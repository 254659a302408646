"""Alternating Least Squares on one device, in PyTorch.

Counterpart of ``predictionio_tpu/ops/als.py`` (single device: no mesh,
no multi-host, no checkpoint, host bucketing only). The algorithm and
its memory-bounded layout are the JAX package's:

* **Segmented bucketing** (host, numpy) — every row's ratings are split
  into fixed-width segments; rows hotter than the widest bucket span
  several max-width segments ("hot" rows). Each bucket is laid out as
  ``[n_chunks, C, L]`` chunks with ``C·L <= chunk_entries``.
* **Chunk loop** — for each chunk the opposite factors are gathered,
  the masked Gramians ``QᵀQ``/``Qᵀr`` formed, the ALS-WR ridge added and
  the batched SPD solve run (:func:`~predictionio_tpu_torch.ops.solve.spd_solve`,
  the hand-written Gauss-Jordan kernel at K % 8 == 0 on CUDA); solved
  rows are written with ``index_copy_``.
* **Hot rows** accumulate their Gramians across segments with
  ``index_add_`` into a ``[H_g, K, K]`` buffer per group and are solved
  once per group at the end of the half-sweep.

Both MLlib objectives: explicit (squared error, λ scaled by each row's
rating count) and implicit (Hu-Koren-Volinsky: ``c = 1 + α|r|``,
``p = [r > 0]``, a shared ``YᵀY`` per half-sweep).

All arithmetic is float32 with TF32 off (the JAX package's
``precision="highest"``). ``index_add_`` on CUDA sums in no fixed order,
so hot-row Gramians — and the factors that depend on them — may differ
in the last bits from run to run.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.solve import spd_solve
from predictionio_tpu_torch.ops.topk import top_k_scores

__all__ = [
    "ALSConfig",
    "ALSFactors",
    "BucketedRatings",
    "build_buckets",
    "rated_row_mask",
    "to_device_buckets",
    "planned_solves",
    "seed_factors",
    "train_als",
    "half_sweep",
    "als_sweep",
    "SCORE_BLOCK",
    "SCORE_QUERY_ROWS",
    "score_rows",
    "predict_scores",
    "top_k_items",
    "top_k_items_batch",
    "score_rows_program",
    "PredictScoresProgram",
    "TopKScoresProgram",
    "TopKItemsBatchProgram",
]

#: Segment widths: multiples of 8 at ~1.33-1.5x steps, so within-bucket
#: padding stays below 1.5x. Rows with more ratings split into hot segments.
_DEFAULT_BUCKET_WIDTHS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)

#: Max padded entries (rows × width) per chunk: bounds the per-chunk
#: gather at chunk_entries·rank·4 bytes (1 GB at rank 64).
_DEFAULT_CHUNK_ENTRIES = 1 << 22

#: Max rows per chunk, independent of width: bounds the batched normal
#: equations at chunk_rows·K²·4 bytes (512 MB at rank 64).
_DEFAULT_CHUNK_ROWS = 1 << 15


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    """Hyperparameters (parity: MLlib ``ALS`` params ``rank``, ``maxIter``,
    ``regParam``, ``implicitPrefs``, ``alpha``, ``seed``)."""

    rank: int = 10
    iterations: int = 10
    reg: float = 0.1
    implicit: bool = False
    alpha: float = 1.0
    seed: int = 0
    #: segment widths for bucketing (see build_buckets)
    bucket_widths: tuple = _DEFAULT_BUCKET_WIDTHS
    #: max padded entries per chunk — the device-memory knob
    chunk_entries: int = _DEFAULT_CHUNK_ENTRIES
    #: max hot rows per Gramian-accumulator group
    hot_group_slots: int = 2048


class ALSFactors(NamedTuple):
    """The trained model: ``user [num_users, K]``, ``item [num_items, K]``."""

    user: torch.Tensor
    item: torch.Tensor


class _Chunked(NamedTuple):
    """One bucket in chunk layout: ``n_chunks`` chunks of ``C`` rows of a
    fixed segment width ``L``."""

    row_id: Any  # [n_chunks, C] — row index (normal) or hot slot (hot);
    #              padding rows carry the sentinel (num_rows / num_hot)
    idx: Any  # [n_chunks, C, L] int32 — column indices into the other side
    val: Any  # [n_chunks, C, L] f32 — ratings (0 where masked)
    mask: Any  # [n_chunks, C, L] f32 — 1 for real entries


class BucketedRatings(NamedTuple):
    """One side of the ratings matrix in solver layout. Hot rows are split
    into groups of at most ``hot_group_slots`` rows: ``hot[g]`` holds group
    g's segments with group-local slot ids and ``hot_rows[g]`` maps those
    slots back to row ids (last entry: the sentinel)."""

    normal: tuple  # tuple[_Chunked, ...] — rows fitting one segment
    hot: tuple  # tuple[_Chunked, ...] — one per group (row_id = local slot)
    hot_rows: tuple  # tuple of [H_g + 1] int32 — slot -> row id; last = sentinel
    num_rows: int
    num_cols: int
    nnz: int  # real entries
    padded_nnz: int  # entries incl. padding


# ---------------------------------------------------------------------------
# Host bucketing (numpy)
# ---------------------------------------------------------------------------


def _chunk(arrs: list, n: int, c: int, l: int) -> _Chunked:
    """Reshape flat [B(,L)] bucket arrays into chunk layout [n, C(, L)]."""
    row_id, idx, val, mask = arrs
    return _Chunked(
        row_id.reshape(n, c),
        idx.reshape(n, c, l),
        val.reshape(n, c, l),
        mask.reshape(n, c, l),
    )


def _fill_bucket(
    n_seg: int,
    n_pad: int,
    width: int,
    seg_row: np.ndarray,
    seg_start: np.ndarray,
    seg_len: np.ndarray,
    cols_s: np.ndarray,
    vals_s: np.ndarray,
    sentinel: int,
) -> list:
    """Vectorized ragged fill of one bucket's [n_pad, width] arrays from
    row-sorted COO slices."""
    row_id = np.full(n_pad, sentinel, dtype=np.int32)
    idx = np.zeros((n_pad, width), dtype=np.int32)
    val = np.zeros((n_pad, width), dtype=np.float32)
    mask = np.zeros((n_pad, width), dtype=np.float32)
    row_id[:n_seg] = seg_row
    if n_seg:
        dst_row = np.repeat(np.arange(n_seg), seg_len)
        lane_end = np.cumsum(seg_len)
        dst_lane = np.arange(int(lane_end[-1])) - np.repeat(lane_end - seg_len, seg_len)
        src = np.repeat(seg_start, seg_len) + dst_lane
        idx[dst_row, dst_lane] = cols_s[src]
        val[dst_row, dst_lane] = vals_s[src]
        mask[dst_row, dst_lane] = 1.0
    return [row_id, idx, val, mask]


def _usable_widths(widths: Sequence[int]) -> list:
    usable = sorted({int(w) for w in widths if w >= 1})
    if not usable:
        raise ValueError("widths must contain at least one positive width")
    return usable


def _row_offsets(counts_all: np.ndarray) -> tuple:
    """(uniq row ids, their start offset in the row-sorted layout, their
    counts) from a dense per-row count vector."""
    uniq = np.nonzero(counts_all)[0]
    counts = counts_all[uniq]
    starts = (np.cumsum(counts_all) - counts_all)[uniq]
    return uniq, starts, counts


def _plan_segments(
    uniq: np.ndarray, starts: np.ndarray, counts: np.ndarray, usable: list
) -> dict:
    """Split rows into fixed-width segments given per-row counts."""
    w_max = usable[-1]
    is_hot = counts > w_max
    per_width: dict = {}
    lo = 0
    for w in usable:
        sel = np.nonzero(~is_hot & (counts > lo) & (counts <= w))[0]
        lo = w
        if sel.size:
            per_width[w] = (uniq[sel].astype(np.int32), starts[sel], counts[sel])

    hot_sel = np.nonzero(is_hot)[0]
    num_hot = int(hot_sel.size)
    if num_hot:
        h_counts = counts[hot_sel]
        n_segs = -(-h_counts // w_max)  # per hot row
        hot_slot = np.repeat(np.arange(num_hot, dtype=np.int32), n_segs)
        # segment k of a row starts at row_start + k*w_max
        seg_k = np.arange(int(n_segs.sum())) - np.repeat(
            np.cumsum(n_segs) - n_segs, n_segs
        )
        hot_start = np.repeat(starts[hot_sel], n_segs) + seg_k * w_max
        hot_len = np.minimum(
            np.repeat(h_counts, n_segs) - seg_k * w_max, w_max
        ).astype(np.int64)
        hot_rows = uniq[hot_sel].astype(np.int32)
    else:
        hot_slot = np.zeros(0, np.int32)
        hot_start = np.zeros(0, np.int64)
        hot_len = np.zeros(0, np.int64)
        hot_rows = np.zeros(0, np.int32)
    return {
        "per_width": per_width, "hot_slot": hot_slot, "hot_start": hot_start,
        "hot_len": hot_len, "hot_rows": hot_rows,
    }


def _chunk_plan(
    n_seg: int, width: int, row_multiple: int, chunk_entries: int
) -> tuple[int, int, int]:
    """(rows per chunk, n_chunks, padded rows) for one bucket. Rows are
    bounded by entries (the gather buffer) and by _DEFAULT_CHUNK_ROWS
    (the [C, K, K] normal-equation buffers)."""
    c = max(row_multiple, (chunk_entries // width) // row_multiple * row_multiple)
    cap = max(row_multiple, _DEFAULT_CHUNK_ROWS // row_multiple * row_multiple)
    c = min(c, cap, -(-max(n_seg, 1) // row_multiple) * row_multiple)
    n_chunks = -(-max(n_seg, 1) // c)
    return c, n_chunks, n_chunks * c


def _bucket_defs(plan: dict, num_rows: int, w_max: int, hot_group_slots: int):
    """Yield ``(seg_row, seg_start, seg_len, width, sentinel, hot_rows_g)``
    per bucket — normal-width buckets first (hot_rows_g None), then hot
    groups of <= hot_group_slots slots."""
    for w in sorted(plan["per_width"]):
        seg_row, seg_start, seg_len = plan["per_width"][w]
        yield seg_row, seg_start, seg_len, w, num_rows, None
    num_hot = int(plan["hot_rows"].size)
    if num_hot:
        H = hot_group_slots
        g_of_seg = plan["hot_slot"] // H
        for g in range(-(-num_hot // H)):
            sel = g_of_seg == g
            h_g = min(H, num_hot - g * H)
            hr = np.full(h_g + 1, num_rows, dtype=np.int32)
            hr[:h_g] = plan["hot_rows"][g * H : g * H + h_g]
            yield (
                (plan["hot_slot"][sel] - g * H).astype(np.int32),
                plan["hot_start"][sel], plan["hot_len"][sel],
                w_max, h_g, hr,
            )


def _check_coo(rows, cols, vals, num_rows: int, num_cols: int) -> tuple:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    if not (rows.shape == cols.shape == vals.shape):
        raise ValueError("rows/cols/vals must be 1-D arrays of equal length")
    if rows.size and (rows.min() < 0 or rows.max() >= num_rows):
        raise ValueError("row index out of range")
    if cols.size and (cols.min() < 0 or cols.max() >= num_cols):
        raise ValueError("column index out of range")
    return rows, cols, vals


def build_buckets(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    num_rows: int,
    num_cols: int,
    widths: Sequence[int] = _DEFAULT_BUCKET_WIDTHS,
    row_multiple: int = 8,
    chunk_entries: int = _DEFAULT_CHUNK_ENTRIES,
    hot_group_slots: int = 2048,
) -> BucketedRatings:
    """Host-side: COO ratings -> chunked, segmented, padded numpy buckets.

    Rows with at most ``max(widths)`` ratings go to the smallest width
    that fits; hotter rows are split into ``max(widths)``-wide segments.
    Every bucket is laid out as ``[n_chunks, C, L]`` with
    ``C·L <= chunk_entries`` and ``C`` a multiple of ``row_multiple``.
    Rows with zero ratings are absent (``train_als`` zeroes them)."""
    rows, cols, vals = _check_coo(rows, cols, vals, num_rows, num_cols)
    usable = _usable_widths(widths)
    order = np.argsort(rows, kind="stable")
    cols_s, vals_s = cols[order], vals[order]
    uniq, starts, counts = _row_offsets(np.bincount(rows, minlength=num_rows))
    plan = _plan_segments(uniq, starts, counts, usable)

    padded_nnz = 0
    normal_chunks: list = []
    hot_chunks: list = []
    hot_rows_groups: list = []
    for seg_row, seg_start, seg_len, width, sentinel, hr in _bucket_defs(
        plan, num_rows, usable[-1], hot_group_slots
    ):
        n_seg = int(seg_row.size)
        c, n_chunks, n_pad = _chunk_plan(n_seg, width, row_multiple, chunk_entries)
        padded_nnz += n_pad * width
        arrs = _fill_bucket(
            n_seg, n_pad, width, seg_row, seg_start, seg_len, cols_s, vals_s, sentinel
        )
        chunked = _chunk(arrs, n_chunks, c, width)
        if hr is None:
            normal_chunks.append(chunked)
        else:
            hot_chunks.append(chunked)
            hot_rows_groups.append(hr)
    return BucketedRatings(
        tuple(normal_chunks), tuple(hot_chunks), tuple(hot_rows_groups),
        num_rows, num_cols, int(rows.size), padded_nnz,
    )


def planned_solves(
    rows: np.ndarray, num_rows: int, config: ALSConfig, row_multiple: int = 8
) -> int:
    """Batched SPD solves one half-sweep over this side runs: one per
    normal-bucket chunk plus one per hot group — computed from the
    per-row counts alone, without building the buckets."""
    usable = _usable_widths(config.bucket_widths)
    counts_all = np.bincount(np.asarray(rows, np.int64), minlength=num_rows)
    plan = _plan_segments(*_row_offsets(counts_all), usable)
    n = 0
    for seg_row, _, _, width, _, hr in _bucket_defs(
        plan, num_rows, usable[-1], config.hot_group_slots
    ):
        if hr is None:
            n += _chunk_plan(int(seg_row.size), width, row_multiple, config.chunk_entries)[1]
        else:
            n += 1
    return n


def rated_row_mask(b: BucketedRatings) -> np.ndarray:
    """Bool [num_rows]: which rows appear in the ratings. Rows outside get
    zero factors."""
    mask = np.zeros(b.num_rows + 1, dtype=bool)
    for ch in b.normal:
        mask[np.asarray(ch.row_id).ravel()] = True
    for hr in b.hot_rows:
        mask[np.asarray(hr)] = True
    mask[b.num_rows] = False
    return mask[: b.num_rows]


def to_device_buckets(b: BucketedRatings, device: torch.device) -> BucketedRatings:
    """Move bucket arrays to ``device``: row ids as int64 (the index type
    of ``index_copy_``), gather indices as int32."""

    def put(ch: _Chunked) -> _Chunked:
        return _Chunked(
            torch.from_numpy(np.asarray(ch.row_id, np.int64)).to(device),
            torch.from_numpy(ch.idx).to(device),
            torch.from_numpy(ch.val).to(device),
            torch.from_numpy(ch.mask).to(device),
        )

    return BucketedRatings(
        tuple(put(ch) for ch in b.normal),
        tuple(put(ch) for ch in b.hot),
        tuple(torch.from_numpy(np.asarray(hr, np.int64)).to(device) for hr in b.hot_rows),
        b.num_rows, b.num_cols, b.nnz, b.padded_nnz,
    )


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------


def _partials(
    Q: torch.Tensor,  # [C, L, K] masked gathered factors
    val: torch.Tensor,  # [C, L]
    mask: torch.Tensor,  # [C, L]
    implicit: bool,
    alpha: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-chunk partial normal equations (no λ/YᵀY yet)."""
    Qt = Q.transpose(1, 2)  # [C, K, L]
    if implicit:
        conf_minus_1 = alpha * val.abs() * mask  # c - 1
        pref = (val > 0).to(Q.dtype) * mask
        A = torch.bmm(Qt, Q * conf_minus_1[..., None])
        b = torch.bmm(Qt, ((1.0 + conf_minus_1) * pref)[..., None])[..., 0]
        n = pref.sum(dim=-1)  # MLlib numExplicits: positive ratings
    else:
        A = torch.bmm(Qt, Q)
        b = torch.bmm(Qt, (val * mask)[..., None])[..., 0]
        n = mask.sum(dim=-1)
    return A, b, n


def _gram_chunk(
    other: torch.Tensor,  # [num_cols + 1, K]
    idx: torch.Tensor,  # [C, L] int32
    val: torch.Tensor,  # [C, L]
    mask: torch.Tensor,  # [C, L]
    implicit: bool,
    alpha: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial normal equations (A [C,K,K], b [C,K], n [C]) of one chunk:
    gather the opposite factors, mask, and form the Gramians."""
    C, L = idx.shape
    Q = other.index_select(0, idx.reshape(-1)).view(C, L, -1) * mask[..., None]
    return _partials(Q, val, mask, implicit, alpha)


def _finish_solve(
    A: torch.Tensor,  # [C, K, K] Gramian (no reg / yty yet); updated in place
    b: torch.Tensor,  # [C, K]
    n: torch.Tensor,  # [C] per-row rating count
    reg: float,
    yty: torch.Tensor | None,
    solver: str,
) -> torch.Tensor:
    """Add the ALS-WR ridge λ·max(n,1)·I (MLlib scales λ by the rating
    count in both objectives) and the implicit YᵀY, then solve. The ridge
    goes onto A's diagonal in place, which adds the same values as the
    JAX package's ``A + ridge·I``."""
    A.diagonal(dim1=-2, dim2=-1).add_((reg * n.clamp_min(1.0))[:, None])
    if yty is not None:
        A.add_(yty)
    return spd_solve(A, b, method=solver)


def half_sweep(
    factors: torch.Tensor,  # [num_rows + 1, K] — side being updated, in place
    other: torch.Tensor,  # [num_cols + 1, K]
    bucketed: BucketedRatings,
    reg: float,
    implicit: bool,
    alpha: float,
    solver: str,
) -> torch.Tensor:
    """Solve every rated row of ``factors`` given ``other``, in place
    (the JAX package's mesh-less ``_half_sweep``); ``solver`` is the
    :func:`spd_solve` method."""
    yty = other.T @ other if implicit else None  # sentinel row is zero

    # normal rows: solve in-chunk, write into the factor table
    for ch in bucketed.normal:
        for c in range(ch.row_id.shape[0]):
            A, b, n = _gram_chunk(other, ch.idx[c], ch.val[c], ch.mask[c], implicit, alpha)
            factors.index_copy_(0, ch.row_id[c], _finish_solve(A, b, n, reg, yty, solver))

    # hot rows: accumulate Gramians across segments, solve per group
    K = factors.shape[1]
    for ch, hot_rows_g in zip(bucketed.hot, bucketed.hot_rows):
        num_slots = int(hot_rows_g.shape[0])  # H_g + sentinel
        A_acc = factors.new_zeros((num_slots, K, K))
        b_acc = factors.new_zeros((num_slots, K))
        n_acc = factors.new_zeros((num_slots,))
        for c in range(ch.row_id.shape[0]):
            A, b, n = _gram_chunk(other, ch.idx[c], ch.val[c], ch.mask[c], implicit, alpha)
            slot = ch.row_id[c]
            A_acc.index_add_(0, slot, A)
            b_acc.index_add_(0, slot, b)
            n_acc.index_add_(0, slot, n)
        factors.index_copy_(0, hot_rows_g, _finish_solve(A_acc, b_acc, n_acc, reg, yty, solver))

    # padding rows were written into the sentinel row; re-zero it
    factors[bucketed.num_rows].zero_()
    return factors


def als_sweep(
    user_factors: torch.Tensor,
    item_factors: torch.Tensor,
    user_bucketed: BucketedRatings,
    item_bucketed: BucketedRatings,
    reg: float,
    implicit: bool,
    alpha: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One full ALS iteration, in place: users given items, then items
    given users, each solve through ``spd_solve(method="auto")``. Tables
    carry the zero sentinel row."""
    with torch.no_grad():
        half_sweep(user_factors, item_factors, user_bucketed, reg, implicit, alpha, "auto")
        half_sweep(item_factors, user_factors, item_bucketed, reg, implicit, alpha, "auto")
    return user_factors, item_factors


def seed_factors(num_rows: int, rank: int, seed: int, implicit: bool) -> np.ndarray:
    """The cold-start draw, ``[num_rows, rank]`` float32 on the host:
    ``|N(0,1)|`` rows from a ``torch.Generator`` seeded with ``seed``,
    scaled by ``1/sqrt(rank)`` (explicit) or normalized to unit L2
    (implicit, MLlib's init). Made on the CPU so every device starts
    from the same numbers."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    draw = torch.randn((num_rows, rank), generator=gen, dtype=torch.float32).abs()
    if implicit:
        draw = draw / draw.norm(dim=1, keepdim=True).clamp_min(1e-9)
    else:
        draw = draw * (1.0 / np.sqrt(rank))
    return draw.numpy()


def _table(init: np.ndarray, num_rows: int, rank: int, rated: np.ndarray, device) -> torch.Tensor:
    """[num_rows + 1, rank] table from an init (sentinel row and unrated
    rows zero; a narrower init fills the leading columns)."""
    init = np.asarray(init, dtype=np.float32)
    if init.shape[0] != num_rows:
        raise ValueError(f"init has {init.shape[0]} rows, expected {num_rows}")
    table = np.zeros((num_rows + 1, rank), np.float32)
    k = min(rank, init.shape[1])
    table[:num_rows, :k] = init[:, :k]
    table[:num_rows][~rated] = 0.0
    return torch.from_numpy(table).to(device)


def train_als(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    num_users: int,
    num_items: int,
    config: ALSConfig = ALSConfig(),
    init_user: np.ndarray | None = None,
    init_item: np.ndarray | None = None,
    device: str | torch.device | None = None,
    on_sweep: Callable[[int, torch.Tensor, torch.Tensor], None] | None = None,
) -> ALSFactors:
    """Train factor matrices from COO ratings on ``device`` (default: the card).

    ``init_user``/``init_item`` (``[num_users, K]`` / ``[num_items, K]``)
    replace the cold-start draw of :func:`seed_factors`; unrated rows are
    zeroed either way. ``on_sweep(step, user, item)`` is called after
    each sweep with views of the current tables (no sentinel row).

    Returns ``ALSFactors`` on ``device``: ``user [num_users, K]``,
    ``item [num_items, K]``.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        # full f32 products, as the JAX package's precision="highest":
        # TF32 keeps ~3 decimal digits and would move the factors
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    kw = dict(
        widths=config.bucket_widths, chunk_entries=config.chunk_entries,
        hot_group_slots=config.hot_group_slots,
    )
    user_b = build_buckets(rows, cols, vals, num_users, num_items, **kw)
    item_b = build_buckets(cols, rows, vals, num_items, num_users, **kw)
    u_rated = rated_row_mask(user_b)
    i_rated = rated_row_mask(item_b)
    user_bucketed = to_device_buckets(user_b, dev)
    item_bucketed = to_device_buckets(item_b, dev)
    del user_b, item_b

    rank = config.rank
    if init_user is None:
        init_user = seed_factors(num_users, rank, config.seed, config.implicit)
    if init_item is None:
        init_item = seed_factors(num_items, rank, config.seed + 1, config.implicit)
    uf = _table(init_user, num_users, rank, u_rated, dev)
    vf = _table(init_item, num_items, rank, i_rated, dev)

    for step in range(config.iterations):
        als_sweep(
            uf, vf, user_bucketed, item_bucketed,
            reg=config.reg, implicit=config.implicit, alpha=config.alpha,
        )
        if on_sweep is not None:
            on_sweep(step, uf[:num_users], vf[:num_items])
    return ALSFactors(user=uf[:num_users], item=vf[:num_items])


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------


#: item rows of every scoring product in :func:`score_rows`
SCORE_BLOCK = 8192
#: :func:`score_rows` pads the queries to a multiple of this many rows:
#: below 8 rows cuBLAS's batched product picks its kernel by the batch
#: count (``chip_smoke.py``'s ``phase_score_cost`` holds every count)
SCORE_QUERY_ROWS = 8

#: each scored table's last, short block as float32, zero-padded to
#: ``SCORE_BLOCK`` rows: ``(table version, start row, block)`` while the
#: table lives (a serving table is scored many times and never written in
#: place; an out-of-place row swap is a new table)
_TAILS: WeakIdKeyDictionary = WeakIdKeyDictionary()
_TAILS_LOCK = threading.Lock()


def _padded_tail(rows: torch.Tensor, start: int) -> torch.Tensor:
    with _TAILS_LOCK:
        hit = _TAILS.get(rows)
    if hit is not None and hit[0] == rows._version and hit[1] == start:
        return hit[2]
    tail = torch.zeros((SCORE_BLOCK, rows.shape[1]), dtype=torch.float32, device=rows.device)
    tail[: rows.shape[0] - start] = rows[start:]
    with _TAILS_LOCK:
        _TAILS[rows] = (rows._version, start, tail)
    return tail


def score_rows(q: torch.Tensor, table) -> torch.Tensor:
    """``q [M, K] @ table.T`` as ``[M, n]`` scores, where each score's bits
    do not depend on how many rows ``table`` has.

    cuBLAS (and the CPU's BLAS at ``M = 1``) picks its kernel, and with
    it the order of each dot product's sums, by the product's shape: the
    same row scored in an ``I``-row and an ``I/8``-row product may differ
    in its last bits (``chip_smoke.py``'s ``[sharded]`` phase counts how
    many on the card). So the table is scored in blocks of
    ``SCORE_BLOCK`` rows, as one batched product ``[blocks, M, K] @
    [blocks, K, SCORE_BLOCK]`` written in place into one ``[M, w]``
    buffer (``w`` the rows rounded up to the block), the last, short
    block zero-padded (:func:`_padded_tail`, once a table) and scored as
    a batch of one, and the queries zero-padded to a multiple of
    ``SCORE_QUERY_ROWS`` rows. A replicated table and each shard of a
    sharded one (``parallel/sharding.py``) then give every item the same
    score, in two launches. ``table`` is a float32 tensor or an int8
    :class:`~predictionio_tpu_torch.ops.quant.QuantizedTable` (``q @
    codes.T`` then the row scales)."""
    quantized = getattr(table, "is_quantized", False)
    rows = table.codes if quantized else table
    n, k = int(rows.shape[0]), int(rows.shape[1])
    m = int(q.shape[0])
    q = q.to(torch.float32)
    if m % SCORE_QUERY_ROWS:
        q = F.pad(q, (0, 0, 0, -m % SCORE_QUERY_ROWS))
    mp = int(q.shape[0])
    full, short = divmod(n, SCORE_BLOCK)
    blocks = full + (short > 0)
    out = torch.empty((mp, blocks * SCORE_BLOCK), dtype=torch.float32, device=q.device)
    windows = out.view(mp, blocks, SCORE_BLOCK).transpose(0, 1)  # [blocks, M, SCORE_BLOCK]
    if full:
        head = rows[: full * SCORE_BLOCK].to(torch.float32).reshape(full, SCORE_BLOCK, k)
        torch.bmm(q.expand(full, mp, k), head.transpose(1, 2), out=windows[:full])
    if short:
        tail = _padded_tail(rows, full * SCORE_BLOCK)
        torch.bmm(q[None], tail.T[None], out=windows[full:])
    scores = out[:m, :n]
    if quantized:
        scores.mul_(table.scales)
    return scores


def predict_scores(user_vec: torch.Tensor, item_factors) -> torch.Tensor:
    """Scores of one user against all items (``item_factors @ user_vec``,
    through :func:`score_rows`)."""
    return score_rows(user_vec[None], item_factors)[0]


def top_k_items(
    user_vec: torch.Tensor,
    item_factors: torch.Tensor,
    k: int,
    exclude_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k item ids + scores for one user; ``exclude_mask`` (bool [I])
    sends items to -inf."""
    scores = predict_scores(user_vec, item_factors)
    if exclude_mask is not None:
        scores = scores.masked_fill(exclude_mask, float("-inf"))
    return top_k_scores(scores, k)


def top_k_items_batch(
    user_idx: torch.Tensor,
    user_factors: torch.Tensor,
    item_factors: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k for a batch of users: gather the user rows, score every item
    (:func:`score_rows`), and take each row's top-k. Returns ``([B, k]
    item ids, [B, k] scores)``."""
    return top_k_scores(score_rows(user_factors[user_idx], item_factors), k)


# ---------------------------------------------------------------------------
# The same scoring as programs for torch.export (``pio train --aot``)
# ---------------------------------------------------------------------------


def score_rows_program(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """:func:`score_rows` of a float32 table, written so that
    ``torch.export`` can trace it (``workflow/aot.py``): the same batched
    products on the same shapes and strides (``[full, M, K] @ [full, K,
    SCORE_BLOCK]`` over the full blocks with the queries expanded, and
    ``[1, M, K] @ [1, K, SCORE_BLOCK]`` over the zero-padded tail), so
    every score has the eager path's bits. :func:`score_rows` writes the
    products in place and caches the padded tail; neither traces, so
    here the products come out whole and the tail is padded inside the
    program. ``q`` must already have a multiple of ``SCORE_QUERY_ROWS``
    rows; the result has every one of them."""
    n, k = int(rows.shape[0]), int(rows.shape[1])
    mp = q.shape[0]
    full, short = divmod(n, SCORE_BLOCK)
    parts = []
    if full:
        head = rows[: full * SCORE_BLOCK].reshape(full, SCORE_BLOCK, k)
        parts.append(torch.bmm(q.expand(full, mp, k), head.transpose(1, 2)))
    if short:
        tail = F.pad(rows[full * SCORE_BLOCK :], (0, 0, 0, SCORE_BLOCK - short))
        parts.append(torch.bmm(q[None], tail.T[None]))
    out = torch.cat(parts) if len(parts) > 1 else parts[0]  # [blocks, M, SCORE_BLOCK]
    return out.transpose(0, 1).reshape(mp, -1)[:, :n]


class PredictScoresProgram(torch.nn.Module):
    """:func:`predict_scores` for export: ``(user_vec [K], items [I, K])
    -> scores [I]``, the vector padded to ``SCORE_QUERY_ROWS`` zero rows
    as :func:`score_rows` pads it."""

    def forward(self, user_vec: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        q = F.pad(user_vec[None], (0, 0, 0, SCORE_QUERY_ROWS - 1))
        return score_rows_program(q, items)[0]


class TopKScoresProgram(torch.nn.Module):
    """:func:`top_k_scores` at a fixed ``k`` for export: ``scores [I] ->
    (ids [k], scores [k])``."""

    def __init__(self, k: int):
        super().__init__()
        self.k = int(k)

    def forward(self, scores: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return top_k_scores(scores, self.k)


class TopKItemsBatchProgram(torch.nn.Module):
    """:func:`top_k_items_batch` at a fixed ``k`` for export: ``(user_idx
    [M], users [U, K], items [I, K]) -> ([M, k], [M, k])``. ``M`` is a
    multiple of ``SCORE_QUERY_ROWS`` (the caller pads the ids; a padding
    row's scores are computed and dropped, and no row's bits depend on
    another row's values), so the product has the eager path's shape."""

    def __init__(self, k: int):
        super().__init__()
        self.k = int(k)

    def forward(
        self, user_idx: torch.Tensor, users: torch.Tensor, items: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        return top_k_scores(score_rows_program(users[user_idx], items), self.k)
