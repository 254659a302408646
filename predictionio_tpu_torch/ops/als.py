"""Alternating Least Squares in PyTorch, on one device or a mesh.

Counterpart of ``predictionio_tpu/ops/als.py``. The algorithm and its
memory-bounded layout are the JAX package's:

* **Segmented bucketing** — every row's ratings are split into
  fixed-width segments; rows hotter than the widest bucket span several
  max-width segments ("hot" rows). Each bucket is laid out as
  ``[n_chunks, C, L]`` chunks with ``C·L <= chunk_entries``. Two paths
  share one plan (``_plan_segments``, ``_bucket_defs``, ``_chunk_plan``
  on the per-row counts) and give the same arrays to the bit:
  :func:`build_buckets` sorts and fills in numpy on the host;
  :func:`build_buckets_device` uploads the COO once, sorts and counts on
  the device, reads back only the counts and gather-fills every bucket
  there. ``ALSConfig.bucketing="auto"`` takes the device path for a
  one-device train on the card; the mesh and the multi-process layouts
  bucket on the host.
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

The mesh (``train_als(mesh=...)``, a
:class:`~predictionio_tpu_torch.controller.context.TrainingMesh` of
``(data, model)`` positions; the JAX package's ``_half_sweep`` under
GSPMD):

* **Chunk rows split over the data positions** — every chunk's ``C`` rows
  (a multiple of ``lcm(8, data)``) go to the data positions in equal
  parts; each position's part is its own batch of normal equations.
* **Tables sharded over the model positions** — every position holds only
  its ``[rows/model, K]`` part of both tables
  (:class:`~predictionio_tpu_torch.parallel.sharding.ShardedTable`, one a
  data position). For a chunk part each model position gathers only the
  entries its shard owns (the others masked to zero); the gathers are
  summed over the model positions (exact: an entry has one owner) and
  the Gramians formed on the data position: the table never moves.
* **The solve on each position** — ``_finish_solve`` through
  :func:`~predictionio_tpu_torch.ops.solve.spd_solve`, so the
  Gauss-Jordan kernel takes each data position's batch on the card (the
  JAX package drops to Cholesky on a mesh, its Pallas kernel not being
  shard_map-wrapped). Hot-row Gramians are summed over the data
  positions before their one solve.
* **The solved rows all-gathered** into every position's shards after
  each half-sweep: copies in process, ``torch.distributed`` across
  processes.
* **Multi-process** (a mesh over the processes' positions): each process
  holds its shard of the ratings; rows are re-partitioned to their owner
  ``row % P`` through the bounded exchange
  (:func:`~predictionio_tpu_torch.parallel.exchange.exchange_by_owner`),
  every process packs equal-shaped chunk blocks, and the rated masks are
  OR-ed (:func:`_multihost_bucketed`). Without a mesh, the processes
  gather the whole COO and each trains it alone (:func:`_allgather_coo`).
* A mesh of one position is the single-device path.

Step checkpoints (``ALSConfig.checkpoint_dir``, every
``checkpoint_interval`` sweeps, :mod:`predictionio_tpu_torch.utils.checkpoint`)
hold the tables at the canonical ``(rows + 1, K)`` shape, so a run resumes
on another mesh shape.

All arithmetic is float32 with TF32 off during the sweeps (the JAX
package's ``precision="highest"``; ``ALSConfig.precision`` allows TF32 or
bf16 passes, and the process's settings come back after each sweep). On
one device ``index_add_`` on CUDA sums in no fixed order, so hot-row
Gramians — and the factors that depend on them —
may differ in the last bits from run to run. The mesh sums in a fixed
order instead (:func:`_accumulate_in_order`, and every Gramian product
on ``GRAM_ROWS`` rows), so a mesh train gives the same bits on every
mesh shape and number of processes, which a resume on another shape
needs; it agrees with one device's train to rounding.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
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
    "build_buckets_device",
    "rated_row_mask",
    "to_device_buckets",
    "planned_solves",
    "seed_factors",
    "train_als",
    "half_sweep",
    "als_sweep",
    "MeshBuckets",
    "mesh_buckets",
    "mesh_tables",
    "mesh_half_sweep",
    "mesh_sweep",
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
    #: pad the rank up to a multiple of this (0 = the exact rank): rank 10
    #: at 8 trains at K = 16, which the Gauss-Jordan kernel takes
    rank_pad_multiple: int = 0
    #: segment widths for bucketing (see build_buckets)
    bucket_widths: tuple = _DEFAULT_BUCKET_WIDTHS
    #: max padded entries per chunk — the device-memory knob
    chunk_entries: int = _DEFAULT_CHUNK_ENTRIES
    #: max hot rows per Gramian-accumulator group
    hot_group_slots: int = 2048
    #: step-checkpoint directory ("" = off); training resumes from the
    #: latest step found there (resume-on-preemption, SURVEY.md 6.4)
    checkpoint_dir: str = ""
    checkpoint_interval: int = 5
    #: where the O(nnz) bucketing runs: "auto" sorts and fills on the card
    #: when training on one CUDA device (build_buckets_device), on the
    #: host otherwise; "host" / "device" force a path. The mesh and the
    #: multi-process layouts always bucket on the host.
    bucketing: str = "auto"
    #: float32 products of the sweep on the card: "highest" (full f32),
    #: "high" (TF32) or "default" (bf16 passes); restored after the train
    precision: str = "highest"
    #: SPD solver: "auto" (the Gauss-Jordan kernel on CUDA at K % 8 == 0,
    #: else Cholesky), "cholesky", "pallas" (the kernel; raises on the
    #: CPU) or "pallas_interpret" (the kernel's plain mirror)
    solver: str = "auto"


#: ``ALSConfig.precision`` -> ``torch.set_float32_matmul_precision``
_PRECISIONS = {"default": "medium", "high": "high", "highest": "highest"}

#: ``ALSConfig.solver`` -> the :func:`spd_solve` method
_SOLVERS = {"auto": "auto", "cholesky": "cholesky", "pallas": "kernel", "pallas_interpret": "plain"}


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


class _Segments(NamedTuple):
    """Host-side segmentation of one COO shard (pre-padding layout)."""

    plan: dict  # _plan_segments' per-width and hot segments
    w_max: int
    cols_s: np.ndarray  # row-sorted column ids
    vals_s: np.ndarray  # row-sorted values
    rated: np.ndarray  # bool [num_rows] — rows present in this shard


def _segment(rows, cols, vals, num_rows: int, num_cols: int, widths: Sequence[int],
             by_column: bool = False) -> _Segments:
    """Validate and row-sort one COO shard and split every row into
    fixed-width segments (the JAX package's ``_segment``). Within a row
    the entries keep their COO order, or with ``by_column`` go in column
    order (repeats of a column by value)."""
    rows, cols, vals = _check_coo(rows, cols, vals, num_rows, num_cols)
    usable = _usable_widths(widths)
    order = np.lexsort((vals, cols, rows)) if by_column else np.argsort(rows, kind="stable")
    counts_all = np.bincount(rows, minlength=num_rows)
    plan = _plan_segments(*_row_offsets(counts_all), usable)
    return _Segments(plan, usable[-1], cols[order], vals[order], counts_all > 0)


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
    ``C·L <= chunk_entries`` and ``C`` a multiple of ``row_multiple``
    (keep that a multiple of the mesh's data positions, so chunk rows
    split evenly). Rows with zero ratings are absent (``train_als``
    zeroes them)."""
    seg = _segment(rows, cols, vals, num_rows, num_cols, widths)
    padded_nnz = 0
    normal_chunks: list = []
    hot_chunks: list = []
    hot_rows_groups: list = []
    for seg_row, seg_start, seg_len, width, sentinel, hr in _bucket_defs(
        seg.plan, num_rows, seg.w_max, hot_group_slots
    ):
        n_seg = int(seg_row.size)
        c, n_chunks, n_pad = _chunk_plan(n_seg, width, row_multiple, chunk_entries)
        padded_nnz += n_pad * width
        arrs = _fill_bucket(
            n_seg, n_pad, width, seg_row, seg_start, seg_len, seg.cols_s, seg.vals_s, sentinel
        )
        chunked = _chunk(arrs, n_chunks, c, width)
        if hr is None:
            normal_chunks.append(chunked)
        else:
            hot_chunks.append(chunked)
            hot_rows_groups.append(hr)
    return BucketedRatings(
        tuple(normal_chunks), tuple(hot_chunks), tuple(hot_rows_groups),
        num_rows, num_cols, int(np.asarray(rows).size), padded_nnz,
    )


def _mh_chunk_plan(width: int, n_seg_max: int, processes: int, m: int, chunk_entries: int) -> tuple[int, int]:
    """``(c_local, n_chunks)`` of one bucket in the multi-process layout:
    every process pads its block to ``n_chunks · c_local`` rows, ``c_local``
    a multiple of ``m``; a chunk holds ``processes · c_local`` rows."""
    budget = max(1, chunk_entries // (width * processes))
    c_local = max(m, budget // m * m)
    c_local = min(c_local, -(-max(n_seg_max, 1) // m) * m)
    return c_local, -(-max(n_seg_max, 1) // c_local)


def planned_solves(
    rows: np.ndarray, num_rows: int, config: ALSConfig, row_multiple: int = 8,
    data: int = 1, processes: int = 1,
) -> int:
    """Batched SPD solves one half-sweep over this side runs in ONE
    process: one per normal-bucket chunk and data position plus one per
    hot group — computed from the per-row counts alone, without building
    the buckets. ``data`` is a process's data positions on a mesh (chunk
    rows then a multiple of ``lcm(row_multiple, data)``); with
    ``processes > 1``, ``rows`` are the JOB's rows, re-partitioned to
    ``row % processes`` as the multi-process mesh does."""
    usable = _usable_widths(config.bucket_widths)
    rows = np.asarray(rows, np.int64)
    if processes > 1:
        m = math.lcm(8, int(data))
        per_width: dict = {}
        num_hot = 0
        for p in range(processes):
            counts_all = np.bincount(rows[rows % processes == p], minlength=num_rows)
            plan = _plan_segments(*_row_offsets(counts_all), usable)
            num_hot += int(plan["hot_rows"].size)
            for w, (seg_row, _, _) in plan["per_width"].items():
                per_width[w] = max(per_width.get(w, 0), int(seg_row.size))
        normal = sum(
            _mh_chunk_plan(w, n, processes, m, config.chunk_entries)[1] for w, n in per_width.items()
        )
        return int(data) * normal + -(-num_hot // config.hot_group_slots)
    row_multiple = math.lcm(int(row_multiple), int(data))
    counts_all = np.bincount(rows, minlength=num_rows)
    plan = _plan_segments(*_row_offsets(counts_all), usable)
    n = 0
    for seg_row, _, _, width, _, hr in _bucket_defs(
        plan, num_rows, usable[-1], config.hot_group_slots
    ):
        if hr is None:
            n += int(data) * _chunk_plan(int(seg_row.size), width, row_multiple, config.chunk_entries)[1]
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
# Device bucketing
# ---------------------------------------------------------------------------


#: indices at or above this take the host path: the device sorts int32
_INT32_LIMIT = 2**31


def _device_coo(rows, cols, vals, num_rows: int, num_cols: int, device) -> tuple | None:
    """Validated ``(rows int32, cols int32, vals f32)`` on the device, or
    ``None`` for the reference's host cases: no ratings, or more than
    int32 can index. Numpy input is checked on the host before the int32
    cast and goes up once; tensors stay where they are and are checked
    with one min/max readback before anything indexes with them (an
    out-of-range index on CUDA is a device-side assert, not an error)."""
    if all(isinstance(a, torch.Tensor) for a in (rows, cols, vals)):
        if not (rows.dim() == 1 and rows.shape == cols.shape == vals.shape):
            raise ValueError("rows/cols/vals must be 1-D arrays of equal length")
        nnz = rows.numel()
        if nnz and nnz < _INT32_LIMIT and max(num_rows, num_cols) < _INT32_LIMIT:
            lo_r, hi_r, lo_c, hi_c = torch.stack(
                [rows.min().long(), rows.max().long(), cols.min().long(), cols.max().long()]
            ).tolist()
            if lo_r < 0 or hi_r >= num_rows:
                raise ValueError("row index out of range")
            if lo_c < 0 or hi_c >= num_cols:
                raise ValueError("column index out of range")
            return rows.to(torch.int32), cols.to(torch.int32), vals.to(torch.float32)
        rows, cols, vals = (a.cpu().numpy() for a in (rows, cols, vals))
    rows, cols, vals = _check_coo(rows, cols, vals, num_rows, num_cols)
    if rows.size == 0 or rows.size >= _INT32_LIMIT or max(num_rows, num_cols) >= _INT32_LIMIT:
        return None
    dev = resolve_device(device)
    return tuple(torch.from_numpy(a).to(dev) for a in (rows.astype(np.int32), cols.astype(np.int32), vals))


def _fill_on_device(
    rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, num_rows: int, num_cols: int,
    widths: Sequence[int], row_multiple: int, chunk_entries: int, hot_group_slots: int,
) -> tuple[BucketedRatings, np.ndarray]:
    """The device half of :func:`build_buckets_device` on validated
    tensors: a stable sort by row and the per-row counts on the device,
    one readback of the counts, the host's plan from them, one upload of
    every bucket's ``(row id, start, length)`` and hot slot map, then a
    gather-fill per bucket."""
    usable = _usable_widths(widths)
    dev = rows.device
    order = torch.sort(rows, stable=True).indices
    cols_s, vals_s = cols[order], vals[order]
    del order
    counts_all = torch.bincount(rows, minlength=num_rows).cpu().numpy().astype(np.int64)
    plan = _plan_segments(*_row_offsets(counts_all), usable)

    shapes: list = []  # (width, rows per chunk, n_chunks, is a hot group)
    meta: list = []
    hot_maps: list = []
    padded_nnz = 0
    for seg_row, seg_start, seg_len, width, sentinel, hr in _bucket_defs(
        plan, num_rows, usable[-1], hot_group_slots
    ):
        n_seg = int(seg_row.size)
        c, n_chunks, n_pad = _chunk_plan(n_seg, width, row_multiple, chunk_entries)
        padded_nnz += n_pad * width
        block = np.zeros((3, n_pad), np.int64)
        block[0] = sentinel
        block[:, :n_seg] = seg_row, seg_start, seg_len
        meta.append(block.ravel())
        shapes.append((width, c, n_chunks, hr is not None))
        if hr is not None:
            hot_maps.append(hr)
    meta_d = torch.from_numpy(np.concatenate(meta + hot_maps, dtype=np.int64)).to(dev)

    normal, hot = [], []
    off = 0
    for width, c, n_chunks, is_hot in shapes:
        n_pad = c * n_chunks
        row_id, start, length = meta_d[off : off + 3 * n_pad].view(3, n_pad)
        off += 3 * n_pad
        lane = torch.arange(width, device=dev)
        real = lane < length[:, None]
        # padded lanes read entry 0, not past the row's last entry
        src = torch.where(real, start[:, None] + lane, 0)
        chunked = _Chunked(
            row_id.view(n_chunks, c),
            torch.where(real, cols_s[src], 0).view(n_chunks, c, width),
            torch.where(real, vals_s[src], 0.0).view(n_chunks, c, width),
            real.to(torch.float32).view(n_chunks, c, width),
        )
        (hot if is_hot else normal).append(chunked)
    hot_rows = meta_d[off:].split([hr.size for hr in hot_maps])
    bucketed = BucketedRatings(
        tuple(normal), tuple(hot), tuple(hot_rows), num_rows, num_cols, int(rows.numel()), padded_nnz
    )
    return bucketed, counts_all > 0


def build_buckets_device(
    rows,
    cols,
    vals,
    num_rows: int,
    num_cols: int,
    widths: Sequence[int] = _DEFAULT_BUCKET_WIDTHS,
    row_multiple: int = 8,
    chunk_entries: int = _DEFAULT_CHUNK_ENTRIES,
    hot_group_slots: int = 2048,
    device: str | torch.device | None = None,
) -> tuple[BucketedRatings, np.ndarray]:
    """:func:`build_buckets` with every O(nnz) step on the device (the JAX
    package's ``build_buckets_device``): ``(buckets as`` :func:`to_device_buckets`
    ``gives them, rated-row mask)``.

    ``rows/cols/vals`` are numpy arrays, which go up to ``device`` (the
    card by default) once as int32 indices and float32 values, or tensors,
    which are bucketed where they lie. Only the per-row counts come back.
    The plan is the host path's (``_plan_segments``, ``_bucket_defs``,
    ``_chunk_plan``), and the stable sort keeps each row's COO order, so
    every array equals the host path's to the bit. No ratings, or more
    than int32 can index, take the host path (the reference's rule)."""
    coo = _device_coo(rows, cols, vals, num_rows, num_cols, device)
    if coo is None:
        if isinstance(rows, torch.Tensor):
            device = rows.device
            rows, cols, vals = (a.cpu().numpy() for a in (rows, cols, vals))
        b = build_buckets(rows, cols, vals, num_rows, num_cols, widths, row_multiple, chunk_entries,
                          hot_group_slots)
        return to_device_buckets(b, resolve_device(device)), rated_row_mask(b)
    return _fill_on_device(*coo, num_rows, num_cols, widths, row_multiple, chunk_entries, hot_group_slots)


# ---------------------------------------------------------------------------
# Multi-process layouts
# ---------------------------------------------------------------------------


def _multihost_bucketed(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    num_rows: int,
    num_cols: int,
    data: int,
    widths: Sequence[int],
    chunk_entries: int,
    hot_group_slots: int = 2048,
) -> tuple[BucketedRatings, np.ndarray]:
    """Multi-process: this process's COO shard -> its block of the job's
    chunk layout, without any process holding the job's ratings (the JAX
    package's ``_multihost_bucketed``).

    1. All-to-all the shard so process ``p`` owns every rating of rows
       with ``row % P == p`` (the bounded exchange).
    2. Segment the owned rows locally (complete rows give correct
       counts; within a row in column order), then agree on per-width
       block shapes (a tiny metadata all-gather) so every process packs
       an identically shaped block per bucket: ``[n_chunks, c_local,
       L]``, ``c_local`` a multiple of
       ``lcm(8, data)`` so it splits over this process's ``data``
       positions. The job's chunk is the processes' blocks side by side,
       process-contiguous along the data axis.
    3. Hot rows take GLOBAL slots (process order); every process packs a
       (possibly empty) block for every group and holds every group's
       slot map.

    Returns (this process's block, this process's rated mask — OR it
    across processes for the job's)."""
    from predictionio_tpu_torch.parallel.distributed import process_count, process_index
    from predictionio_tpu_torch.parallel.exchange import allgather_objects, exchange_by_owner

    P = process_count()
    me = process_index()
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    # validate BEFORE the exchange and agree on the verdict: a lone raise
    # would strand the peers in the next collective
    err = ""
    if rows.size and (rows.min() < 0 or rows.max() >= num_rows):
        err = f"process {me}: row index out of range"
    elif cols.size and (cols.min() < 0 or cols.max() >= num_cols):
        err = f"process {me}: column index out of range"
    errors = [e for e in allgather_objects(err) if e]
    if errors:
        raise ValueError("; ".join(errors))

    rows, cols, vals = exchange_by_owner([rows, cols, vals], rows % P)
    # the exchange interleaves the processes' shards: column order is the
    # canonical order within a row (the order of a (row, col)-sorted COO,
    # as the DataSources hand one process; repeats of a pair by value)
    seg = _segment(rows, cols, vals, num_rows, num_cols, widths, by_column=True)
    m = math.lcm(8, int(data))

    local_meta = {
        "widths": {w: int(v[0].size) for w, v in seg.plan["per_width"].items()},
        "num_hot": int(seg.plan["hot_rows"].size),
        "nnz": int(rows.size),
    }
    metas = allgather_objects(local_meta)
    all_widths = sorted({w for mt in metas for w in mt["widths"]})
    hot_counts = [mt["num_hot"] for mt in metas]
    hot_offset = int(np.sum(hot_counts[:me]))
    num_hot_tot = int(np.sum(hot_counts))
    nnz_global = int(np.sum([mt["nnz"] for mt in metas]))
    padded_global = 0

    def pack(seg_row, seg_start, seg_len, width, sentinel, n_seg_max):
        nonlocal padded_global
        c_local, n_chunks = _mh_chunk_plan(width, n_seg_max, P, m, chunk_entries)
        n_pad = n_chunks * c_local
        padded_global += n_pad * width * P
        arrs = _fill_bucket(
            int(seg_row.size), n_pad, width, seg_row, seg_start, seg_len, seg.cols_s, seg.vals_s, sentinel
        )
        return _chunk(arrs, n_chunks, c_local, width)

    empty_i64 = np.zeros(0, np.int64)
    normal_chunks = []
    for w in all_widths:
        n_seg_max = max(mt["widths"].get(w, 0) for mt in metas)
        seg_row, seg_start, seg_len = seg.plan["per_width"].get(w, (np.zeros(0, np.int32), empty_i64, empty_i64))
        normal_chunks.append(pack(seg_row, seg_start, seg_len, w, num_rows, n_seg_max))

    hot_chunks = []
    hot_rows_groups = []
    if num_hot_tot:
        H = hot_group_slots
        n_groups = -(-num_hot_tot // H)
        g_slot = seg.plan["hot_slot"].astype(np.int64) + hot_offset
        my_counts = [int(np.count_nonzero((g_slot >= g * H) & (g_slot < (g + 1) * H))) for g in range(n_groups)]
        all_counts = allgather_objects(my_counts)
        hot_rows_all = np.concatenate(
            [np.asarray(h, np.int32) for h in allgather_objects(seg.plan["hot_rows"].tolist())]
        )
        for g in range(n_groups):
            sel = (g_slot >= g * H) & (g_slot < (g + 1) * H)
            h_g = min(H, num_hot_tot - g * H)
            hot_chunks.append(pack(
                (g_slot[sel] - g * H).astype(np.int32), seg.plan["hot_start"][sel], seg.plan["hot_len"][sel],
                seg.w_max, h_g, max(c[g] for c in all_counts),
            ))
            hr = np.full(h_g + 1, num_rows, dtype=np.int32)
            hr[:h_g] = hot_rows_all[g * H : g * H + h_g]
            hot_rows_groups.append(hr)

    bucketed = BucketedRatings(
        tuple(normal_chunks), tuple(hot_chunks), tuple(hot_rows_groups),
        num_rows, num_cols, nnz_global, padded_global,
    )
    return bucketed, seg.rated


def _allgather_coo(rows, cols, vals) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mesh-less multi-process training: every process gathers every
    process's COO shard (process order), so each holds the job's ratings
    and trains them alone (the JAX package's ``_allgather_coo``)."""
    from predictionio_tpu_torch.parallel.exchange import allgather_objects

    parts = allgather_objects(
        (np.asarray(rows, np.int64), np.asarray(cols, np.int64), np.asarray(vals, np.float32))
    )
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(3))


def _global_rated(rated: np.ndarray) -> np.ndarray:
    """The OR of every process's rated mask."""
    from predictionio_tpu_torch.parallel.exchange import allgather_objects

    packed = np.bitwise_or.reduce(allgather_objects(np.packbits(rated)))
    return np.unpackbits(packed, count=rated.size).astype(bool)


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
    solver: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One full ALS iteration, in place: users given items, then items
    given users, each solve through ``spd_solve(method=solver)``. Tables
    carry the zero sentinel row."""
    with torch.no_grad():
        half_sweep(user_factors, item_factors, user_bucketed, reg, implicit, alpha, solver)
        half_sweep(item_factors, user_factors, item_bucketed, reg, implicit, alpha, solver)
    return user_factors, item_factors


# ---------------------------------------------------------------------------
# The sweep on a mesh
# ---------------------------------------------------------------------------


class MeshBuckets(NamedTuple):
    """One side's buckets on a mesh: ``normal[k][d][m]`` is bucket ``k``'s
    chunk arrays for data position ``d`` (its ``C/data`` rows of every
    chunk) on model position ``m``'s device; ``hot`` likewise per group;
    ``hot_rows[g]`` the group's slot map on the lead device."""

    normal: tuple
    hot: tuple
    hot_rows: tuple
    num_rows: int


def mesh_buckets(b: BucketedRatings, mesh, model_axis: str = "model") -> MeshBuckets:
    """Place host buckets on ``mesh``: every chunk's rows split in equal
    parts over the data positions, each part on its row's devices (one
    tensor a device: a repeated device shares it)."""
    D = len(mesh.devices) // mesh.local(model_axis)

    def split(ch: _Chunked) -> tuple:
        C = ch.row_id.shape[1]
        if C % D:
            raise ValueError(f"chunk rows ({C}) do not split over {D} data positions")
        per = C // D
        parts = []
        for d in range(D):
            sl = slice(d * per, (d + 1) * per)
            row = mesh.row(d, model_axis)
            base = _Chunked(
                torch.from_numpy(np.ascontiguousarray(ch.row_id[:, sl], np.int64)).to(row[0]),
                torch.from_numpy(np.ascontiguousarray(ch.idx[:, sl])).to(row[0]),
                torch.from_numpy(np.ascontiguousarray(ch.val[:, sl])).to(row[0]),
                torch.from_numpy(np.ascontiguousarray(ch.mask[:, sl])).to(row[0]),
            )
            parts.append(tuple(_Chunked(*(t.to(dev) for t in base)) for dev in row))
        return tuple(parts)

    lead = mesh.devices[0]
    return MeshBuckets(
        tuple(split(ch) for ch in b.normal),
        tuple(split(ch) for ch in b.hot),
        tuple(torch.from_numpy(np.asarray(hr, np.int64)).to(lead) for hr in b.hot_rows),
        b.num_rows,
    )


def mesh_tables(host: np.ndarray, mesh, model_axis: str = "model") -> tuple:
    """A ``[rows + 1, K]`` host table laid out on ``mesh``: for each data
    position a :class:`~predictionio_tpu_torch.parallel.sharding.ShardedTable`
    over its model positions, each holding ``[rows/model, K]`` (zero rows
    pad the split)."""
    from predictionio_tpu_torch.parallel.sharding import ServingMesh, shard_table

    D = len(mesh.devices) // mesh.local(model_axis)
    return tuple(shard_table(host, ServingMesh(mesh.row(d, model_axis))) for d in range(D))


#: rows of every batched Gramian product on a mesh: cuBLAS picks its
#: kernel, and with it the order of each product's sums, by the batch
#: count too, so a data position's part of a chunk is formed in blocks of
#: this many rows (the last one zero-padded), and a row's Gramian has the
#: same bits whichever mesh shape, data position or process holds it
GRAM_ROWS = 1024


def _partials_in_blocks(
    Q: torch.Tensor, val: torch.Tensor, mask: torch.Tensor, implicit: bool, alpha: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_partials` on ``GRAM_ROWS`` rows at a time."""
    C = Q.shape[0]
    parts = []
    for lo in range(0, C, GRAM_ROWS):
        hi = min(lo + GRAM_ROWS, C)
        q, v, m = Q[lo:hi], val[lo:hi], mask[lo:hi]
        if hi - lo < GRAM_ROWS:
            pad = GRAM_ROWS - (hi - lo)
            q, v, m = F.pad(q, (0, 0, 0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad)), F.pad(m, (0, 0, 0, pad))
        parts.append(tuple(t[: hi - lo] for t in _partials(q, v, m, implicit, alpha)))
    return tuple(torch.cat(ts) for ts in zip(*parts))


def _hot_accumulators(num_slots: int, K: int, device) -> tuple:
    """Zeroed ``(A [S, K, K], [b | n] [S, K + 1])`` for one hot group."""
    return (torch.zeros((num_slots, K, K), device=device), torch.zeros((num_slots, K + 1), device=device))


def _accumulate_in_order(acc: tuple, slot: torch.Tensor, A: torch.Tensor, b: torch.Tensor, n: torch.Tensor) -> None:
    """``acc[slot] += (A, b, n)`` into a hot group's accumulators
    (:func:`_hot_accumulators`), repeats of a slot summed in ``slot``'s
    order. On CUDA ``index_add_`` adds them by atomics in no fixed order,
    while ``index_put_`` with ``accumulate`` sorts the indices (stably)
    and sums each slot's rows one after the other; on the CPU
    ``index_add_`` adds in order (and ``index_put_`` does not). ``b`` and
    ``n`` share one accumulator, and so one sort."""
    A_acc, bn_acc = acc
    bn = torch.cat([b, n[:, None]], dim=1)
    if A_acc.device.type == "cuda":
        A_acc.index_put_((slot,), A, accumulate=True)
        bn_acc.index_put_((slot,), bn, accumulate=True)
    else:
        A_acc.index_add_(0, slot, A)
        bn_acc.index_add_(0, slot, bn)


def _solve_accumulated(acc: tuple, reg: float, yty, solver: str) -> torch.Tensor:
    A_acc, bn_acc = acc
    K = A_acc.shape[-1]
    return _finish_solve(A_acc, bn_acc[:, :K], bn_acc[:, K], reg, yty, solver)


def _gram_sharded(other, parts: tuple, c: int, implicit: bool, alpha: float, out: torch.device) -> tuple:
    """Partial normal equations of one data position's part of chunk
    ``c`` against a model-sharded opposite table: each model position
    gathers only the entries its shard owns (the others masked to zero),
    the gathers are summed over the model positions on ``out`` (every
    entry has one owner, so the sum is the unsharded gather to the bit),
    and the Gramians are formed there — the JAX package's ``_gram_chunk``
    under ``shard_map``, whose ``psum`` runs over the Gramians instead."""
    rps = other.rows_per_shard
    Q = None
    for m, (shard, ch) in enumerate(zip(other.shards, parts)):
        idx = ch.idx[c]
        C, L = idx.shape
        local = idx - m * rps
        inr = (local >= 0) & (local < rps)
        part = shard.index_select(0, torch.where(inr, local, 0).reshape(-1)).view(C, L, -1)
        part = (part * (ch.mask[c] * inr)[..., None]).to(out)
        Q = part if Q is None else Q.add_(part)
    lead = parts[0]
    return _partials_in_blocks(Q, lead.val[c], lead.mask[c], implicit, alpha)


def _write_rows(tables: tuple, ids: torch.Tensor, x: torch.Tensor, num_rows: int) -> None:
    """Rows ``ids`` (global) of every data position's sharded table set to
    ``x``, each row in its owner shard; the sentinel row re-zeroed."""
    for tbl in tables:
        rps = tbl.rows_per_shard
        owner = torch.div(ids, rps, rounding_mode="floor")
        for m, shard in enumerate(tbl.shards):
            sel = owner == m
            shard.index_copy_(0, (ids[sel] - m * rps).to(shard.device), x[sel].to(shard.device))
        s, r = divmod(num_rows, rps)
        tbl.shards[s][r].zero_()


def mesh_half_sweep(
    tables: tuple,  # per data position: the updated side's ShardedTable, in place
    others: tuple,  # per data position: the opposite side's ShardedTable
    side: MeshBuckets,
    reg: float,
    implicit: bool,
    alpha: float,
    solver: str,
) -> tuple:
    """One half-sweep on a mesh (the JAX package's ``_half_sweep`` with a
    mesh): every data position solves its part of every normal chunk on
    its device; hot-row Gramians are summed over the data positions (and
    the processes) before their solve; then the solved rows are gathered
    from every position (and process) into every position's shards."""
    from predictionio_tpu_torch.parallel import distributed

    lead = tables[0].mesh[0]
    yty = None
    if implicit:  # padding and sentinel rows are zero: no-op terms
        for shard in others[0].shards:
            part = (shard.T @ shard).to(lead)
            yty = part if yty is None else yty + part

    ids_parts, x_parts = [], []
    for bucket in side.normal:
        for c in range(bucket[0][0].row_id.shape[0]):
            for d, parts in enumerate(bucket):
                dev = tables[d].mesh[0]
                A, b, n = _gram_sharded(others[d], parts, c, implicit, alpha, dev)
                x = _finish_solve(A, b, n, reg, None if yty is None else yty.to(dev), solver)
                ids_parts.append(parts[0].row_id[c].to(lead))
                x_parts.append(x.to(lead))
    K = tables[0].shape[1]
    ids = torch.cat(ids_parts) if ids_parts else torch.zeros(0, dtype=torch.int64, device=lead)
    xs = torch.cat(x_parts) if x_parts else torch.zeros((0, K), dtype=torch.float32, device=lead)
    if distributed.is_multihost():
        ids = torch.cat(distributed.all_gather_tensor(ids))
        xs = torch.cat(distributed.all_gather_tensor(xs))

    hot_ids, hot_xs = [], []
    for bucket, hot_rows_g in zip(side.hot, side.hot_rows):
        acc = _hot_accumulators(int(hot_rows_g.shape[0]), K, lead)  # H_g + sentinel slots
        # the psum over the data positions, in chunk order and within a
        # chunk in data-position order (a chunk's rows in their order),
        # then over the processes
        for c in range(bucket[0][0].row_id.shape[0]):
            for d, parts in enumerate(bucket):
                partial = _gram_sharded(others[d], parts, c, implicit, alpha, tables[d].mesh[0])
                _accumulate_in_order(acc, parts[0].row_id[c].to(lead), *(p.to(lead) for p in partial))
        for t in acc:
            distributed.all_reduce_(t)
        hot_ids.append(hot_rows_g)
        hot_xs.append(_solve_accumulated(acc, reg, yty, solver))

    _write_rows(tables, torch.cat([ids, *hot_ids]), torch.cat([xs, *hot_xs]), side.num_rows)
    return tables


def mesh_sweep(user_tables: tuple, item_tables: tuple, user_side: MeshBuckets, item_side: MeshBuckets,
               reg: float, implicit: bool, alpha: float, solver: str = "auto") -> tuple:
    """One full ALS iteration on a mesh, in place (:func:`mesh_half_sweep`
    for the users, then the items), each solve through
    ``spd_solve(method=solver)``."""
    with torch.no_grad():
        mesh_half_sweep(user_tables, item_tables, user_side, reg, implicit, alpha, solver)
        mesh_half_sweep(item_tables, user_tables, item_side, reg, implicit, alpha, solver)
    return user_tables, item_tables


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def seed_factors(num_rows: int, rank: int, seed: int, implicit: bool) -> np.ndarray:
    """The cold-start draw, ``[num_rows, rank]`` float32 on the host:
    ``|N(0,1)|`` rows from a ``torch.Generator`` seeded with ``seed``,
    scaled by ``1/sqrt(rank)`` (explicit) or normalized to unit L2
    (implicit, MLlib's init). Made on the CPU so every device and every
    process starts from the same numbers."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    draw = torch.randn((num_rows, rank), generator=gen, dtype=torch.float32).abs()
    if implicit:
        draw = draw / draw.norm(dim=1, keepdim=True).clamp_min(1e-9)
    else:
        draw = draw * (1.0 / np.sqrt(rank))
    return draw.numpy()


@contextlib.contextmanager
def _matmul_precision(precision: str, cuda: bool):
    """float32 products at ``ALSConfig.precision`` on the card while the
    block runs ("highest": TF32 off, the JAX package's default), and the
    process's settings as they were after it, whether it returns or
    raises: a server in the same process relies on full f32 products."""
    if not cuda:
        yield
        return
    tf32, saved = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(_PRECISIONS[precision])
    try:
        yield
    finally:
        # the flag first: setting it rewrites the precision ("medium" too)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(saved)


def _host_table(init: np.ndarray, num_rows: int, rank: int, rated: np.ndarray) -> np.ndarray:
    """The canonical ``[num_rows + 1, rank]`` table from an init (sentinel
    row and unrated rows zero; a narrower init fills the leading columns)."""
    init = np.asarray(init, dtype=np.float32)
    if init.shape[0] != num_rows:
        raise ValueError(f"init has {init.shape[0]} rows, expected {num_rows}")
    table = np.zeros((num_rows + 1, rank), np.float32)
    k = min(rank, init.shape[1])
    table[:num_rows, :k] = init[:, :k]
    table[:num_rows][~rated] = 0.0
    return table


def _resume(manager, num_users: int, num_items: int, rank: int, iterations: int):
    """``(step, {"user", "item"} canonical host tensors)`` of the latest
    compatible checkpoint, or ``(0, None)``."""
    latest = manager.latest_step()
    if latest is None:
        return 0, None
    like = {"user": torch.empty((num_users + 1, rank)), "item": torch.empty((num_items + 1, rank))}
    try:
        state = manager.restore(latest, like=like)
    except ValueError as exc:
        # shape drift only (another rank or catalog); I/O errors propagate
        logging.getLogger(__name__).warning(
            "Checkpoint step %d is incompatible with this run (%s); starting fresh", latest, exc
        )
        return 0, None
    logging.getLogger(__name__).info("Resumed ALS from checkpoint step %d", latest)
    return min(latest, iterations), state


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
    on_sweep: Callable[[int, Any, Any], None] | None = None,
    mesh=None,
    data_axis: str = "data",
    model_axis: str = "model",
) -> ALSFactors:
    """Train factor matrices from COO ratings on ``device`` (default: the
    card) or on ``mesh`` (a
    :class:`~predictionio_tpu_torch.controller.context.TrainingMesh`; a
    mesh of one position is the single-device path on that position).

    In a multi-process job ``rows/cols/vals`` are this process's shard of
    the ratings: with a mesh they are re-partitioned by row through the
    bounded exchange (:func:`_multihost_bucketed`), without one gathered
    whole onto every process (:func:`_allgather_coo`).

    ``init_user``/``init_item`` (``[num_users, K]`` / ``[num_items, K]``)
    replace the cold-start draw of :func:`seed_factors`; unrated rows are
    zeroed either way, and a checkpoint resume (``config.checkpoint_dir``)
    takes precedence. ``on_sweep(step, user, item)`` is called after each
    sweep: single-device with views of the tables (no sentinel row), on a
    mesh with data position 0's
    :class:`~predictionio_tpu_torch.parallel.sharding.ShardedTable`\\ s
    (padding rows included).

    ``config.bucketing`` picks where the ratings are bucketed (one device
    on the card: :func:`build_buckets_device` on the COO uploaded once;
    otherwise :func:`build_buckets`), ``config.solver`` the
    :func:`spd_solve` method (on a mesh too), ``config.precision`` the
    sweeps' float32 products, and ``config.rank_pad_multiple`` pads K.

    Returns ``ALSFactors``: ``user [num_users, K]``, ``item [num_items,
    K]`` (K the padded rank), on ``device``, or (mesh) on the host,
    assembled from the shards.
    """
    from predictionio_tpu_torch.parallel import distributed

    if config.precision not in _PRECISIONS:
        raise ValueError(f"ALSConfig.precision must be one of {sorted(_PRECISIONS)}, got {config.precision!r}")
    if config.solver not in _SOLVERS:
        raise ValueError(
            f"ALSConfig.solver must be 'auto', 'cholesky', 'pallas' or 'pallas_interpret', got {config.solver!r}"
        )
    if config.bucketing not in ("auto", "host", "device"):
        raise ValueError(f"ALSConfig.bucketing must be 'auto', 'host' or 'device', got {config.bucketing!r}")
    solver = _SOLVERS[config.solver]
    if mesh is not None and mesh.size == 1:
        device, mesh = mesh.devices[0], None
    devices = mesh.devices if mesh is not None else (resolve_device(device),)
    dev = resolve_device(devices[0])
    cuda = any(d.type == "cuda" for d in devices)

    multihost = distributed.is_multihost()
    kw = dict(widths=config.bucket_widths, chunk_entries=config.chunk_entries,
              hot_group_slots=config.hot_group_slots)
    if mesh is None and multihost:
        rows, cols, vals = _allgather_coo(rows, cols, vals)
    coo = None
    if mesh is None and not multihost and (
        config.bucketing == "device" or (config.bucketing == "auto" and dev.type == "cuda")
    ):
        # one upload for both sides; None: the host cases
        coo = _device_coo(rows, cols, vals, num_users, num_items, dev)
    if coo is not None:
        user_side, u_rated = build_buckets_device(*coo, num_users, num_items, **kw)
        item_side, i_rated = build_buckets_device(coo[1], coo[0], coo[2], num_items, num_users, **kw)
        del coo
    elif mesh is not None and multihost:
        data = mesh.local(data_axis)
        user_b, u_rated = _multihost_bucketed(rows, cols, vals, num_users, num_items, data, **kw)
        item_b, i_rated = _multihost_bucketed(cols, rows, vals, num_items, num_users, data, **kw)
        u_rated, i_rated = _global_rated(u_rated), _global_rated(i_rated)
    else:
        row_multiple = 8 if mesh is None else math.lcm(8, mesh.local(data_axis))
        user_b = build_buckets(rows, cols, vals, num_users, num_items, row_multiple=row_multiple, **kw)
        item_b = build_buckets(cols, rows, vals, num_items, num_users, row_multiple=row_multiple, **kw)
        u_rated, i_rated = rated_row_mask(user_b), rated_row_mask(item_b)
        if mesh is None:
            user_side, item_side = to_device_buckets(user_b, dev), to_device_buckets(item_b, dev)
            del user_b, item_b

    rank = config.rank
    if config.rank_pad_multiple:
        rank = -(-rank // config.rank_pad_multiple) * config.rank_pad_multiple
    if init_user is None:
        init_user = seed_factors(num_users, rank, config.seed, config.implicit)
    if init_item is None:
        init_item = seed_factors(num_items, rank, config.seed + 1, config.implicit)
    uh = _host_table(init_user, num_users, rank, u_rated)
    vh = _host_table(init_item, num_items, rank, i_rated)

    manager = None
    start = 0
    if config.checkpoint_dir:
        from predictionio_tpu_torch.utils.checkpoint import CheckpointManager

        manager = CheckpointManager(config.checkpoint_dir)
        start, state = _resume(manager, num_users, num_items, rank, config.iterations)
        if state is not None:
            uh, vh = state["user"].numpy(), state["item"].numpy()

    if mesh is None:
        uf, vf = torch.from_numpy(uh).to(dev), torch.from_numpy(vh).to(dev)

        def sweep() -> None:
            als_sweep(uf, vf, user_side, item_side, config.reg, config.implicit, config.alpha, solver)

        def canonical() -> dict:
            return {"user": uf, "item": vf}

        def views() -> tuple:
            return uf[:num_users], vf[:num_items]
    else:
        user_side = mesh_buckets(user_b, mesh, model_axis)
        item_side = mesh_buckets(item_b, mesh, model_axis)
        del user_b, item_b
        uf, vf = mesh_tables(uh, mesh, model_axis), mesh_tables(vh, mesh, model_axis)

        def sweep() -> None:
            mesh_sweep(uf, vf, user_side, item_side, config.reg, config.implicit, config.alpha, solver)

        def canonical() -> dict:
            return {
                "user": torch.from_numpy(np.asarray(uf[0])[: num_users + 1]),
                "item": torch.from_numpy(np.asarray(vf[0])[: num_items + 1]),
            }

        def views() -> tuple:
            return uf[0], vf[0]

    for step in range(start, config.iterations):
        with _matmul_precision(config.precision, cuda):
            sweep()
        if on_sweep is not None:
            on_sweep(step, *views())
        if manager is not None and (
            (step + 1) % config.checkpoint_interval == 0 or step + 1 == config.iterations
        ):
            manager.save(step + 1, canonical())
    if mesh is None:
        return ALSFactors(user=uf[:num_users], item=vf[:num_items])
    final = canonical()
    return ALSFactors(user=final["user"][:num_users], item=final["item"][:num_items])


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
