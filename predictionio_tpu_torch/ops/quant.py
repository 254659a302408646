"""Per-row symmetric int8 quantization — the ``--quantize int8`` tier.

Counterpart of ``predictionio_tpu/ops/quant.py``. Factor tables (and
IVF slabs, :mod:`predictionio_tpu_torch.ops.ivf`) are served as **int8
codes plus one f32 scale per row**: ``rank + 4`` bytes a row instead of
``4·rank``. Quality is kept by a recall-guarded two-stage top-K:

1. **int8 coarse scan** — the query row is quantized too and scored
   against the whole table; the sums of code products are exact, then
   rescaled by the product of the two scales. It over-fetches
   ``k' = max(4k, k + 64)`` candidates (:func:`overfetch`).
2. **f32 rescore** — only the ``k'`` gathered candidates are dequantized
   and scored against the f32 query, then merged under the shared tie
   rule (:func:`~predictionio_tpu_torch.ops.topk.sort_merge_topk`).

One rounding rule, in this module only: ``scale = amax(|row|) ·
float32(1/127)`` (a reciprocal multiply, never a division by 127),
``code = round_half_even(row / scale)`` clipped to ±127, all-zero rows
scale 0 with zero codes. :func:`quantize_rows` (tensors, on their
device) and :func:`quantize_table_host` (numpy) apply it bit for bit
alike: the build quantizes on the card, the online fold re-quantizes
touched rows on the host, and both must write the same codes.

The coarse scan (:func:`int8_matmul`) takes an f32 product of the cast
codes: every code is an integer of at most 127 in magnitude, exact in
f32 and in TF32, and every partial sum an integer below ``127² · K``,
exact in f32 while that is below 2^24 (K ≤ 1040), whatever the order of
the sums.

Sharded (``pio deploy --shard-factors --quantize int8``): the codes and
scales are :class:`~predictionio_tpu_torch.parallel.sharding.ShardedTable` tables
and :func:`run_topk`/:func:`topk_users` take ``shards=`` (the model's
``ShardInfo``) to
:func:`~predictionio_tpu_torch.parallel.sharding.sharded_quantized_topk_users`.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.topk import bucket_k, sort_merge_topk, top_k_scores

__all__ = [
    "QuantizedTable",
    "QuantRuntime",
    "quantize_rows",
    "quantize_table_host",
    "quantize_slabs",
    "dequantize",
    "quantize_table",
    "quantization_error",
    "overfetch",
    "int8_matmul",
    "quantized_topk_batch",
    "quantized_topk_users",
    "run_topk",
    "topk_users",
    "table_bytes_f32",
]

#: symmetric code range: [-127, 127] (the -128 slot is unused so the
#: range is symmetric and negation is exact)
_QMAX = 127.0
#: the scale's factor, rounded to f32 once (the JAX package's constant)
_INV_QMAX = np.float32(1.0 / _QMAX)
#: widest rank whose int8 code products sum exactly in f32 (127² · K < 2^24)
MAX_EXACT_RANK = (1 << 24) // (127 * 127)


# ---------------------------------------------------------------------------
# Quantize / dequantize primitives (the ONE rounding rule)
# ---------------------------------------------------------------------------


def quantize_rows(mat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``mat [..., K]`` f32 tensor -> ``(codes [..., K] int8, scales [...]
    f32)`` on ``mat``'s device, by the module's one rule (reciprocal
    multiply, round-half-even, zero-row guard)."""
    mat = mat.to(torch.float32)
    amax = mat.abs().amax(dim=-1)
    scales = amax * torch.tensor(_INV_QMAX, device=mat.device)
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    codes = torch.clamp(torch.round(mat / safe[..., None]), -_QMAX, _QMAX).to(torch.int8)
    return codes, scales


def quantize_table_host(mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Numpy mirror of :func:`quantize_rows` (same rounding, same
    zero-row guard): the IVF host mirror's per-lane re-quantize and the
    online fold's touched rows."""
    mat = np.asarray(mat, np.float32)
    amax = np.max(np.abs(mat), axis=-1)
    scales = (amax * _INV_QMAX).astype(np.float32)
    safe = np.where(scales > 0, scales, np.float32(1.0))
    codes = np.clip(np.rint(mat / safe[..., None]), -_QMAX, _QMAX).astype(np.int8)
    return codes, scales


def quantize_slabs(slabs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Quantize IVF cluster-major slabs ``[nlist, W, K]`` per LANE row:
    ``(codes [nlist, W, K] int8, scales [nlist, W] f32)``. Zero-padded
    lanes quantize to zero codes and zero scale."""
    return quantize_table_host(np.asarray(slabs, np.float32))


def dequantize(codes, scales):
    """``codes [..., K] * scales [...]`` -> f32 rows, for numpy arrays and
    tensors alike."""
    if isinstance(codes, np.ndarray):
        return codes.astype(np.float32) * np.asarray(scales, np.float32)[..., None]
    return codes.to(torch.float32) * scales[..., None]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def quantization_error(mat: np.ndarray, codes, scales) -> dict:
    """Error accounting for the ``/stats.json`` ``quant`` block: how far
    the dequantized table sits from the f32 original (``maxRelError`` is
    per row, relative to the row's own magnitude)."""
    mat = np.asarray(mat, np.float32)
    deq = dequantize(_host(codes), _host(scales))
    err = np.abs(deq - mat)
    amax = np.maximum(np.max(np.abs(mat), axis=-1, keepdims=True), 1e-12)
    return {
        "maxAbsError": round(float(err.max()) if err.size else 0.0, 6),
        "rmsError": round(float(np.sqrt(np.mean(err * err))) if err.size else 0.0, 6),
        "maxRelError": round(float((err / amax).max()) if err.size else 0.0, 6),
    }


def overfetch(k: int, limit: int) -> int:
    """Coarse-stage candidate count ``k' = max(4k, k+64)``, clamped to the
    catalog."""
    return max(1, min(int(limit), max(4 * int(k), int(k) + 64)))


def table_bytes_f32(rows: int, rank: int) -> int:
    """What the same table would cost served f32 (the ``bytesSaved``
    baseline)."""
    return int(rows) * int(rank) * 4


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(a.size) * a.dtype.itemsize


# ---------------------------------------------------------------------------
# The served container
# ---------------------------------------------------------------------------


class QuantizedTable:
    """An int8-served factor table: ``codes [N, K]`` and per-row ``scales
    [N]``, tensors on the serving device (or host numpy). Quacks enough
    like a table for the serving and fold paths: ``shape``/``len``,
    ``device``, a dequantizing ``__getitem__`` (only the rows asked for),
    and ``__array__`` (the whole table as host f32, for release and the
    index build)."""

    #: duck-type marker (isinstance would make the default serving path
    #: import this module just to check)
    is_quantized = True

    __slots__ = ("codes", "scales")

    def __init__(self, codes, scales):
        self.codes = codes
        self.scales = scales

    @property
    def shape(self) -> tuple:
        return tuple(self.codes.shape)

    @property
    def device(self) -> torch.device:
        """The codes' device (a sharded table's: its lead device)."""
        return getattr(self.codes, "device", torch.device("cpu"))

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    def __getitem__(self, idx):
        """Dequantized f32 row(s): the fold's prior gather and the ANN
        path's query rows read through here."""
        if isinstance(self.codes, torch.Tensor) and isinstance(idx, (np.ndarray, list, tuple)):
            idx = torch.as_tensor(np.asarray(idx, np.int64), device=self.codes.device)
        return dequantize(self.codes[idx], self.scales[idx])

    def __array__(self, dtype=None, copy=None):
        full = dequantize(_host(self.codes), _host(self.scales))
        return full.astype(dtype) if dtype is not None else full

    @property
    def nbytes_codes(self) -> int:
        return _nbytes(self.codes)

    @property
    def nbytes_scales(self) -> int:
        return _nbytes(self.scales)


def quantize_table(mat, device: str | torch.device | None = None) -> QuantizedTable:
    """Quantize a host f32 table on ``device`` (default: the card) and keep
    its codes and scales there — the ``--quantize`` layout."""
    dev = resolve_device(device)
    return QuantizedTable(*quantize_rows(torch.tensor(np.asarray(mat, np.float32), device=dev)))


# ---------------------------------------------------------------------------
# Two-stage top-K
# ---------------------------------------------------------------------------


def int8_matmul(q_codes: torch.Tensor, table_codes: torch.Tensor) -> torch.Tensor:
    """``q_codes [B, K] @ table_codes.T [K, N]`` summed exactly, as int32
    (the module docstring says why the f32 product is exact)."""
    if q_codes.shape[-1] > MAX_EXACT_RANK:
        raise ValueError(f"rank {q_codes.shape[-1]} > {MAX_EXACT_RANK}: int8 sums would not be exact in f32")
    acc = q_codes.to(torch.float32) @ table_codes.to(torch.float32).T
    return acc.to(torch.int32)


def _two_stage_topk(qvecs, codes, scales, k: int, kp: int, num_items: int):
    """int8 coarse scan -> ``kp`` over-fetch -> f32 rescore of the
    gathered candidates -> tie-stable merge. Rows from ``num_items`` on
    (growth padding) never rank: they carry the ``num_items`` sentinel at
    ``-inf``."""
    q_codes, q_scales = quantize_rows(qvecs)
    acc = int8_matmul(q_codes, codes)  # [B, N]
    approx = acc.to(torch.float32) * q_scales[:, None] * scales[None, :]
    gid = torch.arange(codes.shape[0], device=codes.device)
    approx = torch.where(gid[None, :] < num_items, approx, torch.full_like(approx, -torch.inf))
    cand = top_k_scores(approx, kp)[0]  # positions ARE ids; ties to the lower id
    deq = dequantize(codes[cand], scales[cand])  # [B, kp, K]
    exact = torch.einsum("bpk,bk->bp", deq, qvecs.to(torch.float32))
    valid = cand < num_items
    exact = torch.where(valid, exact, torch.full_like(exact, -torch.inf))
    ids = torch.where(valid, cand, torch.full_like(cand, num_items))
    return sort_merge_topk(exact, ids, min(int(k), int(kp)))


def quantized_topk_batch(qvecs, codes, scales, k: int, kp: int, num_items: int):
    """Two-stage top-k for a batch of f32 query VECTORS against an int8
    table: ``([B, k] ids, [B, k] f32 rescored scores)``, descending
    score, ties by ascending id."""
    return _two_stage_topk(qvecs, codes, scales, k, kp, int(num_items))


def quantized_topk_users(user_idx, u_codes, u_scales, i_codes, i_scales, k: int, kp: int, num_items: int):
    """Two-stage top-k for a batch of USER indices: the user rows are
    dequantized on their device (the f32 queries of the rescore)."""
    q = dequantize(u_codes[user_idx], u_scales[user_idx])
    return _two_stage_topk(q, i_codes, i_scales, k, kp, int(num_items))


# ---------------------------------------------------------------------------
# Host-facing wrappers + runtime accounting
# ---------------------------------------------------------------------------


class QuantRuntime:
    """Per-model serving state of the quantized tier (``model._pio_quant``,
    set by the ``quantize_model_for_serving`` hooks): the mode, the byte
    ledger (codes/scales against the f32 baseline), the measured
    quantization error and thread-safe counters for ``/stats.json``
    ``quant``, the rescore depth each bucket paid included. A copy of
    the JAX package's class."""

    def __init__(self, mode: str, bytes_by_dtype: dict, bytes_f32: int, error: dict | None = None):
        self.mode = str(mode)
        self.bytes_by_dtype = dict(bytes_by_dtype)
        self.bytes_f32 = int(bytes_f32)
        self.error = dict(error or {})
        self._lock = threading.Lock()
        self.queries = 0
        self.rescored = 0  # total candidates rescored (sum of k')
        self.rescore_depth_max = 0

    def note(self, n_queries: int, rescore_depth: int) -> None:
        with self._lock:
            self.queries += int(n_queries)
            self.rescored += int(n_queries) * int(rescore_depth)
            self.rescore_depth_max = max(self.rescore_depth_max, int(rescore_depth))

    def stats_json(self) -> dict:
        with self._lock:
            q = self.queries
            rescored = self.rescored
            depth_max = self.rescore_depth_max
        total = sum(self.bytes_by_dtype.values())
        return {
            "dtype": self.mode,
            "bytesByDtype": dict(self.bytes_by_dtype),
            "bytesTotal": total,
            "bytesF32Equivalent": self.bytes_f32,
            "bytesSaved": self.bytes_f32 - total,
            "overfetch": "max(4k, k+64)",
            "queries": q,
            "candidatesRescored": rescored,
            "rescoreDepthMax": depth_max,
            "rescoreDepthMean": round(rescored / q, 1) if q else 0.0,
            "quantizationError": dict(self.error),
        }


def run_topk(runtime: QuantRuntime, user_qt: QuantizedTable, item_qt: QuantizedTable, user_idx, k: int,
             shards=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the quantized serving path, results left on the
    device (callers stage chunks and cross to the host once). ``k`` is
    the caller's bucketed fetch size; the over-fetch derives from it.
    ``shards`` (a ``ShardInfo``) routes sharded tables through the sharded
    kernel, over the logical item count."""
    idx = torch.as_tensor(np.asarray(user_idx, np.int64), device=item_qt.device)
    if shards is not None:
        from predictionio_tpu_torch.parallel import sharding

        num_items = int(shards.rows["item"])
        kp = overfetch(k, num_items)
        ids, scores = sharding.sharded_quantized_topk_users(
            idx, user_qt.codes, user_qt.scales, item_qt.codes, item_qt.scales, k, kp, num_items
        )
    else:
        num_items = int(item_qt.shape[0])
        kp = overfetch(k, num_items)
        ids, scores = quantized_topk_users(
            idx, user_qt.codes, user_qt.scales, item_qt.codes, item_qt.scales, k, kp, num_items
        )
    runtime.note(int(idx.shape[0]), kp)
    return ids, scores


def topk_users(runtime: QuantRuntime, user_qt: QuantizedTable, item_qt: QuantizedTable, user_idx, k: int,
               shards=None) -> tuple[np.ndarray, np.ndarray]:
    """Top-``k`` for a batch of user indices as numpy — the single-query
    predict path. ``k`` buckets to a power of two (floor 16), like every
    other tier; sharded tables (``shards``) rank their logical items."""
    num_items = int(shards.rows["item"]) if shards is not None else int(item_qt.shape[0])
    k = max(1, min(int(k), num_items))
    kb = bucket_k(k, num_items)
    ids, scores = run_topk(runtime, user_qt, item_qt, np.asarray(user_idx, np.int64), kb, shards=shards)
    ids = ids.cpu().numpy()
    scores = scores.cpu().numpy()
    out_i, out_s = [], []
    for r in range(ids.shape[0]):
        keep = ids[r] < num_items
        out_i.append(ids[r][keep][:k])
        out_s.append(scores[r][keep][:k])
    return np.asarray(out_i), np.asarray(out_s)
