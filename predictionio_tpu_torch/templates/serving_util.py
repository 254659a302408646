"""Shared serving-path helpers for engine templates.

Counterpart of ``predictionio_tpu/templates/serving_util.py``:

* :func:`chunked_topk`, the exact branches only. Its host branch is the
  JAX package's numpy code (one GEMM and :func:`top_k_host` a chunk), so
  the two packages' host answers are equal to the bit; its device branch
  scores each chunk with one ``[B,K]@[K,I]`` product on the tensors'
  device and crosses to the host once for the whole call. The IVF,
  sharded, int8 and AOT branches wait (ROADMAP queue 1 items 7, 13, 8
  and 14) and raise ``NotImplementedError`` naming their item.
* :func:`aligned_factor_init`, a copy: a warm retrain's carried rows.
* :func:`release_tables`: both templates' release of pinned tables.

``device_latency_ok`` is not ported on purpose: in the JAX package it
moves serving to the host when the device answers slowly, and the port
never leaves the device without being asked (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.ops.als import top_k_items_batch
from predictionio_tpu_torch.ops.topk import bucket_k, top_k_host

__all__ = ["TOPK_CHUNK", "chunked_topk", "aligned_factor_init", "release_tables"]

#: queries per score product in :func:`chunked_topk` (the JAX package's
#: value, so a host chunk's GEMM has the same shape in both packages)
TOPK_CHUNK = 2048


def chunked_topk(
    user_mat, item_mat, valid: Sequence[tuple], chunk: int = TOPK_CHUNK,
    ann=None, shards=None, quant=None, aot=None,
) -> Iterator[tuple[list, list, list]]:
    """Chunked batch top-k over ``valid = [(slot, uidx, k), ...]``;
    yields ``(part, ids, scores)`` with ids/scores as Python lists of
    ``bucket_k(max k)`` entries a row (each caller trims its own k).

    Host tables (numpy) take one numpy GEMM and :func:`top_k_host` a
    chunk. Tensor tables (pinned on the card, or on the CPU when the
    caller asked for it) take one :func:`top_k_items_batch` a chunk, at
    the chunk's own row count (the micro-batcher already pads to its
    buckets); every chunk's ids and scores are packed into one int32
    tensor on the device, so the call crosses to the host once."""
    # the tiers not ported yet, by the ROADMAP queue 1 item each waits for
    waiting = (("ann", ann, 7), ("shards", shards, 13), ("quant", quant, 8), ("aot", aot, 14))
    for name, tier, item in waiting:
        if tier is not None:
            raise NotImplementedError(
                f"chunked_topk({name}=...) waits for ROADMAP queue 1 item {item}"
            )
    if not valid:
        return
    n_items = int(item_mat.shape[0])
    k_max = bucket_k(max(k for _, _, k in valid), n_items)
    if isinstance(item_mat, np.ndarray):
        for lo in range(0, len(valid), chunk):
            part = list(valid[lo : lo + chunk])
            uidx_arr = np.fromiter((u for _, u, _ in part), np.int32, len(part))
            scores = np.asarray(user_mat)[uidx_arr] @ np.asarray(item_mat).T  # [B, I]
            # descending score, ties to the lower item index (ops/topk.py)
            idx_b, score_b = top_k_host(scores, k_max)
            yield part, idx_b.tolist(), score_b.tolist()
        return
    parts: list[list] = []
    packed: list[torch.Tensor] = []
    for lo in range(0, len(valid), chunk):
        part = list(valid[lo : lo + chunk])
        uidx = torch.as_tensor(
            np.fromiter((u for _, u, _ in part), np.int64, len(part)), device=item_mat.device
        )
        idx_b, score_b = top_k_items_batch(uidx, user_mat, item_mat, k_max)
        # ids fit int32; the scores travel as their f32 bit patterns
        packed.append(torch.cat([idx_b.to(torch.int32), score_b.view(torch.int32)], dim=1))
        parts.append(part)
    host = torch.cat(packed).cpu().numpy()
    ids_all = host[:, :k_max]
    scores_all = np.ascontiguousarray(host[:, k_max:]).view(np.float32)
    off = 0
    for part in parts:
        yield (
            part,
            ids_all[off : off + len(part)].tolist(),
            scores_all[off : off + len(part)].tolist(),
        )
        off += len(part)


def aligned_factor_init(
    old_factors: np.ndarray,
    old_index,
    new_index,
    rank: int,
    seed: int,
    fresh: Callable | None = None,
) -> tuple[np.ndarray, int]:
    """Carry a previous model's factor/embedding rows over to a new id
    space: entities present in both keep their vectors (overlapping
    columns when the rank changed); new entities get the standard
    abs(normal)/sqrt(rank) draw. This is what makes a warm retrain start
    near the previous optimum even as the catalog shifts (shared by the
    ALS and two-tower templates). Returns (init matrix, number of carried
    rows).

    ``fresh(rng, shape)`` draws the init for NON-carried rows; the
    default is ALS's nonnegative abs(normal)/sqrt(rank). Templates whose
    cold init differs (e.g. the two-tower's signed normal) must pass
    their own draw, or new entities would start in the wrong
    distribution — for towers, all in the positive orthant with pairwise
    cosine ~0.64 instead of ~0."""
    rng = np.random.default_rng(seed)
    shape = (len(new_index), rank)
    if fresh is None:
        out = (np.abs(rng.standard_normal(shape)) / np.sqrt(rank)).astype(
            np.float32
        )
    else:
        out = np.asarray(fresh(rng, shape), np.float32)
        if out.shape != shape:
            raise ValueError(f"fresh draw returned {out.shape}, want {shape}")
    old = np.asarray(old_factors)
    k = min(rank, old.shape[1])
    old_d, new_d = old_index.to_dict(), new_index.to_dict()
    if not old_d or not new_d:
        return out, 0
    # vectorized key intersection — a per-key Python loop would cost
    # minutes at catalog scale
    old_keys = np.asarray(list(old_d), dtype=np.str_)
    old_rows = np.fromiter(old_d.values(), np.int64, len(old_d))
    new_keys = np.asarray(list(new_d), dtype=np.str_)
    new_rows = np.fromiter(new_d.values(), np.int64, len(new_d))
    o_sort = np.argsort(old_keys)
    pos = np.searchsorted(old_keys, new_keys, sorter=o_sort)
    pos_c = np.minimum(pos, old_keys.size - 1)
    hit = old_keys[o_sort[pos_c]] == new_keys
    src = old_rows[o_sort[pos_c[hit]]]
    ok = src < old.shape[0]
    out[new_rows[hit][ok], :k] = old[src[ok], :k]
    return out, int(ok.sum())


def release_tables(model, *attrs: str) -> None:
    """Release a model's pinned tables ``attrs`` (both templates'
    ``release_pinned_model``): the pin-time host arrays come back while
    they are current; once an online update dropped them as stale, the
    updated tables are copied back to the host instead, so nothing that
    reads the model later sees pre-update rows."""
    host = getattr(model, "_pio_host", None)
    if host is not None:
        for attr, arr in zip(attrs, host):
            setattr(model, attr, arr)
    elif getattr(model, "_pio_pinned", False):
        for attr in attrs:
            table = getattr(model, attr)
            if isinstance(table, torch.Tensor):
                setattr(model, attr, table.cpu().numpy())
    model._pio_host = None
    model._pio_pinned = False
