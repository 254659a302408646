"""Top-K selection under the repo's one tie rule.

    **descending score, ties broken by ascending item index.**

Counterpart of ``predictionio_tpu/ops/topk.py``. ``torch.topk`` promises
no order among equal values, so the device path takes a *stable*
descending sort: equal scores keep their original (ascending index)
order, which is exactly ``jax.lax.top_k``'s contract. ``top_k_host`` is
the numpy mirror (argpartition + lexsort) for host-side scores.

Where a score's position is not its item id (the IVF cluster-major
merge, the int8 rescore), :func:`sort_merge_topk` and
:func:`top_k_permuted` order ``(scores, ids)`` by the same rule in the
id space: a stable sort on id, then a stable descending sort on score.
The two zeros are one key there, as in ``jax.lax.sort``; the scores come
back with their own bits.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bucket_k", "top_k_scores", "top_k_permuted", "sort_merge_topk", "top_k_host"]


def bucket_k(k: int, n_items: int, floor: int = 16) -> int:
    """The shared pow2 fetch-size bucket: ``k`` rounds up to a power of
    two (``floor`` minimum), capped at the catalog."""
    return min(int(n_items), max(floor, 1 << (max(1, int(k)) - 1).bit_length()))


def top_k_scores(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``scores`` along the last axis: ``(indices, values)``.
    Ties break toward the lower index (stable descending sort)."""
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return indices[..., :k], values[..., :k]


def sort_merge_topk(
    scores: torch.Tensor, ids: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tie-stable top-k of an unordered candidate list: ``(ids [..., k],
    scores [..., k])`` by descending score, ties by ascending id — the
    JAX package's two-key ``lax.sort`` on ``(-score, id)``, exact for any
    id width. ``-0.0`` and ``0.0`` are one key (``scores + 0.0`` makes
    the key; the returned scores keep their bits)."""
    by_id = torch.argsort(ids, dim=-1, stable=True)
    key = (scores + 0.0).gather(-1, by_id)
    by_score = torch.argsort(key, dim=-1, descending=True, stable=True)
    pos = by_id.gather(-1, by_score[..., :k])
    return ids.gather(-1, pos), scores.gather(-1, pos)


def top_k_permuted(
    scores: torch.Tensor, ids: torch.Tensor, k: int, big_ids: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tie-stable top-k when position != item id: ``scores[..., n]``
    belongs to item ``ids[..., n]``. Returns ``(ids [..., k], scores
    [..., k])`` by descending score, ties by ascending id — what
    :func:`top_k_scores` gives on the naturally ordered axis.

    ``big_ids`` is the JAX package's switch for catalogs of 2^24 items or
    more, where its fast path (an f32 key over the ids) stops being
    exact. The sorts here key on the ids themselves, exact at any width,
    so both values take :func:`sort_merge_topk`."""
    del big_ids  # one exact path for every id width
    return sort_merge_topk(scores, ids, k)


def top_k_host(scores: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Numpy top-k over the last axis of a 1-D or 2-D score array with
    the shared tie rule; returns ``(indices, values)``. ``argpartition``
    keeps it O(n + k log k) per row."""
    k = min(int(k), scores.shape[-1])
    if k <= 0:
        shape = scores.shape[:-1] + (0,)
        return np.zeros(shape, np.int64), np.zeros(shape, scores.dtype)
    if scores.ndim == 1:
        part = np.argpartition(scores, -k)[-k:]
        top = part[np.lexsort((part, -scores[part]))]
        return top, scores[top]
    part = np.argpartition(scores, -k, axis=-1)[..., -k:]
    vals = np.take_along_axis(scores, part, axis=-1)
    # per-row lexsort: primary key descending value, secondary ascending
    # original index — np.lexsort's last key is primary
    order = np.lexsort((part, -vals), axis=-1)
    top = np.take_along_axis(part, order, axis=-1)
    return top, np.take_along_axis(scores, top, axis=-1)
