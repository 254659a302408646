"""Top-K selection under the repo's one tie rule.

    **descending score, ties broken by ascending item index.**

Counterpart of ``predictionio_tpu/ops/topk.py``. The order is
``jax.lax.top_k``'s: the IEEE total order of the float bits, so ``0.0``
ranks above ``-0.0``, a NaN with the sign bit clear above ``+inf`` and
one with it set below ``-inf``. ``torch.topk`` promises no order among
equal values and ``torch.sort`` ranks the two zeros as one value, so
:func:`top_k_scores` takes a *stable* descending sort of an integer key
of the bits (:func:`order_key`): equal keys keep their original
(ascending index) order. :func:`top_k_host` is the numpy mirror,
O(n + k log k) a row: ``argpartition`` finds the k-th key, every
candidate above it is kept, and of those tied with it the lowest
indices fill the rest.

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

__all__ = ["bucket_k", "order_key", "top_k_scores", "top_k_permuted", "sort_merge_topk", "top_k_host"]


def bucket_k(k: int, n_items: int, floor: int = 16) -> int:
    """The shared pow2 fetch-size bucket: ``k`` rounds up to a power of
    two (``floor`` minimum), capped at the catalog."""
    return min(int(n_items), max(floor, 1 << (max(1, int(k)) - 1).bit_length()))


def order_key(scores):
    """An integer array or tensor in the order of ``jax.lax.top_k``: the
    float bits, with the magnitude bits of negative values flipped, so
    the integers order as the IEEE total order of the floats (``-0.0``
    below ``0.0``; a NaN by its sign bit, beyond the infinities). Integer
    scores are their own key."""
    if isinstance(scores, torch.Tensor):
        if not scores.is_floating_point():
            return scores
        width = 8 * scores.element_size()
        bits = scores.contiguous().view(getattr(torch, f"int{width}"))
    else:
        scores = np.asarray(scores)
        if scores.dtype.kind != "f":
            return scores
        width = 8 * scores.dtype.itemsize
        bits = np.ascontiguousarray(scores).view(f"int{width}")
    # all ones for a negative value (arithmetic shift), then its
    # magnitude bits flipped
    return bits ^ ((bits >> (width - 1)) & ((1 << (width - 1)) - 1))


def top_k_scores(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``scores`` along the last axis: ``(indices, values)``.
    Ties break toward the lower index (a stable descending sort of
    :func:`order_key`, so ``0.0`` ranks above ``-0.0``)."""
    _, indices = torch.sort(order_key(scores), dim=-1, descending=True, stable=True)
    indices = indices[..., :k]
    return indices, scores.gather(-1, indices)


def sort_merge_topk(
    scores: torch.Tensor, ids: torch.Tensor, k: int, total_order: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tie-stable top-k of an unordered candidate list: ``(ids [..., k],
    scores [..., k])`` by descending score, ties by ascending id — the
    JAX package's two-key ``lax.sort`` on ``(-score, id)``, exact for any
    id width. ``-0.0`` and ``0.0`` are one key (``scores + 0.0`` makes
    the key; the returned scores keep their bits). ``total_order=True``
    keys on :func:`order_key` instead (``0.0`` above ``-0.0``), so merging
    the :func:`top_k_scores` of a row's parts gives the
    :func:`top_k_scores` of the whole row (``parallel/sharding.py``)."""
    by_id = torch.argsort(ids, dim=-1, stable=True)
    key = (order_key(scores) if total_order else scores + 0.0).gather(-1, by_id)
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
    the shared tie rule and :func:`order_key`'s order; returns
    ``(indices, values)``. O(n + k log k) a row: ``argpartition`` finds
    the k-th key; every candidate above it is kept, and the ones tied
    with it fill the remaining places in ascending index order (a
    partition alone keeps arbitrary members of such a tie)."""
    scores = np.asarray(scores)
    k = min(int(k), scores.shape[-1])
    if k <= 0:
        shape = scores.shape[:-1] + (0,)
        return np.zeros(shape, np.int64), np.zeros(shape, scores.dtype)
    if scores.ndim == 1:
        top, vals = top_k_host(scores[None], k)
        return top[0], vals[0]
    key = order_key(scores)
    part = np.argpartition(key, -k, axis=-1)[..., -k:]
    kth = np.take_along_axis(key, part, axis=-1).min(axis=-1, keepdims=True)
    chosen = key > kth
    need = k - chosen.sum(axis=-1)  # places left to members of the k-th key's tie
    tied = key == kth
    bite = np.flatnonzero(tied.sum(axis=-1) > need)  # rows whose tie straddles the boundary
    chosen |= tied
    if bite.size:
        rank = np.cumsum(tied[bite], axis=-1, dtype=np.int64)
        chosen[bite] &= ~tied[bite] | (rank <= need[bite, None])
    cand = np.nonzero(chosen)[1].reshape(scores.shape[0], k)  # ascending index a row
    cand_key = np.take_along_axis(key, cand, axis=-1)
    # descending key, then ascending index: np.lexsort's last key is
    # primary; ~key reverses the order without overflow
    order = np.lexsort((cand, ~cand_key), axis=-1)
    top = np.take_along_axis(cand, order, axis=-1)
    return top, np.take_along_axis(scores, top, axis=-1)
