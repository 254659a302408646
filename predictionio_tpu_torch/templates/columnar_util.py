"""Shared vectorized event aggregation for template datasources.

The count/weight-style templates (similar-product, e-commerce) reduce a
(user, item) event stream to one value per pair. On the columnar bulk
scan that is a grouped reduction over code arrays — no per-event Python
(the same move that makes the recommendation template's read keep up
with the device at 10^7+ events).
"""

from __future__ import annotations

import numpy as np

from predictionio_tpu_torch.data.columns import EventColumns

__all__ = ["aggregate_pairs", "event_name_mask", "densify_pairs"]


def event_name_mask(cols: EventColumns, name: str) -> np.ndarray:
    """Boolean row mask for one event name. Exact-match lookup — makes
    no assumption that a driver's event_vocab is sorted."""
    hits = np.flatnonzero(cols.event_vocab == name)
    if hits.size == 0:
        return np.zeros(len(cols), dtype=bool)
    return cols.event_code == hits[0]


def densify_pairs(
    cols: EventColumns,
    u_sel: np.ndarray,
    i_sel: np.ndarray,
    extra_items=(),
):
    """Compact aggregated pair codes to dense 0..n-1 index spaces.

    Returns ``(rows, cols_idx, user_vocab, item_vocab)`` where the vocab
    lists cover exactly the surviving ids — plus ``extra_items`` (e.g.
    $set-only catalog entries) appended to the item vocabulary so
    serving-time filters can address unobserved items. bincount keeps
    the compaction O(N), unlike a sort-based unique."""
    used_u = np.flatnonzero(np.bincount(u_sel, minlength=cols.entity_vocab.size))
    user_vocab = cols.entity_vocab[used_u].tolist()
    u_lut = np.zeros(cols.entity_vocab.size, np.int64)
    u_lut[used_u] = np.arange(used_u.size)
    used_i = np.flatnonzero(np.bincount(i_sel, minlength=cols.target_vocab.size))
    item_vocab = cols.target_vocab[used_i].tolist()
    present = set(item_vocab)
    item_vocab += [x for x in extra_items if x not in present]
    i_lut = np.zeros(cols.target_vocab.size, np.int64)
    i_lut[used_i] = np.arange(used_i.size)
    return u_lut[u_sel], i_lut[i_sel], user_vocab, item_vocab


def aggregate_pairs(
    cols: EventColumns, weights: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group events by (entity, target) pair and sum their weights.

    Returns ``(entity_code, target_code, totals)`` — one row per distinct
    pair, codes in the columns' own vocab spaces. Rows without a target
    are dropped. ``weights=None`` counts events (weight 1 each).
    """
    keep = cols.target_code >= 0
    if keep.all():
        u_code, i_code = cols.entity_code, cols.target_code
        w = weights
    else:
        u_code, i_code = cols.entity_code[keep], cols.target_code[keep]
        w = None if weights is None else weights[keep]
    span = int(cols.entity_vocab.size) * (int(cols.target_vocab.size) + 1)
    pair_dt = np.uint32 if span < 2**32 else np.int64
    pair = u_code.astype(pair_dt) * pair_dt(
        cols.target_vocab.size + 1
    ) + i_code.astype(pair_dt)
    order = np.argsort(pair)
    ps = pair[order]
    n = ps.size
    last = np.flatnonzero(np.r_[ps[1:] != ps[:-1], n > 0])
    first = np.r_[0, last[:-1] + 1] if n else last
    if weights is None:
        totals = (last - first + 1).astype(np.float32)
    else:
        csum = np.r_[0.0, np.cumsum(w[order], dtype=np.float64)]
        totals = (csum[last + 1] - csum[first]).astype(np.float32)
    sel = order[last]
    return u_code[sel], i_code[sel], totals
