"""Pinned serving state — the ``--pin-model`` tier.

Counterpart of ``predictionio_tpu/workflow/device_state.py``
(``pin_pairs``, ``release_pairs``, ``bytes_by_dtype``). Each successful
(re)load of a query server pins the deployed models' scoring tables on
the algorithm's device once per model generation, so every request
scores against resident tensors. Algorithms opt in by implementing
``pin_model_for_serving(model) -> (model, bytes_pinned)`` and
``release_pinned_model(model)``; any other pair is served as it is.

One difference from the JAX package, which the port's rules require: a
pin hook that raises is not swallowed (the JAX ``pin_pairs`` serves the
pair unpinned). The error reaches the caller, so a deploy's first load
fails loudly and a ``/reload`` leaves the service degraded on its
last-good model; nothing falls back to the host quietly.

The online fold-in's row swaps (``pio deploy --online``): :func:`get_rows`,
:func:`set_rows`, :func:`append_rows`, :func:`swap_side_rows` and
:func:`update_ann_items`. Host arrays update copy-on-write and swap
whole, as in the JAX package. Pinned tensors update out of place
(``index_copy`` into a new table, ``torch.cat`` for growth): a tensor that
``QueryService.snapshot_pairs`` or an in-flight query holds never
changes under it, as with JAX's ``.at[].set``. An int8 or sharded table
raises ``NotImplementedError``: those tiers wait with ROADMAP queue 1
items 8 and 13, as do the IVF and AOT tiers with items 7 and 14.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np

__all__ = [
    "append_rows",
    "bytes_by_dtype",
    "get_rows",
    "pin_pairs",
    "release_pairs",
    "set_rows",
    "swap_side_rows",
    "update_ann_items",
]

logger = logging.getLogger(__name__)


def pin_pairs(pairs: Sequence) -> tuple[list, int]:
    """Pin every (algorithm, model) pair whose algorithm has the hook.

    Returns ``(pairs, bytes_pinned)`` — the pair list with the pinned
    models and the bytes of every table they now hold on their device.
    A hook that raises propagates (see the module docstring)."""
    out = []
    total = 0
    for algo, model in pairs:
        pin = getattr(algo, "pin_model_for_serving", None)
        if pin is not None:
            model, nbytes = pin(model)
            total += int(nbytes)
        out.append((algo, model))
    return out, total


def bytes_by_dtype(pairs: Sequence) -> dict:
    """Per-dtype ledger of the pinned tables across the served models —
    ``cache.bytesByDtype`` on ``/stats.json``. Each pin hook records its
    own breakdown on ``model._pio_bytes_by_dtype`` from the tensors it
    placed."""
    agg: dict = {}
    for _, model in pairs:
        for dtype, nbytes in (getattr(model, "_pio_bytes_by_dtype", None) or {}).items():
            agg[dtype] = agg.get(dtype, 0) + int(nbytes)
    return agg


def _check_plain(mat) -> None:
    """Refuse the tables of tiers the port does not have: they must not
    be treated as plain ones."""
    if getattr(mat, "is_quantized", False):
        raise NotImplementedError("online updates of int8 tables wait for ROADMAP queue 1 item 8")
    if hasattr(mat, "placements"):  # a torch.distributed DTensor
        raise NotImplementedError("online updates of sharded tables wait for ROADMAP queue 1 item 13")


def get_rows(mat, idx) -> np.ndarray:
    """Rows ``idx`` of a factor table as host float32: a numpy fancy
    index, or one gather on the tensor's device and a ``len(idx)``-row
    copy — never the whole table."""
    _check_plain(mat)
    idx = np.asarray(idx, np.int64)
    if isinstance(mat, np.ndarray):
        return np.asarray(mat[idx], np.float32)
    import torch

    return mat.index_select(0, torch.from_numpy(idx).to(mat.device)).to(torch.float32).cpu().numpy()


def set_rows(mat, idx, rows):
    """Replace factor rows ``idx`` of ``mat`` with ``rows`` — the online
    fold-in's delta swap. A host array updates copy-on-write; a tensor
    out of place (``index_copy``), so only the touched rows cross to the
    device and every holder of the old table keeps it intact."""
    _check_plain(mat)
    if isinstance(mat, np.ndarray):
        out = mat.copy()
        out[np.asarray(idx, np.int64)] = np.asarray(rows, mat.dtype)
        return out
    import torch

    index = torch.as_tensor(np.asarray(idx, np.int64)).to(mat.device)
    src = torch.as_tensor(np.asarray(rows, np.float32)).to(device=mat.device, dtype=mat.dtype)
    return mat.index_copy(0, index, src)


def append_rows(mat, rows):
    """Grow a factor table by cold-start rows (fold-in injection for
    never-seen entities); a new table on the same device."""
    _check_plain(mat)
    if isinstance(mat, np.ndarray):
        return np.concatenate([mat, np.asarray(rows, mat.dtype)], axis=0)
    import torch

    src = torch.as_tensor(np.asarray(rows, np.float32)).to(device=mat.device, dtype=mat.dtype)
    return torch.cat([mat, src], dim=0)


def swap_side_rows(
    model, ids, rows, factors_attr: str, index_attr: str, rows_before_index: bool
) -> tuple[int, int]:
    """Swap one side's online-update rows into a live model: split
    ``ids`` into known (:func:`set_rows`) and new (cold start:
    :func:`append_rows` + ``BiMap.extended``), mutating the model's
    attributes by whole-object assignment only. The ordering contract
    both templates rely on (the JAX package's):

    ``rows_before_index=True`` (user side) — a racing query resolving a
    fresh user must find its row already present; until the index
    lands, the user reads as unknown.

    ``rows_before_index=False`` (item side) — scoring runs over the
    factor table, so a new row must not become rankable before the index
    can translate it back to an item id.

    Returns ``(rows updated, rows added)``."""
    if getattr(model, "_pio_shards", None) is not None:
        raise NotImplementedError("online updates of sharded tables wait for ROADMAP queue 1 item 13")
    index = getattr(model, index_attr)
    known = [(j, idx) for j, e in enumerate(ids) if (idx := index.get(e)) is not None]
    new = [j for j, e in enumerate(ids) if index.get(e) is None]
    rows = np.asarray(rows, np.float32)
    if known:
        setattr(
            model,
            factors_attr,
            set_rows(getattr(model, factors_attr), [idx for _, idx in known], rows[[j for j, _ in known]]),
        )
    if new:
        new_ids = [ids[j] for j in new]
        if rows_before_index:
            setattr(model, factors_attr, append_rows(getattr(model, factors_attr), rows[new]))
            setattr(model, index_attr, index.extended(new_ids))
        else:
            setattr(model, index_attr, index.extended(new_ids))
            setattr(model, factors_attr, append_rows(getattr(model, factors_attr), rows[new]))
    return len(known), len(new)


def update_ann_items(model, item_ids, rows, index_attr: str = "item_index"):
    """Fold changed/new item rows into the model's incremental IVF index;
    ``None`` — the port builds no IVF index until ROADMAP queue 1 item 7."""
    return None


def release_pairs(pairs: Sequence) -> None:
    """Drop a superseded generation's pinned tables so their device
    memory is freed at once (a hot-reloading server must not hold one
    catalog per reload). The query server calls it on its device thread,
    where no query of the old generation can still be running."""
    for algo, model in pairs:
        release = getattr(algo, "release_pinned_model", None)
        if release is None:
            continue
        try:
            release(model)
        except Exception:
            logger.exception("release_pinned_model failed for %s", type(algo).__name__)
