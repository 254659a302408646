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

``set_rows``, ``append_rows`` and ``swap_side_rows`` wait with online
fold-in (ROADMAP queue 1 item 9); the sharded, int8, IVF and AOT tiers
wait with items 13, 8, 7 and 14.
"""

from __future__ import annotations

import logging
from typing import Sequence

__all__ = ["pin_pairs", "release_pairs", "bytes_by_dtype"]

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
