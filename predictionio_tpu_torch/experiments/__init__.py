"""Experimentation subsystem: exploration policies, A/B traffic splits,
batched eval sweeps.

Counterpart of ``predictionio_tpu/experiments/``. Three composing pieces,
each importable on its own:

* :mod:`predictionio_tpu_torch.experiments.explore` — epsilon-greedy and
  Thompson-sampling re-ranking over a deployed engine's top-K scores
  (``pio deploy --explore <policy>``), as torch ops on the query
  service's device; rewards fold back through the online follower or
  ``POST /experiments/reward.json``.
* :mod:`predictionio_tpu_torch.experiments.split` — stdlib-only weighted
  A/B variant assignment for the fleet router (``pio deploy --replicas N
  --variants a:2,b:1``): hash-sticky by cache scope, bit-equal to the
  JAX package's, promotable via ``POST /experiments/promote.json``.
* :mod:`predictionio_tpu_torch.experiments.sweep` — ``pio eval --grid``
  trains every grid candidate as ONE batched torch program per fold.

This ``__init__`` is import-light on purpose: a default deploy never
imports the package (``tests/test_torch_no_jax.py``), and the fleet
router (stdlib-only) imports ``experiments.split`` without ever pulling
torch — so the submodules load lazily via PEP 562 and nothing heavy runs
here.
"""

from __future__ import annotations

_EXPORTS = {
    "Variant": ("predictionio_tpu_torch.experiments.split", "Variant"),
    "SplitConfig": ("predictionio_tpu_torch.experiments.split", "SplitConfig"),
    "TrafficSplit": ("predictionio_tpu_torch.experiments.split", "TrafficSplit"),
    "ExploreConfig": ("predictionio_tpu_torch.experiments.explore", "ExploreConfig"),
    "Explorer": ("predictionio_tpu_torch.experiments.explore", "Explorer"),
    "run_grid_evaluation": ("predictionio_tpu_torch.experiments.sweep", "run_grid_evaluation"),
    "grid_axes": ("predictionio_tpu_torch.experiments.sweep", "grid_axes"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(module), attr)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
