"""Serving runtime — cross-request micro-batching, caching, coalescing.

Counterpart of ``predictionio_tpu/serving/``. Sits between the HTTP
transport and :class:`~predictionio_tpu_torch.workflow.serving.QueryService`:

* :mod:`predictionio_tpu_torch.serving.batcher` — concurrent
  ``POST /queries.json`` requests are coalesced into one
  ``handle_batch`` call (one score product per batch instead of one per
  request);
* :mod:`predictionio_tpu_torch.serving.cache` — result LRU with
  event-driven invalidation, singleflight dedup of identical in-flight
  queries, and the config surface of the pinned model-state tier (which
  lives in :mod:`predictionio_tpu_torch.workflow.device_state`);
* :mod:`predictionio_tpu_torch.serving.ann` — only the ``--ann`` flag's
  config: the IVF tier itself is :mod:`predictionio_tpu_torch.ops.ivf`,
  built per model generation by
  :mod:`predictionio_tpu_torch.workflow.device_state`.

This package imports neither torch nor jax: batching and caching are
pure threading/queue/dict machinery (``tests/test_torch_no_jax.py``
holds it).
"""

from predictionio_tpu_torch.serving.ann import AnnConfig
from predictionio_tpu_torch.serving.batcher import (
    AdmissionPolicy,
    BatcherConfig,
    MicroBatcher,
)
from predictionio_tpu_torch.serving.cache import (
    CacheConfig,
    CacheStats,
    ResultCache,
    Singleflight,
)

__all__ = [
    "AdmissionPolicy",
    "AnnConfig",
    "BatcherConfig",
    "CacheConfig",
    "CacheStats",
    "MicroBatcher",
    "ResultCache",
    "Singleflight",
]
