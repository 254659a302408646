"""Online learning — fold fresh events from the event tail into the live
serving model in seconds, without a retrain (``pio deploy --online``).

Counterpart of ``predictionio_tpu/online/``, module for module:

* :mod:`~predictionio_tpu_torch.online.follower` — the durable tail
  follower: a persisted watermark cursor over the columnar event store
  (segment roll, compaction and restart, exactly once). Its cursor files
  are the JAX package's, so either package's deploy resumes the other's;
* :mod:`~predictionio_tpu_torch.online.foldin` — the batched ALS re-solve
  of only the touched user/item rows against the fixed opposite-side
  factors, on an explicit device, plus cold-start rows for never-seen
  entities;
* :mod:`~predictionio_tpu_torch.online.trainer` — the streaming
  mini-batch trainer of two-tower embeddings, on its own thread;
* :mod:`~predictionio_tpu_torch.online.runner` — the daemon: poll the
  follower, dispatch the deltas to each deployed algorithm's online
  hooks, hot-swap the touched rows through
  ``QueryService.apply_online_update`` (per-scope cache invalidation,
  rows scattered into the pinned tables out of place), commit the
  watermark.

Every torch call of a fold (the gather, the solves, the row scatters) and
of a streaming step runs on the query server's device thread; polling,
the rating histories and the building of the systems stay on the
runner's thread.

Strictly opt-in: with ``--online`` off nothing here is imported, and this
``__init__`` and ``types`` import neither torch nor jax, so constructing
an :class:`OnlineConfig` costs nothing.
"""

from predictionio_tpu_torch.online.types import EventDelta, OnlineConfig, OnlineUpdate

__all__ = ["EventDelta", "OnlineConfig", "OnlineUpdate"]
