"""Distribution layer of the port.

Counterpart of ``predictionio_tpu/parallel/``:

* :mod:`~predictionio_tpu_torch.parallel.distributed` — the
  ``PIO_COORDINATOR_*`` multi-process start over ``torch.distributed``
  (the Spark driver role collapses into process 0), the backend rule,
  and the collectives the training mesh uses;
* :mod:`~predictionio_tpu_torch.parallel.exchange` — the bounded
  point-to-point all-to-all and the DataSources' coherence helpers;
* :mod:`~predictionio_tpu_torch.parallel.reader` — deterministic
  per-host event shard files (``pio export --sharded``);
* :mod:`~predictionio_tpu_torch.parallel.sharding` — sharded factor
  tables over one process's devices (``pio deploy --shard-factors``,
  and the training mesh's tables).

The names below load their module on first use: importing the package
imports neither torch nor numpy.
"""

from __future__ import annotations

import importlib

__all__ = [
    "initialize_from_env",
    "is_multihost",
    "process_count",
    "process_index",
    "read_event_shards",
    "write_event_shards",
    "shard_paths",
    "allgather_objects",
    "exchange_by_owner",
    "exchange_objects_by_owner",
    "exchange_traffic",
    "reset_exchange_traffic",
    "crc_owner",
    "merge_keyed",
    "global_vocab",
    "global_sum_array",
]

_HOME = {
    **dict.fromkeys(("initialize_from_env", "is_multihost", "process_count", "process_index"), "distributed"),
    **dict.fromkeys(("read_event_shards", "write_event_shards", "shard_paths"), "reader"),
    **dict.fromkeys(
        ("allgather_objects", "exchange_by_owner", "exchange_objects_by_owner", "exchange_traffic",
         "reset_exchange_traffic", "crc_owner", "merge_keyed", "global_vocab", "global_sum_array"),
        "exchange",
    ),
}


def __getattr__(name: str):
    home = _HOME.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{home}"), name)
