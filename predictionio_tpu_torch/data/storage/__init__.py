"""Pluggable storage: registry + SPI + drivers.

Parity with the reference storage layer (``data/storage/Storage.scala`` and
friends): three repository roles — METADATA (apps, keys, channels, engine /
evaluation instances), EVENTDATA (the event log), MODELDATA (model blobs) —
each resolved through env-var configuration to a concrete driver module.
"""

from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    Model,
    LEvents,
    PEvents,
    StorageClientConfig,
    StorageError,
)
from predictionio_tpu_torch.data.storage.registry import Storage

__all__ = [
    "AccessKey",
    "App",
    "Channel",
    "EngineInstance",
    "EvaluationInstance",
    "Model",
    "LEvents",
    "PEvents",
    "Storage",
    "StorageClientConfig",
    "StorageError",
]
