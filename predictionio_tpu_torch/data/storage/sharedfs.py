"""Shared-filesystem model-blob driver (multi-host deploy path).

Parity: ``data/storage/hdfs/HDFSModels.scala`` / ``storage/s3`` — a model
store every host can reach, so a blob written by the training host (host 0
of a multi-process training job) is loadable by any serving host. The
equivalent of HDFS is a shared mount (NFS, GCS-fuse, Filestore), so this
driver is ``localfs`` hardened for concurrent multi-host use:

* temp files carry a host+pid+random suffix — two hosts writing the same
  model id never collide on the temp name;
* data and directory are fsync'd before the atomic rename, so a reader
  on another host never observes a torn blob through close-to-open
  consistency (NFS) after the rename is visible;
* reads retry (3 attempts) across a concurrent replace and raise
  ``StorageError`` — never a false "absent" — if the path persists but
  every open raced a replacement.

Config::

    PIO_STORAGE_SOURCES_<ID>_TYPE=sharedfs
    PIO_STORAGE_SOURCES_<ID>_PATH=/mnt/shared/pio-models
    PIO_STORAGE_SOURCES_<ID>_FSYNC=true   # optional (default true)

Counterpart of ``predictionio_tpu/data/storage/sharedfs.py``, the same
code with the port's imports.
"""

from __future__ import annotations

import os
import socket
import uuid

from predictionio_tpu_torch.data.storage.base import (
    BaseStorageClient,
    Model,
    ModelsRepo,
    StorageClientConfig,
    StorageError,
)
from predictionio_tpu_torch.data.storage.localfs import _FsModels, _pid_alive

__all__ = ["StorageClient"]


class _SharedFsModels(_FsModels):
    """Extends the localfs store (same paths/sanitization — a model
    written by either driver is readable by the other; the write path,
    fsync of data + directory entry included, now lives in
    ``_FsModels.insert``) with the concurrent-multi-host hardening
    documented above."""

    def _tmp_path(self, final: str) -> str:
        # host-unique temp name: concurrent writers on different hosts of a
        # shared mount must never collide before the atomic rename
        return (
            f"{final}.tmp.{socket.gethostname()}.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        )

    def get(self, model_id: str) -> Model | None:
        path = self._path(model_id)
        for _ in range(3):  # retry across a concurrent os.replace
            try:
                with open(path, "rb") as f:
                    return Model(id=model_id, models=f.read())
            except FileNotFoundError:
                if not os.path.exists(path):
                    return None
        # never misreport an existing model as absent (advisor r3): the
        # path still exists, yet every open raced a concurrent replace
        raise StorageError(
            f"model {model_id!r} exists at {path} but could not be opened "
            "after repeated concurrent replacements"
        )

    def delete(self, model_id: str) -> bool:
        try:
            os.remove(self._path(model_id))
            return True
        except FileNotFoundError:
            return False

    def sweep_recovery(self) -> dict:
        """Like the localfs sweep, but restricted to temps carrying THIS
        host's name: on a shared mount an unsuffixed ``*.tmp.<host>...``
        file may be another host's write in flight, and quarantining it
        would break that host's atomic rename."""
        report: dict = {"quarantined": [], "notes": []}
        marker = f".tmp.{socket.gethostname()}."
        try:
            names = sorted(os.listdir(self._base))
        except FileNotFoundError:
            return report
        for name in names:
            if not (name.startswith("pio_model_") and marker in name):
                continue
            pid_part = name.split(marker, 1)[1].split(".")[0]
            if pid_part.isdigit() and _pid_alive(int(pid_part)):
                continue  # a same-host writer process is still in flight
            qdir = os.path.join(self._base, "quarantine")
            os.makedirs(qdir, exist_ok=True)
            dest = os.path.join(qdir, f"{name}.{uuid.uuid4().hex[:8]}")
            os.replace(os.path.join(self._base, name), dest)
            report["quarantined"].append(dest)
        return report


class StorageClient(BaseStorageClient):
    """Shared-mount model driver (``TYPE=sharedfs``; ``PATH`` = directory)."""

    def __init__(self, config: StorageClientConfig):
        super().__init__(config)
        path = config.properties.get("path")
        if not path:
            raise StorageError("sharedfs driver requires a PATH property")
        fsync = config.properties.get("fsync", "true").lower() != "false"
        self._models = _SharedFsModels(os.path.expanduser(path), fsync)
        # NOTE: on a shared mount other hosts may be mid-write, so only
        # THIS host's orphans are quarantined (the temp-name suffix makes
        # ownership checkable)
        self._recovery = self._models.sweep_recovery()

    def recovery_report(self) -> dict:
        return dict(self._recovery)

    def get_models(self) -> ModelsRepo:
        return self._models
