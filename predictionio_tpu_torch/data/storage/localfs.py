"""Local-filesystem model-blob driver.

Parity: ``data/storage/localfs/LocalFSModels.scala`` — model blobs as files
under a base directory (``PATH`` property, typically
``$PIO_FS_BASEDIR/models``). The MODELDATA default.

Durability: writes are tmp-file + atomic ``os.replace`` **with fsync of
both the data and the directory entry** (``FSYNC=false`` opts out for
throwaway stores). Without the fsyncs a model "written" just before a
crash could vanish wholesale — the rename is atomic in the namespace but
nothing forced the bytes (or the rename itself) to disk. Enforced
tree-wide by piolint rule PIO403.

On open, the driver quarantines orphan ``*.tmp*`` files left by a crash
mid-write (see :meth:`_FsModels.sweep_recovery`).
"""

from __future__ import annotations

import logging
import os
import uuid

from predictionio_tpu_torch.data.storage.base import (
    BaseStorageClient,
    Model,
    ModelsRepo,
    StorageClientConfig,
    StorageError,
)

__all__ = ["StorageClient"]

logger = logging.getLogger(__name__)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    except OSError:
        return True  # unknowable: err on the side of not touching it
    return True


def _suffix_names_live_pid(name: str) -> bool:
    """Does any dotted component after ``.tmp.`` name a live process?
    Covers both this driver's ``<final>.tmp.<pid>.<rand>`` temps and
    sharedfs's ``<final>.tmp.<host>.<pid>.<rand>`` temps sharing the
    directory — a live writer's temp must never be swept."""
    suffix = name.split(".tmp.", 1)
    if len(suffix) < 2:
        return False
    return any(
        part.isdigit() and _pid_alive(int(part))
        for part in suffix[1].split(".")
    )


class _FsModels(ModelsRepo):
    def __init__(self, base: str, fsync: bool = True):
        self._base = base
        self._fsync = fsync
        os.makedirs(base, exist_ok=True)

    def _path(self, model_id: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in model_id)
        return os.path.join(self._base, f"pio_model_{safe}.bin")

    def _tmp_path(self, final: str) -> str:
        # pid + random suffix: a concurrent writer in another process
        # never collides on the temp name, and the recovery sweep can
        # tell a live writer's temp (pid alive — skip) from a crash's
        # orphan (pid dead — quarantine)
        return f"{final}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"

    def insert(self, model: Model) -> None:
        final = self._path(model.id)
        tmp = self._tmp_path(final)
        try:
            with open(tmp, "wb") as f:
                f.write(model.models)
                if self._fsync:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, final)
            if self._fsync:
                # persist the rename itself (directory entry) before
                # reporting success to the trainer
                dir_fd = os.open(self._base, os.O_RDONLY)
                try:
                    os.fsync(dir_fd)
                finally:
                    os.close(dir_fd)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def get(self, model_id: str) -> Model | None:
        path = self._path(model_id)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return Model(id=model_id, models=f.read())

    def delete(self, model_id: str) -> bool:
        path = self._path(model_id)
        if os.path.exists(path):
            os.remove(path)
            return True
        return False

    def sweep_recovery(self) -> dict:
        """Quarantine orphan temp files from a crash mid-``insert``.
        Moved aside (never deleted) into ``quarantine/`` so an operator
        can inspect the partial blob."""
        report: dict = {"quarantined": [], "notes": []}
        try:
            names = sorted(os.listdir(self._base))
        except FileNotFoundError:
            return report
        for name in names:
            if not (name.startswith("pio_model_") and ".tmp" in name):
                continue
            if _suffix_names_live_pid(name):
                continue  # another process's write in flight
            qdir = os.path.join(self._base, "quarantine")
            os.makedirs(qdir, exist_ok=True)
            dest = os.path.join(qdir, f"{name}.{uuid.uuid4().hex[:8]}")
            os.replace(os.path.join(self._base, name), dest)
            report["quarantined"].append(dest)
        if report["quarantined"]:
            logger.warning(
                "model store recovery quarantined %d orphan temp file(s) "
                "under %s", len(report["quarantined"]), self._base,
            )
        return report


class StorageClient(BaseStorageClient):
    """Model-data driver (``TYPE=localfs``; property ``PATH`` = directory;
    ``FSYNC`` optional, default true)."""

    def __init__(self, config: StorageClientConfig):
        super().__init__(config)
        path = config.properties.get("path")
        if not path:
            raise StorageError("localfs driver requires a PATH property")
        fsync = config.properties.get("fsync", "true").lower() != "false"
        self._models = _FsModels(os.path.expanduser(path), fsync)
        self._recovery = self._models.sweep_recovery()

    def recovery_report(self) -> dict:
        return dict(self._recovery)

    def get_models(self) -> ModelsRepo:
        return self._models
