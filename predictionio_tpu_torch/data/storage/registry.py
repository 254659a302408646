"""The storage registry — dependency-injection core of the data layer.

Parity with ``data/storage/Storage.scala``: parse
``PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_{NAME,SOURCE}`` and
``PIO_STORAGE_SOURCES_<ID>_{TYPE,...}`` from the environment, reflectively
import the driver module named by ``TYPE``, instantiate and cache one
``StorageClient`` per source, and expose role-scoped accessors
(``get_meta_data_apps()``, ``get_l_events()``...).

Zero-config default (new vs the reference, which demands HBase+ES): a pure
local stack — ``sqlite`` for metadata + events, ``localfs`` for model blobs —
rooted at ``$PIO_FS_BASEDIR`` (default ``~/.pio_store``), so the quickstart
needs no external services.
"""

from __future__ import annotations

import importlib
import os
import threading
from typing import Any

from predictionio_tpu_torch.data.storage.base import (
    AccessKeysRepo,
    AppsRepo,
    BaseStorageClient,
    ChannelsRepo,
    EngineInstancesRepo,
    EvaluationInstancesRepo,
    LEvents,
    ModelsRepo,
    PEvents,
    StorageClientConfig,
    StorageError,
)

__all__ = ["Storage"]

_REPO_KEYS = ("METADATA", "EVENTDATA", "MODELDATA")

#: short driver name -> module path; dotted names are imported verbatim so
#: third-party drivers plug in without touching this table.
_BUILTIN_DRIVERS = {
    "sqlite": "predictionio_tpu_torch.data.storage.sqlite",
    "memory": "predictionio_tpu_torch.data.storage.memory",
    "localfs": "predictionio_tpu_torch.data.storage.localfs",
    "remote": "predictionio_tpu_torch.data.storage.remote",
    "sharedfs": "predictionio_tpu_torch.data.storage.sharedfs",
    "columnar": "predictionio_tpu_torch.data.storage.columnar",
}


class _Registry:
    """Process-wide storage registry (singleton behind :data:`Storage`)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._clients: dict[str, BaseStorageClient] = {}
        self._env: dict[str, str] | None = None  # explicit override for tests

    # -- configuration ------------------------------------------------------

    def configure(self, env: dict[str, str] | None) -> None:
        """Override the environment (tests / embedded use). ``None`` reverts
        to ``os.environ``. Drops all cached clients."""
        with self._lock:
            self.close()
            self._env = dict(env) if env is not None else None

    def _getenv(self, key: str, default: str | None = None) -> str | None:
        env = self._env if self._env is not None else os.environ
        return env.get(key, default)

    def _env_with_prefix(self, prefix: str) -> dict[str, str]:
        env = self._env if self._env is not None else os.environ
        return {k: v for k, v in env.items() if k.startswith(prefix)}

    def base_dir(self) -> str:
        return os.path.expanduser(
            self._getenv("PIO_FS_BASEDIR", os.path.join("~", ".pio_store"))
        )

    def _default_sources(self) -> dict[str, dict[str, str]]:
        base = self.base_dir()
        return {
            "PIO_SQLITE": {
                "TYPE": "sqlite",
                "PATH": os.path.join(base, "pio.db"),
            },
            "PIO_LOCALFS": {
                "TYPE": "localfs",
                "PATH": os.path.join(base, "models"),
            },
        }

    def _default_repositories(self) -> dict[str, str]:
        return {
            "METADATA": "PIO_SQLITE",
            "EVENTDATA": "PIO_SQLITE",
            "MODELDATA": "PIO_LOCALFS",
        }

    def repository_source_id(self, repo: str) -> str:
        repo = repo.upper()
        if repo not in _REPO_KEYS:
            raise StorageError(f"Unknown repository '{repo}'")
        sid = self._getenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE")
        if sid:
            return sid
        return self._default_repositories()[repo]

    def repository_name(self, repo: str) -> str:
        """The namespace prefix for the repo (table prefix), default ``pio``."""
        return self._getenv(
            f"PIO_STORAGE_REPOSITORIES_{repo.upper()}_NAME", "pio"
        ) or "pio"

    def source_config(self, source_id: str) -> StorageClientConfig:
        prefix = f"PIO_STORAGE_SOURCES_{source_id}_"
        props = {
            k[len(prefix):].lower(): v
            for k, v in self._env_with_prefix(prefix).items()
        }
        if not props:
            props = {
                k.lower(): v
                for k, v in self._default_sources().get(source_id, {}).items()
            }
        if "type" not in props:
            raise StorageError(
                f"Storage source '{source_id}' is not configured "
                f"(missing PIO_STORAGE_SOURCES_{source_id}_TYPE)"
            )
        type_ = props.pop("type")
        return StorageClientConfig(source_id=source_id, type=type_, properties=props)

    # -- client construction -------------------------------------------------

    def client_for_source(
        self, source_id: str, namespace: str | None = None
    ) -> BaseStorageClient:
        """Get/construct the cached client for a source. ``namespace`` (the
        repository NAME) becomes the driver's table/key prefix unless the
        source config sets one explicitly."""
        cache_key = f"{source_id}\x00{namespace or ''}"
        with self._lock:
            client = self._clients.get(cache_key)
            if client is None:
                config = self.source_config(source_id)
                if namespace and "prefix" not in config.properties:
                    config.properties["prefix"] = namespace
                module_name = _BUILTIN_DRIVERS.get(config.type, config.type)
                try:
                    module = importlib.import_module(module_name)
                except ImportError as e:
                    raise StorageError(
                        f"Cannot import storage driver '{config.type}' "
                        f"(module '{module_name}'): {e}"
                    ) from e
                cls = getattr(module, "StorageClient", None)
                if cls is None:
                    raise StorageError(
                        f"Driver module '{module_name}' defines no StorageClient"
                    )
                # piolint: waive=PIO211 -- one build a source, under the registry lock: two threads building one store would sweep its directory twice at once; the fsyncs are that recovery sweep's, once a process
                client = cls(config)
                self._clients[cache_key] = client
            return client

    def client_for_repo(self, repo: str) -> BaseStorageClient:
        return self.client_for_source(
            self.repository_source_id(repo), self.repository_name(repo)
        )

    # -- role-scoped accessors (the API the rest of the framework uses) -----

    def get_meta_data_apps(self) -> AppsRepo:
        return self.client_for_repo("METADATA").get_apps()

    def get_meta_data_access_keys(self) -> AccessKeysRepo:
        return self.client_for_repo("METADATA").get_access_keys()

    def get_meta_data_channels(self) -> ChannelsRepo:
        return self.client_for_repo("METADATA").get_channels()

    def get_meta_data_engine_instances(self) -> EngineInstancesRepo:
        return self.client_for_repo("METADATA").get_engine_instances()

    def get_meta_data_evaluation_instances(self) -> EvaluationInstancesRepo:
        return self.client_for_repo("METADATA").get_evaluation_instances()

    def get_model_data_models(self) -> ModelsRepo:
        return self.client_for_repo("MODELDATA").get_models()

    def get_l_events(self) -> LEvents:
        return self.client_for_repo("EVENTDATA").get_l_events()

    def get_p_events(self) -> PEvents:
        return self.client_for_repo("EVENTDATA").get_p_events()

    # -- diagnostics (pio status) -------------------------------------------

    def verify_all(self) -> dict[str, Any]:
        """Connectivity/health check of all three roles (``pio status``)."""
        out: dict[str, Any] = {}
        for repo in _REPO_KEYS:
            sid = self.repository_source_id(repo)
            try:
                cfg = self.source_config(sid)
                self.client_for_source(sid, self.repository_name(repo))
                out[repo] = {"source": sid, "type": cfg.type, "ok": True}
            except Exception as e:  # driver construction can raise anything
                out[repo] = {"source": sid, "ok": False, "error": str(e)}
        return out

    def close(self) -> None:
        with self._lock:
            for client in self._clients.values():
                try:
                    client.close()
                except Exception:
                    pass
            self._clients.clear()


#: The process-wide registry. ``Storage.configure({...})`` injects a custom
#: environment (tests); ``Storage.configure(None)`` reverts to ``os.environ``.
Storage = _Registry()
