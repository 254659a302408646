"""Storage SPI: metadata entities, repository interfaces, event-store contracts.

Parity map (reference -> here):

* ``data/storage/Apps.scala`` / ``AccessKeys.scala`` / ``Channels.scala`` /
  ``EngineInstances.scala`` / ``EvaluationInstances.scala`` / ``Models.scala``
  -> the dataclasses + ``*Repo`` ABCs below.
* ``data/storage/LEvents.scala`` -> :class:`LEvents` (single-process CRUD and
  serving-time reads).
* ``data/storage/PEvents.scala`` -> :class:`PEvents` (bulk scan for training).
  The reference returns a Spark ``RDD[Event]``; here the bulk path returns an
  iterator that the training-side event store batches into host arrays for
  the device input pipeline — locality comes from deterministic per-host
  sharding of the scan (``shard_index``/``num_shards``), replacing HBase
  region locality.
"""

from __future__ import annotations

import abc
import datetime as _dt
import secrets
from dataclasses import dataclass, field, replace
from typing import Any, Iterable, Iterator, Sequence

from predictionio_tpu_torch.data.event import Event

__all__ = [
    "StorageError",
    "StorageUnavailableError",
    "StorageClientConfig",
    "App",
    "AccessKey",
    "Channel",
    "EngineInstance",
    "EvaluationInstance",
    "Model",
    "AppsRepo",
    "AccessKeysRepo",
    "ChannelsRepo",
    "EngineInstancesRepo",
    "EvaluationInstancesRepo",
    "ModelsRepo",
    "LEvents",
    "PEvents",
    "BaseStorageClient",
    "generate_access_key",
]


class StorageError(RuntimeError):
    """Raised for storage-layer failures (parity: ``StorageException``)."""


class StorageUnavailableError(StorageError):
    """Transport-level failure: the backend could not be reached or did
    not produce a well-formed answer (connection refused, timeout,
    mid-body disconnect, HTTP 5xx, open circuit). Distinct from plain
    :class:`StorageError` so retry policies and circuit breakers act only
    on faults that retrying can plausibly fix — an application-level
    error ("unknown method", bad arguments) is deterministic and proves
    the backend is up."""


@dataclass(frozen=True)
class StorageClientConfig:
    """Configuration handed to a driver (parity: ``StorageClientConfig.scala``).

    ``properties`` carries the parsed ``PIO_STORAGE_SOURCES_<ID>_*`` pairs
    (e.g. ``PATH``, ``HOSTS``, ``PORTS``) lower-cased.
    """

    source_id: str
    type: str
    properties: dict[str, str] = field(default_factory=dict)
    parallel: bool = False
    test: bool = False


# ---------------------------------------------------------------------------
# Metadata entities
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class App:
    """A tenant (parity: ``data/storage/Apps.scala``)."""

    id: int
    name: str
    description: str | None = None


@dataclass(frozen=True)
class AccessKey:
    """An API key granting event access to one app, optionally restricted to
    an event-name whitelist (parity: ``data/storage/AccessKeys.scala``)."""

    key: str
    appid: int
    events: tuple[str, ...] = ()


@dataclass(frozen=True)
class Channel:
    """A named event sub-stream within an app (parity: ``Channels.scala``)."""

    id: int
    name: str
    appid: int

    NAME_CONSTRAINT = "must be non-empty, alphanumeric plus '-' and '_'"

    @staticmethod
    def is_valid_name(name: str) -> bool:
        return bool(name) and all(c.isalnum() or c in "-_" for c in name)


@dataclass(frozen=True)
class EngineInstance:
    """Lineage record of one training run (parity: ``EngineInstances.scala``).

    Stores everything needed to reproduce or deploy the run: engine identity,
    variant, component params JSON, timings, and status.
    """

    id: str
    status: str  # INIT | TRAINING | COMPLETED | FAILED
    start_time: _dt.datetime
    end_time: _dt.datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    mesh_conf: dict[str, str] = field(default_factory=dict)  # replaces sparkConf
    datasource_params: str = ""
    preparator_params: str = ""
    algorithms_params: str = ""
    serving_params: str = ""

    def with_status(self, status: str, end_time: _dt.datetime | None = None) -> "EngineInstance":
        return replace(self, status=status, end_time=end_time or self.end_time)


@dataclass(frozen=True)
class EvaluationInstance:
    """Record of one ``pio eval`` run (parity: ``EvaluationInstances.scala``)."""

    id: str
    status: str
    start_time: _dt.datetime
    end_time: _dt.datetime
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


@dataclass(frozen=True)
class Model:
    """A serialized model blob keyed by engine-instance id
    (parity: ``data/storage/Models.scala``)."""

    id: str
    models: bytes


def generate_access_key() -> str:
    return secrets.token_urlsafe(48)


# ---------------------------------------------------------------------------
# Repository interfaces
# ---------------------------------------------------------------------------


class AppsRepo(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> int | None:
        """Insert; ``app.id == 0`` means auto-assign. Returns the id."""

    @abc.abstractmethod
    def get(self, app_id: int) -> App | None: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> App | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> bool: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> bool: ...


class AccessKeysRepo(abc.ABC):
    @abc.abstractmethod
    def insert(self, access_key: AccessKey) -> str | None:
        """Insert; empty ``key`` means auto-generate. Returns the key."""

    @abc.abstractmethod
    def get(self, key: str) -> AccessKey | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[AccessKey]: ...

    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> list[AccessKey]: ...

    @abc.abstractmethod
    def update(self, access_key: AccessKey) -> bool: ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...


class ChannelsRepo(abc.ABC):
    @abc.abstractmethod
    def insert(self, channel: Channel) -> int | None: ...

    @abc.abstractmethod
    def get(self, channel_id: int) -> Channel | None: ...

    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> list[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> bool: ...


class EngineInstancesRepo(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> EngineInstance | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None: ...

    @abc.abstractmethod
    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EngineInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class EvaluationInstancesRepo(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EvaluationInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> EvaluationInstance | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_completed(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EvaluationInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class ModelsRepo(abc.ABC):
    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Model | None: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> bool: ...


# ---------------------------------------------------------------------------
# Event-store contracts
# ---------------------------------------------------------------------------


class LEvents(abc.ABC):
    """Local (single-process) event CRUD, the write path of the event server
    and the serving-time read path (parity: ``data/storage/LEvents.scala``).

    Each (app_id, channel_id) pair addresses an isolated event stream;
    ``channel_id=None`` is the default channel.
    """

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        """Create backing structures for the stream. Idempotent."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        """Drop the stream and all its events."""

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        """Insert one event; returns its (possibly generated) event id."""

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        return [self.insert(e, app_id, channel_id) for e in events]

    def insert_dedup(
        self, event: Event, app_id: int, channel_id: int | None = None
    ) -> tuple[str, bool]:
        """Idempotent insert keyed on a CLIENT-SUPPLIED ``event_id``:
        returns ``(event_id, duplicate)``. When the id was already
        stored, the original event is kept untouched and ``duplicate`` is
        True — which is what makes a retried ``POST /events.json`` (and a
        retried storage-RPC write) safe: re-sending the same event can
        never double-count it. Events WITHOUT a client id take the plain
        :meth:`insert` path unchanged (dedup is strictly opt-in per
        event). The base implementation has no dedup index; durable
        drivers override it through their existing commit paths."""
        return self.insert(event, app_id, channel_id), False

    def insert_batch_dedup(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[tuple[str, bool]]:
        """Batch flavor of :meth:`insert_dedup`; duplicates are detected
        against the store AND earlier items of the same batch. Drivers
        override to keep the batch route's single-transaction
        amortization; for drivers that did not, a batch with no client
        ids (nothing to dedup) still takes their optimized
        :meth:`insert_batch` in one shot."""
        if not any(e.event_id for e in events):
            return [
                (eid, False)
                for eid in self.insert_batch(events, app_id, channel_id)
            ]
        return [self.insert_dedup(e, app_id, channel_id) for e in events]

    def ingest_chunk(
        self, chunk, app_id: int, channel_id: int | None = None
    ) -> list[tuple[str, bool]]:
        """Bulk-ingest one pre-parsed columnar chunk
        (:class:`~predictionio_tpu_torch.data.columns.EventChunk`); returns
        ``(event_id, duplicate)`` per row, aligned with the chunk.

        This is the append stage of the streaming bulk route and ``pio
        import``'s pipeline. The base default decodes the chunk into
        events and reuses :meth:`insert_batch_dedup` — correct on every
        driver; the columnar driver overrides it with a vectorized
        dedup probe plus a direct explicit-id segment write so bulk
        ingest never constructs per-event objects at all."""
        return self.insert_batch_dedup(chunk.to_events(), app_id, channel_id)

    @abc.abstractmethod
    def get(self, event_id: str, app_id: int, channel_id: int | None = None) -> Event | None: ...

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool: ...

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None = None,
        target_entity_id: str | None = None,
        limit: int | None = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        """Time/entity-filtered scan. ``limit=None`` means unbounded;
        ``reversed=True`` returns newest-first (requires an entity filter in
        the reference; here always supported)."""

    def close(self) -> None:  # optional resource hook
        pass


class PEvents(abc.ABC):
    """Bulk event scan for the training workflow
    (parity: ``data/storage/PEvents.scala``; the RDD becomes a sharded
    iterator feeding the host->device input pipeline)."""

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None = None,
        target_entity_id: str | None = None,
        shard_index: int = 0,
        num_shards: int = 1,
    ) -> Iterator[Event]:
        """Full scan with filters; ``(shard_index, num_shards)`` selects a
        deterministic horizontal shard for per-host parallel reads."""

    @abc.abstractmethod
    def write(
        self, events: Iterable[Event], app_id: int, channel_id: int | None = None
    ) -> None:
        """Bulk append (used by ``pio import``)."""

    @abc.abstractmethod
    def delete(self, app_id: int, channel_id: int | None = None) -> None:
        """Delete all events of the stream (used by ``pio app data-delete``)."""

    def find_columns(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None = None,
        prop: str | None = None,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        """Columnar bulk scan: the same filters as :meth:`find`, landed as
        dictionary-encoded numpy arrays (``data/columns.EventColumns``)
        instead of an object stream — what the device input pipeline actually
        wants at 10^7+ events. ``prop`` optionally extracts one numeric
        property as a float column (NaN = absent).

        This default adapts :meth:`find` row by row, so every driver is
        columnar-capable; drivers with a native columnar layout override
        it with an array-speed implementation.
        """
        from predictionio_tpu_torch.data.columns import columns_from_events

        return columns_from_events(
            self.find(
                app_id, channel_id,
                start_time=start_time, until_time=until_time,
                entity_type=entity_type, event_names=event_names,
                target_entity_type=target_entity_type,
                shard_index=shard_index, num_shards=num_shards,
            ),
            prop=prop,
        )


class BaseStorageClient(abc.ABC):
    """A connected driver instance (parity: ``BaseStorageClient.scala``).

    Subclasses expose whichever repositories the backend supports via the
    ``get_*`` factory methods; unsupported roles raise ``StorageError``.
    """

    prefix: str = ""

    def __init__(self, config: StorageClientConfig):
        self.config = config

    def _unsupported(self, what: str) -> StorageError:
        return StorageError(
            f"storage source type '{self.config.type}' does not support {what}"
        )

    def get_apps(self) -> AppsRepo:
        raise self._unsupported("metadata (apps)")

    def get_access_keys(self) -> AccessKeysRepo:
        raise self._unsupported("metadata (access keys)")

    def get_channels(self) -> ChannelsRepo:
        raise self._unsupported("metadata (channels)")

    def get_engine_instances(self) -> EngineInstancesRepo:
        raise self._unsupported("metadata (engine instances)")

    def get_evaluation_instances(self) -> EvaluationInstancesRepo:
        raise self._unsupported("metadata (evaluation instances)")

    def get_models(self) -> ModelsRepo:
        raise self._unsupported("model data")

    def get_l_events(self) -> LEvents:
        raise self._unsupported("event data (LEvents)")

    def get_p_events(self) -> PEvents:
        raise self._unsupported("event data (PEvents)")

    def recovery_report(self) -> dict:
        """Summary of the driver's startup recovery sweep: what it found
        on open (orphan temp files, torn commit points, torn tail lines)
        and where it quarantined them. Suspect files are **moved aside,
        never deleted** — an operator can inspect and, if a bug rather
        than a crash produced them, recover data. Default: nothing to
        sweep (backends with native crash recovery, e.g. sqlite WAL)."""
        return {"quarantined": [], "notes": []}

    def close(self) -> None:
        pass

    @staticmethod
    def sorted_events_key(e: Event) -> tuple:
        return (e.event_time, e.event_id or "")

    @staticmethod
    def match_filters(
        e: Event,
        start_time: _dt.datetime | None,
        until_time: _dt.datetime | None,
        entity_type: str | None,
        entity_id: str | None,
        event_names: Sequence[str] | None,
        target_entity_type: str | None,
        target_entity_id: str | None,
    ) -> bool:
        """Shared filter predicate used by drivers without a query engine."""
        if start_time is not None and e.event_time < start_time:
            return False
        if until_time is not None and e.event_time >= until_time:
            return False
        if entity_type is not None and e.entity_type != entity_type:
            return False
        if entity_id is not None and e.entity_id != entity_id:
            return False
        if event_names is not None and e.event not in set(event_names):
            return False
        if target_entity_type is not None and e.target_entity_type != target_entity_type:
            return False
        if target_entity_id is not None and e.target_entity_id != target_entity_id:
            return False
        return True
