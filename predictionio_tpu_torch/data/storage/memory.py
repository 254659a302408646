"""In-memory tri-role storage driver.

Used by unit tests and ephemeral embedded runs; implements every repository
role so the whole framework can run with zero I/O. This is the "throwaway
tables" analog of the reference test utilities (``StorageTestUtils``), but
promoted to a first-class driver.
"""

from __future__ import annotations

import datetime as _dt
import itertools
import threading
from typing import Iterable, Iterator, Sequence

from predictionio_tpu_torch.data.event import Event, new_event_id
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    AccessKeysRepo,
    App,
    AppsRepo,
    BaseStorageClient,
    Channel,
    ChannelsRepo,
    EngineInstance,
    EngineInstancesRepo,
    EvaluationInstance,
    EvaluationInstancesRepo,
    LEvents,
    Model,
    ModelsRepo,
    PEvents,
    StorageClientConfig,
    generate_access_key,
)

__all__ = ["StorageClient"]


class _MemApps(AppsRepo):
    def __init__(self) -> None:
        self._apps: dict[int, App] = {}
        self._next = itertools.count(1)
        self._lock = threading.RLock()

    def insert(self, app: App) -> int | None:
        with self._lock:
            if app.id > 0:
                app_id = app.id
            else:
                app_id = next(self._next)
                while app_id in self._apps:  # skip ids taken by explicit inserts
                    app_id = next(self._next)
            if app_id in self._apps:
                return None
            if any(a.name == app.name for a in self._apps.values()):
                return None
            self._apps[app_id] = App(app_id, app.name, app.description)
            return app_id

    def get(self, app_id: int) -> App | None:
        return self._apps.get(app_id)

    def get_by_name(self, name: str) -> App | None:
        return next((a for a in self._apps.values() if a.name == name), None)

    def get_all(self) -> list[App]:
        return sorted(self._apps.values(), key=lambda a: a.id)

    def update(self, app: App) -> bool:
        with self._lock:
            if app.id not in self._apps:
                return False
            if any(a.name == app.name and a.id != app.id for a in self._apps.values()):
                return False  # name must stay unique
            self._apps[app.id] = app
            return True

    def delete(self, app_id: int) -> bool:
        with self._lock:
            return self._apps.pop(app_id, None) is not None


class _MemAccessKeys(AccessKeysRepo):
    def __init__(self) -> None:
        self._keys: dict[str, AccessKey] = {}
        self._lock = threading.RLock()

    def insert(self, access_key: AccessKey) -> str | None:
        with self._lock:
            key = access_key.key or generate_access_key()
            if key in self._keys:
                return None
            self._keys[key] = AccessKey(key, access_key.appid, tuple(access_key.events))
            return key

    def get(self, key: str) -> AccessKey | None:
        return self._keys.get(key)

    def get_all(self) -> list[AccessKey]:
        return list(self._keys.values())

    def get_by_appid(self, appid: int) -> list[AccessKey]:
        return [k for k in self._keys.values() if k.appid == appid]

    def update(self, access_key: AccessKey) -> bool:
        with self._lock:
            if access_key.key not in self._keys:
                return False
            self._keys[access_key.key] = access_key
            return True

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._keys.pop(key, None) is not None


class _MemChannels(ChannelsRepo):
    def __init__(self) -> None:
        self._channels: dict[int, Channel] = {}
        self._next = itertools.count(1)
        self._lock = threading.RLock()

    def insert(self, channel: Channel) -> int | None:
        if not Channel.is_valid_name(channel.name):
            return None
        with self._lock:
            if channel.id > 0:
                cid = channel.id
            else:
                cid = next(self._next)
                while cid in self._channels:  # skip ids taken by explicit inserts
                    cid = next(self._next)
            if cid in self._channels:
                return None
            if any(
                c.appid == channel.appid and c.name == channel.name
                for c in self._channels.values()
            ):
                return None
            self._channels[cid] = Channel(cid, channel.name, channel.appid)
            return cid

    def get(self, channel_id: int) -> Channel | None:
        return self._channels.get(channel_id)

    def get_by_appid(self, appid: int) -> list[Channel]:
        return sorted(
            (c for c in self._channels.values() if c.appid == appid),
            key=lambda c: c.id,
        )

    def delete(self, channel_id: int) -> bool:
        with self._lock:
            return self._channels.pop(channel_id, None) is not None


class _MemEngineInstances(EngineInstancesRepo):
    def __init__(self) -> None:
        self._instances: dict[str, EngineInstance] = {}
        self._next = itertools.count(1)
        self._lock = threading.RLock()

    def insert(self, instance: EngineInstance) -> str:
        with self._lock:
            iid = instance.id or str(next(self._next))
            self._instances[iid] = (
                instance if instance.id else EngineInstance(**{**instance.__dict__, "id": iid})
            )
            return iid

    def get(self, instance_id: str) -> EngineInstance | None:
        return self._instances.get(instance_id)

    def get_all(self) -> list[EngineInstance]:
        return sorted(self._instances.values(), key=lambda i: i.start_time)

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        return sorted(
            (
                i
                for i in self._instances.values()
                if i.status == "COMPLETED"
                and i.engine_id == engine_id
                and i.engine_version == engine_version
                and i.engine_variant == engine_variant
            ),
            key=lambda i: i.start_time,
            reverse=True,
        )

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None:
        completed = self.get_completed(engine_id, engine_version, engine_variant)
        return completed[0] if completed else None

    def update(self, instance: EngineInstance) -> bool:
        with self._lock:
            if instance.id not in self._instances:
                return False
            self._instances[instance.id] = instance
            return True

    def delete(self, instance_id: str) -> bool:
        with self._lock:
            return self._instances.pop(instance_id, None) is not None


class _MemEvaluationInstances(EvaluationInstancesRepo):
    def __init__(self) -> None:
        self._instances: dict[str, EvaluationInstance] = {}
        self._next = itertools.count(1)
        self._lock = threading.RLock()

    def insert(self, instance: EvaluationInstance) -> str:
        with self._lock:
            iid = instance.id or str(next(self._next))
            self._instances[iid] = (
                instance
                if instance.id
                else EvaluationInstance(**{**instance.__dict__, "id": iid})
            )
            return iid

    def get(self, instance_id: str) -> EvaluationInstance | None:
        return self._instances.get(instance_id)

    def get_all(self) -> list[EvaluationInstance]:
        return sorted(self._instances.values(), key=lambda i: i.start_time)

    def get_completed(self) -> list[EvaluationInstance]:
        return sorted(
            (i for i in self._instances.values() if i.status == "EVALCOMPLETED"),
            key=lambda i: i.start_time,
            reverse=True,
        )

    def update(self, instance: EvaluationInstance) -> bool:
        with self._lock:
            if instance.id not in self._instances:
                return False
            self._instances[instance.id] = instance
            return True

    def delete(self, instance_id: str) -> bool:
        with self._lock:
            return self._instances.pop(instance_id, None) is not None


class _MemModels(ModelsRepo):
    def __init__(self) -> None:
        self._models: dict[str, Model] = {}

    def insert(self, model: Model) -> None:
        self._models[model.id] = model

    def get(self, model_id: str) -> Model | None:
        return self._models.get(model_id)

    def delete(self, model_id: str) -> bool:
        return self._models.pop(model_id, None) is not None


class _MemEvents(LEvents):
    """Event store over plain dicts; streams keyed by (app_id, channel_id).
    The PEvents role is served by :class:`_MemPEvents` wrapping this."""

    def __init__(self) -> None:
        self._streams: dict[tuple[int, int | None], dict[str, Event]] = {}
        self._lock = threading.RLock()

    def _stream(self, app_id: int, channel_id: int | None) -> dict[str, Event]:
        return self._streams.setdefault((app_id, channel_id), {})

    # LEvents -------------------------------------------------------------
    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            self._stream(app_id, channel_id)
            return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            return self._streams.pop((app_id, channel_id), None) is not None

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        with self._lock:
            eid = event.event_id or new_event_id()
            self._stream(app_id, channel_id)[eid] = event.with_event_id(eid)
            return eid

    def insert_dedup(
        self, event: Event, app_id: int, channel_id: int | None = None
    ) -> tuple[str, bool]:
        """The id-keyed stream dict IS the (process-lifetime) dedup
        index: membership is exact, checked and inserted under one lock.
        No durability — this driver holds nothing across restarts."""
        with self._lock:
            eid = event.event_id or new_event_id()
            stream = self._stream(app_id, channel_id)
            if event.event_id and eid in stream:
                return eid, True
            stream[eid] = event.with_event_id(eid)
            return eid, False

    def get(self, event_id: str, app_id: int, channel_id: int | None = None) -> Event | None:
        return self._stream(app_id, channel_id).get(event_id)

    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            return self._stream(app_id, channel_id).pop(event_id, None) is not None

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
        with self._lock:
            events = list(self._stream(app_id, channel_id).values())
        events.sort(key=BaseStorageClient.sorted_events_key, reverse=reversed)
        if limit is not None and limit == 0:
            return
        n = 0
        for e in events:
            if BaseStorageClient.match_filters(
                e, start_time, until_time, entity_type, entity_id,
                event_names, target_entity_type, target_entity_id,
            ):
                yield e
                n += 1
                if limit is not None and 0 < limit <= n:
                    return

    def write(self, events: Iterable[Event], app_id: int, channel_id: int | None = None) -> None:
        for e in events:
            self.insert(e, app_id, channel_id)


class _MemPEvents(PEvents):
    def __init__(self, levents: _MemEvents) -> None:
        self._l = levents

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
        for i, e in enumerate(
            self._l.find(
                app_id, channel_id, start_time, until_time, entity_type,
                entity_id, event_names, target_entity_type, target_entity_id,
            )
        ):
            if i % num_shards == shard_index:
                yield e

    def write(self, events: Iterable[Event], app_id: int, channel_id: int | None = None) -> None:
        self._l.write(events, app_id, channel_id)

    def delete(self, app_id: int, channel_id: int | None = None) -> None:
        self._l.remove(app_id, channel_id)
        self._l.init(app_id, channel_id)


class StorageClient(BaseStorageClient):
    """Tri-role in-memory driver (``TYPE=memory``)."""

    def __init__(self, config: StorageClientConfig):
        super().__init__(config)
        self._apps = _MemApps()
        self._keys = _MemAccessKeys()
        self._channels = _MemChannels()
        self._engine_instances = _MemEngineInstances()
        self._eval_instances = _MemEvaluationInstances()
        self._models = _MemModels()
        self._events = _MemEvents()
        self._pevents = _MemPEvents(self._events)

    def get_apps(self) -> AppsRepo:
        return self._apps

    def get_access_keys(self) -> AccessKeysRepo:
        return self._keys

    def get_channels(self) -> ChannelsRepo:
        return self._channels

    def get_engine_instances(self) -> EngineInstancesRepo:
        return self._engine_instances

    def get_evaluation_instances(self) -> EvaluationInstancesRepo:
        return self._eval_instances

    def get_models(self) -> ModelsRepo:
        return self._models

    def get_l_events(self) -> LEvents:
        return self._events

    def get_p_events(self) -> PEvents:
        return self._pevents
