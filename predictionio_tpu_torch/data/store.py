"""Public event-read API used by engine templates.

Parity: ``data/store/PEventStore.scala``, ``data/store/LEventStore.scala``,
``data/store/Common.scala`` — resolve an *app name* (+ optional channel name)
to the underlying storage stream, then scan or aggregate. Nothing above this
module knows which backend holds events.

The P-side (training) additionally exposes a batched columnar path: the
trainer wants dense host arrays, not an object stream, so
:meth:`PEventStore.find` feeds :func:`~predictionio_tpu_torch.data.store.events` to
templates which index entities via ``BiMap`` and build ``numpy`` arrays for
the device input pipeline.
"""

from __future__ import annotations

import datetime as _dt
from typing import Iterator, Sequence

from predictionio_tpu_torch.data.aggregator import aggregate_properties, aggregate_properties_single
from predictionio_tpu_torch.data.event import Event, PropertyMap
from predictionio_tpu_torch.data.storage import Storage, StorageError

__all__ = ["PEventStore", "LEventStore", "resolve_app"]


def resolve_app(app_name: str, channel_name: str | None = None) -> tuple[int, int | None]:
    """appName (+ channelName) -> (appId, channelId). Raises on unknown names
    (parity: ``data/store/Common.scala`` ``appNameToId``)."""
    app = Storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise StorageError(f"Unknown app name '{app_name}'")
    if channel_name is None:
        return app.id, None
    channels = Storage.get_meta_data_channels().get_by_appid(app.id)
    for ch in channels:
        if ch.name == channel_name:
            return app.id, ch.id
    raise StorageError(f"Unknown channel '{channel_name}' for app '{app_name}'")


class _PEventStore:
    """Bulk reads for training (parity: ``PEventStore.scala``)."""

    def find(
        self,
        app_name: str,
        channel_name: str | None = None,
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
        app_id, channel_id = resolve_app(app_name, channel_name)
        return Storage.get_p_events().find(
            app_id, channel_id,
            start_time=start_time, until_time=until_time,
            entity_type=entity_type, entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
            shard_index=shard_index, num_shards=num_shards,
        )

    def find_columns(
        self,
        app_name: str,
        channel_name: str | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None = None,
        prop: str | None = None,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        """Columnar bulk scan (``data/columns.EventColumns``): the same
        filters as :meth:`find`, landed as dictionary-encoded numpy
        arrays. Every driver supports it (the base SPI adapts the event
        iterator); the ``columnar`` driver serves it at array speed —
        this is the path a 10^7-event ``pio train`` reads through."""
        app_id, channel_id = resolve_app(app_name, channel_name)
        return Storage.get_p_events().find_columns(
            app_id, channel_id,
            start_time=start_time, until_time=until_time,
            entity_type=entity_type, event_names=event_names,
            target_entity_type=target_entity_type, prop=prop,
            shard_index=shard_index, num_shards=num_shards,
        )

    def aggregate_properties(
        self,
        app_name: str,
        entity_type: str,
        channel_name: str | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        required: Sequence[str] | None = None,
    ) -> dict[str, PropertyMap]:
        """Fold ``$set``/``$unset``/``$delete`` streams into the current
        property map per entity (parity: ``PEventStore.aggregateProperties``).
        ``required`` drops entities missing any of those property names."""
        events = self.find(
            app_name, channel_name,
            start_time=start_time, until_time=until_time,
            entity_type=entity_type,
            event_names=["$set", "$unset", "$delete"],
        )
        props = aggregate_properties(events)
        if required:
            props = {
                eid: p for eid, p in props.items()
                if all(name in p for name in required)
            }
        return props


class _LEventStore:
    """Low-latency reads at serving time (parity: ``LEventStore.scala``).

    The reference enforces a blocking timeout around its async storage
    futures. Here ``timeout`` becomes an ambient resilience deadline
    around the driver scan: local drivers (sqlite/memory/columnar) answer
    in microseconds and never notice it, but the *remote* storage driver
    consults :func:`predictionio_tpu_torch.resilience.current_deadline` per RPC
    attempt — a serving-time read against a slow storage server is cut
    off at the caller's budget instead of silently ignoring it (piolint
    PIO208 guards this propagation tree-wide).
    """

    @staticmethod
    def _scan(timeout: float | None, thunk):
        if timeout is None:
            return list(thunk())
        from predictionio_tpu_torch import resilience

        with resilience.deadline_scope(timeout):
            return list(thunk())

    def find_by_entity(
        self,
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None = None,
        target_entity_id: str | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        limit: int | None = None,
        latest: bool = True,
        timeout: float | None = None,
    ) -> list[Event]:
        app_id, channel_id = resolve_app(app_name, channel_name)
        return self._scan(
            timeout,
            lambda: Storage.get_l_events().find(
                app_id, channel_id,
                start_time=start_time, until_time=until_time,
                entity_type=entity_type, entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
                limit=limit, reversed=latest,
            ),
        )

    def find(
        self,
        app_name: str,
        channel_name: str | None = None,
        timeout: float | None = None,
        **filters,
    ) -> list[Event]:
        app_id, channel_id = resolve_app(app_name, channel_name)
        return self._scan(
            timeout,
            lambda: Storage.get_l_events().find(app_id, channel_id, **filters),
        )

    def aggregate_properties_of_entity(
        self,
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: str | None = None,
        timeout: float | None = None,
    ) -> PropertyMap | None:
        events = self.find_by_entity(
            app_name, entity_type, entity_id, channel_name,
            event_names=["$set", "$unset", "$delete"], latest=False,
            timeout=timeout,
        )
        return aggregate_properties_single(events)


PEventStore = _PEventStore()
LEventStore = _LEventStore()
