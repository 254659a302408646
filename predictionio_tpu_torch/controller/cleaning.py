"""Self-cleaning data source — event compaction / TTL.

A copy of ``predictionio_tpu/controller/cleaning.py`` over the port's
storage, aggregator and event store (data layer only). Parity: ``core/src/main/scala/org/apache/predictionio/core/SelfCleaningDataSource.scala``
— a mixin a DataSource adds to keep its event stream bounded:

* **property compaction**: each entity's ``$set``/``$unset``/``$delete``
  chain collapses into one ``$set`` carrying the current PropertyMap;
* **TTL**: regular (non-reserved) events older than ``event_window``
  seconds are deleted.

Call :meth:`clean_persisted_data` from ``read_training`` (the reference
runs it on every train when ``eventWindow`` is configured).
"""

from __future__ import annotations

import datetime as _dt
import logging

from predictionio_tpu_torch.data.aggregator import aggregate_properties
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.store import resolve_app

__all__ = ["SelfCleaningDataSource"]

logger = logging.getLogger(__name__)


class SelfCleaningDataSource:
    """Mixin. The host class supplies ``app_name`` (and optionally
    ``channel_name``); cleaning parameters come as method args."""

    app_name: str = ""
    channel_name: str | None = None

    def clean_persisted_data(
        self,
        event_window_seconds: float | None = None,
        compact_properties: bool = True,
        now: _dt.datetime | None = None,
    ) -> dict:
        """Run one cleaning pass; returns counts for observability."""
        app_id, channel_id = resolve_app(self.app_name, self.channel_name)
        le = Storage.get_l_events()
        now = now or _dt.datetime.now(_dt.timezone.utc)
        removed = 0
        compacted_entities = 0

        if compact_properties:
            # entity -> its reserved-event chain
            by_entity: dict[tuple[str, str], list[Event]] = {}
            for e in le.find(
                app_id, channel_id, event_names=["$set", "$unset", "$delete"]
            ):
                by_entity.setdefault((e.entity_type, e.entity_id), []).append(e)
            for (etype, eid), chain in by_entity.items():
                if len(chain) <= 1:
                    continue
                props = aggregate_properties(iter(chain)).get(eid)
                for e in chain:
                    if e.event_id:
                        le.delete(e.event_id, app_id, channel_id)
                        removed += 1
                if props is not None:
                    # an entity alive with an empty map still exists:
                    # always re-insert its $set. Preserve first_updated
                    # with an empty $set at the original first timestamp
                    # (props is None only for $delete-d entities).
                    if props.first_updated < props.last_updated:
                        le.insert(
                            Event(
                                event="$set",
                                entity_type=etype,
                                entity_id=eid,
                                properties=DataMap({}),
                                event_time=props.first_updated,
                            ),
                            app_id,
                            channel_id,
                        )
                    le.insert(
                        Event(
                            event="$set",
                            entity_type=etype,
                            entity_id=eid,
                            properties=DataMap(props.to_dict()),
                            event_time=props.last_updated,
                        ),
                        app_id,
                        channel_id,
                    )
                compacted_entities += 1

        if event_window_seconds is not None:
            cutoff = now - _dt.timedelta(seconds=event_window_seconds)
            stale = [
                e
                for e in le.find(app_id, channel_id, until_time=cutoff)
                if not e.is_special and e.event_id
            ]
            for e in stale:
                le.delete(e.event_id, app_id, channel_id)
                removed += 1

        logger.info(
            "Self-cleaning app=%s: removed %d events, compacted %d entities",
            self.app_name, removed, compacted_entities,
        )
        return {"removed": removed, "compacted_entities": compacted_entities}
