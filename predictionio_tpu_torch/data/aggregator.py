"""Entity-property aggregation and string<->int indexing.

Parity with the reference's entity views
(``data/storage/LEventAggregator.scala``, ``data/storage/PEventAggregator.scala``,
``data/storage/BiMap.scala``): fold a stream of ``$set``/``$unset``/``$delete``
events into the current :class:`~predictionio_tpu_torch.data.event.PropertyMap` per
entity. ``BiMap``, the string<->index map engine templates use to hand
dense integer ids to the numeric compute path, is re-exported from
:mod:`predictionio_tpu_torch.data.bimap`: the port has one ``BiMap``
class, whose pickled state is the JAX package's.
"""

from __future__ import annotations

import datetime as _dt
from typing import Iterable

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.event import (
    DELETE_EVENT,
    SET_EVENT,
    UNSET_EVENT,
    Event,
    PropertyMap,
)

__all__ = ["aggregate_properties", "aggregate_properties_single", "BiMap"]


def _fold(events: Iterable[Event]) -> PropertyMap | None:
    """Fold one entity's special events (any order) into its current state.

    Later ``event_time`` wins per property; ``$delete`` erases everything
    seen so far (events after the delete re-create the entity) — the same
    semantics as the reference aggregator's ``dataMapAggregator``.
    """
    ordered = sorted(events, key=lambda e: e.event_time)
    fields: dict[str, object] = {}
    first: _dt.datetime | None = None
    last: _dt.datetime | None = None
    alive = False
    for e in ordered:
        if e.event == DELETE_EVENT:
            fields.clear()
            first = last = None
            alive = False
        elif e.event == SET_EVENT:
            fields.update(e.properties.to_dict())
            first = first or e.event_time
            last = e.event_time
            alive = True
        elif e.event == UNSET_EVENT and alive:
            # $unset on a nonexistent entity is a no-op (reference:
            # dataMapAggregator maps over None without creating the entity).
            for k in e.properties:
                fields.pop(k, None)
            last = e.event_time
    if not alive or first is None or last is None:
        return None
    return PropertyMap(fields, first_updated=first, last_updated=last)


def aggregate_properties(events: Iterable[Event]) -> dict[str, PropertyMap]:
    """Aggregate ``$set``/``$unset``/``$delete`` events (one entity type)
    into ``{entityId: PropertyMap}``. Non-special events are ignored.
    """
    by_entity: dict[str, list[Event]] = {}
    for e in events:
        if e.is_special:
            by_entity.setdefault(e.entity_id, []).append(e)
    out: dict[str, PropertyMap] = {}
    for entity_id, evs in by_entity.items():
        folded = _fold(evs)
        if folded is not None:
            out[entity_id] = folded
    return out


def aggregate_properties_single(events: Iterable[Event]) -> PropertyMap | None:
    """Aggregate special events of a single entity (serving-time path)."""
    return _fold([e for e in events if e.is_special])
