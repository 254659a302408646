"""Event model: ``Event``, ``DataMap``, ``PropertyMap``, validation, JSON codec.

Capability parity with the reference's event model
(``data/storage/Event.scala``, ``data/storage/DataMap.scala``,
``data/storage/EventValidation.scala``, ``data/storage/EventJson4sSupport.scala``):
a timestamped behavioral event with an entity, an optional target entity,
a free-form typed property bag, and reserved ``$set``/``$unset``/``$delete``
semantics for entity-property mutation.

The wire format (JSON field names, ISO-8601 times with milliseconds and
zone offset) is kept byte-compatible with the reference's REST contract so
existing PredictionIO client SDKs keep working.
"""

from __future__ import annotations

import datetime as _dt
import re
import uuid
from dataclasses import dataclass, field, replace
from typing import Any, Iterator, Mapping

__all__ = [
    "DataMap",
    "PropertyMap",
    "Event",
    "EventValidationError",
    "validate_event",
    "event_to_json",
    "event_from_json",
    "parse_event_time",
    "format_event_time",
    "SET_EVENT",
    "UNSET_EVENT",
    "DELETE_EVENT",
    "RESERVED_EVENTS",
]

SET_EVENT = "$set"
UNSET_EVENT = "$unset"
DELETE_EVENT = "$delete"
#: Reserved (system) event names accepted by the event server. Any other
#: name beginning with ``$`` or ``pio_`` is rejected, matching the
#: reference's EventValidation rules.
RESERVED_EVENTS = frozenset({SET_EVENT, UNSET_EVENT, DELETE_EVENT})

_RESERVED_PREFIXES = ("$", "pio_")

#: pio_-prefixed entity types the server itself writes (parity: the
#: reference's builtin entity types — the feedback loop records
#: predictions as ``pio_pr`` entities).
BUILTIN_ENTITY_TYPES = frozenset({"pio_user", "pio_item", "pio_pr"})


class EventValidationError(ValueError):
    """Raised when an event violates the event-model invariants."""


class DataMap(Mapping[str, Any]):
    """An immutable, typed view over a JSON object of properties.

    Parity: ``data/storage/DataMap.scala`` — ``get[T](name)`` /
    ``getOpt[T]`` / ``getOrElse`` become :meth:`get_as`, :meth:`opt`,
    and plain ``Mapping`` access. Values are plain JSON-compatible Python
    values (str, int, float, bool, None, list, dict).
    """

    __slots__ = ("_fields",)

    def __init__(self, fields: Mapping[str, Any] | None = None):
        self._fields: dict[str, Any] = dict(fields or {})

    # -- Mapping interface -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._fields[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"DataMap({self._fields!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self) -> int:
        # JSON-canonicalize so list/dict-valued properties stay hashable.
        import json

        return hash(json.dumps(self._fields, sort_keys=True, default=str))

    # -- typed accessors ---------------------------------------------------
    def require(self, *names: str) -> None:
        """Raise if any of ``names`` is absent (reference: ``DataMap.require``)."""
        missing = [n for n in names if n not in self._fields]
        if missing:
            raise EventValidationError(f"Missing required properties: {missing}")

    def get_as(self, name: str, typ: type) -> Any:
        """Typed get: raise if absent or not coercible to ``typ``."""
        if name not in self._fields:
            raise EventValidationError(f"Property '{name}' is missing")
        return self._coerce(name, self._fields[name], typ)

    def opt(self, name: str, typ: type | None = None, default: Any = None) -> Any:
        """Optional typed get: ``default`` if absent."""
        if name not in self._fields:
            return default
        value = self._fields[name]
        if typ is None:
            return value
        return self._coerce(name, value, typ)

    def get_string_list(self, name: str) -> list[str]:
        value = self.get_as(name, list)
        return [str(v) for v in value]

    def get_double_list(self, name: str) -> list[float]:
        value = self.get_as(name, list)
        return [float(v) for v in value]

    @staticmethod
    def _coerce(name: str, value: Any, typ: type) -> Any:
        if typ is float and isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        if typ is int and isinstance(value, int) and not isinstance(value, bool):
            return value
        if not isinstance(value, typ) or (typ in (int, float) and isinstance(value, bool)):
            raise EventValidationError(
                f"Property '{name}' has type {type(value).__name__}, expected {typ.__name__}"
            )
        return value

    # -- functional updates (used by the $set/$unset aggregator) -----------
    def union(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        """Right-biased merge (``this ++ other`` in the reference)."""
        merged = dict(self._fields)
        merged.update(dict(other))
        return DataMap(merged)

    def without(self, keys) -> "DataMap":
        return DataMap({k: v for k, v in self._fields.items() if k not in set(keys)})

    def to_dict(self) -> dict[str, Any]:
        return dict(self._fields)


class PropertyMap(DataMap):
    """A :class:`DataMap` plus the lifecycle timestamps of the entity it
    describes (parity: ``data/storage/PropertyMap.scala``)."""

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Mapping[str, Any] | None,
        first_updated: _dt.datetime,
        last_updated: _dt.datetime,
    ):
        super().__init__(fields)
        self.first_updated = first_updated
        self.last_updated = last_updated

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"PropertyMap({self.to_dict()!r}, first={self.first_updated}, "
            f"last={self.last_updated})"
        )


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


@dataclass(frozen=True)
class Event:
    """One immutable behavioral event (parity: ``data/storage/Event.scala``).

    ``event_time`` is when the event happened in the outside world;
    ``creation_time`` is when the server recorded it. Both are
    timezone-aware datetimes.
    """

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: str | None = None
    target_entity_id: str | None = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: _dt.datetime = field(default_factory=_utcnow)
    event_id: str | None = None
    tags: tuple[str, ...] = ()
    pr_id: str | None = None
    creation_time: _dt.datetime = field(default_factory=_utcnow)

    def with_event_id(self, event_id: str) -> "Event":
        return replace(self, event_id=event_id)

    @property
    def is_set(self) -> bool:
        return self.event == SET_EVENT

    @property
    def is_unset(self) -> bool:
        return self.event == UNSET_EVENT

    @property
    def is_delete(self) -> bool:
        return self.event == DELETE_EVENT

    @property
    def is_special(self) -> bool:
        return self.event in RESERVED_EVENTS


def new_event_id() -> str:
    return uuid.uuid4().hex


def validate_event(event: Event) -> None:
    """Enforce the reference's EventValidation invariants
    (``data/storage/EventValidation.scala``).

    * non-empty ``event``, ``entityType``, ``entityId``
    * names starting with ``$`` or ``pio_`` are reserved; only
      ``$set``/``$unset``/``$delete`` are accepted
    * ``$unset`` requires a non-empty ``properties``
    * ``$set``/``$unset``/``$delete`` must not carry a target entity
    * ``$delete`` must not carry properties
    """
    if not event.event:
        raise EventValidationError("event must not be empty")
    if not event.entity_type:
        raise EventValidationError("entityType must not be empty")
    if not event.entity_id:
        raise EventValidationError("entityId must not be empty")
    if (event.target_entity_type is None) != (event.target_entity_id is None):
        raise EventValidationError(
            "targetEntityType and targetEntityId must be specified together"
        )

    for value, label in ((event.event, "event"), (event.entity_type, "entityType")):
        if any(value.startswith(p) for p in _RESERVED_PREFIXES):
            if label == "event" and value in RESERVED_EVENTS:
                continue
            if label == "entityType" and not value.startswith("$"):
                if value in BUILTIN_ENTITY_TYPES:
                    continue
                # other pio_* entity types are reserved for internal
                # bookkeeping; reject on the write path.
                raise EventValidationError(f"{label} '{value}' is reserved (pio_ prefix)")
            if label == "event":
                raise EventValidationError(
                    f"event name '{value}' is reserved; only "
                    f"{sorted(RESERVED_EVENTS)} are allowed to start with '$'"
                )
            raise EventValidationError(f"{label} '{value}' is reserved")

    if event.is_special and event.target_entity_type is not None:
        raise EventValidationError(
            f"{event.event} event must not have a target entity"
        )
    if event.is_unset and len(event.properties) == 0:
        raise EventValidationError("$unset event requires non-empty properties")
    if event.is_delete and len(event.properties) != 0:
        raise EventValidationError("$delete event must not have properties")


# --------------------------------------------------------------------------
# JSON codec — byte-compatible with the reference REST wire format
# (``data/storage/EventJson4sSupport.scala``,
#  ``data/storage/DateTimeJson4sSupport.scala``).
# --------------------------------------------------------------------------

_ISO_RE = re.compile(
    r"^(\d{4})-(\d{2})-(\d{2})T(\d{2}):(\d{2}):(\d{2})(\.\d{1,9})?"
    r"(Z|[+-]\d{2}:?\d{2})?$"
)


def parse_event_time(value: str) -> _dt.datetime:
    """Parse an ISO-8601 timestamp (joda ``DateTime`` style) into an aware
    datetime. Naive inputs are taken as UTC, matching the reference."""
    if not isinstance(value, str):
        raise EventValidationError(f"eventTime must be a string, got {type(value).__name__}")
    m = _ISO_RE.match(value)
    if not m:
        raise EventValidationError(f"Cannot parse eventTime '{value}'")
    year, month, day, hour, minute, second = (int(m.group(i)) for i in range(1, 7))
    frac = m.group(7)
    micros = int(round(float(frac) * 1_000_000)) if frac else 0
    carry = _dt.timedelta(0)
    if micros >= 1_000_000:  # e.g. ".9999999" rounds up into the next second
        micros = 0
        carry = _dt.timedelta(seconds=1)
    zone = m.group(8)
    if zone is None or zone == "Z":
        tz = _dt.timezone.utc
    else:
        zone = zone.replace(":", "")
        sign = 1 if zone[0] == "+" else -1
        offs = _dt.timedelta(hours=int(zone[1:3]), minutes=int(zone[3:5]))
        tz = _dt.timezone(sign * offs)
    try:
        return _dt.datetime(year, month, day, hour, minute, second, micros, tzinfo=tz) + carry
    except ValueError as e:
        raise EventValidationError(f"Cannot parse eventTime '{value}': {e}") from e


def format_event_time(dt: _dt.datetime) -> str:
    """Format as ISO-8601 with millisecond precision and zone offset —
    e.g. ``2026-07-29T12:34:56.789+00:00`` — the shape the reference emits."""
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    base = dt.strftime("%Y-%m-%dT%H:%M:%S")
    millis = dt.microsecond // 1000
    offset = dt.utcoffset() or _dt.timedelta(0)
    total = int(offset.total_seconds())
    sign = "+" if total >= 0 else "-"
    total = abs(total)
    return f"{base}.{millis:03d}{sign}{total // 3600:02d}:{(total % 3600) // 60:02d}"


def event_to_json(event: Event) -> dict[str, Any]:
    out: dict[str, Any] = {
        "eventId": event.event_id,
        "event": event.event,
        "entityType": event.entity_type,
        "entityId": event.entity_id,
    }
    if event.target_entity_type is not None:
        out["targetEntityType"] = event.target_entity_type
        out["targetEntityId"] = event.target_entity_id
    out["properties"] = event.properties.to_dict()
    out["eventTime"] = format_event_time(event.event_time)
    if event.tags:
        out["tags"] = list(event.tags)
    if event.pr_id is not None:
        out["prId"] = event.pr_id
    out["creationTime"] = format_event_time(event.creation_time)
    return out


def event_from_json(obj: Mapping[str, Any], *, validate: bool = True) -> Event:
    if "event" not in obj:
        raise EventValidationError("field 'event' is required")
    if "entityType" not in obj or "entityId" not in obj:
        raise EventValidationError("fields 'entityType' and 'entityId' are required")

    def _opt_str(key: str) -> str | None:
        v = obj.get(key)
        if v is None:
            return None
        if not isinstance(v, str):
            raise EventValidationError(f"field '{key}' must be a string")
        return v

    props = obj.get("properties") or {}
    if not isinstance(props, Mapping):
        raise EventValidationError("field 'properties' must be an object")
    event_time = (
        parse_event_time(obj["eventTime"]) if obj.get("eventTime") else _utcnow()
    )
    creation_time = (
        parse_event_time(obj["creationTime"]) if obj.get("creationTime") else _utcnow()
    )
    tags = obj.get("tags") or []
    if not isinstance(tags, (list, tuple)):
        raise EventValidationError("field 'tags' must be an array")
    ev = Event(
        event=str(obj["event"]),
        entity_type=str(obj["entityType"]),
        entity_id=str(obj["entityId"]),
        target_entity_type=_opt_str("targetEntityType"),
        target_entity_id=_opt_str("targetEntityId"),
        properties=DataMap(props),
        event_time=event_time,
        event_id=_opt_str("eventId"),
        tags=tuple(str(t) for t in tags),
        pr_id=_opt_str("prId"),
        creation_time=creation_time,
    )
    if validate:
        validate_event(ev)
    return ev
