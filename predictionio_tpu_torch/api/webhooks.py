"""Webhook connector framework + bundled connectors.

Parity: ``data/api/webhooks/`` (``ConnectorUtil``, ``JsonConnector``,
``FormConnector``) and the concrete connectors under ``data/webhooks/``
(``examplejson``, ``exampleform``, ``segmentio``, ``mailchimp``) —
adapters that turn third-party POST payloads into :class:`Event`s on a
per-app webhook endpoint (``POST /webhooks/<connector>.json``).
"""

from __future__ import annotations

import abc
from typing import Any, Mapping

from predictionio_tpu_torch.data.event import DataMap, Event, parse_event_time

__all__ = [
    "ConnectorError",
    "JsonConnector",
    "FormConnector",
    "CONNECTORS",
    "register_connector",
    "get_connector",
]


class ConnectorError(ValueError):
    """Payload cannot be adapted into an Event (parity: ``ConnectorException``)."""


class JsonConnector(abc.ABC):
    """Adapts a JSON POST body into an Event (parity: ``JsonConnector.scala``)."""

    kind = "json"

    @abc.abstractmethod
    def to_event(self, payload: Mapping[str, Any]) -> Event: ...


class FormConnector(abc.ABC):
    """Adapts form-encoded fields into an Event (parity: ``FormConnector.scala``)."""

    kind = "form"

    @abc.abstractmethod
    def to_event(self, fields: Mapping[str, str]) -> Event: ...


class ExampleJsonConnector(JsonConnector):
    """Parity: ``data/webhooks/examplejson/ExampleJsonConnector.scala`` —
    payload ``{"type": "userAction", "userId": ..., "targetedItem"?: ...,
    "properties"?: {...}, "timestamp"?: ...}``."""

    def to_event(self, payload: Mapping[str, Any]) -> Event:
        if payload.get("type") != "userAction":
            raise ConnectorError(f"Unsupported payload type: {payload.get('type')!r}")
        if not payload.get("userId"):
            raise ConnectorError("field 'userId' is required")
        target = payload.get("targetedItem")
        kwargs = {}
        if payload.get("timestamp"):
            kwargs["event_time"] = parse_event_time(payload["timestamp"])
        return Event(
            event=str(payload.get("event", "userAction")),
            entity_type="user",
            entity_id=str(payload["userId"]),
            target_entity_type="item" if target is not None else None,
            target_entity_id=str(target) if target is not None else None,
            properties=DataMap(payload.get("properties") or {}),
            **kwargs,
        )


class ExampleFormConnector(FormConnector):
    """Parity: ``data/webhooks/exampleform/ExampleFormConnector.scala``."""

    def to_event(self, fields: Mapping[str, str]) -> Event:
        if "userId" not in fields:
            raise ConnectorError("field 'userId' is required")
        target = fields.get("itemId")
        props = {
            k: v for k, v in fields.items() if k not in {"userId", "itemId", "event", "timestamp"}
        }
        return Event(
            event=fields.get("event", "formAction"),
            entity_type="user",
            entity_id=fields["userId"],
            target_entity_type="item" if target else None,
            target_entity_id=target or None,
            properties=DataMap(props),
        )


class SegmentIOConnector(JsonConnector):
    """Parity: ``data/webhooks/segmentio/SegmentIOConnector.scala`` —
    Segment spec events (identify/track/page/screen/alias/group)."""

    SUPPORTED = frozenset({"identify", "track", "page", "screen", "alias", "group"})

    def to_event(self, payload: Mapping[str, Any]) -> Event:
        kind = payload.get("type")
        if kind not in self.SUPPORTED:
            raise ConnectorError(f"Unsupported Segment.io event type: {kind!r}")
        user = payload.get("userId") or payload.get("anonymousId")
        if not user:
            raise ConnectorError("Segment.io payload needs userId or anonymousId")
        props_key = {
            "identify": "traits",
            "group": "traits",
            "track": "properties",
            "page": "properties",
            "screen": "properties",
            "alias": "properties",
        }[kind]
        props = dict(payload.get(props_key) or {})
        if kind == "track" and payload.get("event"):
            props["event"] = payload["event"]
        ts = payload.get("timestamp") or payload.get("sentAt")
        kwargs = {}
        if ts:
            kwargs["event_time"] = parse_event_time(ts)
        return Event(
            event=kind,
            entity_type="user",
            entity_id=str(user),
            properties=DataMap(props),
            **kwargs,
        )


class MailChimpConnector(FormConnector):
    """Parity: ``data/webhooks/mailchimp/MailChimpConnector.scala`` —
    MailChimp list-event form posts (``type=subscribe`` etc., fields
    flattened as ``data[email]`` style keys)."""

    SUPPORTED = frozenset(
        {"subscribe", "unsubscribe", "profile", "upemail", "cleaned", "campaign"}
    )

    def to_event(self, fields: Mapping[str, str]) -> Event:
        kind = fields.get("type")
        if kind not in self.SUPPORTED:
            raise ConnectorError(f"Unsupported MailChimp event type: {kind!r}")
        entity_id = (
            fields.get("data[email]")
            or fields.get("data[new_email]")
            or fields.get("data[id]")
        )
        if not entity_id:
            raise ConnectorError("MailChimp payload needs data[email] or data[id]")
        props = {
            k[len("data["):-1]: v
            for k, v in fields.items()
            if k.startswith("data[") and k.endswith("]")
        }
        return Event(
            event=kind,
            entity_type="user",
            entity_id=entity_id,
            properties=DataMap(props),
        )


CONNECTORS: dict[str, JsonConnector | FormConnector] = {
    "examplejson": ExampleJsonConnector(),
    "exampleform": ExampleFormConnector(),
    "segmentio": SegmentIOConnector(),
    "mailchimp": MailChimpConnector(),
}


def register_connector(name: str, connector: JsonConnector | FormConnector) -> None:
    CONNECTORS[name] = connector


def get_connector(name: str) -> JsonConnector | FormConnector | None:
    return CONNECTORS.get(name)
