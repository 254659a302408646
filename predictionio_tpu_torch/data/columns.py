"""Columnar event batches — the bulk representation training reads.

The reference feeds training from an ``RDD[Event]`` scan
(``data/storage/PEvents.scala`` → ``storage/hbase/HBPEvents.find``); the
per-record object stream is fine for Spark because the JVM amortizes it
across a cluster. On one host the analog is a **columnar batch**: dense
numpy arrays with dictionary-encoded entity ids, which the input pipeline
turns into device arrays without ever constructing 20M Python objects.

:class:`EventColumns` is the exchange type of the ``PEvents.find_columns``
SPI (``data/storage/base.py``): every driver can produce it (a universal
event-iterator fallback lives on the ABC), and the ``columnar`` driver
produces it at memcpy speed from its on-disk segments.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = [
    "EventChunk",
    "EventColumns",
    "columns_from_events",
    "encode_strings",
]


@dataclasses.dataclass
class EventColumns:
    """Dictionary-encoded event batch.

    ``*_code`` arrays index into the matching ``*_vocab`` string arrays;
    ``target_code == -1`` means the event has no target entity. ``prop``
    (present when a property name was requested) is float32 with NaN for
    rows where the property is absent or non-numeric — rows whose property
    lives in a driver's non-columnar residue are still surfaced here.
    Row order is deterministic per (driver, filters) but NOT globally
    time-sorted; training consumers must not rely on event order beyond
    what ``event_time_us`` itself provides.
    """

    event_code: np.ndarray  # int32 [N]
    event_vocab: np.ndarray  # unicode [E]
    entity_code: np.ndarray  # int32 [N]
    entity_vocab: np.ndarray  # unicode [U]
    target_code: np.ndarray  # int32 [N], -1 = no target entity
    target_vocab: np.ndarray  # unicode [I]
    event_time_us: np.ndarray  # int64 [N], UTC microseconds
    prop: np.ndarray | None = None  # float32 [N], NaN = absent

    def __len__(self) -> int:
        return int(self.event_code.shape[0])


@dataclasses.dataclass
class EventChunk:
    """One already-extracted batch of the bulk-ingest write path.

    The streaming bulk route and ``pio import`` parse NDJSON lines
    straight into this shape — python lists for the string fields (they
    feed ``np.unique`` dictionary encoding once per chunk), numpy arrays
    for the numeric ones — instead of constructing per-event
    ``Event``/``DataMap`` objects. Every row carries an ``ids`` entry
    (client-supplied or generated at parse time), which is what makes a
    retried bulk stream idempotent end to end. ``propf`` holds the
    numeric property columns (NaN = absent, ``propint`` remembers int
    inputs); everything non-numeric rides in the ``extra`` JSON residue
    (``""`` = none) exactly like the columnar segment layout.
    """

    event: list  # str per row
    entity_type: list  # str per row
    entity_id: list  # str per row
    target_entity_type: list  # str | None per row
    target_entity_id: list  # str | None per row
    t_us: np.ndarray  # int64 [N], UTC microseconds
    c_us: np.ndarray  # int64 [N]
    ids: list  # str per row — the dedup keys
    propf: dict[str, np.ndarray]  # float64 [N], NaN = absent
    propint: dict[str, np.ndarray]  # bool [N]: value was an int
    extra: list  # str per row, "" = none (JSON residue)

    def __len__(self) -> int:
        return len(self.event)

    def take(self, rows) -> "EventChunk":
        """Row-subset copy (fancy-indexed) — the unit the partitioned
        store routes to one partition and the replication layer mirrors
        to a replica. ``rows`` is any integer index sequence; order is
        preserved. The whole-chunk case returns ``self`` unsliced."""
        idx = np.asarray(rows, dtype=np.int64)
        if idx.shape[0] == len(self.event):
            return self
        pick = idx.tolist()
        return EventChunk(
            event=[self.event[i] for i in pick],
            entity_type=[self.entity_type[i] for i in pick],
            entity_id=[self.entity_id[i] for i in pick],
            target_entity_type=[self.target_entity_type[i] for i in pick],
            target_entity_id=[self.target_entity_id[i] for i in pick],
            t_us=self.t_us[idx],
            c_us=self.c_us[idx],
            ids=[self.ids[i] for i in pick],
            propf={k: v[idx] for k, v in self.propf.items()},
            propint={k: v[idx] for k, v in self.propint.items()},
            extra=[self.extra[i] for i in pick],
        )

    def to_events(self) -> list:
        """Decode rows into ``Event`` objects — the universal-driver
        adapter behind ``LEvents.ingest_chunk``'s base default (sqlite,
        memory, ...). The columnar driver never calls this."""
        import datetime as _dt
        import json as _json

        from predictionio_tpu_torch.data.event import DataMap, Event

        utc = _dt.timezone.utc
        out = []
        for i in range(len(self.event)):
            props: dict[str, Any] = {}
            for k, col in self.propf.items():
                v = col[i]
                if not np.isnan(v):
                    props[k] = int(v) if self.propint[k][i] else float(v)
            tags: tuple = ()
            pr_id = None
            if self.extra[i]:
                residue = _json.loads(self.extra[i])
                props.update(residue.get("p", {}))
                tags = tuple(residue.get("tags", ()))
                pr_id = residue.get("prId")
            out.append(
                Event(
                    event=self.event[i],
                    entity_type=self.entity_type[i],
                    entity_id=self.entity_id[i],
                    target_entity_type=self.target_entity_type[i],
                    target_entity_id=self.target_entity_id[i],
                    properties=DataMap(props),
                    event_time=_dt.datetime.fromtimestamp(
                        int(self.t_us[i]) / 1e6, tz=utc
                    ),
                    event_id=self.ids[i],
                    tags=tags,
                    pr_id=pr_id,
                    creation_time=_dt.datetime.fromtimestamp(
                        int(self.c_us[i]) / 1e6, tz=utc
                    ),
                )
            )
        return out

    def to_wire(self) -> dict:
        """JSON-safe encoding for the storage RPC (NaN → null)."""
        return {
            "event": list(self.event),
            "entityType": list(self.entity_type),
            "entityId": list(self.entity_id),
            "targetEntityType": list(self.target_entity_type),
            "targetEntityId": list(self.target_entity_id),
            "tUs": [int(v) for v in self.t_us],
            "cUs": [int(v) for v in self.c_us],
            "ids": list(self.ids),
            "propf": {
                k: [None if np.isnan(v) else float(v) for v in col]
                for k, col in self.propf.items()
            },
            "propint": {
                k: [bool(v) for v in col] for k, col in self.propint.items()
            },
            "extra": list(self.extra),
        }

    @staticmethod
    def from_wire(obj: dict) -> "EventChunk":
        propf = {
            k: np.asarray(
                [np.nan if v is None else float(v) for v in col], np.float64
            )
            for k, col in (obj.get("propf") or {}).items()
        }
        propint = {
            k: np.asarray(col, dtype=bool)
            for k, col in (obj.get("propint") or {}).items()
        }
        return EventChunk(
            event=[*map(str, obj["event"])],
            entity_type=[*map(str, obj["entityType"])],
            entity_id=[*map(str, obj["entityId"])],
            target_entity_type=[
                None if v is None else str(v) for v in obj["targetEntityType"]
            ],
            target_entity_id=[
                None if v is None else str(v) for v in obj["targetEntityId"]
            ],
            t_us=np.asarray(obj["tUs"], np.int64),
            c_us=np.asarray(obj["cUs"], np.int64),
            # null id = "generate one" (parse_chunk_wire stamps it)
            ids=["" if v is None else str(v) for v in obj["ids"]],
            propf=propf,
            propint=propint,
            extra=[*map(str, obj.get("extra") or [""] * len(obj["event"]))],
        )


def encode_strings(values: list) -> tuple[np.ndarray, np.ndarray]:
    """strings -> (codes int32, sorted vocab). None is not allowed here."""
    arr = np.asarray(values, dtype=np.str_)
    if arr.size == 0:
        return np.zeros(0, np.int32), np.zeros(0, dtype="<U1")
    vocab, codes = np.unique(arr, return_inverse=True)
    return codes.astype(np.int32), vocab


def columns_from_events(events, prop: str | None = None) -> EventColumns:
    """Universal fallback: build an :class:`EventColumns` from an event
    iterator. O(N) Python — correct everywhere, fast nowhere; drivers with
    a columnar layout override ``find_columns`` instead of using this."""
    ev_names: list[str] = []
    ent_ids: list[str] = []
    tgt_ids: list[str] = []
    has_target: list[bool] = []
    times: list[int] = []
    props: list[float] = []
    import datetime as _dt

    utc = _dt.timezone.utc
    for e in events:
        ev_names.append(e.event)
        ent_ids.append(e.entity_id)
        if e.target_entity_id is None:
            tgt_ids.append("")
            has_target.append(False)
        else:
            tgt_ids.append(e.target_entity_id)
            has_target.append(True)
        t = e.event_time
        if t.tzinfo is None:
            t = t.replace(tzinfo=utc)
        times.append(int(t.timestamp() * 1e6))
        if prop is not None:
            v = e.properties.opt(prop)
            props.append(
                float(v)
                if isinstance(v, (int, float)) and not isinstance(v, bool)
                else np.nan
            )
    event_code, event_vocab = encode_strings(ev_names)
    entity_code, entity_vocab = encode_strings(ent_ids)
    ht = np.asarray(has_target, dtype=bool)
    n = len(ev_names)
    if ht.any():
        t_codes, target_vocab = encode_strings([t for t, h in zip(tgt_ids, ht) if h])
        target_code = np.full(n, -1, np.int32)
        target_code[ht] = t_codes
    else:
        target_code = np.full(n, -1, np.int32)
        target_vocab = np.zeros(0, dtype="<U1")
    return EventColumns(
        event_code=event_code,
        event_vocab=event_vocab,
        entity_code=entity_code,
        entity_vocab=entity_vocab,
        target_code=target_code,
        target_vocab=target_vocab,
        event_time_us=np.asarray(times, dtype=np.int64),
        prop=np.asarray(props, dtype=np.float32) if prop is not None else None,
    )
