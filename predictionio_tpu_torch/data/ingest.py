"""Streaming bulk-ingest pipeline: NDJSON bytes → columnar chunks → store.

Counterpart of ``predictionio_tpu/data/ingest.py``, line for line apart
from this docstring and the imports. A bulk payload is a mapped
parse/validate over line chunks followed by one columnar append per
chunk, never a loop of per-event ``dict`` → ``Event`` → ``DataMap``
round trips.

Three pieces:

* :func:`parse_chunk` — vectorized-extraction NDJSON parser: one
  ``json.loads`` per line straight into :class:`~predictionio_tpu_torch.data.
  columns.EventChunk` column lists (no per-event ``Event`` objects),
  batch validation mirroring ``validate_event`` with **per-line error
  offsets**, and a sliced-field ISO-8601 fast path (:func:`iso_us`) with
  a per-day epoch cache so timestamp decoding stops dominating parse.
* :class:`IngestPipeline` — the pipelined parse→validate→append stages:
  the caller (a file reader) feeds raw byte blocks, a parser thread turns
  line chunks into ``EventChunk``s, and ONE appender thread owns the
  store write path (``LEvents.ingest_chunk``), so reading, parsing and
  appends overlap instead of serializing. Stage queues are bounded —
  backpressure propagates to the reader — and per-chunk results stream
  back in order.
* :class:`ChunkResult` — the per-chunk status record (stored/duplicate/
  invalid counts, capped per-line error and duplicate offsets).

Used by ``pio import`` (``tools/commands.py``) and by the event
server's bulk route, ``POST /events/bulk.json``
(``api/service.py``: ``EventService._bulk_lines`` streams the request
body through an :class:`IngestPipeline`). Layering: data-layer
only — this module imports nothing of tools or serving.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
import queue
import threading
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from predictionio_tpu_torch.data.columns import EventChunk
from predictionio_tpu_torch.data.event import (
    BUILTIN_ENTITY_TYPES,
    RESERVED_EVENTS,
    new_event_id,
    parse_event_time,
)

__all__ = [
    "ChunkResult",
    "IngestPipeline",
    "ParseOutcome",
    "PipelineError",
    "iso_us",
    "parse_chunk",
    "split_lines",
]

logger = logging.getLogger(__name__)

_UTC = _dt.timezone.utc

#: per-chunk cap on the error / duplicate line-offset lists streamed
#: back by the bulk route (counts stay exact); bounds response size so a
#: pathological all-invalid or all-duplicate stream cannot balloon the
#: status channel while the client is still blind-sending the payload
MAX_LINE_REPORTS = 256

#: ``(year, month, day) -> UTC epoch seconds of midnight`` — bulk
#: payloads cluster heavily by day, so almost every row's timestamp
#: resolves with integer math instead of a ``datetime`` construction.
#: Bounded: cleared wholesale at the cap (a cache this small rebuilds in
#: microseconds; real payloads never span 4096 distinct days).
_DAY_EPOCH: dict[tuple[int, int, int], int] = {}
_DAY_EPOCH_MAX = 4096


def _day_epoch(y: int, mo: int, d: int) -> int:
    key = (y, mo, d)
    v = _DAY_EPOCH.get(key)
    if v is None:
        v = int(_dt.datetime(y, mo, d, tzinfo=_UTC).timestamp())
        if len(_DAY_EPOCH) >= _DAY_EPOCH_MAX:
            _DAY_EPOCH.clear()
        _DAY_EPOCH[key] = v
    return v


#: full-timestamp memo: bulk payloads repeat timestamp STRINGS heavily
#: (second/millisecond granularity exports, steady-state streams), so
#: the common case is one dict hit instead of any parsing at all.
#: Bounded: cleared wholesale at the cap.
_TS_CACHE: dict[str, int] = {}
_TS_CACHE_MAX = 16_384


def iso_us(value: str) -> int:
    """ISO-8601 timestamp → UTC microseconds, semantics identical to
    ``parse_event_time`` (naive = UTC, fractional rounding, carry).

    Fast path: a memo of whole timestamp strings (bulk payloads repeat
    them), then fixed-position slicing plus the per-day epoch cache —
    ~5x cheaper than the regex + ``datetime`` construction. Anything
    that doesn't match the common shape falls back to
    ``parse_event_time`` so error messages and edge-case behavior stay
    byte-identical with the single-event route."""
    cached = _TS_CACHE.get(value)
    if cached is not None:
        return cached
    us = _iso_us_uncached(value)
    if len(_TS_CACHE) >= _TS_CACHE_MAX:
        _TS_CACHE.clear()
    _TS_CACHE[value] = us
    return us


def _iso_us_uncached(value: str) -> int:
    try:
        if (
            len(value) >= 19
            and value[4] == "-"
            and value[7] == "-"
            and value[10] == "T"
            and value[13] == ":"
            and value[16] == ":"
        ):
            y = int(value[:4])
            mo = int(value[5:7])
            d = int(value[8:10])
            h = int(value[11:13])
            mi = int(value[14:16])
            sec = int(value[17:19])
            if h > 23 or mi > 59 or sec > 59:
                # out-of-range fields must take the datetime-backed
                # fallback so they REJECT exactly like the single route
                # instead of silently rolling over
                raise ValueError(value)
            i = 19
            micros = 0
            carry = 0
            if i < len(value) and value[i] == ".":
                j = i + 1
                while j < len(value) and value[j].isdigit():
                    j += 1
                frac = value[i:j]
                if len(frac) < 2 or len(frac) > 10:
                    raise ValueError(frac)
                # mirror parse_event_time exactly: float round + carry
                micros = int(round(float(frac) * 1_000_000))
                if micros >= 1_000_000:
                    micros = 0
                    carry = 1
                i = j
            zone = value[i:]
            if zone == "" or zone == "Z":
                off = 0
            else:
                sign = zone[0]
                if sign not in "+-":
                    raise ValueError(zone)
                z = zone[1:].replace(":", "")
                if len(z) != 4:
                    raise ValueError(zone)
                zh = int(z[:2])
                zm = int(z[2:])
                if zh > 23 or zm > 59:
                    raise ValueError(zone)  # fallback rejects like tz()
                off = zh * 3600 + zm * 60
                if sign == "-":
                    off = -off
            base = _day_epoch(y, mo, d) + h * 3600 + mi * 60 + sec - off
            return (base + carry) * 1_000_000 + micros
    except (ValueError, TypeError, KeyError):
        pass
    t = parse_event_time(value)
    return int(t.timestamp() * 1e6)


@dataclasses.dataclass
class ParseOutcome:
    """One parsed chunk: the columnar rows that validated, plus the
    per-line rejects. ``row_lines[i]`` is the global (0-based) payload
    line number row ``i`` came from — invalid lines punch holes, so the
    mapping is explicit. ``id_supplied[i]`` remembers whether the row
    carried a client ``eventId`` (the dedup hit/miss counters only count
    supplied ids, same as the single/batch routes)."""

    chunk: EventChunk
    errors: list  # [{"line": int, "status": int, "message": str}, ...]
    row_lines: list  # int per chunk row
    id_supplied: list  # bool per chunk row
    received: int  # lines seen (valid + invalid)


def _err(line: int, message: str, status: int = 400) -> dict:
    return {"line": line, "status": status, "message": message}


def _field_error(obj: Any) -> str | None:
    """Mirror of ``event_from_json`` + ``validate_event`` over a raw
    dict — same checks, same messages, no ``Event`` construction.
    Returns the error message or None. Parity is CI-tested
    (tests/test_bulk_ingest.py) so the bulk route can never accept what
    the single route rejects."""
    if not isinstance(obj, dict):
        return "Event must be a JSON object."
    if "event" not in obj:
        return "field 'event' is required"
    if "entityType" not in obj or "entityId" not in obj:
        return "fields 'entityType' and 'entityId' are required"
    event = str(obj["event"])
    etype = str(obj["entityType"])
    eid = str(obj["entityId"])
    for key in ("targetEntityType", "targetEntityId", "eventId", "prId"):
        v = obj.get(key)
        if v is not None and not isinstance(v, str):
            return f"field '{key}' must be a string"
    props = obj.get("properties") or {}
    if not isinstance(props, dict):
        return "field 'properties' must be an object"
    tags = obj.get("tags") or []
    if not isinstance(tags, (list, tuple)):
        return "field 'tags' must be an array"
    if not event:
        return "event must not be empty"
    if not etype:
        return "entityType must not be empty"
    if not eid:
        return "entityId must not be empty"
    tt = obj.get("targetEntityType")
    tid = obj.get("targetEntityId")
    if (tt is None) != (tid is None):
        return "targetEntityType and targetEntityId must be specified together"
    if event.startswith(("$", "pio_")) and event not in RESERVED_EVENTS:
        return (
            f"event name '{event}' is reserved; only "
            f"{sorted(RESERVED_EVENTS)} are allowed to start with '$'"
        )
    if etype.startswith("$"):
        return f"entityType '{etype}' is reserved"
    if etype.startswith("pio_") and etype not in BUILTIN_ENTITY_TYPES:
        return f"entityType '{etype}' is reserved (pio_ prefix)"
    if event in RESERVED_EVENTS and tt is not None:
        return f"{event} event must not have a target entity"
    if event == "$unset" and len(props) == 0:
        return "$unset event requires non-empty properties"
    if event == "$delete" and len(props) != 0:
        return "$delete event must not have properties"
    return None


def parse_chunk(
    lines: Sequence[bytes],
    base_line: int = 0,
    allowed_events: frozenset | set | None = None,
    now_us: int | None = None,
) -> ParseOutcome:
    """One mapped parse/validate stage: NDJSON lines → an
    :class:`EventChunk` plus per-line error offsets.

    Exactly one ``json.loads`` per line; field extraction goes straight
    into column lists (numeric properties into float columns, everything
    else into the JSON residue), and validation mirrors the single-POST
    route's ``validate_event`` including the access-key event whitelist
    (``allowed_events``; violations answer per-line 403s). Rows without
    a client ``eventId`` are stamped here so every stored row has a
    dedup key."""
    n_hint = len(lines)
    ev: list = []
    etype: list = []
    eid: list = []
    ttype: list = []
    tid: list = []
    t_us: list = []
    c_us: list = []
    ids: list = []
    extra: list = []
    row_lines: list = []
    id_supplied: list = []
    prop_cols: dict[str, list] = {}
    prop_int: dict[str, list] = {}
    errors: list = []
    if now_us is None:
        now_us = int(_dt.datetime.now(_UTC).timestamp() * 1e6)
    received = 0
    # one joined array parse for the whole chunk: json scans
    # `[line,line,...]` in a single C pass (~40% cheaper than a loads
    # per line). Any malformed line fails the joined parse — the
    # per-line fallback then assigns exact per-line errors; an element-
    # count mismatch (a line like `1,2` smuggling two elements) forces
    # the same fallback.
    present: list[int] = []
    parts: list[bytes] = []
    for offset, raw in enumerate(lines):
        if raw.strip():
            parts.append(raw if isinstance(raw, bytes) else raw.encode())
            present.append(offset)
    objs: list | None
    try:
        objs = json.loads(b"[" + b",".join(p.rstrip(b"\r\n") for p in parts) + b"]")
        if len(objs) != len(parts):
            objs = None
    except (json.JSONDecodeError, UnicodeDecodeError, ValueError):
        objs = None
    # hot loop: bound everything (method lookups cost real throughput at
    # 10^5+ lines/s); validation runs an inlined fast path for the
    # common shape and defers to _field_error for exact reject messages
    loads = json.loads
    append_ev = ev.append
    append_etype = etype.append
    append_eid = eid.append
    append_ttype = ttype.append
    append_tid = tid.append
    append_t = t_us.append
    append_c = c_us.append
    append_id = ids.append
    append_extra = extra.append
    append_row_line = row_lines.append
    append_supplied = id_supplied.append
    for j, offset in enumerate(present):
        received += 1
        line_no = base_line + offset
        if objs is not None:
            obj = objs[j]
        else:
            try:
                obj = loads(parts[j])
            except (json.JSONDecodeError, UnicodeDecodeError, ValueError) as e:
                errors.append(_err(line_no, f"Malformed JSON: {e}"))
                continue
        if type(obj) is not dict:
            errors.append(_err(line_no, "Event must be a JSON object."))
            continue
        name = obj.get("event")
        et_v = obj.get("entityType")
        ei_v = obj.get("entityId")
        tt_v = obj.get("targetEntityType")
        tid_v = obj.get("targetEntityId")
        props = obj.get("properties")
        tags = obj.get("tags")
        eid_v = obj.get("eventId")
        pr_v = obj.get("prId")
        if not (
            type(name) is str and name and name[0] != "$"
            and not name.startswith("pio_")
            and type(et_v) is str and et_v and et_v[0] != "$"
            and not et_v.startswith("pio_")
            and type(ei_v) is str and ei_v
            and (tt_v is None) == (tid_v is None)
            and (tt_v is None or type(tt_v) is str)
            and (tid_v is None or type(tid_v) is str)
            and (props is None or type(props) is dict)
            and (tags is None or type(tags) is list)
            and (eid_v is None or type(eid_v) is str)
            and (pr_v is None or type(pr_v) is str)
        ):
            # uncommon shape: the exact mirror of validate_event decides
            # (reserved-but-allowed names pass, everything else gets the
            # single-route's message verbatim)
            msg = _field_error(obj)
            if msg is not None:
                errors.append(_err(line_no, msg))
                continue
            name = str(obj["event"])
            et_v = str(obj["entityType"])
            ei_v = str(obj["entityId"])
        if allowed_events is not None and name not in allowed_events:
            errors.append(
                _err(
                    line_no,
                    f"Event '{name}' is not allowed by this accessKey.",
                    status=403,
                )
            )
            continue
        try:
            t_str = obj.get("eventTime")
            row_t = iso_us(t_str) if t_str else now_us
            c_str = obj.get("creationTime")
            row_c = iso_us(c_str) if c_str else now_us
        except Exception as e:
            errors.append(_err(line_no, str(e)))
            continue
        row = len(ev)
        residue_p: dict[str, Any] = {}
        if props:
            for k, v in props.items():
                tv = type(v)
                if tv is not float and tv is not int:
                    residue_p[k] = v
                    continue
                try:
                    fv = float(v)
                except OverflowError:
                    # an int beyond float range: the single route keeps
                    # it verbatim (DataMap), so the bulk path routes it
                    # to the JSON residue instead of failing the stream
                    residue_p[k] = v
                    continue
                col = prop_cols.get(k)
                if col is None:
                    col = prop_cols[k] = []
                    prop_int[k] = []
                # backfill NaN for rows that predate this property
                if len(col) < row:
                    col.extend([np.nan] * (row - len(col)))
                    prop_int[k].extend([False] * (row - len(prop_int[k])))
                col.append(fv)
                prop_int[k].append(tv is int)
        if residue_p or tags or pr_v is not None:
            residue: dict[str, Any] = {}
            if residue_p:
                residue["p"] = residue_p
            if tags:
                residue["tags"] = [str(t) for t in tags]
            if pr_v is not None:
                residue["prId"] = pr_v
            append_extra(json.dumps(residue))
        else:
            append_extra("")
        append_ev(name)
        append_etype(et_v)
        append_eid(ei_v)
        append_ttype(tt_v)
        append_tid(tid_v)
        append_t(row_t)
        append_c(row_c)
        supplied = bool(eid_v)
        append_supplied(supplied)
        append_id(eid_v if supplied else new_event_id())
        append_row_line(line_no)

    n = len(ev)
    propf = {}
    propint = {}
    for k, col in prop_cols.items():
        if len(col) < n:  # backfill rows after the property's last sight
            col.extend([np.nan] * (n - len(col)))
            prop_int[k].extend([False] * (n - len(prop_int[k])))
        propf[k] = np.asarray(col, np.float64)
        propint[k] = np.asarray(prop_int[k], dtype=bool)
    chunk = EventChunk(
        event=ev,
        entity_type=etype,
        entity_id=eid,
        target_entity_type=ttype,
        target_entity_id=tid,
        t_us=np.asarray(t_us, np.int64),
        c_us=np.asarray(c_us, np.int64),
        ids=ids,
        propf=propf,
        propint=propint,
        extra=extra,
    )
    del n_hint
    return ParseOutcome(
        chunk=chunk,
        errors=errors,
        row_lines=row_lines,
        id_supplied=id_supplied,
        received=received,
    )


def parse_chunk_wire(
    raw: bytes,
    base_row: int = 0,
    allowed_events: frozenset | set | None = None,
    max_rows: int = 65536,
) -> ParseOutcome:
    """Parse one line of the COLUMNAR bulk encoding
    (``Content-Type: application/x-pio-chunks``): the line is a whole
    :meth:`EventChunk.to_wire` object — pre-columnarized by the sender —
    so ingest cost is one ``json.loads`` plus vectorized validation per
    *chunk*, not per event. This is the binary-leaning half of the
    NDJSON/binary bulk route: ``pio export``-shaped tooling and SDKs
    that already hold columns skip the per-event text round trip
    entirely.

    Validation is vectorized: required columns non-empty (numpy mask),
    reserved names and the access-key whitelist checked against the
    UNIQUE values only, target pairing per row. Invalid rows are
    dropped with per-ROW error offsets (``line`` = global row ordinal);
    valid rows flow on. String fields are coerced with ``str`` exactly
    like the wire decoder."""
    try:
        obj = json.loads(raw)
        if type(obj) is not dict:
            raise ValueError("chunk line must be a JSON object")
        chunk = EventChunk.from_wire(obj)
    except Exception as e:  # malformed chunk: the whole line is one error
        return ParseOutcome(
            chunk=_empty_chunk(),
            errors=[_err(base_row, f"Malformed chunk: {e}")],
            row_lines=[],
            id_supplied=[],
            received=0,
        )
    n = len(chunk)
    if n > max_rows:
        return ParseOutcome(
            chunk=_empty_chunk(),
            errors=[
                _err(base_row, f"chunk of {n} rows exceeds max {max_rows}")
            ],
            row_lines=[],
            id_supplied=[],
            received=n,
        )
    cols = (
        chunk.entity_type, chunk.entity_id, chunk.target_entity_type,
        chunk.target_entity_id, chunk.ids, chunk.extra,
    )
    if any(len(c) != n for c in cols) or chunk.t_us.shape[0] != n or (
        chunk.c_us.shape[0] != n
    ) or any(
        col.shape[0] != n
        for cc in (chunk.propf, chunk.propint)
        for col in cc.values()
    ) or set(chunk.propf) != set(chunk.propint):
        # the key-set parity check matters: a propf column without its
        # propint twin would KeyError deep in the append and surface as
        # a retryable server storage error for what is a client shape bug
        return ParseOutcome(
            chunk=_empty_chunk(),
            errors=[_err(base_row, "chunk columns have mismatched lengths")],
            row_lines=[],
            id_supplied=[],
            received=n,
        )
    errors: list = []
    ok = np.ones(n, dtype=bool)
    ev_arr = np.asarray(chunk.event, dtype=np.str_)
    et_arr = np.asarray(chunk.entity_type, dtype=np.str_)
    ei_arr = np.asarray(chunk.entity_id, dtype=np.str_)

    def reject(mask: np.ndarray, message_for) -> None:
        for i in np.flatnonzero(mask & ok):
            errors.append(_err(base_row + int(i), message_for(int(i))))
        ok[mask] = False

    # reserved / whitelist checks against the UNIQUE names only
    bad_ev = np.zeros(n, dtype=bool)
    denied = np.zeros(n, dtype=bool)
    for name in np.unique(ev_arr):
        sname = str(name)
        if not sname or (
            sname.startswith(("$", "pio_")) and sname not in RESERVED_EVENTS
        ):
            bad_ev |= ev_arr == name
        elif allowed_events is not None and sname not in allowed_events:
            denied |= ev_arr == name
    reject(
        bad_ev,
        lambda i: (
            "event must not be empty"
            if not chunk.event[i]
            else f"event name '{chunk.event[i]}' is reserved; only "
            f"{sorted(RESERVED_EVENTS)} are allowed to start with '$'"
        ),
    )
    for i in np.flatnonzero(denied & ok):
        errors.append(
            _err(
                base_row + int(i),
                f"Event '{chunk.event[i]}' is not allowed by this accessKey.",
                status=403,
            )
        )
    ok[denied] = False
    bad_et = np.zeros(n, dtype=bool)
    for name in np.unique(et_arr):
        sname = str(name)
        if not sname:
            bad_et |= et_arr == name
        elif sname.startswith("$") or (
            sname.startswith("pio_") and sname not in BUILTIN_ENTITY_TYPES
        ):
            bad_et |= et_arr == name
    reject(
        bad_et,
        lambda i: (
            "entityType must not be empty"
            if not chunk.entity_type[i]
            else f"entityType '{chunk.entity_type[i]}' is reserved"
        ),
    )
    reject(ei_arr == "", lambda i: "entityId must not be empty")
    tt_none = np.fromiter(
        (v is None for v in chunk.target_entity_type), dtype=bool, count=n
    )
    tid_none = np.fromiter(
        (v is None for v in chunk.target_entity_id), dtype=bool, count=n
    )
    reject(
        tt_none != tid_none,
        lambda i: "targetEntityType and targetEntityId must be specified "
        "together",
    )
    special = np.isin(ev_arr, sorted(RESERVED_EVENTS))
    if special.any():
        reject(
            special & ~tt_none,
            lambda i: f"{chunk.event[i]} event must not have a target entity",
        )
        # property-shape rules for the (rare) reserved events
        for i in np.flatnonzero(special & ok):
            has_props = bool(chunk.extra[i]) or any(
                not np.isnan(col[i]) for col in chunk.propf.values()
            )
            if chunk.event[i] == "$unset" and not has_props:
                errors.append(
                    _err(
                        base_row + int(i),
                        "$unset event requires non-empty properties",
                    )
                )
                ok[i] = False
            elif chunk.event[i] == "$delete" and has_props:
                errors.append(
                    _err(
                        base_row + int(i),
                        "$delete event must not have properties",
                    )
                )
                ok[i] = False
    no_id = np.fromiter(
        (not v for v in chunk.ids), dtype=bool, count=n
    )
    supplied = ~no_id
    if no_id.any():
        for i in np.flatnonzero(no_id):
            chunk.ids[int(i)] = new_event_id()
    rows = np.flatnonzero(ok)
    if rows.shape[0] != n:
        pick = rows.tolist()
        chunk = EventChunk(
            event=[chunk.event[i] for i in pick],
            entity_type=[chunk.entity_type[i] for i in pick],
            entity_id=[chunk.entity_id[i] for i in pick],
            target_entity_type=[chunk.target_entity_type[i] for i in pick],
            target_entity_id=[chunk.target_entity_id[i] for i in pick],
            t_us=chunk.t_us[rows],
            c_us=chunk.c_us[rows],
            ids=[chunk.ids[i] for i in pick],
            propf={k: v[rows] for k, v in chunk.propf.items()},
            propint={k: v[rows] for k, v in chunk.propint.items()},
            extra=[chunk.extra[i] for i in pick],
        )
    else:
        pick = list(range(n))
    errors.sort(key=lambda e: e["line"])
    return ParseOutcome(
        chunk=chunk,
        errors=errors,
        row_lines=[base_row + i for i in pick],
        id_supplied=[bool(supplied[i]) for i in pick],
        received=n,
    )


def _empty_chunk() -> EventChunk:
    return EventChunk(
        event=[], entity_type=[], entity_id=[],
        target_entity_type=[], target_entity_id=[],
        t_us=np.zeros(0, np.int64), c_us=np.zeros(0, np.int64),
        ids=[], propf={}, propint={}, extra=[],
    )


def split_lines(buffer: bytes, data: bytes) -> tuple[list[bytes], bytes]:
    """Append ``data`` to the carry ``buffer`` and split off complete
    lines; returns ``(lines, new_carry)``. The carry is whatever trails
    the last newline — the torn-frame boundary a crashing sender leaves."""
    whole = buffer + data
    if b"\n" not in whole:
        return [], whole
    head, _, carry = whole.rpartition(b"\n")
    return head.split(b"\n"), carry


@dataclasses.dataclass
class ChunkResult:
    """Status of one appended chunk — the unit the bulk route streams
    back. Counts are exact; the ``errors`` and ``duplicate_lines``
    offset lists are capped at :data:`MAX_LINE_REPORTS` entries each
    (``errors_truncated`` / ``duplicates_truncated`` carry the
    overflow)."""

    seq: int
    line_start: int
    received: int
    stored: int
    duplicates: int
    invalid: int
    errors: list
    duplicate_lines: list
    errors_truncated: int = 0
    duplicates_truncated: int = 0
    dedup_hits: int = 0  # supplied id answered duplicate
    dedup_misses: int = 0  # supplied id stored fresh
    storage_error: str | None = None
    #: partitioned appends only: partition -> {"failed": N, "message"} for
    #: partitions whose append failed. Their rows also appear as per-line
    #: 500 errors (subject to the MAX_LINE_REPORTS cap); rows on healthy
    #: partitions in the SAME chunk are stored and acked normally.
    partition_errors: dict | None = None

    def to_json(self) -> dict:
        out = {
            "chunk": self.seq,
            "lineStart": self.line_start,
            "received": self.received,
            "stored": self.stored,
            "duplicates": self.duplicates,
            "invalid": self.invalid,
        }
        if self.errors or self.errors_truncated:
            out["errors"] = self.errors
            if self.errors_truncated:
                out["errorsTruncated"] = self.errors_truncated
        if self.duplicate_lines or self.duplicates_truncated:
            out["duplicateLines"] = self.duplicate_lines
            if self.duplicates_truncated:
                out["duplicateLinesTruncated"] = self.duplicates_truncated
        if self.storage_error is not None:
            out["storageError"] = self.storage_error
        if self.partition_errors:
            out["partitionErrors"] = {
                str(p): dict(v) for p, v in sorted(self.partition_errors.items())
            }
        return out


class PipelineError(RuntimeError):
    """A pipeline stage died; the stream cannot continue."""


_STOP = object()


@dataclasses.dataclass
class _SeqState:
    """Merge state for one chunk split across partition appenders."""

    base_line: int
    outcome: ParseOutcome
    remaining: int
    stored: int = 0
    duplicates: int = 0
    dedup_hits: int = 0
    dedup_misses: int = 0
    dup_lines: list = dataclasses.field(default_factory=list)
    storage_lines: list = dataclasses.field(default_factory=list)
    partition_errors: dict = dataclasses.field(default_factory=dict)


class IngestPipeline:
    """Bounded-queue parse→validate→append pipeline over one stream.

    The calling thread owns stage 0 (socket/file reads + response
    streaming); a parser thread owns parse/validate; ONE appender thread
    owns the store's append path — so exactly one thread ever drives the
    segment file per request, and reads, parsing, and fsync'd appends
    overlap. ``feed`` applies backpressure (bounded ``parse``/``append``
    queues) back to the byte source; results are drained with ``poll``
    and stream back strictly in chunk order (single FIFO per stage).

    The sink is any ``LEvents`` — ``ingest_chunk`` lands vectorized on
    the columnar driver, decodes through the base default elsewhere. A
    storage failure fails the CHUNK (its rows report a 500-style
    ``storageError``, matching the batch route's per-slot convention),
    never the stream.

    **Partitioned sinks** (``events.partition_count > 1``): the single
    appender is replaced by a router thread plus one appender thread per
    partition, each feeding its own store through a bounded queue — the
    appends run concurrently and a slow or dead partition never blocks
    the others. Results still stream back strictly in chunk order (an
    out-of-order completion buffer re-serializes them), and a failed
    partition fails only ITS rows: per-line 500 errors naming the
    partition (plus a ``partitionErrors`` summary), while the same
    chunk's rows on healthy partitions store and ack normally.
    """

    def __init__(
        self,
        events: Any,
        app_id: int,
        channel_id: int | None = None,
        *,
        chunk_rows: int = 4096,
        queue_depth: int = 4,
        allowed_events: frozenset | set | None = None,
        on_chunk: Callable[[ChunkResult], None] | None = None,
        wire: str = "ndjson",
    ):
        if wire not in ("ndjson", "chunks"):
            raise ValueError(f"unknown wire format {wire!r}")
        self._events = events
        self._app_id = app_id
        self._channel_id = channel_id
        self._wire = wire
        self._chunk_rows = max(1, int(chunk_rows))
        self._allowed = frozenset(allowed_events) if allowed_events else None
        self._on_chunk = on_chunk
        self._parse_q: "queue.Queue" = queue.Queue(maxsize=max(1, queue_depth))
        self._append_q: "queue.Queue" = queue.Queue(maxsize=max(1, queue_depth))
        self._result_q: "queue.Queue" = queue.Queue()  # drained by the caller
        self._carry = b""
        self._pending: list[bytes] = []
        self._pending_lines = 0
        self._next_line = 0
        self._seq = 0
        self._failure: BaseException | None = None
        self._closed = False
        # totals (owned by the caller thread via poll/finish)
        self.received = 0
        self.stored = 0
        self.duplicates = 0
        self.invalid = 0
        self.chunks = 0
        self._parser = threading.Thread(
            target=self._parse_loop, name="pio-ingest-parse", daemon=True
        )
        self._parser.start()
        self._partitions = int(getattr(events, "partition_count", 1) or 1)
        if self._partitions > 1:
            # router + per-partition appenders (see class docstring)
            depth = max(1, queue_depth)
            self._part_qs: list["queue.Queue"] = [
                queue.Queue(maxsize=depth) for _ in range(self._partitions)
            ]
            self._merge_lock = threading.Lock()
            self._inflight: dict[int, _SeqState] = {}
            self._emit_buf: dict[int, ChunkResult] = {}
            self._emit_next = 0
            self._parts_live = self._partitions
            self._appender = threading.Thread(
                target=self._router_loop, name="pio-ingest-route", daemon=True
            )
            self._part_workers = [
                threading.Thread(
                    target=self._part_loop,
                    args=(p,),
                    name=f"pio-ingest-append-p{p}",
                    daemon=True,
                )
                for p in range(self._partitions)
            ]
            for t in self._part_workers:
                t.start()
        else:
            self._appender = threading.Thread(
                target=self._append_loop, name="pio-ingest-append", daemon=True
            )
        self._appender.start()

    # ------------------------------------------------------------ stages
    def _parse_loop(self) -> None:
        try:
            row_base = 0  # chunks wire: rows are numbered here, in order
            while True:
                item = self._parse_q.get()
                if item is _STOP:
                    self._append_q.put(_STOP)
                    return
                seq, base_line, lines = item
                if self._wire == "chunks":
                    outcome = parse_chunk_wire(
                        lines[0], row_base, allowed_events=self._allowed
                    )
                    base_line = row_base
                    row_base += outcome.received
                else:
                    outcome = parse_chunk(
                        lines, base_line, allowed_events=self._allowed
                    )
                self._append_q.put((seq, base_line, outcome))
        except BaseException as e:  # surfaced to the caller via feed/finish
            self._failure = e  # piolint: waive=PIO201 -- single atomic write; readers only test non-None
            self._append_q.put(_STOP)

    def _append_loop(self) -> None:
        try:
            while True:
                item = self._append_q.get()
                if item is _STOP:
                    self._result_q.put(_STOP)
                    return
                seq, base_line, outcome = item
                self._result_q.put(self._append_one(seq, base_line, outcome))
        except BaseException as e:
            self._failure = e  # piolint: waive=PIO201 -- single atomic write; readers only test non-None
            self._result_q.put(_STOP)

    def _append_one(
        self, seq: int, base_line: int, outcome: ParseOutcome
    ) -> ChunkResult:
        chunk = outcome.chunk
        errors = outcome.errors
        dup_lines: list = []
        stored = 0
        duplicates = 0
        hits = 0
        misses = 0
        storage_error = None
        if len(chunk):
            try:
                results = self._events.ingest_chunk(
                    chunk, self._app_id, self._channel_id
                )
            except Exception:
                # chunk-scoped failure: rows were not stored; report the
                # batch route's generic message (exception text can embed
                # backend paths/DSNs — details go to the log)
                logger.exception("bulk chunk append failed")
                storage_error = "Storage error: chunk was not stored."
            else:
                for i, (_, dup) in enumerate(results):
                    if dup:
                        duplicates += 1
                        dup_lines.append(outcome.row_lines[i])
                        if outcome.id_supplied[i]:
                            hits += 1
                    else:
                        stored += 1
                        if outcome.id_supplied[i]:
                            misses += 1
        result = ChunkResult(
            seq=seq,
            line_start=base_line,
            received=outcome.received,
            stored=stored,
            duplicates=duplicates,
            invalid=len(errors),
            errors=errors[:MAX_LINE_REPORTS],
            duplicate_lines=dup_lines[:MAX_LINE_REPORTS],
            errors_truncated=max(0, len(errors) - MAX_LINE_REPORTS),
            duplicates_truncated=max(0, len(dup_lines) - MAX_LINE_REPORTS),
            dedup_hits=hits,
            dedup_misses=misses,
            storage_error=storage_error,
        )
        if self._on_chunk is not None:
            try:
                self._on_chunk(result)
            except Exception:
                logger.exception("bulk on_chunk hook failed")
        return result

    # ------------------------------------------------- partitioned appends
    def _part_put(self, p: int, item) -> None:
        while True:
            try:
                self._part_qs[p].put(item, timeout=1.0)
                return
            except queue.Full:
                if self._failure is not None:
                    raise PipelineError(
                        f"ingest pipeline stage died: {self._failure!r}"
                    ) from self._failure

    def _router_loop(self) -> None:
        """Split each parsed chunk by entity hash and fan the row groups
        out to the per-partition appender queues. Serial and cheap (one
        crc32 pass per chunk) — the appends themselves are what
        parallelize."""
        try:
            while True:
                item = self._append_q.get()
                if item is _STOP:
                    for q_ in self._part_qs:
                        q_.put(_STOP)
                    return
                seq, base_line, outcome = item
                chunk = outcome.chunk
                groups: dict[int, list] = {}
                if len(chunk):
                    parts = self._events.partition_rows(chunk)
                    for p in np.unique(parts).tolist():
                        groups[int(p)] = np.nonzero(parts == p)[0].tolist()
                state = _SeqState(
                    base_line=base_line, outcome=outcome,
                    remaining=len(groups),
                )
                with self._merge_lock:
                    self._inflight[seq] = state
                if not groups:
                    self._finalize_seq(seq)
                    continue
                for p, rows in sorted(groups.items()):
                    self._part_put(p, (seq, rows))
        except BaseException as e:
            self._failure = e  # piolint: waive=PIO201 -- single atomic write; readers only test non-None
            for q_ in self._part_qs:
                try:
                    q_.put_nowait(_STOP)
                except queue.Full:
                    pass
            self._result_q.put(_STOP)

    def _part_loop(self, p: int) -> None:
        """Partition ``p``'s appender: exactly one thread ever drives
        partition ``p``'s store, so per-partition append order (and the
        columnar tail's single-writer assumption) is preserved while P
        appenders run concurrently."""
        try:
            while True:
                item = self._part_qs[p].get()
                if item is _STOP:
                    with self._merge_lock:
                        self._parts_live -= 1
                        last = self._parts_live == 0
                    if last:
                        self._result_q.put(_STOP)
                    return
                seq, rows = item
                with self._merge_lock:
                    state = self._inflight[seq]
                sub = state.outcome.chunk.take(rows)
                error = None
                try:
                    results = self._events.ingest_chunk_partition(
                        sub, self._app_id, self._channel_id, p
                    )
                except Exception as e:
                    # partition-scoped failure: ONLY this partition's rows
                    # fail (per-line 500s naming the partition); the rest
                    # of the chunk proceeds on the other appenders
                    logger.exception("partition %d chunk append failed", p)
                    error = f"Storage error: partition {p}: rows were not stored."
                    results = None
                with self._merge_lock:
                    if results is None:
                        state.partition_errors[p] = {
                            "failed": len(rows), "message": error,
                        }
                        state.storage_lines.extend(
                            _err(state.outcome.row_lines[i], error, status=500)
                            for i in rows
                        )
                    else:
                        for i, (_, dup) in zip(rows, results):
                            if dup:
                                state.duplicates += 1
                                state.dup_lines.append(
                                    state.outcome.row_lines[i]
                                )
                                if state.outcome.id_supplied[i]:
                                    state.dedup_hits += 1
                            else:
                                state.stored += 1
                                if state.outcome.id_supplied[i]:
                                    state.dedup_misses += 1
                    state.remaining -= 1
                    done = state.remaining == 0
                if done:
                    self._finalize_seq(seq)
        except BaseException as e:
            self._failure = e  # piolint: waive=PIO201 -- single atomic write; readers only test non-None
            self._result_q.put(_STOP)

    def _finalize_seq(self, seq: int) -> None:
        """Assemble the merged ChunkResult and emit it — plus any
        buffered successors — strictly in sequence order."""
        with self._merge_lock:
            state = self._inflight.pop(seq)
        outcome = state.outcome
        errors = outcome.errors
        if state.storage_lines:
            errors = sorted(
                errors + state.storage_lines, key=lambda e: e["line"]
            )
        state.dup_lines.sort()
        result = ChunkResult(
            seq=seq,
            line_start=state.base_line,
            received=outcome.received,
            stored=state.stored,
            duplicates=state.duplicates,
            invalid=len(outcome.errors),
            errors=errors[:MAX_LINE_REPORTS],
            duplicate_lines=state.dup_lines[:MAX_LINE_REPORTS],
            errors_truncated=max(0, len(errors) - MAX_LINE_REPORTS),
            duplicates_truncated=max(
                0, len(state.dup_lines) - MAX_LINE_REPORTS
            ),
            dedup_hits=state.dedup_hits,
            dedup_misses=state.dedup_misses,
            partition_errors=state.partition_errors or None,
        )
        if self._on_chunk is not None:
            try:
                self._on_chunk(result)
            except Exception:
                logger.exception("bulk on_chunk hook failed")
        with self._merge_lock:
            self._emit_buf[seq] = result
            while self._emit_next in self._emit_buf:
                self._result_q.put(self._emit_buf.pop(self._emit_next))
                self._emit_next += 1

    # ----------------------------------------------------------- caller API
    def _check_failure(self) -> None:
        if self._failure is not None:
            raise PipelineError(
                f"ingest pipeline stage died: {self._failure!r}"
            ) from self._failure

    # the _pending/_carry/_seq/_next_line/_closed writes below are all
    # caller-thread-only stage-0 state; _merge_lock exists solely for the
    # cross-thread merge buffers (_inflight/_emit_buf/_emit_next/_parts_live)
    def _submit_pending(self) -> None:
        lines, self._pending = self._pending, []  # piolint: waive=PIO201 -- caller-thread stage-0 state
        n = self._pending_lines
        self._pending_lines = 0  # piolint: waive=PIO201 -- caller-thread stage-0 state
        item = (self._seq, self._next_line, lines)
        while True:
            # bounded put with a liveness check: if a stage died, raise
            # instead of blocking the socket-reader thread forever
            try:
                self._parse_q.put(item, timeout=1.0)
                break
            except queue.Full:
                self._check_failure()
        self._seq += 1  # piolint: waive=PIO201 -- caller-thread stage-0 state
        self._next_line += n  # piolint: waive=PIO201 -- caller-thread stage-0 state

    def feed(self, data: bytes) -> None:
        """Stage 0: push raw bytes; complete chunks flow downstream.
        Blocks (bounded queues) when parse/append lag — that is the
        backpressure that keeps a 100 MB payload from materializing."""
        self._check_failure()
        if self._closed:
            raise PipelineError("pipeline already finished")
        lines, self._carry = split_lines(self._carry, data)  # piolint: waive=PIO201 -- caller-thread stage-0 state
        if not lines:
            return
        if self._wire == "chunks":
            # each line IS a whole pre-columnarized chunk
            for line in lines:
                if line.strip():
                    self._pending.append(line)
                    self._pending_lines += 1  # piolint: waive=PIO201 -- caller-thread stage-0 state
                    self._submit_pending()
            return
        self._pending.extend(lines)
        self._pending_lines += len(lines)  # piolint: waive=PIO201 -- caller-thread stage-0 state
        while self._pending_lines >= self._chunk_rows:
            rest = self._pending[self._chunk_rows:]
            self._pending = self._pending[: self._chunk_rows]  # piolint: waive=PIO201 -- caller-thread stage-0 state
            self._pending_lines = self._chunk_rows  # piolint: waive=PIO201 -- caller-thread stage-0 state
            self._submit_pending()
            self._pending = rest  # piolint: waive=PIO201 -- caller-thread stage-0 state
            self._pending_lines = len(rest)  # piolint: waive=PIO201 -- caller-thread stage-0 state

    def poll(self) -> list[ChunkResult]:
        """Drain whatever chunk results are ready (non-blocking, in
        order). The caller interleaves this with ``feed`` so statuses
        stream while the payload is still arriving."""
        out: list[ChunkResult] = []
        while True:
            try:
                item = self._result_q.get_nowait()
            except queue.Empty:
                return out
            if item is _STOP:
                self._result_q.put(_STOP)  # keep finish() terminating
                self._check_failure()
                return out
            self._account(item)
            out.append(item)

    def _account(self, r: ChunkResult) -> None:
        self.received += r.received
        self.stored += r.stored
        self.duplicates += r.duplicates
        self.invalid += r.invalid
        self.chunks += 1

    def finish(self, timeout_s: float = 300.0) -> Iterator[ChunkResult]:
        """Flush the trailing partial chunk (a final unterminated line
        counts as a line — senders that omit the last newline still
        ingest), close the stages, and yield the remaining results in
        order. After this, ``summary()`` totals are final."""
        if not self._closed:
            self._closed = True  # piolint: waive=PIO201 -- caller-thread stage-0 state
            if self._carry.strip():
                self._pending.append(self._carry)
                self._pending_lines += 1  # piolint: waive=PIO201 -- caller-thread stage-0 state
            self._carry = b""  # piolint: waive=PIO201 -- caller-thread stage-0 state
            if self._pending:
                self._submit_pending()
            self._parse_q.put(_STOP)
        while True:
            try:
                item = self._result_q.get(timeout=timeout_s)
            except queue.Empty:
                raise PipelineError(
                    f"ingest pipeline stalled past {timeout_s:g}s"
                ) from None
            if item is _STOP:
                self._check_failure()
                return
            self._account(item)
            yield item

    def close(self) -> None:
        """Abandon the stream (error paths): unblock and stop the stage
        threads without waiting for orderly completion."""
        self._closed = True  # piolint: waive=PIO201 -- caller-thread stage-0 state
        self._failure = self._failure or PipelineError(  # piolint: waive=PIO201 -- single atomic write; readers only test non-None
            "pipeline closed"
        )
        queues = [self._parse_q, self._append_q]
        if self._partitions > 1:
            queues.extend(self._part_qs)
        for q in queues:
            try:
                q.put_nowait(_STOP)
            except queue.Full:
                try:  # make room, then re-signal
                    q.get_nowait()
                    q.put_nowait(_STOP)
                except (queue.Empty, queue.Full):
                    pass

    def summary(self) -> dict:
        return {
            "received": self.received,
            "stored": self.stored,
            "duplicates": self.duplicates,
            "invalid": self.invalid,
            "chunks": self.chunks,
        }
