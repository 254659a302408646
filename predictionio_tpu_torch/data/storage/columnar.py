"""Columnar event-data driver (``TYPE=columnar``) — bulk training reads at
array speed.

Role parity: the reference's default event store is HBase
(``data/storage/hbase/HBEvents.scala`` + ``HBPEvents.scala``) — a
write-optimized row store whose value is the *bulk scan locality* that
feeds training (``HBPEvents.find`` → ``TableInputFormat`` →
``RDD[Event]``). One host has no Spark executors to hide a per-record
object stream behind; what training wants is dense host arrays. This
driver therefore stores events in the layout training reads:

* **Columnar segments** (``seg-*.npz``): immutable batches with
  dictionary-encoded ids (int32 codes + sorted string vocab — Parquet-style
  dictionary encoding), microsecond int64 timestamps, one float64 column
  per numeric property, and a JSON residue column for everything else
  (non-numeric properties, tags, prId). Written by the bulk paths
  (``PEvents.write`` / :meth:`write_columns`, i.e. ``pio import`` and the
  sharded ingest writer).
* **A JSON-lines tail** (``tail.jsonl``): the single-event write path of
  the event server appends here — durable and immediately visible. The
  LSM-ish split means live ingest never rewrites segments.
* **Tombstones** (``tombstones.txt``): deletes of individual events append
  an id; scans filter them. Bulk deletes drop the whole stream directory.

``find_columns`` (the SPI of ``base.PEvents``) concatenates segment
columns and merges their vocabularies with pure numpy — no per-event
Python — which is what makes the full product path (event store →
template → ALS) run at device speed instead of interpreter speed.
``find``/``get`` remain fully supported (the storage contract suite runs
against this driver) but materialize decoded events; serving-time
point lookups belong on the sqlite driver.

Layout: ``<path>/<prefix>_app_<appId>/<default|ch<N>>/``.

Counterpart of ``predictionio_tpu/data/storage/columnar.py``: the same
code and the same on-disk format byte for byte, so a store written by
either package is read by the other, partitioned and replicated layouts
included.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import os
import shutil
import threading
import time
import uuid
import zlib
from typing import Any, Iterable, Iterator, Sequence

import numpy as np

from predictionio_tpu_torch.data.columns import (
    EventChunk,
    EventColumns,
    columns_from_events,
    encode_strings,
)
from predictionio_tpu_torch.data.event import (
    DataMap,
    Event,
    event_from_json,
    event_to_json,
    new_event_id,
)
from predictionio_tpu_torch.data.storage.base import (
    BaseStorageClient,
    LEvents,
    PEvents,
    StorageClientConfig,
    StorageError,
)

__all__ = ["StorageClient"]

_UTC = _dt.timezone.utc
#: rows per segment file. Sized like an HBase region: big enough that the
#: per-file overhead (open + CRC + concat copy) vanishes against the
#: column payload, small enough that one segment's working set stays a
#: few hundred MB. SEGMENT_ROWS in the source config overrides.
_DEFAULT_SEGMENT_ROWS = 4_000_000


def _to_us(t: _dt.datetime) -> int:
    if t.tzinfo is None:
        t = t.replace(tzinfo=_UTC)
    return int(t.timestamp() * 1e6)


def _from_us(us: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(us / 1e6, tz=_UTC)


def _merge_vocabs(
    parts: list[tuple[np.ndarray, np.ndarray]], allow_missing: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """[(codes, vocab), ...] -> (global codes concat, merged sorted vocab).
    ``allow_missing`` keeps -1 codes (no-target rows) as -1."""
    vocabs = [v for _, v in parts if v.size]
    if not vocabs:
        return (
            np.concatenate([c for c, _ in parts])
            if parts
            else np.zeros(0, np.int32),
            np.zeros(0, dtype="<U1"),
        )
    # bulk ingest writes many segments sharing one vocabulary — when every
    # non-empty part agrees, codes are already global: skip the string
    # unique AND the per-part remap gathers (the expensive ops here)
    if all(
        v is vocabs[0] or np.array_equal(v, vocabs[0]) for v in vocabs[1:]
    ) and all(v.size for _, v in parts):
        if len(parts) == 1:
            return parts[0][0], vocabs[0]
        return np.concatenate([c for c, _ in parts]), vocabs[0]
    merged = np.unique(np.concatenate(vocabs))
    out = []
    for codes, vocab in parts:
        if vocab.size == 0:
            out.append(codes)
            continue
        remap = np.searchsorted(merged, vocab).astype(np.int32)
        if allow_missing:
            g = np.full_like(codes, -1)
            ok = codes >= 0
            g[ok] = remap[codes[ok]]
            out.append(g)
        else:
            out.append(remap[codes])
    return np.concatenate(out) if out else np.zeros(0, np.int32), merged


@dataclasses.dataclass
class _Segment:
    """Loaded segment columns (decoded lazily from one ``seg-*.npz``)."""

    name: str
    ev_code: np.ndarray
    ev_vocab: np.ndarray
    etype_code: np.ndarray
    etype_vocab: np.ndarray
    eid_code: np.ndarray
    eid_vocab: np.ndarray
    ttype_code: np.ndarray  # -1 = none
    ttype_vocab: np.ndarray
    tid_code: np.ndarray  # -1 = none
    tid_vocab: np.ndarray
    t_us: np.ndarray
    c_us: np.ndarray
    propf: dict[str, np.ndarray]  # float64, NaN = absent
    propint: dict[str, np.ndarray]  # bool: value was an int
    extra: np.ndarray | None  # unicode JSON residue, "" = none
    #: explicit per-row event ids (compacted-tail and bulk-chunk
    #: segments); None = positional "<segment>@<row>" ids
    ids: np.ndarray | None = None
    #: True = written by the bulk-chunk append path. The tail follower's
    #: compaction re-anchor must never treat a bulk segment as part of
    #: the consumed TAIL prefix — its rows were never tail lines.
    #: (Explicit-id segments without the flag are compacted tails, which
    #: keeps pre-flag stores reading exactly as before.)
    bulk: bool = False

    def __len__(self) -> int:
        return int(self.ev_code.shape[0])

    def row_event(self, row: int) -> Event:
        props: dict[str, Any] = {}
        for k, col in self.propf.items():
            v = col[row]
            if not np.isnan(v):
                props[k] = (
                    int(v) if self.propint[k][row] else float(v)
                )
        tags: tuple[str, ...] = ()
        pr_id = None
        if self.extra is not None and self.extra[row]:
            residue = json.loads(str(self.extra[row]))
            props.update(residue.get("p", {}))
            tags = tuple(residue.get("tags", ()))
            pr_id = residue.get("prId")
        t_code = int(self.tid_code[row])
        return Event(
            event=str(self.ev_vocab[self.ev_code[row]]),
            entity_type=str(self.etype_vocab[self.etype_code[row]]),
            entity_id=str(self.eid_vocab[self.eid_code[row]]),
            target_entity_type=(
                str(self.ttype_vocab[self.ttype_code[row]])
                if self.ttype_code[row] >= 0
                else None
            ),
            target_entity_id=str(self.tid_vocab[t_code]) if t_code >= 0 else None,
            properties=DataMap(props),
            event_time=_from_us(int(self.t_us[row])),
            event_id=(
                str(self.ids[row]) if self.ids is not None
                else f"{self.name}@{row}"
            ),
            tags=tags,
            pr_id=pr_id,
            creation_time=_from_us(int(self.c_us[row])),
        )


def _load_segment(path: str) -> _Segment:
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    propf = {}
    propint = {}
    for k in list(data):
        if k.startswith("propf_"):
            propf[k[len("propf_"):]] = data[k]
        elif k.startswith("propint_"):
            propint[k[len("propint_"):]] = data[k]
    return _Segment(
        name=os.path.splitext(os.path.basename(path))[0],
        ev_code=data["ev_code"],
        ev_vocab=data["ev_vocab"],
        etype_code=data["etype_code"],
        etype_vocab=data["etype_vocab"],
        eid_code=data["eid_code"],
        eid_vocab=data["eid_vocab"],
        ttype_code=data["ttype_code"],
        ttype_vocab=data["ttype_vocab"],
        tid_code=data["tid_code"],
        tid_vocab=data["tid_vocab"],
        t_us=data["t_us"],
        c_us=data["c_us"],
        propf=propf,
        propint=propint,
        extra=data.get("extra"),
        ids=data.get("ids"),
        bulk=bool(data["bulk"]) if "bulk" in data else False,
    )


class _ColumnarEvents(LEvents):
    """LEvents over the segment + tail + tombstone layout (plus the shared
    machinery :class:`_ColumnarPEvents` delegates to)."""

    #: decoded segments kept hot (LRU): bounds resident memory at
    #: ~cache_size·segment_rows rows instead of pinning the whole store
    _CACHE_SEGMENTS = 8

    #: recent client-supplied event ids remembered per stream for O(1)
    #: duplicate detection (ids beyond the window fall back to the exact
    #: per-segment/tail lookup). Durability is free: the tail itself is
    #: the record — after a restart the window re-warms from it.
    _DEDUP_WINDOW = 100_000

    #: byte budget of the startup dedup warm (tail suffix + explicit-id
    #: segment ids). A huge uncompacted tail used to be read WHOLE on
    #: first insert; now the warm seeks to the last ``warm_bytes`` of it
    #: (byte-offset cursor style) and stops folding segment ids in once
    #: the budget is spent — completeness is given up instead of open
    #: latency. DEDUP_WARM_BYTES in the source config overrides.
    _DEDUP_WARM_BYTES = 64 * 1024 * 1024

    def __init__(self, base: str, segment_rows: int, fsync: bool,
                 cache_segments: int | None = None,
                 dedup_window: int | None = None,
                 dedup_warm_bytes: int | None = None):
        self._base = base
        self._segment_rows = segment_rows
        self._fsync = fsync
        self._lock = threading.RLock()
        from collections import OrderedDict

        self._seg_cache: "OrderedDict[str, _Segment]" = OrderedDict()
        #: stream dir -> LRU of recently seen event ids (insert_dedup)
        self._recent_ids: dict[str, "OrderedDict[str, None]"] = {}
        #: stream dir -> does the LRU provably hold EVERY client-visible
        #: id in the stream (live tail lines AND explicit-id segment
        #: rows)? Warmed under the byte budget and never evicted since.
        #: While True, a dedup miss proves the id fresh without touching
        #: the store (positional ``seg@row`` ids keep their routed
        #: lookup) — the invariant the bulk route's throughput rests on.
        self._recent_complete: dict[str, bool] = {}
        #: stream dir -> milliseconds the startup dedup warm took
        self._warm_ms: dict[str, float] = {}
        self._dedup_window = (
            self._DEDUP_WINDOW if dedup_window is None else max(1, dedup_window)
        )
        self._dedup_warm_bytes = (
            self._DEDUP_WARM_BYTES
            if dedup_warm_bytes is None
            else max(4096, dedup_warm_bytes)
        )
        #: per-path point-lookup indexes: None = positional segment
        #: (cached indefinitely — a few bytes), (sorted ids, argsort
        #: rows) = explicit-id segment (LRU-bounded; a huge segment's
        #: index is tens of MB). Segments are immutable, so entries never
        #: go stale; remove() drops them with the stream.
        self._ids_cache: "OrderedDict[str, tuple[np.ndarray, np.ndarray] | None]" = (
            OrderedDict()
        )
        self._cache_segments = (
            self._CACHE_SEGMENTS if cache_segments is None else cache_segments
        )
        self._seg_seq = 0

    # ---------------------------------------------------------- paths
    def _stream_dir(self, app_id: int, channel_id: int | None) -> str:
        ch = "default" if channel_id is None else f"ch{channel_id}"
        return os.path.join(self._base, f"app_{app_id}", ch)

    def _stream_dirs(self) -> Iterator[tuple[int, int | None, str]]:
        """Every stream on disk as ``(app_id, channel_id, dir)`` — the
        ONE place that parses the ``app_<id>/<default|ch<N>>`` layout
        back out (recovery sweep + compaction scheduler both walk it)."""
        if not os.path.isdir(self._base):
            return
        for app in sorted(os.listdir(self._base)):
            app_dir = os.path.join(self._base, app)
            if not (app.startswith("app_") and os.path.isdir(app_dir)):
                continue
            try:
                app_id = int(app[len("app_"):])
            except ValueError:
                continue
            for ch in sorted(os.listdir(app_dir)):
                d = os.path.join(app_dir, ch)
                if not os.path.isdir(d):
                    continue
                if ch == "default":
                    channel_id: int | None = None
                elif ch.startswith("ch"):
                    try:
                        channel_id = int(ch[2:])
                    except ValueError:
                        continue
                else:
                    continue
                yield app_id, channel_id, d

    def _ensure_stream(self, app_id: int, channel_id: int | None) -> str:
        d = self._stream_dir(app_id, channel_id)
        os.makedirs(d, exist_ok=True)
        sid = os.path.join(d, "stream_id")
        # identity marker: lets incremental readers detect that a stream
        # was dropped and recreated (their cache must not count the new
        # tail as already-consumed). Written atomically, and an empty
        # file (crash mid-write) is repaired rather than left disabling
        # incremental reads forever.
        if not os.path.exists(sid) or os.path.getsize(sid) == 0:
            tmp = sid + ".tmp"
            with open(tmp, "w") as f:
                f.write(uuid.uuid4().hex)
            os.replace(tmp, sid)
        return d

    def _stream_id(self, d: str) -> str:
        try:
            with open(os.path.join(d, "stream_id")) as f:
                return f.read().strip()
        except FileNotFoundError:
            return ""

    def _segment_paths(self, d: str) -> list[str]:
        if not os.path.isdir(d):
            return []
        return sorted(
            os.path.join(d, f)
            for f in os.listdir(d)
            if f.startswith("seg-") and f.endswith(".npz")
        )

    def _segment(self, path: str) -> _Segment:
        with self._lock:
            seg = self._seg_cache.get(path)
            if seg is None:
                seg = _load_segment(path)
                self._seg_cache[path] = seg
                while len(self._seg_cache) > max(self._cache_segments, 0):
                    self._seg_cache.popitem(last=False)
            else:
                self._seg_cache.move_to_end(path)
            return seg

    def _compactions(self, d: str) -> int:
        try:
            with open(os.path.join(d, "compactions")) as f:
                return int(f.read().strip() or 0)
        except (FileNotFoundError, ValueError):
            return 0

    def _recover(self, d: str) -> None:
        """Finish (or discard) an interrupted compaction. Called under
        the store lock before any read/write touches the stream.

        Protocol: compact() stages new segments as ``*.pending``, then
        atomically writes ``compact.commit`` (the commit point) listing
        them, then renames them visible, truncates the tail, rewrites
        tombstones, bumps the generation, and removes the marker. A
        crash BEFORE the marker leaves only stray ``.pending`` files
        (deleted here); a crash AFTER it is replayed here idempotently —
        either way scans never see tail events twice or lose them."""
        marker = os.path.join(d, "compact.commit")
        if not os.path.exists(marker):  # fast path: nothing to recover
            return
        with open(marker) as f:
            pending = json.load(f)["pending"]
        for name in pending:
            src = os.path.join(d, name + ".pending")
            if os.path.exists(src):
                os.replace(src, os.path.join(d, name))
        self._finish_compact(d)

    def _finish_compact(self, d: str) -> None:
        """Post-commit tail truncation + tombstone GC + generation bump
        (shared by compact() and crash recovery; idempotent)."""
        tail_path = os.path.join(d, "tail.jsonl")
        tmp = tail_path + ".tmp"
        with open(tmp, "w") as f:
            if self._fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, tail_path)
        tomb = self._tombstones(d)
        keep = sorted(t for t in tomb if not t.startswith("t:"))
        tmp = os.path.join(d, "tombstones.txt.tmp")
        with open(tmp, "w") as f:
            f.write("".join(t + "\n" for t in keep))
            if self._fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, os.path.join(d, "tombstones.txt"))
        gen = self._compactions(d) + 1
        tmp = os.path.join(d, "compactions.tmp")
        with open(tmp, "w") as f:
            f.write(str(gen))
            if self._fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, os.path.join(d, "compactions"))
        try:
            os.remove(os.path.join(d, "compact.commit"))
        except FileNotFoundError:
            pass

    # -------------------------------------------------- startup recovery
    def _quarantine_file(self, d: str, path: str, report: dict) -> None:
        """Move a suspect file into the stream's ``quarantine/`` dir —
        never delete: a crash normally explains an orphan, but if a bug
        produced it the bytes are still recoverable by an operator."""
        qdir = os.path.join(d, "quarantine")
        os.makedirs(qdir, exist_ok=True)
        dest = os.path.join(
            qdir, f"{os.path.basename(path)}.{uuid.uuid4().hex[:8]}"
        )
        os.replace(path, dest)
        report["quarantined"].append(dest)

    def _repair_tail(self, d: str, report: dict) -> None:
        """Trim torn tail lines (a crash mid-append leaves a partial last
        line that would poison every subsequent scan). Torn bytes are
        quarantined, valid lines kept; a torn line was by definition
        never acknowledged to a client, so trimming it loses nothing
        that was promised durable."""
        tail = os.path.join(d, "tail.jsonl")
        try:
            with open(tail, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return
        good: list[bytes] = []
        bad: list[bytes] = []
        for line in raw.split(b"\n"):
            if not line.strip():
                continue
            try:
                json.loads(line)
            except (json.JSONDecodeError, UnicodeDecodeError):
                bad.append(line)
            else:
                good.append(line)
        if not bad:
            return
        qdir = os.path.join(d, "quarantine")
        os.makedirs(qdir, exist_ok=True)
        dest = os.path.join(qdir, f"tail.torn.{uuid.uuid4().hex[:8]}.jsonl")
        with open(dest, "wb") as f:
            f.write(b"\n".join(bad) + b"\n")
        tmp = tail + ".repair"
        with open(tmp, "wb") as f:
            f.write(b"".join(ln + b"\n" for ln in good))
            if self._fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, tail)
        report["quarantined"].append(dest)
        report["tornTailLines"] += len(bad)

    def sweep_recovery(self) -> dict:
        """Scan every stream directory on open: replay committed
        compactions, quarantine orphan temp/staging files and torn
        commit markers, and trim torn tail lines. Returns the summary
        the driver reports via ``recovery_report()``."""
        report: dict = {
            "streams": 0,
            "quarantined": [],
            "replayedCommits": 0,
            "tornTailLines": 0,
            "dedupWarmMs": 0.0,
            "dedupWarmedStreams": 0,
        }
        if not os.path.isdir(self._base):
            return report
        stream_dirs = [d for _, _, d in self._stream_dirs()]
        with self._lock:
            for d in stream_dirs:
                report["streams"] += 1
                marker = os.path.join(d, "compact.commit")
                if os.path.exists(marker):
                    try:
                        with open(marker) as f:
                            json.load(f)["pending"]
                    except Exception:
                        # torn marker: the compaction never committed —
                        # quarantine it so _recover can't trip on it; the
                        # staged .pending files become orphans below and
                        # the (still intact) tail remains authoritative
                        self._quarantine_file(d, marker, report)
                    else:
                        self._recover(d)
                        report["replayedCommits"] += 1
                for name in sorted(os.listdir(d)):
                    if name.endswith((".tmp", ".pending", ".pending.tmp",
                                      ".repair")):
                        self._quarantine_file(
                            d, os.path.join(d, name), report
                        )
                self._repair_tail(d, report)
                # eager, byte-bounded dedup warm: pay the (measured)
                # cost at open instead of on the first POST's latency
                self._recent_ids_for(d)
            warm = self.dedup_warm_stats()
            report["dedupWarmMs"] = warm["dedupWarmMs"]
            report["dedupWarmedStreams"] = warm["dedupWarmedStreams"]
        return report

    def _tombstones(self, d: str) -> set[str]:
        try:
            with open(os.path.join(d, "tombstones.txt")) as f:
                return {line.strip() for line in f if line.strip()}
        except FileNotFoundError:
            return set()

    @staticmethod
    def _split_tombstones(
        tomb: set[str],
    ) -> tuple[set[str], dict[str, set[int]]]:
        """Tombstone entries -> (dead tail ids, dead segment rows).
        ``t:``-prefixed entries name tail events precisely (a tail id may
        itself look like ``seg@row``); unprefixed entries are segment rows
        — plus, for stores written before the prefix existed, possibly
        tail ids, so they count against both."""
        tail_ids: set[str] = set()
        seg_rows: dict[str, set[int]] = {}
        for t in tomb:
            if t.startswith("t:"):
                tail_ids.add(t[2:])
                continue
            tail_ids.add(t)
            seg_name, sep, row_s = t.rpartition("@")
            if sep and row_s.isdigit():
                seg_rows.setdefault(seg_name, set()).add(int(row_s))
        return tail_ids, seg_rows

    def _snapshot(
        self, d: str, count_tail_only: bool = False
    ) -> tuple[list, Any, set]:
        """Consistent (segment paths, raw tail lines, tombstones) taken
        under the store lock. Scans must start from ONE such snapshot:
        compaction moves events from the tail into a new segment, and a
        lock-free reader interleaving the two reads would either lose
        the moved events or count them twice. ``count_tail_only``
        returns an int line count instead of the lines — scan_state on a
        large uncompacted tail must not materialize it."""
        with self._lock:
            self._recover(d)
            seg_paths = self._segment_paths(d)
            lines: Any = 0 if count_tail_only else []
            try:
                with open(os.path.join(d, "tail.jsonl")) as f:
                    if count_tail_only:
                        lines = sum(1 for ln in f if ln.strip())
                    else:
                        lines = [ln for ln in f if ln.strip()]
            except FileNotFoundError:
                pass
            tomb = self._tombstones(d)
        return seg_paths, lines, tomb

    @staticmethod
    def _decode_tail_lines(lines: Sequence[str]) -> Iterator[Event]:
        for line in lines:
            yield _ColumnarEvents._decode_tail(json.loads(line))

    def _tail_events(self, d: str) -> Iterator[Event]:
        try:
            with open(os.path.join(d, "tail.jsonl")) as f:
                for line in f:
                    if line.strip():
                        yield self._decode_tail(json.loads(line))
        except FileNotFoundError:
            return

    @staticmethod
    def _decode_tail(obj: dict) -> Event:
        e = event_from_json(obj, validate=False)
        # the REST wire format truncates to milliseconds; the sidecar
        # microsecond fields preserve full event-time precision locally
        if "eventTimeUs" in obj:
            e = dataclasses.replace(e, event_time=_from_us(obj["eventTimeUs"]))
        if "creationTimeUs" in obj:
            e = dataclasses.replace(
                e, creation_time=_from_us(obj["creationTimeUs"])
            )
        return e

    @staticmethod
    def _encode_tail(event: Event) -> str:
        obj = event_to_json(event)
        obj["eventTimeUs"] = _to_us(event.event_time)
        obj["creationTimeUs"] = _to_us(event.creation_time)
        return json.dumps(obj)

    # ---------------------------------------------------------- LEvents
    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        self._ensure_stream(app_id, channel_id)
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        d = self._stream_dir(app_id, channel_id)
        if not os.path.isdir(d):
            return False
        with self._lock:
            shutil.rmtree(d)
            for p in [p for p in self._seg_cache if p.startswith(d)]:
                del self._seg_cache[p]
            for p in [p for p in self._ids_cache if p.startswith(d)]:
                del self._ids_cache[p]
            self._recent_ids.pop(d, None)
            self._recent_complete.pop(d, None)
            self._warm_ms.pop(d, None)
        return True

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        d = self._ensure_stream(app_id, channel_id)
        ids = []
        lines = []
        for e in events:
            eid = e.event_id or new_event_id()
            ids.append(eid)
            lines.append(self._encode_tail(e.with_event_id(eid)))
        with self._lock:
            # an unreplayed compaction marker would truncate the tail on
            # the next read — finish it BEFORE appending new lines
            self._recover(d)
            path = os.path.join(d, "tail.jsonl")
            prefix = ""
            try:
                with open(path, "rb") as rf:
                    rf.seek(-1, os.SEEK_END)
                    if rf.read(1) != b"\n":
                        # a writer (possibly another process) died
                        # mid-append, leaving torn bytes with no
                        # newline: isolate them on their own line so
                        # THIS acked event is not merged into one
                        # undecodable hybrid and lost
                        prefix = "\n"
            except (FileNotFoundError, OSError):
                pass  # no tail yet (or empty): nothing to isolate
            with open(path, "a") as f:
                f.write(prefix + "".join(line + "\n" for line in lines))
                if self._fsync:
                    f.flush()
                    os.fsync(f.fileno())
            lru = self._recent_ids.get(d)
            if lru is not None:
                # keep a built dedup window coherent with non-dedup
                # appends (webhook/import paths) so its tail-coverage
                # claim stays true
                for eid in ids:
                    self._remember_id(d, lru, eid)
        return ids

    # ----------------------------------------------------- idempotent insert
    def _recent_ids_for(self, d: str) -> "Any":
        """The stream's recent-id LRU, warmed on first use from the tail
        SUFFIX (seek to the last ``dedup_warm_bytes``, byte-offset
        style) plus the explicit-id segments while the byte budget and
        the window hold — so dedup keeps working across a process
        restart without an unbounded tail read. The warm is timed
        (``dedupWarmMs`` in ``recovery_report()``). Caller holds the
        store lock."""
        lru = self._recent_ids.get(d)
        if lru is None:
            t0 = time.perf_counter()
            from collections import OrderedDict

            lru = OrderedDict()
            complete = True
            budget = self._dedup_warm_bytes
            tail_path = os.path.join(d, "tail.jsonl")
            raw: list[bytes] = []
            try:
                size = os.path.getsize(tail_path)
            except OSError:
                size = 0
            if size:
                with open(tail_path, "rb") as f:
                    if size > budget:
                        # warm only the newest `budget` bytes; the
                        # skipped prefix may hold live ids, so coverage
                        # can no longer be proven
                        f.seek(size - budget)
                        f.readline()  # drop the partial first line
                        complete = False
                    raw = [ln for ln in f if ln.strip()]
            for line in raw[-self._dedup_window:]:
                try:
                    eid = json.loads(line).get("eventId")
                except (json.JSONDecodeError, UnicodeDecodeError):
                    continue  # torn line; the recovery sweep owns repair
                if eid:
                    lru[str(eid)] = None
            if len(raw) > self._dedup_window:
                complete = False
            # fold explicit-id segment ids in (bulk chunks, compacted
            # tails) while the byte budget and the window hold — this is
            # what lets a complete-window miss skip the per-segment
            # probe entirely on the bulk hot path. Positional segments
            # carry no client ids, so they cost nothing and never break
            # completeness (the presence probe reads only the npz
            # directory, not the data) — a store dominated by one huge
            # write_columns segment must not lose the fast path over it.
            budget -= size if size <= budget else budget
            for path in self._segment_paths(d):
                ids = None
                cost = 0
                try:
                    seg = self._seg_cache.get(path)
                    if seg is not None:
                        ids = seg.ids  # already resident: free
                    elif path in self._ids_cache:
                        index = self._ids_cache[path]
                        ids = None if index is None else index[0]
                    else:
                        with np.load(path, allow_pickle=False) as z:
                            if "ids" in z.files:
                                cost = os.path.getsize(path)
                                if cost > budget:
                                    complete = False
                                    break
                                ids = z["ids"]
                except OSError:
                    complete = False
                    break
                if ids is None:  # positional segment: no client ids
                    continue
                if len(lru) + ids.size > self._dedup_window:
                    complete = False
                    break
                budget -= cost
                for s in ids:
                    lru[str(s)] = None
            self._recent_ids[d] = lru
            self._recent_complete[d] = complete
            self._warm_ms[d] = (time.perf_counter() - t0) * 1000.0
        return lru

    def dedup_warm_stats(self) -> dict:
        """Aggregate warm cost across streams (``recovery_report()`` /
        the event server's ``/stats.json`` dedup section)."""
        with self._lock:
            return {
                "dedupWarmMs": round(sum(self._warm_ms.values()), 3),
                "dedupWarmedStreams": len(self._warm_ms),
            }

    def _remember_id(self, d: str, lru: "Any", eid: str) -> None:
        lru[eid] = None
        lru.move_to_end(eid)
        while len(lru) > self._dedup_window:
            lru.popitem(last=False)
            self._recent_complete[d] = False  # evicted: window < tail

    def insert_dedup(
        self, event: Event, app_id: int, channel_id: int | None = None
    ) -> tuple[str, bool]:
        return self.insert_batch_dedup([event], app_id, channel_id)[0]

    def insert_batch_dedup(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[tuple[str, bool]]:
        """Idempotent append: client-supplied ids are checked against the
        recent-id window (O(1)), falling back to the exact tail/segment
        lookup for ids older than the window; fresh events land through
        the normal single-fsync batch append. Check and append happen
        under one store lock, so concurrent retries of the same event
        cannot both pass the membership test."""
        d = self._ensure_stream(app_id, channel_id)
        out: list[tuple[str, bool] | None] = []
        fresh: list[Event] = []
        with self._lock:
            self._recover(d)
            lru = self._recent_ids_for(d)
            for e in events:
                eid = e.event_id
                if not eid:
                    e = e.with_event_id(new_event_id())
                    fresh.append(e)
                    out.append((e.event_id, False))  # type: ignore[arg-type]
                    continue
                if eid in lru:
                    lru.move_to_end(eid)
                    out.append((eid, True))
                    continue
                # LRU miss. When the window provably covers every
                # client-visible id (tail AND explicit-id segments), the
                # miss itself proves freshness — only positional
                # ``seg@row`` ids (which are never in the window) still
                # need their routed lookup. Otherwise fall back to the
                # exact full lookup — never an O(tail) decode per insert
                # on the hot path.
                if self._recent_complete.get(d, False):
                    dup = (
                        "@" in eid
                        and self._lookup_segments(eid, d) is not None
                    )
                else:
                    dup = self._lookup(eid, d)[0] is not None
                self._remember_id(d, lru, eid)  # also dedups within the batch
                if dup:
                    out.append((eid, True))
                    continue
                fresh.append(e)
                out.append((eid, False))
            if fresh:
                self.insert_batch(fresh, app_id, channel_id)
        return out  # type: ignore[return-value]

    # ------------------------------------------------------ bulk chunk ingest
    @staticmethod
    def _window_probe(ids_py: list, lru: "Any") -> np.ndarray:
        """Chunk-batched membership probe against the recent-id window:
        one C-level ``np.fromiter`` pass of hashed lookups — O(chunk),
        no per-event python frames, and (unlike a sorted-array merge)
        no O(window) maintenance per chunk. Returns the known-duplicate
        mask. Caller holds the store lock."""
        return np.fromiter(
            (i in lru for i in ids_py), dtype=bool, count=len(ids_py)
        )

    def _store_probe(
        self, d: str, probe: np.ndarray, probe_py: list
    ) -> np.ndarray:
        """Exact-store half of the chunk dedup: vectorized searchsorted
        through every explicit-id segment index plus ONE tail scan —
        only reached when the window cannot prove freshness (store
        bigger than the window / warm budget). Caller holds the lock."""
        m = probe.shape[0]
        hit = np.zeros(m, dtype=bool)
        for path in self._segment_paths(d):
            index = self._segment_id_index(path)
            if index is None:
                continue
            sorted_ids, _ = index
            pos = np.searchsorted(sorted_ids, probe)
            inb = pos < sorted_ids.size
            eq = np.zeros(m, dtype=bool)
            eq[inb] = (
                sorted_ids[np.minimum(pos[inb], sorted_ids.size - 1)]
                == probe[inb]
            )
            hit |= eq
        # positional seg@row ids: the routed per-id lookup (rare — only
        # ids that syntactically name a positional segment row)
        for j in np.flatnonzero(~hit):
            if "@" in probe_py[j] and self._lookup_segments(
                probe_py[j], d
            ) is not None:
                hit[j] = True
        if not self._recent_complete.get(d, False):
            tail_ids = self._tail_id_set(d)
            for j in np.flatnonzero(~hit):
                if probe_py[j] in tail_ids:
                    hit[j] = True
        return hit

    def _tail_id_set(self, d: str) -> set:
        """One pass over the live tail collecting event ids — amortizes
        the incomplete-window fallback to one scan per CHUNK instead of
        one per id."""
        out: set[str] = set()
        try:
            with open(os.path.join(d, "tail.jsonl"), "rb") as f:
                for ln in f:
                    if not ln.strip():
                        continue
                    try:
                        eid = json.loads(ln).get("eventId")
                    except (json.JSONDecodeError, UnicodeDecodeError):
                        continue
                    if eid:
                        out.add(str(eid))
        except FileNotFoundError:
            pass
        return out

    def ingest_chunk(
        self, chunk: EventChunk, app_id: int, channel_id: int | None = None
    ) -> list[tuple[str, bool]]:
        """Bulk-route append: one pre-parsed chunk lands as ONE
        explicit-id columnar segment, dedup on — no per-event dicts, no
        tail JSON re-encode, one fsync'd file write.

        Dedup order: (1) vectorized window probe (searchsorted + LRU);
        (2) intra-chunk repeats via ``np.unique`` (first occurrence
        wins, same rule as the batch route); (3) exact store probe only
        when the window is not provably complete. Fresh rows are written
        with their ids (``ids`` column) so they stay fetchable,
        deletable, follower-visible, and dedup-durable across restarts;
        the whole check+append runs under one store lock so concurrent
        retries of the same chunk cannot both pass the membership test."""
        n = len(chunk)
        if n == 0:
            return []
        self.init(app_id, channel_id)
        d = self._stream_dir(app_id, channel_id)
        ids_py = chunk.ids
        with self._lock:
            self._recover(d)
            lru = self._recent_ids_for(d)
            dup = self._window_probe(ids_py, lru)
            if dup.all():
                keep = None  # pure retransmit: nothing to write
            else:
                # intra-chunk repeats: np.unique keeps the FIRST occurrence
                ids_arr = np.asarray(ids_py, dtype=np.str_)
                first = np.unique(ids_arr, return_index=True)[1]
                keep = np.zeros(n, dtype=bool)
                keep[first] = True
                if self._recent_complete.get(d, False):
                    # positional seg@row ids are never in the window —
                    # they keep their routed lookup, like the single
                    # route's complete-window fast path (the any() scan
                    # keeps the common no-"@" chunk one C pass)
                    if any("@" in s for s in ids_py):
                        for i in np.flatnonzero(~dup & keep).tolist():
                            if "@" in ids_py[i] and self._lookup_segments(
                                ids_py[i], d
                            ) is not None:
                                dup[i] = True
                else:
                    rest = np.flatnonzero(~dup & keep)
                    if rest.size:
                        dup[rest] = self._store_probe(
                            d, ids_arr[rest], [ids_py[i] for i in rest]
                        )
            if keep is None:
                row_dup = dup
            else:
                row_dup = dup | ~keep
                fresh = np.flatnonzero(keep & ~dup)
                if fresh.size:
                    self._write_chunk_segment(
                        chunk, fresh, ids_arr, app_id, channel_id
                    )
                    # bulk-remember: insert everything, trim the window
                    # once (a fresh id lands at the LRU end by insertion
                    # order, so no per-id move_to_end is needed)
                    if fresh.size == n:
                        lru.update(dict.fromkeys(ids_py))
                    else:
                        for i in fresh.tolist():
                            lru[ids_py[i]] = None
                    overflow = len(lru) - self._dedup_window
                    if overflow > 0:
                        for _ in range(overflow):
                            lru.popitem(last=False)
                        self._recent_complete[d] = False
        return list(zip(ids_py, row_dup.tolist()))

    def _write_chunk_segment(
        self,
        chunk: EventChunk,
        rows: np.ndarray,
        ids_arr: np.ndarray,
        app_id: int,
        channel_id: int | None,
    ) -> None:
        """Encode the fresh rows of one chunk straight into a segment —
        the vectorized mirror of ``_write_segment_from_events`` (string
        dictionary encoding via ``np.unique``, numeric columns sliced,
        ids kept). The common all-rows-fresh case skips every
        fancy-index copy."""
        n = len(chunk)
        whole = rows.size == n

        def col_str(values: list) -> np.ndarray:
            arr = np.asarray(values, dtype=np.str_)
            return arr if whole else arr[rows]

        def col_num(arr: np.ndarray) -> np.ndarray:
            return arr if whole else arr[rows]

        # uniform single-value columns (one event name / entity type per
        # stream is the norm) skip the np.unique sort entirely
        def encode_maybe_uniform(values: list) -> tuple[np.ndarray, np.ndarray]:
            first = values[0]
            arr = col_str(values)
            if (arr == first).all():
                return (
                    np.zeros(arr.shape[0], np.int32),
                    np.asarray([first], dtype=np.str_),
                )
            return encode_strings(arr)

        ev_code, ev_vocab = encode_maybe_uniform(chunk.event)
        etype_code, etype_vocab = encode_maybe_uniform(chunk.entity_type)
        eid_code, eid_vocab = encode_strings(col_str(chunk.entity_id))

        def encode_opt(values: list) -> tuple[np.ndarray, np.ndarray]:
            picked = values if whole else [values[i] for i in rows.tolist()]
            if None not in picked:
                return encode_strings(np.asarray(picked, dtype=np.str_))
            present = [v for v in picked if v is not None]
            codes = np.full(len(picked), -1, np.int32)
            if not present:
                return codes, np.zeros(0, dtype="<U1")
            p_codes, vocab = encode_strings(present)
            codes[[i for i, v in enumerate(picked) if v is not None]] = p_codes
            return codes, vocab

        ttype_code, ttype_vocab = encode_opt(chunk.target_entity_type)
        tid_code, tid_vocab = encode_opt(chunk.target_entity_id)
        arrays: dict[str, np.ndarray] = {
            "ev_code": ev_code, "ev_vocab": ev_vocab,
            "etype_code": etype_code, "etype_vocab": etype_vocab,
            "eid_code": eid_code, "eid_vocab": eid_vocab,
            "ttype_code": ttype_code, "ttype_vocab": ttype_vocab,
            "tid_code": tid_code, "tid_vocab": tid_vocab,
            "t_us": col_num(chunk.t_us),
            "c_us": col_num(chunk.c_us),
        }
        for k, col in chunk.propf.items():
            arrays[f"propf_{k}"] = col_num(col)
            arrays[f"propint_{k}"] = col_num(chunk.propint[k])
        extra = col_str(chunk.extra)
        if np.any(extra != ""):
            arrays["extra"] = extra
        arrays["ids"] = col_num(ids_arr)
        # provenance marker: bulk segments are never part of the
        # consumed tail prefix (see tail_follow's re-anchor)
        arrays["bulk"] = np.asarray(True)
        self._save_segment(arrays, app_id, channel_id)

    # --------------------------------------------- compaction watermarks
    def stream_stats(self) -> list[dict]:
        """Per-stream watermark inputs for the background compaction
        scheduler: tail bytes, dead tail tombstones, segment count —
        everything readable without decoding a single event."""
        out: list[dict] = []
        for app_id, channel_id, d in self._stream_dirs():
            try:
                tail_bytes = os.path.getsize(os.path.join(d, "tail.jsonl"))
            except OSError:
                tail_bytes = 0
            dead = 0
            try:
                with open(os.path.join(d, "tombstones.txt")) as f:
                    for line in f:
                        if line.startswith("t:"):
                            dead += 1
            except OSError:
                pass
            out.append(
                {
                    "app_id": app_id,
                    "channel_id": channel_id,
                    "tail_bytes": tail_bytes,
                    "dead_tail_tombstones": dead,
                    "segments": len(self._segment_paths(d)),
                    "compactions": self._compactions(d),
                }
            )
        return out

    # ------------------------------------------------------- tail following
    #: consumed tail event ids remembered in a follow cursor. After a
    #: compaction moves consumed tail lines into an explicit-id segment,
    #: the newest chain id found in the new segments re-anchors the
    #: consumed prefix — so a follower never re-reads what it already
    #: consumed, even across a process restart straddling the compaction.
    _FOLLOW_CHAIN = 64

    #: how many trailing bytes of the consumed prefix the cursor
    #: checksums — catches a recovery trim (or any rewrite) that shifted
    #: the byte layout under a persisted ``tail_bytes`` offset
    _CRC_WINDOW = 64

    @staticmethod
    def _scan_tail_bytes(
        path: str, offset: int
    ) -> tuple[list[dict], int | None, int | None]:
        """Decode tail lines from byte ``offset`` to EOF. Returns
        ``(objs, end, crc)``: ``end`` is the exclusive byte offset of
        the cleanly consumed region — it only advances across lines that
        both decode AND end in a newline, and collapses to None the
        moment anything torn/unterminated is seen (the cursor then falls
        back to decodable-line counting, the pre-offset behavior).
        ``crc`` covers the last ``_CRC_WINDOW`` bytes before ``end``.
        Decodable-but-dirty lines are still decoded and counted, exactly
        like the non-offset scan."""
        objs: list[dict] = []
        clean = True
        end = offset
        try:
            f = open(path, "rb")
        except FileNotFoundError:
            return [], (0 if offset == 0 else None), (0 if offset == 0 else None)
        with f:
            if offset:
                f.seek(offset)
            for raw in f:
                terminated = raw.endswith(b"\n")
                if not raw.strip():
                    if clean and terminated:
                        end += len(raw)
                    else:
                        clean = False
                    continue
                try:
                    obj = json.loads(raw)
                except json.JSONDecodeError:
                    # torn (crash-mid-append) bytes: never acked, never
                    # followed — and never COUNTED (see tail_follow)
                    clean = False
                    continue
                objs.append(obj)
                if clean and terminated:
                    end += len(raw)
                else:
                    clean = False
            if not clean:
                return objs, None, None
            start = max(0, end - _ColumnarEvents._CRC_WINDOW)
            f.seek(start)
            crc = zlib.crc32(f.read(end - start))
        return objs, end, crc

    def _tail_delta(self, d: str, cursor: dict) -> dict | None:
        """O(delta) same-generation tail read: seek straight to the
        cursor's ``tail_bytes`` offset instead of re-reading the whole
        tail. Returns None (caller falls back to the full decodable-line
        scan) unless every validation holds: the offset is within the
        file, lands on a line boundary, and the checksummed trailing
        bytes of the consumed prefix are byte-identical — so a recovery
        trim or out-of-band rewrite can never silently shift events
        under the watermark."""
        path = os.path.join(d, "tail.jsonl")
        offset = cursor.get("tail_bytes")
        if not isinstance(offset, int) or isinstance(offset, bool) or offset < 0:
            return None
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        if size < offset:
            return None
        if offset > 0:
            with open(path, "rb") as f:
                f.seek(offset - 1)
                if f.read(1) != b"\n":
                    return None
                expect = cursor.get("tail_crc")
                if isinstance(expect, int) and not isinstance(expect, bool):
                    start = max(0, offset - self._CRC_WINDOW)
                    f.seek(start)
                    if zlib.crc32(f.read(offset - start)) != expect:
                        return None
        objs, end, crc = self._scan_tail_bytes(path, offset)
        return {"objs": objs, "end": end, "crc": crc}

    def tail_follow(
        self,
        app_id: int,
        channel_id: int | None = None,
        cursor: dict | None = None,
        from_start: bool = False,
    ) -> tuple[list[Event], dict]:
        """Exactly-once delta read for the online-learning follower
        (:mod:`predictionio_tpu_torch.online.follower`): return every event
        appended since ``cursor`` and the advanced cursor.

        The cursor records ``(stream_id, compactions, consumed segment
        names, consumed tail line count, recent tail ids)`` plus — when
        the consumed prefix ended cleanly — a ``tail_bytes`` byte offset
        and a ``tail_crc`` checksum of its trailing bytes, so a
        same-generation poll seeks straight to the delta instead of
        re-reading (and re-decoding) the whole tail: poll cost is
        O(bytes appended since the last poll), not O(tail). Offset
        mismatch, checksum drift, or any torn bytes fall back to the
        decodable-line-count scan, which stays the semantic authority.
        Three store mutations are survived without loss or duplication:

        * **segment roll** — bulk writes land whole new (positional-id)
          segments; any segment name not in the cursor is new and read in
          full;
        * **compaction** — the consumed tail prefix moves into new
          explicit-id segments. The newest ``recent_ids`` chain entry
          found in those segments marks the end of the consumed prefix;
          rows at or before it are skipped, everything after (and the
          reset tail) is new. A chain entry only misses if every one of
          the last ``_FOLLOW_CHAIN`` consumed events was individually
          deleted before the compaction — the documented (rare) window
          where re-delivery is possible; events are never skipped;
        * **stream drop/recreate** — the ``stream_id`` mismatch resets
          the cursor instead of mis-counting the new tail as consumed.

        A fresh (or reset) cursor starts at the END of the stream unless
        ``from_start`` — online serving folds new events, not history.
        Tombstoned events are filtered like every other scan. The caller
        owns cursor persistence (see ``TailFollower.commit``)."""
        d = self._ensure_stream(app_id, channel_id)
        tail_path = os.path.join(d, "tail.jsonl")
        with self._lock:
            self._recover(d)
            seg_paths = self._segment_paths(d)
            tomb = self._tombstones(d)
            compactions = self._compactions(d)
            stream_id = self._stream_id(d)
            fresh = (
                cursor is None
                or not cursor.get("stream_id")
                or cursor.get("stream_id") != stream_id
            )
            same_gen = (
                not fresh
                and cursor is not None
                and int(cursor.get("compactions", 0)) == compactions
            )
            # O(delta) fast path: a same-generation cursor carrying a
            # validated byte offset reads only what was appended since
            # the last poll. Any mismatch (compaction reset the tail,
            # recovery trimmed torn bytes, checksum drift) returns None
            # and the decodable-line-count scan below stays the
            # authority — the cursor semantics never change, only the
            # bytes read.
            delta = self._tail_delta(d, cursor) if same_gen else None
            if delta is None:
                # torn (crash-mid-append) bytes are never COUNTED: the
                # cursor indexes DECODABLE lines only, so the recovery
                # sweep's trim (which rewrites the tail without the torn
                # bytes) cannot shift consumed indices under a live
                # watermark and skip the next appended event.
                tail_objs, tail_end, tail_crc = self._scan_tail_bytes(
                    tail_path, 0
                )
                base_count = 0
            else:
                tail_objs = delta["objs"]
                tail_end = delta["end"]
                tail_crc = delta["crc"]
                base_count = int(cursor.get("tail_lines", 0))
        tail_tomb, seg_tomb = self._split_tombstones(tomb)
        names = [os.path.splitext(os.path.basename(p))[0] for p in seg_paths]

        def cursor_tail_fields(count: int) -> dict:
            out = {"tail_lines": count}
            if tail_end is not None:
                out["tail_bytes"] = tail_end
                out["tail_crc"] = tail_crc
            return out

        if fresh and not from_start:
            chain = [
                i
                for i in (str(o.get("eventId") or "") for o in tail_objs)
                if i
            ]
            return [], {
                "stream_id": stream_id,
                "compactions": compactions,
                "segments": names,
                "recent_ids": chain[-self._FOLLOW_CHAIN:],
                **cursor_tail_fields(len(tail_objs)),
            }
        if fresh:
            cursor = {
                "stream_id": stream_id,
                "compactions": compactions,
                "segments": [],
                "tail_lines": 0,
                "recent_ids": [],
            }
        assert cursor is not None
        known = set(cursor.get("segments", ()))
        chain = [str(i) for i in cursor.get("recent_ids", ())]
        new_paths = [p for p, n in zip(seg_paths, names) if n not in known]
        events: list[Event] = []

        if same_gen:
            seg_plan = [(p, 0) for p in new_paths]
            if delta is None:
                tail_start = min(
                    int(cursor.get("tail_lines", 0)), len(tail_objs)
                )
            else:
                tail_start = 0  # tail_objs already IS the delta
        else:
            # compaction(s) landed: locate the consumed prefix inside the
            # new COMPACTED explicit-id segments via the newest chain id
            # present. Bulk-chunk segments (seg.bulk) never held tail
            # lines, so they are excluded from both the anchor search
            # and the prefix skip — they are read in full like any other
            # segment roll, even when they sorted before the cut.
            loaded = {p: self._segment(p) for p in new_paths}
            cut: tuple[int, int] | None = None
            for si, p in enumerate(new_paths):
                seg = loaded[p]
                if seg.ids is None or seg.bulk:
                    continue
                for cid in reversed(chain):  # newest consumed first
                    hits = np.flatnonzero(seg.ids == cid)
                    if hits.size:
                        cand = (si, int(hits[0]))
                        if cut is None or cand > cut:
                            cut = cand
                        break
            seg_plan = []
            for si, p in enumerate(new_paths):
                seg = loaded[p]
                if cut is not None and seg.ids is not None and not seg.bulk:
                    if si < cut[0]:
                        continue  # fully inside the consumed prefix
                    if si == cut[0]:
                        seg_plan.append((p, cut[1] + 1))
                        continue
                seg_plan.append((p, 0))
            tail_start = 0  # the whole current tail postdates the compaction

        for p, start_row in seg_plan:
            seg = self._segment(p)
            if seg.ids is not None:
                for row in range(start_row, len(seg)):
                    if str(seg.ids[row]) not in tail_tomb:
                        events.append(seg.row_event(row))
            else:
                dead = seg_tomb.get(seg.name, ())
                for row in range(start_row, len(seg)):
                    if row not in dead:
                        events.append(seg.row_event(row))

        new_tail_ids: list[str] = []
        for obj in tail_objs[tail_start:]:
            e = self._decode_tail(obj)
            if e.event_id:
                new_tail_ids.append(e.event_id)
            if e.event_id not in tail_tomb:
                events.append(e)
        if same_gen:
            chain = (chain + new_tail_ids)[-self._FOLLOW_CHAIN:]
        else:
            chain = new_tail_ids[-self._FOLLOW_CHAIN:]
        return events, {
            "stream_id": stream_id,
            "compactions": compactions,
            "segments": names,
            "recent_ids": chain,
            **cursor_tail_fields(base_count + len(tail_objs)),
        }

    def compact(self, app_id: int, channel_id: int | None = None) -> int:
        """Seal the live JSONL tail into explicit-id segments and drop
        the consumed tail tombstones. Event ids survive (the segments
        carry an ``ids`` column), so acknowledged ids from POST
        /events.json stay fetchable and deletable. Returns the number of
        events moved.

        The whole operation holds the store lock; in-process readers see
        a consistent before/after via :meth:`_snapshot`. Incremental
        readers (``scan_state`` manifests) are invalidated by the
        tombstone-count/tail-length change and fall back to a full
        re-read. NOT safe against concurrent writers in OTHER processes
        (single-owner deployment, like the reference's HBase major
        compaction)."""
        d = self._ensure_stream(app_id, channel_id)
        with self._lock:
            self._recover(d)
            for name in os.listdir(d):  # pre-commit crash garbage
                if name.endswith(".pending") or name.endswith(".pending.tmp"):
                    try:
                        os.remove(os.path.join(d, name))
                    except FileNotFoundError:
                        pass
            tomb = self._tombstones(d)
            raw_ids, _ = self._split_tombstones(tomb)
            tail = list(self._tail_events(d))
            if not tail:
                return 0
            live = [e for e in tail if e.event_id not in raw_ids]
            # stage new segments invisibly, then commit atomically: a
            # crash before the marker leaves only .pending garbage, a
            # crash after it is replayed by _recover — never duplicates
            pending: list[str] = []
            for lo in range(0, len(live), self._segment_rows):
                path = self._next_segment_path(d)
                name = os.path.basename(path)
                self._write_segment_from_events(
                    live[lo : lo + self._segment_rows], app_id, channel_id,
                    keep_ids=True, path=path + ".pending",
                )
                pending.append(name)
            marker = os.path.join(d, "compact.commit")
            tmp = marker + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"pending": pending}, f)
                if self._fsync:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, marker)  # <- commit point
            for name in pending:
                os.replace(
                    os.path.join(d, name + ".pending"), os.path.join(d, name)
                )
            self._finish_compact(d)
        return len(live)

    def _lookup(
        self, event_id: str, d: str
    ) -> tuple[Event | None, bool]:
        """(event, found_in_tail) ignoring tombstones. The tail is checked
        first: caller-supplied ids may contain '@' (e.g. an export->import
        round trip of segment-generated ids) and must not be misrouted to
        a same-named segment row."""
        for e in self._tail_events(d):
            if e.event_id == event_id:
                return e, True
        return self._lookup_segments(event_id, d), False

    def _lookup_segments(self, event_id: str, d: str) -> Event | None:
        """Segment half of :meth:`_lookup` (positional-id routing plus the
        per-segment sorted-id index) — also the dedup fallback when the
        recent-id window provably covers the whole tail."""
        if "@" in event_id:
            seg_name, _, row_s = event_id.rpartition("@")
            path = os.path.join(d, seg_name + ".npz")
            if os.path.exists(path) and row_s.isdigit():
                seg = self._segment(path)
                row = int(row_s)
                if row < len(seg) and seg.ids is None:
                    return seg.row_event(row)
        # explicit-id (compacted) segments: match by stored id through the
        # per-segment sorted index — O(log rows) searchsorted per segment
        # instead of a full O(rows) equality scan per point get()/delete().
        # Only the ids member is read per file (decoding whole segments
        # for a point lookup would thrash the LRU cache) and positional
        # segments cache a None marker so repeat misses skip their files
        for path in self._segment_paths(d):
            index = self._segment_id_index(path)
            if index is None:
                continue
            sorted_ids, order = index
            pos = int(np.searchsorted(sorted_ids, event_id))
            if pos < sorted_ids.size and sorted_ids[pos] == event_id:
                return self._segment(path).row_event(int(order[pos]))
        return None

    def _segment_id_index(
        self, path: str
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Point-lookup index of one explicit-id segment — ``(ids sorted,
        argsort rows)`` — or None for positional segments. Built once per
        segment (O(rows log rows)), LRU-cached; each lookup is then a
        binary search instead of scanning every id in the store."""
        with self._lock:
            if path in self._ids_cache:
                self._ids_cache.move_to_end(path)
                return self._ids_cache[path]
        seg = self._seg_cache.get(path)
        if seg is not None:
            ids = seg.ids
        else:
            with np.load(path, allow_pickle=False) as z:
                ids = z["ids"] if "ids" in z.files else None
        if ids is None:
            index = None
        else:
            order = np.argsort(ids, kind="stable")
            index = (ids[order], order)
        with self._lock:
            self._ids_cache[path] = index
            # None markers are tiny; bound the real indexes by TOTAL
            # indexed rows, not file count — the bulk route writes many
            # small chunk segments, and a per-file cap would thrash
            # their indexes on every dedup probe while one huge
            # compacted segment still fits the same budget
            budget = max(self._cache_segments, 1) * 512_000
            real = [
                k for k, v in self._ids_cache.items() if v is not None
            ]
            rows = sum(self._ids_cache[k][0].size for k in real)
            while rows > budget and len(real) > 1:
                victim = real.pop(0)
                rows -= self._ids_cache[victim][0].size
                del self._ids_cache[victim]
        return index

    def _is_dead(self, event_id: str, in_tail: bool, d: str) -> bool:
        tail_ids, seg_rows = self._split_tombstones(self._tombstones(d))
        if in_tail or event_id in tail_ids:
            # tail events AND explicit-id segment rows are named by the
            # raw/unprefixed id set
            return event_id in tail_ids
        seg_name, sep, row_s = event_id.rpartition("@")
        return bool(
            sep and row_s.isdigit()
            and int(row_s) in seg_rows.get(seg_name, ())
        )

    def get(self, event_id: str, app_id: int, channel_id: int | None = None) -> Event | None:
        d = self._stream_dir(app_id, channel_id)
        with self._lock:
            self._recover(d)
        event, in_tail = self._lookup(event_id, d)
        if event is None or self._is_dead(event_id, in_tail, d):
            return None
        return event

    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool:
        d = self._ensure_stream(app_id, channel_id)
        with self._lock:
            # replay any interrupted compaction BEFORE classifying the
            # event: a tail hit followed by recovery's tombstone GC
            # would silently undo this delete
            self._recover(d)
        event, in_tail = self._lookup(event_id, d)
        if event is None or self._is_dead(event_id, in_tail, d):
            return False
        entry = f"t:{event_id}" if in_tail else event_id
        with self._lock:
            with open(os.path.join(d, "tombstones.txt"), "a") as f:
                f.write(entry + "\n")
        return True

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
        """Compat scan: decodes matching rows into Events, globally sorted
        by (event_time, event_id). Materializes the matching set — bulk
        training must use :meth:`find_columns` instead."""
        d = self._stream_dir(app_id, channel_id)
        seg_paths, tail_lines, tomb = self._snapshot(d)
        tail_tomb, seg_tomb = self._split_tombstones(tomb)
        out: list[Event] = []

        def keep(e: Event) -> bool:
            return BaseStorageClient.match_filters(
                e, start_time, until_time, entity_type, entity_id,
                event_names, target_entity_type, target_entity_id,
            )

        for path in seg_paths:
            seg = self._segment(path)
            rows = self._matching_rows(
                seg, start_time, until_time, entity_type, entity_id,
                event_names, target_entity_type, target_entity_id,
            )
            if seg.ids is not None:
                # explicit-id (compacted) segment: tombstones match by id
                for row in rows:
                    if str(seg.ids[int(row)]) not in tail_tomb:
                        out.append(seg.row_event(int(row)))
                continue
            dead = seg_tomb.get(seg.name, ())
            for row in rows:
                if int(row) not in dead:
                    out.append(seg.row_event(int(row)))
        for e in self._decode_tail_lines(tail_lines):
            if e.event_id not in tail_tomb and keep(e):
                out.append(e)
        out.sort(key=BaseStorageClient.sorted_events_key, reverse=reversed)
        if limit is not None:
            if limit == 0:
                return iter(())
            if limit > 0:  # negative = unbounded (contract)
                out = out[:limit]
        return iter(out)

    @staticmethod
    def _matching_rows(
        seg: _Segment,
        start_time,
        until_time,
        entity_type,
        entity_id,
        event_names,
        target_entity_type,
        target_entity_id,
    ) -> np.ndarray:
        """Vectorized filter over one segment's columns -> row indices."""
        return np.flatnonzero(
            _ColumnarEvents._matching_mask(
                seg, start_time, until_time, entity_type, entity_id,
                event_names, target_entity_type, target_entity_id,
            )
        )

    @staticmethod
    def _matching_mask(
        seg: _Segment,
        start_time,
        until_time,
        entity_type,
        entity_id,
        event_names,
        target_entity_type,
        target_entity_id,
    ) -> np.ndarray:
        mask = np.ones(len(seg), dtype=bool)

        def code_of(vocab: np.ndarray, value: str) -> int:
            i = np.searchsorted(vocab, value)
            if i < vocab.size and vocab[i] == value:
                return int(i)
            return -2  # matches nothing (tid/ttype use -1 for "none")

        if start_time is not None:
            mask &= seg.t_us >= _to_us(start_time)
        if until_time is not None:
            mask &= seg.t_us < _to_us(until_time)
        if entity_type is not None:
            mask &= seg.etype_code == code_of(seg.etype_vocab, entity_type)
        if entity_id is not None:
            mask &= seg.eid_code == code_of(seg.eid_vocab, entity_id)
        if event_names is not None:
            codes = [code_of(seg.ev_vocab, n) for n in event_names]
            mask &= np.isin(seg.ev_code, [c for c in codes if c >= 0])
        if target_entity_type is not None:
            mask &= seg.ttype_code == code_of(seg.ttype_vocab, target_entity_type)
        if target_entity_id is not None:
            mask &= seg.tid_code == code_of(seg.tid_vocab, target_entity_id)
        return mask

    # ------------------------------------------------- bulk (PEvents side)
    def bulk_write(
        self, events: Iterable[Event], app_id: int, channel_id: int | None = None
    ) -> None:
        """Bulk append as columnar segments, ``segment_rows`` per file."""
        self.init(app_id, channel_id)
        batch: list[Event] = []
        for e in events:
            batch.append(e)
            if len(batch) >= self._segment_rows:
                self._write_segment_from_events(batch, app_id, channel_id)
                batch = []
        if batch:
            self._write_segment_from_events(batch, app_id, channel_id)

    def _next_segment_path(self, d: str) -> str:
        with self._lock:
            self._seg_seq += 1
            seq = self._seg_seq
        return os.path.join(
            d, f"seg-{seq:06d}-{uuid.uuid4().hex[:8]}.npz"
        )

    def _write_segment_from_events(
        self, events: Sequence[Event], app_id: int, channel_id: int | None,
        keep_ids: bool = False, path: str | None = None,
    ) -> None:
        ev, etype, eid, ttype, tid = [], [], [], [], []
        t_us, c_us = [], []
        prop_rows: list[dict[str, tuple[float, bool]]] = []
        extra_rows: list[str] = []
        any_extra = False
        for e in events:
            ev.append(e.event)
            etype.append(e.entity_type)
            eid.append(e.entity_id)
            ttype.append(e.target_entity_type if e.target_entity_type is not None else None)
            tid.append(e.target_entity_id if e.target_entity_id is not None else None)
            t_us.append(_to_us(e.event_time))
            c_us.append(_to_us(e.creation_time))
            fl: dict[str, tuple[float, bool]] = {}
            residue_p: dict[str, Any] = {}
            for k, v in e.properties.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    residue_p[k] = v
                else:
                    fl[k] = (float(v), isinstance(v, int))
            prop_rows.append(fl)
            residue: dict[str, Any] = {}
            if residue_p:
                residue["p"] = residue_p
            if e.tags:
                residue["tags"] = list(e.tags)
            if e.pr_id is not None:
                residue["prId"] = e.pr_id
            extra_rows.append(json.dumps(residue) if residue else "")
            any_extra = any_extra or bool(residue)

        n = len(events)
        ev_code, ev_vocab = encode_strings(ev)
        etype_code, etype_vocab = encode_strings(etype)
        eid_code, eid_vocab = encode_strings(eid)

        def encode_opt(values):
            present = [v for v in values if v is not None]
            codes = np.full(n, -1, np.int32)
            if not present:
                return codes, np.zeros(0, dtype="<U1")
            p_codes, vocab = encode_strings(present)
            codes[[i for i, v in enumerate(values) if v is not None]] = p_codes
            return codes, vocab

        ttype_code, ttype_vocab = encode_opt(ttype)
        tid_code, tid_vocab = encode_opt(tid)

        prop_keys = sorted({k for row in prop_rows for k in row})
        arrays: dict[str, np.ndarray] = {
            "ev_code": ev_code, "ev_vocab": ev_vocab,
            "etype_code": etype_code, "etype_vocab": etype_vocab,
            "eid_code": eid_code, "eid_vocab": eid_vocab,
            "ttype_code": ttype_code, "ttype_vocab": ttype_vocab,
            "tid_code": tid_code, "tid_vocab": tid_vocab,
            "t_us": np.asarray(t_us, np.int64),
            "c_us": np.asarray(c_us, np.int64),
        }
        for k in prop_keys:
            col = np.full(n, np.nan, np.float64)
            was_int = np.zeros(n, dtype=bool)
            for i, row in enumerate(prop_rows):
                if k in row:
                    col[i], was_int[i] = row[k]
            arrays[f"propf_{k}"] = col
            arrays[f"propint_{k}"] = was_int
        if any_extra:
            arrays["extra"] = np.asarray(extra_rows, dtype=np.str_)
        if keep_ids:
            # compacted-tail segments keep their original event ids so
            # acknowledged ids stay fetchable/deletable after compaction
            arrays["ids"] = np.asarray(
                [e.event_id or new_event_id() for e in events], dtype=np.str_
            )
        self._save_segment(arrays, app_id, channel_id, path=path)

    def write_columns(
        self,
        app_id: int,
        channel_id: int | None = None,
        *,
        event: str | tuple[np.ndarray, np.ndarray],
        entity_type: str,
        entity_codes: np.ndarray,
        entity_vocab: np.ndarray,
        event_time_us: np.ndarray,
        target_entity_type: str | None = None,
        target_codes: np.ndarray | None = None,
        target_vocab: np.ndarray | None = None,
        props: dict[str, np.ndarray] | None = None,
        creation_time_us: np.ndarray | None = None,
    ) -> int:
        """Vectorized bulk ingest — the sharded-writer path (SURVEY §8.3
        "streaming events → device arrays"): land pre-columnar data
        (e.g. a ratings CSV/COO) as segments without constructing one
        Event object. ``event`` is one name for all rows or (codes,
        vocab); ``props`` maps property name -> float array (NaN =
        absent). Returns the number of events written."""
        self.init(app_id, channel_id)
        n = int(np.asarray(entity_codes).shape[0])

        def normalized(codes, vocab):
            """Segment vocabs must be SORTED (readers binary-search them);
            callers may pass any order — remap through np.unique."""
            vocab = np.asarray(vocab, dtype=np.str_)
            codes = np.asarray(codes, np.int32)
            sorted_vocab, inv = np.unique(vocab, return_inverse=True)
            remapped = np.full_like(codes, -1)
            ok = codes >= 0
            remapped[ok] = inv.astype(np.int32)[codes[ok]]
            return remapped, sorted_vocab

        if isinstance(event, str):
            ev_code = np.zeros(n, np.int32)
            ev_vocab = np.asarray([event], dtype=np.str_)
        else:
            ev_code, ev_vocab = normalized(event[0], event[1])
        entity_codes, entity_vocab = normalized(entity_codes, entity_vocab)
        if target_codes is None:
            t_code = np.full(n, -1, np.int32)
            t_vocab = np.zeros(0, dtype="<U1")
            tt_code = np.full(n, -1, np.int32)
            tt_vocab = np.zeros(0, dtype="<U1")
        else:
            t_code, t_vocab = normalized(target_codes, target_vocab)
            tt_code = np.where(t_code >= 0, np.int32(0), np.int32(-1))
            tt_vocab = np.asarray(
                [target_entity_type or "item"], dtype=np.str_
            )
        t_us = np.asarray(event_time_us, np.int64)
        c_us = (
            np.asarray(creation_time_us, np.int64)
            if creation_time_us is not None
            else t_us
        )
        written = 0
        for lo in range(0, n, self._segment_rows):
            hi = min(lo + self._segment_rows, n)
            sl = slice(lo, hi)
            arrays = {
                "ev_code": ev_code[sl], "ev_vocab": ev_vocab,
                "etype_code": np.zeros(hi - lo, np.int32),
                "etype_vocab": np.asarray([entity_type], dtype=np.str_),
                "eid_code": np.asarray(entity_codes[sl], np.int32),
                "eid_vocab": np.asarray(entity_vocab, dtype=np.str_),
                "ttype_code": tt_code[sl], "ttype_vocab": tt_vocab,
                "tid_code": t_code[sl], "tid_vocab": t_vocab,
                "t_us": t_us[sl], "c_us": c_us[sl],
            }
            for k, col in (props or {}).items():
                arrays[f"propf_{k}"] = np.asarray(col[sl], np.float64)
                arrays[f"propint_{k}"] = np.zeros(hi - lo, dtype=bool)
            self._save_segment(arrays, app_id, channel_id)
            written += hi - lo
        return written

    def _save_segment(
        self, arrays: dict[str, np.ndarray], app_id: int, channel_id: int | None,
        path: str | None = None,
    ) -> None:
        if arrays["ev_code"].shape[0] == 0:
            return
        d = self._ensure_stream(app_id, channel_id)
        if path is None:
            path = self._next_segment_path(d)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            if self._fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)

    def scan_state(self, app_id: int, channel_id: int | None = None) -> dict:
        """Snapshot of the stream's physical inputs — the incremental
        re-index manifest. Segments are immutable and the tail is
        append-only, so a reader that recorded this state can later read
        ONLY the segments/tail lines added since (``segments`` +
        ``tail_skip`` on :meth:`find_columns`), provided the tombstone
        count is unchanged and its recorded segments still exist."""
        d = self._stream_dir(app_id, channel_id)
        seg_paths, n_tail, tomb = self._snapshot(d, count_tail_only=True)
        return {
            "stream_id": self._stream_id(d),
            "segments": sorted(
                os.path.splitext(os.path.basename(p))[0] for p in seg_paths
            ),
            "tail_lines": n_tail,
            "tombstones": len(tomb),
            # bumps on every compaction: incremental manifests recorded
            # before one must NOT validate after it (the tail was
            # consumed; a regrown tail would otherwise alias tail_skip)
            "compactions": self._compactions(d),
        }

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
        segments: Sequence[str] | None = None,
        tail_skip: int = 0,
    ) -> EventColumns:
        """Array-speed columnar scan: per-segment vectorized filters, then
        one vocabulary merge — no per-event Python except for the (small)
        JSONL tail and rows whose requested property lives in the JSON
        residue. ``segments`` restricts the scan to the named segment
        files and ``tail_skip`` skips the first N tail lines — the delta
        read of an incremental re-index (see :meth:`scan_state`)."""
        d = self._stream_dir(app_id, channel_id)
        seg_paths, tail_lines, tomb = self._snapshot(d)
        tail_tomb, tomb_rows = self._split_tombstones(tomb)

        ev_parts: list[tuple[np.ndarray, np.ndarray]] = []
        ent_parts: list[tuple[np.ndarray, np.ndarray]] = []
        tgt_parts: list[tuple[np.ndarray, np.ndarray]] = []
        times: list[np.ndarray] = []
        props: list[np.ndarray] = []

        if segments is not None:
            wanted = set(segments)
            seg_paths = [
                p
                for p in seg_paths
                if os.path.splitext(os.path.basename(p))[0] in wanted
            ]
        for path in seg_paths:
            seg = self._segment(path)
            mask = self._matching_mask(
                seg, start_time, until_time, entity_type, None,
                event_names, target_entity_type, None,
            )
            if seg.ids is not None:
                if tail_tomb:
                    mask &= ~np.isin(seg.ids, list(tail_tomb))
            else:
                dead = tomb_rows.get(seg.name)
                if dead:
                    mask[list(dead)] = False
            if mask.all():
                rows = slice(None)  # whole segment: skip the index gather
                n_rows = len(seg)
            else:
                rows = np.flatnonzero(mask)
                n_rows = rows.size
                if n_rows == 0:
                    continue
            ev_parts.append((seg.ev_code[rows], seg.ev_vocab))
            ent_parts.append((seg.eid_code[rows], seg.eid_vocab))
            tgt_parts.append((seg.tid_code[rows], seg.tid_vocab))
            times.append(seg.t_us[rows])
            if prop is not None:
                col = seg.propf.get(prop)
                p = (
                    col[rows].astype(np.float32)
                    if col is not None
                    else np.full(n_rows, np.nan, np.float32)
                )
                # the requested property may hide in the JSON residue of
                # a few rows (non-float values coerced where possible)
                if seg.extra is not None:
                    ex = seg.extra[rows]
                    for j in np.flatnonzero(ex != ""):
                        residue = json.loads(str(ex[j])).get("p", {})
                        if prop in residue:
                            try:
                                p[j] = float(residue[prop])
                            except (TypeError, ValueError):
                                pass
                props.append(p)

        tail = [
            e
            for j, e in enumerate(self._decode_tail_lines(tail_lines))
            if j >= tail_skip
            and e.event_id not in tail_tomb
            and BaseStorageClient.match_filters(
                e, start_time, until_time, entity_type, None,
                event_names, target_entity_type, None,
            )
        ]
        if tail:
            tc = columns_from_events(tail, prop=prop)
            ev_parts.append((tc.event_code, tc.event_vocab))
            ent_parts.append((tc.entity_code, tc.entity_vocab))
            tgt_parts.append((tc.target_code, tc.target_vocab))
            times.append(tc.event_time_us)
            if prop is not None:
                props.append(tc.prop)

        if not times:
            empty = np.zeros(0, np.int32)
            u1 = np.zeros(0, dtype="<U1")
            return EventColumns(
                empty, u1, empty.copy(), u1, empty.copy(), u1,
                np.zeros(0, np.int64),
                np.zeros(0, np.float32) if prop is not None else None,
            )

        ev_code, ev_vocab = _merge_vocabs(ev_parts)
        ent_code, ent_vocab = _merge_vocabs(ent_parts)
        tgt_code, tgt_vocab = _merge_vocabs(tgt_parts, allow_missing=True)
        t_us = times[0] if len(times) == 1 else np.concatenate(times)
        if prop is None:
            p_all = None
        else:
            p_all = props[0] if len(props) == 1 else np.concatenate(props)
        if num_shards > 1:
            sel = np.arange(t_us.shape[0]) % num_shards == shard_index
            ev_code, ent_code, tgt_code, t_us = (
                ev_code[sel], ent_code[sel], tgt_code[sel], t_us[sel],
            )
            if p_all is not None:
                p_all = p_all[sel]
        return EventColumns(
            event_code=ev_code, event_vocab=ev_vocab,
            entity_code=ent_code, entity_vocab=ent_vocab,
            target_code=tgt_code, target_vocab=tgt_vocab,
            event_time_us=t_us, prop=p_all,
        )


class _ColumnarPEvents(PEvents):
    """PEvents over the same layout: bulk scan (sharded), bulk append,
    stream truncation, and the array-speed columnar read."""

    def __init__(self, events: _ColumnarEvents):
        self._e = events

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
            self._e.find(
                app_id, channel_id, start_time, until_time, entity_type,
                entity_id, event_names, target_entity_type, target_entity_id,
            )
        ):
            if i % num_shards == shard_index:
                yield e

    def write(
        self, events: Iterable[Event], app_id: int, channel_id: int | None = None
    ) -> None:
        self._e.bulk_write(events, app_id, channel_id)

    def delete(self, app_id: int, channel_id: int | None = None) -> None:
        self._e.remove(app_id, channel_id)
        self._e.init(app_id, channel_id)

    def write_columns(self, app_id: int, channel_id: int | None = None, **kw) -> int:
        return self._e.write_columns(app_id, channel_id, **kw)

    def compact(self, app_id: int, channel_id: int | None = None) -> int:
        return self._e.compact(app_id, channel_id)

    def find_columns(self, app_id: int, channel_id: int | None = None, **kw):
        return self._e.find_columns(app_id, channel_id, **kw)

    def scan_state(self, app_id: int, channel_id: int | None = None) -> dict:
        return self._e.scan_state(app_id, channel_id)

    def tail_follow(
        self,
        app_id: int,
        channel_id: int | None = None,
        cursor: dict | None = None,
        from_start: bool = False,
    ) -> tuple[list[Event], dict]:
        return self._e.tail_follow(app_id, channel_id, cursor, from_start)


class StorageClient(BaseStorageClient):
    """Event-data driver over columnar segments (``TYPE=columnar``).

    Config::

        PIO_STORAGE_SOURCES_<ID>_TYPE=columnar
        PIO_STORAGE_SOURCES_<ID>_PATH=/data/pio-events
        PIO_STORAGE_SOURCES_<ID>_SEGMENT_ROWS=1000000        # optional
        PIO_STORAGE_SOURCES_<ID>_FSYNC=false                 # optional
        PIO_STORAGE_SOURCES_<ID>_DEDUP_WINDOW=100000         # optional
        PIO_STORAGE_SOURCES_<ID>_DEDUP_WARM_BYTES=67108864   # optional
        PIO_STORAGE_SOURCES_<ID>_PARTITIONS=4                # optional
        PIO_STORAGE_SOURCES_<ID>_REPLICATION=2               # optional
        PIO_STORAGE_SOURCES_<ID>_ACK_QUORUM=2                # optional

    On open, the driver runs a startup recovery sweep (quarantines orphan
    temp/staging files, replays committed compactions, trims torn tail
    lines) and reports it via :meth:`recovery_report`.

    ``PARTITIONS > 1`` (or ``REPLICATION >= 2``) switches the layout to
    entity-hash partitioned per-partition stores (see
    ``data/storage/partitioned.py``); the default path stays byte-for-byte
    the single-stream layout and never imports the partitioned modules.
    """

    def __init__(self, config: StorageClientConfig):
        super().__init__(config)
        path = config.properties.get("path")
        if not path:
            raise StorageError("columnar driver requires a PATH property")
        prefix = config.properties.get("prefix", "pio")
        segment_rows = int(
            config.properties.get("segment_rows", _DEFAULT_SEGMENT_ROWS)
        )
        fsync = config.properties.get("fsync", "false").lower() == "true"
        cache_segments = config.properties.get("cache_segments")
        dedup_window = config.properties.get("dedup_window")
        dedup_warm_bytes = config.properties.get("dedup_warm_bytes")
        partitions = int(config.properties.get("partitions", "1") or "1")
        replication = int(config.properties.get("replication", "0") or "0")
        ack_quorum = int(config.properties.get("ack_quorum", "0") or "0")
        base = os.path.join(os.path.expanduser(path), f"{prefix}_events")
        os.makedirs(base, exist_ok=True)
        store_kw = dict(
            cache_segments=(
                int(cache_segments) if cache_segments is not None else None
            ),
            dedup_window=(
                int(dedup_window) if dedup_window is not None else None
            ),
            dedup_warm_bytes=(
                int(dedup_warm_bytes) if dedup_warm_bytes is not None else None
            ),
        )
        if partitions > 1 or replication:
            from predictionio_tpu_torch.data.storage.partitioned import (
                PartitionedPEvents,
                open_partitioned,
            )

            self._events = open_partitioned(
                base,
                partitions=partitions,
                replication=replication,
                ack_quorum=ack_quorum,
                segment_rows=segment_rows,
                fsync=fsync,
                **store_kw,
            )
            self._pevents = PartitionedPEvents(self._events)
        else:
            # refuse to open a partitioned layout as a single stream:
            # routing/dedup state lives per partition, and flattening it
            # silently would double-store retransmitted events
            if os.path.exists(os.path.join(base, "partitions.json")):
                raise StorageError(
                    f"store at {base} is partitioned (partitions.json "
                    "present); open it with the same PARTITIONS setting or "
                    "migrate via pio export/import"
                )
            self._events = _ColumnarEvents(base, segment_rows, fsync, **store_kw)
            self._pevents = _ColumnarPEvents(self._events)
        # startup recovery: a kill -9 can leave orphan temp files, a torn
        # commit marker, or a torn tail line — sweep BEFORE any read or
        # write touches the store, quarantining rather than deleting
        self._recovery = self._events.sweep_recovery()
        if self._recovery["quarantined"]:
            import logging

            logging.getLogger(__name__).warning(
                "columnar startup recovery quarantined %d file(s): %s",
                len(self._recovery["quarantined"]),
                ", ".join(self._recovery["quarantined"][:5]),
            )

    def recovery_report(self) -> dict:
        return dict(self._recovery)

    def get_l_events(self) -> LEvents:
        return self._events

    def get_p_events(self) -> PEvents:
        return self._pevents
