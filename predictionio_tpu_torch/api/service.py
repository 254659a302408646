"""Event-server handler core — transport-agnostic request handlers.

Parity: ``data/api/EventServer.scala`` (``EventServiceActor`` routes):

* ``GET /``                          -> ``{"status": "alive"}``
* ``POST /events.json``              -> 201 ``{"eventId": ...}``
* ``GET /events/<id>.json``          -> 200 event | 404
* ``DELETE /events/<id>.json``       -> 200 ``{"message": "Found"}`` | 404
* ``GET /events.json``               -> 200 JSON array (time/entity filters)
* ``POST /batch/events.json``        -> 200 per-item status array (max 50)
* ``GET /stats.json``                -> live counters (when enabled)
* ``POST /webhooks/<connector>.json``-> adapt third-party payloads

Auth matches the reference: every data route needs ``accessKey`` (query
param or ``Authorization`` header), resolved against the metadata store;
an access key may whitelist event names; ``channel`` routes to a channel
stream. Responses use the reference's JSON shapes so existing client SDKs
keep working.

Counterpart of ``predictionio_tpu/api/service.py``, the same code with the
port's imports, the partitioned and replicated stores' ``/stats.json``
sections and ``/readyz`` check included.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Iterable, Mapping

from predictionio_tpu_torch.api.stats import Stats
from predictionio_tpu_torch.api.webhooks import (
    ConnectorError,
    FormConnector,
    JsonConnector,
    get_connector,
)
from predictionio_tpu_torch.data.event import (
    EventValidationError,
    event_from_json,
    event_to_json,
    parse_event_time,
    validate_event,
)
from predictionio_tpu_torch.data.storage import Storage

__all__ = [
    "Response",
    "StreamingResponse",
    "EventService",
    "MAX_BATCH_SIZE",
    "invalidate_access_key_caches",
]

logger = logging.getLogger(__name__)

MAX_BATCH_SIZE = 50  # parity: reference rejects batches > 50

#: every live EventService, so in-process key/app deletion (the `pio`
#: command layer running inside the server process, or tests) can revoke
#: cached access keys immediately instead of waiting out the TTL.
#: _LIVE_SERVICES_LOCK guards add vs iterate: WeakSet only defends its
#: iteration against GC-driven removals, not a concurrent add() from a
#: server thread constructing a service mid-delete
_LIVE_SERVICES: "weakref.WeakSet[EventService]" = weakref.WeakSet()
_LIVE_SERVICES_LOCK = threading.Lock()


def invalidate_access_key_caches(keys: Iterable[str] | None = None) -> None:
    """Drop ``keys`` (or everything, when None) from every live
    EventService's access-key cache. Called by the accesskey-delete and
    app-delete command paths; out-of-process servers still revoke within
    the cache TTL (``PIO_ACCESSKEY_CACHE_SECS`` — docs/eventserver.md)."""
    key_list = None if keys is None else list(keys)
    with _LIVE_SERVICES_LOCK:
        services = list(_LIVE_SERVICES)
    for service in services:
        service.invalidate_access_keys(key_list)


@dataclasses.dataclass(frozen=True)
class Response:
    status: int
    body: Any
    #: extra HTTP headers (e.g. ``Retry-After`` on a 429 from the serving
    #: runtime's admission control); the transport layer emits them
    headers: Mapping[str, str] | None = None

    def json_bytes(self) -> bytes:
        return json.dumps(self.body, default=str).encode()


@dataclasses.dataclass
class StreamingResponse:
    """A response whose body is produced incrementally (the bulk-ingest
    route): ``chunks`` yields byte pieces the transport sends with
    chunked transfer encoding as they become ready — per-chunk ingest
    statuses stream back while the payload is still arriving, so a
    100 MB upload never buffers its response."""

    status: int
    chunks: Any  # Iterator[bytes]
    headers: Mapping[str, str] | None = None
    content_type: str = "application/x-ndjson"


def _msg(status: int, message: str) -> Response:
    return Response(status, {"message": message})


class EventService:
    """One instance per server process; thread-safe through the storage
    drivers' own locking (single-writer semantics per sqlite connection)."""

    def __init__(self, stats: bool = False):
        self.stats_enabled = stats
        self.stats = Stats() if stats else None
        # Resolved access keys, cached briefly: the ingest hot loop pays a
        # metadata-store query per POST otherwise (SURVEY.md section 4.3 —
        # the reference's spray routes resolve the key per request against
        # HBase/JDBC, but those clients pool and cache; our sqlite metadata
        # store shares the event-table lock, so per-POST lookups convoy).
        # Staleness bound = PIO_ACCESSKEY_CACHE_SECS (0 disables); only
        # positive lookups are cached so a just-created key works at once.
        # LRU-bounded (PIO_ACCESSKEY_CACHE_MAX, default 1024): a key-scan
        # attack or a long-lived multi-tenant server evicts oldest-used
        # entries one at a time instead of growing without limit (the old
        # guard cleared the WHOLE cache at the cap, stampeding every hot
        # key back to the metadata store at once). Hit/miss/eviction
        # counters surface on /stats.json.
        self._key_cache: "OrderedDict[str, tuple[float, Any]]" = OrderedDict()
        self._key_cache_lock = threading.Lock()
        self._key_cache_hits = 0
        self._key_cache_misses = 0
        self._key_cache_evictions = 0
        try:
            self._key_cache_ttl = float(
                os.environ.get("PIO_ACCESSKEY_CACHE_SECS", "2.0")
            )
        except ValueError:
            self._key_cache_ttl = 2.0
        try:
            self._key_cache_max = max(
                1, int(os.environ.get("PIO_ACCESSKEY_CACHE_MAX", "1024"))
            )
        except ValueError:
            self._key_cache_max = 1024
        # idempotent-ingestion counters (docs/eventserver.md): a hit is a
        # duplicate client-supplied eventId answered without a second
        # write; a miss is a client-supplied id seen for the first time.
        # Retrying clients produce a low steady hit rate; a SPIKE usually
        # means a crashed-and-restarted client is replaying its backlog.
        self._dedup_lock = threading.Lock()
        self._dedup_hits = 0
        self._dedup_misses = 0
        # streaming bulk-route counters (docs/eventserver.md): updated
        # per CHUNK by the ingest pipeline, never per event
        self._bulk_lock = threading.Lock()
        self._bulk_requests = 0
        self._bulk_chunks = 0
        self._bulk_received = 0
        self._bulk_stored = 0
        self._bulk_duplicates = 0
        self._bulk_invalid = 0
        self._bulk_bytes = 0
        self._bulk_storage_errors = 0
        #: optional background compaction scheduler (`pio eventserver
        #: --compact-interval-s`); surfaced on /stats.json and stopped
        #: by the drain hook
        self.compaction_scheduler = None
        with _LIVE_SERVICES_LOCK:
            _LIVE_SERVICES.add(self)

    def invalidate_access_keys(self, keys: Iterable[str] | None = None) -> None:
        """Evict ``keys`` (or all, when None) from the resolved-key cache
        so a deleted key stops authenticating immediately."""
        with self._key_cache_lock:
            if keys is None:
                self._key_cache.clear()
            else:
                for k in keys:
                    self._key_cache.pop(k, None)

    def _resolve_key(self, key: str):
        if self._key_cache_ttl <= 0:
            return Storage.get_meta_data_access_keys().get(key)
        now = time.monotonic()
        with self._key_cache_lock:
            hit = self._key_cache.get(key)
            if hit is not None and now - hit[0] < self._key_cache_ttl:
                self._key_cache.move_to_end(key)
                self._key_cache_hits += 1
                return hit[1]
            self._key_cache_misses += 1
        access_key = Storage.get_meta_data_access_keys().get(key)
        if access_key is not None:
            with self._key_cache_lock:
                self._key_cache[key] = (now, access_key)
                self._key_cache.move_to_end(key)
                while len(self._key_cache) > self._key_cache_max:
                    self._key_cache.popitem(last=False)
                    self._key_cache_evictions += 1
        return access_key

    def key_cache_stats(self) -> dict:
        """Access-key-cache counters for ``GET /stats.json`` — a rising
        eviction rate with a low hit rate is the signature of a key-scan
        (each probe misses, fills, and evicts a real tenant's entry)."""
        with self._key_cache_lock:
            return {
                "hits": self._key_cache_hits,
                "misses": self._key_cache_misses,
                "evictions": self._key_cache_evictions,
                "entries": len(self._key_cache),
                "maxEntries": self._key_cache_max,
                "ttlSeconds": self._key_cache_ttl,
            }

    # ---------------------------------------------------------------- auth
    def _auth(
        self, params: Mapping[str, str], headers: Mapping[str, str] | None = None
    ) -> tuple[Any, Any] | Response:
        """accessKey (+channel) -> (AccessKey, channel_id|None) or an error
        Response (parity: the authenticate directive + channel resolve)."""
        key = params.get("accessKey")
        if not key and headers:
            # SDKs may send the key as basic-auth username; header names
            # are case-insensitive per HTTP
            auth = next(
                (v for k, v in headers.items() if k.lower() == "authorization"), ""
            )
            if auth.startswith("Basic "):
                import base64

                try:
                    key = base64.b64decode(auth[6:]).decode().split(":", 1)[0]
                except Exception:
                    key = None
        if not key:
            return _msg(401, "Missing accessKey.")
        access_key = self._resolve_key(key)
        if access_key is None:
            return _msg(401, "Invalid accessKey.")
        channel_name = params.get("channel")
        if not channel_name:
            return access_key, None
        channels = Storage.get_meta_data_channels().get_by_appid(access_key.appid)
        for ch in channels:
            if ch.name == channel_name:
                return access_key, ch.id
        return _msg(400, f"Invalid channel: {channel_name}")

    # -------------------------------------------------------------- routes
    def status(self) -> Response:
        return Response(200, {"status": "alive"})

    def create_event(
        self,
        body: Any,
        params: Mapping[str, str],
        headers: Mapping[str, str] | None = None,
    ) -> Response:
        auth = self._auth(params, headers)
        if isinstance(auth, Response):
            return auth
        access_key, channel_id = auth
        resp = self._insert_one(body, access_key, channel_id)
        self._record_stats(access_key.appid, body, resp.status)
        return resp

    def _record_stats(self, app_id: int, body: Any, status: int) -> None:
        if self.stats is None:
            return
        name = body.get("event") if isinstance(body, Mapping) else None
        etype = body.get("entityType") if isinstance(body, Mapping) else None
        self.stats.update(app_id, status, name, etype)

    @staticmethod
    def _validate_item(body: Any, access_key):
        """Parse + authorize one event body -> Event, or an error Response
        (shared by the single and batch routes so they can't diverge)."""
        if not isinstance(body, Mapping):
            return _msg(400, "Event must be a JSON object.")
        try:
            event = event_from_json(body)
        except EventValidationError as e:
            return _msg(400, str(e))
        if access_key.events and event.event not in access_key.events:
            return _msg(403, f"Event '{event.event}' is not allowed by this accessKey.")
        return event

    def _record_dedup(self, supplied: bool, duplicate: bool) -> None:
        if not supplied:
            return
        with self._dedup_lock:
            if duplicate:
                self._dedup_hits += 1
            else:
                self._dedup_misses += 1

    def dedup_stats(self) -> dict:
        with self._dedup_lock:
            return {"hits": self._dedup_hits, "misses": self._dedup_misses}

    def _insert_one(self, body: Any, access_key, channel_id) -> Response:
        event = self._validate_item(body, access_key)
        if isinstance(event, Response):
            return event
        # client-supplied eventId = idempotency key: a retried POST gets
        # the ORIGINAL id back with `"duplicate": true` instead of a
        # second stored event. Without an eventId the write path is the
        # historical generate-and-insert, unchanged (dedup is strictly
        # per-event opt-in; CI-guarded).
        event_id, duplicate = Storage.get_l_events().insert_dedup(
            event, access_key.appid, channel_id
        )
        self._record_dedup(bool(event.event_id), duplicate)
        payload: dict = {"eventId": event_id}
        if duplicate:
            payload["duplicate"] = True
        return Response(201, payload)

    def create_events_batch(
        self,
        body: Any,
        params: Mapping[str, str],
        headers: Mapping[str, str] | None = None,
    ) -> Response:
        auth = self._auth(params, headers)
        if isinstance(auth, Response):
            return auth
        access_key, channel_id = auth
        if not isinstance(body, list):
            return _msg(400, "Batch events must be a JSON array.")
        if len(body) > MAX_BATCH_SIZE:
            return _msg(400, f"Batch size is greater than {MAX_BATCH_SIZE}.")
        # Validate everything first, then write the valid events through ONE
        # insert_batch call (single transaction on sqlite, one segment append
        # on columnar) instead of a commit per item — the batch route exists
        # to amortize exactly this (ref EventServer.scala batch route; the
        # per-item status array contract is unchanged).
        results: list[dict | None] = []
        valid: list[tuple[int, Any]] = []  # (result slot, parsed Event)
        for item in body:
            event = self._validate_item(item, access_key)
            if isinstance(event, Response):
                entry = dict(event.body)
                entry["status"] = event.status
                results.append(entry)
                continue
            valid.append((len(results), event))
            results.append(None)  # filled after the bulk insert
        if valid:
            try:
                results_dedup = Storage.get_l_events().insert_batch_dedup(
                    [e for _, e in valid], access_key.appid, channel_id
                )
            except Exception:
                # the route's contract is a per-item status array; a
                # storage failure maps every pending slot to its own 500
                # instead of failing the whole request (clients retry by
                # slot, and already-reported 4xx validation entries
                # stand). Message stays generic — exception text can
                # embed backend paths/DSNs (details go to the log)
                logger.exception("batch event insert failed")
                for slot, _ in valid:
                    results[slot] = {
                        "status": 500,
                        "message": "Storage error: event was not stored.",
                    }
            else:
                for (slot, event), (eid, dup) in zip(valid, results_dedup):
                    entry = {"eventId": eid, "status": 201}
                    if dup:
                        entry["duplicate"] = True
                    self._record_dedup(bool(event.event_id), dup)
                    results[slot] = entry
        for item, entry in zip(body, results):
            self._record_stats(access_key.appid, item, entry["status"])
        return Response(200, results)

    # ------------------------------------------------- streaming bulk ingest
    #: routes the HTTP wrapper hands a raw body STREAM instead of a
    #: parsed JSON body (chunked transfer + gzip supported) — the
    #: payload is never materialized whole
    stream_routes = frozenset({("POST", "/events/bulk.json")})

    #: rows per pipeline chunk (one columnar segment append per chunk);
    #: ``?chunkRows=`` overrides within [64, 65536]
    BULK_CHUNK_ROWS = 4096

    def create_events_bulk(
        self,
        params: Mapping[str, str],
        headers: Mapping[str, str] | None = None,
        stream: Any = None,
    ) -> Response | StreamingResponse:
        """``POST /events/bulk.json`` — NDJSON (one event per line),
        unbounded count, optional ``Content-Encoding: gzip``, chunked
        transfer welcome. The body flows through the pipelined
        parse→validate→append stages straight into the event store's
        columnar bulk path; the response streams one NDJSON status
        object per ingested chunk (stored/duplicate/invalid counts,
        per-line error offsets) and a final ``{"done": true}`` summary.
        Dedup semantics are identical to the single/batch routes:
        client ``eventId``s are idempotency keys, duplicates answer
        with per-line offsets instead of storing twice."""
        auth = self._auth(params, headers)
        if isinstance(auth, Response):
            return auth
        access_key, channel_id = auth
        if stream is None:
            return _msg(400, "Bulk route requires a streamed request body.")
        try:
            chunk_rows = int(params.get("chunkRows", self.BULK_CHUNK_ROWS))
        except ValueError:
            return _msg(400, "chunkRows must be an integer.")
        chunk_rows = max(64, min(65536, chunk_rows))
        encoding = ""
        ctype = ""
        if headers:
            for k, v in headers.items():
                lk = k.lower()
                if lk == "content-encoding":
                    encoding = v.lower()
                elif lk == "content-type":
                    ctype = v.split(";")[0].strip().lower()
        if encoding and encoding not in ("gzip", "x-gzip", "identity"):
            return _msg(415, f"Unsupported Content-Encoding '{encoding}'.")
        gzipped = encoding in ("gzip", "x-gzip")
        # two wire formats: NDJSON (one event per line — default) and
        # the columnar chunk encoding (one pre-columnarized EventChunk
        # per line) that skips per-event parsing entirely
        wire = "chunks" if ctype == "application/x-pio-chunks" else "ndjson"
        return StreamingResponse(
            200,
            self._bulk_lines(
                stream, access_key, channel_id, chunk_rows, gzipped, wire
            ),
        )

    def _bulk_lines(
        self, stream, access_key, channel_id, chunk_rows: int, gzipped: bool,
        wire: str = "ndjson",
    ):
        """Generator driving stage 0 of the pipeline: read byte blocks
        off the socket (gunzip incrementally), feed the parser, and
        yield per-chunk status lines as the appender finishes them —
        socket read, parse, and fsync'd append overlap."""
        import zlib

        from predictionio_tpu_torch.data.ingest import IngestPipeline, PipelineError

        pipeline = IngestPipeline(
            Storage.get_l_events(),
            access_key.appid,
            channel_id,
            chunk_rows=chunk_rows,
            allowed_events=(
                frozenset(access_key.events) if access_key.events else None
            ),
            wire=wire,
        )
        decomp = zlib.decompressobj(47) if gzipped else None
        bytes_in = 0
        storage_errors = 0
        dedup_hits = 0
        dedup_misses = 0

        def encode(result) -> bytes:
            nonlocal storage_errors, dedup_hits, dedup_misses
            if result.storage_error is not None:
                storage_errors += 1
            dedup_hits += result.dedup_hits
            dedup_misses += result.dedup_misses
            return (
                json.dumps(result.to_json(), separators=(",", ":")) + "\n"
            ).encode()

        ok = True
        error: str | None = None
        try:
            try:
                while True:
                    block = stream.read(65536)
                    if not block:
                        break
                    bytes_in += len(block)
                    pipeline.feed(
                        decomp.decompress(block) if decomp else block
                    )
                    for result in pipeline.poll():
                        yield encode(result)
                if decomp is not None:
                    tail = decomp.flush()
                    if tail:
                        pipeline.feed(tail)
                    if not decomp.eof:
                        # zlib only raises on CORRUPT input; a cut-off
                        # gzip member flushes quietly — acking it would
                        # silently drop everything after the truncation
                        raise ValueError("truncated gzip body")
                for result in pipeline.finish():
                    yield encode(result)
            except (PipelineError, zlib.error, OSError, ValueError) as e:
                logger.exception("bulk ingest stream failed")
                ok = False
                error = str(e)[:200]
                pipeline.close()
            summary = pipeline.summary()
            summary["done"] = True
            summary["ok"] = ok and storage_errors == 0
            summary["storageErrors"] = storage_errors
            if error is not None:
                summary["error"] = error
            yield (json.dumps(summary, separators=(",", ":")) + "\n").encode()
        finally:
            # also runs on GeneratorExit (client hung up mid-stream):
            # unblock and stop the stage threads instead of leaking them
            pipeline.close()
            s = pipeline.summary()
            with self._bulk_lock:
                self._bulk_requests += 1
                self._bulk_chunks += s["chunks"]
                self._bulk_received += s["received"]
                self._bulk_stored += s["stored"]
                self._bulk_duplicates += s["duplicates"]
                self._bulk_invalid += s["invalid"]
                self._bulk_bytes += bytes_in
                self._bulk_storage_errors += storage_errors
            with self._dedup_lock:
                self._dedup_hits += dedup_hits
                self._dedup_misses += dedup_misses

    def bulk_stats(self) -> dict:
        with self._bulk_lock:
            return {
                "requests": self._bulk_requests,
                "chunks": self._bulk_chunks,
                "received": self._bulk_received,
                "stored": self._bulk_stored,
                "duplicates": self._bulk_duplicates,
                "invalid": self._bulk_invalid,
                "bytesIn": self._bulk_bytes,
                "storageErrors": self._bulk_storage_errors,
            }

    # ------------------------------------------------------------- lifecycle
    def drain(self) -> None:
        """Drain hook (discovered by the HTTP wrapper): stop the
        background compaction scheduler before the storage flush so a
        draining server never starts new tail rewrites."""
        scheduler = self.compaction_scheduler
        if scheduler is not None:
            scheduler.stop()

    def get_event(
        self, event_id: str, params: Mapping[str, str], headers=None
    ) -> Response:
        auth = self._auth(params, headers)
        if isinstance(auth, Response):
            return auth
        access_key, channel_id = auth
        event = Storage.get_l_events().get(event_id, access_key.appid, channel_id)
        if event is None:
            return _msg(404, "Not Found")
        return Response(200, event_to_json(event))

    def delete_event(
        self, event_id: str, params: Mapping[str, str], headers=None
    ) -> Response:
        auth = self._auth(params, headers)
        if isinstance(auth, Response):
            return auth
        access_key, channel_id = auth
        if Storage.get_l_events().delete(event_id, access_key.appid, channel_id):
            return Response(200, {"message": "Found"})
        return _msg(404, "Not Found")

    def find_events(self, params: Mapping[str, str], headers=None) -> Response:
        auth = self._auth(params, headers)
        if isinstance(auth, Response):
            return auth
        access_key, channel_id = auth
        try:
            filters = self._parse_find_filters(params)
        except (EventValidationError, ValueError) as e:
            return _msg(400, str(e))
        events = Storage.get_l_events().find(
            access_key.appid, channel_id, **filters
        )
        return Response(200, [event_to_json(e) for e in events])

    @staticmethod
    def _parse_find_filters(params: Mapping[str, str]) -> dict[str, Any]:
        filters: dict[str, Any] = {}
        if params.get("startTime"):
            filters["start_time"] = parse_event_time(params["startTime"])
        if params.get("untilTime"):
            filters["until_time"] = parse_event_time(params["untilTime"])
        if params.get("entityType"):
            filters["entity_type"] = params["entityType"]
        if params.get("entityId"):
            filters["entity_id"] = params["entityId"]
        if params.get("event"):
            filters["event_names"] = [params["event"]]
        if params.get("targetEntityType"):
            filters["target_entity_type"] = params["targetEntityType"]
        if params.get("targetEntityId"):
            filters["target_entity_id"] = params["targetEntityId"]
        if params.get("limit"):
            limit = int(params["limit"])
            filters["limit"] = None if limit < 0 else limit
        else:
            filters["limit"] = 20  # reference default
        if params.get("reversed"):
            filters["reversed"] = params["reversed"].lower() == "true"
        return filters

    def get_stats(self, params: Mapping[str, str], headers=None) -> Response:
        # authenticate first: an unauthenticated caller learns nothing
        # about server configuration
        auth = self._auth(params, headers)
        if isinstance(auth, Response):
            return auth
        if self.stats is None:
            return _msg(404, "Stats are not enabled (run with --stats).")
        payload = self.stats.to_json()
        payload["accessKeyCache"] = self.key_cache_stats()
        payload["dedup"] = self.dedup_stats()
        warm = getattr(Storage.get_l_events(), "dedup_warm_stats", None)
        if callable(warm):
            payload["dedup"].update(warm())
        payload["bulk"] = self.bulk_stats()
        if self.compaction_scheduler is not None:
            payload["compaction"] = self.compaction_scheduler.to_json()
        le = Storage.get_l_events()
        part_count = int(getattr(le, "partition_count", 1) or 1)
        if part_count > 1:
            # partitioned store: per-partition stream stats so a wedged
            # or lagging partition is visible, not averaged away
            section: dict = {"count": part_count}
            per_part = getattr(le, "stream_stats_partitioned", None)
            if callable(per_part):
                try:
                    section["streams"] = per_part()
                except Exception as e:
                    section["error"] = str(e)[:200]
            payload["partitions"] = section
        health = getattr(le, "replication_health", None)
        if callable(health):
            try:
                rep = health()
            except Exception as e:
                rep = [{"error": str(e)[:200]}]
            if rep is not None:
                # per-partition replication lag + quorum — the loud
                # degraded-mode surface the durability story promises
                payload["replication"] = rep
        return Response(200, payload)

    def webhook(
        self,
        connector_name: str,
        body: Any,
        params: Mapping[str, str],
        headers=None,
        form: Mapping[str, str] | None = None,
    ) -> Response:
        auth = self._auth(params, headers)
        if isinstance(auth, Response):
            return auth
        access_key, channel_id = auth
        connector = get_connector(connector_name)
        if connector is None:
            return _msg(404, f"Unknown webhook connector '{connector_name}'.")
        try:
            if isinstance(connector, FormConnector):
                event = connector.to_event(form or {})
            else:
                assert isinstance(connector, JsonConnector)
                if not isinstance(body, Mapping):
                    return _msg(400, "Webhook payload must be a JSON object.")
                event = connector.to_event(body)
            # connectors adapt shapes; the event-model invariants still
            # apply on this write path like any other
            validate_event(event)
        except (ConnectorError, EventValidationError) as e:
            return _msg(400, str(e))
        event_id = Storage.get_l_events().insert(event, access_key.appid, channel_id)
        return Response(201, {"eventId": event_id})

    # ----------------------------------------------------------- readiness
    def readiness(self) -> dict:
        """``GET /readyz`` (served by the HTTP wrapper): an event server
        is ready when BOTH its stores answer — metadata for access-key
        resolution, eventdata for the ingest writes themselves (they may
        be different sources, so each is probed)."""
        from predictionio_tpu_torch.api.health import (
            events_check,
            readiness_report,
            replication_check,
            storage_check,
        )

        checks = {"storage": storage_check(), "events": events_check()}
        rep = replication_check()
        if rep is not None:
            # replicated stores degrade /readyz on quorum loss — a 503
            # here is the signal that acked-append guarantees cannot
            # currently be met on some partition
            checks["replication"] = rep
        return readiness_report(**checks)

    # ------------------------------------------------------------ dispatch
    def dispatch(
        self,
        method: str,
        path: str,
        params: Mapping[str, str],
        body: Any = None,
        headers: Mapping[str, str] | None = None,
        form: Mapping[str, str] | None = None,
        stream: Any = None,
    ) -> Response | StreamingResponse:
        """Route one request (shared by the HTTP wrapper and in-process
        tests — the spray-testkit analog). ``stream`` carries the raw
        body reader for :attr:`stream_routes`; every other route keeps
        the parsed-``body`` contract byte-identical."""
        method = method.upper()
        if path == "/" and method == "GET":
            return self.status()
        if path == "/events.json":
            if method == "POST":
                return self.create_event(body, params, headers)
            if method == "GET":
                return self.find_events(params, headers)
        if path == "/batch/events.json" and method == "POST":
            return self.create_events_batch(body, params, headers)
        if path == "/events/bulk.json" and method == "POST":
            return self.create_events_bulk(params, headers, stream)
        if path.startswith("/events/") and path.endswith(".json"):
            event_id = path[len("/events/"):-len(".json")]
            if method == "GET":
                return self.get_event(event_id, params, headers)
            if method == "DELETE":
                return self.delete_event(event_id, params, headers)
        if path == "/stats.json" and method == "GET":
            return self.get_stats(params, headers)
        if path.startswith("/webhooks/") and path.endswith(".json") and method == "POST":
            name = path[len("/webhooks/"):-len(".json")]
            return self.webhook(name, body, params, headers, form)
        return _msg(404, "Not Found")
