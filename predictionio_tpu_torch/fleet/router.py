"""The fleet router: health-gated load balancing, failover, rolling swap.

The process ``pio deploy --replicas N`` binds to the public port. It
owns no model — it owns the *availability contract*:

* **Routing** — ``POST /queries.json`` routes by consistent hash of the
  query's cache scope (``serving.cache.affinity_key`` →
  :class:`~predictionio_tpu_torch.fleet.ring.HashRing`), so each scope's
  cached results live on exactly one replica; scope-less bodies route
  least-loaded. Unhealthy, draining, rolling, or breaker-open replicas
  are skipped at selection time.
* **Health gating** — a monitor thread probes every replica's
  ``/readyz`` each ``probe_interval_s`` (active), and every forwarded
  request's outcome feeds the same state (passive), with one
  :class:`~predictionio_tpu_torch.resilience.CircuitBreaker` per backend. A
  SIGKILLed replica is routed around within one probe interval — and
  usually sooner, because the first failed forward marks it down.
* **Failover** — a transport failure mid-request re-dispatches the SAME
  query to the next replica in ring order, at most
  ``failover_retries`` times (default 1), and only for idempotent
  requests (GETs and ``/queries.json``; any other proxied POST is
  forwarded exactly once). Caveat under ``--feedback``: a replica that
  died *after* scoring may already have enqueued its prediction event,
  so a failover (or a hedge) can record the same query's prediction
  twice — feedback is best-effort telemetry by contract
  (``FeedbackConfig``), and that contract is what makes queries safe to
  re-dispatch. A ``503`` carrying ``Retry-After`` is a
  *routing signal*, not a client problem: the replica is marked
  draining for that long and the request re-dispatches to a peer
  immediately without consuming the failover budget — behind a router,
  the drain contract produces zero client-visible 503s.
* **Hedging** (opt-in, ``--hedge-ms``) — when the primary has not
  answered within ``max(hedge_ms, observed p95)``, a hedge goes to the
  next candidate and the first answer wins; bounds the tail a single
  slow replica can impose.
* **Rolling swap** — ``POST /reload`` rotates one replica at a time:
  mark it rolling (drain semantics: new work routes around it, in-flight
  work completes), reload it, wait for ``/readyz`` to report the new
  generation, move on. A bounded key→generation LRU tags every routed
  cache key with the generation that served it, and selection prefers
  replicas at or past that generation — so one cache key is never served
  by two model generations mid-rollout (``generationRegressions`` on
  ``/stats.json`` counts the availability-over-affinity escapes; the
  fleet drills assert it stays 0).
* **Invalidation fan-out** — ``POST /cache/invalidate.json`` broadcasts
  to every replica (one retry per replica; invalidation is idempotent,
  and event-shaped bodies carry the deterministic ``eventId`` so any
  upstream redelivery is absorbed too).
* **Fast fleet-down answer** — with every replica down the router
  answers ``503`` immediately with a ``taxonomy`` field
  (``breaker_open`` vs ``no_healthy_replicas``) and a ``Retry-After``
  derived from the breaker reset — no retry storm, no stacked timeouts.
* **Elastic membership** (opt-in, ``endpoint_registry=``) — the monitor
  thread reconciles the ring from the shared
  :class:`~predictionio_tpu_torch.fleet.registry.EndpointRegistry` each probe
  interval: replicas that announced join, replicas whose lease expired
  are evicted (exactly once across an HA router pair — the registry's
  rename-claim guarantees it) and leave the ring. ``GET
  /fleet/endpoints.json`` is the registry's HTTP read API.
* **Stale-while-down cache** (opt-in, ``--stale-cache-ttl-s``) — the
  last good answer per scope is kept for a bounded TTL and served with
  an explicit ``X-PIO-Stale: true`` marker ONLY when no replica can
  serve at all; a scope any live replica could answer is always served
  fresh.

Stdlib-only by contract: replicas are opaque HTTP backends; the router
must never import torch, jax, storage, or the workflow.
"""

from __future__ import annotations

import collections
import dataclasses
import http.client
import json
import logging
import queue
import threading
import time
import urllib.parse
from typing import Any, Callable, Iterable, Mapping, Sequence

from predictionio_tpu_torch.fleet.registry import EndpointRegistry, ModelRegistry
from predictionio_tpu_torch.fleet.ring import HashRing
from predictionio_tpu_torch.resilience import CircuitBreaker
from predictionio_tpu_torch.serving.cache import affinity_key

__all__ = ["ReplicaState", "RouterConfig", "RouterService", "TransportError"]

logger = logging.getLogger(__name__)


class TransportError(Exception):
    """The replica could not be reached or died mid-request (connection
    refused/reset, timeout, torn response) — distinct from any HTTP
    status it answered."""


def _token_ok(presented: str, expected: str) -> bool:
    import hmac

    return hmac.compare_digest(str(presented), expected)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Knobs of the router (CLI: ``pio deploy --replicas N ...``)."""

    #: seconds between active /readyz probes of each replica
    probe_interval_s: float = 0.25
    #: socket timeout of one probe
    probe_timeout_s: float = 2.0
    #: socket timeout of one forwarded request
    request_timeout_s: float = 30.0
    #: most times one idempotent request is re-dispatched after a
    #: transport failure (draining re-dispatches are not counted here)
    failover_retries: int = 1
    #: >0 enables hedged queries: a hedge fires after
    #: ``max(hedge_ms, observed p95 latency)`` — p95-triggered with a
    #: floor, so a cold histogram cannot hedge every request. 0 = off.
    hedge_ms: float = 0.0
    #: consecutive transport failures that open a replica's breaker
    breaker_threshold: int = 2
    #: seconds an open replica breaker waits before the next probe
    breaker_reset_s: float = 1.0
    #: query field naming the cache scope (must match the replicas'
    #: ``--cache-scope-field``); None hashes whole bodies only
    scope_field: str | None = "user"
    #: bounded key→generation affinity map (the never-two-generations
    #: guard); oldest tags are forgotten first
    key_gen_entries: int = 65536
    #: virtual nodes per replica on the hash ring
    vnodes: int = 64
    #: per-replica budget of one rolling-reload rotation (model load +
    #: jit warm-up)
    reload_timeout_s: float = 300.0
    #: longest the rotation waits for a replica's in-flight requests
    drain_wait_s: float = 10.0
    #: >0 enables the stale-while-down cache: the last good
    #: ``/queries.json`` answer per scope is kept this many seconds and
    #: served (marked ``X-PIO-Stale: true``) ONLY when no replica can
    #: serve — never for a scope a live replica could answer fresh
    stale_cache_ttl_s: float = 0.0
    #: bounded entry count of the stale-while-down cache
    stale_cache_entries: int = 1024

    def __post_init__(self) -> None:
        if self.probe_interval_s <= 0:
            raise ValueError("probe_interval_s must be > 0")
        if self.failover_retries < 0:
            raise ValueError("failover_retries must be >= 0")


class _ConnPool:
    """Tiny keep-alive pool of ``http.client`` connections to one
    replica. Handler threads check out/in; any error discards the
    connection (the next checkout dials fresh)."""

    def __init__(self, host: str, port: int, timeout_s: float):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._idle: list[http.client.HTTPConnection] = []

    def get(self) -> http.client.HTTPConnection:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        return http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout_s
        )

    def put(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if len(self._idle) < 32:
                self._idle.append(conn)
                return
        conn.close()

    def close_all(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()


class ReplicaState:
    """Everything the router knows about one backend replica."""

    def __init__(self, replica_id: str, host: str, port: int, config: RouterConfig):
        self.id = replica_id
        self.host = host
        self.port = port
        self.url = f"http://{host}:{port}"
        self.pool = _ConnPool(host, port, config.request_timeout_s)
        self.breaker = CircuitBreaker(
            failure_threshold=config.breaker_threshold,
            reset_timeout_s=config.breaker_reset_s,
            name=f"replica:{replica_id}",
        )
        self._lock = threading.Lock()
        # health (monitor-written, selection-read)
        self.healthy = False
        self.degraded = False
        self.draining = False
        self.draining_until = 0.0  # monotonic; passive Retry-After signal
        self.rolling = False  # excluded while its rolling-reload rotation runs
        self.generation = 0  # last generation the replica reported
        self.reported_id: str | None = None
        self.last_probe_at = 0.0
        self.last_error: str | None = None
        # load / counters
        self.inflight = 0
        self.forwarded = 0
        self.failures = 0

    # ------------------------------------------------------------- signals
    def note_success(self, generation: int | None = None) -> None:
        self.breaker.record_success()
        with self._lock:
            self.healthy = True
            self.forwarded += 1
            if generation is not None and generation > 0:
                self.generation = generation

    def note_transport_failure(self, error: str) -> None:
        self.breaker.record_failure()
        with self._lock:
            self.failures += 1
            # passive detection: don't wait for the next probe to stop
            # routing at a dead socket
            self.healthy = False
            self.last_error = error[:200]

    def note_draining(self, retry_after_s: float) -> None:
        with self._lock:
            self.draining_until = time.monotonic() + max(0.1, retry_after_s)

    def available(self, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            return (
                self.healthy
                and not self.rolling
                and not self.draining
                and now >= self.draining_until
            )

    def begin(self) -> None:
        with self._lock:
            self.inflight += 1

    def end(self) -> None:
        with self._lock:
            self.inflight -= 1

    def to_json(self) -> dict:
        with self._lock:
            return {
                "id": self.id,
                "url": self.url,
                "healthy": self.healthy,
                "degraded": self.degraded,
                "draining": self.draining
                or time.monotonic() < self.draining_until,
                "rolling": self.rolling,
                "generation": self.generation,
                "reportedId": self.reported_id,
                "inflight": self.inflight,
                "forwarded": self.forwarded,
                "failures": self.failures,
                "lastError": self.last_error,
                "breaker": self.breaker.to_json(),
            }


class _RouterStats:
    """Thread-safe router counters for ``GET /stats.json``."""

    _FIELDS = (
        "routed",
        "failovers",
        "redispatch_draining",
        "hedges",
        "hedge_wins",
        "fast_503s",
        "broadcasts",
        "reloads",
        "generation_regressions",
        "passthrough",
        "membership_changes",
        "lease_evictions",
        "stale_served",
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()
        for f in self._FIELDS:
            setattr(self, f, 0)

    def incr(self, name: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + by)

    def to_json(self) -> dict:
        with self._lock:
            camel = {
                "routed": "routed",
                "failovers": "failovers",
                "redispatch_draining": "redispatchDraining",
                "hedges": "hedges",
                "hedge_wins": "hedgeWins",
                "fast_503s": "fast503s",
                "broadcasts": "broadcasts",
                "reloads": "reloads",
                "generation_regressions": "generationRegressions",
                "passthrough": "passthrough",
                "membership_changes": "membershipChanges",
                "lease_evictions": "leaseEvictions",
                "stale_served": "staleServed",
            }
            return {camel[f]: getattr(self, f) for f in self._FIELDS}


class _Wire:
    """Transport-shape response (duck-typed like ``api.service.Response``
    — the fleet package must not import the storage-coupled api.service
    module). ``raw`` carries an already-encoded replica body through
    unchanged; ``body`` is JSON-encoded at send time."""

    __slots__ = ("status", "body", "raw", "headers", "content_type")

    def __init__(
        self,
        status: int,
        body: Any = None,
        raw: bytes | None = None,
        headers: Mapping[str, str] | None = None,
        content_type: str = "application/json; charset=UTF-8",
    ):
        self.status = status
        self.body = body
        self.raw = raw
        self.headers = dict(headers) if headers else None
        self.content_type = content_type

    def json_bytes(self) -> bytes:
        if self.raw is not None:
            return self.raw
        return json.dumps(self.body, default=str).encode()


#: response headers the router forwards back to the client verbatim
_FORWARDED_HEADERS = ("x-pio-replica", "x-pio-generation", "retry-after")


class RouterService:
    """Transport-agnostic router core; served by ``api.http.serve`` like
    every other framework service (``dispatch`` / ``readiness``)."""

    def __init__(
        self,
        replicas: Sequence[tuple[str, str, int]],  # (id, host, port)
        config: RouterConfig | None = None,
        registry: ModelRegistry | None = None,
        split=None,
        endpoint_registry: EndpointRegistry | None = None,
    ):
        self.config = config or RouterConfig()
        self.registry = registry
        #: optional shared EndpointRegistry — when set, it is the single
        #: source of truth for ring membership (reconciled each probe
        #: interval); the ``replicas`` argument is only the initial view
        self.endpoint_registry = endpoint_registry
        #: optional experiments.split.TrafficSplit — A/B assignment is a
        #: pure function of (salt, weights, affinity key), so stickiness
        #: survives router restarts and replica failover by construction
        self.split = split
        self.replicas: list[ReplicaState] = [
            ReplicaState(rid, host, port, self.config)
            for rid, host, port in replicas
        ]
        self._by_id = {r.id: r for r in self.replicas}
        self._ring = HashRing(
            [r.id for r in self.replicas], vnodes=self.config.vnodes
        )
        self._membership_lock = threading.Lock()
        self.stats = _RouterStats()
        # stale-while-down: gen_key → (expires_monotonic, raw, headers)
        self._stale_cache: "collections.OrderedDict[str, tuple]" = (
            collections.OrderedDict()
        )
        self._stale_lock = threading.Lock()
        # query arrival timestamps for the autoscaler's q/s window
        self._query_times: "collections.deque[float]" = collections.deque(
            maxlen=4096
        )
        self.start_time = time.time()
        # bounded key→generation tags (the never-two-generations guard)
        self._key_gens: "collections.OrderedDict[str, int]" = (
            collections.OrderedDict()
        )
        self._key_gens_lock = threading.Lock()
        # last 256 successful query latencies, for the p95 hedge trigger
        self._latencies: "collections.deque[float]" = collections.deque(
            maxlen=256
        )
        self._latencies_lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self._stop_event = threading.Event()
        self._monitor_lock = threading.Lock()
        self._monitor: threading.Thread | None = None
        # wired by the console like QueryService's (GET /stop)
        self.stop_server: Callable[[], Any] | None = None
        self.stop_token: str | None = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Launch the health-monitor thread (idempotent)."""
        with self._monitor_lock:
            if self._monitor is not None and self._monitor.is_alive():
                return
            self._stop_event.clear()
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="fleet-health", daemon=True
            )
            self._monitor.start()

    def close(self) -> None:
        self._stop_event.set()
        for rep in self.replicas:
            rep.pool.close_all()

    def drain(self) -> None:
        """Drain hook discovered by the HTTP wrapper."""
        self.close()

    # -------------------------------------------------------------- probing
    def probe_replica(self, rep: ReplicaState) -> bool:
        """One active /readyz probe; updates the replica's health, drain,
        degraded, and generation state. Returns readiness."""
        try:
            status, raw, _ = self._forward(
                rep,
                "GET",
                "/readyz",
                None,
                timeout_s=self.config.probe_timeout_s,
                count_load=False,
            )
        except TransportError as e:
            rep.breaker.record_failure()
            with rep._lock:
                rep.healthy = False
                rep.last_probe_at = time.monotonic()
                rep.last_error = str(e)[:200]
            return False
        try:
            report = json.loads(raw) if raw else {}
        except json.JSONDecodeError:
            report = {}
        ready = status == 200 and bool(report.get("ready"))
        if ready:
            rep.breaker.record_success()
        with rep._lock:
            rep.healthy = ready
            rep.draining = bool(report.get("draining"))
            rep.degraded = bool(report.get("degraded"))
            gen = report.get("generation")
            if isinstance(gen, int) and gen > 0:
                rep.generation = gen
            rid = report.get("replicaId")
            if isinstance(rid, str):
                rep.reported_id = rid
            rep.last_probe_at = time.monotonic()
            if ready:
                rep.last_error = None
        return ready

    def probe_all(self) -> None:
        for rep in self.replicas:
            self.probe_replica(rep)

    def reconcile_endpoints(self) -> dict:
        """Fold the shared endpoint registry into ring membership:
        announced replicas join, withdrawn/expired ones leave. Expired
        leases are evicted through the registry's rename-claim, so of N
        routers sharing the directory exactly one counts each eviction
        (``leaseEvictions``); every router counts its own local ring
        rebuilds (``membershipChanges``). No-op without a registry."""
        reg = self.endpoint_registry
        if reg is None:
            return {"joined": [], "left": [], "evicted": []}
        evicted = reg.evict_expired()
        if evicted:
            self.stats.incr("lease_evictions", len(evicted))
        live, _expired, problems = reg.snapshot()
        with self._membership_lock:
            current = self._by_id
            live_by_id = {e.replica_id: e for e in live}
            joined = [e for e in live if e.replica_id not in current]
            left = [rid for rid in current if rid not in live_by_id]
            # same id, new address = a respawned replica that re-bound
            # port 0 — must be re-pointed, not just added/removed
            moved = [
                e.replica_id
                for e in live
                if e.replica_id in current
                and (current[e.replica_id].host, current[e.replica_id].port)
                != (e.host, e.port)
            ]
            if not joined and not left and not moved:
                return {"joined": [], "left": [], "evicted": evicted,
                        "problems": problems}
            new_replicas: list[ReplicaState] = []
            for entry in live:
                rep = current.get(entry.replica_id)
                if rep is None or (rep.host, rep.port) != (
                    entry.host, entry.port
                ):
                    rep = ReplicaState(
                        entry.replica_id, entry.host, entry.port, self.config
                    )
                    if entry.generation > 0:
                        rep.generation = entry.generation
                new_replicas.append(rep)
            new_by_id = {r.id: r for r in new_replicas}
            new_ring = HashRing(
                sorted(new_by_id), vnodes=self.config.vnodes
            )
            leavers = [current[rid] for rid in left]
            leavers += [current[rid] for rid in moved]  # stale-address pools
            # readers capture these attributes per access and tolerate
            # by_id/ring skew (missing members are dropped in selection),
            # so plain assignment is the atomic publish
            self._by_id = new_by_id
            self._ring = new_ring
            self.replicas = new_replicas
            self.stats.incr(
                "membership_changes", len(joined) + len(left) + len(moved)
            )
        for rep in leavers:
            rep.pool.close_all()
        if joined or left or moved:
            logger.info(
                "ring membership reconciled: +%s -%s ~%s (evicted %s)",
                [e.replica_id for e in joined], left, moved, evicted,
            )
        return {
            "joined": [e.replica_id for e in joined],
            "left": left,
            "moved": moved,
            "evicted": evicted,
            "problems": problems,
        }

    def _monitor_loop(self) -> None:
        while not self._stop_event.is_set():
            t0 = time.monotonic()
            try:
                self.reconcile_endpoints()
            except OSError as e:  # sharedfs hiccup: keep probing
                logger.warning("endpoint reconcile failed: %s", e)
            self.probe_all()
            elapsed = time.monotonic() - t0
            self._stop_event.wait(
                max(0.01, self.config.probe_interval_s - elapsed)
            )

    # ------------------------------------------------------------ transport
    def _forward(
        self,
        rep: ReplicaState,
        method: str,
        path: str,
        body_bytes: bytes | None,
        timeout_s: float | None = None,
        count_load: bool = True,
        extra_headers: Mapping[str, str] | None = None,
    ) -> tuple[int, bytes, dict]:
        """One HTTP round trip to ``rep``; raises :class:`TransportError`
        on anything below the HTTP layer. Returns
        ``(status, raw body, lowercased headers)``."""
        if timeout_s is not None:
            # custom-deadline calls (probes, reloads) dial fresh: a pooled
            # connection's socket keeps the timeout it connected with, so
            # reusing one here would silently ignore the tighter deadline
            conn = http.client.HTTPConnection(
                rep.host, rep.port, timeout=timeout_s
            )
        else:
            conn = rep.pool.get()
        headers = {"Content-Type": "application/json"}
        if extra_headers:
            headers.update(extra_headers)
        if body_bytes is not None:
            headers["Content-Length"] = str(len(body_bytes))
        if count_load:
            rep.begin()
        try:
            try:
                conn.request(method, path, body=body_bytes, headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
                status = resp.status
                rhdrs = {k.lower(): v for k, v in resp.getheaders()}
                reuse = not resp.will_close
            except (http.client.HTTPException, OSError, ValueError) as e:
                conn.close()
                raise TransportError(f"{type(e).__name__}: {e}") from e
        finally:
            if count_load:
                rep.end()
        if reuse and timeout_s is None:
            rep.pool.put(conn)
        else:
            conn.close()
        return status, raw, rhdrs

    # ------------------------------------------------------------ selection
    def _key_gen_get(self, key: str | None) -> int:
        if key is None:
            return 0
        with self._key_gens_lock:
            return self._key_gens.get(key, 0)

    def _key_gen_put(self, key: str | None, generation: int) -> None:
        if key is None or generation <= 0:
            return
        with self._key_gens_lock:
            prev = self._key_gens.get(key, 0)
            self._key_gens[key] = max(prev, generation)
            self._key_gens.move_to_end(key)
            while len(self._key_gens) > self.config.key_gen_entries:
                self._key_gens.popitem(last=False)

    def _candidates(self, key: str | None, min_gen: int) -> list[ReplicaState]:
        """Selection order: ring order for keyed queries (owner first),
        least-loaded otherwise; unavailable replicas are dropped, and
        replicas whose known generation is behind the key's recorded
        generation sort last (availability still beats affinity — a
        served-below-tag escape is counted, never a refused query)."""
        now = time.monotonic()
        if key is not None:
            ring, by_id = self._ring, self._by_id
            # a reconcile may land between the two attribute reads: a
            # ring member missing from by_id is simply dropped this pass
            order = [
                r
                for r in (by_id.get(m) for m in ring.sequence(key))
                if r is not None
            ]
        else:
            order = sorted(
                self.replicas, key=lambda r: (r.inflight, r.forwarded)
            )
        avail = [r for r in order if r.available(now)]
        if min_gen > 0:
            preferred = [r for r in avail if r.generation >= min_gen]
            behind = [r for r in avail if r.generation < min_gen]
            return preferred + behind
        return avail

    def _all_down_response(self) -> _Wire:
        """Every replica unavailable: answer fast with the failure
        taxonomy — no forwards, no stacked timeouts."""
        self.stats.incr("fast_503s")
        open_breakers = [
            r for r in self.replicas if r.breaker.state != "closed"
        ]
        taxonomy = (
            "breaker_open"
            if len(open_breakers) == len(self.replicas) and self.replicas
            else "no_healthy_replicas"
        )
        retry_after = max(
            [r.breaker.retry_after_s() for r in self.replicas] or [0.0]
        )
        retry_after = max(1, int(retry_after or self.config.probe_interval_s) + 1)
        return _Wire(
            503,
            {
                "message": "No healthy replica available.",
                "taxonomy": taxonomy,
                "replicas": len(self.replicas),
                "retryAfterSeconds": retry_after,
            },
            headers={"Retry-After": str(retry_after)},
        )

    # ----------------------------------------------------------- query path
    def _record_latency(self, seconds: float) -> None:
        with self._latencies_lock:
            self._latencies.append(seconds)
            self._query_times.append(time.monotonic())

    def _p95_s(self) -> float:
        with self._latencies_lock:
            lat = sorted(self._latencies)
        if not lat:
            return 0.0
        return lat[min(len(lat) - 1, int(0.95 * len(lat)))]

    def _hedge_delay_s(self) -> float:
        # p95-triggered with the configured floor: a cold histogram (or a
        # uniformly fast one) never hedges earlier than hedge_ms
        return max(self.config.hedge_ms / 1000.0, self._p95_s())

    def load_snapshot(self, window_s: float = 5.0) -> dict:
        """Router-side load over the trailing window — the autoscaler's
        watermark inputs: queries/second and p99 latency."""
        now = time.monotonic()
        with self._latencies_lock:
            recent = sum(1 for t in self._query_times if now - t <= window_s)
            lat = sorted(self._latencies)
        p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat else 0.0
        return {
            "windowSeconds": window_s,
            "qps": recent / window_s if window_s > 0 else 0.0,
            "p99Seconds": p99,
            "replicas": len(self.replicas),
        }

    # ----------------------------------------------------- stale-while-down
    def _stale_put(self, gen_key: str | None, raw: bytes, headers: dict) -> None:
        if gen_key is None or self.config.stale_cache_ttl_s <= 0:
            return
        expires = time.monotonic() + self.config.stale_cache_ttl_s
        with self._stale_lock:
            self._stale_cache[gen_key] = (expires, raw, dict(headers))
            self._stale_cache.move_to_end(gen_key)
            while len(self._stale_cache) > self.config.stale_cache_entries:
                self._stale_cache.popitem(last=False)

    def _stale_response(self, gen_key: str | None) -> _Wire | None:
        """The bounded-TTL last-good answer for this scope, explicitly
        marked ``X-PIO-Stale`` — called ONLY from the no-candidate-can-
        serve paths, so a fresh-capable scope never sees it."""
        if gen_key is None or self.config.stale_cache_ttl_s <= 0:
            return None
        with self._stale_lock:
            entry = self._stale_cache.get(gen_key)
            if entry is None:
                return None
            expires, raw, headers = entry
            if time.monotonic() >= expires:
                del self._stale_cache[gen_key]
                return None
        self.stats.incr("stale_served")
        out = dict(headers)
        out["X-PIO-Stale"] = "true"
        return _Wire(200, raw=raw, headers=out)

    def _forward_query(
        self,
        rep: ReplicaState,
        body_bytes: bytes,
        extra_headers: Mapping[str, str] | None = None,
    ) -> tuple[int, bytes, dict]:
        t0 = time.monotonic()
        result = self._forward(
            rep, "POST", "/queries.json", body_bytes,
            extra_headers=extra_headers,
        )
        self._record_latency(time.monotonic() - t0)
        return result

    def _forward_hedged(
        self,
        rep: ReplicaState,
        backup: ReplicaState | None,
        body_bytes: bytes,
        extra_headers: Mapping[str, str] | None = None,
    ) -> tuple[ReplicaState, int, bytes, dict]:
        """Primary forward with one optional hedge: first answer wins.
        Raises TransportError only when every launched attempt failed."""
        results: "queue.Queue" = queue.Queue()

        def attempt(r: ReplicaState) -> None:
            try:
                results.put(
                    (r, self._forward_query(r, body_bytes, extra_headers))
                )
            except TransportError as e:
                r.note_transport_failure(str(e))
                results.put((r, e))

        threading.Thread(
            target=attempt, args=(rep,), name="fleet-fwd", daemon=True
        ).start()
        launched = 1
        try:
            winner, outcome = results.get(timeout=self._hedge_delay_s())
        except queue.Empty:
            winner, outcome = None, None
        if winner is None and backup is not None:
            self.stats.incr("hedges")
            threading.Thread(
                target=attempt, args=(backup,), name="fleet-hedge", daemon=True
            ).start()
            launched += 1
        failures: list[TransportError] = []
        while True:
            if winner is None:
                try:
                    winner, outcome = results.get(
                        timeout=self.config.request_timeout_s + 5.0
                    )
                except queue.Empty:
                    # every launched attempt outlived the total budget
                    # (per-read socket timeouts never fired on a
                    # slow-drip response): surface a routed transport
                    # failure, not a naked exception — the abandoned
                    # threads' eventual results are discarded
                    raise TransportError(
                        "hedged request exceeded the request deadline "
                        "on every attempt"
                    ) from None
            if isinstance(outcome, TransportError):
                failures.append(outcome)
                if len(failures) >= launched:
                    raise failures[0]
                winner, outcome = None, None
                continue
            if launched > 1 and winner is backup:
                self.stats.incr("hedge_wins")
            return winner, outcome[0], outcome[1], outcome[2]

    def route_query(self, body: Any, params: Mapping[str, str]) -> _Wire:
        """The /queries.json path: hash-affine selection, breaker gating,
        draining re-dispatch, bounded failover, optional hedging."""
        try:
            body_bytes = json.dumps(body, default=str).encode()
        except (TypeError, ValueError):
            return _Wire(400, {"message": "Query body is required (JSON)."})
        key = affinity_key(body, self.config.scope_field)
        variant = self.split.assign(key) if self.split is not None else None
        # per-variant generation streams: during a promotion rollout two
        # variants may legitimately serve the same scope from different
        # generations, so the never-two-generations guard tracks
        # (variant, key) — variant names cannot contain "|" (validated in
        # experiments.split), so the tag cannot collide with a raw key
        gen_key = (
            f"{variant}|{key}"
            if variant is not None and key is not None
            else key
        )
        variant_headers = (
            {"X-PIO-Variant": variant} if variant is not None else None
        )
        min_gen = self._key_gen_get(gen_key)
        candidates = self._candidates(key, min_gen)
        if not candidates:
            stale = self._stale_response(gen_key)
            if stale is not None:
                return stale
            return self._all_down_response()
        failovers = 0
        last_503: _Wire | None = None
        tried: set[str] = set()
        while True:
            rep = next(
                (
                    r
                    for r in candidates
                    if r.id not in tried and r.available()
                ),
                None,
            )
            if rep is None:
                break
            tried.add(rep.id)
            if not rep.breaker.acquire():
                continue  # open circuit: skip without touching the socket
            hedge_backup = None
            if self.config.hedge_ms > 0:
                hedge_backup = next(
                    (
                        r
                        for r in candidates
                        if r.id not in tried
                        and r.id != rep.id
                        and r.available()
                    ),
                    None,
                )
            t_fwd = time.monotonic()
            try:
                if hedge_backup is not None:
                    rep, status, raw, rhdrs = self._forward_hedged(
                        rep, hedge_backup, body_bytes, variant_headers
                    )
                    tried.add(rep.id)
                else:
                    status, raw, rhdrs = self._forward_query(
                        rep, body_bytes, variant_headers
                    )
            except TransportError as e:
                if hedge_backup is None:
                    # the hedged path already recorded each failed
                    # attempt inside _forward_hedged — recording again
                    # here would open the primary's breaker at half the
                    # configured threshold
                    rep.note_transport_failure(str(e))
                if failovers < self.config.failover_retries:
                    failovers += 1
                    self.stats.incr("failovers")
                    continue
                if variant is not None:
                    self.split.note_routed(
                        variant, time.monotonic() - t_fwd, ok=False
                    )
                return _Wire(
                    502,
                    {
                        "message": "Replica failed mid-request and the "
                        "failover budget is exhausted.",
                        "replica": rep.id,
                        "failovers": failovers,
                        "error": str(e)[:200],
                    },
                )
            if status == 503 and "retry-after" in rhdrs:
                # draining replica (the drain contract): routing
                # signal, not a client answer — mark and re-dispatch,
                # without consuming the failover budget
                try:
                    retry_after = float(rhdrs["retry-after"])
                except ValueError:
                    retry_after = 1.0
                rep.note_draining(retry_after)
                self.stats.incr("redispatch_draining")
                last_503 = _Wire(
                    status, raw=raw,
                    headers={"Retry-After": rhdrs["retry-after"]},
                )
                continue
            gen = 0
            try:
                gen = int(rhdrs.get("x-pio-generation", "0"))
            except ValueError:
                pass
            rep.note_success(gen or None)
            served_gen = gen or rep.generation
            if min_gen > 0 and 0 < served_gen < min_gen:
                # availability beat affinity: an older generation served a
                # key the newer one already answered — surfaced, counted,
                # and asserted zero during orderly rollouts
                self.stats.incr("generation_regressions")
            self._key_gen_put(gen_key, served_gen)
            self.stats.incr("routed")
            if variant is not None:
                self.split.note_routed(
                    variant, time.monotonic() - t_fwd, ok=status == 200
                )
            out_headers = {
                k.title(): v
                for k, v in rhdrs.items()
                if k in _FORWARDED_HEADERS
            }
            out_headers["X-PIO-Routed-Replica"] = rep.id
            if variant is not None:
                out_headers["X-PIO-Variant"] = variant
            if status == 200:
                self._stale_put(gen_key, raw, out_headers)
            return _Wire(status, raw=raw, headers=out_headers)
        if last_503 is not None:
            # every peer was also draining/down: the drain 503 (with its
            # Retry-After) is the truthful answer
            return last_503
        # every candidate was tried and is down: the last good answer
        # (explicitly marked stale) beats a 503 for a read-shaped query
        stale = self._stale_response(gen_key)
        if stale is not None:
            return stale
        return self._all_down_response()

    # ------------------------------------------------------------ broadcast
    def broadcast(
        self, method: str, path: str, body: Any, retries: int = 1
    ) -> dict:
        """Deliver one request to EVERY replica (invalidations must reach
        all R caches). Per-replica transport failures retry ``retries``
        times; results are reported per replica. Safe to retry because
        the broadcast routes are idempotent (cache invalidation; event-
        shaped bodies additionally carry deterministic eventIds)."""
        try:
            body_bytes = (
                json.dumps(body, default=str).encode()
                if body is not None
                else None
            )
        except (TypeError, ValueError):
            return {"ok": False, "error": "unserializable body"}
        results: dict[str, dict] = {}
        lock = threading.Lock()

        def deliver(rep: ReplicaState) -> None:
            # a replica that is DOWN before we even try cannot be holding
            # cache entries the invalidation needs to kill: whenever it
            # comes back (respawn, reload) its result cache starts cold,
            # so failed delivery to it is a safe skip, not a lost
            # invalidation. Delivery failure to a replica that WAS
            # serving stays loudly partial (502).
            was_available = rep.available()
            outcome: dict = {}
            for _ in range(retries + 1):
                try:
                    status, raw, _h = self._forward(rep, method, path, body_bytes)
                except TransportError as e:
                    rep.note_transport_failure(str(e))
                    outcome = {"ok": False, "error": str(e)[:200]}
                    continue
                try:
                    payload = json.loads(raw) if raw else None
                except json.JSONDecodeError:
                    payload = None
                outcome = {"ok": 200 <= status < 300, "status": status,
                           "body": payload}
                break
            if not outcome.get("ok") and not was_available:
                outcome = dict(
                    outcome,
                    ok=True,
                    skipped="replica down before delivery — its cache "
                    "is cold when it returns",
                )
            with lock:
                results[rep.id] = outcome

        threads = [
            threading.Thread(
                target=deliver, args=(rep,), name=f"fleet-bcast-{rep.id}",
                daemon=True,
            )
            for rep in self.replicas
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.config.request_timeout_s + 5.0)
        self.stats.incr("broadcasts")
        return {
            "ok": all(r.get("ok") for r in results.values()) and bool(results),
            "replicas": results,
        }

    # --------------------------------------------------------- rolling swap
    def rolling_reload(self) -> tuple[int, dict]:
        """Rotate ``/reload`` through the fleet one replica at a time,
        reusing the drain semantics: the rotating replica stops receiving
        new work, finishes what it has, reloads, and must come back ready
        at a NEWER generation before the next rotation starts. Returns
        ``(http status, report)``."""
        if not self._reload_lock.acquire(blocking=False):
            return 409, {"message": "A rolling reload is already running."}
        try:
            self.stats.incr("reloads")
            target = self.registry.current() if self.registry else None
            report: dict[str, Any] = {
                "replicas": {},
                "registryGeneration": target.generation if target else None,
                "registryInstanceId": (
                    target.engine_instance_id if target else None
                ),
            }
            if target is not None and target.artifacts:
                # artifact-readiness gate (pio train --aot): the target
                # generation declares an AOT artifact set, so verify it —
                # stdlib manifest parse + blob size/sha256 (registry.py)
                # — BEFORE rotating a single replica. Rotating onto a
                # missing/torn artifact dir would demote the whole fleet
                # to JIT fallback at once, the exact cold-start spike AOT
                # exists to remove; failing the rotation here keeps every
                # replica serving warm while the operator re-exports.
                # Fingerprint matching stays the replicas' job.
                from predictionio_tpu_torch.fleet.registry import (
                    verify_aot_artifacts,
                )

                adir = target.artifacts.get("dir", "")
                check = verify_aot_artifacts(adir) if adir else {
                    "ok": False,
                    "problems": ["artifact stamp carries no dir"],
                }
                report["artifactCheck"] = {
                    "dir": adir,
                    "ok": check["ok"],
                    "problems": check.get("problems", []),
                }
                if not check["ok"]:
                    report["ok"] = False
                    report["error"] = (
                        "registry generation declares AOT artifacts but "
                        "the artifact set failed verification; rotation "
                        "aborted before touching any replica"
                    )
                    return 500, report
            ok = True
            for rep in self.replicas:
                entry: dict[str, Any] = {"generationBefore": rep.generation}
                old_gen = rep.generation
                with rep._lock:
                    rep.rolling = True
                try:
                    # drain semantics: new work already routes around the
                    # rolling replica; wait (bounded) for in-flight work
                    deadline = time.monotonic() + self.config.drain_wait_s
                    while rep.inflight > 0 and time.monotonic() < deadline:
                        time.sleep(0.02)
                    try:
                        status, raw, _h = self._forward(
                            rep, "POST", "/reload", b"{}",
                            timeout_s=self.config.reload_timeout_s,
                        )
                    except TransportError as e:
                        rep.note_transport_failure(str(e))
                        entry["error"] = str(e)[:200]
                        ok = False
                        break
                    if status != 200:
                        entry["error"] = f"/reload answered {status}"
                        entry["body"] = raw[:300].decode("utf-8", "replace")
                        ok = False
                        break
                    # gate the rotation on the replica converging: ready
                    # AND generation advanced past the pre-reload one
                    deadline = time.monotonic() + self.config.reload_timeout_s
                    converged = False
                    while time.monotonic() < deadline:
                        if (
                            self.probe_replica(rep)
                            and rep.generation > old_gen
                        ):
                            converged = True
                            break
                        time.sleep(
                            min(0.05, self.config.probe_interval_s)
                        )
                    if not converged:
                        entry["error"] = (
                            "replica did not report a newer generation "
                            "after /reload"
                        )
                        ok = False
                        break
                finally:
                    with rep._lock:
                        rep.rolling = False
                    entry["generationAfter"] = rep.generation
                    report["replicas"][rep.id] = entry
            generations = {r.generation for r in self.replicas}
            report["converged"] = len(generations) == 1
            report["generations"] = sorted(generations)
            report["ok"] = ok and report["converged"]
            if report["ok"] and self.registry is not None and self.replicas:
                # stamp what the fleet actually converged to: the served
                # instance id comes from a replica's own status, so the
                # registry records rollout truth, not intent
                try:
                    _s, raw, _h = self._forward(
                        self.replicas[0], "GET", "/", None
                    )
                    inst = (json.loads(raw) or {}).get("engineInstanceId")
                except (TransportError, json.JSONDecodeError):
                    inst = None
                if inst and (
                    target is None or target.engine_instance_id != inst
                ):
                    record = self.registry.publish(  # piolint: waive=PIO211 -- reload lock is try-acquire: contenders bail with 409 instead of convoying, and publishing the new generation durably is part of the rotation by design
                        inst, meta={"source": "rolling_reload"}
                    )
                    report["registryGeneration"] = record.generation
                    report["registryInstanceId"] = inst
            return (200 if report["ok"] else 500), report
        finally:
            self._reload_lock.release()

    # ---------------------------------------------------------- passthrough
    def _passthrough(
        self, method: str, path: str, params: Mapping[str, str], body: Any
    ) -> _Wire:
        """Any other route: forward to one healthy replica. Only
        idempotent requests (GETs) may fail over after a transport error;
        a non-idempotent POST body is never re-sent — the client gets the
        502 and decides."""
        try:
            body_bytes = (
                json.dumps(body, default=str).encode()
                if body is not None
                else None
            )
        except (TypeError, ValueError):
            return _Wire(400, {"message": "Malformed body."})
        qs = urllib.parse.urlencode(dict(params))
        target = path + (f"?{qs}" if qs else "")
        idempotent = method == "GET"
        attempts = (self.config.failover_retries + 1) if idempotent else 1
        candidates = self._candidates(None, 0)
        if not candidates:
            return self._all_down_response()
        last_error = "no candidate attempted"
        for rep in candidates[:attempts]:
            if not rep.breaker.acquire():
                continue
            try:
                status, raw, rhdrs = self._forward(
                    rep, method, target, body_bytes
                )
            except TransportError as e:
                rep.note_transport_failure(str(e))
                last_error = str(e)[:200]
                if not idempotent:
                    return _Wire(
                        502,
                        {
                            "message": "Replica failed mid-request; this "
                            "route is not idempotent, so the request was "
                            "not retried.",
                            "replica": rep.id,
                            "error": last_error,
                        },
                    )
                continue
            rep.note_success()
            self.stats.incr("passthrough")
            out_headers = {
                k.title(): v
                for k, v in rhdrs.items()
                if k in _FORWARDED_HEADERS
            }
            out_headers["X-PIO-Routed-Replica"] = rep.id
            return _Wire(status, raw=raw, headers=out_headers)
        return _Wire(
            502,
            {"message": "Every candidate replica failed.", "error": last_error},
        )

    # -------------------------------------------------------------- status
    def generation_converged(self) -> int | None:
        gens = {r.generation for r in self.replicas}
        if len(gens) == 1:
            return next(iter(gens))
        return None

    def status_json(self) -> dict:
        return {
            "status": "alive",
            "role": "router",
            "replicas": [r.to_json() for r in self.replicas],
            "generation": self.generation_converged(),
            "generationConverged": self.generation_converged() is not None,
            "registry": (
                self.registry.current().to_json()
                if self.registry and self.registry.current()
                else None
            ),
            "stats": self.stats.to_json(),
        }

    def stats_json(self, fanout: bool = False) -> dict:
        out: dict[str, Any] = {
            "role": "router",
            "router": self.stats.to_json(),
            "replicas": [r.to_json() for r in self.replicas],
            "generation": self.generation_converged(),
            "p95Seconds": round(self._p95_s(), 6),
        }
        if self.split is not None:
            out["experiments"] = self.split.stats_json()
        if fanout:
            details: dict[str, Any] = {}
            for rep in self.replicas:
                try:
                    _s, raw, _h = self._forward(rep, "GET", "/stats.json", None)
                    details[rep.id] = json.loads(raw)
                except (TransportError, json.JSONDecodeError) as e:
                    details[rep.id] = {"error": str(e)[:200]}
            out["replicaStats"] = details
        return out

    def endpoints_json(self) -> dict:
        """``GET /fleet/endpoints.json``: the registry's HTTP read API —
        live entries (with lease ages), expired-but-unevicted entries,
        torn-file problems, and this router's current ring view."""
        now = time.time()
        reg = self.endpoint_registry
        doc: dict[str, Any] = {
            "registry": None,
            "ring": sorted(self._by_id),
            "replicas": [r.to_json() for r in self.replicas],
            "membershipChanges": self.stats.membership_changes,
            "leaseEvictions": self.stats.lease_evictions,
        }
        if reg is None:
            return doc
        live, expired, problems = reg.snapshot(now)
        doc["registry"] = {
            "directory": reg.directory,
            "leaseTtlSeconds": reg.lease_ttl_s,
            "live": [
                dict(e.to_json(), leaseAgeSeconds=round(e.lease_age_s(now), 3))
                for e in live
            ],
            "expired": [e.to_json() for e in expired],
            "problems": problems,
        }
        return doc

    def readiness(self) -> dict:
        """Router /readyz: ready while at least one replica can serve."""
        now = time.monotonic()
        healthy = sum(1 for r in self.replicas if r.available(now))
        return {
            "ready": healthy > 0,
            "checks": {
                "replicas": {
                    "ok": healthy > 0,
                    "healthy": healthy,
                    "total": len(self.replicas),
                }
            },
            "role": "router",
            "generation": self.generation_converged(),
        }

    # ---------------------------------------------------------- experiments
    def experiments_json(self) -> dict:
        """``GET /experiments.json``: the live experiment — config,
        per-variant counters, and the promotion stamp (plus the registry
        record a promotion published, when one exists)."""
        out: dict[str, Any] = self.split.stats_json()
        out["scopeField"] = self.config.scope_field
        if self.registry is not None:
            current = self.registry.current()
            meta = getattr(current, "meta", None) if current else None
            if isinstance(meta, dict) and meta.get("source") == (
                "experiment_promotion"
            ):
                out["registryPromotion"] = {
                    "generation": current.generation,
                    "engineInstanceId": current.engine_instance_id,
                    "variant": meta.get("variant"),
                }
        return out

    def promote_experiment(self, body: Any) -> tuple[int, dict]:
        """``POST /experiments/promote.json`` ``{"variant": name}``:
        collapse traffic onto the winner, stamp the outcome into the
        model registry, and rotate the fleet through a rolling reload so
        every replica converges on one generation with zero failed
        queries (the drain semantics)."""
        name = (body or {}).get("variant") if isinstance(body, dict) else None
        if not isinstance(name, str) or not name:
            return 400, {
                "message": 'Promotion body must be {"variant": "<name>"}.'
            }
        try:
            promotion = self.split.promote(name)
        except ValueError as e:
            return 404, {"message": str(e)}
        report: dict[str, Any] = {"promotion": promotion}
        if self.registry is not None and self.replicas:
            # stamp rollout truth: the instance id the fleet is actually
            # serving, read from a replica, not deployment intent
            inst = None
            for rep in self.replicas:
                try:
                    _s, raw, _h = self._forward(rep, "GET", "/", None)
                    inst = (json.loads(raw) or {}).get("engineInstanceId")
                except (TransportError, json.JSONDecodeError):
                    continue
                if inst:
                    break
            if inst:
                record = self.registry.publish(
                    inst,
                    meta={
                        "source": "experiment_promotion",
                        "variant": name,
                        "weightsBefore": promotion.get("weightsBefore"),
                    },
                )
                report["registry"] = {
                    "generation": record.generation,
                    "engineInstanceId": inst,
                }
        status, reload_report = self.rolling_reload()
        report["reload"] = reload_report
        report["ok"] = status == 200
        return (200 if status == 200 else 500), report

    def reward_experiment(self, body: Any) -> tuple[int, dict]:
        """``POST /experiments/reward.json``: fold reward observations
        into the per-variant counters. Each item names its variant
        explicitly, or carries the original query body's scope fields so
        the router re-derives the assignment (same pure function that
        routed it)."""
        items = body if isinstance(body, list) else [body]
        matched = 0
        for item in items:
            if not isinstance(item, dict):
                continue
            variant = item.get("variant")
            if not isinstance(variant, str) or not variant:
                key = affinity_key(item, self.config.scope_field)
                if key is None:
                    continue
                variant = self.split.assign(key)
            value = item.get("value", 1.0)
            if variant in self.split.variant_names():
                self.split.note_reward(variant, value)
                matched += 1
        return 200, {
            "matched": matched,
            "experiments": self.split.stats_json(),
        }

    # ------------------------------------------------------------- dispatch
    def dispatch(
        self,
        method: str,
        path: str,
        params: Mapping[str, str],
        body: Any = None,
        headers: Mapping[str, str] | None = None,
        form: Mapping[str, str] | None = None,
    ) -> _Wire:
        method = method.upper()
        if path == "/" and method == "GET":
            return _Wire(200, self.status_json())
        if path == "/queries.json" and method == "POST":
            return self.route_query(body, params)
        if path == "/cache/invalidate.json" and method == "POST":
            result = self.broadcast(method, path, body)
            return _Wire(200 if result.get("ok") else 502, result)
        if path == "/stats.json" and method == "GET":
            return _Wire(
                200, self.stats_json(fanout=params.get("fanout") == "1")
            )
        if path == "/fleet/endpoints.json" and method == "GET":
            return _Wire(200, self.endpoints_json())
        if path == "/reload" and method == "POST":
            status, report = self.rolling_reload()
            return _Wire(status, report)
        if path.startswith("/experiments") and self.split is None:
            return _Wire(
                404,
                {
                    "message": "No experiment is configured on this fleet "
                    "(deploy with --variants name:weight,...)."
                },
            )
        if path == "/experiments.json" and method == "GET":
            return _Wire(200, self.experiments_json())
        if path == "/experiments/promote.json" and method == "POST":
            status, report = self.promote_experiment(body)
            return _Wire(status, report)
        if path == "/experiments/reward.json" and method == "POST":
            status, report = self.reward_experiment(body)
            return _Wire(status, report)
        if path == "/stop" and method == "GET":
            presented = ""
            if headers:
                presented = next(
                    (
                        v
                        for k, v in headers.items()
                        if k.lower() == "x-pio-stop-token"
                    ),
                    "",
                )
            presented = presented or params.get("token", "")
            if self.stop_token and not _token_ok(presented, self.stop_token):
                return _Wire(403, {"message": "Missing or invalid stop token."})
            if self.stop_server is None:
                return _Wire(501, {"message": "This router has no stop hook."})
            self.stop_server()
            return _Wire(200, {"message": "Shutting down fleet."})
        return self._passthrough(method, path, params, body)
