"""Query-path caching & request coalescing for the online serving path.

Counterpart of ``predictionio_tpu/serving/cache.py`` (a copy with the
port's imports). Three individually opt-in tiers:

* **Singleflight coalescing** (:class:`Singleflight`) — identical
  in-flight queries (canonical-JSON key, per model generation) collapse
  into ONE scored computation whose result fans out to every waiter;
  only the flight leader submits to the micro-batcher, so a batch never
  holds duplicate work.
* **Result LRU cache** (:class:`ResultCache`) — bounded entries AND
  bytes, per-entry TTL, and *event-driven invalidation*: ``/reload`` and
  write hooks bump per-model / per-scope generation counters so stale
  entries die on write rather than only on TTL. Fills snapshot the
  generations they were computed under (:meth:`ResultCache.reserve`) and
  are dropped at commit time if an invalidation won the race.
* **Pinned scoring state** — :attr:`CacheConfig.pin_model`, served by
  :mod:`predictionio_tpu_torch.workflow.device_state` (this package
  imports neither torch nor jax), observable via
  :attr:`CacheStats.bytes_pinned`.

Everything surfaces on the query server's ``GET /stats.json`` through
:class:`CacheStats`. An all-off :class:`CacheConfig` (or none) leaves
the query path as it is without one.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Iterable, Mapping

__all__ = [
    "CacheConfig",
    "CacheStats",
    "ResultCache",
    "Singleflight",
    "affinity_key",
    "canonical_key",
]

#: a follower waiting on a flight whose leader never answers (a bug, not
#: a slow model) must not hang the HTTP handler thread forever — same
#: contract as the micro-batcher's result timeout
_FLIGHT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Knobs of the query-path cache (CLI: ``pio deploy --result-cache
    --coalesce --pin-model ...``). Each tier is individually opt-in; the
    all-default config enables nothing."""

    #: serve repeated identical queries from an in-memory LRU
    result_cache: bool = False
    #: most entries the LRU holds (oldest evicted first)
    result_cache_entries: int = 4096
    #: seconds an entry may serve before it expires (<= 0: no TTL —
    #: entries die only by eviction or invalidation)
    result_cache_ttl_s: float = 30.0
    #: approximate payload-byte budget for the LRU (<= 0: unbounded)
    result_cache_max_bytes: int = 64 * 1024 * 1024
    #: collapse identical in-flight queries into one computation
    coalesce: bool = False
    #: pin model state (factor matrices, jitted score+top-K programs)
    #: device-resident across requests — see workflow/device_state.py
    pin_model: bool = False
    #: pin factor SHARDS per device instead of a replica (``pio deploy
    #: --shard-factors``): per-device factor memory drops to
    #: ``O(table / num_devices)`` so catalogs bigger than one device's
    #: memory serve; top-K stays tie-stable-identical to the replicated
    #: exact path (parallel/sharding.py). Implies device residency.
    shard_factors: bool = False
    #: serve factor tables (and IVF slabs under ``--ann``) as int8
    #: codes + per-row f32 scales (``pio deploy --quantize int8``,
    #: ops/quant.py): ~4x more catalog per device and ~4x less gather
    #: traffic, recall-guarded by the two-stage int8-coarse/f32-rescore
    #: kernels. None (default) serves f32 everywhere; composes
    #: multiplicatively with ``shard_factors``. Implies device
    #: residency.
    quantize: str | None = None
    #: query field whose value names the per-entity invalidation scope
    #: (``"user"`` for the recommendation templates); None disables
    #: per-scope invalidation (only full flushes apply)
    scope_field: str | None = "user"

    def __post_init__(self) -> None:
        if self.result_cache_entries < 1:
            raise ValueError("result_cache_entries must be >= 1")
        if self.quantize not in (None, "int8"):
            raise ValueError(
                f"unsupported quantize mode {self.quantize!r} (int8)"
            )

    @property
    def enabled(self) -> bool:
        """Does any tier change the serving path at all?"""
        return (
            self.result_cache
            or self.coalesce
            or self.pin_model
            or self.shard_factors
            or self.quantize is not None
        )


def canonical_key(body: Any) -> str | None:
    """Canonical-JSON cache key of a query body: stable across dict
    ordering, so ``{"user": "1", "num": 4}`` and ``{"num": 4, "user":
    "1"}`` coalesce. None for bodies that do not serialize (those bypass
    the cache and singleflight entirely)."""
    try:
        return json.dumps(
            body, sort_keys=True, separators=(",", ":"), allow_nan=False
        )
    except (TypeError, ValueError):
        return None


class CacheStats:
    """Thread-safe counters for every cache tier, serialized into the
    ``cache`` section of the query server's ``GET /stats.json``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.coalesced = 0  # followers served by another flight's result
        self.flights = 0  # singleflight leaders (distinct computations)
        self.evictions_entries = 0  # LRU-capacity evictions
        self.evictions_bytes = 0  # byte-budget evictions
        self.expirations = 0  # TTL deaths observed at get()
        self.invalidations_scope = 0  # per-scope generation bumps
        self.invalidations_full = 0  # full flushes (reload/degraded/all)
        self.stale_drops = 0  # fills dropped: invalidation won the race
        self.uncacheable = 0  # bodies canonical_key() rejected
        self.entries = 0  # gauge
        self.bytes = 0  # gauge (approximate payload bytes)
        self.bytes_pinned = 0  # gauge: device-resident model state
        #: gauge: per-dtype breakdown of bytes_pinned, read from the
        #: ACTUAL pinned arrays (f32 vs int8 codes vs their scales) —
        #: the bench asserts served truth here, not shape math
        self.bytes_by_dtype: dict = {}
        self.factor_shards = 0  # gauge: --shard-factors model-axis size
        self.model_generation = 0  # gauge

    def incr(self, name: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + by)

    def set_gauge(self, name: str, value: int) -> None:
        with self._lock:
            setattr(self, name, value)

    def to_json(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "stores": self.stores,
                "coalesced": self.coalesced,
                "flights": self.flights,
                "evictions": {
                    "entries": self.evictions_entries,
                    "bytes": self.evictions_bytes,
                },
                "expirations": self.expirations,
                "invalidations": {
                    "scope": self.invalidations_scope,
                    "full": self.invalidations_full,
                },
                "staleDrops": self.stale_drops,
                "uncacheable": self.uncacheable,
                "entries": self.entries,
                "bytes": self.bytes,
                "bytesPinned": self.bytes_pinned,
                "bytesByDtype": dict(self.bytes_by_dtype),
                "factorShards": self.factor_shards,
                "modelGeneration": self.model_generation,
            }


def _payload_nbytes(value: Any) -> int:
    """Approximate retained size of a cached ``(status, payload)``:
    JSON-serialized length is a good proxy for the dict/list/str graph
    and costs one dumps — exact ``getsizeof`` graph walks are slower and
    no more honest."""
    try:
        return len(json.dumps(value, default=str)) + 64
    except (TypeError, ValueError):
        return sys.getsizeof(value)


class _Entry:
    __slots__ = ("value", "expires_at", "model_gen", "scope", "scope_gen", "nbytes")

    def __init__(self, value, expires_at, model_gen, scope, scope_gen, nbytes):
        self.value = value
        self.expires_at = expires_at
        self.model_gen = model_gen
        self.scope = scope
        self.scope_gen = scope_gen
        self.nbytes = nbytes


@dataclasses.dataclass(frozen=True)
class FillToken:
    """Generation snapshot taken at miss time (:meth:`ResultCache
    .reserve`); :meth:`ResultCache.commit` stores the fill only if the
    generations are STILL current — the no-stale-resurrect guarantee."""

    key: str
    scope: str | None
    model_gen: int
    scope_gen: int


class ResultCache:
    """LRU + TTL + generation-invalidated result cache (thread-safe).

    Invalidation is generation-based, not key-scan-based: bumping a
    scope's (or the model's) generation makes every entry recorded under
    the old generation unservable immediately, in O(1), without knowing
    which keys belong to the scope. Dead entries are reaped lazily on
    ``get`` and by LRU/byte eviction; a full flush drops them eagerly.
    """

    def __init__(self, config: CacheConfig, stats: CacheStats | None = None):
        self.config = config
        self.stats = stats or CacheStats()
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._bytes = 0
        self._model_gen = 0
        # per-scope generation counters, themselves LRU-bounded so a
        # scope-scan cannot grow the map without limit (piolint PIO205
        # lints exactly this class of leak)
        self._scope_gens: "OrderedDict[str, int]" = OrderedDict()
        self._max_scopes = max(16, config.result_cache_entries * 4)

    # ------------------------------------------------------------- internals
    def _scope_gen(self, scope: str | None) -> int:
        """Current generation of ``scope`` (0 = never invalidated).
        Caller holds the lock."""
        if scope is None:
            return 0
        gen = self._scope_gens.get(scope)
        if gen is None:
            return 0
        self._scope_gens.move_to_end(scope)
        return gen

    def _drop(self, key: str, entry: _Entry) -> int:
        """Remove ``key``; returns the entry's bytes so the CALLER (who
        holds the lock) adjusts ``self._bytes`` under it."""
        del self._entries[key]
        return entry.nbytes

    def _sync_gauges(self) -> None:
        """Caller holds the lock."""
        self.stats.set_gauge("entries", len(self._entries))
        self.stats.set_gauge("bytes", self._bytes)

    # ------------------------------------------------------------ public API
    def get(self, key: str):
        """``(hit, value)``. A TTL-expired or generation-stale entry is
        reaped here and reported as a miss. The entry's invalidation
        scope was recorded at :meth:`reserve` time — the lookup validates
        against that, so no scope argument is needed (or consulted)."""
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                if entry.expires_at is not None and now >= entry.expires_at:
                    self._bytes -= self._drop(key, entry)
                    self.stats.incr("expirations")
                    entry = None
                elif (
                    entry.model_gen != self._model_gen
                    or entry.scope_gen != self._scope_gen(entry.scope)
                ):
                    self._bytes -= self._drop(key, entry)
                    entry = None
                else:
                    self._entries.move_to_end(key)
            self._sync_gauges()
        if entry is None:
            self.stats.incr("misses")
            return False, None
        self.stats.incr("hits")
        return True, entry.value

    def reserve(self, key: str, scope: str | None = None) -> FillToken:
        """Snapshot the generations a fill is being computed under."""
        with self._lock:
            return FillToken(key, scope, self._model_gen, self._scope_gen(scope))

    def commit(self, token: FillToken, value: Any) -> bool:
        """Store a computed fill — unless an invalidation won the race
        since :meth:`reserve`, in which case the fill is dropped (a stale
        result must never resurrect past its invalidation). Returns
        whether the value was stored."""
        cfg = self.config
        # the KEY (the canonical query body) and scope are retained too —
        # excluding them would let large distinct query bodies blow past
        # the byte budget while it reads near-zero
        nbytes = (
            _payload_nbytes(value)
            + len(token.key)
            + len(token.scope or "")
        )
        expires_at = (
            time.monotonic() + cfg.result_cache_ttl_s
            if cfg.result_cache_ttl_s > 0
            else None
        )
        with self._lock:
            if (
                token.model_gen != self._model_gen
                or token.scope_gen != self._scope_gen(token.scope)
            ):
                self.stats.incr("stale_drops")
                return False
            old = self._entries.pop(token.key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[token.key] = _Entry(
                value, expires_at, token.model_gen, token.scope,
                token.scope_gen, nbytes,
            )
            self._bytes += nbytes
            while len(self._entries) > cfg.result_cache_entries:
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= evicted.nbytes
                self.stats.incr("evictions_entries")
            if cfg.result_cache_max_bytes > 0:
                while self._bytes > cfg.result_cache_max_bytes and self._entries:
                    _, evicted = self._entries.popitem(last=False)
                    self._bytes -= evicted.nbytes
                    self.stats.incr("evictions_bytes")
            self._sync_gauges()
        self.stats.incr("stores")
        return True

    def invalidate_scope(self, scope: str) -> None:
        """Write hook: a new event about ``scope`` (user/entity) makes
        every entry computed for it stale NOW, not at TTL."""
        with self._lock:
            self._scope_gens[scope] = self._scope_gens.get(scope, 0) + 1
            self._scope_gens.move_to_end(scope)
            while len(self._scope_gens) > self._max_scopes:
                # evicting a scope counter forgets its bump history; any
                # surviving entries of that scope read gen 0 and would
                # resurrect, so reap them eagerly first
                evicted_scope, _ = self._scope_gens.popitem(last=False)
                for key in [
                    k
                    for k, e in self._entries.items()
                    if e.scope == evicted_scope
                ]:
                    self._bytes -= self._drop(key, self._entries[key])
            self._sync_gauges()
        self.stats.incr("invalidations_scope")

    def invalidate_all(self) -> None:
        """Full flush — reload to a new model generation, entering
        degraded mode, or an operator-requested clear."""
        with self._lock:
            self._model_gen += 1
            self._entries.clear()
            self._scope_gens.clear()
            self._bytes = 0
            self._sync_gauges()
        # NB: the ``modelGeneration`` gauge is owned by the QueryService
        # (its reload counter), not by this internal generation counter
        self.stats.incr("invalidations_full")

    @property
    def model_generation(self) -> int:
        with self._lock:
            return self._model_gen

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class _Flight:
    __slots__ = ("done", "value", "exc")

    def __init__(self) -> None:
        self.done = threading.Event()
        self.value: Any = None
        self.exc: BaseException | None = None


class Singleflight:
    """Per-key in-flight computation dedup (the Go ``singleflight``
    idiom). ``do(key, fn)`` runs ``fn`` once per key at a time: the
    first caller (leader) computes; concurrent callers with the same key
    (followers) block and receive the leader's result — or its raised
    exception, re-raised in each follower. Leaders and followers are
    reported via the ``led`` flag so the caller can count coalesced
    work."""

    def __init__(self, stats: CacheStats | None = None):
        self.stats = stats or CacheStats()
        self._lock = threading.Lock()
        self._flights: dict[str, _Flight] = {}

    def do(self, key: str, fn: Callable[[], Any]) -> tuple[Any, bool]:
        """Returns ``(value, led)``; re-raises the leader's exception in
        every waiter."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is None:
                flight = _Flight()
                self._flights[key] = flight
                leader = True
            else:
                leader = False
        if not leader:
            if not flight.done.wait(timeout=_FLIGHT_TIMEOUT_S):
                raise TimeoutError(
                    f"singleflight leader did not answer within "
                    f"{_FLIGHT_TIMEOUT_S:g}s"
                )
            self.stats.incr("coalesced")
            if flight.exc is not None:
                raise flight.exc
            return flight.value, False
        self.stats.incr("flights")
        try:
            flight.value = fn()
        except BaseException as e:
            flight.exc = e
            raise
        finally:
            # unpublish BEFORE fan-out: a request arriving after the
            # result is set starts a fresh flight (it may be observing
            # newer state) instead of reading a completed one
            with self._lock:
                self._flights.pop(key, None)
            flight.done.set()
        return flight.value, True

    def inflight(self) -> int:
        with self._lock:
            return len(self._flights)


def extract_scope(body: Any, scope_field: str | None) -> str | None:
    """The invalidation scope named by a query body (e.g. its ``user``
    field), or None when the body has no usable scope."""
    if scope_field is None or not isinstance(body, Mapping):
        return None
    value = body.get(scope_field)
    if isinstance(value, str):
        return value
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return str(value)
    return None


def affinity_key(body: Any, scope_field: str | None = "user") -> str | None:
    """Scope→replica routing key of a query body, for the fleet router's
    consistent hash (``predictionio_tpu_torch.fleet``): the query's
    invalidation scope when it names one — so all of a scope's queries
    (and so its cached results) land on one replica and the fleet's
    aggregate cache shards instead of duplicating — else the whole
    canonical body, else None (route by load). The prefixes keep the two
    key spaces apart."""
    scope = extract_scope(body, scope_field)
    if scope is not None:
        return f"s:{scope}"
    key = canonical_key(body)
    return f"q:{key}" if key is not None else None


def scopes_from_events(
    bodies: Iterable[Any], entity_types: tuple[str, ...] = ("user",)
) -> set[str]:
    """Entity ids named by event-server-shaped event bodies — the bridge
    an ingest pipeline uses to turn observed writes into per-scope
    invalidations (``QueryService.cache_note_write``)."""
    scopes: set[str] = set()
    for body in bodies:
        if not isinstance(body, Mapping):
            continue
        if body.get("entityType") in entity_types:
            eid = body.get("entityId")
            if isinstance(eid, str) and eid:
                scopes.add(eid)
    return scopes
