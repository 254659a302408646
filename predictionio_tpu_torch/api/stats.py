"""Live statistics for the API servers.

* :class:`Stats` — event-server ingest counters. Parity:
  ``data/api/Stats.scala`` + ``StatsActor`` — counts events by (appId,
  status-code, event-name, entity-type) over start-of-minute time
  buckets, served at ``/stats.json`` when the server runs with
  ``--stats``. Single-writer here (the service locks), no actor needed.
* :class:`ServingStats` — query-server micro-batcher gauges, counters and
  the per-request latency decomposition (queue wait / batch-form /
  handle time), served at the query server's ``GET /stats.json``. No
  reference counterpart (the reference has no cross-request batcher).

Counterpart of ``predictionio_tpu/api/stats.py`` (a copy).
"""

from __future__ import annotations

import datetime as _dt
import threading
from collections import Counter, deque

__all__ = ["Stats", "ServingStats"]


def _bucket(dt: _dt.datetime) -> _dt.datetime:
    return dt.replace(second=0, microsecond=0)


class Stats:
    #: retain at most this many (appId, minute) buckets; oldest evicted
    #: first so a long-running server's memory and /stats.json response
    #: stay bounded (~24h of single-app traffic).
    MAX_BUCKETS = 1440

    def __init__(self, max_buckets: int | None = None):
        self._lock = threading.Lock()
        self.start_time = _dt.datetime.now(_dt.timezone.utc)
        self.max_buckets = max_buckets or self.MAX_BUCKETS
        # (appId, bucket) -> Counter keyed by ("status", code) /
        # ("event", name) / ("etype", entityType)
        self._counts: dict[tuple[int, _dt.datetime], Counter] = {}

    def update(
        self,
        app_id: int,
        status_code: int,
        event_name: str | None = None,
        entity_type: str | None = None,
        when: _dt.datetime | None = None,
    ) -> None:
        when = _bucket(when or _dt.datetime.now(_dt.timezone.utc))
        with self._lock:
            if (app_id, when) not in self._counts:
                while len(self._counts) >= self.max_buckets:
                    oldest = min(self._counts, key=lambda k: k[1])
                    del self._counts[oldest]
            c = self._counts.setdefault((app_id, when), Counter())
            c[("status", str(status_code))] += 1
            if event_name:
                c[("event", event_name)] += 1
            if entity_type:
                c[("etype", entity_type)] += 1

    def to_json(self) -> dict:
        with self._lock:
            out = []
            for (app_id, bucket), c in sorted(self._counts.items(), key=lambda kv: (kv[0][1], kv[0][0])):
                out.append(
                    {
                        "appId": app_id,
                        "bucket": bucket.isoformat(),
                        "status": {k: v for (kind, k), v in c.items() if kind == "status"},
                        "event": {k: v for (kind, k), v in c.items() if kind == "event"},
                        "entityType": {k: v for (kind, k), v in c.items() if kind == "etype"},
                    }
                )
            return {"startTime": self.start_time.isoformat(), "statsByMinute": out}


def _percentiles(samples, points=(50, 95, 99)) -> dict[str, float]:
    """Nearest-rank percentiles of a sample window, no numpy needed on
    this hot-ish path."""
    if not samples:
        return {f"p{p}": None for p in points}
    s = sorted(samples)
    out = {}
    for p in points:
        idx = min(len(s) - 1, max(0, int(round(p / 100.0 * len(s))) - 1))
        out[f"p{p}"] = round(s[idx], 3)
    return out


class ServingStats:
    """Micro-batcher serving statistics (thread-safe).

    Latency decomposition per request, all in milliseconds:

    * ``queueWait`` — enqueue until the dispatcher formed its batch;
    * ``batchForm`` — per batch: drain-complete until ``handle_batch``
      is entered (padding + bookkeeping);
    * ``handle`` — per batch: the ``handle_batch`` call itself (bind +
      device dispatch + serve tail);
    * ``total`` — enqueue until the caller gets its result back.

    Windows keep the most recent :attr:`WINDOW` samples so percentiles
    track current behavior on a long-running server; counters are
    monotonic over the process lifetime.
    """

    WINDOW = 4096

    def __init__(self, window: int | None = None):
        self._lock = threading.Lock()
        self.start_time = _dt.datetime.now(_dt.timezone.utc)
        n = window or self.WINDOW
        self.submitted = 0
        self.completed = 0
        self.rejected = 0  # 429s from the REJECT admission policy
        self.block_timeouts = 0  # 503s from the BLOCK admission policy
        self.batches = 0
        self.batched_queries = 0
        self.padded_queries = 0  # filler slots added for bucket padding
        self.queue_depth = 0  # last observed; gauge
        self.inflight_batch = 0  # 0|1 — one dispatcher thread
        self.batch_size_hist: Counter = Counter()
        self.bucket_hist: Counter = Counter()
        #: buckets whose jit programs are assumed compiled (warm-up or a
        #: previous live dispatch); a dispatch to a bucket outside this
        #: set is counted as a miss == a likely recompile
        self.warmed_buckets: set[int] = set()
        self.bucket_misses = 0
        self.warmup_ms: dict[int, float] = {}
        self._queue_wait_ms: deque = deque(maxlen=n)
        self._form_ms: deque = deque(maxlen=n)
        self._handle_ms: deque = deque(maxlen=n)
        self._total_ms: deque = deque(maxlen=n)

    # ------------------------------------------------------------ recording
    def record_submitted(self, queue_depth: int) -> None:
        with self._lock:
            self.submitted += 1
            self.queue_depth = queue_depth

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_block_timeout(self) -> None:
        with self._lock:
            self.block_timeouts += 1

    def record_warmup(self, bucket: int, ms: float) -> None:
        with self._lock:
            self.warmed_buckets.add(bucket)
            # bounded by the batcher's finite bucket set, not request data
            self.warmup_ms[bucket] = round(ms, 3)  # piolint: disable=PIO205

    def record_queue_wait(self, ms: float) -> None:
        with self._lock:
            self._queue_wait_ms.append(ms)

    def record_batch_start(self, queue_depth: int) -> None:
        with self._lock:
            self.inflight_batch = 1
            self.queue_depth = queue_depth

    def record_batch(
        self, size: int, bucket: int, form_ms: float, handle_ms: float
    ) -> None:
        with self._lock:
            self.inflight_batch = 0
            self.batches += 1
            self.batched_queries += size
            self.padded_queries += bucket - size
            self.batch_size_hist[size] += 1
            self.bucket_hist[bucket] += 1
            if bucket not in self.warmed_buckets:
                self.bucket_misses += 1
                self.warmed_buckets.add(bucket)
            self._form_ms.append(form_ms)
            self._handle_ms.append(handle_ms)

    def record_request(self, total_ms: float) -> None:
        with self._lock:
            self.completed += 1
            self._total_ms.append(total_ms)

    # ------------------------------------------------------------- reporting
    def handle_p50_ms(self) -> float:
        """Median per-batch handle time over the window (0.0 before any
        batch ran) — feeds the batcher's Retry-After estimate."""
        with self._lock:
            p = _percentiles(self._handle_ms, points=(50,))["p50"]
        return p or 0.0

    def to_json(self) -> dict:
        with self._lock:
            real = max(1, self.batched_queries)
            return {
                "startTime": self.start_time.isoformat(),
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "blockTimeouts": self.block_timeouts,
                "queueDepth": self.queue_depth,
                "inflightBatch": self.inflight_batch,
                "batches": self.batches,
                "batchedQueries": self.batched_queries,
                "meanBatchSize": round(self.batched_queries / self.batches, 2)
                if self.batches
                else 0.0,
                "paddingOverhead": round(self.padded_queries / real, 4),
                "batchSizeHist": {
                    str(k): v for k, v in sorted(self.batch_size_hist.items())
                },
                "bucketHist": {
                    str(k): v for k, v in sorted(self.bucket_hist.items())
                },
                "warmedBuckets": sorted(self.warmed_buckets),
                "bucketMisses": self.bucket_misses,
                "warmupMs": {str(k): v for k, v in sorted(self.warmup_ms.items())},
                "latencyMs": {
                    "queueWait": _percentiles(self._queue_wait_ms),
                    "batchForm": _percentiles(self._form_ms),
                    "handle": _percentiles(self._handle_ms),
                    "total": _percentiles(self._total_ms),
                },
            }
