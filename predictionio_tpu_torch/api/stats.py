"""Live statistics for the event server.

:class:`Stats` — event-server ingest counters. Parity:
``data/api/Stats.scala`` + ``StatsActor`` — counts events by (appId,
status-code, event-name, entity-type) over start-of-minute time buckets,
served at ``/stats.json`` when the server runs with ``--stats``.
Single-writer here (the service locks), no actor needed.

Counterpart of ``predictionio_tpu/api/stats.py``; its ``ServingStats``
(the query server's micro-batcher gauges) waits with the batcher.
"""

from __future__ import annotations

import datetime as _dt
import threading
from collections import Counter

__all__ = ["Stats"]


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
