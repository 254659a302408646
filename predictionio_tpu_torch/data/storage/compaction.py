"""Background compaction scheduler — tail compaction as a continuous
process instead of an operator command.

The columnar store's ``compact()`` seals the JSONL tail into
explicit-id segments, GCs consumed tombstones and bumps the compaction
generation. Run only by `pio app compact`, the tail grows without bound
under sustained ingest and every scan re-decodes it. This scheduler runs
the same compaction **under load**, driven by watermarks:

* ``tail_bytes_high`` — the live tail outgrew its byte budget;
* ``dead_tombstones_high`` — enough tail events were deleted that scans
  pay real tombstone-filter cost (dead bytes);
* both per stream, discovered via the driver's ``stream_stats()``.

Safety properties the scheduler leans on (and tests assert):

* ``compact()`` holds the store lock, so a compaction serializes against
  concurrent single/batch/bulk appends — a bulk chunk either lands
  before the generation bump (and is consumed through the re-anchor) or
  after it (and is a new segment the follower reads in full);
* the tail follower's cursor survives the generation bump
  exactly-once by design — the scheduler merely makes bumps frequent;
* **rate limiting** (``min_interval_s`` per stream) keeps a
  hot-deleting workload from compacting in a loop;
* **drain awareness**: ``stop()`` is registered as a drain hook ahead of
  the storage flush, so a draining server never starts a new compaction
  while requests are finishing, and a compaction in flight completes
  (the store lock, not the scheduler, owns atomicity — a SIGKILL
  mid-compaction is already recovered by the commit-marker replay).

Strictly opt-in: nothing constructs a scheduler unless ``pio
eventserver --compact-interval-s`` is set. Stdlib-only threading over the
storage SPI; data-layer module.

Counterpart of ``predictionio_tpu/data/storage/compaction.py``, the same
code with the port's imports.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any

__all__ = ["CompactionConfig", "CompactionScheduler"]

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class CompactionConfig:
    """Watermarks and pacing (``pio eventserver --compact-*``)."""

    #: seconds between watermark sweeps
    interval_s: float = 5.0
    #: compact a stream when its live tail exceeds this many bytes
    tail_bytes_high: int = 32 * 1024 * 1024
    #: ... or when this many tail events are tombstoned (dead bytes)
    dead_tombstones_high: int = 10_000
    #: per-stream floor between two compactions (rate limit)
    min_interval_s: float = 30.0


class CompactionScheduler:
    """Daemon sweep loop over ``stream_stats()`` → ``compact()``.

    ``events`` is any LEvents exposing ``stream_stats()`` and
    ``compact()`` (the columnar driver); drivers without them simply
    can't be scheduled (the caller checks before constructing one).
    """

    def __init__(self, events: Any, config: CompactionConfig | None = None):
        self._events = events
        self._config = config or CompactionConfig()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        #: (app_id, channel_id) -> monotonic time of the last compaction
        self._last: dict[tuple, float] = {}
        self._compactions = 0
        self._events_moved = 0
        self._errors = 0
        self._last_sweep_ms = 0.0
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._run, name="pio-compact-scheduler", daemon=True
            )
            self._thread.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        """Stop sweeping (drain hook). A compaction already inside
        ``compact()`` finishes — its atomicity belongs to the store's
        commit marker, not to this thread."""
        self._stop.set()
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)

    # ------------------------------------------------------------- sweeping
    def _run(self) -> None:
        while not self._stop.wait(self._config.interval_s):
            try:
                self.sweep_once()
            except Exception:
                with self._lock:
                    self._errors += 1
                logger.exception("compaction sweep failed")

    def sweep_once(self) -> int:
        """One watermark sweep; returns how many streams compacted.
        Public so tests (and `pio app compact`-style tooling) can drive
        the policy deterministically without the timer thread."""
        t0 = time.perf_counter()
        cfg = self._config
        compacted = 0
        for st in self._events.stream_stats():
            if self._stop.is_set():
                break
            over = (
                st["tail_bytes"] >= cfg.tail_bytes_high
                or st["dead_tail_tombstones"] >= cfg.dead_tombstones_high
            )
            if not over:
                continue
            key = (st["app_id"], st["channel_id"])
            now = time.monotonic()
            last = self._last.get(key)
            if last is not None and now - last < cfg.min_interval_s:
                continue
            try:
                moved = self._events.compact(st["app_id"], st["channel_id"])
            except Exception:
                with self._lock:
                    self._errors += 1
                logger.exception(
                    "scheduled compaction failed for app=%s channel=%s",
                    st["app_id"], st["channel_id"],
                )
                continue
            self._last[key] = now
            compacted += 1
            with self._lock:
                self._compactions += 1
                self._events_moved += int(moved)
        with self._lock:
            self._last_sweep_ms = (time.perf_counter() - t0) * 1000.0
        return compacted

    # ---------------------------------------------------------------- stats
    def to_json(self) -> dict:
        """``/stats.json`` ``compaction`` section."""
        cfg = self._config
        with self._lock:
            return {
                "running": self._thread is not None
                and self._thread.is_alive(),
                "compactions": self._compactions,
                "eventsMoved": self._events_moved,
                "errors": self._errors,
                "lastSweepMs": round(self._last_sweep_ms, 3),
                "intervalSeconds": cfg.interval_s,
                "tailBytesHigh": cfg.tail_bytes_high,
                "deadTombstonesHigh": cfg.dead_tombstones_high,
                "minIntervalSeconds": cfg.min_interval_s,
            }
