"""Durable tail follower — the watermark cursor over the event store.

A copy of ``predictionio_tpu/online/follower.py`` over the port's
columnar driver (:meth:`predictionio_tpu_torch.data.storage.columnar
._ColumnarEvents.tail_follow`), with crash-safe cursor persistence:

* :meth:`TailFollower.poll` reads everything appended since the cursor
  (decoded events) and advances the cursor **in memory only**;
* :meth:`TailFollower.commit` persists the advanced cursor atomically
  (tmp + fsync + rename) — callers commit AFTER the batch is applied to
  the model, so a crash between poll and commit re-delivers the batch
  (at-least-once) instead of skipping it; the fold-in consumers are
  re-solve-idempotent, so re-delivery converges to the same factors.

Across a clean stop/start the persisted cursor resumes exactly once,
including across segment roll and compaction. The cursor file's name and
JSON are the JAX package's, so a deploy of either package resumes the
other's watermark. A partitioned store gets one follower per partition
(``partition=``), each with its own cursor file.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import re
import threading
import zlib

from predictionio_tpu_torch.online.types import EventDelta

__all__ = ["TailFollower", "FollowerUnsupportedError", "to_deltas"]

logger = logging.getLogger(__name__)


class FollowerUnsupportedError(RuntimeError):
    """The configured event store has no tail-follow API (only the
    columnar driver streams deltas)."""


def _state_path(
    state_dir: str, app_name: str, channel: str | None,
    partition: int | None = None,
) -> str:
    if not state_dir:
        from predictionio_tpu_torch.data.storage import Storage

        state_dir = os.path.join(Storage.base_dir(), "online")
    # readable prefix + crc so distinct app names never share a cursor;
    # a partitioned store gets one cursor file a partition follower
    # (partition=None keeps the single-stream name)
    name = f"{app_name}\x00{channel or ''}"
    safe = re.sub(r"[^A-Za-z0-9_-]", "_", app_name)
    if partition is not None:
        name += f"\x00p{partition}"
        safe += f"-p{partition}"
    return os.path.join(state_dir, f"{safe}-{zlib.crc32(name.encode()):08x}.cursor.json")


class TailFollower:
    """Follow one app's event stream from a persisted watermark."""

    def __init__(
        self,
        app_name: str,
        channel: str | None = None,
        state_dir: str = "",
        from_start: bool = False,
        partition: int | None = None,
    ):
        from predictionio_tpu_torch.data.storage import Storage
        from predictionio_tpu_torch.data.store import resolve_app

        self.app_name = app_name
        self.partition = partition
        self._app_id, self._channel_id = resolve_app(app_name, channel)
        self._pe = Storage.get_p_events()
        if not hasattr(self._pe, "tail_follow"):
            raise FollowerUnsupportedError(
                "the configured EVENTDATA store does not support tail "
                "following (pio deploy --online needs the columnar "
                "driver; docs/operations.md)"
            )
        self._from_start = from_start
        self._path = _state_path(state_dir, app_name, channel, partition)
        self._lock = threading.Lock()
        self._cursor: dict | None = self._load()
        self._pending: dict | None = None  # advanced but uncommitted
        if self._cursor is None and not from_start:
            # anchor the watermark NOW, not at the first poll: anything
            # ingested between deploy and the daemon's first cycle is
            # new data and must fold
            _, self._cursor = self._follow(None)
            self._pending = self._cursor
            self.commit()

    def _follow(self, cursor: dict | None):
        # the partition is routed only when set: plain stores never see
        # the kwarg
        kw = {} if self.partition is None else {"partition": self.partition}
        return self._pe.tail_follow(
            self._app_id, self._channel_id, cursor=cursor, from_start=self._from_start, **kw
        )

    # ------------------------------------------------------------ persistence
    def _load(self) -> dict | None:
        try:
            with open(self._path) as f:
                cursor = json.load(f)
        except (FileNotFoundError, ValueError):
            return None
        return cursor if isinstance(cursor, dict) else None

    def commit(self) -> None:
        """Persist the last poll's cursor atomically. Called by the
        runner AFTER the batch was folded into the serving model — the
        watermark never runs ahead of what serving reflects."""
        with self._lock:
            pending = self._pending
            if pending is None:
                return
            self._pending = None
            self._cursor = pending
        os.makedirs(os.path.dirname(self._path), exist_ok=True)
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(pending, f)
            # the watermark IS the exactly-once contract: a torn cursor
            # file after a crash would re-deliver (or skip) the tail
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path)
        dfd = os.open(os.path.dirname(self._path), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def rollback(self) -> None:
        """Drop the uncommitted poll advance: the next :meth:`poll`
        re-delivers everything since the last committed watermark (a
        batch that could not be applied: deadline hit, superseded
        generation, or an error mid-fold)."""
        with self._lock:
            self._pending = None

    # ------------------------------------------------------------------ poll
    def poll(self, limit: int | None = None) -> list:
        """Events appended since the watermark, oldest first (decoded
        :class:`~predictionio_tpu_torch.data.event.Event` objects).
        Advances the in-memory cursor; call :meth:`commit` once the batch
        is applied. ``limit`` is advisory only — a poll always consumes
        whole storage deltas; the runner slices oversized batches into
        consecutive folds itself."""
        with self._lock:
            cursor = self._pending if self._pending is not None else self._cursor
            # piolint: waive=PIO211 -- tail_follow can reach os.replace only on first-touch stream creation; every later poll is a pure delta read, and poll/commit must stay serialized under this lock regardless
            events, new_cursor = self._follow(cursor)
            # only the PENDING cursor advances; the committed cursor
            # moves in commit() so rollback() can re-deliver in-process
            self._pending = new_cursor
        return events

    def lag(self) -> dict:
        """Watermark position for /stats.json: consumed segments/lines
        against the store's current state."""
        with self._lock:
            cursor = dict(self._cursor or {})
        kw = {} if self.partition is None else {"partition": self.partition}
        state = self._pe.scan_state(self._app_id, self._channel_id, **kw) if hasattr(self._pe, "scan_state") else {}
        out = {
            "tailLinesConsumed": int(cursor.get("tail_lines", 0)),
            "tailLinesStore": int(state.get("tail_lines", 0)),
            "segmentsConsumed": len(cursor.get("segments", ())),
            "segmentsStore": len(state.get("segments", ())),
            "compactions": int(cursor.get("compactions", 0)),
            # byte offset of the cleanly consumed tail prefix: polls are
            # O(delta) while present; absent means the next poll takes
            # the line-count fallback scan
            "tailBytesConsumed": cursor.get("tail_bytes"),
        }
        if self.partition is not None:
            out["partition"] = self.partition
        return out


def to_deltas(events, rating_prop: str = "rating") -> list[EventDelta]:
    """Decoded events -> the reduced per-event view fold-in consumes.
    Property extraction mirrors the training read: a numeric
    ``rating_prop`` lands as the rating, everything else is NaN."""
    out: list[EventDelta] = []
    for e in events:
        v = e.properties.opt(rating_prop) if e.properties is not None else None
        rating = float(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else float("nan")
        t = e.event_time
        if t.tzinfo is None:
            t = t.replace(tzinfo=_dt.timezone.utc)
        out.append(
            EventDelta(
                event=e.event,
                user=e.entity_id,
                item=e.target_entity_id,
                t_us=int(t.timestamp() * 1e6),
                rating=rating,
            )
        )
    return out
