"""Quorum-replicated appends for one event-stream partition.

:class:`ReplicatedEvents` owns N full columnar replicas of a single
partition. Appends land on a deterministic leader first (its dedup
window decides duplicate flags), then mirror synchronously to replicas
until ``ack_quorum`` copies are **fsync-durable** — only then does the
call return, which is what lets the event server emit a 201 meaning
"this event survives Q-1 disk losses". Replicas past the quorum catch
up asynchronously from the leader's columnar tail (``tail_follow``),
and every mirror path goes through the replica's dedup probe so retries
and sync/async double-delivery are absorbed idempotently.

Degradation is loud, never silent: a replica whose mirror fails is
marked unhealthy (the catch-up thread keeps reporting its lag), and if
fewer than Q replicas remain healthy the append raises
:class:`QuorumLostError` — the server turns that into per-line 5xx
errors and ``/readyz`` flips to 503 until quorum is restored.

Semantics the docs promise (docs/storage.md):

- quorum applies to the event-server ack paths (``insert*`` /
  ``ingest_chunk``). Offline bulk loads (``bulk_write`` /
  ``write_columns``) go leader-only and replicate asynchronously.
- reads (``find`` / ``get`` / ``tail_follow`` / ``find_columns``)
  serve from the leader; follower replicas exist for durability, not
  read scaling.
- deletes apply to the leader and best-effort to healthy replicas; a
  replica that was down during a delete re-converges only via operator
  re-init (documented limitation).

Counterpart of ``predictionio_tpu/data/storage/replication.py``, the
same code and on-disk layout with the port's imports.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Callable, Iterable, Sequence

from predictionio_tpu_torch.data.storage.base import StorageError

logger = logging.getLogger(__name__)

__all__ = ["QuorumLostError", "ReplicatedEvents"]


class QuorumLostError(StorageError):
    """Fewer than ``ack_quorum`` replicas could durably store an append.

    The event may exist on the leader (and some replicas) but was NOT
    acked — a client retry after quorum is restored converges via the
    replicas' dedup windows without double-storing."""


def _fsync_file_and_dir(path: str) -> None:
    """Durability barrier: fsync ``path`` (when it exists) and its
    directory. The directory fsync also persists any segment renames the
    append produced, so the ack covers explicit-id chunk segments too."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        fd = -1
    if fd >= 0:
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    d = os.path.dirname(path)
    try:
        dfd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


class ReplicatedEvents:
    """N columnar replicas of ONE partition with quorum-acked appends.

    Wraps N independent ``_ColumnarEvents`` stores (per-replica
    directories). The leader index is deterministic (chosen by the
    partition layer as ``partition_index % replication`` so leadership
    spreads across replica slots) and never moves at runtime — leader
    failure is partition failure, which the partitioned layer reports
    per-partition rather than papering over with an election.
    """

    #: async catch-up poll interval (seconds)
    CATCHUP_INTERVAL_S = 0.25

    def __init__(
        self,
        bases: Sequence[str],
        ack_quorum: int,
        *,
        segment_rows: int,
        leader: int = 0,
        cache_segments: int | None = None,
        dedup_window: int | None = None,
        dedup_warm_bytes: int | None = None,
        name: str = "r",
    ):
        from predictionio_tpu_torch.data.storage.columnar import _ColumnarEvents

        n = len(bases)
        if n < 2:
            raise StorageError("replication requires at least 2 replicas")
        if not 1 <= ack_quorum <= n:
            raise StorageError(
                f"ack_quorum must be in [1, {n}], got {ack_quorum}"
            )
        # replication forces fsync=True on every replica: a quorum ack
        # that did not reach any disk would be durability theater
        self._stores = [
            _ColumnarEvents(
                b, segment_rows, True,
                cache_segments=cache_segments,
                dedup_window=dedup_window,
                dedup_warm_bytes=dedup_warm_bytes,
            )
            for b in bases
        ]
        self.replicas = n
        self.ack_quorum = ack_quorum
        self.leader = leader % n
        #: replication bookkeeping ONLY (health flags, cursors, lag) —
        #: never held across a store call, so the lock witness sees no
        #: ordering edge between it and the per-replica store locks
        self._rlock = threading.Lock()
        self._healthy = [True] * n
        self._cursors: dict[tuple[int, int, int | None], dict] = {}
        self._lag: dict[int, dict] = {}
        self._streams: set[tuple[int, int | None]] = set()
        self._stop = threading.Event()
        self._catchup = threading.Thread(
            target=self._catchup_loop,
            name=f"pio-replica-catchup-{name}",
            daemon=True,
        )
        self._catchup.start()

    # ------------------------------------------------------------ leader
    @property
    def leader_store(self):
        return self._stores[self.leader]

    def replica_store(self, r: int):
        """Direct replica access — chaos/tests only."""
        return self._stores[r]

    def fail_replica(self, r: int) -> None:
        """Mark replica ``r`` permanently unhealthy (chaos injection /
        operator fence). The leader keeps serving; quorum math updates."""
        if r == self.leader:
            raise StorageError("cannot fail the leader replica in place")
        with self._rlock:
            self._healthy[r] = False
        logger.warning("replica %d marked unhealthy", r)

    def _sync_order(self) -> list[int]:
        """Deterministic mirror order: leader+1, leader+2, ... mod N."""
        return [
            (self.leader + i) % self.replicas
            for i in range(1, self.replicas)
        ]

    def _note_stream(self, app_id: int, channel_id: int | None) -> None:
        with self._rlock:
            self._streams.add((app_id, channel_id))

    # --------------------------------------------------- the quorum barrier
    def _fsync_stream_replica(self, store, app_id, channel_id) -> None:
        """Explicit fsync barrier on one replica's stream (tail + dir).

        The store already fsyncs its own tail/segment writes (fsync=True
        is forced), but the quorum ack must be *provably* behind an
        fsync in this module's own control flow — piolint's PIO505 rule
        checks exactly that — and the directory fsync here additionally
        persists segment renames before the ack."""
        _fsync_file_and_dir(
            os.path.join(store._stream_dir(app_id, channel_id), "tail.jsonl")
        )

    def _quorum_ack(
        self,
        app_id: int,
        channel_id: int | None,
        mirror: Callable[[Any], Any],
    ) -> int:
        """Mirror an already-leader-applied append until Q replicas are
        fsync-durable; raise :class:`QuorumLostError` otherwise.

        ``mirror`` must be idempotent (all callers mirror through the
        replica's dedup probe), because the SAME rows are re-mirrored on
        client retry after a partial quorum failure."""
        self._fsync_stream_replica(self._stores[self.leader], app_id, channel_id)
        acked = 1  # the leader
        for r in self._sync_order():
            if acked >= self.ack_quorum:
                break
            with self._rlock:
                healthy = self._healthy[r]
            if not healthy:
                continue
            store = self._stores[r]
            try:
                mirror(store)
            except Exception:
                logger.exception(
                    "replica %d mirror failed; marking unhealthy", r
                )
                with self._rlock:
                    self._healthy[r] = False
                continue
            self._fsync_stream_replica(store, app_id, channel_id)
            acked += 1
        if acked < self.ack_quorum:
            raise QuorumLostError(
                f"quorum lost: {acked}/{self.ack_quorum} replicas durable"
            )
        return acked

    # ----------------------------------------------------------- appends
    def insert(self, event, app_id, channel_id=None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events, app_id, channel_id=None) -> list:
        ids = self.leader_store.insert_batch(events, app_id, channel_id)
        mirrored = [
            e if e.event_id == eid else e.with_event_id(eid)
            for e, eid in zip(events, ids)
        ]
        self._note_stream(app_id, channel_id)
        self._quorum_ack(
            app_id, channel_id,
            lambda s: s.insert_batch_dedup(mirrored, app_id, channel_id),
        )
        return ids

    def insert_dedup(self, event, app_id, channel_id=None):
        return self.insert_batch_dedup([event], app_id, channel_id)[0]

    def insert_batch_dedup(self, events, app_id, channel_id=None) -> list:
        res = self.leader_store.insert_batch_dedup(events, app_id, channel_id)
        mirrored = [
            e if e.event_id == eid else e.with_event_id(eid)
            for e, (eid, _dup) in zip(events, res)
        ]
        self._note_stream(app_id, channel_id)
        # the barrier covers EVERY row, not only rows fresh on the
        # leader: a retried batch whose first attempt died between the
        # leader append and the quorum mirror is all-dup on the leader
        # but may still be missing on replicas — it must reach Q copies
        # before it is acked again
        self._quorum_ack(
            app_id, channel_id,
            lambda s: s.insert_batch_dedup(mirrored, app_id, channel_id),
        )
        return res

    def ingest_chunk(self, chunk, app_id, channel_id=None) -> list:
        res = self.leader_store.ingest_chunk(chunk, app_id, channel_id)
        self._note_stream(app_id, channel_id)
        # same retry rationale as insert_batch_dedup: mirror the whole
        # chunk, replica dedup absorbs what already landed
        self._quorum_ack(
            app_id, channel_id,
            lambda s: s.ingest_chunk(chunk, app_id, channel_id),
        )
        return res

    # ------------------------------------------------------ async catch-up
    def _catchup_loop(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(self.CATCHUP_INTERVAL_S)
            if self._stop.is_set():
                return
            try:
                self._catchup_once()
            except Exception:  # pragma: no cover - defensive
                logger.exception("replica catch-up pass failed")

    def _catchup_once(self) -> None:
        """One catch-up pass: every healthy non-leader replica drains the
        leader tail delta through its dedup probe and refreshes its lag.

        Cursors are in-memory only: a restart re-delivers from the start
        of the leader stream, which the replica dedup absorbs (slower
        first pass, never a duplicate)."""
        with self._rlock:
            streams = sorted(self._streams, key=lambda s: (s[0], s[1] or -1))
            healthy = list(self._healthy)
        leader = self.leader_store
        for app_id, channel_id in streams:
            try:
                state = leader.scan_state(app_id, channel_id)
            except Exception:
                continue
            for r in range(self.replicas):
                if r == self.leader:
                    continue
                key = (r, app_id, channel_id)
                with self._rlock:
                    cursor = self._cursors.get(key)
                if not healthy[r]:
                    self._update_lag(r, state, cursor, in_sync=False,
                                     healthy=False)
                    continue
                try:
                    events, new_cursor = leader.tail_follow(
                        app_id, channel_id, cursor=cursor, from_start=True
                    )
                    if events:
                        self._stores[r].insert_batch_dedup(
                            events, app_id, channel_id
                        )
                except Exception:
                    logger.exception(
                        "replica %d catch-up failed; marking unhealthy", r
                    )
                    with self._rlock:
                        self._healthy[r] = False
                    continue
                with self._rlock:
                    self._cursors[key] = new_cursor
                self._update_lag(r, state, new_cursor, in_sync=True,
                                 healthy=True)

    def _update_lag(self, r, state, cursor, *, in_sync, healthy) -> None:
        tail_behind = state["tail_lines"] - (
            (cursor or {}).get("tail_lines") or 0
        )
        seg_behind = len(state["segments"]) - len(
            (cursor or {}).get("segments") or ()
        )
        with self._rlock:
            self._lag[r] = {
                "tailLinesBehind": max(0, int(tail_behind)),
                "segmentsBehind": max(0, int(seg_behind)),
                "inSync": bool(in_sync and tail_behind <= 0),
                "healthy": bool(healthy),
            }

    def replication_health(self) -> dict:
        """Degraded-mode surface for /stats.json and /readyz: per-replica
        health + lag and whether a quorum of healthy replicas remains."""
        with self._rlock:
            healthy = list(self._healthy)
            lag = {str(r): dict(v) for r, v in sorted(self._lag.items())}
        return {
            "replicas": self.replicas,
            "ackQuorum": self.ack_quorum,
            "leader": self.leader,
            "healthy": healthy,
            "quorumOk": sum(healthy) >= self.ack_quorum,
            "lag": lag,
        }

    # ------------------------------------------------- leader-side reads
    def get(self, event_id, app_id, channel_id=None):
        return self.leader_store.get(event_id, app_id, channel_id)

    def find(self, *a, **kw):
        return self.leader_store.find(*a, **kw)

    def find_columns(self, *a, **kw):
        return self.leader_store.find_columns(*a, **kw)

    def tail_follow(self, app_id, channel_id=None, cursor=None,
                    from_start=False):
        return self.leader_store.tail_follow(
            app_id, channel_id, cursor, from_start
        )

    def scan_state(self, app_id, channel_id=None) -> dict:
        return self.leader_store.scan_state(app_id, channel_id)

    def stream_stats(self) -> list:
        return self.leader_store.stream_stats()

    def dedup_warm_stats(self) -> dict:
        return self.leader_store.dedup_warm_stats()

    # ----------------------------------------- offline / admin operations
    def bulk_write(self, events: Iterable, app_id, channel_id=None) -> None:
        # leader-only; the catch-up follower replicates asynchronously.
        # Offline loads get throughput, the event-server ack paths above
        # keep the quorum guarantee.
        self.leader_store.bulk_write(events, app_id, channel_id)
        self._note_stream(app_id, channel_id)

    def write_columns(self, app_id, channel_id=None, **kw) -> int:
        n = self.leader_store.write_columns(app_id, channel_id, **kw)
        self._note_stream(app_id, channel_id)
        return n

    def init(self, app_id, channel_id=None) -> bool:
        ok = True
        for s in self._stores:
            ok = s.init(app_id, channel_id) and ok
        self._note_stream(app_id, channel_id)
        return ok

    def remove(self, app_id, channel_id=None) -> bool:
        ok = True
        for s in self._stores:
            ok = s.remove(app_id, channel_id) and ok
        with self._rlock:
            self._streams.discard((app_id, channel_id))
            self._cursors = {
                k: v for k, v in self._cursors.items()
                if (k[1], k[2]) != (app_id, channel_id)
            }
        return ok

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        hit = self.leader_store.delete(event_id, app_id, channel_id)
        for r in self._sync_order():
            with self._rlock:
                healthy = self._healthy[r]
            if not healthy:
                continue
            try:
                self._stores[r].delete(event_id, app_id, channel_id)
            except Exception:  # pragma: no cover - best effort
                logger.exception("replica %d delete failed", r)
        return hit

    def compact(self, app_id, channel_id=None) -> int:
        # compacting every healthy replica keeps follower dirs bounded;
        # catch-up cursors survive it via tail_follow's re-anchor
        moved = self.leader_store.compact(app_id, channel_id)
        for r in self._sync_order():
            with self._rlock:
                healthy = self._healthy[r]
            if not healthy:
                continue
            try:
                self._stores[r].compact(app_id, channel_id)
            except Exception:  # pragma: no cover - best effort
                logger.exception("replica %d compact failed", r)
        return moved

    def sweep_recovery(self) -> dict:
        agg: dict = {
            "streams": 0,
            "quarantined": [],
            "replayedCommits": 0,
            "tornTailLines": 0,
            "dedupWarmMs": 0.0,
            "dedupWarmedStreams": 0,
        }
        for r, s in enumerate(self._stores):
            rep = s.sweep_recovery()
            agg["quarantined"].extend(
                f"replica_{r}:{p}" for p in rep.get("quarantined", ())
            )
            for k in ("streams", "replayedCommits", "tornTailLines",
                      "dedupWarmMs", "dedupWarmedStreams"):
                agg[k] += rep.get(k, 0)
        # seed the stream set from disk so catch-up covers streams that
        # existed before this process started
        for app_id, channel_id, _d in self.leader_store._stream_dirs():
            self._note_stream(app_id, channel_id)
        return agg

    def close(self) -> None:
        self._stop.set()
        self._catchup.join(timeout=5)
