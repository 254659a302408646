"""Entity-hash partitioned event streams over independent columnar stores.

One columnar stream per (app, channel) makes a single appender thread
the global events/s ceiling and one disk's fsync the whole durability
story. This module splits every stream across P **independent**
columnar stores — ``<base>/part_00 … part_{P-1}`` — routed by a stable
entity hash (``crc32(entity_type \\x00 entity_id) % P``). Each partition
keeps its own appender lock, its own dedup window, and its own
compaction schedule; nothing is shared between partitions but the
routing function, so a crashed or wedged partition never stalls the
others.

Dedup stays correct under partitioning because the dedup key (the
client event id) always travels with its entity: a retransmitted row
hashes to the SAME partition as the original, where that partition's
window/store probe catches it. That invariant only holds while P is
fixed — which is why the partition count is sealed into a durable
``partitions.json`` marker at first open and any mismatch (including
opening partitioned data with the default single-stream driver) is a
hard refusal pointing at ``pio export`` → ``pio import`` migration,
never a silent double-store.

With ``replication >= 2`` each partition becomes a
:class:`~predictionio_tpu_torch.data.storage.replication.ReplicatedEvents`
group (quorum-acked appends, async follower catch-up); the leader slot
rotates with the partition index so N replicas share leadership load.

Chaos knobs (read once at open; used only by ``pio chaos-ingest``):

- ``PIO_CHAOS_KILL_PARTITION="<p>:<after_rows>"`` — once partition
  ``p`` has accepted ``after_rows`` rows, its appender "dies": torn
  bytes land on its tail (as a kill -9 mid-append would leave) and
  every later append to it raises, while other partitions keep going.
- ``PIO_CHAOS_KILL_REPLICA="<p>:<r>:<after_rows>"`` — same trigger, but
  replica ``r`` of partition ``p`` is fenced (torn tail bytes + marked
  unhealthy), exercising quorum-loss reporting and catch-up.

Counterpart of ``predictionio_tpu/data/storage/partitioned.py``, the
same code and on-disk layout with the port's imports, so a store written
by either package is read by the other.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import zlib
from typing import Any, Iterable, Iterator, Sequence

import numpy as np

from predictionio_tpu_torch.data.storage.base import (
    BaseStorageClient,
    LEvents,
    PEvents,
    StorageError,
)

logger = logging.getLogger(__name__)

__all__ = [
    "MARKER_NAME",
    "PartitionedEvents",
    "PartitionedPEvents",
    "open_partitioned",
    "partition_of",
]

MARKER_NAME = "partitions.json"

_MIGRATE_HINT = (
    "changing the partition layout in place would silently break dedup "
    "routing (the same entity would hash to a different partition); "
    "migrate with `pio export` from the old layout and `pio import` "
    "into a store opened with the new one"
)


def partition_of(entity_type: str, entity_id: str, partitions: int) -> int:
    """Stable entity → partition routing. crc32 is deterministic across
    processes and Python versions (unlike ``hash``), so a retransmitted
    event id always lands on the partition that first stored it."""
    key = f"{entity_type}\x00{entity_id}".encode("utf-8")
    return zlib.crc32(key) % partitions


def _read_marker(base: str) -> dict | None:
    try:
        with open(os.path.join(base, MARKER_NAME)) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        raise StorageError(f"unreadable {MARKER_NAME}: {e}") from e


def _write_marker(base: str, meta: dict) -> None:
    """Marker write with the full durable-root protocol (PIO501/502):
    temp + fsync + rename + directory fsync — a torn marker would make
    the refusal rules unreliable exactly when they matter (post-crash)."""
    path = os.path.join(base, MARKER_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(base, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _parse_fault2(val: str | None) -> tuple[int, int] | None:
    if not val:
        return None
    p, after = val.split(":")
    return int(p), int(after)


def _parse_fault3(val: str | None) -> tuple[int, int, int] | None:
    if not val:
        return None
    p, r, after = val.split(":")
    return int(p), int(r), int(after)


def open_partitioned(
    base: str,
    *,
    partitions: int,
    replication: int = 0,
    ack_quorum: int = 0,
    segment_rows: int,
    fsync: bool,
    cache_segments: int | None = None,
    dedup_window: int | None = None,
    dedup_warm_bytes: int | None = None,
) -> "PartitionedEvents":
    """Open (or create) a partitioned store at ``base``, enforcing the
    marker protocol: the partition count is sealed at first open and a
    mismatch is a refusal, not a remap (see module docstring)."""
    from predictionio_tpu_torch.data.storage.columnar import _ColumnarEvents
    from predictionio_tpu_torch.data.storage.replication import ReplicatedEvents

    if partitions < 1:
        raise StorageError(f"partitions must be >= 1, got {partitions}")
    if replication == 1:
        raise StorageError(
            "replication=1 is a no-op; omit it or use replication >= 2"
        )
    replicated = replication >= 2
    if replicated:
        q = ack_quorum or (replication // 2 + 1)
        if not 1 <= q <= replication:
            raise StorageError(
                f"ack_quorum must be in [1, {replication}], got {q}"
            )
    else:
        if ack_quorum:
            raise StorageError("ack_quorum requires replication >= 2")
        q = 0

    os.makedirs(base, exist_ok=True)
    marker = _read_marker(base)
    meta = {
        "partitions": partitions,
        "replication": replication if replicated else 0,
        "ackQuorum": q,
        "hash": "crc32",
    }
    if marker is None:
        if any(
            n.startswith("app_") for n in sorted(os.listdir(base))
        ):
            raise StorageError(
                f"refusing to partition existing single-stream data at "
                f"{base}: {_MIGRATE_HINT}"
            )
        _write_marker(base, meta)
    else:
        if int(marker.get("partitions", -1)) != partitions:
            raise StorageError(
                f"partition count mismatch at {base}: store was sealed "
                f"with partitions={marker.get('partitions')}, opened with "
                f"partitions={partitions}; {_MIGRATE_HINT}"
            )
        if marker.get("hash", "crc32") != "crc32":
            raise StorageError(
                f"unknown partition hash {marker.get('hash')!r} at {base}"
            )
        if marker != meta:
            # replication topology (unlike P) may change across restarts:
            # replicas re-converge via dedup'd catch-up, not rehashing
            _write_marker(base, meta)

    store_kw = dict(
        cache_segments=cache_segments,
        dedup_window=dedup_window,
        dedup_warm_bytes=dedup_warm_bytes,
    )
    stores: list[Any] = []
    for k in range(partitions):
        part_base = os.path.join(base, f"part_{k:02d}")
        if replicated:
            stores.append(
                ReplicatedEvents(
                    [
                        os.path.join(part_base, f"replica_{r}")
                        for r in range(replication)
                    ],
                    q,
                    segment_rows=segment_rows,
                    leader=k % replication,
                    name=f"p{k}",
                    **store_kw,
                )
            )
        else:
            stores.append(
                _ColumnarEvents(part_base, segment_rows, fsync, **store_kw)
            )
    return PartitionedEvents(
        stores,
        partitions,
        replicated=replicated,
        kill_partition=_parse_fault2(os.environ.get("PIO_CHAOS_KILL_PARTITION")),
        kill_replica=_parse_fault3(os.environ.get("PIO_CHAOS_KILL_REPLICA")),
    )


class PartitionedEvents(LEvents):
    """LEvents facade over P independent partition stores.

    Single-key operations route by entity hash; scans fan out and
    merge. ``ingest_chunk_partition`` is the per-partition appender
    entry the pipeline's partition threads call concurrently — each
    lands in a different store with its own lock, so the threads never
    serialize on shared state."""

    def __init__(
        self,
        stores: Sequence[Any],
        partitions: int,
        *,
        replicated: bool = False,
        kill_partition: tuple[int, int] | None = None,
        kill_replica: tuple[int, int, int] | None = None,
    ):
        self._stores = list(stores)
        self.partition_count = partitions
        self.replicated = replicated
        # chaos fault state (inert unless the env knobs were set)
        self._fault_lock = threading.Lock()
        self._kill_partition = kill_partition
        self._kill_replica = kill_replica
        self._part_rows = 0
        self._replica_rows = 0
        self._part_dead = False
        self._replica_fired = False
        if kill_partition or kill_replica:
            logger.warning(
                "chaos fault injection armed: kill_partition=%s "
                "kill_replica=%s", kill_partition, kill_replica,
            )

    # ------------------------------------------------------------ routing
    def partition_for(self, entity_type: str, entity_id: str) -> int:
        return partition_of(entity_type, entity_id, self.partition_count)

    def partition_rows(self, chunk) -> np.ndarray:
        """Per-row partition index for an EventChunk (pipeline router)."""
        n = len(chunk)
        return np.fromiter(
            (
                partition_of(et, ei, self.partition_count)
                for et, ei in zip(chunk.entity_type, chunk.entity_id)
            ),
            dtype=np.int64,
            count=n,
        )

    def store(self, p: int):
        return self._stores[p]

    def _groups(self, events: Sequence) -> dict[int, list[int]]:
        by_p: dict[int, list[int]] = {}
        for i, e in enumerate(events):
            by_p.setdefault(
                self.partition_for(e.entity_type, e.entity_id), []
            ).append(i)
        return by_p

    # ----------------------------------------------------- chaos injection
    def _check_fault(self, p: int, nrows: int, app_id, channel_id) -> None:
        """Appender-death simulation. The append that crosses the
        threshold fails with torn bytes already on the partition's tail
        (exactly what a kill -9 mid-write leaves behind); every later
        append to that partition keeps failing until a restart without
        the knob."""
        kp, kr = self._kill_partition, self._kill_replica
        if kp is not None and p == kp[0]:
            with self._fault_lock:
                if self._part_dead:
                    raise StorageError(
                        f"partition {p}: appender killed (chaos injection)"
                    )
                self._part_rows += nrows
                fire = self._part_rows >= kp[1]
                if fire:
                    self._part_dead = True
            if fire:
                self._torn_write(self._stores[p], app_id, channel_id)
                logger.warning("chaos: partition %d appender killed", p)
                raise StorageError(
                    f"partition {p}: appender killed (chaos injection)"
                )
        if kr is not None and p == kr[0] and self.replicated:
            with self._fault_lock:
                if self._replica_fired:
                    return
                self._replica_rows += nrows
                fire = self._replica_rows >= kr[2]
                if fire:
                    self._replica_fired = True
            if fire:
                store = self._stores[p]
                r = kr[1] % store.replicas
                if r == store.leader:
                    r = (r + 1) % store.replicas
                self._torn_write(
                    store.replica_store(r), app_id, channel_id
                )
                store.fail_replica(r)
                logger.warning(
                    "chaos: replica %d of partition %d killed", r, p
                )

    @staticmethod
    def _torn_write(store, app_id, channel_id) -> None:
        target = getattr(store, "leader_store", store)
        d = target._stream_dir(app_id, channel_id)
        os.makedirs(d, exist_ok=True)
        # append-mode torn garbage with no trailing newline — the
        # signature of a writer dying mid-append; the recovery sweep /
        # torn-byte isolation must absorb it without losing acked rows
        with open(os.path.join(d, "tail.jsonl"), "ab") as f:
            f.write(b'{"chaos-torn-appender"')

    # ------------------------------------------------------------- appends
    def insert(self, event, app_id, channel_id=None) -> str:
        p = self.partition_for(event.entity_type, event.entity_id)
        self._check_fault(p, 1, app_id, channel_id)
        return self._stores[p].insert(event, app_id, channel_id)

    def insert_batch(self, events, app_id, channel_id=None) -> list:
        out: list = [None] * len(events)
        for p, rows in sorted(self._groups(events).items()):
            self._check_fault(p, len(rows), app_id, channel_id)
            ids = self._stores[p].insert_batch(
                [events[i] for i in rows], app_id, channel_id
            )
            for i, eid in zip(rows, ids):
                out[i] = eid
        return out

    def insert_dedup(self, event, app_id, channel_id=None):
        return self.insert_batch_dedup([event], app_id, channel_id)[0]

    def insert_batch_dedup(self, events, app_id, channel_id=None) -> list:
        out: list = [None] * len(events)
        for p, rows in sorted(self._groups(events).items()):
            self._check_fault(p, len(rows), app_id, channel_id)
            res = self._stores[p].insert_batch_dedup(
                [events[i] for i in rows], app_id, channel_id
            )
            for i, r in zip(rows, res):
                out[i] = r
        return out

    def ingest_chunk(self, chunk, app_id, channel_id=None) -> list:
        """Serial fan-out fallback (pio import, direct callers). The
        event server's pipeline calls :meth:`ingest_chunk_partition`
        from P appender threads instead."""
        parts = self.partition_rows(chunk)
        out: list = [None] * len(chunk)
        for p in sorted(set(parts.tolist())):
            rows = np.nonzero(parts == p)[0]
            res = self.ingest_chunk_partition(
                chunk.take(rows), app_id, channel_id, int(p)
            )
            for i, r in zip(rows.tolist(), res):
                out[i] = r
        return out

    def ingest_chunk_partition(
        self, chunk, app_id, channel_id, p: int
    ) -> list:
        """Append one partition's (already-routed) sub-chunk. Raises
        with the partition named on failure — the pipeline turns that
        into per-line errors for THIS partition's rows only."""
        self._check_fault(p, len(chunk), app_id, channel_id)
        try:
            return self._stores[p].ingest_chunk(chunk, app_id, channel_id)
        except StorageError:
            raise
        except Exception as e:
            raise StorageError(f"partition {p}: {e}") from e

    # --------------------------------------------------------------- reads
    def get(self, event_id, app_id, channel_id=None):
        for s in self._stores:
            e = s.get(event_id, app_id, channel_id)
            if e is not None:
                return e
        return None

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        return any(
            s.delete(event_id, app_id, channel_id) for s in self._stores
        )

    def find(
        self,
        app_id,
        channel_id=None,
        start_time=None,
        until_time=None,
        entity_type=None,
        entity_id=None,
        event_names=None,
        target_entity_type=None,
        target_entity_id=None,
        limit=None,
        reversed=False,
    ) -> Iterator:
        if entity_type is not None and entity_id is not None:
            # fully-routed point query: one partition holds the entity
            stores = [self._stores[self.partition_for(entity_type, entity_id)]]
        else:
            stores = self._stores
        out: list = []
        for s in stores:
            out.extend(
                s.find(
                    app_id, channel_id, start_time, until_time, entity_type,
                    entity_id, event_names, target_entity_type,
                    target_entity_id, limit, reversed,
                )
            )
        out.sort(key=BaseStorageClient.sorted_events_key, reverse=reversed)
        if limit is not None:
            if limit == 0:
                return iter(())
            if limit > 0:  # negative = unbounded (contract)
                out = out[:limit]
        return iter(out)

    def find_columns(self, app_id, channel_id=None, partition=None, **kw):
        if partition is not None:
            return self._stores[partition].find_columns(
                app_id, channel_id, **kw
            )
        if kw.get("segments") is not None or kw.get("tail_skip"):
            raise StorageError(
                "incremental find_columns on a partitioned store requires "
                "partition= (per-partition scan_state manifests)"
            )
        from predictionio_tpu_torch.data.columns import EventColumns
        from predictionio_tpu_torch.data.storage.columnar import _merge_vocabs

        parts = [
            s.find_columns(app_id, channel_id, **kw) for s in self._stores
        ]
        nonempty = [c for c in parts if len(c)]
        if len(nonempty) <= 1:
            return nonempty[0] if nonempty else parts[0]
        ev_code, ev_vocab = _merge_vocabs(
            [(c.event_code, c.event_vocab) for c in nonempty]
        )
        ent_code, ent_vocab = _merge_vocabs(
            [(c.entity_code, c.entity_vocab) for c in nonempty]
        )
        tgt_code, tgt_vocab = _merge_vocabs(
            [(c.target_code, c.target_vocab) for c in nonempty],
            allow_missing=True,
        )
        prop = (
            np.concatenate([c.prop for c in nonempty])
            if nonempty[0].prop is not None
            else None
        )
        return EventColumns(
            event_code=ev_code,
            event_vocab=ev_vocab,
            entity_code=ent_code,
            entity_vocab=ent_vocab,
            target_code=tgt_code,
            target_vocab=tgt_vocab,
            event_time_us=np.concatenate(
                [c.event_time_us for c in nonempty]
            ),
            prop=prop,
        )

    # ------------------------------------------------------- tail following
    def tail_follow(
        self, app_id, channel_id=None, cursor=None, from_start=False,
        partition=None,
    ):
        if partition is None:
            if self.partition_count != 1:
                raise StorageError(
                    "tail_follow on a partitioned store requires "
                    "partition= (one follower per partition)"
                )
            partition = 0
        return self._stores[partition].tail_follow(
            app_id, channel_id, cursor, from_start
        )

    def scan_state(self, app_id, channel_id=None, partition=None) -> dict:
        if partition is not None:
            return self._stores[partition].scan_state(app_id, channel_id)
        states = [
            s.scan_state(app_id, channel_id) for s in self._stores
        ]
        return {
            "stream_id": "|".join(s["stream_id"] for s in states),
            "segments": [
                f"p{k}/{name}"
                for k, s in enumerate(states)
                for name in s["segments"]
            ],
            "tail_lines": sum(s["tail_lines"] for s in states),
            "tombstones": sum(s["tombstones"] for s in states),
            "compactions": sum(s["compactions"] for s in states),
            "partitions": states,
        }

    # ------------------------------------------------------ offline / admin
    def bulk_write(self, events: Iterable, app_id, channel_id=None) -> None:
        batch = list(events)
        for p, rows in sorted(self._groups(batch).items()):
            self._stores[p].bulk_write(
                [batch[i] for i in rows], app_id, channel_id
            )

    def write_columns(self, app_id, channel_id=None, **kw) -> int:
        entity_type = kw["entity_type"]
        entity_codes = np.asarray(kw["entity_codes"], np.int32)
        entity_vocab = np.asarray(kw["entity_vocab"], np.str_)
        part_of_vocab = np.fromiter(
            (
                partition_of(entity_type, str(v), self.partition_count)
                for v in entity_vocab
            ),
            dtype=np.int64,
            count=entity_vocab.shape[0],
        )
        row_parts = part_of_vocab[entity_codes]
        written = 0
        event = kw.get("event")
        for p in sorted(set(row_parts.tolist())):
            mask = row_parts == p
            sub = dict(kw)
            sub["entity_codes"] = entity_codes[mask]
            if not isinstance(event, str):
                sub["event"] = (np.asarray(event[0], np.int32)[mask], event[1])
            sub["event_time_us"] = np.asarray(
                kw["event_time_us"], np.int64
            )[mask]
            if kw.get("creation_time_us") is not None:
                sub["creation_time_us"] = np.asarray(
                    kw["creation_time_us"], np.int64
                )[mask]
            if kw.get("target_codes") is not None:
                sub["target_codes"] = np.asarray(
                    kw["target_codes"], np.int32
                )[mask]
            if kw.get("props"):
                sub["props"] = {
                    name: np.asarray(col)[mask]
                    for name, col in kw["props"].items()
                }
            written += self._stores[int(p)].write_columns(
                app_id, channel_id, **sub
            )
        return written

    def init(self, app_id, channel_id=None) -> bool:
        ok = True
        for s in self._stores:
            ok = s.init(app_id, channel_id) and ok
        return ok

    def remove(self, app_id, channel_id=None) -> bool:
        ok = True
        for s in self._stores:
            ok = s.remove(app_id, channel_id) and ok
        return ok

    def compact(self, app_id, channel_id=None, partition=None) -> int:
        if partition is not None:
            return self._stores[partition].compact(app_id, channel_id)
        return sum(s.compact(app_id, channel_id) for s in self._stores)

    def stream_stats(self) -> list:
        """Aggregated per-(app, channel) stats — the compaction
        scheduler's watermark inputs sum across partitions so its
        byte thresholds keep their meaning."""
        agg: dict[tuple, dict] = {}
        for k, s in enumerate(self._stores):
            for st in s.stream_stats():
                key = (st["app_id"], st["channel_id"])
                cur = agg.setdefault(
                    key,
                    {
                        "app_id": st["app_id"],
                        "channel_id": st["channel_id"],
                        "tail_bytes": 0,
                        "dead_tail_tombstones": 0,
                        "segments": 0,
                        "compactions": 0,
                    },
                )
                for f in ("tail_bytes", "dead_tail_tombstones", "segments",
                          "compactions"):
                    cur[f] += st[f]
        return [agg[k] for k in sorted(agg, key=lambda t: (t[0], t[1] or -1))]

    def stream_stats_partitioned(self) -> list:
        """Per-partition stats for /stats.json's partitions section."""
        out = []
        for k, s in enumerate(self._stores):
            out.append({"partition": k, "streams": s.stream_stats()})
        return out

    def replication_health(self) -> list | None:
        """Per-partition replication health, None when not replicated."""
        if not self.replicated:
            return None
        return [
            {"partition": k, **s.replication_health()}
            for k, s in enumerate(self._stores)
        ]

    def dedup_warm_stats(self) -> dict:
        ms = 0.0
        streams = 0
        for s in self._stores:
            w = s.dedup_warm_stats()
            ms += w["dedupWarmMs"]
            streams += w["dedupWarmedStreams"]
        return {"dedupWarmMs": round(ms, 3), "dedupWarmedStreams": streams}

    def sweep_recovery(self) -> dict:
        agg: dict = {
            "streams": 0,
            "quarantined": [],
            "replayedCommits": 0,
            "tornTailLines": 0,
            "dedupWarmMs": 0.0,
            "dedupWarmedStreams": 0,
        }
        for k, s in enumerate(self._stores):
            rep = s.sweep_recovery()
            agg["quarantined"].extend(
                f"part_{k:02d}:{p}" for p in rep.get("quarantined", ())
            )
            for key in ("streams", "replayedCommits", "tornTailLines",
                        "dedupWarmMs", "dedupWarmedStreams"):
                agg[key] += rep.get(key, 0)
        return agg

    def close(self) -> None:
        for s in self._stores:
            s.close()


class PartitionedPEvents(PEvents):
    """PEvents facade: fan-out scans, entity-routed bulk writes."""

    def __init__(self, events: PartitionedEvents):
        self._e = events

    def find(
        self,
        app_id,
        channel_id=None,
        start_time=None,
        until_time=None,
        entity_type=None,
        entity_id=None,
        event_names=None,
        target_entity_type=None,
        target_entity_id=None,
        shard_index: int = 0,
        num_shards: int = 1,
    ) -> Iterator:
        for i, e in enumerate(
            self._e.find(
                app_id, channel_id, start_time, until_time, entity_type,
                entity_id, event_names, target_entity_type, target_entity_id,
            )
        ):
            if i % num_shards == shard_index:
                yield e

    def write(self, events: Iterable, app_id, channel_id=None) -> None:
        self._e.bulk_write(events, app_id, channel_id)

    def delete(self, app_id, channel_id=None) -> None:
        self._e.remove(app_id, channel_id)
        self._e.init(app_id, channel_id)

    def write_columns(self, app_id, channel_id=None, **kw) -> int:
        return self._e.write_columns(app_id, channel_id, **kw)

    def compact(self, app_id, channel_id=None) -> int:
        return self._e.compact(app_id, channel_id)

    def find_columns(self, app_id, channel_id=None, **kw):
        return self._e.find_columns(app_id, channel_id, **kw)

    def scan_state(self, app_id, channel_id=None, partition=None) -> dict:
        return self._e.scan_state(app_id, channel_id, partition=partition)

    def tail_follow(
        self, app_id, channel_id=None, cursor=None, from_start=False,
        partition=None,
    ):
        return self._e.tail_follow(
            app_id, channel_id, cursor, from_start, partition=partition
        )
