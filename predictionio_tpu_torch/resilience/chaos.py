"""Kill-9 chaos harness for the ingestion path (``pio chaos-ingest``),
and the serving drills (``pio chaos-serve``, ``pio chaos-fleet``).

Counterpart of ``predictionio_tpu/resilience/chaos.py``: the same drills
and verdicts, run on the port's processes (every process it starts is
``python -m predictionio_tpu_torch.tools.console``). The serving drills
train and deploy on ``device`` (the card unless the caller asks for the
CPU). Every process a drill starts runs in a session of its own, and the
drill SIGKILLs what is left of each session before it returns, so
nothing it started outlives it, ``keep_dir`` runs included.

Nothing in a test suite proves crash safety like actually crashing: this
harness spawns a **real event-server subprocess** on a scratch storage
directory, drives concurrent retrying writers against it over real HTTP,
SIGKILLs the server at seeded-random points mid-traffic (including while
a deliberately torn request body is on the wire), restarts it, and at
the end verifies the three invariants the rest of this repo's
crash-safety work exists to provide:

1. **zero acked loss** — every event the server acknowledged (HTTP 201)
   before any kill is present after the final restart;
2. **zero duplicates** — retried writes (same client ``eventId``) never
   double-count: the storage dedup index absorbs them;
3. **clean recovery** — the startup sweep leaves no unquarantined torn
   files (``*.tmp`` / ``*.pending``) anywhere in the store.

A final **drain phase** SIGTERMs a server started with
``--drain-deadline-s`` while writers are in flight and asserts it exits
0 within the deadline with no raw 500s (late arrivals get clean 503 +
``Retry-After``).

Writer-side faults are scheduled through the deterministic
:class:`~predictionio_tpu_torch.resilience.faults.FaultInjector` — just before
each kill the injector aborts a burst of writer calls client-side, so
the "request abandoned exactly at the kill point" path is exercised on
every cycle, not only when the race happens to land.

A run passes with >= 3 kill cycles, ``ackedLost == 0`` and
``duplicates == 0``.

Stdlib-only by contract (the resilience package's piolint manifest
entry): the harness drives the server over the wire and inspects the
store through the filesystem and the REST API — it never imports the
storage layer it is trying to catch lying.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib
from typing import Any

from predictionio_tpu_torch.resilience.faults import FaultError, FaultInjector

__all__ = [
    "ChaosConfig",
    "ChaosError",
    "FleetChaosConfig",
    "ServeChaosConfig",
    "run_chaos_fleet",
    "run_chaos_ingest",
    "run_chaos_partitioned",
    "run_chaos_serve",
]

_ACCESS_KEY = "chaos-ingest-key"
_APP_NAME = "chaosapp"


class ChaosError(RuntimeError):
    """The harness itself could not run (setup/spawn failure) — distinct
    from a chaos verdict, which is reported, not raised."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Knobs of one chaos run (CLI: ``pio chaos-ingest``)."""

    cycles: int = 3  # SIGKILL/restart cycles
    writers: int = 4
    events_per_writer: int = 120  # across the whole run, per writer
    backend: str = "sqlite"  # sqlite | columnar (columnar forces FSYNC=true)
    seed: int = 0
    #: events streamed through POST /events/bulk.json in the bulk-writer
    #: phase (SIGKILL lands mid-stream; the whole stream is retried with
    #: the same ids until a clean summary). 0 disables the phase.
    bulk_events: int = 1000
    drain_deadline_s: float = 5.0  # the SIGTERM-under-load phase
    #: >1 adds the partitioned-ingest drill: a columnar store with
    #: PARTITIONS=P (its own scratch dir — partitioned stores are sealed
    #: by a marker and never share a path with a plain one), one
    #: partition's appender chaos-killed mid-bulk-stream (torn tail bytes
    #: + dead thread — the in-process kill-9 signature), then a real
    #: whole-server SIGKILL mid-retry. Verdict: zero acked loss, zero
    #: duplicates, surviving partitions kept storing while the victim
    #: failed, and the killed partition catches up after restart.
    partitions: int = 1
    #: with ``partitions``: replicate each partition across N stores and
    #: require ``ack_quorum`` fsync-durable copies per ack; the drill then
    #: also kills one non-leader replica (quorum loss must fail that
    #: partition's appends loudly and flip /readyz) and asserts replica
    #: catch-up after restart
    replication: int = 0
    ack_quorum: int = 0  # 0 = majority default (replication//2 + 1)
    startup_timeout_s: float = 60.0
    #: overall wall-clock budget; expiry fails the run rather than hanging CI
    total_timeout_s: float = 300.0
    base_dir: str | None = None  # None = fresh tempdir
    keep_dir: bool = False

    def __post_init__(self) -> None:
        if self.backend not in ("sqlite", "columnar"):
            raise ValueError("backend must be 'sqlite' or 'columnar'")
        if self.cycles < 1 or self.writers < 1 or self.events_per_writer < 1:
            raise ValueError("cycles, writers, events_per_writer must be >= 1")
        if self.partitions < 1:
            raise ValueError("partitions must be >= 1")
        if self.replication < 0 or self.replication == 1:
            raise ValueError("replication must be 0 (off) or >= 2")
        if self.ack_quorum and not self.replication:
            raise ValueError("ack-quorum requires replication")
        if self.replication and self.ack_quorum > self.replication:
            raise ValueError("ack-quorum cannot exceed replication")
        if self.replication and self.partitions < 2:
            raise ValueError(
                "the replicated drill needs partitions >= 2: the replica "
                "kill must leave OTHER partitions making progress"
            )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _console(*args: str) -> list[str]:
    """The argv of one port console command."""
    return [sys.executable, "-m", "predictionio_tpu_torch.tools.console", *args]


def _spawn(argv: list[str], env: dict, **kwargs) -> subprocess.Popen:
    """Start one drill process as the leader of a new session: whatever
    it starts (a fleet router's replicas) joins its process group, which
    :func:`_end_group` ends."""
    return subprocess.Popen(argv, env=env, start_new_session=True, **kwargs)


def _group_members(pgid: int) -> list[int]:
    """Live (not zombie) processes of process group ``pgid``, from
    ``/proc``."""
    members = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] != "Z" and int(fields[2]) == pgid:
            members.append(int(entry))
    return members


def _end_group(proc: subprocess.Popen, wait_s: float = 30.0) -> None:
    """SIGKILL every process left in ``proc``'s session group (``proc``
    led it), reap ``proc``, and wait until no member runs."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    try:
        proc.wait(timeout=wait_s)
    except subprocess.TimeoutExpired:
        pass
    deadline = time.monotonic() + wait_s
    while _group_members(proc.pid) and time.monotonic() < deadline:
        time.sleep(0.05)


def _run_console(env: dict, args: list[str], timeout_s: float) -> subprocess.CompletedProcess:
    """One console command to its end (``subprocess.run``, in a session
    of its own: a timeout ends the command and whatever it started)."""
    proc = _spawn(_console(*args), env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    finally:
        _end_group(proc)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


class _ServerProc:
    """One event-server subprocess on a fixed port + scratch storage env."""

    def __init__(self, env: dict, port: int, extra_args: tuple[str, ...] = ()):
        self.port = port
        self.proc = _spawn(
            _console("eventserver", "--ip", "127.0.0.1", "--port", str(port), *extra_args),
            env,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )

    def wait_ready(self, timeout_s: float) -> float:
        """Poll ``/readyz`` until 200; returns seconds to readiness."""
        t0 = time.monotonic()
        url = f"http://127.0.0.1:{self.port}/readyz"
        while time.monotonic() - t0 < timeout_s:
            if self.proc.poll() is not None:
                raise ChaosError(
                    f"event server exited rc={self.proc.returncode} before ready"
                )
            try:
                with urllib.request.urlopen(url, timeout=2) as resp:
                    if resp.status == 200:
                        return time.monotonic() - t0
            except Exception:
                pass
            time.sleep(0.05)
        raise ChaosError(f"event server not ready within {timeout_s:g}s")

    def kill9(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=30)

    def sigterm(self) -> None:
        self.proc.send_signal(signal.SIGTERM)

    def stop(self) -> None:
        _end_group(self.proc)


class _Writers:
    """Concurrent retrying writers. Each event carries a deterministic
    client ``eventId``; any transport failure or non-201 answer is
    retried with the SAME id — the idempotent-ingestion contract is what
    makes this loop safe, and this harness is what proves it."""

    def __init__(self, port: int, n_writers: int, per_writer: int,
                 injector: FaultInjector, stop: threading.Event, seed: int):
        self.port = port
        self.injector = injector
        self.stop = stop
        self.acked: dict[str, int] = {}  # eventId -> ack count (1 expected)
        self.duplicate_acks = 0  # 201s with "duplicate": true (retries absorbed)
        #: an already-acked id re-sent WITHOUT the duplicate flag coming
        #: back means the server double-stored it — the core violation
        self.dedup_violations = 0
        self._lock = threading.Lock()
        self._threads = [
            threading.Thread(
                target=self._run, name=f"chaos-writer-{w}",
                args=(w, per_writer, random.Random(seed * 1000 + w)),
                daemon=True,
            )
            for w in range(n_writers)
        ]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def done(self) -> bool:
        return all(not t.is_alive() for t in self._threads)

    def acked_count(self) -> int:
        with self._lock:
            return len(self.acked)

    def join(self, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        return self.done()

    def _post(self, event_id: str, payload: bytes) -> dict:
        # the injector sits on the CLIENT side: a scheduled fault aborts
        # this call exactly where a kill-9'd connection would
        self.injector.before_call("writer-post")
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/events.json?accessKey={_ACCESS_KEY}",
            data=payload,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=5) as resp:
            return json.loads(resp.read())

    def _run(self, writer: int, per_writer: int, rng: random.Random) -> None:
        for i in range(per_writer):
            event_id = f"w{writer}-e{i:05d}"
            payload = json.dumps(
                {
                    "eventId": event_id,
                    "event": "rate",
                    "entityType": "user",
                    "entityId": f"u{writer}",
                    "targetEntityType": "item",
                    "targetEntityId": f"i{i % 97}",
                    "properties": {"rating": float(1 + i % 5)},
                }
            ).encode()
            while not self.stop.is_set():
                try:
                    body = self._post(event_id, payload)
                except (urllib.error.URLError, urllib.error.HTTPError,
                        ConnectionError, TimeoutError, OSError, FaultError):
                    # server down / mid-kill / injected abort: back off a
                    # touch and re-send the SAME eventId
                    time.sleep(0.05 + rng.random() * 0.15)
                    continue
                if body.get("eventId"):
                    with self._lock:
                        self.acked[event_id] = self.acked.get(event_id, 0) + 1
                        if body.get("duplicate"):
                            self.duplicate_acks += 1
                    if rng.random() < 0.15:
                        # deliberate retransmit of an ALREADY-acked event:
                        # the lost-ack retry in miniature, forced often
                        # enough to prove dedup rather than hoping the
                        # kill window produces it. Best-effort — a kill
                        # racing the probe is fine, a missing duplicate
                        # flag on a delivered answer is not.
                        try:
                            again = self._post(event_id, payload)
                        except Exception:
                            pass
                        else:
                            with self._lock:
                                if again.get("duplicate"):
                                    self.duplicate_acks += 1
                                else:
                                    self.dedup_violations += 1
                    break
                time.sleep(0.05 + rng.random() * 0.15)
            else:
                return  # harness timed out; report what was acked so far


def _torn_request(port: int, event_id: str) -> None:
    """Send a request whose body stops halfway (Content-Length promises
    more) and abandon the socket — the classic torn write a crashing
    client (or a server kill mid-read) produces. The server must never
    ack it, and no storage garbage may survive it unquarantined."""
    body = json.dumps(
        {
            "eventId": event_id,
            "event": "rate",
            "entityType": "user",
            "entityId": "torn",
            "targetEntityType": "item",
            "targetEntityId": "torn",
        }
    ).encode()
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=2) as s:
            head = (
                f"POST /events.json?accessKey={_ACCESS_KEY} HTTP/1.1\r\n"
                f"Host: 127.0.0.1:{port}\r\n"
                "Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n\r\n"
            ).encode()
            s.sendall(head + body[: len(body) // 2])
            # abandon mid-body; RST on close
    except OSError:
        pass  # server may already be dead — the tear still happened


def _storage_env(base: str, backend: str) -> dict:
    env = dict(os.environ)
    # children must resolve predictionio_tpu_torch regardless of the caller's
    # cwd or install state (same injection `pio run` performs)
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env["PYTHONPATH"] = (
        pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    ).rstrip(os.pathsep)
    env["PIO_FS_BASEDIR"] = str(base)
    env["PIO_STORAGE_REPOSITORIES_METADATA_SOURCE"] = "CHAOS_META"
    env["PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE"] = "CHAOS_FS"
    env["PIO_STORAGE_SOURCES_CHAOS_META_TYPE"] = "sqlite"
    env["PIO_STORAGE_SOURCES_CHAOS_META_PATH"] = os.path.join(base, "meta.db")
    env["PIO_STORAGE_SOURCES_CHAOS_FS_TYPE"] = "localfs"
    env["PIO_STORAGE_SOURCES_CHAOS_FS_PATH"] = os.path.join(base, "models")
    if backend == "sqlite":
        env["PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE"] = "CHAOS_META"
    else:
        env["PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE"] = "CHAOS_COL"
        env["PIO_STORAGE_SOURCES_CHAOS_COL_TYPE"] = "columnar"
        env["PIO_STORAGE_SOURCES_CHAOS_COL_PATH"] = os.path.join(base, "events")
        # "acked == durable" is only a promise when the tail is fsync'd
        env["PIO_STORAGE_SOURCES_CHAOS_COL_FSYNC"] = "true"
    return env


def _setup_app(env: dict) -> None:
    proc = _run_console(env, ["app", "new", _APP_NAME, "--access-key", _ACCESS_KEY], 120)
    if proc.returncode != 0:
        raise ChaosError(f"app setup failed: {proc.stderr[-500:]}")


def _fetch_all_events(port: int) -> list[dict]:
    url = (
        f"http://127.0.0.1:{port}/events.json?accessKey={_ACCESS_KEY}&limit=-1"
    )
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def _unquarantined_torn_files(base: str) -> list[str]:
    """Any ``*.tmp`` / ``*.pending`` file outside a ``quarantine/`` dir
    is a torn write the recovery sweep missed."""
    bad: list[str] = []
    for root, dirs, files in os.walk(base):
        if "quarantine" in root.split(os.sep):
            continue
        for name in files:
            if name.endswith((".tmp", ".pending", ".pending.tmp", ".repair")):
                bad.append(os.path.join(root, name))
    return sorted(bad)


class _BulkStreamAttempt:
    """One full-duplex attempt at streaming the bulk payload: the
    sender thread (caller) trickles chunked-transfer frames while a
    reader thread collects the per-chunk NDJSON statuses as they
    arrive — so a SIGKILL mid-stream leaves a truthful record of
    exactly which chunks were ACKED before the socket died."""

    def __init__(self, port: int):
        self.statuses: list[dict] = []
        self.summary: dict | None = None
        self.error: str | None = None
        self._sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        head = (
            f"POST /events/bulk.json?accessKey={_ACCESS_KEY}&chunkRows=200 "
            "HTTP/1.1\r\n"
            f"Host: 127.0.0.1:{port}\r\n"
            "Content-Type: application/x-ndjson\r\n"
            "Transfer-Encoding: chunked\r\n\r\n"
        ).encode()
        self._sock.sendall(head)
        self._reader = threading.Thread(
            target=self._read_response, name="chaos-bulk-reader", daemon=True
        )
        self._reader.start()

    def send_piece(self, piece: bytes) -> None:
        self._sock.sendall(
            f"{len(piece):X}\r\n".encode() + piece + b"\r\n"
        )

    def finish_send(self) -> None:
        self._sock.sendall(b"0\r\n\r\n")

    def _read_response(self) -> None:
        try:
            f = self._sock.makefile("rb")
            status_line = f.readline()
            if b"200" not in status_line:
                self.error = f"unexpected status {status_line!r}"
                return
            while True:  # headers
                line = f.readline()
                if not line or line in (b"\r\n", b"\n"):
                    break
            buf = b""
            while True:  # de-chunk the response stream
                size_line = f.readline()
                if not size_line:
                    break
                size = int(size_line.split(b";")[0].strip() or b"0", 16)
                if size == 0:
                    break
                buf += f.read(size)
                f.read(2)
                while b"\n" in buf:
                    line, _, buf = buf.partition(b"\n")
                    if not line.strip():
                        continue
                    obj = json.loads(line)
                    if obj.get("done"):
                        self.summary = obj
                    else:
                        self.statuses.append(obj)
        except (OSError, ValueError) as e:
            self.error = str(e)

    def wait(self, timeout_s: float) -> None:
        self._reader.join(timeout=timeout_s)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _bulk_phase(env: dict, cfg: ChaosConfig, rng: random.Random,
                base: str) -> dict:
    """Bulk-route chaos: stream ``bulk_events`` NDJSON events with
    deterministic client ids through ``POST /events/bulk.json``
    (chunked transfer, trickled), SIGKILL the server mid-stream, then
    retry the WHOLE stream with the same ids until a clean summary —
    while a side writer keeps single-event POSTs flowing so the tail
    (and, on the columnar backend, the background compaction scheduler
    started via ``--compact-*``) churns underneath. Verdict: every
    acked chunk's events survive exactly once, retries are absorbed as
    duplicates, no unquarantined torn chunk files remain."""
    port = _free_port()
    extra: tuple[str, ...] = ("--stats",)
    if cfg.backend == "columnar":
        # aggressive scheduler: compaction generation bumps land DURING
        # the bulk stream and the kill window
        extra += (
            "--compact-interval-s", "0.3",
            "--compact-tail-mb", "0.0001",
            "--compact-min-interval-s", "0.2",
        )
    server = _ServerProc(env, port, extra_args=extra)
    lines = [
        json.dumps(
            {
                "eventId": f"bulk-e{i:05d}",
                "event": "rate",
                "entityType": "user",
                "entityId": f"bu{i % 13}",
                "targetEntityType": "item",
                "targetEntityId": f"bi{i % 41}",
                "properties": {"rating": float(1 + i % 5)},
            }
        ).encode() + b"\n"
        for i in range(cfg.bulk_events)
    ]
    ids = [f"bulk-e{i:05d}" for i in range(cfg.bulk_events)]
    stop_side = threading.Event()
    side_acked: dict[str, int] = {}
    side_lock = threading.Lock()

    def side_writer() -> None:
        i = 0
        while not stop_side.is_set():
            i += 1
            eid = f"bside-e{i:05d}"
            payload = json.dumps(
                {
                    "eventId": eid,
                    "event": "rate",
                    "entityType": "user",
                    "entityId": "side",
                    "targetEntityType": "item",
                    "targetEntityId": f"si{i % 7}",
                }
            ).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/events.json?accessKey={_ACCESS_KEY}",
                data=payload,
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            try:
                with urllib.request.urlopen(req, timeout=5) as resp:
                    body = json.loads(resp.read())
            except Exception:
                time.sleep(0.05)
                continue
            if body.get("eventId"):
                with side_lock:
                    side_acked[eid] = side_acked.get(eid, 0) + 1
            time.sleep(0.01)

    acked_chunk_ids: set[str] = set()
    kills = 0
    attempts = 0
    report: dict[str, Any] = {"events": cfg.bulk_events}
    try:
        server.wait_ready(cfg.startup_timeout_s)
        side = threading.Thread(target=side_writer, daemon=True,
                                name="chaos-bulk-side")
        side.start()
        deadline = time.monotonic() + cfg.total_timeout_s / 2
        summary = None
        while summary is None and time.monotonic() < deadline:
            attempts += 1
            kill_this_attempt = kills == 0
            kill_at = rng.uniform(0.3, 0.7) * len(lines)
            try:
                attempt = _BulkStreamAttempt(port)
            except OSError:
                time.sleep(0.1)
                continue
            try:
                sent = 0
                for lo in range(0, len(lines), 100):
                    attempt.send_piece(b"".join(lines[lo:lo + 100]))
                    sent += 100
                    time.sleep(0.005)
                    if kill_this_attempt and sent >= kill_at:
                        server.kill9()
                        kills += 1
                        break
                else:
                    attempt.finish_send()
                    attempt.wait(30.0)
                    summary = attempt.summary
            except OSError:
                pass  # mid-kill socket death: the retry owns recovery
            finally:
                attempt.wait(2.0)
                for st in attempt.statuses:
                    lo = int(st.get("lineStart", 0))
                    n = int(st.get("received", 0))
                    if st.get("storageError") is None:
                        acked_chunk_ids.update(ids[lo:lo + n])
                attempt.close()
            if kill_this_attempt and kills:
                server = _ServerProc(env, port, extra_args=extra)
                server.wait_ready(cfg.startup_timeout_s)
        compactions = None
        if cfg.backend == "columnar" and summary is not None:
            # the side writer keeps the tail growing past the (tiny)
            # watermark; wait for the scheduler to actually fire so the
            # exactly-once verification below runs AGAINST a generation
            # bump, not merely next to a dormant thread
            stats_url = (
                f"http://127.0.0.1:{port}/stats.json?accessKey={_ACCESS_KEY}"
            )
            wait_until = time.monotonic() + 5.0
            while time.monotonic() < wait_until:
                try:
                    with urllib.request.urlopen(stats_url, timeout=5) as resp:
                        compactions = (
                            json.loads(resp.read())
                            .get("compaction", {})
                            .get("compactions")
                        )
                except Exception:
                    compactions = None
                if compactions:
                    break
                time.sleep(0.2)
        stop_side.set()
        side.join(timeout=10)
        if cfg.backend == "columnar":
            # the scheduler compacts the side writer's last events after
            # it stops; a compaction in flight stages *.pending files, so
            # the torn-file scan below waits for it to finish
            _await_compactions_settled(port, base, settle_s=1.5, timeout_s=30.0)
        stored = _fetch_all_events(port)
        counts: dict[str, int] = {}
        for evd in stored:
            eid = evd.get("eventId") or ""
            counts[eid] = counts.get(eid, 0) + 1
        bulk_lost = sorted(
            e for e in acked_chunk_ids if counts.get(e, 0) == 0
        )
        bulk_dups = sorted(
            e for e in counts
            if e.startswith(("bulk-", "bside-")) and counts[e] > 1
        )
        with side_lock:
            side_lost = sorted(
                e for e in side_acked if counts.get(e, 0) == 0
            )
        report.update(
            attempts=attempts,
            kills=kills,
            completed=summary is not None,
            summary=summary,
            ackedChunkEvents=len(acked_chunk_ids),
            ackedLost=len(bulk_lost),
            ackedLostIds=bulk_lost[:20],
            duplicates=len(bulk_dups),
            duplicateIds=bulk_dups[:20],
            sideAcked=len(side_acked),
            sideAckedLost=len(side_lost),
            schedulerCompactions=compactions,
        )
        torn = _unquarantined_torn_files(base)
        report.update(unquarantinedTornFiles=len(torn), unquarantinedTornFilePaths=torn[:20])
    finally:
        stop_side.set()
        server.stop()
    report["ok"] = bool(
        report.get("completed")
        and report.get("kills", 0) >= 1
        and report.get("ackedLost") == 0
        and report.get("duplicates") == 0
        and report.get("sideAckedLost") == 0
        and report.get("unquarantinedTornFiles") == 0
        and (report.get("summary") or {}).get("stored", 0)
        + (report.get("summary") or {}).get("duplicates", 0)
        == cfg.bulk_events
        # columnar runs the background scheduler underneath the phase;
        # a run where it never fired proves nothing about coordination
        and (
            cfg.backend != "columnar"
            or bool(report.get("schedulerCompactions"))
        )
    )
    return report


def _await_compactions_settled(port: int, base: str, settle_s: float, timeout_s: float) -> None:
    """Until the event server's compaction count has not moved for
    ``settle_s`` and no compaction's staged file is in the store (at most
    ``timeout_s``: a torn file the recovery sweep missed never goes, and
    the scan after this counts it)."""
    url = f"http://127.0.0.1:{port}/stats.json?accessKey={_ACCESS_KEY}"
    last, since = None, time.monotonic()
    deadline = since + timeout_s
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                count = (json.loads(resp.read()).get("compaction") or {}).get("compactions")
        except Exception:
            count = None
        if count != last:
            last, since = count, time.monotonic()
        elif time.monotonic() - since >= settle_s and not _unquarantined_torn_files(base):
            return
        time.sleep(0.1)


def _partition_of(entity_type: str, entity_id: str, partitions: int) -> int:
    """Inline recomputation of the store's crc32 entity routing. The
    harness is stdlib-only by contract and must not import the storage
    layer it is auditing — an independent copy of the hash is the point:
    if the store ever drifts from it, the killed-partition catch-up
    check fails loudly."""
    return zlib.crc32(f"{entity_type}\x00{entity_id}".encode()) % partitions


def _acked_ids(status: dict, ids: list[str]) -> list[str]:
    """Event ids one bulk chunk status ACKED: every received line minus
    the per-line failures. A whole-chunk ``storageError`` or a truncated
    error list acks nothing — the bar is "no acked event may be lost",
    so under-counting acks is always the safe direction."""
    if status.get("storageError") is not None or status.get("errorsTruncated"):
        return []
    lo = int(status.get("lineStart", 0))
    n = int(status.get("received", 0))
    failed = {
        int(e.get("line", -1))
        for e in status.get("errors", ())
        if int(e.get("status", 0)) >= 400
    }
    return [ids[i] for i in range(lo, min(lo + n, len(ids))) if i not in failed]


def _get_json(port: int, path: str, timeout_s: float = 5.0):
    url = f"http://127.0.0.1:{port}{path}?accessKey={_ACCESS_KEY}"
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return json.loads(resp.read())
    except Exception:
        return None


def _wait_http_status(
    port: int, path: str, want: int, timeout_s: float
) -> bool:
    """Poll ``path`` until it answers with status ``want``."""
    deadline = time.monotonic() + timeout_s
    url = f"http://127.0.0.1:{port}{path}"
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=2) as resp:
                code = resp.status
        except urllib.error.HTTPError as e:
            e.read()
            code = e.code
        except Exception:
            code = 0
        if code == want:
            return True
        time.sleep(0.1)
    return False


def _partitioned_env(base: str, cfg: ChaosConfig) -> tuple[dict, str]:
    """Columnar EVENTDATA env with PARTITIONS (and, when configured,
    REPLICATION/ACK_QUORUM) on a drill-private store dir — a partitioned
    store is sealed by its ``partitions.json`` marker and must never
    share a path with the plain store the other phases use."""
    env = _storage_env(base, "columnar")
    store_dir = os.path.join(base, "events_part")
    env["PIO_STORAGE_SOURCES_CHAOS_COL_PATH"] = store_dir
    env["PIO_STORAGE_SOURCES_CHAOS_COL_PARTITIONS"] = str(cfg.partitions)
    if cfg.replication:
        env["PIO_STORAGE_SOURCES_CHAOS_COL_REPLICATION"] = str(cfg.replication)
        env["PIO_STORAGE_SOURCES_CHAOS_COL_ACK_QUORUM"] = str(
            cfg.ack_quorum or cfg.replication // 2 + 1
        )
    return env, store_dir


def _partitioned_phase(cfg: ChaosConfig, rng: random.Random, base: str) -> dict:
    """The kill-one-partition drill. One bulk stream against a
    P-partition store whose busiest partition's appender is chaos-killed
    mid-stream (torn tail bytes, then every later append on it fails —
    the in-process kill-9 signature; a thread cannot be SIGKILLed alone),
    and, with replication on, one non-leader replica of a second
    partition is killed the same way so its quorum is lost. Then a real
    whole-server SIGKILL mid-retry, a clean-env restart, and retries of
    the WHOLE stream with the same ids until a clean summary.

    Verdict fields: zero acked loss, zero duplicates, surviving
    partitions stored rows in every faulted chunk (no stream-wide
    stall), the killed partition holds exactly its routed share after
    recovery, /readyz went degraded while quorum was lost, and every
    replica reports in-sync at the end."""
    P = cfg.partitions
    R = cfg.replication
    Q = (cfg.ack_quorum or R // 2 + 1) if R else 0
    env, store_dir = _partitioned_env(base, cfg)
    n = max(cfg.bulk_events, 400)
    ids = [f"part-e{i:05d}" for i in range(n)]
    entities = [f"pu{i % 101}" for i in range(n)]
    routed = [_partition_of("user", entities[i], P) for i in range(n)]
    lines = [
        json.dumps(
            {
                "eventId": ids[i],
                "event": "rate",
                "entityType": "user",
                "entityId": entities[i],
                "targetEntityType": "item",
                "targetEntityId": f"pi{i % 37}",
                "properties": {"rating": float(1 + i % 5)},
            }
        ).encode() + b"\n"
        for i in range(n)
    ]
    per_part = {p: routed.count(p) for p in range(P)}
    victim = max(per_part, key=lambda p: per_part[p])
    fault_env = dict(env)
    fault_env["PIO_CHAOS_KILL_PARTITION"] = (
        f"{victim}:{max(1, per_part[victim] * 2 // 5)}"
    )
    rvictim = rrep = None
    if R:
        others = sorted(
            (p for p in per_part if p != victim),
            key=lambda p: -per_part[p],
        )
        rvictim = others[0]
        rrep = (rvictim % R + 1) % R  # first non-leader replica
        fault_env["PIO_CHAOS_KILL_REPLICA"] = (
            f"{rvictim}:{rrep}:{max(1, per_part[rvictim] // 3)}"
        )
    report: dict[str, Any] = {
        "partitions": P,
        "replication": R,
        "ackQuorum": Q,
        "events": n,
        "killedPartition": victim,
        "killedReplica": f"{rvictim}:{rrep}" if R else None,
        "rowsPerPartition": {str(p): per_part[p] for p in sorted(per_part)},
    }
    port = _free_port()
    acked: set[str] = set()
    kills = 0
    summary = None
    server = _ServerProc(fault_env, port, extra_args=("--stats",))
    try:
        server.wait_ready(cfg.startup_timeout_s)
        # ---- stream 1: the appender (and replica) faults fire mid-stream
        attempt = _BulkStreamAttempt(port)
        try:
            for lo in range(0, len(lines), 100):
                attempt.send_piece(b"".join(lines[lo:lo + 100]))
                time.sleep(0.002)
            attempt.finish_send()
            attempt.wait(60.0)
        finally:
            attempt.close()
        fault_seen = False
        faulted_chunks = 0
        survivor_chunks = 0
        failed_lines = 0
        for st in attempt.statuses:
            acked.update(_acked_ids(st, ids))
            perr = st.get("partitionErrors") or {}
            if perr:
                fault_seen = True
                faulted_chunks += 1
                failed_lines += sum(
                    int(v.get("failed", 0)) for v in perr.values()
                )
                if int(st.get("stored", 0)) + int(st.get("duplicates", 0)) > 0:
                    survivor_chunks += 1
        report.update(
            stream1Completed=attempt.summary is not None,
            faultFired=fault_seen,
            faultFailedLines=failed_lines,
            faultedChunks=faulted_chunks,
            survivorProgressChunks=survivor_chunks,
            ackedAfterFault=len(acked),
        )
        # ---- degraded-mode surfaces while quorum is lost
        if R and Q >= 2:
            report["readyzDegradedSeen"] = _wait_http_status(
                port, "/readyz", 503, 15.0
            )
            stats = _get_json(port, "/stats.json") or {}
            repl = stats.get("replication") or []
            report["degradedPartitionsReported"] = sorted(
                part.get("partition") for part in repl
                if not part.get("quorumOk")
            )
        # ---- a real whole-server SIGKILL mid-retry stream
        try:
            attempt2 = _BulkStreamAttempt(port)
        except OSError:
            attempt2 = None
        if attempt2 is not None:
            try:
                kill_at = rng.uniform(0.3, 0.7) * len(lines)
                sent = 0
                for lo in range(0, len(lines), 100):
                    attempt2.send_piece(b"".join(lines[lo:lo + 100]))
                    sent += 100
                    time.sleep(0.002)
                    if sent >= kill_at:
                        server.kill9()
                        kills += 1
                        break
            except OSError:
                pass  # socket died under the kill: expected
            finally:
                attempt2.wait(2.0)
                for st in attempt2.statuses:
                    acked.update(_acked_ids(st, ids))
                attempt2.close()
        if not kills:
            server.kill9()
            kills += 1
        # ---- clean-env restart (recovery sweep quarantines the torn
        # tails; replicas reopen healthy) + retry until a clean summary
        server = _ServerProc(env, port, extra_args=("--stats",))
        recovery_s = server.wait_ready(cfg.startup_timeout_s)
        deadline = time.monotonic() + cfg.total_timeout_s / 2
        attempts = 0
        while summary is None and time.monotonic() < deadline:
            attempts += 1
            try:
                a = _BulkStreamAttempt(port)
            except OSError:
                time.sleep(0.2)
                continue
            try:
                for lo in range(0, len(lines), 100):
                    a.send_piece(b"".join(lines[lo:lo + 100]))
                a.finish_send()
                a.wait(60.0)
                for st in a.statuses:
                    acked.update(_acked_ids(st, ids))
                if a.summary is not None and not any(
                    st.get("storageError") is not None
                    or st.get("partitionErrors")
                    for st in a.statuses
                ):
                    summary = a.summary
            except OSError:
                pass
            finally:
                a.close()
        # ---- replication catch-up: every partition quorum-ok + in-sync
        replica_insync = None
        if R:
            replica_insync = False
            wait_until = time.monotonic() + 30.0
            while time.monotonic() < wait_until:
                stats = _get_json(port, "/stats.json") or {}
                repl = stats.get("replication") or []
                if repl and all(p.get("quorumOk") for p in repl) and all(
                    lag.get("inSync") and lag.get("healthy")
                    for p in repl
                    for lag in (p.get("lag") or {}).values()
                ):
                    replica_insync = True
                    break
                time.sleep(0.5)
        # ---- exactly-once + killed-partition catch-up verification
        stored = _fetch_all_events(port)
        counts: dict[str, int] = {}
        for evd in stored:
            eid = evd.get("eventId") or ""
            counts[eid] = counts.get(eid, 0) + 1
        lost = sorted(e for e in acked if counts.get(e, 0) == 0)
        dups = sorted(
            e for e in counts if e.startswith("part-") and counts[e] > 1
        )
        victim_expected = {ids[i] for i in range(n) if routed[i] == victim}
        victim_present = sum(
            1 for e in victim_expected if counts.get(e, 0) == 1
        )
        stats = _get_json(port, "/stats.json") or {}
        report.update(
            kills=kills,
            retryAttempts=attempts,
            completed=summary is not None,
            summary=summary,
            recoverySeconds=round(recovery_s, 3),
            acked=len(acked),
            ackedLost=len(lost),
            ackedLostIds=lost[:20],
            duplicates=len(dups),
            duplicateIds=dups[:20],
            killedPartitionExpected=len(victim_expected),
            killedPartitionPresent=victim_present,
            killedPartitionCaughtUp=victim_present == len(victim_expected),
            statsPartitionCount=(stats.get("partitions") or {}).get("count"),
            replicaCatchUp=replica_insync,
            unquarantinedTornFiles=len(_unquarantined_torn_files(store_dir)),
        )
    finally:
        server.stop()
    report["ok"] = bool(
        report.get("completed")
        and report.get("stream1Completed")
        and report.get("faultFired")
        and report.get("survivorProgressChunks", 0) > 0
        and report.get("survivorProgressChunks")
        == report.get("faultedChunks")
        and kills >= 1
        and report.get("ackedLost") == 0
        and report.get("duplicates") == 0
        and report.get("killedPartitionCaughtUp")
        and report.get("statsPartitionCount") == P
        and report.get("unquarantinedTornFiles") == 0
        and summary is not None
        and summary.get("stored", 0) + summary.get("duplicates", 0) == n
        and (
            not R
            or (
                report.get("replicaCatchUp")
                and (Q < 2 or report.get("readyzDegradedSeen"))
            )
        )
    )
    return report


def _drain_phase(env: dict, cfg: ChaosConfig, rng: random.Random) -> dict:
    """SIGTERM under load: a fresh server with ``--drain-deadline-s``
    gets concurrent writers, then SIGTERM mid-traffic. Verdict: exit 0
    within the deadline (+ grace), every response a 201 or a clean 503,
    zero raw 500s / dropped connections after the ack."""
    port = _free_port()
    server = _ServerProc(
        env, port, extra_args=("--drain-deadline-s", str(cfg.drain_deadline_s))
    )
    statuses: list[int] = []
    lock = threading.Lock()
    stop = threading.Event()

    def drain_writer(w: int) -> None:
        i = 0
        while not stop.is_set():
            i += 1
            payload = json.dumps(
                {
                    "eventId": f"drain-w{w}-e{i}",
                    "event": "rate",
                    "entityType": "user",
                    "entityId": f"d{w}",
                    "targetEntityType": "item",
                    "targetEntityId": f"i{i % 7}",
                }
            ).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/events.json?accessKey={_ACCESS_KEY}",
                data=payload,
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            try:
                with urllib.request.urlopen(req, timeout=10) as resp:
                    status = resp.status
            except urllib.error.HTTPError as e:
                status = e.code
            except OSError:
                # listener already gone (post-drain) — not a protocol
                # violation, the request was never admitted
                break
            with lock:
                statuses.append(status)
            time.sleep(0.005)

    try:
        server.wait_ready(cfg.startup_timeout_s)
        writers = [
            threading.Thread(target=drain_writer, args=(w,), daemon=True)
            for w in range(cfg.writers)
        ]
        for t in writers:
            t.start()
        time.sleep(0.3 + rng.random() * 0.2)  # real traffic in flight
        t_term = time.monotonic()
        server.sigterm()
        try:
            exit_code = server.proc.wait(
                timeout=cfg.drain_deadline_s + cfg.startup_timeout_s
            )
        except subprocess.TimeoutExpired:
            server.stop()
            return {"exitCode": None, "error": "drain never exited"}
        exit_seconds = time.monotonic() - t_term
        stop.set()
        for t in writers:
            t.join(timeout=10)
    finally:
        stop.set()
        server.stop()
    with lock:
        counts = {str(s): statuses.count(s) for s in sorted(set(statuses))}
        raw_500s = sum(1 for s in statuses if s >= 500 and s != 503)
    return {
        "exitCode": exit_code,
        "exitSeconds": round(exit_seconds, 3),
        "withinDeadline": exit_seconds <= cfg.drain_deadline_s + 2.0,
        "responses": counts,
        "raw500s": raw_500s,
        "drainDeadlineSeconds": cfg.drain_deadline_s,
    }


def run_chaos_partitioned(cfg: ChaosConfig) -> dict:
    """Run ONLY the kill-one-partition drill on a fresh scratch dir
    (:func:`run_chaos_ingest` wraps the same phase with the whole-server
    kill cycles, bulk and drain phases)."""
    if cfg.partitions <= 1 and not cfg.replication:
        raise ChaosError("run_chaos_partitioned needs partitions > 1")
    base = cfg.base_dir or tempfile.mkdtemp(prefix="pio_chaos_part_")
    os.makedirs(base, exist_ok=True)
    env = _storage_env(base, "columnar")
    try:
        _setup_app(env)
        report = _partitioned_phase(cfg, random.Random(cfg.seed), base)
    finally:
        if not cfg.keep_dir and cfg.base_dir is None:
            shutil.rmtree(base, ignore_errors=True)
    if cfg.keep_dir or cfg.base_dir is not None:
        report["storageDir"] = base
    return report


def run_chaos_ingest(cfg: ChaosConfig) -> dict:
    """Run the full harness; returns the report dict (``report["ok"]`` is
    the overall verdict, and the CLI's exit code)."""
    base = cfg.base_dir or tempfile.mkdtemp(prefix="pio_chaos_")
    os.makedirs(base, exist_ok=True)
    env = _storage_env(base, cfg.backend)
    rng = random.Random(cfg.seed)
    injector = FaultInjector()
    t_start = time.monotonic()
    report: dict[str, Any] = {
        "backend": cfg.backend,
        "cycles": cfg.cycles,
        "writers": cfg.writers,
        "eventsPerWriter": cfg.events_per_writer,
        "seed": cfg.seed,
    }
    port = _free_port()
    server: _ServerProc | None = None
    stop = threading.Event()
    try:
        _setup_app(env)
        server = _ServerProc(env, port)
        cold_start = server.wait_ready(cfg.startup_timeout_s)
        writers = _Writers(
            port, cfg.writers, cfg.events_per_writer, injector, stop, cfg.seed
        )
        writers.start()
        recovery_s: list[float] = []
        kills = 0
        total = cfg.writers * cfg.events_per_writer
        for cycle in range(cfg.cycles):
            # kill points are keyed to writer PROGRESS, not wall time, so
            # every kill is guaranteed to land mid-stream (with work both
            # behind it — acked events that must survive — and ahead of
            # it — events whose retries must converge after restart). The
            # seeded jitter moves each point around its progress anchor.
            target = max(
                1,
                int(total * (cycle + 1) / (cfg.cycles + 1))
                - rng.randrange(max(1, total // (4 * cfg.cycles))),
            )
            while (
                writers.acked_count() < target
                and not writers.done()
                and time.monotonic() - t_start < cfg.total_timeout_s
            ):
                time.sleep(0.01)
            # abort a burst of in-flight writer calls client-side at the
            # exact kill point (deterministic via the injector schedule)
            # and put one torn half-request on the wire
            injector.fail_next(cfg.writers)
            _torn_request(port, f"torn-c{cycle}")
            server.kill9()
            kills += 1
            time.sleep(0.05 + rng.random() * 0.2)  # writers bang on a dead port
            server = _ServerProc(env, port)
            recovery_s.append(server.wait_ready(cfg.startup_timeout_s))
        # final convergence: writers finish acking everything
        budget = cfg.total_timeout_s - (time.monotonic() - t_start)
        finished = writers.join(max(5.0, budget))
        stop.set()

        expected = {
            f"w{w}-e{i:05d}"
            for w in range(cfg.writers)
            for i in range(cfg.events_per_writer)
        }
        acked = dict(writers.acked)
        stored = _fetch_all_events(port)
        stored_counts: dict[str, int] = {}
        for ev in stored:
            eid = ev.get("eventId") or ""
            stored_counts[eid] = stored_counts.get(eid, 0) + 1
        acked_lost = sorted(e for e in acked if stored_counts.get(e, 0) == 0)
        duplicates = sorted(
            e for e, n in stored_counts.items() if n > 1
        )
        torn_acked = [e for e in stored_counts if e.startswith("torn-")]
        torn_files = _unquarantined_torn_files(base)
        report.update(
            killCycles=kills,
            writersFinished=finished,
            ackedTotal=len(acked),
            ackedExpected=len(expected),
            ackedLost=len(acked_lost),
            ackedLostIds=acked_lost[:20],
            duplicates=len(duplicates),
            duplicateIds=duplicates[:20],
            duplicateAcksAbsorbed=writers.duplicate_acks,
            dedupViolations=writers.dedup_violations,
            tornRequestsStored=len(torn_acked),
            unquarantinedTornFiles=len(torn_files),
            unquarantinedTornFilePaths=torn_files[:20],
            coldStartSeconds=round(cold_start, 3),
            recoverySeconds=[round(s, 3) for s in recovery_s],
            meanRecoverySeconds=round(sum(recovery_s) / len(recovery_s), 3)
            if recovery_s
            else None,
            injector=injector.to_json(),
        )
    finally:
        stop.set()
        if server is not None:
            server.stop()
    if cfg.bulk_events > 0:
        report["bulk"] = _bulk_phase(env, cfg, rng, base)
    if cfg.partitions > 1 or cfg.replication:
        report["partitioned"] = _partitioned_phase(cfg, rng, base)
    report["drain"] = _drain_phase(env, cfg, rng)
    if not cfg.keep_dir and cfg.base_dir is None:
        shutil.rmtree(base, ignore_errors=True)
    else:
        report["storageDir"] = base
    drain = report["drain"]
    report["ok"] = bool(
        report.get("killCycles", 0) >= cfg.cycles
        and report.get("writersFinished")
        and report.get("ackedLost") == 0
        and report.get("duplicates") == 0
        and report.get("dedupViolations") == 0
        and report.get("tornRequestsStored") == 0
        and report.get("unquarantinedTornFiles") == 0
        and (cfg.bulk_events <= 0 or report.get("bulk", {}).get("ok"))
        and (
            (cfg.partitions <= 1 and not cfg.replication)
            or report.get("partitioned", {}).get("ok")
        )
        and drain.get("exitCode") == 0
        and drain.get("raw500s") == 0
        and drain.get("withinDeadline")
    )
    return report


# ---------------------------------------------------------------------------
# Serving-fleet chaos (``pio chaos-serve``)
# ---------------------------------------------------------------------------
#
# The ingest drill above proves writes survive a SIGKILL; this drill
# proves *reads never notice one*. It trains a tiny real model, deploys
# it as ``pio deploy --replicas N`` (router + replica subprocesses), and
# then, with >= 16 concurrent query clients that NEVER retry:
#
# 1. **throughput** — aggregate q/s at each fleet size (the q/s-vs-R
#    curve; one core can't show scaling, so the report carries cpuCount
#    and a one-core note instead of a fake ratio);
# 2. **kill** — SIGKILL a replica mid-traffic. The router must route
#    around it within one probe interval and retry the in-flight
#    casualties on a peer, so every client request still answers 2xx
#    (zero failed queries), and tail latency must recover within one
#    breaker-reset interval. The supervisor respawns the replica and the
#    fleet heals to full strength;
# 3. **rolling** — ``POST /reload`` on the router rotates the fleet one
#    replica at a time while clients keep querying: zero failed queries,
#    zero cross-generation results for any one cache scope (each client
#    owns disjoint scopes, so per-scope generation monotonicity is exact,
#    not racy), and the fleet converges to one generation;
# 4. optionally one **sharded-replica** fleet (``--shard-factors`` inside
#    each replica, over the cards the replica sees) — the R x S
#    composition point. The port's serving mesh is the machine's real
#    devices (nothing fakes one from the environment), so on one card
#    each replica takes the fallback to ``--pin-model`` replication and
#    reports ``factorShards`` 0; the report records each replica's count.
#
# Same contract as the ingest drill: stdlib-only, everything over the
# wire and the filesystem (the supervisor's fleet state file names the
# replica PIDs to kill); verdicts are asserted fields, never log lines.


@dataclasses.dataclass(frozen=True)
class ServeChaosConfig:
    """Knobs of one serving-fleet chaos run (CLI: ``pio chaos-serve``)."""

    replicas: int = 2
    clients: int = 16
    kills: int = 1
    phase_seconds: float = 6.0
    reloads: int = 1
    #: synthetic `rate` events the tiny model trains on
    train_events: int = 400
    train_users: int = 60
    train_items: int = 120
    rank: int = 8
    iterations: int = 2
    seed: int = 0
    #: fleet sizes of the aggregate-q/s sweep (the last one is reused
    #: for the kill/rolling phases when it matches ``replicas``)
    throughput_replicas: tuple[int, ...] = (1, 2)
    throughput_seconds: float = 3.0
    #: also measure one fleet whose replicas serve ``--shard-factors``
    sharded_point: bool = False
    #: run the drill AOT-on: ``pio train --aot`` exports the serving
    #: programs, replicas deploy ``--aot``, and the rolling phase
    #: additionally asserts ZERO serve-time compiles across the full
    #: rotation (every replica tier 1; docs/operations.md AOT runbook)
    aot: bool = False
    #: where the drill's ``pio train`` and every ``pio deploy`` run:
    #: ``"cuda"`` (the card) or ``"cpu"``
    device: str = "cuda"
    probe_interval_s: float = 0.25
    breaker_reset_s: float = 1.0
    query_timeout_s: float = 20.0
    startup_timeout_s: float = 180.0
    total_timeout_s: float = 900.0
    base_dir: str | None = None
    keep_dir: bool = False

    def __post_init__(self) -> None:
        if self.replicas < 1 or self.clients < 1:
            raise ValueError("replicas and clients must be >= 1")


def _run_pio(env: dict, args: list[str], timeout_s: float, what: str) -> str:
    proc = _run_console(env, args, timeout_s)
    if proc.returncode != 0:
        raise ChaosError(
            f"{what} failed rc={proc.returncode}: {proc.stderr[-800:]}"
        )
    return proc.stdout


class _FleetProc:
    """One ``pio deploy --replicas N`` subprocess tree (router +
    supervised replicas) plus the wire/file helpers the drill needs."""

    def __init__(
        self,
        env: dict,
        base: str,
        engine_json: str,
        replicas: int,
        cfg: ServeChaosConfig,
        extra_args: tuple[str, ...] = (),
        env_extra: dict | None = None,
    ):
        self.port = _free_port()
        self.base = base
        self.replicas = replicas
        run_env = dict(env)
        if env_extra:
            run_env.update(env_extra)
        # the router's replicas join its process group (see stop)
        self.proc = _spawn(
            _console(
                "deploy",
                "--engine-json", engine_json,
                "--device", cfg.device,
                "--ip", "127.0.0.1",
                "--port", str(self.port),
                "--replicas", str(replicas),
                "--probe-interval-s", str(cfg.probe_interval_s),
                "--failover-retries", "1",
                "--fleet-breaker-threshold", "2",
                "--fleet-breaker-reset-s", str(cfg.breaker_reset_s),
                "--result-cache", "--coalesce",
                *extra_args,
            ),
            run_env,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )

    @property
    def state_path(self) -> str:
        return os.path.join(
            self.base, "deployments", f"fleet-{self.port}.json"
        )

    def state(self) -> dict | None:
        try:
            with open(self.state_path) as f:
                doc = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError, OSError):
            return None
        return doc if isinstance(doc, dict) else None

    def status(self) -> dict | None:
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}/", timeout=5
            ) as resp:
                return json.loads(resp.read())
        except Exception:
            return None

    def wait_all_ready(self, timeout_s: float) -> float:
        """Until EVERY replica is healthy at the router (throughput
        phases must start at full strength); returns seconds waited."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout_s:
            if self.proc.poll() is not None:
                raise ChaosError(
                    f"fleet exited rc={self.proc.returncode} before ready"
                )
            status = self.status()
            if status is not None:
                reps = status.get("replicas", [])
                if reps and all(r.get("healthy") for r in reps):
                    return time.monotonic() - t0
            time.sleep(0.1)
        raise ChaosError(f"fleet not fully ready within {timeout_s:g}s")

    def kill_replica(self, index: int) -> tuple[str, int]:
        """SIGKILL replica ``index`` by the PID in the supervisor's state
        file; returns (replica id, pid killed)."""
        state = self.state()
        if state is None:
            raise ChaosError("no fleet state file to pick a victim from")
        reps = state.get("replicas", [])
        rep = reps[index % len(reps)]
        pid = rep.get("pid")
        if not pid:
            raise ChaosError(f"replica {rep.get('id')} has no pid on file")
        os.kill(int(pid), signal.SIGKILL)
        return str(rep.get("id")), int(pid)

    def wait_respawn(self, replica_id: str, old_pid: int, timeout_s: float) -> bool:
        """Until the supervisor has a NEW live pid for ``replica_id`` and
        the router reports it healthy again."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout_s:
            state = self.state() or {}
            rep = next(
                (
                    r
                    for r in state.get("replicas", [])
                    if r.get("id") == replica_id
                ),
                None,
            )
            if rep and rep.get("alive") and rep.get("pid") != old_pid:
                status = self.status() or {}
                srep = next(
                    (
                        r
                        for r in status.get("replicas", [])
                        if r.get("id") == replica_id
                    ),
                    None,
                )
                if srep and srep.get("healthy"):
                    return True
            time.sleep(0.1)
        return False

    def reload(self, timeout_s: float) -> dict:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/reload",
            data=b"{}",
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                return json.loads(e.read())
            except Exception:
                return {"ok": False, "error": f"HTTP {e.code}"}

    def router_stats(self, fanout: bool = False) -> dict | None:
        url = f"http://127.0.0.1:{self.port}/stats.json"
        if fanout:
            url += "?fanout=1"
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                return json.loads(resp.read())
        except Exception:
            return None

    def stop(self) -> None:
        """SIGTERM the supervisor (it takes its replicas down), escalate
        if needed, reap any replica pid still on file, then end whatever
        is left of the router's process group (a replica the supervisor
        respawned after the state file was read, say)."""
        pids: list[int] = []
        state = self.state()
        if state:
            pids = [
                int(r["pid"])
                for r in state.get("replicas", [])
                if r.get("pid")
            ]
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                try:
                    self.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
        for pid in pids:  # belt-and-braces: no replica outlives the drill
            try:
                os.kill(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        _end_group(self.proc)


class _QueryClients:
    """Concurrent query clients that NEVER retry — zero failed queries
    means the ROUTER absorbed every fault, not the clients. Client ``i``
    queries only users ``u`` with ``u % clients == i``: disjoint cache
    scopes per client, so each scope's responses are observed strictly
    in order and per-scope generation monotonicity is exact."""

    def __init__(self, port: int, cfg: ServeChaosConfig):
        self.port = port
        self.cfg = cfg
        self.stop = threading.Event()
        self._lock = threading.Lock()
        #: (t_done_monotonic, latency_s, status, scope, generation)
        self.samples: list[tuple[float, float, int, str, int]] = []
        self.transport_errors = 0
        self._threads = [
            threading.Thread(
                target=self._run, args=(i,), daemon=True,
                name=f"chaos-serve-client-{i}",
            )
            for i in range(cfg.clients)
        ]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def join(self, timeout_s: float = 30.0) -> None:
        self.stop.set()
        deadline = time.monotonic() + timeout_s
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))

    def _run(self, cid: int) -> None:
        cfg = self.cfg
        users = [
            f"u{u}" for u in range(cfg.train_users) if u % cfg.clients == cid
        ] or [f"u{cid % cfg.train_users}"]
        rng = random.Random(cfg.seed * 7919 + cid)
        url = f"http://127.0.0.1:{self.port}/queries.json"
        while not self.stop.is_set():
            user = users[rng.randrange(len(users))]
            payload = json.dumps({"user": user, "num": 4}).encode()
            req = urllib.request.Request(
                url,
                data=payload,
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            t0 = time.monotonic()
            status = 0
            generation = 0
            try:
                with urllib.request.urlopen(
                    req, timeout=cfg.query_timeout_s
                ) as resp:
                    resp.read()
                    status = resp.status
                    generation = int(
                        resp.headers.get("X-PIO-Generation", "0") or 0
                    )
            except urllib.error.HTTPError as e:
                e.read()
                status = e.code
            except Exception:
                with self._lock:
                    self.transport_errors += 1
                continue
            t1 = time.monotonic()
            with self._lock:
                self.samples.append((t1, t1 - t0, status, user, generation))

    # ----------------------------------------------------------- analysis
    def snapshot(self) -> list[tuple[float, float, int, str, int]]:
        with self._lock:
            return list(self.samples)

    @staticmethod
    def _p99(latencies: list[float]) -> float | None:
        if not latencies:
            return None
        lat = sorted(latencies)
        return lat[min(len(lat) - 1, int(0.99 * len(lat)))]

    def summarize(self, t_start: float, t_end: float) -> dict:
        samples = [s for s in self.snapshot() if t_start <= s[0] <= t_end]
        lat = sorted(s[1] for s in samples)
        failed = [s for s in samples if not 200 <= s[2] < 300]
        duration = max(1e-6, t_end - t_start)
        return {
            "requests": len(samples),
            "failed": len(failed),
            "failedStatuses": sorted({s[2] for s in failed}),
            "transportErrors": self.transport_errors,
            "qps": round(len(samples) / duration, 1),
            "p50Ms": round(lat[len(lat) // 2] * 1000, 3) if lat else None,
            "p99Ms": round(self._p99([s[1] for s in samples]) * 1000, 3)
            if lat
            else None,
        }

    def cross_generation_violations(self) -> int:
        """Per scope, the generation sequence (in completion order —
        exact, because scopes are client-disjoint) must never decrease:
        one cache key served by gen g+1 must never be served by gen g
        again."""
        last: dict[str, int] = {}
        violations = 0
        for _t, _lat, status, scope, gen in self.snapshot():
            if not 200 <= status < 300 or gen <= 0:
                continue
            if gen < last.get(scope, 0):
                violations += 1
            else:
                last[scope] = gen
        return violations


def _serve_setup(env: dict, base: str, cfg: ServeChaosConfig) -> str:
    """App + synthetic events + one trained instance; returns the
    engine.json path. All through real ``pio`` subprocesses — the drill
    exercises the product path end to end."""
    _setup_app(env)
    rng = random.Random(cfg.seed)
    events_path = os.path.join(base, "train-events.jsonl")
    with open(events_path, "w") as f:
        for i in range(cfg.train_events):
            u = i % cfg.train_users
            f.write(
                json.dumps(
                    {
                        "event": "rate",
                        "entityType": "user",
                        "entityId": f"u{u}",
                        "targetEntityType": "item",
                        "targetEntityId": f"i{rng.randrange(cfg.train_items)}",
                        "properties": {"rating": float(1 + rng.randrange(5))},
                        "eventTime": "2024-01-01T00:00:00.000Z",
                    }
                )
                + "\n"
            )
    _run_pio(
        env,
        ["import", "--appname", _APP_NAME, "--input", events_path],
        cfg.startup_timeout_s,
        "event import",
    )
    engine_json = os.path.join(base, "engine.json")
    with open(engine_json, "w") as f:
        json.dump(
            {
                "id": "fleet-chaos",
                "version": "1",
                "engineFactory": (
                    "predictionio_tpu_torch.templates.recommendation:engine_factory"
                ),
                "datasource": {"params": {"appName": _APP_NAME}},
                "algorithms": [
                    {
                        "name": "als",
                        "params": {
                            "rank": cfg.rank,
                            "numIterations": cfg.iterations,
                            "lambda": 0.05,
                        },
                    }
                ],
            },
            f,
        )
    train_args = ["train", "--engine-json", engine_json, "--mesh", "none", "--device", cfg.device]
    if getattr(cfg, "aot", False):
        train_args.append("--aot")
    _run_pio(
        env,
        train_args,
        cfg.startup_timeout_s * 2,  # an --aot train also compiles the serving programs
        "train",
    )
    return engine_json


def _warm_fleet(port: int, cfg: ServeChaosConfig, distinct_users: int = 8) -> None:
    """Sequential warm-up queries before any measured (or asserted)
    window: the first queries after a (re)deploy pay the warm-up of the
    device path (a CUDA context, the first products) — and 16 concurrent
    cold clients would read as timeouts, not as fleet behavior. Distinct
    users spread the warm-up across the hash ring so every replica gets
    touched."""
    for u in range(distinct_users):
        payload = json.dumps({"user": f"u{u}", "num": 4}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/queries.json",
            data=payload,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        deadline = time.monotonic() + cfg.startup_timeout_s
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(
                    req, timeout=cfg.startup_timeout_s
                ) as resp:
                    resp.read()
                break
            except urllib.error.HTTPError as e:
                e.read()
                break  # the fleet answered; warm enough for this user
            except Exception:
                time.sleep(0.2)


def _throughput_point(
    env: dict,
    base: str,
    engine_json: str,
    cfg: ServeChaosConfig,
    replicas: int,
    extra_args: tuple[str, ...] = (),
    env_extra: dict | None = None,
    keep_fleet: bool = False,
    clients_override: int | None = None,
) -> tuple[dict, "_FleetProc | None"]:
    """Measure aggregate q/s at one fleet size; optionally hand the live
    fleet back for the next phase instead of stopping it."""
    fleet = _FleetProc(
        env, base, engine_json, replicas, cfg,
        extra_args=extra_args, env_extra=env_extra,
    )
    if clients_override is not None:
        cfg = dataclasses.replace(cfg, clients=clients_override)
    try:
        ready_s = fleet.wait_all_ready(cfg.startup_timeout_s)
        _warm_fleet(fleet.port, cfg)
        clients = _QueryClients(fleet.port, cfg)
        clients.start()
        t0 = time.monotonic()
        time.sleep(cfg.throughput_seconds)
        t1 = time.monotonic()
        clients.join()
        point = dict(
            clients.summarize(t0, t1),
            replicas=replicas,
            clients=cfg.clients,
            readySeconds=round(ready_s, 2),
        )
    except BaseException:
        fleet.stop()
        raise
    if keep_fleet:
        return point, fleet
    fleet.stop()
    return point, None


def _kill_phase(fleet: "_FleetProc", cfg: ServeChaosConfig) -> dict:
    """SIGKILL replicas under load; zero failed queries, p99 recovery
    within one breaker reset, supervisor respawn back to full strength."""
    clients = _QueryClients(fleet.port, cfg)
    clients.start()
    t0 = time.monotonic()
    warm_s = max(0.5, cfg.phase_seconds * 0.25)
    time.sleep(warm_s)
    kill_records = []
    for k in range(cfg.kills):
        t_kill = time.monotonic()
        rid, pid = fleet.kill_replica(k % fleet.replicas)
        respawned = fleet.wait_respawn(
            rid, pid, timeout_s=cfg.startup_timeout_s
        )
        kill_records.append(
            {
                "replica": rid,
                "pid": pid,
                "tKill": t_kill,
                "respawned": respawned,
                "respawnSeconds": round(time.monotonic() - t_kill, 3) if respawned else None,
            }
        )
    # post-kill observation window: at least one breaker reset + probes
    recovery_budget = cfg.breaker_reset_s + 2 * cfg.probe_interval_s
    tail_s = max(cfg.phase_seconds - (time.monotonic() - t0), recovery_budget + 1.0)
    time.sleep(tail_s)
    t_end = time.monotonic()
    clients.join()
    overall = clients.summarize(t0, t_end)
    first_kill = kill_records[0]["tKill"] if kill_records else t0
    last_kill = kill_records[-1]["tKill"] if kill_records else t0
    baseline = clients.summarize(t0 + warm_s * 0.5, first_kill)
    recovered_window = clients.summarize(
        last_kill + recovery_budget, t_end
    )
    base_p99 = baseline.get("p99Ms")
    rec_p99 = recovered_window.get("p99Ms")
    # one-core honesty (and scheduler jitter generally): the recovery
    # claim uses a floor — "back under 3x the pre-kill p99, or under an
    # absolute 250 ms" — so a microsecond-fast baseline cannot turn
    # noise into a red verdict, while a breaker/probe regression (seconds
    # of stall) still fails loudly
    p99_recovered = (
        rec_p99 is not None
        and base_p99 is not None
        and (rec_p99 <= 3 * base_p99 or rec_p99 <= 250.0)
    )
    return {
        "kills": [
            {"replica": r["replica"], "respawned": r["respawned"], "respawnSeconds": r["respawnSeconds"]}
            for r in kill_records
        ],
        "killCount": len(kill_records),
        "allRespawned": all(r["respawned"] for r in kill_records),
        "overall": overall,
        "baselineWindow": baseline,
        "recoveredWindow": recovered_window,
        "recoveryBudgetSeconds": round(recovery_budget, 3),
        "p99Recovered": bool(p99_recovered),
        "failedQueries": overall["failed"] + overall["transportErrors"],
    }


def _rolling_phase(fleet: "_FleetProc", cfg: ServeChaosConfig) -> dict:
    """Rolling /reload under load: zero failed queries, zero
    cross-generation results per cache scope, fleet converges."""
    clients = _QueryClients(fleet.port, cfg)
    clients.start()
    t0 = time.monotonic()
    time.sleep(0.5)
    reload_reports = []
    for _ in range(max(1, cfg.reloads)):
        reload_reports.append(fleet.reload(timeout_s=cfg.startup_timeout_s))
    time.sleep(1.0)
    t_end = time.monotonic()
    clients.join()
    overall = clients.summarize(t0, t_end)
    stats = fleet.router_stats() or {}
    out = {
        "overall": overall,
        "reloads": reload_reports,
        "reloadsOk": all(r.get("ok") for r in reload_reports),
        "converged": all(r.get("converged") for r in reload_reports),
        "crossGenerationViolations": clients.cross_generation_violations(),
        "routerGenerationRegressions": (
            (stats.get("router") or {}).get("generationRegressions")
        ),
        "failedQueries": overall["failed"] + overall["transportErrors"],
    }
    if cfg.aot:
        # AOT rolling contract (docs/operations.md AOT runbook): after a
        # full rotation every replica must serve deserialized programs
        # (tier 1) and have witnessed ZERO compiles since its boot
        # finished — a rotation that recompiles is the regression this
        # drill exists to catch. Read through the router's stats fanout
        # so the drill stays wire-only.
        fan = fleet.router_stats(fanout=True) or {}
        per_replica: dict[str, Any] = {}
        total = 0
        tiers_ok = True
        for rid, rstats in (fan.get("replicaStats") or {}).items():
            aot_block = (
                rstats.get("aot") if isinstance(rstats, dict) else None
            ) or {}
            compiles = aot_block.get("serveTimeCompiles")
            per_replica[rid] = {
                "tier": aot_block.get("tier"),
                "serveTimeCompiles": compiles,
            }
            total += int(compiles or 0)
            if aot_block.get("tier") != 1:
                tiers_ok = False
        out["aot"] = {
            "perReplica": per_replica,
            "serveTimeCompiles": total,
            "allTier1": bool(per_replica) and tiers_ok,
        }
    return out


def run_chaos_serve(cfg: ServeChaosConfig) -> dict:
    """Run the full serving-fleet drill; returns the report dict
    (``report["ok"]`` is the overall verdict, and the CLI's exit code)."""
    base = cfg.base_dir or tempfile.mkdtemp(prefix="pio_chaos_serve_")
    os.makedirs(base, exist_ok=True)
    env = _storage_env(base, "sqlite")
    report: dict[str, Any] = {
        "replicas": cfg.replicas,
        "clients": cfg.clients,
        "seed": cfg.seed,
        "aot": cfg.aot,
        "device": cfg.device,
        "cpuCount": os.cpu_count(),
    }
    aot_args = ("--aot",) if cfg.aot else ()
    fleet: _FleetProc | None = None
    t_start = time.monotonic()
    try:
        t0 = time.monotonic()
        engine_json = _serve_setup(env, base, cfg)
        report["setupSeconds"] = round(time.monotonic() - t0, 1)

        # ---- phase 1: aggregate q/s vs fleet size
        points: list[dict] = []
        for r in cfg.throughput_replicas:
            keep = r == cfg.replicas and r == cfg.throughput_replicas[-1]
            point, kept = _throughput_point(
                env, base, engine_json, cfg, r,
                extra_args=aot_args, keep_fleet=keep,
            )
            points.append(point)
            if kept is not None:
                fleet = kept
        by_r = {p["replicas"]: p for p in points}
        scaling = None
        if 1 in by_r and cfg.replicas in by_r and by_r[1]["qps"]:
            scaling = round(by_r[cfg.replicas]["qps"] / by_r[1]["qps"], 2)
        report["throughput"] = {
            "points": points,
            "scaling": scaling,
            "note": (
                "single-core host: replicas time-share one core, so "
                "aggregate q/s cannot scale with R here — the scaling "
                "claim applies to the multi-core path (see "
                "docs/operations.md)"
            )
            if (os.cpu_count() or 1) < 2
            else "multi-core host: q/s should scale with R until cores "
            "saturate",
        }

        # ---- phase 2: replica SIGKILL under load
        if fleet is None:
            fleet = _FleetProc(
                env, base, engine_json, cfg.replicas, cfg,
                extra_args=aot_args,
            )
            fleet.wait_all_ready(cfg.startup_timeout_s)
        report["kill"] = _kill_phase(fleet, cfg)

        # ---- phase 3: rolling reload under load
        if cfg.reloads > 0:
            report["rolling"] = _rolling_phase(fleet, cfg)
        fleet.stop()
        fleet = None

        # ---- phase 4: one sharded-replica composition point (R x S)
        if cfg.sharded_point:
            # one client, as the reference drill runs this point: it
            # shows that the R x S composition serves, not its throughput
            point, fleet = _throughput_point(
                env, base, engine_json, cfg,
                2,  # fixed-size composition point, independent of cfg.replicas
                extra_args=("--shard-factors",),
                keep_fleet=True,
                clients_override=1,
            )
            fan = (fleet.router_stats(fanout=True) or {}).get("replicaStats") or {}
            shards = {
                rid: ((st.get("cache") or {}).get("factorShards") if isinstance(st, dict) else None)
                for rid, st in sorted(fan.items())
            }
            fleet.stop()
            fleet = None
            point["factorShards"] = shards
            if shards and not any(shards.values()):
                point["note"] = (
                    "factorShards 0 on every replica: each sees one device, so "
                    "--shard-factors fell back to --pin-model replication"
                )
            report["shardedReplica"] = point
        report["totalSeconds"] = round(time.monotonic() - t_start, 1)
    except (ChaosError, subprocess.TimeoutExpired) as e:
        report["error"] = str(e)[:800]
        report["ok"] = False
        return report
    finally:
        if fleet is not None:
            fleet.stop()
        if not cfg.keep_dir and cfg.base_dir is None:
            shutil.rmtree(base, ignore_errors=True)
        else:
            report["storageDir"] = base
    kill = report.get("kill", {})
    rolling = report.get("rolling", {"failedQueries": 0, "reloadsOk": True,
                                     "converged": True,
                                     "crossGenerationViolations": 0})
    tp = report["throughput"]
    multi_core = (os.cpu_count() or 1) >= 2
    sharded = report.get("shardedReplica", {})
    aot = rolling.get("aot", {})
    # each term of the verdict, by name; ``ok`` is all of them
    report["verdicts"] = verdicts = {
        "throughputClean": all(p["failed"] == 0 and p["transportErrors"] == 0 for p in tp["points"]),
        "killsDone": kill.get("killCount", 0) >= cfg.kills,
        "killNoFailedQueries": kill.get("failedQueries") == 0,
        "allRespawned": bool(kill.get("allRespawned")),
        "p99Recovered": bool(kill.get("p99Recovered")),
        "rollingNoFailedQueries": rolling.get("failedQueries") == 0,
        "reloadsOk": bool(rolling.get("reloadsOk")),
        "converged": bool(rolling.get("converged")),
        "noCrossGeneration": rolling.get("crossGenerationViolations") == 0,
        # AOT rolling contract: a full rotation must land every replica
        # on tier 1 with zero serve-time compiles (the jit-witness gate,
        # asserted over the wire instead of in-process)
        "aotTier1NoCompiles": (not cfg.aot or cfg.reloads == 0
                               or (aot.get("serveTimeCompiles") == 0 and bool(aot.get("allTier1")))),
        # q/s must scale on a multi-core host; a one-core host documents
        # the ceiling instead of faking the claim
        "throughputScales": not multi_core or tp["scaling"] is None or tp["scaling"] >= 1.5,
        "shardedPointClean": (not cfg.sharded_point
                              or (sharded.get("failed") == 0 and sharded.get("transportErrors") == 0
                                  and sharded.get("qps", 0) > 0)),
    }
    report["ok"] = all(verdicts.values())
    return report


# ---------------------------------------------------------------------------
# Cross-host elastic-fleet chaos (``pio chaos-fleet``)
# ---------------------------------------------------------------------------
#
# ``pio chaos-serve`` kills one replica behind one router; this drill
# kills a whole "host". Two independent ``pio deploy --replicas N``
# trees on SEPARATE storage basedirs (two hosts in miniature — separate
# supervisors, separate routers) share one endpoint-registry directory,
# so both routers see one 2N-replica consistent-hash ring. Then:
#
# 1. **host-kill** — SIGKILL host A's entire tree (every replica AND its
#    router/supervisor) under concurrent clients that never retry a
#    delivered answer but DO fail over between routers on transport
#    errors (the dead router never answered — the idempotent-read retry
#    is the client-visible router-HA contract). Verdict: zero failed
#    queries; the surviving router routes around the dead replicas
#    within its probe interval and evicts them on lease expiry; the
#    killed host, restarted, rejoins the ring through the registry with
#    no operator re-wiring.
# 2. **autoscale** — a 1-replica fleet with ``--autoscale 1:2`` under
#    watermark-crossing load must scale up (new replica binds port 0,
#    self-reports, joins the ring); when the load drops to a trickle it
#    must retire the extra replica drain-aware — the trickle (and the
#    full load before it) loses zero queries.
# 3. **stale-while-down** — a 1-replica fleet with
#    ``--stale-cache-ttl-s``: after its replica is SIGKILLed, a
#    previously-answered scope is served from the router's stale cache
#    (200 + ``X-PIO-Stale: true``), an unknown scope still gets a clean
#    503, and after respawn the scope is fresh again with no marker.
#    While any owner is alive the marker must never appear.
#
# Same contract as the other drills: stdlib-only, real subprocesses,
# verdicts as asserted fields.


@dataclasses.dataclass(frozen=True)
class FleetChaosConfig:
    """Knobs of one elastic-fleet chaos run (CLI: ``pio chaos-fleet``)."""

    replicas_per_host: int = 1
    clients: int = 16
    phase_seconds: float = 6.0
    #: synthetic `rate` events the tiny model trains on
    train_events: int = 400
    train_users: int = 60
    train_items: int = 120
    rank: int = 8
    iterations: int = 2
    #: endpoint-registry lease TTL for the host-kill phase — the
    #: eviction clock the surviving router runs on
    lease_ttl_s: float = 1.0
    seed: int = 0
    #: where the drill's ``pio train`` and every ``pio deploy`` run
    device: str = "cuda"
    autoscale_phase: bool = True
    stale_phase: bool = True
    probe_interval_s: float = 0.25
    breaker_reset_s: float = 1.0
    query_timeout_s: float = 20.0
    startup_timeout_s: float = 180.0
    total_timeout_s: float = 900.0
    base_dir: str | None = None
    keep_dir: bool = False

    def __post_init__(self) -> None:
        if self.replicas_per_host < 1 or self.clients < 1:
            raise ValueError("replicas_per_host and clients must be >= 1")
        if self.lease_ttl_s <= 0:
            raise ValueError("lease_ttl_s must be > 0")


class _HAQueryClients(_QueryClients):
    """Query clients with client-visible router failover: a transport
    error from one router (connection refused/reset — the router died
    before DELIVERING an answer) is retried once on the other router;
    an HTTP error from a live router is a failed query and is never
    retried. ``router_failovers`` counts recovered failovers;
    ``transport_errors`` keeps its parent meaning of an UNRECOVERED
    request (every router transport-failed) — still a failure."""

    def __init__(self, ports: list[int], cfg):
        super().__init__(ports[0], cfg)
        self.ports = list(ports)
        self.router_failovers = 0
        self._preferred = 0  # advisory: index of the last router that answered

    def _run(self, cid: int) -> None:
        cfg = self.cfg
        users = [
            f"u{u}" for u in range(cfg.train_users) if u % cfg.clients == cid
        ] or [f"u{cid % cfg.train_users}"]
        rng = random.Random(cfg.seed * 7919 + cid)
        while not self.stop.is_set():
            user = users[rng.randrange(len(users))]
            payload = json.dumps({"user": user, "num": 4}).encode()
            t0 = time.monotonic()
            status = 0
            generation = 0
            answered = False
            preferred = self._preferred
            order = [
                self.ports[(preferred + k) % len(self.ports)]
                for k in range(len(self.ports))
            ]
            for attempt, port in enumerate(order):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/queries.json",
                    data=payload,
                    headers={"Content-Type": "application/json"},
                    method="POST",
                )
                try:
                    with urllib.request.urlopen(
                        req, timeout=cfg.query_timeout_s
                    ) as resp:
                        resp.read()
                        status = resp.status
                        generation = int(
                            resp.headers.get("X-PIO-Generation", "0") or 0
                        )
                except urllib.error.HTTPError as e:
                    e.read()
                    status = e.code
                except Exception:
                    if attempt + 1 < len(order):
                        with self._lock:
                            self.router_failovers += 1
                    continue
                answered = True
                with self._lock:
                    self._preferred = self.ports.index(port)
                break
            if not answered:
                with self._lock:
                    self.transport_errors += 1
                time.sleep(0.05)
                continue
            t1 = time.monotonic()
            with self._lock:
                self.samples.append((t1, t1 - t0, status, user, generation))


def _elastic_host(base: str, seed_dir: str, name: str) -> tuple[str, dict]:
    """Clone the trained seed storage into a fresh per-"host" basedir —
    two hosts with independent supervisors/state files, one shared model
    lineage (the shared-filesystem deployment the registry targets)."""
    host_dir = os.path.join(base, name)
    shutil.copytree(seed_dir, host_dir)
    return host_dir, _storage_env(host_dir, "sqlite")


def _elastic_fleet(
    env: dict,
    host_dir: str,
    engine_json: str,
    reg_dir: str,
    cfg: FleetChaosConfig,
    replicas: int,
    extra_args: tuple[str, ...] = (),
) -> _FleetProc:
    return _FleetProc(
        env, host_dir, engine_json, replicas, cfg,
        extra_args=(
            "--endpoint-registry", reg_dir,
            "--lease-ttl-s", str(cfg.lease_ttl_s),
            "--drain-deadline-s", "5",
            *extra_args,
        ),
    )


def _wait_fleet_view(
    fleet: _FleetProc, expect: int, timeout_s: float, what: str
) -> float:
    """Until the router's ring holds EXACTLY ``expect`` healthy replicas
    (registry-joined fleets start with an empty ring and grow as
    replicas self-report); returns seconds waited."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if fleet.proc.poll() is not None:
            raise ChaosError(
                f"{what}: fleet exited rc={fleet.proc.returncode} before ready"
            )
        status = fleet.status()
        if status is not None:
            reps = status.get("replicas", [])
            if len(reps) == expect and all(r.get("healthy") for r in reps):
                return time.monotonic() - t0
        time.sleep(0.1)
    raise ChaosError(f"{what}: ring never reached {expect} healthy replicas")


def _host_kill_phase(
    base: str, seed_dir: str, engine_json: str, cfg: FleetChaosConfig
) -> dict:
    """SIGKILL one entire host's tree under HA clients; the surviving
    router absorbs, the restarted host rejoins through the registry."""
    reg_dir = os.path.join(base, "endpoints-hostkill")
    host_a, env_a = _elastic_host(base, seed_dir, "hostA")
    host_b, env_b = _elastic_host(base, seed_dir, "hostB")
    expect = 2 * cfg.replicas_per_host
    fleet_a = _elastic_fleet(env_a, host_a, engine_json, reg_dir, cfg,
                             cfg.replicas_per_host)
    fleet_b: _FleetProc | None = None
    fleet_a2: _FleetProc | None = None
    clients: _HAQueryClients | None = None
    try:
        fleet_b = _elastic_fleet(env_b, host_b, engine_json, reg_dir, cfg,
                                 cfg.replicas_per_host)
        ready_s = max(
            _wait_fleet_view(fleet_a, expect, cfg.startup_timeout_s, "hostA"),
            _wait_fleet_view(fleet_b, expect, cfg.startup_timeout_s, "hostB"),
        )
        _warm_fleet(fleet_a.port, cfg)
        _warm_fleet(fleet_b.port, cfg)
        clients = _HAQueryClients([fleet_a.port, fleet_b.port], cfg)
        clients.start()
        t0 = time.monotonic()
        time.sleep(max(0.5, cfg.phase_seconds * 0.25))

        # ---- SIGKILL every process of host A: replicas first, then the
        # router/supervisor itself — the whole host goes dark at once
        t_kill = time.monotonic()
        pids = [
            int(r["pid"])
            for r in (fleet_a.state() or {}).get("replicas", [])
            if r.get("pid")
        ]
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        fleet_a.proc.send_signal(signal.SIGKILL)
        fleet_a.proc.wait(timeout=30)

        # ---- surviving router: routed-around (unhealthy or gone) fast,
        # evicted from the ring on lease expiry
        absorb_s = None
        evict_s = None
        absorb_deadline = (
            t_kill + cfg.lease_ttl_s + 10 * cfg.probe_interval_s + 10.0
        )
        while time.monotonic() < absorb_deadline:
            status = fleet_b.status() or {}
            reps = status.get("replicas", [])
            dead_visible = [
                r for r in reps if not r.get("healthy")
            ]
            if absorb_s is None and len(reps) - len(dead_visible) == (
                cfg.replicas_per_host
            ):
                absorb_s = time.monotonic() - t_kill
            if len(reps) == cfg.replicas_per_host:
                evict_s = time.monotonic() - t_kill
                if absorb_s is None:  # evicted before a poll saw "unhealthy"
                    absorb_s = evict_s
                break
            time.sleep(0.05)

        time.sleep(max(1.0, cfg.phase_seconds * 0.25))

        # ---- restart host A: same basedir, same registry — it must
        # rejoin the ring with no re-wiring
        fleet_a2 = _elastic_fleet(env_a, host_a, engine_json, reg_dir, cfg,
                                  cfg.replicas_per_host)
        t_restart = time.monotonic()
        rejoin_s = None
        rejoin_deadline = t_restart + cfg.startup_timeout_s
        while time.monotonic() < rejoin_deadline:
            status = fleet_b.status() or {}
            reps = status.get("replicas", [])
            if len(reps) == expect and all(r.get("healthy") for r in reps):
                rejoin_s = time.monotonic() - t_restart
                break
            time.sleep(0.1)
        time.sleep(max(1.0, cfg.phase_seconds * 0.25))
        t_end = time.monotonic()
        clients.join()
        overall = clients.summarize(t0, t_end)
        failed = overall["failed"] + overall["transportErrors"]
        return {
            "replicasPerHost": cfg.replicas_per_host,
            "readySeconds": round(ready_s, 2),
            "killedPids": len(pids) + 1,  # replicas + the router tree
            "overall": overall,
            "routerFailovers": clients.router_failovers,
            "absorbSeconds": round(absorb_s, 3) if absorb_s is not None else None,
            "evictSeconds": round(evict_s, 3) if evict_s is not None else None,
            "rejoinSeconds": round(rejoin_s, 3) if rejoin_s is not None else None,
            "failedQueries": failed,
            "ok": bool(
                failed == 0
                and overall["requests"] > 0
                and absorb_s is not None
                and evict_s is not None
                and rejoin_s is not None
            ),
        }
    finally:
        if clients is not None:
            clients.stop.set()
        for f in (fleet_a, fleet_a2, fleet_b):
            if f is not None:
                f.stop()


def _autoscale_phase(
    base: str, seed_dir: str, engine_json: str, cfg: FleetChaosConfig
) -> dict:
    """Watermark scale-up under load, then drain-aware retirement under
    a trickle — zero queries lost across both transitions."""
    reg_dir = os.path.join(base, "endpoints-autoscale")
    host_dir, env = _elastic_host(base, seed_dir, "hostScale")
    # watermarks sized to the drill: 16 concurrent clients blow far past
    # 8 q/s per replica; the 1 q/s trickle sits far below 2 q/s per
    # replica once the trailing window drains
    fleet = _elastic_fleet(
        env, host_dir, engine_json, reg_dir, cfg, 1,
        extra_args=(
            "--autoscale", "1:2",
            "--scale-up-qps", "8",
            "--scale-down-qps", "2",
            "--scale-cooldown-s", "1",
        ),
    )
    clients: _QueryClients | None = None
    trickle_stop = threading.Event()
    trickle = {"requests": 0, "failed": 0, "statuses": []}
    trickle_lock = threading.Lock()

    def trickle_client() -> None:
        i = 0
        while not trickle_stop.is_set():
            i += 1
            payload = json.dumps(
                {"user": f"u{i % cfg.train_users}", "num": 4}
            ).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{fleet.port}/queries.json",
                data=payload,
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            status = 0
            try:
                with urllib.request.urlopen(
                    req, timeout=cfg.query_timeout_s
                ) as resp:
                    resp.read()
                    status = resp.status
            except urllib.error.HTTPError as e:
                e.read()
                status = e.code
            except Exception:
                status = 0
            with trickle_lock:
                trickle["requests"] += 1
                if not 200 <= status < 300:
                    trickle["failed"] += 1
                    trickle["statuses"].append(status)
            trickle_stop.wait(1.0)

    try:
        _wait_fleet_view(fleet, 1, cfg.startup_timeout_s, "autoscale")
        _warm_fleet(fleet.port, cfg)
        clients = _QueryClients(fleet.port, cfg)
        clients.start()
        t0 = time.monotonic()

        # ---- scale-up: the ring must grow to 2 healthy replicas (cold
        # replica start pays the model load, hence the startup budget)
        scale_up_s = None
        deadline = t0 + cfg.startup_timeout_s
        while time.monotonic() < deadline:
            status = fleet.status() or {}
            reps = status.get("replicas", [])
            if len(reps) == 2 and all(r.get("healthy") for r in reps):
                scale_up_s = time.monotonic() - t0
                break
            time.sleep(0.1)
        t_load_end = time.monotonic()
        clients.join()
        load_summary = clients.summarize(t0, t_load_end)

        # ---- scale-down: drop to a trickle; the autoscaler must retire
        # one replica drain-aware (its registry entry withdrawn on clean
        # exit) without losing a single trickle query
        trickle_thread = threading.Thread(
            target=trickle_client, name="chaos-trickle", daemon=True
        )
        trickle_thread.start()
        scale_down_s = None
        if scale_up_s is not None:
            t1 = time.monotonic()
            deadline = t1 + cfg.startup_timeout_s
            while time.monotonic() < deadline:
                status = fleet.status() or {}
                reps = status.get("replicas", [])
                if len(reps) == 1 and all(r.get("healthy") for r in reps):
                    scale_down_s = time.monotonic() - t1
                    break
                time.sleep(0.1)
        # a couple more trickle beats AFTER the retirement settles —
        # the survivor must be serving alone
        trickle_stop.wait(2.0)
        trickle_stop.set()
        trickle_thread.join(timeout=10)
        with trickle_lock:
            trickle_out = dict(trickle)
        failed = (
            load_summary["failed"]
            + load_summary["transportErrors"]
            + trickle_out["failed"]
        )
        return {
            "scaleUpSeconds": round(scale_up_s, 2)
            if scale_up_s is not None
            else None,
            "scaleDownSeconds": round(scale_down_s, 2)
            if scale_down_s is not None
            else None,
            "loadWindow": load_summary,
            "trickle": {
                "requests": trickle_out["requests"],
                "failed": trickle_out["failed"],
                "failedStatuses": sorted(set(trickle_out["statuses"])),
            },
            "failedQueries": failed,
            "ok": bool(
                scale_up_s is not None
                and scale_down_s is not None
                and failed == 0
                and load_summary["requests"] > 0
                and trickle_out["requests"] > 0
            ),
        }
    finally:
        trickle_stop.set()
        if clients is not None:
            clients.stop.set()
        fleet.stop()


def _query_once(
    port: int, payload: bytes, timeout_s: float
) -> tuple[int, dict]:
    """One never-retried query; returns (status, lowercased headers)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=payload,
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            resp.read()
            return resp.status, {k.lower(): v for k, v in resp.headers.items()}
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, {k.lower(): v for k, v in e.headers.items()}


def _stale_phase(
    base: str, seed_dir: str, engine_json: str, cfg: FleetChaosConfig
) -> dict:
    """Stale-while-down: with every owner replica dead, a cached scope
    is served marked-stale, an uncached scope is a clean 503, and a
    healthy fleet never emits the marker."""
    reg_dir = os.path.join(base, "endpoints-stale")
    host_dir, env = _elastic_host(base, seed_dir, "hostStale")
    stale_cfg = dataclasses.replace(cfg, lease_ttl_s=10.0)  # outlive the outage
    fleet = _elastic_fleet(
        env, host_dir, engine_json, reg_dir, stale_cfg, 1,
        extra_args=("--stale-cache-ttl-s", "60"),
    )
    cached = json.dumps({"user": "u0", "num": 4}).encode()
    uncached = json.dumps({"user": "u59", "num": 4}).encode()
    report: dict[str, Any] = {}
    try:
        _wait_fleet_view(fleet, 1, cfg.startup_timeout_s, "stale")
        _warm_fleet(fleet.port, cfg, distinct_users=1)  # warms u0
        fresh_status, fresh_headers = _query_once(
            fleet.port, cached, cfg.query_timeout_s
        )
        report["freshStatus"] = fresh_status
        report["freshMarked"] = "x-pio-stale" in fresh_headers

        state = fleet.state() or {}
        rep = (state.get("replicas") or [{}])[0]
        rid, pid = str(rep.get("id")), int(rep.get("pid") or 0)
        if not pid:
            raise ChaosError("stale phase: no replica pid on file")
        os.kill(pid, signal.SIGKILL)
        try:
            stale_status, stale_headers = _query_once(
                fleet.port, cached, cfg.query_timeout_s
            )
        except OSError as e:
            stale_status, stale_headers = 0, {"error": str(e)}
        report["staleStatus"] = stale_status
        report["staleMarked"] = stale_headers.get("x-pio-stale") == "true"
        try:
            uncached_status, uncached_headers = _query_once(
                fleet.port, uncached, cfg.query_timeout_s
            )
        except OSError:
            uncached_status, uncached_headers = 0, {}
        report["uncachedStatus"] = uncached_status
        report["uncachedMarked"] = "x-pio-stale" in uncached_headers

        respawned = fleet.wait_respawn(rid, pid, cfg.startup_timeout_s)
        report["respawned"] = respawned
        after_status, after_marked = 0, True
        deadline = time.monotonic() + cfg.startup_timeout_s
        while time.monotonic() < deadline:
            try:
                after_status, after_headers = _query_once(
                    fleet.port, cached, cfg.query_timeout_s
                )
            except OSError:
                time.sleep(0.2)
                continue
            after_marked = "x-pio-stale" in after_headers
            if after_status == 200 and not after_marked:
                break
            time.sleep(0.2)
        report["freshAfterStatus"] = after_status
        report["freshAfterMarked"] = after_marked
    finally:
        fleet.stop()
    report["ok"] = bool(
        report.get("freshStatus") == 200
        and not report.get("freshMarked")
        and report.get("staleStatus") == 200
        and report.get("staleMarked")
        and report.get("uncachedStatus") == 503
        and not report.get("uncachedMarked")
        and report.get("respawned")
        and report.get("freshAfterStatus") == 200
        and not report.get("freshAfterMarked")
    )
    return report


def run_chaos_fleet(cfg: FleetChaosConfig) -> dict:
    """Run the full elastic-fleet drill; returns the report dict
    (``report["ok"]`` is the overall verdict, and the CLI's exit code)."""
    base = cfg.base_dir or tempfile.mkdtemp(prefix="pio_chaos_fleet_")
    os.makedirs(base, exist_ok=True)
    seed_dir = os.path.join(base, "seed")
    os.makedirs(seed_dir, exist_ok=True)
    env = _storage_env(seed_dir, "sqlite")
    report: dict[str, Any] = {
        "replicasPerHost": cfg.replicas_per_host,
        "clients": cfg.clients,
        "leaseTtlSeconds": cfg.lease_ttl_s,
        "seed": cfg.seed,
        "device": cfg.device,
        "cpuCount": os.cpu_count(),
    }
    t_start = time.monotonic()
    try:
        t0 = time.monotonic()
        engine_json = _serve_setup(env, seed_dir, cfg)
        report["setupSeconds"] = round(time.monotonic() - t0, 1)
        report["hostKill"] = _host_kill_phase(base, seed_dir, engine_json, cfg)
        if cfg.autoscale_phase:
            report["autoscale"] = _autoscale_phase(
                base, seed_dir, engine_json, cfg
            )
        if cfg.stale_phase:
            report["staleWhileDown"] = _stale_phase(
                base, seed_dir, engine_json, cfg
            )
        report["totalSeconds"] = round(time.monotonic() - t_start, 1)
    except (ChaosError, subprocess.TimeoutExpired) as e:
        report["error"] = str(e)[:800]
        report["ok"] = False
        return report
    finally:
        if not cfg.keep_dir and cfg.base_dir is None:
            shutil.rmtree(base, ignore_errors=True)
        else:
            report["storageDir"] = base
    report["ok"] = bool(
        report.get("hostKill", {}).get("ok")
        and (not cfg.autoscale_phase or report.get("autoscale", {}).get("ok"))
        and (not cfg.stale_phase or report.get("staleWhileDown", {}).get("ok"))
    )
    return report
