"""Replica process supervision for ``pio deploy --replicas N``.

The supervisor owns the replica *processes* the way the router owns the
replica *traffic*: it spawns N query-server subprocesses (each a full
``pio deploy`` with the operator's flags, so ``--shard-factors`` /
``--quantize`` / ``--ann`` compose per replica), respawns any replica
that dies (rate-limited, so a crash-looping model cannot fork-bomb the
host), and records the live topology in a **fleet state file** under the
deployments directory — the single source of truth ``pio status``, the
fleet drills, and operators use to find replica ports and PIDs.

Self-healing is what turns the router's route-around into recovery: the
router hides a SIGKILLed replica within one probe interval, and the
supervisor brings a replacement up on the same port so capacity (and the
hash ring's affinity — the ring is keyed by replica id, which the
replacement inherits) returns without operator action. Under k8s the
Deployment controller plays this role instead; this supervisor is the single-host story.

Stdlib-only by contract: process control and JSON state only.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Sequence

__all__ = [
    "FleetSupervisor",
    "ReplicaSpec",
    "fleet_state_path",
    "read_fleet_state",
]

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """One replica's identity and launch recipe."""

    replica_id: str
    port: int
    #: full argv AFTER the interpreter (e.g. ``["-m",
    #: "predictionio_tpu_torch.tools.console", "deploy", ...]``)
    argv: tuple[str, ...]


def fleet_state_path(base_dir: str, router_port: int) -> str:
    return os.path.join(
        base_dir, "deployments", f"fleet-{router_port}.json"
    )


def read_fleet_state(path: str) -> dict | None:
    """The fleet topology document, or None when absent/torn."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError, OSError):
        return None
    return doc if isinstance(doc, dict) else None


class FleetSupervisor:
    """Spawns, watches, respawns, and stops the replica subprocesses."""

    #: respawn rate limit per replica: more than this many deaths inside
    #: the window means the replica is crash-looping (bad model, bad
    #: flags) — stop respawning it and mark it failed in the state file
    MAX_RESPAWNS = 5
    RESPAWN_WINDOW_S = 60.0

    def __init__(
        self,
        specs: Sequence[ReplicaSpec],
        state_path: str,
        router_port: int,
        env: dict | None = None,
        poll_interval_s: float = 0.5,
    ):
        self.specs = list(specs)
        self.state_path = state_path
        self.router_port = router_port
        self.env = dict(env) if env is not None else None
        self.poll_interval_s = poll_interval_s
        self._lock = threading.Lock()
        self._procs: dict[str, subprocess.Popen] = {}
        #: retired replicas still draining — stop() escalates on them too
        self._retiring: list[subprocess.Popen] = []
        self._respawn_times: dict[str, list[float]] = {}
        self._failed: set[str] = set()
        self._stopping = threading.Event()
        self._monitor: threading.Thread | None = None

    # -------------------------------------------------------------- spawn
    def _spawn(self, spec: ReplicaSpec) -> subprocess.Popen:
        proc = subprocess.Popen(
            [sys.executable, *spec.argv],
            env=self.env,
            stdin=subprocess.DEVNULL,
        )
        logger.info(
            "spawned replica %s (port %d, pid %d)",
            spec.replica_id, spec.port, proc.pid,
        )
        return proc

    def start(self) -> None:
        # spawn OUTSIDE the lock (Popen blocks); publish under it
        spawned = {spec.replica_id: self._spawn(spec) for spec in self.specs}
        monitor = threading.Thread(
            target=self._monitor_loop, name="fleet-supervisor", daemon=True
        )
        with self._lock:
            self._procs.update(spawned)
            self._monitor = monitor
        self.write_state()
        monitor.start()

    # ------------------------------------------------------------- monitor
    def _monitor_loop(self) -> None:
        while not self._stopping.wait(self.poll_interval_s):
            changed = False
            with self._lock:
                specs = list(self.specs)  # autoscaler mutates the fleet
            for spec in specs:
                with self._lock:
                    proc = self._procs.get(spec.replica_id)
                    failed = spec.replica_id in self._failed
                if failed or proc is None or proc.poll() is None:
                    continue
                rc = proc.returncode
                now = time.monotonic()
                times = self._respawn_times.setdefault(spec.replica_id, [])
                times[:] = [
                    t for t in times if now - t < self.RESPAWN_WINDOW_S
                ]
                if len(times) >= self.MAX_RESPAWNS:
                    logger.error(
                        "replica %s crash-looping (rc=%s, %d respawns in "
                        "%.0fs) — giving up on it",
                        spec.replica_id, rc, len(times), self.RESPAWN_WINDOW_S,
                    )
                    with self._lock:
                        self._failed.add(spec.replica_id)
                    changed = True
                    continue
                times.append(now)
                if self._stopping.is_set():
                    # stop() raced this iteration: it has already
                    # snapshotted the process list, so a respawn here
                    # would orphan the replacement past the shutdown
                    return
                logger.warning(
                    "replica %s (port %d) exited rc=%s — respawning",
                    spec.replica_id, spec.port, rc,
                )
                try:
                    replacement = self._spawn(spec)  # outside the lock
                except OSError as e:
                    # transient fork/exec failure (EAGAIN, ENOMEM): the
                    # monitor thread must survive it — this attempt
                    # counted toward the rate limit above, and the next
                    # poll retries. An unhandled raise here would kill
                    # the supervisor thread and silently disable
                    # self-healing for the whole fleet.
                    logger.error(
                        "respawn of replica %s failed: %s", spec.replica_id, e
                    )
                    continue
                with self._lock:
                    if self._stopping.is_set():
                        # stop() won the race mid-spawn: the snapshot
                        # missed the replacement, so terminate it here
                        replacement.terminate()
                        return
                    self._procs[spec.replica_id] = replacement
                changed = True
            if changed and not self._stopping.is_set():
                self.write_state()

    # ------------------------------------------------------------- elastic
    def add_replica(self, spec: ReplicaSpec) -> None:
        """Scale-up: spawn one more replica and start watching it."""
        if self._stopping.is_set():
            return
        proc = self._spawn(spec)  # outside the lock (Popen blocks)
        with self._lock:
            if self._stopping.is_set():
                proc.terminate()
                return
            self.specs.append(spec)
            self._procs[spec.replica_id] = proc
        self.write_state()

    def retire_replica(self, replica_id: str) -> bool:
        """Scale-down, drain-aware: remove the spec FIRST (so the monitor
        never respawns it), then SIGTERM — the replica drains in-flight
        queries per its ``--drain-deadline-s`` and withdraws its own
        registry entry on clean exit. Returns whether a replica was
        actually retired."""
        with self._lock:
            spec = next(
                (s for s in self.specs if s.replica_id == replica_id), None
            )
            if spec is None:
                return False
            self.specs.remove(spec)
            proc = self._procs.pop(replica_id, None)
            if proc is not None:
                self._retiring.append(proc)
            self._failed.discard(replica_id)
            self._respawn_times.pop(replica_id, None)
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
        logger.info("retiring replica %s (drain via SIGTERM)", replica_id)
        self.write_state()
        return True

    def retiring_count(self) -> int:
        """Retired replicas still draining (their process has not exited
        yet) — the autoscaler holds further scale-downs while > 0."""
        with self._lock:
            self._retiring = [p for p in self._retiring if p.poll() is None]
            return len(self._retiring)

    # --------------------------------------------------------------- state
    def state(self) -> dict:
        with self._lock:
            replicas = []
            for spec in self.specs:
                proc = self._procs.get(spec.replica_id)
                replicas.append(
                    {
                        "id": spec.replica_id,
                        "port": spec.port,
                        "pid": proc.pid if proc is not None else None,
                        "alive": proc is not None and proc.poll() is None,
                        "failed": spec.replica_id in self._failed,
                    }
                )
        return {
            "routerPort": self.router_port,
            "supervisorPid": os.getpid(),
            "replicas": replicas,
        }

    def write_state(self) -> None:
        doc = self.state()
        directory = os.path.dirname(self.state_path)
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            prefix=".fleet.", suffix=".tmp", dir=directory
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=2)
                # full durability protocol (PIO501/PIO502): the state
                # file is how a post-crash `pio status` finds orphaned
                # replica PIDs to clean up — a torn or forgotten file
                # after a host reset would leak the whole fleet
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.state_path)
            dfd = os.open(directory, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        finally:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass

    # ---------------------------------------------------------------- stop
    def stop(self, grace_s: float = 10.0) -> None:
        """SIGTERM every replica, escalate to SIGKILL after ``grace_s``,
        and remove the state file. Idempotent."""
        if self._stopping.is_set():
            return
        self._stopping.set()
        with self._lock:
            procs = list(self._procs.values()) + list(self._retiring)
        for proc in procs:
            if proc.poll() is None:
                try:
                    proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + grace_s
        for proc in procs:
            remaining = max(0.1, deadline - time.monotonic())
            try:
                proc.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                proc.kill()
                try:
                    proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass
        try:
            os.unlink(self.state_path)
        except FileNotFoundError:
            pass
