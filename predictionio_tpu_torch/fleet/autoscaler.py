"""Watermark autoscaler: spawn/retire replicas on q/s + p99 pressure.

Counterpart of ``predictionio_tpu/fleet/autoscaler.py``, a copy.

The autoscaler closes the loop between the router's observed load and
the supervisor's process control (``pio deploy --replicas N --autoscale
MIN:MAX``): each interval it reads the router's trailing-window load
snapshot (queries/second and p99 latency), and

* **scales up** when per-replica q/s exceeds ``scale_up_qps`` OR p99
  exceeds ``scale_up_p99_ms`` — one replica at a time, up to ``max``;
  the new replica binds port 0, self-reports through the shared
  :class:`~predictionio_tpu_torch.fleet.registry.EndpointRegistry`, and joins
  the ring at the router's next reconcile;
* **scales down** when per-replica q/s falls below ``scale_down_qps``
  (and p99 is calm) — **drain-aware**: retirement is a SIGTERM, so the
  replica finishes its in-flight queries (the ``--drain-deadline-s``
  contract), answers new work with drain 503s the router treats as a
  routing signal, withdraws its own registry entry on clean exit, and
  only then disappears from the ring. Zero in-flight queries are lost.

Decisions are damped three ways so the fleet cannot flap: a cooldown
after every action, a floor of ``min`` replicas, and scale-down only
when the fleet is at steady state (no replica currently retiring).

Stdlib-only by contract, like the rest of the fleet package.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable

from predictionio_tpu_torch.fleet.supervisor import FleetSupervisor, ReplicaSpec

__all__ = ["Autoscaler", "AutoscalerConfig"]

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Watermarks and damping (CLI: ``--autoscale MIN:MAX`` + knobs)."""

    min_replicas: int = 1
    max_replicas: int = 4
    #: per-replica q/s above which one replica is added
    scale_up_qps: float = 50.0
    #: p99 latency (ms) above which one replica is added regardless of q/s
    scale_up_p99_ms: float = 250.0
    #: per-replica q/s below which one replica is drained away
    scale_down_qps: float = 5.0
    #: seconds between scaling actions (damping)
    cooldown_s: float = 10.0
    #: seconds between load evaluations
    interval_s: float = 1.0
    #: trailing window the load snapshot aggregates over
    window_s: float = 5.0

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.scale_down_qps >= self.scale_up_qps:
            raise ValueError(
                "scale_down_qps must be < scale_up_qps (hysteresis band)"
            )
        if self.interval_s <= 0 or self.cooldown_s < 0:
            raise ValueError("interval_s must be > 0, cooldown_s >= 0")


class Autoscaler:
    """Periodic evaluate→act loop over (router load, supervisor fleet).

    ``spawn_spec`` mints the launch recipe for a new replica id — the
    console builds it from the operator's own deploy flags, so scaled-up
    replicas compose with ``--shard-factors``/``--quantize``/... exactly
    like the initial fleet.
    """

    def __init__(
        self,
        router,  # RouterService (duck-typed: load_snapshot())
        supervisor: FleetSupervisor,
        spawn_spec: Callable[[str], ReplicaSpec],
        config: AutoscalerConfig | None = None,
    ):
        self.router = router
        self.supervisor = supervisor
        self.spawn_spec = spawn_spec
        self.config = config or AutoscalerConfig()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._next_id = 0
        self._last_action_at = 0.0  # monotonic; 0 = never acted
        self._history: list[dict] = []  # bounded action log
        self.scale_ups = 0
        self.scale_downs = 0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="fleet-autoscaler", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.evaluate_once()
            except Exception as e:  # the loop must survive any one tick
                logger.error("autoscaler tick failed: %s", e)

    # ------------------------------------------------------------- decision
    def _fleet_size(self) -> int:
        with self.supervisor._lock:
            return len(self.supervisor.specs)

    def _mint_replica_id(self) -> str:
        with self.supervisor._lock:
            taken = {s.replica_id for s in self.supervisor.specs}
        while True:
            with self._lock:
                self._next_id += 1
                rid = f"scale{self._next_id}"
            if rid not in taken:
                return rid

    def decide(self, load: dict, size: int) -> str:
        """Pure watermark decision: ``"up"``, ``"down"``, or ``"hold"``."""
        if size < self.config.min_replicas:
            return "up"
        qps_per_replica = load.get("qps", 0.0) / max(1, size)
        p99_ms = load.get("p99Seconds", 0.0) * 1000.0
        if size < self.config.max_replicas and (
            qps_per_replica > self.config.scale_up_qps
            or p99_ms > self.config.scale_up_p99_ms
        ):
            return "up"
        if (
            size > self.config.min_replicas
            and qps_per_replica < self.config.scale_down_qps
            and p99_ms <= self.config.scale_up_p99_ms
        ):
            return "down"
        return "hold"

    def evaluate_once(self) -> dict:
        """One evaluate→act tick; returns what happened (for tests and
        ``/fleet/endpoints.json``-adjacent observability)."""
        now = time.monotonic()
        load = self.router.load_snapshot(self.config.window_s)
        size = self._fleet_size()
        action = self.decide(load, size)
        cooled = now - self._last_action_at >= self.config.cooldown_s
        outcome = {
            "action": action,
            "applied": False,
            "size": size,
            "qps": round(load.get("qps", 0.0), 3),
            "p99Ms": round(load.get("p99Seconds", 0.0) * 1000.0, 3),
        }
        if action == "hold" or not cooled:
            if action != "hold":
                outcome["action"] = f"{action}_cooldown"
            return self._record(outcome)
        if action == "down" and self.supervisor.retiring_count() > 0:
            # steady-state gate: never stack drains — a second retirement
            # while one replica is still draining could dip capacity two
            # replicas below the decision's basis
            outcome["action"] = "down_waiting_drain"
            return self._record(outcome)
        if action == "up":
            rid = self._mint_replica_id()
            spec = self.spawn_spec(rid)
            self.supervisor.add_replica(spec)
            self.scale_ups += 1
            outcome.update(applied=True, replicaId=rid, size=size + 1)
            logger.info(
                "scale-up → %d replicas (qps=%.1f p99=%.0fms): spawned %s",
                size + 1, load.get("qps", 0.0), outcome["p99Ms"], rid,
            )
        else:
            rid = self._pick_retiree()
            if rid is None:
                return self._record(outcome)
            if self.supervisor.retire_replica(rid):
                self.scale_downs += 1
                outcome.update(applied=True, replicaId=rid, size=size - 1)
                logger.info(
                    "scale-down → %d replicas (qps=%.1f): draining %s",
                    size - 1, load.get("qps", 0.0), rid,
                )
        with self._lock:
            self._last_action_at = time.monotonic()
        return self._record(outcome)

    def _pick_retiree(self) -> str | None:
        """Retire the youngest scaled-up replica first (``scaleN`` ids),
        falling back to the highest-numbered original — the initial
        fleet's low-numbered replicas are the last to go."""
        with self.supervisor._lock:
            ids = [s.replica_id for s in self.supervisor.specs]
        if not ids:
            return None
        scaled = sorted(
            (i for i in ids if i.startswith("scale")), reverse=True
        )
        return scaled[0] if scaled else sorted(ids)[-1]

    def _record(self, outcome: dict) -> dict:
        with self._lock:
            self._history.append(outcome)
            del self._history[:-100]
        return outcome

    def to_json(self) -> dict:
        with self._lock:
            history = list(self._history[-20:])
        return {
            "config": dataclasses.asdict(self.config),
            "scaleUps": self.scale_ups,
            "scaleDowns": self.scale_downs,
            "recent": history,
        }
