"""Replica-fleet serving: router, health gating, rolling model swap.

Counterpart of ``predictionio_tpu/fleet/``, a copy: the fleet is
stdlib-only, so the port runs the reference's code on its own
``resilience`` and ``serving.cache``, and the files it writes (the
model registry, the endpoint entries, the fleet state) are read by both
packages.

One process — even a multi-device mesh process (``--shard-factors``) —
is still one SIGKILL away from an outage. This package composes **R
replicas** behind a router so the served product survives any single
replica dying, reloading, or draining (the serving-fleet
topology of PredictionIO's query-server tier, scaled the way ALX scales
model-parallel serving beyond one host — PAPERS.md):

* :mod:`predictionio_tpu_torch.fleet.ring` — consistent-hash-by-cache-scope
  routing, so the result cache *shards* across replicas instead of
  duplicating (a scope's repeated queries always land on the same
  replica) and a membership change remaps only ~1/R of scopes;
* :mod:`predictionio_tpu_torch.fleet.router` — the router process behind
  ``pio deploy --replicas N``: per-replica health tracking (active
  ``/readyz`` probes + passive failure counting + a
  :class:`~predictionio_tpu_torch.resilience.CircuitBreaker` per backend),
  bounded same-query failover for idempotent requests, ``Retry-After``-
  aware draining avoidance, optional p95-triggered hedged requests,
  invalidation broadcast, and router-orchestrated rolling ``/reload``;
* :mod:`predictionio_tpu_torch.fleet.registry` — a generation-stamped model
  registry over shared-filesystem storage, so every replica of a fleet
  (and every fleet of a cluster) agrees on which model generation is
  being rolled out — plus the **endpoint registry**: lease-stamped
  per-replica entry files through which replicas on ANY host
  self-report their port-0-bound address and join the ring (``pio
  deploy --endpoint-registry DIR``), with expiry-based eviction claimed
  exactly once across an HA router pair;
* :mod:`predictionio_tpu_torch.fleet.supervisor` — spawns the N query-server
  subprocesses, respawns any that die, and records the fleet topology
  where operators (``pio status``) and drills can find it; the
  autoscaler adds/retires replicas through it at runtime;
* :mod:`predictionio_tpu_torch.fleet.autoscaler` — watermark-driven elastic
  capacity (``--autoscale MIN:MAX``): scale-up on q/s or p99 pressure,
  drain-aware scale-down that loses zero in-flight queries.

Stdlib-only by contract: the fleet layer is host orchestration over
HTTP and must run with no torch, jax, numpy, or storage
imports — replicas are opaque processes behind URLs. The only framework
imports allowed are the equally stdlib-only resilience primitives, the
HTTP transport, and ``serving.cache``'s key helpers. Everything is
strictly opt-in: without ``--replicas`` nothing here is ever imported
and serving is byte-identical (tests/test_torch_no_jax.py).
"""

from __future__ import annotations

from predictionio_tpu_torch.fleet.autoscaler import Autoscaler, AutoscalerConfig
from predictionio_tpu_torch.fleet.registry import (
    EndpointRecord,
    EndpointRegistry,
    ModelRegistry,
    RegistryRecord,
)
from predictionio_tpu_torch.fleet.ring import HashRing
from predictionio_tpu_torch.fleet.router import (
    ReplicaState,
    RouterConfig,
    RouterService,
)
from predictionio_tpu_torch.fleet.supervisor import (
    FleetSupervisor,
    ReplicaSpec,
    fleet_state_path,
    read_fleet_state,
)

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "EndpointRecord",
    "EndpointRegistry",
    "FleetSupervisor",
    "HashRing",
    "ModelRegistry",
    "RegistryRecord",
    "ReplicaSpec",
    "ReplicaState",
    "RouterConfig",
    "RouterService",
    "fleet_state_path",
    "read_fleet_state",
]
