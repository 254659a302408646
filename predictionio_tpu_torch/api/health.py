"""Readiness-check helpers shared by every framework server.

``GET /healthz`` (liveness) is answered by the transport itself
(:mod:`predictionio_tpu_torch.api.http`); ``GET /readyz`` (readiness) calls
the service's ``readiness()`` hook, and these helpers keep those hooks
uniform: each dependency check is ``{"ok": bool, "error"?: str}`` and
the report is ``{"ready": all-ok, "checks": {...}}``.

The storage check is a cheap metadata point-read under a short
:func:`~predictionio_tpu_torch.resilience.deadline_scope`, so a probe against
a dead storage server costs at most ``timeout_s`` — and, once the remote
driver's circuit breaker is open, microseconds.

Counterpart of ``predictionio_tpu/api/health.py``, the same code with the
port's imports.
"""

from __future__ import annotations

from typing import Any, Mapping

__all__ = [
    "events_check",
    "readiness_report",
    "replication_check",
    "storage_check",
]


def storage_check(timeout_s: float = 2.0) -> dict:
    """Is the configured metadata storage reachable? Uses ``apps.get`` on
    a never-assigned id: every backend serves it as a point lookup and it
    exercises the full transport (including retry/breaker policy for
    ``TYPE=remote``) without touching real data."""
    from predictionio_tpu_torch import resilience
    from predictionio_tpu_torch.data.storage import Storage

    try:
        with resilience.deadline_scope(timeout_s):
            Storage.get_meta_data_apps().get(-1)
        return {"ok": True}
    except Exception as e:
        return {"ok": False, "error": str(e)[:200]}


def events_check(timeout_s: float = 2.0) -> dict:
    """Is the configured EVENTDATA storage reachable? It may be a
    different source than metadata (e.g. columnar events + sqlite
    metadata), so an ingest-path server must probe it separately. A
    point-get of a never-assigned event id answers None on every driver
    without touching real data."""
    from predictionio_tpu_torch import resilience
    from predictionio_tpu_torch.data.storage import Storage

    try:
        with resilience.deadline_scope(timeout_s):
            Storage.get_l_events().get("__readyz_probe__", 0)
        return {"ok": True}
    except Exception as e:
        return {"ok": False, "error": str(e)[:200]}


def replication_check() -> dict | None:
    """Quorum health of a partitioned+replicated event store; ``None``
    when the store has no replication (the check is then omitted from
    the report — a plain server's /readyz payload is unchanged). Any
    partition below its ack quorum makes the server NOT ready: appends
    routed there are failing loudly, and load balancers should stop
    sending bulk streams here until the fleet heals."""
    from predictionio_tpu_torch.data.storage import Storage

    health = getattr(Storage.get_l_events(), "replication_health", None)
    if not callable(health):
        return None
    try:
        per_partition = health()
    except Exception as e:
        return {"ok": False, "error": str(e)[:200]}
    if per_partition is None:
        return None
    degraded = [
        p["partition"] for p in per_partition if not p.get("quorumOk")
    ]
    out: dict = {"ok": not degraded}
    if degraded:
        out["error"] = (
            f"quorum lost on partition(s) {degraded}: appends there fail "
            "until replicas heal"
        )
        out["degradedPartitions"] = degraded
    return out


def readiness_report(**checks: Mapping[str, Any]) -> dict:
    """Fold named checks into the ``/readyz`` payload; ready only when
    every check passed."""
    return {
        "ready": all(bool(c.get("ok")) for c in checks.values()),
        "checks": {k: dict(v) for k, v in checks.items()},
    }
