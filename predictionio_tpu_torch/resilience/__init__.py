"""Resilience layer — retries, circuit breaking, deadlines, fault injection.

At production scale transient storage/network faults are the common
case, not the exception (cf. the distributed-Spark lineage of the
reference: every MLlib stage assumes retried tasks); this package gives
the framework one vocabulary for surviving them:

* :class:`RetryPolicy` — exponential backoff + full jitter, idempotency-
  aware, budgeted by a :class:`Deadline` that is consumed *across*
  attempts and propagated ambiently (:func:`deadline_scope`);
* :class:`CircuitBreaker` — closed -> open -> half-open with probe
  requests, so a dead dependency fails fast instead of stacking
  timeouts;
* :class:`FaultInjector` — the deterministic harness that proves the
  above actually works (tests + ``bench.py`` ``resilience`` section);
* a process-wide stats registry: transports register their counters
  here and servers surface :func:`stats_snapshot` on ``/stats.json``.

Everything is strictly opt-in: the built-in defaults (0 retries, no
breaker, no deadline) reproduce the prior single-attempt behavior
byte-for-byte, guarded by ``tests/test_ci_guards.py``. The package is
stdlib-only and jax-free by contract (same guard): resilience is host
orchestration, never device work.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any

from predictionio_tpu_torch.resilience.breaker import CircuitBreaker, CircuitOpenError
from predictionio_tpu_torch.resilience.faults import FaultError, FaultInjector
from predictionio_tpu_torch.resilience.retry import (
    Deadline,
    DeadlineExceededError,
    RetryPolicy,
    current_deadline,
    deadline_scope,
)

__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "Deadline",
    "DeadlineExceededError",
    "FaultError",
    "FaultInjector",
    "RetryPolicy",
    "RpcDefaults",
    "current_deadline",
    "deadline_scope",
    "get_rpc_defaults",
    "register_stats",
    "set_rpc_defaults",
    "stats_snapshot",
]


# ---------------------------------------------------------------------------
# Stats registry: named to_json() providers, surfaced on /stats.json
# ---------------------------------------------------------------------------

_stats_lock = threading.Lock()
#: weak values: a replaced QueryService / storage client must not pin its
#: stats (nor keep reporting) after it is garbage collected
_stats_registry: "weakref.WeakValueDictionary[str, Any]" = (
    weakref.WeakValueDictionary()
)


def register_stats(name: str, provider: Any) -> None:
    """Register an object with a ``to_json()`` method under ``name``;
    later registrations replace earlier ones (latest client wins)."""
    with _stats_lock:
        _stats_registry[name] = provider


def stats_snapshot() -> dict[str, Any]:
    """``{name: provider.to_json()}`` for every live registered provider."""
    with _stats_lock:
        providers = dict(_stats_registry)
    out: dict[str, Any] = {}
    for name, provider in sorted(providers.items()):
        try:
            out[name] = provider.to_json()
        except Exception as e:  # a broken provider must not break /stats.json
            out[name] = {"error": str(e)[:200]}
    return out


# ---------------------------------------------------------------------------
# Process-wide RPC resilience defaults (set by `pio deploy --retry-*`)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RpcDefaults:
    """Fallbacks for storage transports whose source config does not set
    its own ``retries``/``breaker_*`` properties. The built-in values are
    the do-nothing configuration (single attempt, no breaker, no
    deadline) — resilience is strictly opt-in."""

    retries: int = 0
    retry_writes: bool = False
    breaker_threshold: int = 0  # 0 = breaker disabled
    breaker_reset_s: float = 5.0
    deadline_s: float = 0.0  # 0 = per-attempt timeout only


_rpc_defaults = RpcDefaults()
_rpc_defaults_lock = threading.Lock()


def set_rpc_defaults(**kwargs: Any) -> RpcDefaults:
    """Replace the process-wide RPC resilience defaults (CLI layer);
    returns the new value."""
    global _rpc_defaults
    with _rpc_defaults_lock:
        _rpc_defaults = dataclasses.replace(_rpc_defaults, **kwargs)
        return _rpc_defaults


def get_rpc_defaults() -> RpcDefaults:
    with _rpc_defaults_lock:
        return _rpc_defaults
