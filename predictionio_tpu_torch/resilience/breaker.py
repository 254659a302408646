"""Circuit breaker: closed -> open -> half-open with probe requests.

When a dependency (the remote storage server, the feedback event server)
is *down*, naive callers stack full timeouts: every request pays the
whole connect/read timeout before failing, so a 30-second storage outage
turns into minutes of convoyed handler threads. The breaker converts
that into fast failures: after ``failure_threshold`` consecutive
transport failures it opens and rejects calls instantly; after
``reset_timeout_s`` it lets exactly ONE probe through (half-open) — a
probe success closes the circuit, a probe failure re-opens it for
another full reset window.

Only *transport-level* failures should be recorded — an application
error (HTTP 4xx, "unknown method") proves the dependency is up and must
``record_success``; classifying is the transport's job.

Stdlib-only by contract (tests/test_ci_guards.py).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

__all__ = ["CircuitBreaker", "CircuitOpenError"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitOpenError(Exception):
    """Fast failure: the circuit is open and the call was not attempted."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    """Thread-safe three-state breaker with an injectable clock.

    Use either the low-level protocol — ``acquire()`` before the call
    (False = fail fast), then exactly one of ``record_success()`` /
    ``record_failure()`` — or the :meth:`call` wrapper.
    """

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_timeout_s: float = 5.0,
        name: str = "",
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if reset_timeout_s < 0:
            raise ValueError("reset_timeout_s must be >= 0")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        # monotonic counters for /stats.json
        self._opened_count = 0
        self._fast_fails = 0
        self._probes = 0

    # ------------------------------------------------------------- protocol
    def acquire(self) -> bool:
        """May this call proceed? False means the circuit is open — fail
        fast without touching the dependency."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.reset_timeout_s:
                    self._state = HALF_OPEN
                    self._probe_in_flight = True
                    self._probes += 1
                    return True
                self._fast_fails += 1
                return False
            # HALF_OPEN: one probe at a time
            if self._probe_in_flight:
                self._fast_fails += 1
                return False
            self._probe_in_flight = True
            self._probes += 1
            return True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probe_in_flight = False
            self._state = CLOSED

    def record_cancelled(self) -> None:
        """The caller aborted the attempt for its own reasons (e.g. a
        tight deadline starved it before the dependency could answer):
        the dependency's health is UNKNOWN, so this neither counts toward
        the failure streak nor closes the circuit — it only releases a
        half-open probe slot so the breaker cannot wedge."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_in_flight = False
                # old opened_at is kept: the next acquire may re-probe
                # immediately instead of waiting a fresh reset window
                self._state = OPEN

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                # failed probe: back to a full reset window
                self._probe_in_flight = False
                self._state = OPEN
                self._opened_at = self._clock()
                self._opened_count += 1
            elif (
                self._state == CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._state = OPEN
                self._opened_at = self._clock()
                self._opened_count += 1

    # ------------------------------------------------------------ convenience
    @property
    def state(self) -> str:
        with self._lock:
            # surface open->half-open eligibility without mutating: an
            # operator reading /stats.json should see "open" until a
            # probe actually goes out
            return self._state

    def retry_after_s(self) -> float:
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(
                0.0, self.reset_timeout_s - (self._clock() - self._opened_at)
            )

    def call(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` under the breaker; raises :class:`CircuitOpenError`
        instead of calling when open."""
        if not self.acquire():
            raise CircuitOpenError(
                f"circuit '{self.name or 'breaker'}' is open",
                retry_after_s=self.retry_after_s(),
            )
        try:
            result = fn()
        except BaseException:
            # BaseException: a KeyboardInterrupt/SystemExit mid-probe must
            # still release the half-open probe slot or the breaker wedges
            self.record_failure()
            raise
        self.record_success()
        return result

    def to_json(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutiveFailures": self._consecutive_failures,
                "failureThreshold": self.failure_threshold,
                "resetTimeoutSeconds": self.reset_timeout_s,
                "openedCount": self._opened_count,
                "fastFails": self._fast_fails,
                "probes": self._probes,
            }
