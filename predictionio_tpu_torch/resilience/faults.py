"""Deterministic fault injection for storage repos and RPC transports.

The resilience layer is only trustworthy if its failure paths are
*executed*, not just written: this harness wraps a callable, a
dispatch-protocol service, or a whole repository object and injects
error / latency / flap schedules on command, deterministically (no
randomness — schedules are by call index or by an injectable clock), so
``tests/test_resilience.py`` and the bench's ``resilience`` section can
stage a storage outage and measure recovery.

Typical shapes::

    inj = FaultInjector()
    svc = StorageRpcService(client=backing)
    server, _ = start_background(inj.wrap_dispatch(svc.dispatch))
    ...
    inj.fail_for(2.0)        # every call errors for the next 2 s
    inj.fail_next(3)         # exactly the next 3 calls error
    inj.delay_for(1.0, 500)  # +500 ms latency for 1 s
    inj.flap(period_s=0.2)   # alternate up/down windows (connection flaps)

Stdlib-only by contract (tests/test_ci_guards.py).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable

__all__ = ["FaultError", "FaultInjector"]


class FaultError(Exception):
    """The injected failure (dependency-down stand-in)."""


class FaultInjector:
    """Shared fault switchboard; every ``wrap_*`` product consults it.

    Thread-safe: load generators call through wrapped objects while the
    orchestrating thread flips schedules.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._fail_until = 0.0
        self._fail_next = 0
        self._delay_until = 0.0
        self._delay_next = 0
        self._delay_ms = 0.0
        self._flap_period_s = 0.0
        self._flap_started = 0.0
        self._script: list[str] = []
        # observability for tests/bench
        self.calls = 0
        self.injected_errors = 0
        self.injected_delays = 0

    # -------------------------------------------------------------- schedule
    def fail_for(self, seconds: float) -> None:
        """Every call within the next ``seconds`` raises (an outage)."""
        with self._lock:
            self._fail_until = self._clock() + seconds

    def fail_next(self, n: int = 1) -> None:
        """Exactly the next ``n`` calls raise (a transient blip)."""
        with self._lock:
            self._fail_next += n

    def delay_for(self, seconds: float, delay_ms: float) -> None:
        """Calls within ``seconds`` are slowed by ``delay_ms`` (brownout)."""
        with self._lock:
            self._delay_until = self._clock() + seconds
            self._delay_ms = delay_ms

    def delay_next(self, n: int, delay_ms: float) -> None:
        with self._lock:
            self._delay_next += n
            self._delay_ms = delay_ms

    def flap(self, period_s: float) -> None:
        """Alternate down/up windows of ``period_s`` each, starting down
        now; ``period_s=0`` stops flapping."""
        with self._lock:
            self._flap_period_s = period_s
            self._flap_started = self._clock()

    def script(self, steps: Iterable[str]) -> None:
        """Exact per-call schedule, consumed one step per call:
        ``"ok"`` | ``"error"`` | ``"delay:<ms>"``. After the script runs
        dry the timed/counted schedules above apply again."""
        with self._lock:
            self._script.extend(steps)

    def clear(self) -> None:
        """Back to healthy immediately (counters are kept)."""
        with self._lock:
            self._fail_until = 0.0
            self._fail_next = 0
            self._delay_until = 0.0
            self._delay_next = 0
            self._flap_period_s = 0.0
            self._script.clear()

    # ------------------------------------------------------------- injection
    def _decide(self) -> tuple[float, bool]:
        """(delay_ms, should_fail) for this call; mutates counters."""
        with self._lock:
            self.calls += 1
            if self._script:
                step = self._script.pop(0)
                if step == "error":
                    self.injected_errors += 1
                    return 0.0, True
                if step.startswith("delay:"):
                    self.injected_delays += 1
                    return float(step.split(":", 1)[1]), False
                return 0.0, False
            now = self._clock()
            delay = 0.0
            if self._delay_next > 0 or now < self._delay_until:
                if self._delay_next > 0:
                    self._delay_next -= 1
                delay = self._delay_ms
                self.injected_delays += 1
            fail = False
            if self._fail_next > 0:
                self._fail_next -= 1
                fail = True
            elif now < self._fail_until:
                fail = True
            elif self._flap_period_s > 0:
                phase = int((now - self._flap_started) / self._flap_period_s)
                fail = phase % 2 == 0  # starts down
            if fail:
                self.injected_errors += 1
            return delay, fail

    def before_call(self, label: str = "") -> None:
        """Apply the schedule to one call: maybe sleep, maybe raise."""
        delay_ms, fail = self._decide()
        if delay_ms > 0:
            time.sleep(delay_ms / 1000.0)
        if fail:
            raise FaultError(f"injected fault{f' ({label})' if label else ''}")

    # -------------------------------------------------------------- wrapping
    def wrap(self, fn: Callable[..., Any], label: str = "") -> Callable[..., Any]:
        """A callable that consults the schedule, then delegates."""

        def wrapped(*args: Any, **kwargs: Any) -> Any:
            self.before_call(label or getattr(fn, "__name__", ""))
            return fn(*args, **kwargs)

        return wrapped

    def wrap_dispatch(self, dispatch: Callable[..., Any]) -> Callable[..., Any]:
        """Wrap a service's ``dispatch`` for use behind ``api.http``: an
        injected error surfaces as the transport's generic 500, exactly
        what a crashing backend looks like to a remote client."""
        return self.wrap(dispatch, label="dispatch")

    def wrap_repo(self, repo: Any) -> Any:
        """Proxy every public method of a repository (or any object)
        through the schedule — for injecting faults below the SPI."""
        injector = self

        class _FaultyRepo:
            def __getattr__(self, name: str) -> Any:
                attr = getattr(repo, name)
                if name.startswith("_") or not callable(attr):
                    return attr
                return injector.wrap(attr, label=name)

            def __repr__(self) -> str:  # pragma: no cover - debugging aid
                return f"FaultyRepo({repo!r})"

        return _FaultyRepo()

    def to_json(self) -> dict:
        with self._lock:
            return {
                "calls": self.calls,
                "injectedErrors": self.injected_errors,
                "injectedDelays": self.injected_delays,
            }
