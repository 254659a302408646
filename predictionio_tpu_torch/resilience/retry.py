"""Retry policy with exponential backoff + full jitter, and deadlines.

Parity rationale: the reference rides on HBase/JDBC client stacks that
retry transient faults internally (HBase's ``hbase.client.retries.number``
defaults to 35 attempts with bounded backoff); our stdlib RPC transport
has no such layer, so the framework provides one. Full jitter follows the
AWS Architecture Blog result ("Exponential Backoff and Jitter"): sleeping
``uniform(0, min(cap, base * 2**attempt))`` avoids the synchronized retry
waves that fixed backoff produces when many clients fail together.

A :class:`Deadline` is an *overall* per-request budget: every attempt's
timeout and every backoff sleep is clamped to the remaining budget, so a
retried call never exceeds what the caller was willing to wait in total.
The ambient deadline propagates via a :mod:`contextvars` scope
(:func:`deadline_scope`) so intermediate layers need no plumbing.

Stdlib-only by contract (tests/test_ci_guards.py) — this package is host
orchestration and must import neither jax nor any framework layer.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import random
import time
from typing import Any, Callable, Iterator

__all__ = [
    "Deadline",
    "DeadlineExceededError",
    "RetryPolicy",
    "current_deadline",
    "deadline_scope",
]


class DeadlineExceededError(Exception):
    """The overall per-request budget ran out (possibly across retries)."""


class Deadline:
    """An absolute point on the monotonic clock by which work must finish."""

    __slots__ = ("_expires_at", "_clock")

    def __init__(self, expires_at: float, clock: Callable[[], float] = time.monotonic):
        self._expires_at = expires_at
        self._clock = clock

    @classmethod
    def after(
        cls, seconds: float, clock: Callable[[], float] = time.monotonic
    ) -> "Deadline":
        return cls(clock() + seconds, clock)

    def remaining(self) -> float:
        """Seconds left; never negative."""
        return max(0.0, self._expires_at - self._clock())

    @property
    def expired(self) -> bool:
        return self._clock() >= self._expires_at

    def clamp(self, timeout: float) -> float:
        """``timeout`` reduced to the remaining budget."""
        return min(timeout, self.remaining())

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining():.3f}s)"


_CURRENT_DEADLINE: contextvars.ContextVar[Deadline | None] = contextvars.ContextVar(
    "pio_resilience_deadline", default=None
)


def current_deadline() -> Deadline | None:
    """The ambient deadline for this thread/context, or None."""
    return _CURRENT_DEADLINE.get()


@contextlib.contextmanager
def deadline_scope(seconds: float) -> Iterator[Deadline]:
    """Run a block under an overall time budget. Nested scopes keep the
    *tighter* deadline — an inner ``deadline_scope(60)`` cannot extend an
    outer 2-second budget."""
    outer = _CURRENT_DEADLINE.get()
    inner = Deadline.after(seconds)
    if outer is not None and outer.remaining() < inner.remaining():
        inner = outer
    token = _CURRENT_DEADLINE.set(inner)
    try:
        yield inner
    finally:
        _CURRENT_DEADLINE.reset(token)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How (and whether) to retry a failed call.

    ``max_attempts=1`` is the do-nothing policy: exactly one attempt, no
    sleeps — byte-for-byte today's single-attempt behavior, guarded by
    ``tests/test_ci_guards.py``. Idempotency is the *caller's* call:
    transports pass ``idempotent=False`` for writes, and those retry only
    when ``retry_writes`` was explicitly set.
    """

    max_attempts: int = 1
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    #: writes are retried only when the operator marked them safe (e.g.
    #: inserts with client-generated ids, idempotent upserts)
    retry_writes: bool = False

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be >= 0")

    def backoff_s(
        self, attempt: int, rng: Callable[[], float] = random.random
    ) -> float:
        """Full-jitter backoff before retry number ``attempt`` (1-based):
        ``uniform(0, min(max_delay, base * 2**(attempt-1)))``."""
        cap = min(self.max_delay_s, self.base_delay_s * (2 ** max(0, attempt - 1)))
        return rng() * cap

    def run(
        self,
        fn: Callable[[], Any],
        *,
        retryable: tuple[type[BaseException], ...] = (Exception,),
        idempotent: bool = True,
        deadline: Deadline | None = None,
        sleep: Callable[[float], None] = time.sleep,
        rng: Callable[[], float] = random.random,
        on_retry: Callable[[int, BaseException], None] | None = None,
    ) -> Any:
        """Call ``fn`` with up to ``max_attempts`` tries.

        Only exceptions in ``retryable`` are retried, and only when the
        call is ``idempotent`` (or ``retry_writes`` is set). The deadline
        budget is consumed across attempts: a backoff sleep is clamped to
        the remaining budget and an exhausted budget re-raises the last
        failure immediately (:class:`DeadlineExceededError` if no attempt
        ran at all).
        """
        may_retry = self.max_attempts > 1 and (idempotent or self.retry_writes)
        attempt = 0
        while True:
            if deadline is not None and deadline.expired:
                raise DeadlineExceededError(
                    f"deadline exhausted before attempt {attempt + 1}"
                )
            attempt += 1
            try:
                return fn()
            except retryable as e:
                if not may_retry or attempt >= self.max_attempts:
                    raise
                delay = self.backoff_s(attempt, rng)
                if deadline is not None:
                    # a backoff that would consume the whole remaining
                    # budget leaves no room for the retry itself — re-raise
                    # the REAL failure now instead of sleeping the budget
                    # away and reporting only "deadline exhausted"
                    remaining = deadline.remaining()
                    if remaining <= 0 or (delay > 0 and delay >= remaining):
                        raise
                    delay = min(delay, remaining)
                if on_retry is not None:
                    on_retry(attempt, e)
                if delay > 0:
                    sleep(delay)
