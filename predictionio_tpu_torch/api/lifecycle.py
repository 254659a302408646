"""Graceful server lifecycle: signal-driven drain and shutdown.

Parity rationale: the reference rides on spray-can/akka's coordinated
shutdown — ``Http.Unbind`` stops the listener while in-flight routes
complete. Our stdlib ``ThreadingHTTPServer`` has no such phase: a
SIGTERM (the *normal* way k8s, systemd, and every operator stops a
server) killed the process mid-request, dropping whatever the handler
threads were doing. This module closes that gap for every framework
server behind ``api/http.py``:

1. the first SIGTERM/SIGINT flips ``/readyz`` to 503 (load balancers
   stop routing here) and starts a **drain**: no new work is accepted —
   late arrivals get ``503`` + ``Retry-After`` — while requests already
   in flight run to completion;
2. when the server is idle (or the configured drain deadline expires),
   the drain hooks run — the query server closes its micro-batcher, the
   process flushes/closes storage — and the listener shuts down; the
   process then exits **0** through the normal ``serve()`` return;
3. a second SIGTERM (``TERM TERM``) force-quits immediately with a
   non-zero exit code — the operator's escape hatch when a drain hangs.

Everything here is **opt-in**: servers started without
``--drain-deadline-s`` get no DrainManager and keep the historical
immediate-exit behavior byte for byte (guarded by
``tests/test_ci_guards.py``).

Stdlib-only by contract (piolint manifest): drain must work on any
server with no storage, numpy, or accelerator imports.
"""

from __future__ import annotations

import itertools
import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Iterable

__all__ = ["DrainManager"]

logger = logging.getLogger(__name__)


class DrainManager:
    """Tracks in-flight requests and orchestrates a bounded drain.

    The HTTP wrapper consults :meth:`try_begin_request` /
    :meth:`end_request` around every dispatched request;
    :meth:`begin_drain` (normally fired by the installed SIGTERM/SIGINT
    handler) stops admission, waits for in-flight work under
    ``drain_deadline_s``, runs the registered drain hooks (batcher
    close, storage flush), and shuts the attached server down.
    """

    def __init__(
        self,
        drain_deadline_s: float,
        *,
        on_drain: Iterable[Callable[[], Any]] = (),
        force_exit_code: int = 1,
        exit_fn: Callable[[int], Any] = os._exit,
        clock: Callable[[], float] = time.monotonic,
    ):
        if drain_deadline_s <= 0:
            raise ValueError("drain_deadline_s must be > 0 (omit the "
                             "manager entirely for immediate-exit behavior)")
        self.drain_deadline_s = drain_deadline_s
        self.force_exit_code = force_exit_code
        self._exit_fn = exit_fn
        self._clock = clock
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight = 0
        self._draining = False
        self._drain_started_at: float | None = None
        #: signal-safe counter: handlers run on the main thread and can
        #: NEST (a second signal interrupts the first handler between
        #: bytecodes), so taking the non-reentrant lock there could
        #: deadlock the force-quit path; count() increments atomically
        self._signal_counter = itertools.count(1)
        self._rejected_during_drain = 0
        self._on_drain: list[Callable[[], Any]] = list(on_drain)
        self._server: Any = None
        self._drain_thread: threading.Thread | None = None

    # ------------------------------------------------------------- wiring
    def attach_server(self, server: Any) -> None:
        """Hand over the bound listener; its ``shutdown()`` ends the
        serve-forever loop once the drain completes."""
        with self._lock:
            self._server = server

    def add_drain_hook(self, hook: Callable[[], Any], first: bool = False) -> None:
        """Run ``hook`` after in-flight requests finished and before the
        listener stops (e.g. batcher close, storage flush). Hooks run in
        registration order; each is exception-isolated. ``first`` puts
        the hook ahead of already-registered ones — the HTTP wrapper uses
        it so a service's own ``drain`` (batcher close) runs before the
        process-level storage flush."""
        with self._lock:
            if first:
                self._on_drain.insert(0, hook)
            else:
                self._on_drain.append(hook)

    def install_signals(
        self, signums: Iterable[int] = (signal.SIGTERM, signal.SIGINT)
    ) -> None:
        """Register the drain handler (main thread only, like any signal
        handler). First signal drains; second force-quits."""
        for signum in signums:
            signal.signal(signum, self._handle_signal)

    def _handle_signal(self, signum: int, frame: Any) -> None:
        nth = next(self._signal_counter)
        if nth == 1:
            logger.warning(
                "signal %d: draining (deadline %.1fs) — send again to force-quit",
                signum, self.drain_deadline_s,
            )
            self.begin_drain(reason=f"signal {signum}")
        else:
            logger.warning("signal %d again: force-quitting", signum)
            self._exit_fn(self.force_exit_code)

    # ------------------------------------------------- per-request tracking
    @property
    def draining(self) -> bool:
        return self._draining

    def try_begin_request(self) -> bool:
        """Admit one request: False (reject with 503 + Retry-After) once
        draining, else count it in flight."""
        with self._lock:
            if self._draining:
                self._rejected_during_drain += 1
                return False
            self._inflight += 1
            return True

    def end_request(self) -> None:
        # _idle shares _lock, so holding the lock satisfies the
        # Condition's notify precondition
        with self._lock:
            self._inflight -= 1
            if self._inflight <= 0:
                self._idle.notify_all()

    def retry_after_s(self) -> int:
        """``Retry-After`` hint on drain rejections: the remaining drain
        window (after it, a restarted replica — or another one behind the
        balancer — takes the traffic)."""
        with self._lock:
            if self._drain_started_at is None:
                return max(1, int(self.drain_deadline_s))
            elapsed = self._clock() - self._drain_started_at
        return max(1, int(self.drain_deadline_s - elapsed) + 1)

    # ------------------------------------------------------------- draining
    def begin_drain(self, reason: str = "requested") -> threading.Thread | None:
        """Flip to draining and run the drain sequence on a helper thread
        (the signal handler interrupts ``serve_forever`` on the main
        thread, so calling ``server.shutdown()`` there would deadlock).
        Idempotent: only the first call starts the sequence."""
        with self._lock:
            if self._draining:
                return self._drain_thread
            self._draining = True
            self._drain_started_at = self._clock()
            thread = threading.Thread(
                target=self._run_drain, name="pio-drain", args=(reason,),
                daemon=True,
            )
            self._drain_thread = thread
        thread.start()
        return thread

    def wait_for_idle(self, timeout_s: float) -> bool:
        """Block until no request is in flight; False on timeout."""
        deadline = self._clock() + timeout_s
        with self._idle:
            while self._inflight > 0:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return False
                self._idle.wait(timeout=min(remaining, 0.5))
        return True

    def _run_drain(self, reason: str) -> None:
        logger.info(
            "drain started (%s): refusing new requests, %d in flight",
            reason, self._inflight,
        )
        if not self.wait_for_idle(self.drain_deadline_s):
            logger.warning(
                "drain deadline %.1fs expired with %d request(s) still in "
                "flight — shutting down anyway",
                self.drain_deadline_s, self._inflight,
            )
        for hook in list(self._on_drain):
            try:
                hook()
            except Exception:
                logger.exception("drain hook %r failed", hook)
        with self._lock:
            server = self._server
        if server is not None:
            # unblocks serve_forever; serve() then closes the socket and
            # returns, so the process exits 0 through the normal path
            server.shutdown()

    # -------------------------------------------------------- observability
    def to_json(self) -> dict:
        with self._lock:
            return {
                "draining": self._draining,
                "inFlight": self._inflight,
                "rejectedDuringDrain": self._rejected_during_drain,
                "drainDeadlineSeconds": self.drain_deadline_s,
            }
