"""Dynamic cross-request micro-batcher for the online query path.

Counterpart of ``predictionio_tpu/serving/batcher.py`` (a copy with the
port's imports). Requests from independent HTTP handler threads enqueue
into a bounded queue with a per-request completion event; one dispatcher
thread drains up to ``max_batch_size`` requests or waits
``max_batch_delay_ms`` past the oldest request (whichever comes first),
pads the batch up to a small set of **bucket sizes**, routes it through
``QueryService.handle_batch`` (per-item error isolation) and resolves
each waiting request with its own ``(status, payload)``. On the card a
bucket is one score-product shape: warm-up runs each once, so the first
live batch of a bucket finds its cuBLAS algorithm chosen and its memory
in the caching allocator.

Admission control is explicit: when the queue is full the configured
policy either rejects immediately (HTTP 429 + ``Retry-After``) or
blocks the caller up to ``block_timeout_ms`` (503 on timeout). Queue
depth, in-flight batch state, bucket hit/miss counts and a per-request
latency decomposition (queue wait / batch-form / handle time) are
recorded in :class:`predictionio_tpu_torch.api.stats.ServingStats` and
served from the query server's ``GET /stats.json``.

This module imports neither torch nor jax: batching is host-side
orchestration, and the device work stays behind ``handle_batch``.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import queue
import threading
import time
from typing import Any, Callable, Sequence

from predictionio_tpu_torch.api.stats import ServingStats

__all__ = ["AdmissionPolicy", "BatcherConfig", "MicroBatcher"]

logger = logging.getLogger(__name__)

#: a submit() whose dispatcher never answers (a bug, not a slow model)
#: must not hang the HTTP handler thread forever
_RESULT_TIMEOUT_S = 300.0


class AdmissionPolicy(str, enum.Enum):
    """What a full queue does to a new request."""

    REJECT = "reject"  # immediate 429 + Retry-After
    BLOCK = "block"  # wait up to block_timeout_ms for a slot, then 503


def _pow2_buckets(max_batch_size: int) -> tuple[int, ...]:
    """1, 2, 4, ... capped at (and always including) ``max_batch_size``."""
    sizes = [1]
    while sizes[-1] * 2 < max_batch_size:
        sizes.append(sizes[-1] * 2)
    if sizes[-1] != max_batch_size:
        sizes.append(max_batch_size)
    return tuple(sizes)


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    """Knobs of the micro-batcher (CLI: ``pio deploy --batching ...``).

    ``max_batch_delay_ms=0`` is a legal configuration: a lone request
    dispatches immediately (no added latency) and batching still happens
    opportunistically whenever multiple requests are already queued.
    """

    max_batch_size: int = 32
    #: how long the dispatcher waits past the OLDEST queued request for
    #: batchmates; the p99 latency a request can gain over the
    #: per-request path is bounded by ~2x this (one wait while queued +
    #: one batch in flight ahead of it)
    max_batch_delay_ms: float = 2.0
    #: bounded admission queue; full -> the admission policy applies
    max_queue: int = 256
    admission: AdmissionPolicy = AdmissionPolicy.REJECT
    #: BLOCK policy only: how long submit() may wait for a queue slot
    block_timeout_ms: float = 1000.0
    #: batch sizes jit programs are padded to; () = powers of two up to
    #: ``max_batch_size``. Every dispatched batch is padded UP to the
    #: smallest bucket >= its size, so after warm-up no new predict
    #: shapes (hence no recompiles) occur.
    buckets: tuple[int, ...] = ()
    #: sample query body used to pre-compile every bucket at startup
    #: (None = skip warm-up; the first live batch of each bucket pays
    #: the compile instead)
    warmup_body: Any = None

    def __post_init__(self) -> None:
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.max_batch_delay_ms < 0:
            raise ValueError("max_batch_delay_ms must be >= 0")
        # accept plain strings from CLI/JSON configs
        object.__setattr__(
            self, "admission", AdmissionPolicy(self.admission)
        )
        if self.buckets:
            raw = sorted(set(int(x) for x in self.buckets))
            if raw[0] < 1:
                raise ValueError("bucket sizes must be >= 1")
            # buckets beyond max_batch_size can never be filled — they
            # would only inflate padding (and compile a dead shape)
            b = tuple(x for x in raw if x <= self.max_batch_size)
            if not b or b[-1] < self.max_batch_size:
                # the largest bucket must fit a full batch or padding
                # would have to truncate
                b = b + (self.max_batch_size,)
            object.__setattr__(self, "buckets", b)

    def bucket_sizes(self) -> tuple[int, ...]:
        return self.buckets or _pow2_buckets(self.max_batch_size)


class _Pending:
    __slots__ = ("body", "enqueued_at", "done", "result", "drained")

    def __init__(self, body: Any):
        self.body = body
        self.enqueued_at = time.monotonic()
        self.done = threading.Event()
        self.result: tuple[int, Any] | None = None
        #: answered by a dead-queue drain (shutdown / dead dispatcher),
        #: not by a dispatched batch — kept out of the latency stats
        self.drained = False


class MicroBatcher:
    """Coalesces concurrent ``submit()`` calls into ``handle_batch`` calls.

    ``handle_batch`` is any ``Sequence[body] -> list[(status, payload)]``
    aligned with its input — in production,
    :meth:`QueryService.handle_batch`, which already provides per-item
    error isolation (one poisoned query gets its own 4xx/5xx; its
    batchmates still get answers).
    """

    def __init__(
        self,
        handle_batch: Callable[[Sequence[Any]], list[tuple[int, Any]]],
        config: BatcherConfig | None = None,
        stats: ServingStats | None = None,
    ):
        self.config = config or BatcherConfig()
        self.stats = stats or ServingStats()
        self._handle = handle_batch
        # handlers that understand padding (QueryService.handle_batch)
        # get told how many leading slots are real, so filler queries pay
        # only predict compute — no serve tail, plugins, feedback, or
        # query-count side effects
        try:
            import inspect

            self._wants_n_real = (
                "n_real" in inspect.signature(handle_batch).parameters
            )
        except (TypeError, ValueError):
            self._wants_n_real = False
        self._buckets = self.config.bucket_sizes()
        self._queue: "queue.Queue[_Pending | None]" = queue.Queue(
            maxsize=self.config.max_queue
        )
        # guards writes to _closed (shared with submit() on HTTP handler
        # threads; piolint PIO201 keeps every post-__init__ write under
        # it). Readers stay lock-free on purpose: the submit/close race
        # is resolved by submit()'s post-enqueue re-check plus the
        # idempotent _drain_dead_queue(), not by mutual exclusion
        self._lock = threading.Lock()
        self._closed = False
        if self.config.warmup_body is not None:
            self.warmup(self.config.warmup_body)
        self._thread = threading.Thread(
            target=self._loop, name="pio-microbatcher", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------ client API
    def submit(self, body: Any) -> tuple[int, Any]:
        """Enqueue one query and block until its slice of a batch result
        is available. Returns ``(status, payload)`` exactly like
        ``QueryService.handle_query``."""
        cfg = self.config
        if self._closed:
            return 503, {"message": "Serving runtime is shut down."}
        if not self._thread.is_alive():
            # a dead dispatcher (a bug — the loop is defensive) must fail
            # fast with a clean 503, not park the HTTP thread for the
            # full result timeout; /readyz turns unready via
            # dispatcher_alive() so orchestrators restart the pod
            self.stats.record_rejected()
            return 503, {
                "message": "Serving runtime dispatcher is not running.",
                "retryAfterSeconds": self.retry_after_seconds(),
            }
        pending = _Pending(body)
        try:
            if cfg.admission is AdmissionPolicy.REJECT:
                self._queue.put_nowait(pending)
            else:
                self._queue.put(pending, timeout=cfg.block_timeout_ms / 1000.0)
        except queue.Full:
            retry_after = self.retry_after_seconds()
            if cfg.admission is AdmissionPolicy.REJECT:
                self.stats.record_rejected()
                return 429, {
                    "message": "Server busy: batching queue is full.",
                    "retryAfterSeconds": retry_after,
                }
            self.stats.record_block_timeout()
            return 503, {
                "message": "Server busy: no queue slot within "
                f"{cfg.block_timeout_ms:g} ms.",
                "retryAfterSeconds": retry_after,
            }
        self.stats.record_submitted(self._queue.qsize())
        if self._closed:
            # raced with close(): the dispatcher may already be past its
            # final drain, so this request could sit in a dead queue —
            # answer everything still enqueued ourselves (idempotent with
            # close()'s own post-join drain; done.set() is at-most-once
            # effective)
            self._drain_dead_queue()
        give_up_at = time.monotonic() + _RESULT_TIMEOUT_S
        while not pending.done.wait(timeout=1.0):
            if not self._thread.is_alive():
                # the dispatcher died while this request was queued:
                # answer every stranded request (ours included) instead
                # of letting them sit out the full result timeout
                self._drain_dead_queue(
                    "Serving runtime dispatcher died; request not processed."
                )
                if pending.done.is_set():
                    break
                # in-flight when the dispatcher died (not in the queue):
                # manufacture the same 503, and count it like every other
                # rejected response so /stats.json stays truthful during
                # the incident
                self.stats.record_rejected()
                return 503, {
                    "message": (
                        "Serving runtime dispatcher died; request not processed."
                    ),
                    "retryAfterSeconds": self.retry_after_seconds(),
                }
            if time.monotonic() >= give_up_at:
                return 500, {"message": "Batch dispatcher did not respond."}
        assert pending.result is not None
        if pending.drained:
            # a shutdown/dead-dispatcher 503, not a served request: keep
            # it out of the latency decomposition an operator reads
            # during exactly this kind of incident
            self.stats.record_rejected()
        else:
            self.stats.record_request(
                total_ms=(time.monotonic() - pending.enqueued_at) * 1e3
            )
        return pending.result

    def retry_after_seconds(self) -> int:
        """Backoff hint for admission-control responses (the 429
        ``Retry-After`` header / ``retryAfterSeconds`` field): worst-case
        time for a full queue to drain, using the MEASURED per-batch
        handle time — the batch-forming delay alone would claim ~1 s
        while a slow model really needs many."""
        cfg = self.config
        waves = -(-cfg.max_queue // cfg.max_batch_size)
        per_wave_ms = cfg.max_batch_delay_ms + self.stats.handle_p50_ms()
        return max(1, -(-int(waves * per_wave_ms) // 1000))

    def warmup(self, body: Any) -> None:
        """Pre-compile every bucket shape with ``body`` replicated, largest
        first (jit caches often make smaller related shapes cheaper after
        the big one). Warm-up traffic flows through the REAL batch path so
        the exact programs live traffic will hit are the ones compiled."""
        for size in sorted(self._buckets, reverse=True):
            t0 = time.monotonic()
            try:
                # n_real=0: every slot is padding — full predict compile,
                # zero serve-tail side effects (no plugin/feedback/count)
                self._call([body] * size, n_real=0)
            except Exception:
                # a bad warm-up body must not kill deploy; the bucket
                # simply compiles on first live traffic instead
                logger.exception("micro-batcher warm-up failed at size %d", size)
                continue
            self.stats.record_warmup(size, (time.monotonic() - t0) * 1e3)

    def dispatcher_alive(self) -> bool:
        """Is the dispatcher thread able to answer submissions? Feeds the
        query server's ``/readyz`` readiness probe."""
        return not self._closed and self._thread.is_alive()

    def close(self) -> None:
        """Stop the dispatcher. Requests already being drained are
        answered normally; anything still queued (or racing in) gets 503."""
        with self._lock:
            self._closed = True
        self._queue.put(None)  # wake the dispatcher even when idle
        self._thread.join(timeout=5.0)
        # a submit() that passed its _closed check concurrently with this
        # close may have enqueued after the dispatcher's final drain
        self._drain_dead_queue()

    def _drain_dead_queue(
        self, message: str = "Serving runtime is shut down."
    ) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item.drained = True
                item.result = (503, {"message": message})
                item.done.set()

    # ------------------------------------------------------------ dispatcher
    def _call(self, bodies: Sequence[Any], n_real: int) -> list[tuple[int, Any]]:
        if self._wants_n_real:
            return self._handle(bodies, n_real=n_real)
        return self._handle(bodies)

    def _bucket_for(self, n: int) -> int:
        for size in self._buckets:
            if size >= n:
                return size
        return self._buckets[-1]

    def _drain(self, first: _Pending) -> list[_Pending]:
        """Collect up to ``max_batch_size`` requests, waiting at most
        ``max_batch_delay_ms`` past the arrival of ``first``."""
        cfg = self.config
        batch = [first]
        deadline = first.enqueued_at + cfg.max_batch_delay_ms / 1000.0
        while len(batch) < cfg.max_batch_size:
            remaining = deadline - time.monotonic()
            try:
                if remaining <= 0:
                    # deadline passed: take whatever is already queued,
                    # but never wait for more
                    item = self._queue.get_nowait()
                else:
                    item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:  # close() sentinel
                break
            batch.append(item)
        return batch

    def _loop(self) -> None:
        while True:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._closed:
                    break
                continue
            if first is None:
                if self._closed:
                    break
                continue
            batch = self._drain(first)
            self._dispatch(batch)
        # drain leftovers so no client hangs on shutdown
        self._drain_dead_queue()

    def _dispatch(self, batch: list[_Pending]) -> None:
        formed_at = time.monotonic()
        for p in batch:
            self.stats.record_queue_wait((formed_at - p.enqueued_at) * 1e3)
        bodies = [p.body for p in batch]
        bucket = self._bucket_for(len(bodies))
        # pad with a copy of the first body: identical query class and
        # shape guarantees, results beyond len(bodies) are discarded
        padded = bodies + [bodies[0]] * (bucket - len(bodies))
        self.stats.record_batch_start(self._queue.qsize())
        called_at = time.monotonic()
        try:
            results = self._call(padded, n_real=len(bodies))
            if len(results) < len(bodies):  # defensive: misaligned handler
                raise RuntimeError(
                    f"handle_batch returned {len(results)} results "
                    f"for {len(padded)} queries"
                )
        except Exception:
            # handle_batch isolates per-item errors itself; reaching this
            # means the batch MACHINERY failed — answer everyone rather
            # than hanging the HTTP threads. Generic message: exception
            # text can leak internals (details go to the log)
            logger.exception("micro-batch dispatch failed")
            results = [
                (500, {"message": "Batch dispatch failed; see server log."})
            ] * len(bodies)
        finished_at = time.monotonic()
        self.stats.record_batch(
            size=len(bodies),
            bucket=bucket,
            form_ms=(called_at - formed_at) * 1e3,
            handle_ms=(finished_at - called_at) * 1e3,
        )
        for p, result in zip(batch, results):
            p.result = result
            p.done.set()
