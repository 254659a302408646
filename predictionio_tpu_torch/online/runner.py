"""Online-learning orchestration — the ``pio deploy --online`` daemon.

Counterpart of ``predictionio_tpu/online/runner.py``. One background
thread closes the loop:

    event store tail --> per-entity deltas --> fold-in / streaming SGD
        --> QueryService.apply_online_update (touched rows only)
        --> watermark commit

Per poll: the durable :class:`~predictionio_tpu_torch.online.follower
.TailFollower` returns everything appended since the watermark; deltas
are dispatched to each deployed algorithm's online hooks (fold-in for
matrix-factorization models, the :class:`~predictionio_tpu_torch.online
.trainer.StreamingTrainer` for towers); the computed rows hot-swap into
serving after the generation check with per-scope cache invalidation;
only then does the watermark commit — a crash re-delivers (and
re-solves, idempotently) rather than skips.

A full ``/reload`` supersedes everything here: the runner detects the
generation bump, rebinds to the fresh pairs, and drops in-flight updates
computed against the old generation; a superseded or failed batch rolls
the watermark back, so its events fold against the new generation.

A partitioned event store gets one follower per partition: their polls
run concurrently, each partition's deltas fold in a worker of its own,
and a partition whose fold fails or is superseded rolls back its own
poll advance while the others commit.

The host work of a cycle (polling, the deltas, the hooks' histories and
systems) runs on the follower and fold-worker threads; every torch call
goes through the query server's ``run_on_device``, which is the one
thread that serves queries (``workflow/serving.py``), so queries queue
behind a fold's chunk there. Difference from the JAX package: the
partitions' hook calls take turns (``_hook_lock``), since the hooks'
online histories are plain dicts that every partition's items share.
With ``--explore``, the same polled batch feeds the explorer's posterior
(:meth:`~predictionio_tpu_torch.experiments.explore.Explorer.note_reward_events`).
"""

from __future__ import annotations

import json
import logging
import threading
import time

from predictionio_tpu_torch.online.follower import TailFollower, to_deltas
from predictionio_tpu_torch.online.types import OnlineConfig

__all__ = ["OnlineRunner"]

logger = logging.getLogger(__name__)

#: fold-latency / freshness sample ring size for /stats.json percentiles
_SAMPLES = 256


def _each(items: list, fn, name: str) -> list:
    """``[fn(x) for x in items]``, one thread an item when there are
    several (a partition's poll or fold each)."""
    if len(items) == 1:
        return [fn(items[0])]
    out: list = [None] * len(items)

    def _one(i: int) -> None:
        out[i] = fn(items[i])

    threads = [threading.Thread(target=_one, args=(i,), name=f"{name}-p{i}", daemon=True) for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _percentile(samples: list[float], q: float) -> float | None:
    if not samples:
        return None
    s = sorted(samples)
    return s[min(len(s) - 1, int(q * len(s)))]


class OnlineRunner:
    """Owns the follower thread and the per-pair streaming trainers for
    one deployed :class:`~predictionio_tpu_torch.workflow.serving.QueryService`."""

    def __init__(self, service, config: OnlineConfig):
        self.service = service
        self.config = config
        ds_params: dict = {}
        inst = service.instance
        if inst is not None and getattr(inst, "datasource_params", None):
            try:
                ds_params = json.loads(inst.datasource_params) or {}
            except ValueError:
                ds_params = {}
        if not ds_params:
            # fall back to the variant's raw engine.json
            ds_params = (service.variant.raw.get("datasource") or {}).get("params") or {}
        self.ds_params = ds_params
        app_name = ds_params.get("appName") or ds_params.get("app_name") or ""
        if not app_name:
            raise ValueError(
                "--online requires the engine's datasource params to name an appName (the stream to follow)"
            )
        # one follower per event-store partition, each with its own
        # durable cursor; a plain store gets the single partition=None
        # follower with the single-stream cursor file name
        from predictionio_tpu_torch.data.storage import Storage

        pe = Storage.get_p_events()
        part_count = int(getattr(getattr(pe, "_e", None), "partition_count", 0) or getattr(pe, "partition_count", 0) or 1)
        self.followers: list[TailFollower] = [
            TailFollower(
                app_name,
                channel=ds_params.get("channelName"),
                state_dir=config.state_dir,
                from_start=config.from_start,
                partition=p,
            )
            for p in ([None] if part_count <= 1 else range(part_count))
        ]
        self.follower: TailFollower = self.followers[0]
        self._lock = threading.Lock()
        #: one partition's hook call at a time (the online histories are
        #: shared dicts); their torch calls queue on the device thread
        self._hook_lock = threading.Lock()
        #: serializes whole fold cycles: the daemon cadence and a manual
        #: POST /online/fold.json must not interleave poll/apply/commit
        self._cycle_lock = threading.Lock()
        self.folds = 0
        self.events_seen = 0
        self.events_folded = 0
        self.last_error: str | None = None
        self._fold_ms: list[float] = []
        self._visible_s: list[float] = []
        self._bound_generation = -1
        self._trainers: dict[int, object] = {}
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="pio-online-follower")
        self._thread.start()

    # -------------------------------------------------------------- control
    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5.0)
        with self._lock:
            trainers = list(self._trainers.values())
            self._trainers = {}
        for t in trainers:
            t.stop()

    def fold_now(self, timeout_s: float = 30.0) -> dict:
        """Synchronous poll+fold — the ``POST /online/fold.json`` manual
        trigger. Runs one cycle on the caller's thread; the daemon keeps
        its own cadence. A deadline abort rolls the watermark back
        (``requeued: true``) — the daemon drains the backlog next."""
        return self._cycle(deadline=time.monotonic() + timeout_s)

    # ----------------------------------------------------------------- loop
    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._cycle()
            except Exception as e:  # keep following; surface on /stats.json
                with self._lock:
                    self.last_error = str(e)[:300]
                logger.exception("online fold cycle failed; continuing")
            self._wake.wait(self.config.interval_s)
            self._wake.clear()

    def _algo_enabled(self, algo) -> bool:
        allow = self.config.algorithms
        if not allow:
            return True
        name = type(algo).__name__.lower()
        return any(tok and tok.lower() in name for tok in allow)

    def _rebind(self, pairs, generation: int) -> None:
        """(Re)build per-pair streaming trainers when the model generation
        moved (a /reload swapped the models out from under the previous
        binding)."""
        with self._lock:
            if generation == self._bound_generation:
                return
            stale = list(self._trainers.values())
            self._trainers = {}
            self._bound_generation = generation
        for t in stale:
            t.stop()
        from predictionio_tpu_torch.online.trainer import StreamingTrainer

        for pi, (algo, model) in enumerate(pairs):
            spec_fn = getattr(algo, "online_trainer_spec", None)
            if spec_fn is None or not self._algo_enabled(algo):
                continue
            spec = spec_fn(model)
            if not spec:
                continue
            cfg = self.config

            def apply(update, _pi=pi, _gen=generation):
                res = self.service.apply_online_update([(_pi, update)], generation=_gen)
                if res.get("applied"):
                    # the trainer applies asynchronously, outside the fold
                    # cycle: freshness for streamed updates is recorded
                    # here, stamped with the batch's newest event time
                    self._record_visible(int(update.info.get("newestUs") or 0))
                return res

            trainer = StreamingTrainer(
                model,
                apply,
                batch_size=cfg.trainer_batch,
                lr=spec.get("learning_rate", cfg.trainer_lr),
                temperature=spec.get("temperature", 0.1),
                seed=int(spec.get("seed", 0)),
                device=spec.get("device"),
                run=self.service.run_on_device,
            )
            with self._lock:
                # stop() may have drained _trainers while this cycle was
                # mid-rebind: registering now would leak a live thread
                # past close(), so stop it instead (outside the lock)
                doomed = trainer if self._stop.is_set() else None
                if doomed is None:
                    self._trainers[pi] = trainer
            if doomed is not None:
                doomed.stop()

    def _record_visible(self, newest_us: int) -> None:
        """One event->serving-visible latency sample: the wall-clock gap
        between a batch's newest event and its hot swap completing."""
        if not newest_us:
            return
        with self._lock:
            self._visible_s.append(max(0.0, time.time() - newest_us / 1e6))
            del self._visible_s[:-_SAMPLES]

    def _cycle(self, deadline: float | None = None) -> dict:
        with self._cycle_lock:
            try:
                # piolint: waive=PIO211 -- the cycle lock exists to serialize fold cycles end to end; the watermark fsync MUST land before the next poll, and no request path ever contends on this lock
                return self._cycle_locked(deadline)
            except Exception:
                # the watermark must never advance past a batch that
                # failed mid-fold: drop the pending cursors so the next
                # cycle re-delivers the whole batch
                for f in self.followers:
                    f.rollback()
                raise

    def _fold_batches(self, pairs, generation: int, deltas, deadline: float | None) -> tuple[bool, int, str | None]:
        """Fold one follower's polled deltas in config-sized batches.
        Returns ``(applied_any, folded, aborted_reason)``. Runs
        concurrently for different partitions: ``apply_online_update``
        checks the generation on the device thread, and the hook calls
        take turns."""
        svc = self.service
        applied_any = False
        folded = 0
        aborted: str | None = None
        batch = self.config.batch_size
        for lo in range(0, len(deltas), batch):
            if deadline is not None and time.monotonic() > deadline:
                aborted = "deadline"
                break
            chunk = deltas[lo : lo + batch]
            t0 = time.perf_counter()
            updates = []
            for pi, (algo, model) in enumerate(pairs):
                if not self._algo_enabled(algo):
                    continue
                with self._lock:
                    trainer = self._trainers.get(pi)
                if trainer is not None:
                    names = self.ds_params.get("eventNames") or ("view", "rate", "buy", "like")
                    trainer.submit(
                        [(d.user, d.item) for d in chunk if d.item is not None and d.event in names],
                        newest_us=max((d.t_us for d in chunk), default=0),
                    )
                    continue
                hook = getattr(algo, "online_foldin", None)
                if hook is None:
                    continue
                with self._hook_lock:
                    upd = hook(model, chunk, self.ds_params, self.config, run=svc.run_on_device)
                if upd is not None and not upd.empty:
                    updates.append((pi, upd))
            if updates:
                res = svc.apply_online_update(updates, generation=generation)
                if not res.get("applied") and res.get("reason"):
                    # a concurrent /reload superseded the generation the
                    # rows were solved against
                    aborted = str(res["reason"])
                    break
                applied_any = applied_any or res.get("applied", False)
            folded += len(chunk)
            with self._lock:
                self._fold_ms.append((time.perf_counter() - t0) * 1e3)
                del self._fold_ms[:-_SAMPLES]
        return applied_any, folded, aborted

    def _cycle_locked(self, deadline: float | None = None) -> dict:
        svc = self.service
        pairs, generation = svc.snapshot_pairs()
        self._rebind(pairs, generation)
        followers = self.followers
        if len(followers) == 1:
            # on this thread, under the cycle lock, called by name (as the
            # reference does) so the static lock graph sees the follower's
            # and the store's locks taken under it: _each's callable hides
            # the call from the graph
            polled = [followers[0].poll()]
        else:
            # concurrent polls: each partition's delta read is independent I/O
            polled = _each(followers, lambda f: f.poll(), "pio-online-poll")
        # a poll that raised in its thread delivers nothing this cycle
        polled = [p if p is not None else [] for p in polled]
        total = sum(len(ev) for ev in polled)
        if not total:
            return {"events": 0, "applied": False}
        # exploration reward fold-back: reward events are telemetry for
        # the bandit, not ratings, so they ride beside the fold pipeline
        # (which ignores non-rating events) rather than in it
        explorer = getattr(svc, "explorer", None)
        if explorer is not None:
            try:
                for ev in polled:
                    if ev:
                        explorer.note_reward_events(ev)
            except Exception:
                logger.exception("explorer reward fold-back failed")
        all_deltas = [to_deltas(ev) for ev in polled]
        newest_us = max((d.t_us for ds in all_deltas for d in ds), default=0)
        failures: list[BaseException] = []

        def _fold(deltas) -> tuple[bool, int, str | None]:
            if not deltas:
                return False, 0, None
            try:
                return self._fold_batches(pairs, generation, deltas, deadline)
            except BaseException as e:
                # a partition whose fold died rolls back below and the
                # exception re-raises after the healthy partitions have
                # committed
                logger.exception("fold failed; requeueing partition batch")
                failures.append(e)
                return False, 0, f"error: {str(e)[:200]}"

        # one fold worker per partition follower
        outcomes = _each(all_deltas, _fold, "pio-online-fold")
        applied_any = False
        folded = 0
        committed_events = 0
        requeued = 0
        reason: str | None = None
        for f, ev, (applied, n, aborted) in zip(followers, polled, outcomes):
            applied_any = applied_any or applied
            folded += n
            if aborted is not None:
                # the watermark must never advance past events that were
                # not applied: drop THIS partition's poll advance so its
                # next cycle re-delivers the batch (fold-in re-solves
                # idempotently; the trainer's drop-oldest queue absorbs a
                # repeated chunk). Other partitions commit normally.
                f.rollback()
                requeued += 1
                reason = reason or aborted
            else:
                f.commit()
                committed_events += len(ev)
        if committed_events or not requeued:
            with self._lock:
                self.folds += 1
                self.events_seen += committed_events
                self.events_folded += folded
                self.last_error = None
        if applied_any and not requeued:
            # wall-clock event->serving-visible latency: the batch's
            # newest event was just swapped into the live model
            self._record_visible(newest_us)
        if failures:
            # the failed partitions were rolled back above and the healthy
            # ones committed, so re-delivery is scoped to what failed
            raise failures[0]
        out = {"events": total, "applied": applied_any}
        if requeued:
            out["requeued"] = True
            out["reason"] = reason
        return out

    # ---------------------------------------------------------------- stats
    def stats_json(self) -> dict:
        with self._lock:
            fold_ms = list(self._fold_ms)
            visible = list(self._visible_s)
            trainers = {str(pi): t.stats_json() for pi, t in self._trainers.items()}
            out = {
                "folds": self.folds,
                "eventsSeen": self.events_seen,
                "eventsFolded": self.events_folded,
                "intervalSeconds": self.config.interval_s,
                "lastError": self.last_error,
            }
        out["foldMs"] = {
            "p50": _percentile(fold_ms, 0.50),
            "p95": _percentile(fold_ms, 0.95),
            "last": fold_ms[-1] if fold_ms else None,
        }
        # measured event->reflected-in-recs latency (newest event of each
        # applied batch to its hot swap completing)
        out["eventToVisibleSeconds"] = {
            "p50": _percentile(visible, 0.50),
            "p95": _percentile(visible, 0.95),
            "last": visible[-1] if visible else None,
        }
        out["watermark"] = self.follower.lag()
        if len(self.followers) > 1:
            out["watermarks"] = [f.lag() for f in self.followers]
        if trainers:
            out["trainers"] = trainers
        return out
