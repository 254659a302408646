"""Query server — deploy a trained engine instance behind HTTP.

Counterpart of ``predictionio_tpu/workflow/serving.py`` (parity:
``core/workflow/CreateServer.scala``): load the latest COMPLETED
``EngineInstance`` (or the one asked for), re-hydrate its models
(``Engine.prepare_deploy``), answer ``POST /queries.json``, hot-swap on
``POST /reload`` (degraded serving on the last-good model when a reload
fails), status on ``GET /``, stop on ``GET /stop``, plugins, and the
feedback loop that writes each prediction back to an event server as a
``predict`` event. :class:`QueryService` is transport-free: its
:meth:`QueryService.dispatch` runs behind ``api/http.py`` (``pio
deploy``), and the optional micro-batcher, result cache and singleflight
(:mod:`predictionio_tpu_torch.serving`) sit in front of its scoring.

The device thread. Every torch call of the query path runs on one
long-lived thread that the service owns: model loads and reloads, each
algorithm's warm-up, every ``handle_query``, ``handle_batch`` (the
micro-batcher's dispatcher hands each batch to it, so its warm-up runs
every bucket shape there before the server answers) and the release of
a superseded generation. A CUDA thread sets up its context and cuBLAS
handle once, on that thread, and no query of an old generation can still
be running when its tensors are released. The HTTP request threads parse
and encode JSON; they never touch the card.

The device rule. On the card (the context's default) every algorithm
with a ``pin_model_for_serving`` hook serves from tables pinned there
(``workflow/device_state.py``); a pin that fails fails the first load or
degrades a reload, never a quiet move to the host. On the CPU, which the
caller asks for, models serve from host numpy, unless ``--pin-model``
asks for tensors there.

Online learning (``online=``, ``pio deploy --online``): an
:class:`~predictionio_tpu_torch.online.runner.OnlineRunner` follows the
event store's tail and folds fresh events into the live models.
:meth:`QueryService.apply_online_update` swaps the touched rows in on the
device thread, after the generation check and with per-scope cache
invalidation; the runner's and the streaming trainer's torch calls go
through :meth:`QueryService.run_on_device` too. With the option off,
nothing under ``predictionio_tpu_torch.online`` is imported.

Approximate and int8 retrieval (``ann=``, ``pio deploy --ann``;
``CacheConfig(quantize="int8")``, ``pio deploy --quantize int8``): the
tables pin as int8 codes and scales, and an IVF index is built on the
device thread at every load and ``/reload`` (``workflow/device_state.py``);
``/stats.json`` grows its ``quant`` and ``ann`` sections and the cache
keys carry the retrieval mode, so exact, ANN and int8 answers never serve
each other. A build or quantization that fails fails the first load and
degrades a ``/reload``, as a failing pin does.

Experiments and the fleet (``explore=``, ``pio deploy --explore``;
``replica_id=``, set by ``pio deploy --replicas`` on each replica): an
:class:`~predictionio_tpu_torch.experiments.explore.Explorer` re-ranks
``itemScores`` on the device thread before plugins and feedback see the
answer; the router's ``X-PIO-Variant`` header namespaces the cache and
singleflight keys and stamps feedback events; ``POST
/experiments/reward.json`` feeds the explorer's posterior; a replica tags
its answers with ``X-PIO-Replica`` and ``X-PIO-Generation``. With the
options off, nothing under ``predictionio_tpu_torch.experiments`` is
imported and answers carry no fleet headers.

Sharded tables (``CacheConfig(shard_factors=True)``, ``pio deploy
--shard-factors``): each load pins the tables row-sharded over the local
devices (``parallel/sharding.py``; replicated, with a warning, on one
device); ``/stats.json`` ``cache.factorShards`` is the mesh's size and
``GET /`` says ``shardFactors``.

AOT serving (``aot=``, ``pio deploy --aot``, which implies pinning): each
load pins the tables, then loads the generation's compiled serving
programs onto the same device (``workflow/aot.py`` through
``device_state.pin_pairs``) and the templates' pinned paths run them
where they fit, on the device thread like every other torch call of the
query path. A missing, foreign or corrupt artifact set falls back loudly
to the eager pinned path, with the same answers. ``GET /`` says ``aot``;
``/stats.json`` grows an ``aot`` block (tier, loaded, problems, hits,
misses, disabled, and ``serveTimeCompiles``: the compiles of this process
since the last successful load, ``analysis/jit_witness.py``). With the
option off nothing of ``workflow.aot`` or ``torch._inductor`` is
imported.

Differences from the JAX package: ``/profiler/start`` and
``/profiler/stop`` drive ``torch.profiler`` on the device thread and
write a Chrome trace.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import hmac
import json
import logging
import os
import queue
import threading
import time
import urllib.error
import urllib.request
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Any, Callable, Mapping, Sequence

from predictionio_tpu_torch import resilience
from predictionio_tpu_torch.api.http import start_background
from predictionio_tpu_torch.api.service import Response
from predictionio_tpu_torch.controller.components import FirstServing, Serving
from predictionio_tpu_torch.controller.context import WorkflowContext, local_context
from predictionio_tpu_torch.controller.params import params_from_json
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.serving import AnnConfig, BatcherConfig, CacheConfig, MicroBatcher
from predictionio_tpu_torch.serving.cache import (
    CacheStats,
    ResultCache,
    Singleflight,
    canonical_key,
    extract_scope,
    scopes_from_events,
)
from predictionio_tpu_torch.workflow import device_state
from predictionio_tpu_torch.workflow.engine_json import EngineVariant

if TYPE_CHECKING:  # imported only with --online: nothing of it is loaded otherwise
    from predictionio_tpu_torch.online import OnlineConfig

__all__ = [
    "EngineServerPlugin",
    "FeedbackConfig",
    "QueryServer",
    "QueryServerError",
    "QueryService",
    "result_to_json",
]

logger = logging.getLogger(__name__)


class QueryServerError(RuntimeError):
    pass


class EngineServerPlugin:
    """Serving-side plugin (parity: ``core/workflow/EngineServerPlugin.scala``).

    ``plugin_type`` is ``"outputblocker"`` (may rewrite the response) or
    ``"outputsniffer"`` (observes only). ``process`` receives and returns
    the JSON-ready prediction payload.
    """

    plugin_type = "outputsniffer"
    name = "plugin"

    def start(self, service: "QueryService") -> None:  # lifecycle hook
        pass

    def process(self, query: Any, prediction: Any, service: "QueryService") -> Any:
        return prediction


@dataclasses.dataclass(frozen=True)
class FeedbackConfig:
    """Feedback-loop settings (parity: ``--feedback --event-server-*``).

    Feedback is best-effort telemetry: the defaults never let a slow or
    down event server stall or fail a query. ``block_ms`` opts into
    briefly blocking the query thread for a queue slot when the queue is
    full; the breaker settings govern how fast the worker degrades to
    dropping while the event server is unreachable.
    """

    event_server_url: str  # e.g. http://127.0.0.1:7070
    access_key: str
    channel: str | None = None
    #: socket timeout for each feedback POST (the worker thread's)
    timeout_s: float = 5.0
    #: >0: a full feedback queue blocks the query thread up to this long
    #: before dropping; 0 (default) never blocks
    block_ms: float = 0.0
    #: consecutive post failures that open the feedback breaker (0 = off)
    breaker_threshold: int = 0
    breaker_reset_s: float = 5.0


def result_to_json(result: Any) -> Any:
    """The wire form of a prediction (the JAX package's ``_result_to_json``)."""
    if hasattr(result, "to_json"):
        return result.to_json()
    if dataclasses.is_dataclass(result) and not isinstance(result, type):
        return dataclasses.asdict(result)
    return result


def _token_ok(presented: str, expected: str) -> bool:
    return hmac.compare_digest(str(presented), expected)


class QueryService:
    """One deployed engine instance (thread-safe; hot-reloadable)."""

    def __init__(
        self,
        variant: EngineVariant,
        ctx: WorkflowContext | None = None,
        plugins: Sequence[EngineServerPlugin] = (),
        feedback: FeedbackConfig | None = None,
        instance_id: str | None = None,
        batching: BatcherConfig | None = None,
        cache: CacheConfig | None = None,
        ann: AnnConfig | None = None,
        online: OnlineConfig | None = None,
        explore=None,
        replica_id: str | None = None,
        aot=None,
    ):
        self.variant = variant
        #: fleet identity (``pio deploy --replica-id``, set by the fleet
        #: supervisor): reported on /readyz, /stats.json and as the
        #: X-PIO-Replica / X-PIO-Generation headers of query answers.
        #: None (every non-fleet deploy) adds no headers.
        self.replica_id = replica_id
        self.ctx = ctx if ctx is not None else local_context()
        self.plugins = list(plugins)
        self.feedback = feedback
        self._requested_instance_id = instance_id
        self._lock = threading.Lock()
        #: the one thread every torch call of the query path runs on
        self._device = ThreadPoolExecutor(max_workers=1, thread_name_prefix="pio-torch-device")
        self._device_thread = self._device.submit(threading.current_thread).result()
        self.cache_config = cache if cache is not None and cache.enabled else None
        #: ``pio deploy --quantize``'s mode (None: f32 tables)
        self.quantize = self.cache_config.quantize if self.cache_config is not None else None
        #: ``pio deploy --shard-factors``: tables row-sharded over the mesh
        self.shard_factors = self.cache_config is not None and self.cache_config.shard_factors
        #: ``pio deploy --aot`` (a ``workflow.aot.AotConfig``); None or a
        #: disabled config imports nothing of it. Each load boots the
        #: generation's compiled programs, and the compile counter proves
        #: the request path compiles nothing after it.
        self.aot_config = aot if aot is not None and aot.active else None
        self._serve_compiles = None
        if self.aot_config is not None:
            from predictionio_tpu_torch.analysis.jit_witness import ServeCompileCounter

            self._serve_compiles = ServeCompileCounter.install()
        #: pin on the card always; on the CPU only when --pin-model,
        #: --shard-factors, --quantize or --aot asks
        self._pin = self.ctx.device.type == "cuda" or self.aot_config is not None or (
            self.cache_config is not None
            and (self.cache_config.pin_model or self.shard_factors or self.quantize is not None)
        )
        #: approximate retrieval (``pio deploy --ann``); None or a disabled
        #: config keeps every query on the exact path and imports nothing
        #: of ops/ivf. Set before the first load, which builds the index.
        self.ann_config = ann if ann is not None and ann.enabled else None
        #: retrieval-mode tag of every cache and singleflight key, so exact,
        #: ANN and int8 answers never serve each other
        self._cache_mode = self.ann_config.cache_mode if self.ann_config is not None else "exact"
        if self.quantize:
            self._cache_mode = f"{self._cache_mode}+q{self.quantize}"
        #: exploration (``pio deploy --explore``); None or a disabled
        #: config imports nothing of the experiments package. The policy
        #: joins the cache-mode tag, so re-ranked and greedy answers never
        #: serve each other.
        self.explore_config = explore if explore is not None and explore.enabled else None
        #: the live Explorer, on the service's device (public: the online
        #: runner feeds polled reward events into its posterior)
        self.explorer = None
        if self.explore_config is not None:
            from predictionio_tpu_torch.experiments.explore import Explorer

            self.explorer = Explorer(self.explore_config, self.ctx.device)
            self._cache_mode = f"{self._cache_mode}+x{self.explore_config.policy}"
        #: the serving generation's IVF runtimes (``/stats.json`` ``ann``)
        self._ann_runtimes: list = []
        self._cache_stats: CacheStats | None = None
        self._result_cache: ResultCache | None = None
        self._singleflight: Singleflight | None = None
        #: increments on every successful reload; keys the singleflight
        #: namespace and is reported on /stats.json
        self._model_generation = 0
        if self.cache_config is not None:
            self._cache_stats = CacheStats()
            if self.cache_config.result_cache:
                self._result_cache = ResultCache(self.cache_config, self._cache_stats)
            if self.cache_config.coalesce:
                self._singleflight = Singleflight(self._cache_stats)
        self._serving = None
        self._algo_model_pairs: list = []
        self.instance = None
        #: where the first algorithm serves from (``GET /`` reports it)
        self.device = str(self.ctx.device)
        self.start_time = _dt.datetime.now(_dt.timezone.utc)
        self.query_count = 0
        self.feedback_dropped = 0
        self.feedback_sent = 0
        self.feedback_failed = 0
        # graceful degradation: a failed /reload keeps serving the
        # last-good model and flags it here
        self.degraded = False
        self.last_reload_error: str | None = None
        self.last_reload_at: _dt.datetime | None = None
        #: set by the transport (console deploy): called by ``GET /stop``
        self.stop_server: Callable[[], None] | None = None
        #: when set, ``GET /stop`` requires this token
        self.stop_token: str | None = None
        #: callbacks run first by :meth:`close` (and so by a drain), e.g.
        #: the endpoint-registry withdraw of ``pio deploy --announce-dir``
        self.on_close: list = []
        self._profiler = None
        self._feedback_queue: "queue.Queue | None" = None
        self._feedback_breaker = None
        if feedback is not None:
            self._feedback_queue = queue.Queue(maxsize=10_000)
            if feedback.breaker_threshold > 0:
                self._feedback_breaker = resilience.CircuitBreaker(
                    failure_threshold=feedback.breaker_threshold,
                    reset_timeout_s=feedback.breaker_reset_s,
                    name="feedback",
                )
                resilience.register_stats("feedback", self._feedback_breaker)
            threading.Thread(target=self._feedback_worker, name="pio-torch-feedback", daemon=True).start()
        #: online learning (an ``OnlineConfig``); None or a disabled
        #: config starts no follower and imports nothing of it
        self.online_config = online if online is not None and online.enabled else None
        self.online = None
        #: applied partial updates — the freshness counter beside the
        #: (full-reload) generation
        self._online_updates = 0
        self.reload()
        if self.online_config is not None:
            from predictionio_tpu_torch.online.runner import OnlineRunner

            try:
                self.online = OnlineRunner(self, self.online_config)
            except BaseException:
                self._device.shutdown(wait=False)
                raise
        # created after the first load, so its warm-up runs every bucket
        # through the loaded models (on the device thread, via handle_batch)
        self.batcher: MicroBatcher | None = (
            MicroBatcher(self.handle_batch, batching) if batching is not None else None
        )
        for p in self.plugins:
            p.start(self)

    # -------------------------------------------------------- device thread
    def run_on_device(self, fn: Callable, *args: Any) -> Any:
        """``fn(*args)`` on the device thread, the one that serves every
        query (directly when already on it)."""
        if threading.current_thread() is self._device_thread:
            return fn(*args)
        return self._device.submit(fn, *args).result()

    # ------------------------------------------------------------ feedback
    def _feedback_worker(self) -> None:
        assert self._feedback_queue is not None and self.feedback is not None
        timeout_s = self.feedback.timeout_s
        breaker = self._feedback_breaker
        while True:
            url, event = self._feedback_queue.get()
            try:
                if breaker is not None and not breaker.acquire():
                    # event server known-down: drop instantly rather than
                    # paying a full connect timeout per queued event
                    with self._lock:
                        self.feedback_dropped += 1
                    continue
                try:
                    req = urllib.request.Request(
                        url,
                        data=json.dumps(event, default=str).encode(),
                        headers={"Content-Type": "application/json"},
                        method="POST",
                    )
                    urllib.request.urlopen(req, timeout=timeout_s).read()
                except Exception as e:
                    if breaker is not None:
                        # a 4xx proves the event server is up: only
                        # transport-level failures may open the breaker
                        if isinstance(e, urllib.error.HTTPError) and e.code < 500:
                            breaker.record_success()
                        else:
                            breaker.record_failure()
                    with self._lock:
                        self.feedback_failed += 1
                    logger.warning("Feedback POST failed: %s", e)
                else:
                    if breaker is not None:
                        breaker.record_success()
                    with self._lock:
                        self.feedback_sent += 1
            finally:
                self._feedback_queue.task_done()

    def _send_feedback(
        self, query_body: Any, payload: Any, pr_id: str | None, variant: str | None = None
    ) -> None:
        """Async POST of the prediction as a ``predict`` event (parity: the
        feedback loop in CreateServer). The ``eventId`` derives from the
        prediction id, so a redelivered event is a duplicate to the store.
        The A/B ``variant`` and the exploration policy ride in the
        properties, so reward joins are exact; the ``eventId`` stays
        ``pio_fb_<prId>``, stamped or not."""
        fb = self.feedback
        assert fb is not None and self._feedback_queue is not None
        properties: dict = {"query": query_body, "prediction": payload}
        if variant is not None:
            properties["variant"] = variant
        explore_config = getattr(self, "explore_config", None)
        if explore_config is not None:
            properties["policy"] = explore_config.policy
        event = {
            "eventId": f"pio_fb_{pr_id}",
            "event": "predict",
            "entityType": "pio_pr",
            "entityId": pr_id or "",
            "properties": properties,
            "prId": pr_id,
            "eventTime": _dt.datetime.now(_dt.timezone.utc).isoformat(),
        }
        url = f"{fb.event_server_url.rstrip('/')}/events.json?accessKey={fb.access_key}"
        if fb.channel:
            url += f"&channel={fb.channel}"
        try:
            if fb.block_ms > 0:
                self._feedback_queue.put((url, event), timeout=fb.block_ms / 1000.0)
            else:
                self._feedback_queue.put_nowait((url, event))
        except queue.Full:
            # best-effort: never stall the query path, but count the loss
            with self._lock:
                self.feedback_dropped += 1
            logger.warning("Feedback queue full; dropping prediction event")

    # ---------------------------------------------------------------- load
    def _resolve_instance(self):
        repo = Storage.get_meta_data_engine_instances()
        if self._requested_instance_id:
            inst = repo.get(self._requested_instance_id)
            if inst is None:
                raise QueryServerError(f"Engine instance '{self._requested_instance_id}' not found")
            return inst
        inst = repo.get_latest_completed(self.variant.id, self.variant.version, self.variant.id)
        if inst is None:
            raise QueryServerError(
                f"No COMPLETED training of engine '{self.variant.id}' "
                f"(version '{self.variant.version}') found — run `pio train` first"
            )
        return inst

    def reload(self) -> None:
        """(Re)hydrate engine + models — the ``/reload`` hot swap (parity:
        MasterActor re-running prepareDeploy), on the device thread.

        Once a model is serving, a failed reload (storage outage, missing
        blob, a pin that fails) never wedges the service: the last-good
        model keeps serving, ``GET /`` reports ``degraded`` with the
        error, the result cache is flushed, and the raised
        :class:`QueryServerError` says so. The first load raises: with
        nothing loaded there is nothing to degrade to."""
        self.run_on_device(self._reload_now)

    def _reload_now(self) -> None:
        try:
            instance = self._resolve_instance()
            engine = self.variant.build_engine()
            engine_params = engine.params_from_json(
                {
                    "datasource": {"params": json.loads(instance.datasource_params or "{}")},
                    "preparator": {"params": json.loads(instance.preparator_params or "{}")},
                    "algorithms": json.loads(instance.algorithms_params or "[]"),
                    "serving": {"params": json.loads(instance.serving_params or "{}")},
                }
                if instance.algorithms_params
                else self.variant.raw
            )
            blob = Storage.get_model_data_models().get(instance.id)
            if blob is None:
                raise QueryServerError(f"No model blob for instance '{instance.id}'")
            # the sharded and int8 tiers build their tables from the blob's
            # host arrays: no replicated f32 pin on the card before them
            tiered = self._pin and (self.shard_factors or self.quantize is not None)
            serving, pairs = engine.prepare_deploy(
                self.ctx, engine_params, instance.id, blob.models, prepare=not tiered
            )
            if self._pin:
                pairs, bytes_pinned = device_state.pin_pairs(
                    pairs, shard=self.shard_factors, quantize=self.quantize, prepared=not tiered,
                    aot=self.aot_config, instance_id=instance.id,
                )
                if self._cache_stats is not None:
                    self._cache_stats.set_gauge("bytes_pinned", bytes_pinned)
                    self._cache_stats.set_gauge("bytes_by_dtype", device_state.bytes_by_dtype(pairs))
                    if self.shard_factors:
                        self._cache_stats.set_gauge("factor_shards", device_state.shard_count(pairs))
            if self.ann_config is not None:
                # the IVF index of this generation, built here on the
                # device thread; it hot-swaps with the pairs
                pairs, _infos = device_state.build_ann_pairs(pairs, self.ann_config)
        except Exception as e:
            with self._lock:
                has_last_good = self._serving is not None
                if has_last_good:
                    self.degraded = True
                    self.last_reload_error = str(e)[:500]
                    self.last_reload_at = _dt.datetime.now(_dt.timezone.utc)
                    last_good = self.instance.id if self.instance else None
            if not has_last_good:
                raise
            # the failed reload proves newer training exists, so cached
            # results may be stale even though the model is not
            if self._result_cache is not None:
                self._result_cache.invalidate_all()
            logger.warning("Reload failed; still serving last-good instance %s: %s", last_good, e)
            raise QueryServerError(
                f"Reload failed (still serving last-good instance '{last_good}'): {e}"
            ) from e
        with self._lock:
            old_pairs = self._algo_model_pairs
            self._serving = serving
            self._algo_model_pairs = pairs
            self._ann_runtimes = [rt for _, model in pairs if (rt := getattr(model, "_pio_ann", None)) is not None]
            self.instance = instance
            self.device = str(getattr(pairs[0][0], "device", self.ctx.device)) if pairs else self.device
            self.degraded = False
            self.last_reload_error = None
            self.last_reload_at = _dt.datetime.now(_dt.timezone.utc)
            self._model_generation += 1
            generation = self._model_generation
        if self._cache_stats is not None:
            self._cache_stats.set_gauge("model_generation", generation)
        if self._result_cache is not None and generation > 1:
            # a new generation never serves the old generation's results
            self._result_cache.invalidate_all()
        if (self._pin or self.ann_config is not None) and old_pairs and old_pairs is not pairs:
            # on the device thread: no query of the old generation runs
            # now, and none can start on it, so its tables and index go
            # at once
            device_state.release_pairs(old_pairs)
        if self._serve_compiles is not None:
            # every compile so far was boot work; from here on, serve-time
            self._serve_compiles.mark_boot_complete()
        logger.info("Loaded engine instance %s (generation %d) on %s", instance.id, generation, self.device)

    # --------------------------------------------------------------- query
    @staticmethod
    def _bind_query(body: Any, pairs: Sequence) -> Any:
        """The body as the first algorithm's query class; an algorithm
        without one takes the body as it is."""
        query_class = getattr(pairs[0][0], "query_class", None)
        if query_class is None:
            return body
        if not isinstance(body, Mapping):
            raise ValueError("the query body must be a JSON object")
        return params_from_json(query_class, body)

    def handle_query(self, body: Any, variant: str | None = None) -> tuple[int, Any]:
        """supplement -> each algorithm's predict -> serve -> explore ->
        plugins -> feedback, on the device thread."""
        return self.run_on_device(self._handle_query, body, variant)

    def _handle_query(self, body: Any, variant: str | None = None) -> tuple[int, Any]:
        # snapshot under the lock so a query is internally consistent
        # across a concurrent /reload
        with self._lock:
            serving = self._serving
            pairs = list(self._algo_model_pairs)
        if serving is None:
            return 503, {"message": "No engine loaded"}
        if body is None:
            return 400, {"message": "Query body is required (JSON)."}
        try:
            query = self._bind_query(body, pairs)
        except Exception as e:
            return 400, {"message": f"Invalid query: {e}"}
        query = serving.supplement_base(query)
        predictions = [algo.predict_base(model, query) for algo, model in pairs]
        return self._finish_query(serving, body, query, predictions, variant)

    def _finish_query(
        self, serving, body: Any, query: Any, predictions: Sequence[Any], variant: str | None = None
    ) -> tuple[int, Any]:
        """serve -> explore -> plugins -> feedback -> count, shared by the
        single and batch routes so they cannot diverge."""
        payload = result_to_json(serving.serve_base(query, predictions))
        pr_id = None
        if self.feedback is not None:
            pr_id = uuid.uuid4().hex
            if isinstance(payload, dict):
                payload = dict(payload, prId=pr_id)
        if self.explorer is not None and isinstance(payload, dict):
            # the policy's re-rank between scoring and the plugins:
            # plugins and feedback see the order actually served
            items = payload.get("itemScores")
            if isinstance(items, list) and items:
                payload = dict(payload, itemScores=self.explorer.rerank(items))
        for plugin in self.plugins:
            if plugin.plugin_type == "outputblocker":
                payload = plugin.process(query, payload, self)
            else:
                plugin.process(query, payload, self)
        if self.feedback is not None:
            self._send_feedback(body, payload, pr_id, variant)
        with self._lock:
            self.query_count += 1
        return 200, payload

    # ------------------------------------------------------- cached queries
    def _scored_query(self, body: Any, variant: str | None = None) -> tuple[int, Any]:
        """The uncached scoring path: the micro-batcher when one is
        configured, else the per-request path. The micro-batched path
        drops the variant tag (a batch mixes variants; its feedback
        events carry no variant field), as in the JAX package."""
        if self.batcher is not None:
            return self.batcher.submit(body)
        if variant is None:  # the exact call of a deploy without experiments
            return self.handle_query(body)
        return self.handle_query(body, variant)

    def handle_query_cached(self, body: Any, variant: str | None = None) -> tuple[int, Any]:
        """/queries.json with the cache tiers applied: result-LRU lookup,
        then singleflight on a miss, then the winning computation's 200
        committed back unless an invalidation won the race. Uncacheable
        bodies bypass every tier; non-200 results are never cached but do
        coalesce."""
        if self._result_cache is None and self._singleflight is None:
            return self._scored_query(body, variant)  # pin-model-only config
        key = canonical_key(body)
        if key is None:
            self._cache_stats.incr("uncacheable")
            return self._scored_query(body, variant)
        key = f"{self._cache_mode}|{key}"
        if variant is not None:
            # the router's X-PIO-Variant tag namespaces the result cache
            # and the singleflight (its key embeds this one); a variant
            # name cannot hold the "|" separator (experiments.split)
            key = f"v={variant}|{key}"
        rc = self._result_cache
        scope = extract_scope(body, self.cache_config.scope_field)
        if rc is not None:
            hit, value = rc.get(key)
            if hit:
                return value

        def compute() -> tuple[int, Any]:
            token = rc.reserve(key, scope) if rc is not None else None
            result = self._scored_query(body, variant)
            if rc is not None and result[0] == 200:
                rc.commit(token, result)
            return result

        if self._singleflight is not None:
            # generation-keyed: a flight straddling a /reload never feeds
            # followers a previous generation's result
            flight_key = f"{self._model_generation}:{key}"
            try:
                value, _led = self._singleflight.do(flight_key, compute)
            except TimeoutError as e:
                return 500, {"message": str(e)}
            return value
        return compute()

    def cache_note_write(self, scopes: Sequence[str] | None = None, flush_all: bool = False) -> dict:
        """Event-driven invalidation: a write about ``scopes`` (user ids)
        makes their cached results stale now; ``flush_all`` drops
        everything (what ``/reload`` does on a generation swap)."""
        if self._result_cache is None:
            return {"invalidated": 0, "flushed": False}
        if flush_all:
            self._result_cache.invalidate_all()
            return {"invalidated": 0, "flushed": True}
        count = 0
        for scope in scopes or ():
            if isinstance(scope, str) and scope:
                self._result_cache.invalidate_scope(scope)
                count += 1
        return {"invalidated": count, "flushed": False}

    # ------------------------------------------------------ online fold-in
    def snapshot_pairs(self) -> tuple[list, int]:
        """Consistent (pairs, model generation) snapshot — what the online
        runner computes updates against; the generation token comes back
        through :meth:`apply_online_update`, so updates computed against a
        superseded generation are dropped."""
        with self._lock:
            return list(self._algo_model_pairs), self._model_generation

    def apply_online_update(self, updates: Sequence[tuple[int, Any]], generation: int | None = None) -> dict:
        """The partial-update hot swap beside ``/reload``: swap ONLY the
        touched factor rows of the live models.

        ``updates`` is ``[(pair index, OnlineUpdate), ...]``; each pair's
        algorithm applies its own update (its ``apply_online_update``
        hook: row swaps, cold-start id injection). ``generation`` (from
        :meth:`snapshot_pairs`) guards against a concurrent ``/reload``:
        rows solved against superseded factors are dropped.

        Runs on the device thread, as reloads and queries do: the
        generation check and the hooks run with no query and no reload in
        between. Cache contract: unlike ``/reload`` (a full flush), a
        partial update bumps only the touched scopes, so unrelated cached
        entries survive a fold-in."""
        return self.run_on_device(self._apply_online_update, list(updates), generation)

    def _apply_online_update(self, updates: list, generation: int | None) -> dict:
        with self._lock:
            if generation is not None and generation != self._model_generation:
                return {"applied": False, "reason": "superseded generation"}
            pairs = list(self._algo_model_pairs)
        infos: list[dict] = []
        scopes: set[str] = set()
        try:
            for pair_idx, upd in updates:
                if upd is None or getattr(upd, "empty", True) or not 0 <= pair_idx < len(pairs):
                    continue
                algo, model = pairs[pair_idx]
                hook = getattr(algo, "apply_online_update", None)
                if hook is None:
                    continue
                # scopes BEFORE the hook: if it raises mid-swap, the
                # touched users' cached results may already reflect a
                # partial swap and must die with it
                scopes.update(upd.touched_scopes())
                infos.append(hook(model, upd))
        finally:
            if infos:
                with self._lock:
                    self._online_updates += 1
            if scopes:
                # per-scope, never a full flush
                self.cache_note_write(sorted(scopes))
        return {"applied": bool(infos), "infos": infos, "scopes": len(scopes)}

    def handle_batch(self, bodies: Sequence[Any], n_real: int | None = None) -> list[tuple[int, Any]]:
        """Batch-amortized :meth:`handle_query` (ref
        ``core/workflow/BatchPredict.scala``), on the device thread: bind
        + supplement each query, push them all through each algorithm's
        ``batch_predict_base`` (one chunked product), then the shared
        per-query tail. A malformed query gets its own 400, a query whose
        predict/serve raises its own 500 (the batched call falls back to
        per-query predict if it raises); the batch never aborts.

        ``n_real``: slots >= ``n_real`` are the micro-batcher's bucket
        padding — scored with the rest (the bucket's shape is their
        purpose) but with no serve tail, no side effects and no count;
        they answer ``(200, None)``."""
        return self.run_on_device(self._handle_batch, bodies, n_real)

    def _handle_batch(self, bodies: Sequence[Any], n_real: int | None) -> list[tuple[int, Any]]:
        with self._lock:
            serving = self._serving
            pairs = list(self._algo_model_pairs)
        if serving is None:
            return [(503, {"message": "No engine loaded"})] * len(bodies)
        out: list[tuple[int, Any] | None] = [None] * len(bodies)
        queries: list[tuple[int, Any]] = []
        for i, body in enumerate(bodies):
            if body is None:
                out[i] = (400, {"message": "Query body is required (JSON)."})
                continue
            try:
                query = self._bind_query(body, pairs)
            except Exception as e:
                out[i] = (400, {"message": f"Invalid query: {e}"})
                continue
            try:
                query = serving.supplement_base(query)
            except Exception as e:
                out[i] = (500, {"message": str(e)})
                continue
            queries.append((i, query))
        by_slot: dict[int, list[Any]] = {i: [] for i, _ in queries}
        if queries:
            try:
                for algo, model in pairs:
                    for i, pred in algo.batch_predict_base(model, queries):
                        by_slot[i].append(pred)
            except Exception:
                # one poisoned query must not fail the chunk: redo it per
                # query so only the offender gets a 500
                logger.exception("batch_predict failed; falling back to per-query predict")
                by_slot = {}
                for i, q in queries:
                    try:
                        by_slot[i] = [algo.predict_base(model, q) for algo, model in pairs]
                    except Exception as e:
                        out[i] = (500, {"message": str(e)})
        limit = len(bodies) if n_real is None else n_real
        for i, query in queries:
            if out[i] is not None:  # the per-query fallback already failed it
                continue
            if i >= limit:  # padding slot: no serve tail, no side effects
                out[i] = (200, None)
                continue
            try:
                out[i] = self._finish_query(serving, bodies[i], query, by_slot[i])
            except Exception as e:
                out[i] = (500, {"message": str(e)})
        return [o if o is not None else (500, {"message": "unprocessed"}) for o in out]

    def handle_batch_jsonlines(self, bodies: Sequence[Any]) -> list[str | None] | None:
        """Bulk-file fast path: JSON payload strings straight from the
        algorithm's vectorized scorer. Only taken where it is the same as
        :meth:`handle_batch`: one algorithm, stock :class:`FirstServing`
        with the default supplement, no plugins, no feedback, and the
        algorithm has ``batch_predict_json``. None when a condition
        fails; a None entry marks a body for :meth:`handle_batch`."""
        return self.run_on_device(self._handle_batch_jsonlines, bodies)

    def _handle_batch_jsonlines(self, bodies: Sequence[Any]) -> list[str | None] | None:
        with self._lock:
            serving = self._serving
            pairs = list(self._algo_model_pairs)
        if (
            serving is None
            or len(pairs) != 1
            or type(serving) is not FirstServing
            or type(serving).supplement is not Serving.supplement
            or self.plugins
            or self.feedback is not None
            or not hasattr(pairs[0][0], "batch_predict_json")
        ):
            return None
        algo, model = pairs[0]
        try:
            lines = algo.batch_predict_json(model, bodies)
        except Exception:
            # handle_batch has per-query isolation: route everything there
            logger.exception("batch_predict_json failed; falling back to handle_batch")
            return None
        with self._lock:
            self.query_count += sum(1 for line in lines if line is not None)
        return lines

    @property
    def model_generation(self) -> int:
        """Per-process reload counter (1 after the first load)."""
        with self._lock:
            return self._model_generation

    # -------------------------------------------------------------- status
    def status_json(self) -> dict:
        inst = self.instance
        return {
            "status": "alive",
            "replicaId": self.replica_id,
            "generation": self.model_generation,
            "engineId": self.variant.id,
            "engineVersion": self.variant.version,
            "engineFactory": self.variant.engine_factory,
            "engineInstanceId": inst.id if inst else None,
            "startTime": self.start_time.isoformat(),
            "queryCount": self.query_count,
            "feedbackDropped": self.feedback_dropped,
            "batching": self.batcher is not None,
            "caching": self.cache_config is not None,
            "shardFactors": self.shard_factors,
            "quantize": self.quantize,
            "bytesPinnedByDtype": (
                self._cache_stats.to_json()["bytesByDtype"] if self._cache_stats is not None else {}
            ),
            "ann": self.ann_config is not None,
            "aot": self.aot_config is not None,
            "online": self.online is not None,
            "explore": self.explore_config.policy if self.explore_config is not None else None,
            "degraded": self.degraded,
            "lastReloadError": self.last_reload_error,
            "lastReloadAt": self.last_reload_at.isoformat() if self.last_reload_at else None,
            "plugins": [{"name": p.name, "type": p.plugin_type} for p in self.plugins],
            "device": self.device,
        }

    def stats_json(self) -> dict:
        """``GET /stats.json``: query counters plus, when on, the
        micro-batcher's gauges and latency decomposition and the cache's."""
        with self._lock:
            count = self.query_count
            feedback_counts = {
                "sent": self.feedback_sent,
                "failed": self.feedback_failed,
                "dropped": self.feedback_dropped,
            }
            degraded = self.degraded
            generation = self._model_generation
        out: dict = {
            "queryCount": count,
            "replicaId": self.replica_id,
            "generation": generation,
            "startTime": self.start_time.isoformat(),
            "batching": self.batcher is not None,
            "degraded": degraded,
            "resilience": resilience.stats_snapshot(),
        }
        if self.feedback is not None:
            out["feedback"] = feedback_counts
        if self.batcher is not None:
            out["batcher"] = self.batcher.stats.to_json()
        if self._cache_stats is not None:
            out["cache"] = self._cache_stats.to_json()
        if self.explorer is not None:
            # queries and explored counts, the cumulative model-score
            # regret, the reward events fed to the posterior
            out["explore"] = self.explorer.stats_json()
        if self.online is not None:
            # freshness: events folded, fold latency, watermark lag, and
            # the measured event->reflected-in-recs latency
            with self._lock:
                applied = self._online_updates
            out["online"] = dict(self.online.stats_json(), updatesApplied=applied)
        if self.quantize is not None:
            # dtype, the byte ledger against f32, the measured
            # quantization error and the rescore depth the over-fetch paid
            with self._lock:
                q_pairs = list(self._algo_model_pairs)
            out["quant"] = {
                "dtype": self.quantize,
                "models": [rt.stats_json() for _, model in q_pairs if (rt := getattr(model, "_pio_quant", None)) is not None],
            }
        if self.aot_config is not None:
            # which tier the load landed on (1: the compiled programs, 2/3:
            # the eager fallback), program hits and misses, and the
            # compiles since the load, which the --aot contract keeps at 0
            with self._lock:
                a_pairs = list(self._algo_model_pairs)
            block = device_state.aot_stats(a_pairs) or {"tier": None, "loaded": 0}
            block["serveTimeCompiles"] = self._serve_compiles.serve_time_compiles()
            out["aot"] = block
        if self.ann_config is not None:
            # the effective nlist/nprobe and, per index, the clusters
            # scored and the share of the catalog each query paid for
            with self._lock:
                runtimes = list(self._ann_runtimes)
            out["ann"] = {
                # nlist 0 means auto (~sqrt(catalog)): report what the build picked
                "nlist": self.ann_config.nlist or (runtimes[0].index.nlist if runtimes else 0),
                "nprobe": self.ann_config.nprobe,
                "cacheMode": self._cache_mode,
                "models": [rt.stats_json() for rt in runtimes],
            }
        return out

    def readiness(self) -> dict:
        """``GET /readyz``: storage reachable, a model loaded, and — with
        batching — the dispatcher alive. ``degraded`` is reported but does
        not fail readiness: the server still answers queries."""
        from predictionio_tpu_torch.api.health import readiness_report, storage_check

        with self._lock:
            model_ok = self._serving is not None
            degraded = self.degraded
            generation = self._model_generation
        batcher_ok = self.batcher is None or self.batcher.dispatcher_alive()
        report = readiness_report(
            storage=storage_check(),
            model_loaded={"ok": model_ok},
            batcher={"ok": batcher_ok},
        )
        report["degraded"] = degraded
        report["replicaId"] = self.replica_id
        report["generation"] = generation
        return report

    def close(self) -> None:
        """Run the ``on_close`` callbacks (the endpoint-registry withdraw
        of ``--announce-dir``, so a draining replica leaves the ring
        before its listener closes), stop the online follower and trainer
        threads, release the batcher's dispatcher (queued requests get a
        503), then the device thread. Safe to call more than once."""
        callbacks, self.on_close = self.on_close, []
        for cb in callbacks:
            try:
                cb()
            except Exception as e:  # closing must never fail the drain
                logger.warning("on_close callback failed: %s", e)
        if self.online is not None:
            self.online.stop()
            self.online = None
        if self.batcher is not None:
            self.batcher.close()
        self._device.shutdown(wait=True)

    def drain(self) -> None:
        """Graceful-shutdown hook, found by the HTTP wrapper
        (``api/lifecycle.py``): runs after in-flight requests completed."""
        self.close()

    # ------------------------------------------------------------ profiler
    def _profiler_start(self, log_dir: str) -> None:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.ctx.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with self._lock:
            if self._profiler is not None:
                raise RuntimeError("Profiler already running")
            prof = torch.profiler.profile(activities=activities)
            self._profiler = (prof, log_dir)
        prof.start()

    def _profiler_stop(self) -> str:
        with self._lock:
            if self._profiler is None:
                raise RuntimeError("Profiler is not running")
            prof, log_dir = self._profiler
            self._profiler = None
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"pio-trace-{int(time.time() * 1000)}.json")
        prof.export_chrome_trace(path)
        return path

    # ------------------------------------------------------------ dispatch
    def _tag_replica(self, resp: Response) -> Response:
        """A fleet replica's answer carries which replica and model
        generation served it, so the router keeps one cache key on one
        generation; outside a fleet the answer is untouched."""
        if self.replica_id is None:
            return resp
        tags = {"X-PIO-Replica": self.replica_id, "X-PIO-Generation": str(self.model_generation)}
        return dataclasses.replace(resp, headers={**(resp.headers or {}), **tags})

    def dispatch(
        self,
        method: str,
        path: str,
        params: Mapping[str, str],
        body: Any = None,
        headers: Mapping[str, str] | None = None,
        form: Mapping[str, str] | None = None,
    ) -> Response:
        method = method.upper()
        if path == "/" and method == "GET":
            return Response(200, self.status_json())
        if path == "/queries.json" and method == "POST":
            # the fleet router tags routed queries with the A/B variant it
            # assigned; no header (every non-experiment deploy) is None
            variant = None
            if headers:
                variant = next((v for k, v in headers.items() if k.lower() == "x-pio-variant"), None) or None
            if self.cache_config is not None:
                status, payload = self.handle_query_cached(body, variant)
            elif self.batcher is not None:
                status, payload = self.batcher.submit(body)
            else:
                answer = self.handle_query(body) if variant is None else self.handle_query(body, variant)
                return self._tag_replica(Response(*answer))
            # admission control: tell clients when to come back
            if status in (429, 503) and isinstance(payload, Mapping) and "retryAfterSeconds" in payload:
                return self._tag_replica(
                    Response(status, payload, headers={"Retry-After": str(payload["retryAfterSeconds"])})
                )
            return self._tag_replica(Response(status, payload))
        if path == "/cache/invalidate.json" and method == "POST":
            # {"entityId": "u1"} / {"entityIds": [...]} / {"all": true} /
            # a list of event-server-shaped bodies
            if self._result_cache is None:
                return Response(
                    404,
                    {"message": "No result cache on this deployment "
                                "(enable with pio deploy --result-cache)."},
                )
            scopes: list = []
            flush_all = False
            if isinstance(body, Mapping):
                flush_all = bool(body.get("all"))
                if isinstance(body.get("entityId"), str):
                    scopes.append(body["entityId"])
                ids = body.get("entityIds")
                if isinstance(ids, list):
                    scopes.extend(i for i in ids if isinstance(i, str))
            elif isinstance(body, list):
                scopes.extend(sorted(scopes_from_events(body)))
            return Response(200, self.cache_note_write(scopes, flush_all))
        if path == "/stats.json" and method == "GET":
            return Response(200, self.stats_json())
        if path == "/online/fold.json" and method == "POST":
            # the partial-update entry point beside /reload: poll the tail
            # and fold whatever landed, synchronously (the daemon keeps
            # its own cadence)
            if self.online is None:
                return Response(
                    404,
                    {"message": "Online learning is off on this deployment "
                                "(enable with pio deploy --online)."},
                )
            try:
                return Response(200, self.online.fold_now())
            except Exception as e:
                return Response(500, {"message": str(e)[:300]})
        if path == "/experiments/reward.json" and method == "POST":
            # the explorer's reward entry when online learning is off (with
            # --online the follower feeds reward events); one event-server
            # shaped event or a list of them
            if self.explorer is None:
                return Response(
                    404,
                    {"message": "Exploration is off on this deployment "
                                "(enable with pio deploy --explore)."},
                )
            events = body if isinstance(body, list) else [body] if isinstance(body, Mapping) else []
            matched = self.explorer.note_reward_events(events)
            return Response(200, {"matched": matched, "explore": self.explorer.stats_json()})
        if path == "/reload" and method == "POST":
            try:
                self.reload()
                return Response(200, {"message": "Reloaded"})
            except QueryServerError as e:
                # degraded, not dead: the last-good model still serves
                if self.degraded:
                    return Response(
                        503, {"message": str(e), "degraded": True}, headers={"Retry-After": "5"}
                    )
                return Response(500, {"message": str(e)})
        if path == "/stop" and method == "GET":
            # the token travels in the X-PIO-Stop-Token header (or ?token=)
            presented = ""
            if headers:
                presented = next(
                    (v for k, v in headers.items() if k.lower() == "x-pio-stop-token"), ""
                )
            presented = presented or params.get("token", "")
            if self.stop_token and not _token_ok(presented, self.stop_token):
                return Response(403, {"message": "Missing or invalid stop token."})
            if self.stop_server is None:
                return Response(501, {"message": "This deployment has no stop hook."})
            self.stop_server()
            return Response(200, {"message": "Shutting down."})
        if path == "/profiler/start" and method == "POST":
            log_dir = (body or {}).get("logDir") if isinstance(body, Mapping) else None
            log_dir = log_dir or os.path.join(Storage.base_dir(), "profile")
            try:
                self.run_on_device(self._profiler_start, log_dir)
            except RuntimeError as e:
                return Response(409, {"message": str(e)})
            return Response(200, {"message": "Profiler started", "logDir": log_dir})
        if path == "/profiler/stop" and method == "POST":
            try:
                trace = self.run_on_device(self._profiler_stop)
            except RuntimeError as e:
                return Response(409, {"message": str(e)})
            return Response(200, {"message": "Profiler stopped", "trace": trace})
        return Response(404, {"message": "Not Found"})


class QueryServer:
    """A :class:`QueryService` behind ``api/http.py`` on a background
    thread (``start_background``), for in-process callers: ``with
    QueryServer(service) as server: ... server.url``."""

    def __init__(self, service: QueryService, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self._host = host
        self._port = port
        self._httpd = None
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    @property
    def url(self) -> str:
        return f"http://{self._httpd.server_address[0]}:{self.port}"

    def start(self) -> "QueryServer":
        self._httpd, self._thread = start_background(self.service.dispatch, self._host, self._port)
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10.0)

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
