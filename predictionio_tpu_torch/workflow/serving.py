"""Query server — deploy a trained engine instance behind HTTP.

Counterpart of the query half of ``predictionio_tpu/workflow/serving.py``
(parity: ``core/workflow/CreateServer.scala``).

* :class:`QueryService` is one deployed engine instance. It loads the
  latest COMPLETED ``EngineInstance`` of an engine variant (or the one
  asked for), re-hydrates its models through ``Engine.prepare_deploy`` on
  the context's device, and answers a query by supplement -> each
  algorithm's predict -> serve, in the JSON shape of the JAX package's
  ``_result_to_json``.
* :class:`QueryServer` puts it behind ``POST /queries.json`` and
  ``GET /`` on a ``ThreadingHTTPServer`` in a background thread, started
  by :meth:`QueryServer.start` and stopped by :meth:`QueryServer.close`.
  A query whose predict raises answers 500 with the error's message.

The HTTP server reads each request on a thread of its own, but every
query runs on one long-lived worker thread, warmed once at start by the
service's ``warm_up()``: the device context and the library handles
(cuBLAS) that a CUDA thread sets up on its first product are set up
once, not on every request.

Waiting: ``/reload`` and degraded serving, ``/stop``, feedback, plugins,
micro-batching, the result cache, the pinned, sharded, quantized, ANN,
online and AOT tiers.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Mapping

from predictionio_tpu_torch.controller.context import WorkflowContext, local_context
from predictionio_tpu_torch.controller.params import params_from_json
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.workflow.engine_json import EngineVariant

__all__ = ["QueryServer", "QueryServerError", "QueryService", "result_to_json"]

logger = logging.getLogger(__name__)

#: largest request body the server reads
_MAX_BODY_BYTES = 1 << 20


class QueryServerError(RuntimeError):
    pass


def result_to_json(result: Any) -> Any:
    """The wire form of a prediction (the JAX package's ``_result_to_json``)."""
    if hasattr(result, "to_json"):
        return result.to_json()
    if dataclasses.is_dataclass(result) and not isinstance(result, type):
        return dataclasses.asdict(result)
    return result


def _bind_query(query_class: Any, body: Any) -> Any:
    """The body as the algorithm's query class; an algorithm without one
    takes the body as it is."""
    if query_class is None:
        return body
    if not isinstance(body, Mapping):
        raise ValueError("the query body must be a JSON object")
    return params_from_json(query_class, body)


class QueryService:
    """One deployed engine instance, loaded at construction."""

    def __init__(
        self,
        variant: EngineVariant,
        ctx: WorkflowContext | None = None,
        instance_id: str | None = None,
    ):
        self.variant = variant
        self.ctx = ctx if ctx is not None else local_context()
        self._requested_instance_id = instance_id
        self._lock = threading.Lock()
        self.start_time = _dt.datetime.now(_dt.timezone.utc)
        self.query_count = 0
        self.instance = self._resolve_instance()
        engine = variant.build_engine()
        engine_params = engine.params_from_json(self._instance_params(self.instance))
        blob = Storage.get_model_data_models().get(self.instance.id)
        if blob is None:
            raise QueryServerError(f"No model blob for instance '{self.instance.id}'")
        self._serving, self._pairs = engine.prepare_deploy(
            self.ctx, engine_params, self.instance.id, blob.models
        )
        #: where the first algorithm serves from (``GET /`` reports it)
        self.device = str(getattr(self._pairs[0][0], "device", self.ctx.device))
        logger.info("Loaded engine instance %s on %s", self.instance.id, self.device)

    # ---------------------------------------------------------------- load
    def _resolve_instance(self):
        repo = Storage.get_meta_data_engine_instances()
        if self._requested_instance_id:
            inst = repo.get(self._requested_instance_id)
            if inst is None:
                raise QueryServerError(
                    f"Engine instance '{self._requested_instance_id}' not found"
                )
            return inst
        inst = repo.get_latest_completed(self.variant.id, self.variant.version, self.variant.id)
        if inst is None:
            raise QueryServerError(
                f"No COMPLETED training of engine '{self.variant.id}' "
                f"(version '{self.variant.version}') found — run `pio train` first"
            )
        return inst

    def _instance_params(self, instance) -> Mapping[str, Any]:
        """The params the instance trained with (the JAX package's and the
        port's instances store them alike); the variant's own when the
        instance has none."""
        if not instance.algorithms_params:
            return self.variant.raw
        return {
            "datasource": {"params": json.loads(instance.datasource_params or "{}")},
            "preparator": {"params": json.loads(instance.preparator_params or "{}")},
            "algorithms": json.loads(instance.algorithms_params or "[]"),
            "serving": {"params": json.loads(instance.serving_params or "{}")},
        }

    def warm_up(self) -> None:
        for algo, model in self._pairs:
            warm = getattr(algo, "warm_up", None)
            if warm is not None:
                warm(model)

    # --------------------------------------------------------------- query
    def handle_query(self, body: Any) -> tuple[int, Any]:
        """supplement -> each algorithm's predict -> serve -> JSON."""
        if body is None:
            return 400, {"message": "Query body is required (JSON)."}
        try:
            query = _bind_query(getattr(self._pairs[0][0], "query_class", None), body)
        except Exception as e:
            return 400, {"message": f"Invalid query: {e}"}
        query = self._serving.supplement_base(query)
        predictions = [algo.predict_base(model, query) for algo, model in self._pairs]
        payload = result_to_json(self._serving.serve_base(query, predictions))
        with self._lock:
            self.query_count += 1
        return 200, payload

    def status_json(self) -> dict:
        inst = self.instance
        with self._lock:
            count = self.query_count
        return {
            "status": "alive",
            "engineId": self.variant.id,
            "engineVersion": self.variant.version,
            "engineFactory": self.variant.engine_factory,
            "engineInstanceId": inst.id,
            "startTime": self.start_time.isoformat(),
            "queryCount": count,
            "device": self.device,
        }


class QueryServer:
    """Serves a :class:`QueryService` over HTTP."""

    def __init__(self, service: QueryService, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None
        self._worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="pio-torch-predict")

    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "QueryServer":
        self._worker.submit(self.service.warm_up).result()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pio-torch-query-server", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._worker.shutdown(wait=True)

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def handle_query(self, body: Any) -> tuple[int, Any]:
        """``(status, payload)`` for one parsed body, on the worker thread."""
        return self._worker.submit(self.service.handle_query, body).result()

    def _handler_class(self) -> type:
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt: str, *args: Any) -> None:
                logger.debug("%s " + fmt, self.address_string(), *args)

            def _reply(self, status: int, payload: Any) -> None:
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self) -> None:
                if self.path == "/":
                    self._reply(200, server.service.status_json())
                else:
                    self._reply(404, {"message": f"Not found: {self.path}"})

            def do_POST(self) -> None:
                if self.path != "/queries.json":
                    self._reply(404, {"message": f"Not found: {self.path}"})
                    return
                length = int(self.headers.get("Content-Length") or 0)
                if length > _MAX_BODY_BYTES:
                    self._reply(413, {"message": "Query body too large."})
                    return
                try:
                    body = json.loads(self.rfile.read(length) or b"null")
                except ValueError as e:
                    self._reply(400, {"message": f"Invalid JSON: {e}"})
                    return
                try:
                    status, payload = server.handle_query(body)
                except Exception as e:  # one failed query answers 500; the server keeps serving
                    logger.exception("query failed: %.200r", body)
                    status, payload = 500, {"message": str(e)}
                self._reply(status, payload)

        return Handler
