"""Networked tri-role storage driver + its server.

Parity: the reference's networked backends — ``data/storage/jdbc/`` (full
tri-role PostgreSQL/MySQL driver), ``data/storage/hbase/`` (events) and
``data/storage/elasticsearch/`` (metadata) — prove that the ``Storage``
registry's pluggability claim holds against a backend on the other side
of a socket. This image ships no database server, so the framework
brings its own: a storage *server* (``pio storageserver``) that exposes
any locally-configured backend (sqlite/localfs/...) over HTTP JSON-RPC,
and this *client* driver (``TYPE=remote``) that implements every SPI
repository by forwarding calls to it.

Config (client)::

    PIO_STORAGE_SOURCES_<ID>_TYPE=remote
    PIO_STORAGE_SOURCES_<ID>_HOSTS=db-host          # default 127.0.0.1
    PIO_STORAGE_SOURCES_<ID>_PORTS=7072             # default 7072
    PIO_STORAGE_SOURCES_<ID>_SECRET=...             # optional shared secret
    PIO_STORAGE_SOURCES_<ID>_SCHEME=https           # optional (default http)
    PIO_STORAGE_SOURCES_<ID>_TIMEOUT=30             # per-attempt socket timeout
    # resilience (docs/operations.md) — all optional, defaults = off:
    PIO_STORAGE_SOURCES_<ID>_RETRIES=2              # extra attempts for reads
    PIO_STORAGE_SOURCES_<ID>_RETRY_WRITES=1         # retry writes too (opt-in)
    PIO_STORAGE_SOURCES_<ID>_BREAKER_THRESHOLD=5    # failures to open breaker
    PIO_STORAGE_SOURCES_<ID>_BREAKER_RESET_S=5      # open -> half-open probe
    PIO_STORAGE_SOURCES_<ID>_DEADLINE_S=10          # overall per-call budget

The wire format is one POST ``/rpc`` per repository call:
``{"repo": "apps", "method": "insert", "args": {...}}`` →
``{"result": ...}`` or ``{"error": "...", "kind": "storage"}``. Entities
travel as JSON dicts (datetimes ISO-8601, model blobs base64). Event
scans are **paginated**: the client iterates ``find_page`` (offset
cursor, ``PIO_REMOTE_FIND_PAGE`` events per response, default 20000) so
neither side ever materializes an unbounded result list; it falls back to the legacy single-response ``find`` when the
server predates pagination. Offset cursors re-scan on the server (the
reference's HBase scanner keeps a server-side cursor instead) and are
not snapshot-isolated across pages — the bulk training read path at real
scale belongs on sharded/columnar local files either way.

Counterpart of ``predictionio_tpu/data/storage/remote.py``, the same
code and wire format with the port's imports: either package's client
talks to either package's server.
"""

from __future__ import annotations

import base64
import datetime as _dt
import http.client
import json
import logging
import socket
import threading
import urllib.error
import urllib.request
from typing import Any, Iterable, Iterator, Mapping, Sequence

from predictionio_tpu_torch import resilience
from predictionio_tpu_torch.data.columns import EventChunk
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    AccessKeysRepo,
    App,
    AppsRepo,
    BaseStorageClient,
    Channel,
    ChannelsRepo,
    EngineInstance,
    EngineInstancesRepo,
    EvaluationInstance,
    EvaluationInstancesRepo,
    LEvents,
    Model,
    ModelsRepo,
    PEvents,
    StorageClientConfig,
    StorageError,
    StorageUnavailableError,
)

__all__ = ["StorageClient", "StorageRpcService"]

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Entity codecs (wire format)
# ---------------------------------------------------------------------------


def _dt_to(v: _dt.datetime | None) -> str | None:
    return v.isoformat() if v is not None else None


def _dt_from(v: str | None) -> _dt.datetime | None:
    return _dt.datetime.fromisoformat(v) if v else None


def _app_to(a: App) -> dict:
    return {"id": a.id, "name": a.name, "description": a.description}


def _app_from(d: Mapping) -> App:
    return App(id=d["id"], name=d["name"], description=d.get("description"))


def _key_to(k: AccessKey) -> dict:
    return {"key": k.key, "appid": k.appid, "events": list(k.events)}


def _key_from(d: Mapping) -> AccessKey:
    return AccessKey(key=d["key"], appid=d["appid"], events=tuple(d.get("events") or ()))


def _channel_to(c: Channel) -> dict:
    return {"id": c.id, "name": c.name, "appid": c.appid}


def _channel_from(d: Mapping) -> Channel:
    return Channel(id=d["id"], name=d["name"], appid=d["appid"])


def _engine_instance_to(i: EngineInstance) -> dict:
    return {
        "id": i.id, "status": i.status,
        "start_time": _dt_to(i.start_time), "end_time": _dt_to(i.end_time),
        "engine_id": i.engine_id, "engine_version": i.engine_version,
        "engine_variant": i.engine_variant, "engine_factory": i.engine_factory,
        "batch": i.batch, "env": dict(i.env), "mesh_conf": dict(i.mesh_conf),
        "datasource_params": i.datasource_params,
        "preparator_params": i.preparator_params,
        "algorithms_params": i.algorithms_params,
        "serving_params": i.serving_params,
    }


def _engine_instance_from(d: Mapping) -> EngineInstance:
    return EngineInstance(
        id=d["id"], status=d["status"],
        start_time=_dt_from(d["start_time"]), end_time=_dt_from(d["end_time"]),
        engine_id=d["engine_id"], engine_version=d["engine_version"],
        engine_variant=d["engine_variant"], engine_factory=d["engine_factory"],
        batch=d.get("batch", ""), env=dict(d.get("env") or {}),
        mesh_conf=dict(d.get("mesh_conf") or {}),
        datasource_params=d.get("datasource_params", ""),
        preparator_params=d.get("preparator_params", ""),
        algorithms_params=d.get("algorithms_params", ""),
        serving_params=d.get("serving_params", ""),
    )


def _evaluation_instance_to(i: EvaluationInstance) -> dict:
    return {
        "id": i.id, "status": i.status,
        "start_time": _dt_to(i.start_time), "end_time": _dt_to(i.end_time),
        "evaluation_class": i.evaluation_class,
        "engine_params_generator_class": i.engine_params_generator_class,
        "batch": i.batch, "env": dict(i.env),
        "evaluator_results": i.evaluator_results,
        "evaluator_results_html": i.evaluator_results_html,
        "evaluator_results_json": i.evaluator_results_json,
    }


def _evaluation_instance_from(d: Mapping) -> EvaluationInstance:
    return EvaluationInstance(
        id=d["id"], status=d["status"],
        start_time=_dt_from(d["start_time"]), end_time=_dt_from(d["end_time"]),
        evaluation_class=d.get("evaluation_class", ""),
        engine_params_generator_class=d.get("engine_params_generator_class", ""),
        batch=d.get("batch", ""), env=dict(d.get("env") or {}),
        evaluator_results=d.get("evaluator_results", ""),
        evaluator_results_html=d.get("evaluator_results_html", ""),
        evaluator_results_json=d.get("evaluator_results_json", ""),
    )


def _model_to(m: Model) -> dict:
    return {"id": m.id, "models": base64.b64encode(m.models).decode("ascii")}


def _model_from(d: Mapping) -> Model:
    return Model(id=d["id"], models=base64.b64decode(d["models"]))


def _event_to_wire(e: Event) -> dict:
    # NOT the REST codec: that format truncates to milliseconds, while the
    # storage SPI round-trips microsecond timestamps — full ISO-8601 here
    return {
        "event": e.event,
        "entityType": e.entity_type,
        "entityId": e.entity_id,
        "targetEntityType": e.target_entity_type,
        "targetEntityId": e.target_entity_id,
        "properties": e.properties.to_dict(),
        "eventTime": e.event_time.isoformat(),
        "eventId": e.event_id,
        "tags": list(e.tags),
        "prId": e.pr_id,
        "creationTime": e.creation_time.isoformat(),
    }


def _event_from_wire(d: Mapping) -> Event:
    return Event(
        event=d["event"],
        entity_type=d["entityType"],
        entity_id=d["entityId"],
        target_entity_type=d.get("targetEntityType"),
        target_entity_id=d.get("targetEntityId"),
        properties=DataMap(d.get("properties") or {}),
        event_time=_dt.datetime.fromisoformat(d["eventTime"]),
        event_id=d.get("eventId"),
        tags=tuple(d.get("tags") or ()),
        pr_id=d.get("prId"),
        creation_time=_dt.datetime.fromisoformat(d["creationTime"]),
    )


def _find_filter_args(
    channel_id, start_time, until_time, entity_type, entity_id,
    event_names, target_entity_type, target_entity_id,
) -> dict:
    return {
        "channel_id": channel_id,
        "start_time": _dt_to(start_time),
        "until_time": _dt_to(until_time),
        "entity_type": entity_type,
        "entity_id": entity_id,
        "event_names": list(event_names) if event_names is not None else None,
        "target_entity_type": target_entity_type,
        "target_entity_id": target_entity_id,
    }


# ---------------------------------------------------------------------------
# Client driver
# ---------------------------------------------------------------------------


def _is_idempotent(method: str) -> bool:
    """Reads retry by default; writes only when explicitly marked safe
    (``retry_writes``). Method names are the SPI whitelist's, so a prefix
    check is exact: every read starts with ``get``/``find``."""
    return method.startswith(("get", "find"))


class _AttemptTimeoutError(StorageUnavailableError):
    """Module-private marker: the attempt timed out. Needed so breaker
    accounting can tell a server-is-slow timeout from one manufactured
    by a deadline-clamped attempt budget."""


class _CircuitOpenSignal(Exception):
    """Module-private: breaker fast-fail. Deliberately OUTSIDE the
    StorageError hierarchy so the retry policy (which retries
    StorageUnavailableError) cannot sleep-and-retry against an open
    circuit — call() converts it at the boundary."""


class _Rpc:
    """One storage-server connection's transport policy: per-attempt
    timeout, optional :class:`~predictionio_tpu_torch.resilience.RetryPolicy`
    (budgeted by the ambient :func:`~predictionio_tpu_torch.resilience
    .deadline_scope` so retries never exceed the caller's overall
    timeout) and optional circuit breaker (a dead storage server fails
    fast instead of stacking full timeouts under load)."""

    def __init__(
        self,
        base_url: str,
        secret: str | None,
        timeout: float,
        policy: "resilience.RetryPolicy | None" = None,
        breaker: "resilience.CircuitBreaker | None" = None,
        deadline_s: float = 0.0,
    ):
        self._url = base_url.rstrip("/") + "/rpc"
        self._secret = secret
        self._timeout = timeout
        self._policy = policy or resilience.RetryPolicy()
        self._breaker = breaker
        self._deadline_s = deadline_s
        self._lock = threading.Lock()
        # monotonic counters for /stats.json (see to_json)
        self._calls = 0
        self._retries = 0
        self._failures = 0
        self._breaker_fast_fails = 0
        self._deadline_exceeded = 0

    def _attempt(self, repo: str, method: str, args: dict, timeout: float) -> Any:
        """One wire round trip. Every failure mode maps to a distinct,
        actionable StorageError; transport-level ones (the only ones a
        retry can fix) to :class:`StorageUnavailableError`."""
        payload = json.dumps(
            {"repo": repo, "method": method, "args": args}
        ).encode()
        headers = {"Content-Type": "application/json"}
        if self._secret:
            headers["X-PIO-Storage-Secret"] = self._secret
        req = urllib.request.Request(
            self._url, data=payload, headers=headers, method="POST"
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                raw = resp.read()
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read())
                detail = body.get("error", e.reason)
            except Exception:
                detail = f"HTTP {e.code} {e.reason} (non-JSON error body)"
            if e.code >= 500:
                # the server (or a proxy in front of it) is failing, not
                # rejecting the request — retryable
                raise StorageUnavailableError(
                    f"storage server failure for {repo}.{method}: {detail}"
                ) from e
            raise StorageError(
                f"storage server error for {repo}.{method}: {detail}"
            ) from e
        except urllib.error.URLError as e:
            reason = e.reason
            if isinstance(reason, ConnectionRefusedError):
                raise StorageUnavailableError(
                    f"cannot reach storage server at {self._url} for "
                    f"{repo}.{method}: connection refused — is "
                    "`pio storageserver` running?"
                ) from e
            if isinstance(reason, (TimeoutError, socket.timeout)):
                raise _AttemptTimeoutError(
                    f"cannot reach storage server at {self._url} for "
                    f"{repo}.{method}: timed out after {timeout:g}s"
                ) from e
            raise StorageUnavailableError(
                f"cannot reach storage server at {self._url}: {reason}"
            ) from e
        except http.client.IncompleteRead as e:
            raise StorageUnavailableError(
                f"storage server connection lost mid-response for "
                f"{repo}.{method} ({len(e.partial)} bytes read) — "
                "server crashed or connection was cut"
            ) from e
        except (http.client.HTTPException, ConnectionError) as e:
            raise StorageUnavailableError(
                f"storage server connection broke for {repo}.{method}: "
                f"{type(e).__name__}: {e}"
            ) from e
        except TimeoutError as e:
            raise _AttemptTimeoutError(
                f"storage server at {self._url} timed out after "
                f"{timeout:g}s for {repo}.{method}"
            ) from e
        try:
            body = json.loads(raw)
        except json.JSONDecodeError as e:
            raise StorageUnavailableError(
                f"storage server sent a malformed JSON response for "
                f"{repo}.{method} ({len(raw)} bytes)"
            ) from e
        if "error" in body:
            raise StorageError(body["error"])
        return body.get("result")

    def call(
        self,
        repo: str,
        method: str,
        args: dict,
        idempotent: bool | None = None,
    ) -> Any:
        """``idempotent=None`` derives retryability from the method name
        (reads retry, writes don't); an explicit True marks a WRITE safe
        to retry — the event-insert path sets it once every event carries
        a client/server-stamped id, because the server-side dedup index
        makes re-sending the same event a no-op."""
        deadline = resilience.current_deadline()
        own = None
        if self._deadline_s > 0:
            # the configured per-call budget composes with any ambient
            # scope the same way nested scopes do: the tighter one wins
            own = resilience.Deadline.after(self._deadline_s)
            if deadline is None or own.remaining() < deadline.remaining():
                deadline = own
        # who bounded this call matters for breaker accounting: a CALLER
        # scope (a readyz probe's 2 s budget) starving an attempt says
        # nothing about server health, but the transport's own configured
        # DEADLINE_S is the operator's definition of "too slow" — a
        # timeout under it must count toward opening the breaker
        caller_bounded = deadline is not None and deadline is not own
        with self._lock:
            self._calls += 1

        def one_attempt() -> Any:
            if deadline is not None and deadline.expired:
                with self._lock:
                    self._deadline_exceeded += 1
                raise resilience.DeadlineExceededError(
                    f"deadline exhausted calling {repo}.{method}"
                )
            if self._breaker is not None and not self._breaker.acquire():
                with self._lock:
                    self._breaker_fast_fails += 1
                # NOT StorageUnavailableError: the retry policy must not
                # sleep-and-retry against an open circuit (that would
                # re-convoy the handler threads the breaker protects);
                # converted to a StorageUnavailableError below, after run()
                raise _CircuitOpenSignal()
            timeout = (
                self._timeout if deadline is None else
                max(0.001, deadline.clamp(self._timeout))
            )
            clamped_by_caller = caller_bounded and timeout < self._timeout
            try:
                result = self._attempt(repo, method, args, timeout)
            except _AttemptTimeoutError:
                with self._lock:
                    self._failures += 1
                if self._breaker is not None:
                    if clamped_by_caller:
                        # the caller's deadline, not the server, bounded
                        # this attempt — a tight probe budget (readyz's
                        # 2 s) must not open the breaker shared with
                        # production calls running the full timeout
                        self._breaker.record_cancelled()
                    else:
                        self._breaker.record_failure()
                raise
            except StorageUnavailableError:
                with self._lock:
                    self._failures += 1
                if self._breaker is not None:
                    self._breaker.record_failure()
                raise
            except StorageError:
                # application-level: the server answered, it is up
                if self._breaker is not None:
                    self._breaker.record_success()
                raise
            except BaseException:
                # anything else (SSL error, serialization TypeError, ...):
                # the acquired breaker slot MUST be released or a failed
                # half-open probe would wedge the breaker shut forever;
                # unknown != healthy, so count it as a failure
                if self._breaker is not None:
                    self._breaker.record_failure()
                raise
            if self._breaker is not None:
                self._breaker.record_success()
            return result

        def on_retry(attempt: int, exc: BaseException) -> None:
            with self._lock:
                self._retries += 1
            logger.warning(
                "retrying %s.%s (attempt %d/%d): %s",
                repo, method, attempt, self._policy.max_attempts, exc,
            )

        try:
            return self._policy.run(
                one_attempt,
                retryable=(StorageUnavailableError,),
                idempotent=(
                    _is_idempotent(method) if idempotent is None else idempotent
                ),
                deadline=deadline,
                on_retry=on_retry,
            )
        except _CircuitOpenSignal:
            raise StorageUnavailableError(
                f"storage circuit open; failing {repo}.{method} fast "
                f"(retry in "
                f"{self._breaker.retry_after_s():.1f}s)"  # type: ignore[union-attr]
            ) from None
        except resilience.DeadlineExceededError as e:
            raise StorageError(str(e)) from e

    def to_json(self) -> dict:
        with self._lock:
            out = {
                "calls": self._calls,
                "retries": self._retries,
                "transportFailures": self._failures,
                "breakerFastFails": self._breaker_fast_fails,
                "deadlineExceeded": self._deadline_exceeded,
                "maxAttempts": self._policy.max_attempts,
            }
        out["breaker"] = (
            self._breaker.to_json() if self._breaker is not None else None
        )
        return out


class _RemoteApps(AppsRepo):
    def __init__(self, rpc: _Rpc):
        self._rpc = rpc

    def insert(self, app: App) -> int | None:
        return self._rpc.call("apps", "insert", {"app": _app_to(app)})

    def get(self, app_id: int) -> App | None:
        d = self._rpc.call("apps", "get", {"app_id": app_id})
        return _app_from(d) if d else None

    def get_by_name(self, name: str) -> App | None:
        d = self._rpc.call("apps", "get_by_name", {"name": name})
        return _app_from(d) if d else None

    def get_all(self) -> list[App]:
        return [_app_from(d) for d in self._rpc.call("apps", "get_all", {})]

    def update(self, app: App) -> bool:
        return bool(self._rpc.call("apps", "update", {"app": _app_to(app)}))

    def delete(self, app_id: int) -> bool:
        return bool(self._rpc.call("apps", "delete", {"app_id": app_id}))


class _RemoteAccessKeys(AccessKeysRepo):
    def __init__(self, rpc: _Rpc):
        self._rpc = rpc

    def insert(self, access_key: AccessKey) -> str | None:
        return self._rpc.call(
            "access_keys", "insert", {"access_key": _key_to(access_key)}
        )

    def get(self, key: str) -> AccessKey | None:
        d = self._rpc.call("access_keys", "get", {"key": key})
        return _key_from(d) if d else None

    def get_all(self) -> list[AccessKey]:
        return [_key_from(d) for d in self._rpc.call("access_keys", "get_all", {})]

    def get_by_appid(self, appid: int) -> list[AccessKey]:
        return [
            _key_from(d)
            for d in self._rpc.call("access_keys", "get_by_appid", {"appid": appid})
        ]

    def update(self, access_key: AccessKey) -> bool:
        return bool(
            self._rpc.call(
                "access_keys", "update", {"access_key": _key_to(access_key)}
            )
        )

    def delete(self, key: str) -> bool:
        return bool(self._rpc.call("access_keys", "delete", {"key": key}))


class _RemoteChannels(ChannelsRepo):
    def __init__(self, rpc: _Rpc):
        self._rpc = rpc

    def insert(self, channel: Channel) -> int | None:
        return self._rpc.call("channels", "insert", {"channel": _channel_to(channel)})

    def get(self, channel_id: int) -> Channel | None:
        d = self._rpc.call("channels", "get", {"channel_id": channel_id})
        return _channel_from(d) if d else None

    def get_by_appid(self, appid: int) -> list[Channel]:
        return [
            _channel_from(d)
            for d in self._rpc.call("channels", "get_by_appid", {"appid": appid})
        ]

    def delete(self, channel_id: int) -> bool:
        return bool(self._rpc.call("channels", "delete", {"channel_id": channel_id}))


class _RemoteEngineInstances(EngineInstancesRepo):
    def __init__(self, rpc: _Rpc):
        self._rpc = rpc

    def insert(self, instance: EngineInstance) -> str:
        return self._rpc.call(
            "engine_instances", "insert", {"instance": _engine_instance_to(instance)}
        )

    def get(self, instance_id: str) -> EngineInstance | None:
        d = self._rpc.call("engine_instances", "get", {"instance_id": instance_id})
        return _engine_instance_from(d) if d else None

    def get_all(self) -> list[EngineInstance]:
        return [
            _engine_instance_from(d)
            for d in self._rpc.call("engine_instances", "get_all", {})
        ]

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None:
        d = self._rpc.call(
            "engine_instances", "get_latest_completed",
            {
                "engine_id": engine_id,
                "engine_version": engine_version,
                "engine_variant": engine_variant,
            },
        )
        return _engine_instance_from(d) if d else None

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        return [
            _engine_instance_from(d)
            for d in self._rpc.call(
                "engine_instances", "get_completed",
                {
                    "engine_id": engine_id,
                    "engine_version": engine_version,
                    "engine_variant": engine_variant,
                },
            )
        ]

    def update(self, instance: EngineInstance) -> bool:
        return bool(
            self._rpc.call(
                "engine_instances", "update",
                {"instance": _engine_instance_to(instance)},
            )
        )

    def delete(self, instance_id: str) -> bool:
        return bool(
            self._rpc.call("engine_instances", "delete", {"instance_id": instance_id})
        )


class _RemoteEvaluationInstances(EvaluationInstancesRepo):
    def __init__(self, rpc: _Rpc):
        self._rpc = rpc

    def insert(self, instance: EvaluationInstance) -> str:
        return self._rpc.call(
            "evaluation_instances", "insert",
            {"instance": _evaluation_instance_to(instance)},
        )

    def get(self, instance_id: str) -> EvaluationInstance | None:
        d = self._rpc.call(
            "evaluation_instances", "get", {"instance_id": instance_id}
        )
        return _evaluation_instance_from(d) if d else None

    def get_all(self) -> list[EvaluationInstance]:
        return [
            _evaluation_instance_from(d)
            for d in self._rpc.call("evaluation_instances", "get_all", {})
        ]

    def get_completed(self) -> list[EvaluationInstance]:
        return [
            _evaluation_instance_from(d)
            for d in self._rpc.call("evaluation_instances", "get_completed", {})
        ]

    def update(self, instance: EvaluationInstance) -> bool:
        return bool(
            self._rpc.call(
                "evaluation_instances", "update",
                {"instance": _evaluation_instance_to(instance)},
            )
        )

    def delete(self, instance_id: str) -> bool:
        return bool(
            self._rpc.call(
                "evaluation_instances", "delete", {"instance_id": instance_id}
            )
        )


class _RemoteModels(ModelsRepo):
    def __init__(self, rpc: _Rpc):
        self._rpc = rpc

    def insert(self, model: Model) -> None:
        self._rpc.call("models", "insert", {"model": _model_to(model)})

    def get(self, model_id: str) -> Model | None:
        d = self._rpc.call("models", "get", {"model_id": model_id})
        return _model_from(d) if d else None

    def delete(self, model_id: str) -> bool:
        return bool(self._rpc.call("models", "delete", {"model_id": model_id}))


def _paged_find(rpc: "_Rpc", role: str, args: dict) -> Iterator[Event]:
    """Iterate a remote event scan page by page (offset cursor). Falls
    back to the legacy unpaginated ``find`` on servers that predate
    ``find_page``."""
    import os

    page_limit = int(os.environ.get("PIO_REMOTE_FIND_PAGE", "20000"))
    offset = 0
    while True:
        try:
            page = rpc.call(
                role, "find_page",
                {**args, "page_limit": page_limit, "offset": offset},
            )
        except StorageError as e:
            if offset == 0 and "unknown method" in str(e):
                for d in rpc.call(role, "find", args):
                    yield _event_from_wire(d)
                return
            raise
        for d in page["items"]:
            yield _event_from_wire(d)
        if page.get("next_offset") is None:
            return
        offset = int(page["next_offset"])


class _RemoteLEvents(LEvents):
    def __init__(self, rpc: _Rpc):
        self._rpc = rpc

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        return bool(
            self._rpc.call(
                "l_events", "init", {"app_id": app_id, "channel_id": channel_id}
            )
        )

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        return bool(
            self._rpc.call(
                "l_events", "remove", {"app_id": app_id, "channel_id": channel_id}
            )
        )

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        return self.insert_dedup(event, app_id, channel_id)[0]

    def insert_dedup(
        self, event: Event, app_id: int, channel_id: int | None = None
    ) -> tuple[str, bool]:
        """Retry-safe remote event write (the reason the RetryPolicy
        can cover this path): the event id is stamped HERE, before
        the wire, so a retried RPC whose first attempt landed but whose
        response was lost re-sends the SAME id and the server's dedup
        index turns it into ``duplicate=True`` instead of a double
        write."""
        if not event.event_id:
            from predictionio_tpu_torch.data.event import new_event_id

            event = event.with_event_id(new_event_id())
        args = {
            "event": _event_to_wire(event),
            "app_id": app_id,
            "channel_id": channel_id,
        }
        try:
            eid, dup = self._rpc.call(
                "l_events", "insert_dedup", args, idempotent=True
            )
        except StorageError as e:
            if "unknown method" not in str(e):
                raise
            # pre-dedup storage server: legacy single-shot insert (the
            # write is NOT retry-safe there, so no idempotent override)
            return self._rpc.call("l_events", "insert", args), False
        return eid, bool(dup)

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        return [eid for eid, _ in self.insert_batch_dedup(events, app_id, channel_id)]

    def insert_batch_dedup(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[tuple[str, bool]]:
        stamped = []
        for e in events:
            if not e.event_id:
                from predictionio_tpu_torch.data.event import new_event_id

                e = e.with_event_id(new_event_id())
            stamped.append(e)
        args = {
            "events": [_event_to_wire(e) for e in stamped],
            "app_id": app_id,
            "channel_id": channel_id,
        }
        try:
            result = self._rpc.call(
                "l_events", "insert_batch_dedup", args, idempotent=True
            )
        except StorageError as e:
            if "unknown method" not in str(e):
                raise
            ids = self._rpc.call("l_events", "insert_batch", args)
            return [(eid, False) for eid in ids]
        return [(eid, bool(dup)) for eid, dup in result]

    def ingest_chunk(
        self, chunk: EventChunk, app_id: int, channel_id: int | None = None
    ) -> list[tuple[str, bool]]:
        """Bulk-chunk RPC: the whole pre-parsed chunk crosses the wire
        once (column lists, not per-event dicts) and the server lands it
        through its backend's vectorized path. Ids are stamped at parse
        time, so the call is retry-safe (``idempotent=True``). Falls
        back to the decoded batch-dedup path on servers that predate the
        bulk SPI."""
        args = {
            "chunk": chunk.to_wire(),
            "app_id": app_id,
            "channel_id": channel_id,
        }
        try:
            result = self._rpc.call(
                "l_events", "ingest_chunk", args, idempotent=True
            )
        except StorageError as e:
            if "unknown method" not in str(e):
                raise
            return LEvents.ingest_chunk(self, chunk, app_id, channel_id)
        return [(str(eid), bool(dup)) for eid, dup in result]

    def compact(self, app_id: int, channel_id: int | None = None) -> int:
        """Proxy of the columnar driver's tail compaction; StorageError
        when the backing store has no tail/segment layout."""
        return self._rpc.call(
            "l_events", "compact",
            {"app_id": app_id, "channel_id": channel_id},
        )

    def get(self, event_id: str, app_id: int, channel_id: int | None = None) -> Event | None:
        d = self._rpc.call(
            "l_events", "get",
            {"event_id": event_id, "app_id": app_id, "channel_id": channel_id},
        )
        return _event_from_wire(d) if d else None

    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool:
        return bool(
            self._rpc.call(
                "l_events", "delete",
                {"event_id": event_id, "app_id": app_id, "channel_id": channel_id},
            )
        )

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None = None,
        target_entity_id: str | None = None,
        limit: int | None = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        args = {"app_id": app_id, "limit": limit, "reversed": reversed}
        args.update(
            _find_filter_args(
                channel_id, start_time, until_time, entity_type, entity_id,
                event_names, target_entity_type, target_entity_id,
            )
        )
        yield from _paged_find(self._rpc, "l_events", args)


class _RemotePEvents(PEvents):
    def __init__(self, rpc: _Rpc):
        self._rpc = rpc

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None = None,
        target_entity_id: str | None = None,
        shard_index: int = 0,
        num_shards: int = 1,
    ) -> Iterator[Event]:
        args = {
            "app_id": app_id,
            "shard_index": shard_index,
            "num_shards": num_shards,
        }
        args.update(
            _find_filter_args(
                channel_id, start_time, until_time, entity_type, entity_id,
                event_names, target_entity_type, target_entity_id,
            )
        )
        yield from _paged_find(self._rpc, "p_events", args)

    def write(
        self, events: Iterable[Event], app_id: int, channel_id: int | None = None
    ) -> None:
        self._rpc.call(
            "p_events", "write",
            {
                "events": [_event_to_wire(e) for e in events],
                "app_id": app_id,
                "channel_id": channel_id,
            },
        )

    def delete(self, app_id: int, channel_id: int | None = None) -> None:
        self._rpc.call(
            "p_events", "delete", {"app_id": app_id, "channel_id": channel_id}
        )


class StorageClient(BaseStorageClient):
    """Client driver for a ``pio storageserver`` (``TYPE=remote``)."""

    def __init__(self, config: StorageClientConfig):
        super().__init__(config)
        props = config.properties
        host = (props.get("hosts") or "127.0.0.1").split(",")[0]
        port = int((props.get("ports") or "7072").split(",")[0])
        scheme = props.get("scheme", "http")
        timeout = float(props.get("timeout", "30"))
        # resilience knobs: per-source properties override the process-
        # wide defaults (`pio deploy --retry-*`); built-in defaults are
        # the do-nothing config — single attempt, no breaker, no deadline
        dft = resilience.get_rpc_defaults()
        retries = int(props.get("retries", dft.retries))
        retry_writes = str(
            props.get("retry_writes", dft.retry_writes)
        ).lower() in ("1", "true", "yes")
        breaker_threshold = int(
            props.get("breaker_threshold", dft.breaker_threshold)
        )
        breaker_reset_s = float(
            props.get("breaker_reset_s", dft.breaker_reset_s)
        )
        deadline_s = float(props.get("deadline_s", dft.deadline_s))
        policy = resilience.RetryPolicy(
            max_attempts=1 + max(0, retries),
            base_delay_s=float(props.get("retry_base_delay_s", "0.05")),
            max_delay_s=float(props.get("retry_max_delay_s", "2.0")),
            retry_writes=retry_writes,
        )
        breaker = (
            resilience.CircuitBreaker(
                failure_threshold=breaker_threshold,
                reset_timeout_s=breaker_reset_s,
                name=f"storage:{config.source_id}",
            )
            if breaker_threshold > 0
            else None
        )
        self._rpc = _Rpc(
            f"{scheme}://{host}:{port}", props.get("secret"), timeout,
            policy=policy, breaker=breaker, deadline_s=deadline_s,
        )
        # breaker state + retry/abort counters on every /stats.json
        resilience.register_stats(f"storage_rpc:{config.source_id}", self._rpc)

    def get_apps(self) -> AppsRepo:
        return _RemoteApps(self._rpc)

    def get_access_keys(self) -> AccessKeysRepo:
        return _RemoteAccessKeys(self._rpc)

    def get_channels(self) -> ChannelsRepo:
        return _RemoteChannels(self._rpc)

    def get_engine_instances(self) -> EngineInstancesRepo:
        return _RemoteEngineInstances(self._rpc)

    def get_evaluation_instances(self) -> EvaluationInstancesRepo:
        return _RemoteEvaluationInstances(self._rpc)

    def get_models(self) -> ModelsRepo:
        return _RemoteModels(self._rpc)

    def get_l_events(self) -> LEvents:
        return _RemoteLEvents(self._rpc)

    def get_p_events(self) -> PEvents:
        return _RemotePEvents(self._rpc)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


def _driver_has_dedup(repo: Any, method: str) -> bool:
    """Does this LEvents implementation actually dedup, or would it run
    the base-class default (a plain insert)? ``insert_batch_dedup``'s
    base default loops ``insert_dedup``, so overriding either makes the
    batch flavor safe."""
    cls = type(repo)
    if getattr(cls, "insert_dedup", None) is not LEvents.insert_dedup:
        return True
    return (
        method == "insert_batch_dedup"
        and getattr(cls, "insert_batch_dedup", None)
        is not LEvents.insert_batch_dedup
    )


#: repo name -> (method -> (arg decoder kwargs, result encoder))
_ENTITY_ARGS = {
    ("apps", "insert"): ("app", _app_from),
    ("apps", "update"): ("app", _app_from),
    ("access_keys", "insert"): ("access_key", _key_from),
    ("access_keys", "update"): ("access_key", _key_from),
    ("channels", "insert"): ("channel", _channel_from),
    ("engine_instances", "insert"): ("instance", _engine_instance_from),
    ("engine_instances", "update"): ("instance", _engine_instance_from),
    ("evaluation_instances", "insert"): ("instance", _evaluation_instance_from),
    ("evaluation_instances", "update"): ("instance", _evaluation_instance_from),
    ("models", "insert"): ("model", _model_from),
}

_ENCODERS = {
    App: _app_to,
    AccessKey: _key_to,
    Channel: _channel_to,
    EngineInstance: _engine_instance_to,
    EvaluationInstance: _evaluation_instance_to,
    Model: _model_to,
    Event: _event_to_wire,
}


def _encode_result(v: Any) -> Any:
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    enc = _ENCODERS.get(type(v))
    if enc is not None:
        return enc(v)
    if isinstance(v, Mapping):
        # refuse rather than let the generic-iterable branch silently
        # serialize a mapping as its keys (advisor r3)
        raise StorageError(
            "cannot serialize Mapping result — add an explicit encoder"
        )
    if isinstance(v, (list, tuple)) or hasattr(v, "__iter__"):
        return [_encode_result(x) for x in v]
    raise StorageError(f"cannot serialize result of type {type(v).__name__}")


class StorageRpcService:
    """Server side: exposes a delegate storage backend over POST ``/rpc``.

    ``client`` pins all repositories to one :class:`BaseStorageClient`
    (tests); ``client=None`` routes each role through the process-wide
    ``Storage`` registry — so ``pio storageserver`` serves whatever its
    own ``PIO_STORAGE_*`` env configures (sqlite + localfs by default).
    """

    #: explicit SPI whitelist: a getattr dispatch would also expose
    #: non-SPI methods (close(), ...) to any network caller
    _METHODS = {
        "apps": frozenset(
            ("insert", "get", "get_by_name", "get_all", "update", "delete")
        ),
        "access_keys": frozenset(
            ("insert", "get", "get_all", "get_by_appid", "update", "delete")
        ),
        "channels": frozenset(("insert", "get", "get_by_appid", "delete")),
        "engine_instances": frozenset(
            (
                "insert", "get", "get_all", "get_latest_completed",
                "get_completed", "update", "delete",
            )
        ),
        "evaluation_instances": frozenset(
            ("insert", "get", "get_all", "get_completed", "update", "delete")
        ),
        "models": frozenset(("insert", "get", "delete")),
        "l_events": frozenset(
            (
                "init", "remove", "insert", "insert_batch", "insert_dedup",
                "insert_batch_dedup", "ingest_chunk", "get", "delete",
                "find", "find_page", "compact",
            )
        ),
        "p_events": frozenset(("find", "find_page", "write", "delete")),
    }
    _ROLES = tuple(_METHODS)

    def __init__(
        self, client: BaseStorageClient | None = None, secret: str | None = None
    ):
        self._client = client
        self._secret = secret

    def _repo(self, role: str) -> Any:
        if role not in self._ROLES:
            raise StorageError(f"unknown repository '{role}'")
        if self._client is not None:
            return getattr(self._client, f"get_{role}")()
        from predictionio_tpu_torch.data.storage import Storage

        registry_map = {
            "apps": Storage.get_meta_data_apps,
            "access_keys": Storage.get_meta_data_access_keys,
            "channels": Storage.get_meta_data_channels,
            "engine_instances": Storage.get_meta_data_engine_instances,
            "evaluation_instances": Storage.get_meta_data_evaluation_instances,
            "models": Storage.get_model_data_models,
            "l_events": Storage.get_l_events,
            "p_events": Storage.get_p_events,
        }
        return registry_map[role]()

    def _call(self, role: str, method: str, args: Mapping[str, Any]) -> Any:
        if method not in self._METHODS.get(role, frozenset()):
            raise StorageError(f"unknown method '{role}.{method}'")
        repo = self._repo(role)
        if method == "compact" and not hasattr(repo, "compact"):
            raise StorageError(
                "the backing EVENTDATA store has no tail to compact"
            )
        if method in ("insert_dedup", "insert_batch_dedup") and not (
            _driver_has_dedup(repo, method)
        ):
            # a driver still on the no-op base default would ACCEPT the
            # call but store duplicates — answer "unknown method" so the
            # client falls back to the legacy path and, crucially, stops
            # treating the write as retry-safe
            raise StorageError(
                f"unknown method '{role}.{method}' (backing event store "
                "has no dedup index)"
            )
        if method == "ingest_chunk":
            # same contract for the bulk chunk RPC: it is only
            # advertised when the backing driver can actually dedup
            # (native chunk path or a real insert_batch_dedup override)
            has_native = (
                getattr(type(repo), "ingest_chunk", None)
                is not LEvents.ingest_chunk
            )
            if not (
                has_native or _driver_has_dedup(repo, "insert_batch_dedup")
            ):
                raise StorageError(
                    f"unknown method '{role}.{method}' (backing event "
                    "store has no dedup index)"
                )
        # find_page is a server-layer verb over the repo's find iterator,
        # not an SPI method — resolved after arg decoding below
        fn = None if method == "find_page" else getattr(repo, method)
        kwargs = dict(args)
        # decode typed arguments
        ent = _ENTITY_ARGS.get((role, method))
        if ent is not None:
            name, dec = ent
            if name not in kwargs:
                raise StorageError(
                    f"'{role}.{method}' requires argument '{name}'"
                )
            kwargs[name] = dec(kwargs[name])
        if role in ("l_events", "p_events"):
            if "event" in kwargs:
                kwargs["event"] = _event_from_wire(kwargs["event"])
            if "events" in kwargs:
                kwargs["events"] = [_event_from_wire(e) for e in kwargs["events"]]
            if "chunk" in kwargs:
                kwargs["chunk"] = EventChunk.from_wire(kwargs["chunk"])
            for tkey in ("start_time", "until_time"):
                if tkey in kwargs:
                    kwargs[tkey] = _dt_from(kwargs[tkey])
            if method == "find_page":
                return self._find_page(repo, kwargs)
        return _encode_result(fn(**kwargs))

    @staticmethod
    def _find_page(repo: Any, kwargs: dict) -> dict:
        """One bounded page of a scan: islice the repo's find iterator at
        an offset cursor. Stateless (each page re-scans up to the offset)
        so the server holds no per-client cursors; ``next_offset`` is
        null on the final page."""
        import itertools

        try:
            page_limit = int(kwargs.pop("page_limit"))
            offset = int(kwargs.pop("offset"))
        except (KeyError, TypeError, ValueError) as e:
            raise StorageError(f"find_page needs page_limit/offset: {e}") from e
        if not (0 < page_limit <= 1_000_000) or offset < 0:
            raise StorageError(
                f"invalid page (page_limit={page_limit}, offset={offset})"
            )
        items = list(
            itertools.islice(repo.find(**kwargs), offset, offset + page_limit + 1)
        )
        has_more = len(items) > page_limit
        return {
            "items": [_event_to_wire(e) for e in items[:page_limit]],
            "next_offset": offset + page_limit if has_more else None,
        }

    # -- readiness (GET /readyz, served by the HTTP wrapper) ----------------
    def readiness(self) -> dict:
        """The storage server is ready iff its *backing* store answers —
        a pinned test client is probed directly, the registry-backed mode
        through the shared storage check."""
        from predictionio_tpu_torch.api.health import readiness_report, storage_check

        if self._client is None:
            return readiness_report(backing_storage=storage_check())
        try:
            self._client.get_apps().get(-1)
            check = {"ok": True}
        except Exception as e:
            check = {"ok": False, "error": str(e)[:200]}
        return readiness_report(backing_storage=check)

    # -- http dispatch (predictionio_tpu_torch.api.http protocol) -----------------
    def dispatch(
        self,
        method: str,
        path: str,
        params: Mapping[str, str],
        body: Any = None,
        headers: Mapping[str, str] | None = None,
        form: Mapping[str, str] | None = None,
    ):
        from predictionio_tpu_torch.api.service import Response

        if path == "/" and method.upper() == "GET":
            return Response(200, {"status": "alive", "service": "storageserver"})
        if path != "/rpc" or method.upper() != "POST":
            return Response(404, {"error": "Not Found"})
        if self._secret:
            # header names reach us in whatever case the client stack
            # normalized to (urllib capitalizes) — compare case-insensitively
            given = next(
                (
                    v
                    for k, v in (headers or {}).items()
                    if k.lower() == "x-pio-storage-secret"
                ),
                None,
            )
            import hmac

            # compare as bytes: compare_digest raises TypeError on
            # non-ASCII str input (-> 500 instead of the intended 401)
            if not hmac.compare_digest(
                (given or "").encode(), self._secret.encode()
            ):
                return Response(401, {"error": "invalid storage secret"})
        if not isinstance(body, Mapping) or "repo" not in body or "method" not in body:
            return Response(400, {"error": "body must be {repo, method, args}"})
        try:
            result = self._call(
                str(body["repo"]), str(body["method"]), body.get("args") or {}
            )
        except StorageError as e:
            return Response(400, {"error": str(e), "kind": "storage"})
        except TypeError as e:
            return Response(400, {"error": f"bad arguments: {e}"})
        except Exception as e:
            logger.exception("storage rpc failed")
            return Response(500, {"error": f"internal error: {e}"})
        return Response(200, {"result": result})
