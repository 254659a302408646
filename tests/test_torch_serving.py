"""The port's query server (``workflow/serving.py``) against the JAX
package's, on one store.

Both packages' ``Storage`` point at one sqlite + localfs base directory.
The port trains the Recommendation engine on the CPU (``run_train``); the
blob format is shared, so the JAX package's ``QueryService`` (its host
path) and the port's (``device="cpu"``, the JAX package's host branch)
serve the same instances. One request script then goes through both
``QueryService.dispatch`` calls: ``/``, ``/queries.json`` (valid,
malformed, unknown user), ``/stats.json``, ``/cache/invalidate.json``,
``/reload`` to a second instance, a degraded ``/reload`` (a third
instance whose blob is removed), ``/stop`` with and without its token,
and the routes of tiers that are off. The payloads must be equal once
times, ``prId`` and ``startTime`` are normalised (tolerance: none, the
scores are the same numpy code on the same arrays). Plugins of each type
and the feedback loop (against a stub event server) are held the same
way, feedback's events equal apart from the prediction id. A padded
bucket through the port's ``handle_batch`` answers what ``handle_query``
answers.
"""

import datetime as dt
import json
import threading
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import predictionio_tpu.resilience as jax_resilience
import predictionio_tpu_torch.resilience as port_resilience
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.serving import CacheConfig as JaxCacheConfig
from predictionio_tpu.workflow import load_engine_variant as jax_load_variant
from predictionio_tpu.workflow import serving as jax_serving
from predictionio_tpu_torch.controller.context import local_context
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.serving import CacheConfig
from predictionio_tpu_torch.workflow import load_engine_variant, run_train
from predictionio_tpu_torch.workflow import serving as port_serving

CPU = local_context("cpu")
VARIANT = {
    "id": "serve-eng",
    "version": "1",
    "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
    "datasource": {"params": {"appName": "serve-app"}},
    "algorithms": [{"name": "als", "params": {"rank": 8, "numIterations": 3, "lambda": 0.05, "seed": 5}}],
}
T0 = dt.datetime(2022, 3, 1, tzinfo=dt.timezone.utc)


def _rate_events(seed: int, n: int, users: int = 40, items: int = 70):
    rng = np.random.default_rng(seed)
    return [
        Event(event="rate", entity_type="user", entity_id=str(u), target_entity_type="item",
              target_entity_id=str(i), properties=DataMap({"rating": float((u * 7 + i) % 5 + 1)}),
              event_time=T0 + dt.timedelta(seconds=k))
        for k, (u, i) in enumerate(zip(rng.integers(0, users, n), rng.integers(0, items, n)))
    ]


@pytest.fixture()
def store(tmp_path, monkeypatch):
    """One base directory for both packages, 900 ratings, one trained
    instance; each package's resilience registry starts empty."""
    env = {"PIO_FS_BASEDIR": str(tmp_path / "base")}
    Storage.configure(env)
    JaxStorage.configure(env)
    for module in (jax_resilience, port_resilience):
        monkeypatch.setattr(module, "_stats_registry", weakref.WeakValueDictionary())
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="serve-app"))
        Storage.get_l_events().init(app_id)
        Storage.get_l_events().insert_batch(_rate_events(3, 900), app_id)
        first = run_train(load_engine_variant(VARIANT), CPU)
        yield {"app_id": app_id, "first": first}
    finally:
        Storage.configure(None)
        JaxStorage.configure(None)


def _services(**kw):
    """The JAX package's and the port's QueryService over the store."""
    jax_kw = dict(kw)
    if "cache" in kw:
        jax_kw["cache"] = JaxCacheConfig(**kw["cache"])
        kw = dict(kw, cache=CacheConfig(**kw["cache"]))
    if "plugins" in kw:
        jax_kw["plugins"], kw["plugins"] = kw["plugins"]
    if "feedback" in kw:
        jax_kw["feedback"] = jax_serving.FeedbackConfig(**kw["feedback"])
        kw["feedback"] = port_serving.FeedbackConfig(**kw["feedback"])
    jax_qs = jax_serving.QueryService(jax_load_variant(VARIANT), **jax_kw)
    port_qs = port_serving.QueryService(load_engine_variant(VARIANT), CPU, **kw)
    return jax_qs, port_qs


def _normalise(payload):
    """Times, ``startTime`` and ``prId`` out of a payload, recursively."""
    if isinstance(payload, dict):
        return {
            k: "<t>" if k in ("startTime", "lastReloadAt", "eventTime") else "<id>" if k == "prId" else _normalise(v)
            for k, v in payload.items()
        }
    if isinstance(payload, list):
        return [_normalise(v) for v in payload]
    return payload


def _call(qs, method, path, body=None, params=None, headers=None):
    resp = qs.dispatch(method, path, params or {}, body, headers=headers)
    return resp.status, _normalise(resp.body), dict(resp.headers or {})


def test_one_request_script_answers_alike(store):
    jax_qs, port_qs = _services(cache={"result_cache": True})
    stopped = {"jax": 0, "port": 0}
    for name, qs in (("jax", jax_qs), ("port", port_qs)):
        qs.stop_token = "tok-1"
        qs.stop_server = lambda n=name: stopped.__setitem__(n, stopped[n] + 1)
    status = port_qs.status_json()
    assert status.pop("device") == "cpu"
    assert _normalise(status) == _normalise(jax_qs.status_json())

    def second_instance():
        Storage.get_l_events().insert_batch(_rate_events(4, 200), store["app_id"])
        return run_train(load_engine_variant(VARIANT), CPU)

    def third_instance_without_blob():
        inst = run_train(load_engine_variant(VARIANT), CPU)
        Storage.get_model_data_models().delete(inst.id)
        return inst

    script = [
        ("GET", "/", None, None, None),
        ("POST", "/queries.json", {"user": "3", "num": 5}, None, None),
        ("POST", "/queries.json", {"user": "3", "num": 5}, None, None),  # a cache hit
        ("POST", "/queries.json", {"user": "11", "num": 10}, None, None),
        ("POST", "/queries.json", {"user": "nobody", "num": 4}, None, None),
        ("POST", "/queries.json", {"user": "3", "bogus": 1}, None, None),  # malformed
        ("POST", "/queries.json", None, None, None),
        ("GET", "/stats.json", None, None, None),
        ("POST", "/cache/invalidate.json", {"entityId": "3"}, None, None),
        ("POST", "/cache/invalidate.json", [{"entityType": "user", "entityId": "11"}], None, None),
        ("POST", "/queries.json", {"user": "3", "num": 5}, None, None),
        ("GET", "/stats.json", None, None, None),
        (second_instance, None, None, None, None),
        ("POST", "/reload", None, None, None),
        ("GET", "/", None, None, None),
        ("POST", "/queries.json", {"user": "11", "num": 10}, None, None),
        (third_instance_without_blob, None, None, None, None),
        ("POST", "/reload", None, None, None),  # degraded: 503
        ("GET", "/", None, None, None),
        ("POST", "/queries.json", {"user": "11", "num": 10}, None, None),
        ("GET", "/stats.json", None, None, None),
        ("POST", "/online/fold.json", None, None, None),
        ("POST", "/experiments/reward.json", {"event": "reward"}, None, None),
        ("GET", "/nope", None, None, None),
        ("GET", "/stop", None, None, None),
        ("GET", "/stop", None, {"token": "wrong"}, None),
        ("GET", "/stop", None, None, {"X-PIO-Stop-Token": "tok-1"}),
    ]
    answers = []
    for method, path, body, params, headers in script:
        if callable(method):
            method()
            continue
        jax_answer = _call(jax_qs, method, path, body, params, headers)
        port_answer = _call(port_qs, method, path, body, params, headers)
        if path == "/":
            port_answer[1].pop("device")
        assert port_answer == jax_answer, (method, path, body)
        answers.append(port_answer)
    assert stopped == {"jax": 1, "port": 1}
    by_path = [(a[0], a[1].get("degraded")) for a in answers if isinstance(a[1], dict)]
    assert (503, True) in by_path  # the degraded reload
    final = port_qs.status_json()
    assert final["degraded"] and "No model blob" in final["lastReloadError"] and final["generation"] == 2
    assert answers[1][1]["itemScores"] and answers[4][1] == {"itemScores": []}
    port_qs.close()


class Blocker(port_serving.EngineServerPlugin):
    plugin_type = "outputblocker"
    name = "blocker"

    def process(self, query, prediction, service):
        return dict(prediction, top=prediction["itemScores"][0]["item"] if prediction["itemScores"] else None)


class Sniffer(port_serving.EngineServerPlugin):
    name = "sniffer"

    def __init__(self):
        self.seen = []

    def process(self, query, prediction, service):
        self.seen.append(json.loads(json.dumps(prediction)))
        return {"ignored": True}  # a sniffer's return value is dropped


def _jax_twin(plugin):
    twin = type(type(plugin).__name__, (jax_serving.EngineServerPlugin,), dict(vars(type(plugin))))()
    twin.__dict__.update(vars(plugin))
    if isinstance(plugin, Sniffer):
        twin.seen = []
    return twin


def test_plugins_of_each_type_answer_alike(store):
    plugins = [Blocker(), Sniffer()]
    jax_plugins = [_jax_twin(p) for p in plugins]
    jax_qs, port_qs = _services(plugins=(jax_plugins, plugins))
    for body in ({"user": "3", "num": 5}, {"user": "nobody"}, {"user": "20", "num": 2}):
        jax_answer = _call(jax_qs, "POST", "/queries.json", body)
        port_answer = _call(port_qs, "POST", "/queries.json", body)
        assert port_answer == jax_answer
        assert "top" in port_answer[1] and "ignored" not in port_answer[1]
    assert plugins[1].seen == jax_plugins[1].seen and len(plugins[1].seen) == 3
    assert port_qs.status_json()["plugins"] == jax_qs.status_json()["plugins"] == [
        {"name": "blocker", "type": "outputblocker"}, {"name": "sniffer", "type": "outputsniffer"}
    ]
    port_qs.close()


class _StubEventServer(BaseHTTPRequestHandler):
    posted: list = []

    def log_message(self, *args):
        pass

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        type(self).posted.append((self.path, body))
        data = json.dumps({"eventId": body["eventId"]}).encode()
        self.send_response(201)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def _drained(qs, timeout_s=10.0) -> bool:
    import time

    deadline = time.monotonic() + timeout_s
    while qs._feedback_queue.unfinished_tasks:
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def test_feedback_posts_the_same_predict_events(store):
    _StubEventServer.posted = []
    server = ThreadingHTTPServer(("127.0.0.1", 0), _StubEventServer)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        jax_qs, port_qs = _services(feedback={"event_server_url": url, "access_key": "key-1"})
        bodies = ({"user": "3", "num": 5}, {"user": "nobody"}, {"user": "20", "num": 2})
        jax_answers = [jax_qs.dispatch("POST", "/queries.json", {}, b).body for b in bodies]
        assert _drained(jax_qs)
        jax_posted, _StubEventServer.posted = _StubEventServer.posted, []
        port_answers = [port_qs.dispatch("POST", "/queries.json", {}, b).body for b in bodies]
        assert _drained(port_qs)
        port_posted = _StubEventServer.posted
        assert [_normalise(a) for a in port_answers] == [_normalise(a) for a in jax_answers]
        assert len(port_posted) == len(jax_posted) == 3
        for (path, event), answer in zip(port_posted, port_answers):
            assert path == "/events.json?accessKey=key-1"
            assert event["eventId"] == f"pio_fb_{answer['prId']}" == f"pio_fb_{event['prId']}"
            assert event["entityId"] == answer["prId"] and event["properties"]["prediction"] == answer
        strip = lambda e: {k: v for k, v in e.items() if k not in ("eventId", "entityId", "prId", "eventTime")}
        assert [_normalise(strip(e)) for _, e in port_posted] == [_normalise(strip(e)) for _, e in jax_posted]
        stats = port_qs.stats_json()["feedback"]
        assert stats == jax_qs.stats_json()["feedback"] == {"sent": 3, "failed": 0, "dropped": 0}
        port_qs.close()
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("pin", [False, True], ids=["host", "pinned"])
def test_padded_bucket_answers_like_per_query(store, pin):
    """``handle_batch`` over a bucket of 8 (5 real queries, 3 padding
    copies of the first) equals per-query ``handle_query`` on the CPU, on
    host numpy and on pinned tensors: the same items in the same order,
    scores within 1e-6 relative (a batch scores with one GEMM, a query
    with a GEMV, so the last bits may differ); the padding slots answer
    ``(200, None)`` and count no query."""
    qs = port_serving.QueryService(load_engine_variant(VARIANT), CPU, cache=CacheConfig(pin_model=pin))
    try:
        _, model = qs._algo_model_pairs[0]
        assert isinstance(model.item_factors, np.ndarray) != pin
        bodies = [{"user": str(u), "num": n} for u, n in ((3, 5), (11, 10), (0, 1), (39, 7), (999, 4))]
        batch = qs.handle_batch(bodies + [bodies[0]] * 3, n_real=len(bodies))
        assert qs.query_count == len(bodies)
        assert batch[len(bodies):] == [(200, None)] * 3
        for body, (status, got) in zip(bodies, batch):
            want_status, want = qs.handle_query(body)
            assert status == want_status == 200
            assert [s["item"] for s in got["itemScores"]] == [s["item"] for s in want["itemScores"]]
            np.testing.assert_allclose(
                [s["score"] for s in got["itemScores"]], [s["score"] for s in want["itemScores"]], rtol=1e-6
            )
        assert got == {"itemScores": []}  # the unknown user
    finally:
        qs.close()


def test_profiler_routes_write_a_chrome_trace(store, tmp_path):
    """``/profiler/start`` and ``/profiler/stop`` drive ``torch.profiler``
    on the device thread (the JAX package's drive ``jax.profiler``): the
    stop writes a Chrome trace holding the query's ops; a second start or
    stop answers 409."""
    qs = port_serving.QueryService(load_engine_variant(VARIANT), CPU)
    try:
        started = qs.dispatch("POST", "/profiler/start", {}, {"logDir": str(tmp_path / "prof")})
        assert started.status == 200 and started.body["logDir"] == str(tmp_path / "prof")
        assert qs.dispatch("POST", "/profiler/start", {}, {}).status == 409
        assert qs.dispatch("POST", "/queries.json", {}, {"user": "3", "num": 5}).status == 200
        stopped = qs.dispatch("POST", "/profiler/stop", {}, None)
        assert stopped.status == 200
        with open(stopped.body["trace"]) as f:
            assert json.load(f)["traceEvents"]
        assert qs.dispatch("POST", "/profiler/stop", {}, None).status == 409
    finally:
        qs.close()
