"""The port's ``pio deploy`` / ``pio undeploy`` console on the CPU.

* ``deploy --device cpu --port 0`` with the batching, cache and feedback
  flags, as a subprocess: it answers queries through the micro-batcher
  (warmed with ``--batch-warmup-query``, so no bucket misses), the result
  cache and singleflight, posts one ``predict`` event per answered query
  to a stub event server, reports all of it on ``/stats.json``, and
  ``pio undeploy`` (the stop token from the base directory) stops it:
  exit 0 within 10 s.
* No deploy flag is refused any more: ``--aot`` and
  ``--compilation-cache-dir`` (ROADMAP queue 1 item 14) build the port's
  ``AotConfig`` (root ``<basedir>/fleet/aot``) and set the Inductor and
  Triton cache variables, and a replica's argv carries both;
  ``--shard-factors`` builds the ``CacheConfig`` the JAX console builds.
* The ``--explore*`` flags build the ``ExploreConfig`` the JAX console
  builds; ``--variants`` builds the router's ``SplitConfig`` as the JAX
  console does (both consoles' ``RouterService`` replaced by a recording
  stub); ``--replicas``, ``--router-only`` and ``--autoscale`` reach the
  console's ``_deploy_fleet`` (replaced by a recorder), and a replica's
  argv runs the port's console with the fleet's ``--device``.
* ``--ann*`` and ``--quantize int8`` build the ``AnnConfig`` and the
  ``CacheConfig`` the JAX console builds from the same command line
  (both consoles' ``QueryService`` replaced by a recording stub), and a
  ``deploy --device cpu --ann --quantize int8`` subprocess serves with
  them (``/stats.json`` ``ann`` and ``quant``, ``GET /`` ``quantize``).
* The ``--online*`` flags build the ``OnlineConfig`` the JAX console
  builds from the same command line, and ``--online`` on the sqlite event
  store fails the deploy with the JAX package's message.
"""

import dataclasses
import datetime as dt
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

import predictionio_tpu.tools.console as jax_console
import predictionio_tpu.workflow.serving as jax_serving
import predictionio_tpu_torch.tools.console as port_console
import predictionio_tpu_torch.workflow.serving as port_serving
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.online.follower import TailFollower as JaxTailFollower
from predictionio_tpu_torch.controller.context import local_context
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.tools.console import main
from predictionio_tpu_torch.workflow import load_engine_variant, run_train

ROOT = Path(__file__).resolve().parents[1]
ENGINE = {
    "id": "cli-eng",
    "version": "1",
    "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
    "datasource": {"params": {"appName": "cli-app"}},
    "algorithms": [{"name": "als", "params": {"rank": 8, "numIterations": 2, "lambda": 0.05, "seed": 2}}],
}


class _Events(BaseHTTPRequestHandler):
    posted: list = []

    def log_message(self, *args):
        pass

    def do_POST(self):
        type(self).posted.append(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
        self.send_response(201)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def _post(url: str, body) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_deploy_with_serving_flags_then_undeploy(tmp_path):
    base = tmp_path / "base"
    Storage.configure({"PIO_FS_BASEDIR": str(base)})
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="cli-app"))
        Storage.get_l_events().init(app_id)
        rng = np.random.default_rng(4)
        t0 = dt.datetime(2022, 2, 1, tzinfo=dt.timezone.utc)
        Storage.get_l_events().insert_batch(
            [
                Event(event="rate", entity_type="user", entity_id=str(u), target_entity_type="item",
                      target_entity_id=str(i), properties=DataMap({"rating": float(i % 5 + 1)}),
                      event_time=t0 + dt.timedelta(seconds=k))
                for k, (u, i) in enumerate(zip(rng.integers(0, 30, 600), rng.integers(0, 50, 600)))
            ],
            app_id,
        )
        engine_json = tmp_path / "engine.json"
        engine_json.write_text(json.dumps(ENGINE))
        run_train(load_engine_variant(str(engine_json)), local_context("cpu"))
    finally:
        Storage.configure(None)
    _Events.posted = []
    events = ThreadingHTTPServer(("127.0.0.1", 0), _Events)
    threading.Thread(target=events.serve_forever, daemon=True).start()
    env = dict(os.environ, PIO_FS_BASEDIR=str(base), PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.console", "deploy",
         "--engine-json", str(engine_json), "--ip", "127.0.0.1", "--port", "0", "--device", "cpu",
         "--batching", "--max-batch-size", "8", "--max-batch-delay-ms", "2",
         "--batch-warmup-query", '{"user": "0", "num": 4}',
         "--result-cache", "--coalesce", "--pin-model",
         "--feedback", "--event-server-ip", "127.0.0.1",
         "--event-server-port", str(events.server_address[1]), "--accesskey", "k-1"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("Bound port"), line or proc.stderr.read()
        port = int(line.split()[-1])
        url = f"http://127.0.0.1:{port}"
        answers = [_post(url + "/queries.json", {"user": str(u), "num": 5}) for u in (1, 2, 1, 3)]
        assert all(status == 200 and len(body["itemScores"]) == 5 for status, body in answers)
        assert answers[0][1] == answers[2][1]  # the second is a cache hit
        status = _get(url + "/")
        assert status["batching"] and status["caching"] and status["device"] == "cpu"
        stats = _get(url + "/stats.json")
        assert stats["batcher"]["bucketMisses"] == 0 and stats["batcher"]["warmedBuckets"] == [1, 2, 4, 8]
        assert stats["cache"]["hits"] == 1 and stats["cache"]["bytesPinned"] == (30 + 50) * 8 * 4
        deadline = time.monotonic() + 10
        while len(_Events.posted) < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sorted(e["prId"] for e in _Events.posted) == sorted({b["prId"] for _, b in answers})
        assert all(e["event"] == "predict" and e["eventId"] == "pio_fb_" + e["prId"] for e in _Events.posted)
        Storage.configure({"PIO_FS_BASEDIR": str(base)})  # where the deploy wrote its stop token
        try:
            assert main(["undeploy", "--port", str(port)]) == 0
        finally:
            Storage.configure(None)
        t0 = time.monotonic()
        assert proc.wait(timeout=10) == 0
        assert time.monotonic() - t0 < 10
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        events.shutdown()
        events.server_close()


@pytest.mark.parametrize(
    "flags, item",
    [
        (["--aot"], "item 14"),
        (["--compilation-cache-dir", "x"], "item 14"),
    ],
)
def test_flags_of_later_tiers_are_refused(flags, item, capsys, monkeypatch):
    """The flags refused until ROADMAP queue 1 ``item`` landed are served
    now: nothing is left to refuse, and the deploy goes on to read its
    engine.json (missing here), so it fails on that instead."""
    _scrub_cache_env(monkeypatch)
    assert port_console._WAITING_DEPLOY_FLAGS == {}
    assert main(["deploy", "--engine-json", "nowhere.json", "--device", "cpu"] + flags) == 1
    err = capsys.readouterr().err
    assert "not in the port yet" not in err and item not in err and "nowhere.json" in err


def _scrub_cache_env(monkeypatch) -> None:
    """No compilation cache variable set, and what a case sets undone."""
    for name in ("PIO_COMPILATION_CACHE_DIR", "TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)


@pytest.mark.parametrize("flags", [["--aot"], ["--aot", "--pin-model", "--batching"]])
def test_aot_builds_the_ports_aot_config(flags, tmp_path, monkeypatch):
    """``deploy --aot`` hands the query server the port's ``AotConfig``,
    enabled, its root ``<basedir>/fleet/aot`` (the JAX console's layout)."""
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(ENGINE))
    _scrub_cache_env(monkeypatch)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    built = {}

    def record(*args, **kwargs):
        built.update(kwargs)
        raise _Built("torch")

    monkeypatch.setattr(port_serving, "QueryService", record)
    Storage.configure(None)
    try:
        assert main(["deploy", "--engine-json", str(engine_json), "--device", "cpu"] + flags) == 1
    finally:
        Storage.configure(None)
    aot = built["aot"]
    assert type(aot).__module__ == "predictionio_tpu_torch.workflow.aot"
    assert aot.enabled and aot.active and aot.root == str(tmp_path / "base" / "fleet" / "aot")


def test_deploy_without_aot_builds_no_aot_config(tmp_path, monkeypatch):
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(ENGINE))
    _scrub_cache_env(monkeypatch)
    built = {}

    def record(*args, **kwargs):
        built.update(kwargs)
        raise _Built("torch")

    monkeypatch.setattr(port_serving, "QueryService", record)
    assert main(["deploy", "--engine-json", str(engine_json), "--device", "cpu"]) == 1
    assert built["aot"] is None


@pytest.mark.parametrize("how", ["flag", "env", "default", "off"])
def test_compilation_cache_dir_sets_the_inductor_and_triton_caches(how, tmp_path, monkeypatch):
    """``--compilation-cache-dir DIR``, then ``PIO_COMPILATION_CACHE_DIR``,
    then ``<basedir>/torch_cache``: ``TORCHINDUCTOR_CACHE_DIR`` and
    ``TRITON_CACHE_DIR`` under it; ``0`` sets neither."""
    _scrub_cache_env(monkeypatch)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    monkeypatch.setattr(port_serving, "QueryService", lambda *a, **k: (_ for _ in ()).throw(_Built("torch")))
    flags, want = [], None
    if how == "flag":
        flags, want = ["--compilation-cache-dir", str(tmp_path / "dir")], tmp_path / "dir"
    elif how == "env":
        monkeypatch.setenv("PIO_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
        want = tmp_path / "env"
    elif how == "default":
        want = tmp_path / "base" / "torch_cache"
    else:
        flags = ["--compilation-cache-dir", "0"]
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(ENGINE))
    Storage.configure(None)
    try:
        assert main(["deploy", "--engine-json", str(engine_json), "--device", "cpu"] + flags) == 1
    finally:
        Storage.configure(None)
    if want is None:
        assert "TORCHINDUCTOR_CACHE_DIR" not in os.environ and "TRITON_CACHE_DIR" not in os.environ
    else:
        assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(want / "inductor")
        assert os.environ["TRITON_CACHE_DIR"] == str(want / "triton")


def test_replica_argv_carries_aot_and_the_cache_dir():
    """``pio deploy --replicas N --aot --compilation-cache-dir DIR``: every
    replica boots from the artifacts, with the same cache."""
    args = port_console.build_parser().parse_args(
        ["deploy", "--replicas", "2", "--device", "cpu", "--aot", "--compilation-cache-dir", "/cache"])
    argv = port_console._replica_argv(args, "r0", "/reg")
    assert "--aot" in argv and argv[argv.index("--compilation-cache-dir") + 1] == "/cache"
    plain = port_console._replica_argv(port_console.build_parser().parse_args(["deploy", "--replicas", "2"]),
                                       "r0", "/reg")
    assert "--aot" not in plain and "--compilation-cache-dir" not in plain


class _Built(Exception):
    pass


@pytest.mark.parametrize(
    "flags",
    [
        ["--shard-factors"],
        ["--shard-factors", "--pin-model", "--result-cache"],
        ["--shard-factors", "--quantize", "int8"],
    ],
)
def test_shard_factors_builds_the_jax_consoles_cache_config(flags, tmp_path, monkeypatch):
    """``--shard-factors`` is served now: both consoles parse one command
    line into the same ``CacheConfig`` (``shard_factors`` on), each
    one's QueryService replaced by a stub that records it."""
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(ENGINE))
    built = {}

    def stub(name):
        def record(*args, **kwargs):
            built[name] = kwargs.get("cache")
            raise _Built(name)
        return record

    monkeypatch.setattr(jax_serving, "QueryService", stub("jax"))
    monkeypatch.setattr(port_serving, "QueryService", stub("torch"))
    argv = ["deploy", "--engine-json", str(engine_json)] + flags
    assert jax_console.main(argv) == 1 and main(argv + ["--device", "cpu"]) == 1
    jax_config, port_config = built["jax"], built["torch"]
    assert type(port_config).__module__ == "predictionio_tpu_torch.serving.cache"
    assert port_config.shard_factors is True and port_config.enabled
    assert dataclasses.asdict(port_config) == dataclasses.asdict(jax_config)


@pytest.mark.parametrize(
    "flags",
    [
        ["--explore", "epsilon"],
        ["--explore", "thompson", "--explore-seed", "3", "--explore-reward-event", "buy"],
        ["--explore", "epsilon", "--explore-epsilon", "0.25", "--replica-id", "r1"],
        ["--explore-epsilon", "0.5"],  # without --explore: no config
    ],
)
def test_explore_flags_build_the_jax_consoles_config(flags, tmp_path, monkeypatch):
    """Both consoles parse one command line; each one's QueryService is
    replaced by a stub that records its ``explore`` and ``replica_id``
    arguments and stops the deploy there."""
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(ENGINE))
    built = {}

    def stub(name):
        def record(*args, **kwargs):
            built[name] = (kwargs.get("explore"), kwargs.get("replica_id"))
            raise _Built(name)
        return record

    monkeypatch.setattr(jax_serving, "QueryService", stub("jax"))
    monkeypatch.setattr(port_serving, "QueryService", stub("torch"))
    argv = ["deploy", "--engine-json", str(engine_json)] + flags
    assert jax_console.main(argv) == 1 and main(argv + ["--device", "cpu"]) == 1
    (jax_config, jax_rid), (port_config, port_rid) = built["jax"], built["torch"]
    assert port_rid == jax_rid == ("r1" if "--replica-id" in flags else None)
    if "--explore" not in flags:
        assert jax_config is None and port_config is None
        return
    assert type(port_config).__module__ == "predictionio_tpu_torch.experiments.explore"
    assert dataclasses.asdict(port_config) == dataclasses.asdict(jax_config) and port_config.enabled


@pytest.mark.parametrize("spec", ["control:1,treatment:1", "a:2,b:1,c"])
def test_variants_build_the_jax_consoles_split(spec, tmp_path, monkeypatch):
    """``--replicas 2 --variants SPEC`` through both consoles: each one's
    ``RouterService`` is replaced by a stub that records its ``split``
    and stops the fleet before any replica is spawned."""
    import predictionio_tpu.fleet as jax_fleet
    import predictionio_tpu_torch.fleet as port_fleet

    built = {}

    def stub(name):
        def record(*args, **kwargs):
            built[name] = kwargs.get("split")
            raise _Built(name)
        return record

    monkeypatch.setattr(jax_fleet, "RouterService", stub("jax"))
    monkeypatch.setattr(port_fleet, "RouterService", stub("torch"))
    argv = ["deploy", "--engine-json", "nowhere.json", "--replicas", "2", "--variants", spec]
    JaxStorage.configure({"PIO_FS_BASEDIR": str(tmp_path / "jax")})
    Storage.configure({"PIO_FS_BASEDIR": str(tmp_path / "torch")})
    try:
        assert jax_console.main(argv) == 1 and main(argv + ["--device", "cpu"]) == 1
    finally:
        JaxStorage.configure(None)
        Storage.configure(None)
    jax_split, port_split = built["jax"], built["torch"]
    assert type(port_split).__module__ == "predictionio_tpu_torch.experiments.split"
    assert dataclasses.asdict(port_split.config) == dataclasses.asdict(jax_split.config)
    assert port_split.variant_names() == jax_split.variant_names()


@pytest.mark.parametrize(
    "flags, want",
    [
        (["--replicas", "2"], {"replicas": 2, "router_only": False, "autoscale": ""}),
        (["--router-only", "--endpoint-registry", "shared"], {"replicas": 0, "router_only": True,
                                                               "endpoint_registry": "shared"}),
        (["--replicas", "1", "--autoscale", "1:3", "--scale-up-qps", "80"], {"replicas": 1, "autoscale": "1:3",
                                                                           "scale_up_qps": 80.0}),
        (["--replicas", "3", "--variants", "a,b", "--hedge-ms", "5"], {"replicas": 3, "variants": "a,b",
                                                                      "hedge_ms": 5.0}),
    ],
)
def test_fleet_flags_reach_deploy_fleet(flags, want, monkeypatch):
    seen = []
    monkeypatch.setattr(port_console, "_deploy_fleet", lambda args: seen.append(args) or 0)
    assert main(["deploy", "--engine-json", "nowhere.json", "--device", "cpu"] + flags) == 0
    (args,) = seen
    assert {key: getattr(args, key) for key in want} == want and args.device == "cpu"


def test_replica_argv_runs_the_ports_console_with_the_fleets_device():
    args = port_console.build_parser().parse_args(
        ["deploy", "--engine-json", "e.json", "--device", "cpu", "--replicas", "2", "--variants", "a,b",
         "--batching", "--explore", "thompson", "--port", "8100", "--lease-ttl-s", "2"])
    argv = port_console._replica_argv(args, "r1", "/reg")
    assert argv[:3] == ["-m", "predictionio_tpu_torch.tools.console", "deploy"]
    pairs = dict(zip(argv[3:], argv[4:]))
    assert pairs["--device"] == "cpu" and pairs["--explore"] == "thompson" and "--batching" in argv
    assert pairs["--port"] == "0" and pairs["--replica-id"] == "r1" and pairs["--announce-dir"] == "/reg"
    assert pairs["--lease-ttl-s"] == "2.0"
    assert "--replicas" not in argv and "--variants" not in argv
    default = port_console._replica_argv(port_console.build_parser().parse_args(["deploy", "--replicas", "2"]),
                                         "r0", "/reg")
    assert "--device" not in default  # the default, the card, stays the default


@pytest.mark.parametrize(
    "flags",
    [
        ["--ann"],
        ["--ann-nprobe", "4"],  # without --ann: no config
        ["--quantize", "int8"],
        ["--ann", "--ann-seed", "3"],
        ["--ann", "--ann-nlist", "16", "--ann-nprobe", "4", "--ann-kmeans-iters", "2", "--quantize", "int8",
         "--pin-model"],
    ],
)
def test_ann_and_quantize_flags_build_the_jax_consoles_configs(flags, tmp_path, monkeypatch):
    """Both consoles parse one command line; each one's QueryService is
    replaced by a stub that records its ``ann`` and ``cache`` arguments
    and stops the deploy there."""
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(ENGINE))
    built = {}

    def stub(name):
        def record(*args, **kwargs):
            built[name] = (kwargs.get("ann"), kwargs.get("cache"))
            raise _Built(name)
        return record

    monkeypatch.setattr(jax_serving, "QueryService", stub("jax"))
    monkeypatch.setattr(port_serving, "QueryService", stub("torch"))
    argv = ["deploy", "--engine-json", str(engine_json)] + flags
    assert jax_console.main(argv) == 1 and main(argv + ["--device", "cpu"]) == 1
    (jax_ann, jax_cache), (port_ann, port_cache) = built["jax"], built["torch"]
    if "--ann" not in flags:
        assert jax_ann is None and port_ann is None
    else:
        assert type(port_ann).__module__ == "predictionio_tpu_torch.serving.ann"
        assert dataclasses.asdict(port_ann) == dataclasses.asdict(jax_ann)
    if "--quantize" not in flags:
        assert jax_cache is None and port_cache is None
    else:
        assert type(port_cache).__module__ == "predictionio_tpu_torch.serving.cache"
        assert dataclasses.asdict(port_cache) == dataclasses.asdict(jax_cache)
        assert port_cache.quantize == "int8"


def test_deploy_with_ann_and_int8_serves(tmp_path):
    """``pio deploy --device cpu --ann --quantize int8`` answers queries
    from an int8 IVF index and reports both tiers."""
    base = tmp_path / "base"
    Storage.configure({"PIO_FS_BASEDIR": str(base)})
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="cli-app"))
        Storage.get_l_events().init(app_id)
        rng = np.random.default_rng(5)
        Storage.get_l_events().insert_batch(
            [Event(event="rate", entity_type="user", entity_id=str(u), target_entity_type="item",
                   target_entity_id=str(i), properties=DataMap({"rating": float(i % 5 + 1)}))
             for u, i in zip(rng.integers(0, 30, 600), rng.integers(0, 50, 600))],
            app_id,
        )
        engine_json = tmp_path / "engine.json"
        engine_json.write_text(json.dumps(ENGINE))
        run_train(load_engine_variant(str(engine_json)), local_context("cpu"))
    finally:
        Storage.configure(None)
    env = dict(os.environ, PIO_FS_BASEDIR=str(base), PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.console", "deploy",
         "--engine-json", str(engine_json), "--ip", "127.0.0.1", "--port", "0", "--device", "cpu",
         "--ann", "--ann-nlist", "4", "--ann-nprobe", "2", "--quantize", "int8", "--batching"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("Bound port"), line or proc.stderr.read()
        url = f"http://127.0.0.1:{int(line.split()[-1])}"
        answers = [_post(url + "/queries.json", {"user": str(u), "num": 5}) for u in (1, 2, 3)]
        assert all(status == 200 and len(body["itemScores"]) == 5 for status, body in answers)
        status = _get(url + "/")
        assert status["quantize"] == "int8" and status["ann"] is True
        assert set(status["bytesPinnedByDtype"]) == {"int8", "scalesFloat32"}
        stats = _get(url + "/stats.json")
        assert stats["cache"]["bytesPinned"] == (30 + 50) * (8 + 4)
        assert stats["ann"]["nlist"] == 4 and stats["ann"]["cacheMode"] == "ann[nlist=4,nprobe=2]+qint8"
        model = stats["ann"]["models"][0]
        assert model["quantized"] is True and model["queries"] == 3 and model["nprobe"] == 2
        assert stats["quant"]["dtype"] == "int8" and stats["quant"]["models"][0]["bytesSaved"] > 0
        assert _post(url + "/reload", {})[0] == 200
        assert _get(url + "/stats.json")["generation"] == 2
    finally:
        proc.terminate()
        proc.wait(timeout=30)


@pytest.mark.parametrize(
    "flags",
    [
        ["--online"],
        ["--online", "--online-interval-s", "0.25", "--online-batch", "2048"],
        ["--online", "--online-algos", "als, twotower,", "--online-prior-weight", "0", "--online-from-start"],
        ["--online-interval-s", "0.5"],  # without --online: no config
    ],
)
def test_online_flags_build_the_jax_consoles_config(flags, tmp_path, monkeypatch):
    """Both consoles parse one command line; each one's QueryService is
    replaced by a stub that records its ``online`` argument and stops
    the deploy there."""
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(ENGINE))
    built = {}

    def stub(name):
        def record(*args, **kwargs):
            built[name] = kwargs.get("online")
            raise _Built(name)
        return record

    monkeypatch.setattr(jax_serving, "QueryService", stub("jax"))
    monkeypatch.setattr(port_serving, "QueryService", stub("torch"))
    argv = ["deploy", "--engine-json", str(engine_json)] + flags
    assert jax_console.main(argv) == 1 and main(argv + ["--device", "cpu"]) == 1
    jax_config, port_config = built["jax"], built["torch"]
    if "--online" not in flags:
        assert jax_config is None and port_config is None
        return
    assert type(port_config).__module__ == "predictionio_tpu_torch.online.types"
    assert dataclasses.asdict(port_config) == dataclasses.asdict(jax_config)


def test_online_on_the_sqlite_store_fails_with_the_jax_message(tmp_path, capsys):
    base = tmp_path / "base"
    Storage.configure({"PIO_FS_BASEDIR": str(base)})
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="cli-app"))
        Storage.get_l_events().init(app_id)
        Storage.get_l_events().insert_batch(
            [Event(event="rate", entity_type="user", entity_id=str(u % 7), target_entity_type="item",
                   target_entity_id=str(u % 11), properties=DataMap({"rating": float(u % 5 + 1)}))
             for u in range(80)],
            app_id,
        )
        engine_json = tmp_path / "engine.json"
        engine_json.write_text(json.dumps(ENGINE))
        run_train(load_engine_variant(str(engine_json)), local_context("cpu"))
        capsys.readouterr()
        assert main(["deploy", "--engine-json", str(engine_json), "--device", "cpu", "--online"]) == 1
        err = capsys.readouterr().err
        JaxStorage.configure({"PIO_FS_BASEDIR": str(base)})
        try:
            with pytest.raises(Exception) as jax_error:
                JaxTailFollower("cli-app")
        finally:
            JaxStorage.configure(None)
    finally:
        Storage.configure(None)
    assert type(jax_error.value).__name__ == "FollowerUnsupportedError"
    assert err.strip() == f"ERROR: {jax_error.value}"
