"""The JAX package's fleet and A/B-split cases on both packages' classes,
and what the two packages share.

Every case of ``tests/test_fleet_router.py``, ``tests/test_fleet_elastic.py``
and ``tests/test_experiments_split.py`` runs twice, ``[jax]`` and
``[torch]`` (``tests/torch_package_swap.py``): under ``[torch]`` the
router, the ring, the registries, the supervisor, the autoscaler, the
split and the console's ``_promote_winner`` / ``_endpoint_registry_status``
are the port's. The fleet is stdlib-only, so the port's classes run the
reference's code on the port's ``resilience`` and ``serving.cache``.

Beside them: ``TrafficSplit.assign`` bit-equal to the reference's on
10,000 keys, the same ``HashRing`` owners and ``affinity_key``s, a model registry and endpoint
entries written by one package and read by the other, and a ``pio deploy
--replicas 2 --device cpu --port 0`` fleet of the port that answers
queries, loses none while one replica is SIGKILLed and respawned, and
stops on ``pio undeploy``.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import predictionio_tpu.fleet as jax_fleet
import predictionio_tpu.experiments.split as jax_split
import predictionio_tpu_torch.experiments.split as port_split
import predictionio_tpu_torch.fleet as port_fleet
import predictionio_tpu_torch.tools.commands as port_commands
import predictionio_tpu_torch.tools.console as port_console
import test_experiments_split as split_cases
import test_fleet_elastic as elastic_cases
import test_fleet_router as router_cases
from predictionio_tpu_torch.controller.context import local_context
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.workflow import load_engine_variant, run_train
from test_experiments_split import echo_replicas  # noqa: F401  (the cases' fixture)
from test_fleet_router import stubs  # noqa: F401  (the cases' fixture)
from torch_package_swap import PACKAGES

ROOT = Path(__file__).resolve().parents[1]

FLEET_NAMES = (
    "Autoscaler", "AutoscalerConfig", "EndpointRegistry", "FleetSupervisor", "HashRing", "ModelRegistry",
    "ReplicaSpec", "RouterConfig", "RouterService",
)
SPLIT_NAMES = ("SplitConfig", "TrafficSplit", "Variant")


@pytest.fixture(params=PACKAGES)
def package(request, monkeypatch):
    if request.param == "torch":
        for module in (router_cases, elastic_cases, split_cases):
            for name in FLEET_NAMES + SPLIT_NAMES:
                if hasattr(module, name):
                    source = port_split if name in SPLIT_NAMES else port_fleet
                    monkeypatch.setattr(module, name, getattr(source, name))
        for name, module in {
            "predictionio_tpu.fleet": port_fleet,
            "predictionio_tpu.experiments.split": port_split,
            "predictionio_tpu.tools.console": port_console,
            "predictionio_tpu.tools.commands": port_commands,
        }.items():
            monkeypatch.setitem(sys.modules, name, module)
    return request.param


@pytest.mark.usefixtures("package")
class TestHashRing(router_cases.TestHashRing):
    pass


@pytest.mark.usefixtures("package")
class TestRegistry(router_cases.TestRegistry):
    pass


@pytest.mark.usefixtures("package")
class TestRouting(router_cases.TestRouting):
    pass


@pytest.mark.usefixtures("package")
class TestRollingReload(router_cases.TestRollingReload):
    pass


@pytest.mark.usefixtures("package")
class TestBroadcastAndStatus(router_cases.TestBroadcastAndStatus):
    pass


@pytest.mark.usefixtures("package")
class TestSupervisor(router_cases.TestSupervisor):
    pass


@pytest.mark.usefixtures("package")
class TestEndpointRegistry(elastic_cases.TestEndpointRegistry):
    pass


@pytest.mark.usefixtures("package")
class TestRouterMembership(elastic_cases.TestRouterMembership):
    pass


@pytest.mark.usefixtures("package")
class TestStaleWhileDown(elastic_cases.TestStaleWhileDown):
    pass


@pytest.mark.usefixtures("package")
class TestAutoscaler(elastic_cases.TestAutoscaler):
    pass


@pytest.mark.usefixtures("package")
class TestSupervisorElasticity(elastic_cases.TestSupervisorElasticity):
    pass


@pytest.mark.usefixtures("package")
class TestEvalPromotion(elastic_cases.TestEvalPromotion):
    pass


@pytest.mark.usefixtures("package")
class TestStatusAggregation(elastic_cases.TestStatusAggregation):
    pass


@pytest.mark.usefixtures("package")
class TestSplitConfig(split_cases.TestSplitConfig):
    pass


@pytest.mark.usefixtures("package")
class TestAssignment(split_cases.TestAssignment):
    pass


@pytest.mark.usefixtures("package")
class TestRouterSplit(split_cases.TestRouterSplit):
    pass


def test_cases_run_on_the_ports_classes(package):
    from predictionio_tpu.fleet import FleetSupervisor
    from predictionio_tpu.tools.console import _promote_winner

    prefix = "predictionio_tpu." if package == "jax" else "predictionio_tpu_torch."
    for obj in (router_cases.RouterService, elastic_cases.Autoscaler, split_cases.TrafficSplit, FleetSupervisor,
                _promote_winner):
        assert obj.__module__.startswith(prefix)


# ------------------------------------------------------ shared across both
SPLITS = ["control:1,treatment:1", "a:2,b:1,c:0.5", "champion:0.9,challenger:0.1"]


@pytest.mark.parametrize("spec", SPLITS)
@pytest.mark.parametrize("salt", ["pio-exp", "exp-7"])
def test_assignment_is_bit_equal_to_the_reference(spec, salt):
    rng = np.random.default_rng(len(spec) + len(salt))
    keys = [f"s:{u}" for u in range(5000)] + [f"q:{rng.integers(0, 1 << 62)}-{i}" for i in range(5000)]
    ref = jax_split.TrafficSplit(jax_split.SplitConfig.parse(spec, salt=salt))
    port = port_split.TrafficSplit(port_split.SplitConfig.parse(spec, salt=salt))
    assert port.config.thresholds() == ref.config.thresholds()
    assert [port.assign(k) for k in keys] == [ref.assign(k) for k in keys]
    assert port.assign(None) == ref.assign(None)
    winner = port.variant_names()[-1]
    port.promote(winner)
    ref.promote(winner)
    assert [port.assign(k) for k in keys[:500]] == [ref.assign(k) for k in keys[:500]] == [winner] * 500


@pytest.mark.parametrize("members", [["r0", "r1"], ["r0", "r1", "r2", "r3"], [f"h{i}@host-{i}" for i in range(7)]])
def test_hash_ring_owners_are_equal(members):
    ref, port = jax_fleet.HashRing(members), port_fleet.HashRing(members)
    keys = [f"s:{u}" for u in range(3000)]
    assert [port.owner(k) for k in keys] == [ref.owner(k) for k in keys]
    assert [list(port.sequence(k, 3)) for k in keys[:300]] == [list(ref.sequence(k, 3)) for k in keys[:300]]


@pytest.mark.parametrize("scope_field", ["user", "item", None])
def test_affinity_key_is_the_references(scope_field):
    from predictionio_tpu.serving.cache import affinity_key as jax_affinity_key
    from predictionio_tpu_torch.serving.cache import affinity_key

    bodies = [{"user": "u1", "num": 4}, {"user": 7, "num": 4}, {"user": 7.5}, {"user": True, "num": 1},
              {"user": None, "item": "i2"}, {"num": 3, "user": "u1"}, {"items": ["a", "b"]}, [1, 2], "x", None,
              {"user": {"nested": 1}}]
    assert [affinity_key(b, scope_field) for b in bodies] == [jax_affinity_key(b, scope_field) for b in bodies]


@pytest.mark.parametrize("writer", PACKAGES)
def test_registries_written_by_one_package_read_by_the_other(writer, tmp_path):
    write, read = (jax_fleet, port_fleet) if writer == "jax" else (port_fleet, jax_fleet)
    models = write.ModelRegistry(str(tmp_path / "fleet"))
    models.publish("inst-1")
    models.publish("inst-2", meta={"source": "experiment_promotion", "variant": "treatment"})
    other = read.ModelRegistry(str(tmp_path / "fleet"))
    assert other.current().to_json() == models.current().to_json()
    assert [r.to_json() for r in other.history()] == [r.to_json() for r in models.history()]
    assert other.publish("inst-3").generation == 3
    endpoints = write.EndpointRegistry(str(tmp_path / "endpoints"), lease_ttl_s=60.0)
    endpoints.announce("r0", "127.0.0.1", 8123, generation=2)
    endpoints.announce("r1", "127.0.0.1", 8124, generation=2, now=time.time() - 600.0)
    live, expired, problems = read.EndpointRegistry(str(tmp_path / "endpoints"), lease_ttl_s=60.0).snapshot()
    assert [(e.replica_id, e.host, e.port, e.generation) for e in live] == [("r0", "127.0.0.1", 8123, 2)]
    assert [e.replica_id for e in expired] == ["r1"] and problems == []
    assert read.EndpointRegistry(str(tmp_path / "endpoints")).withdraw("r0")
    assert write.EndpointRegistry(str(tmp_path / "endpoints")).snapshot()[0] == []


# --------------------------------------------------- the port's fleet, CPU
ENGINE = {
    "id": "fleet-eng",
    "version": "1",
    "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
    "datasource": {"params": {"appName": "fleet-app"}},
    "algorithms": [{"name": "als", "params": {"rank": 8, "numIterations": 2, "lambda": 0.05, "seed": 2}}],
}


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def _query(url: str, user: str) -> int:
    req = urllib.request.Request(url + "/queries.json", data=json.dumps({"user": user, "num": 4}).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        body = json.loads(resp.read())
        return resp.status if len(body["itemScores"]) == 4 else -1


def _wait(predicate, timeout_s: float, what: str):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.1)
    raise AssertionError(f"timed out after {timeout_s} s waiting for {what}")


def test_replica_fleet_answers_survives_sigkill_and_undeploys(tmp_path):
    """``deploy --replicas 2 --device cpu --port 0``: the router answers
    through both replicas, a SIGKILLed replica costs no query while the
    supervisor respawns it into the ring, and ``pio undeploy`` stops the
    router and every replica."""
    base = tmp_path / "base"
    Storage.configure({"PIO_FS_BASEDIR": str(base)})
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="fleet-app"))
        Storage.get_l_events().init(app_id)
        rng = np.random.default_rng(6)
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
        [sys.executable, "-m", "predictionio_tpu_torch.tools.console", "deploy", "--engine-json", str(engine_json),
         "--ip", "127.0.0.1", "--port", "0", "--device", "cpu", "--replicas", "2", "--probe-interval-s", "0.1",
         "--lease-ttl-s", "3"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    state_path = base / "deployments"
    pids: list = []
    try:
        line = proc.stdout.readline()
        assert line.startswith("Bound port"), line
        port = int(line.split()[-1])
        url = f"http://127.0.0.1:{port}"

        def healthy() -> list:
            reps = _get(url + "/")["replicas"]
            return reps if len(reps) == 2 and all(r["healthy"] for r in reps) else []

        _wait(healthy, 120, "two healthy replicas in the ring")
        assert _get(url + "/")["role"] == "router"
        assert all(_query(url, str(u)) == 200 for u in range(12))
        state = json.loads((state_path / f"fleet-{port}.json").read_text())
        pids = [r["pid"] for r in state["replicas"]]
        assert len(pids) == 2 and all(r["alive"] for r in state["replicas"])

        failures: list = []
        answered = [0]
        stop = threading.Event()

        def client(c: int) -> None:
            u = c
            while not stop.is_set():
                try:
                    if _query(url, str(u % 30)) != 200:
                        failures.append(u)
                    answered[0] += 1
                except Exception as e:  # counted: the drill allows none
                    failures.append(repr(e))
                u += 4

        threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        os.kill(pids[0], signal.SIGKILL)

        def respawned() -> bool:
            doc = json.loads((state_path / f"fleet-{port}.json").read_text())
            rep = next(r for r in doc["replicas"] if r["id"] == state["replicas"][0]["id"])
            return rep["pid"] != pids[0] and rep["alive"] and bool(healthy())

        _wait(respawned, 120, "the killed replica's respawn back in the ring")
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not failures, failures[:5]
        assert answered[0] > 0
        pids = [r["pid"] for r in json.loads((state_path / f"fleet-{port}.json").read_text())["replicas"]]
        Storage.configure({"PIO_FS_BASEDIR": str(base)})  # where the router wrote its stop token
        try:
            assert port_console.main(["undeploy", "--port", str(port)]) == 0
        finally:
            Storage.configure(None)
        assert proc.wait(timeout=60) == 0
        for pid in pids:
            _wait(lambda: not _alive(pid), 30, f"replica pid {pid} to exit")
        assert not (state_path / f"fleet-{port}.json").exists()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        for pid in pids:
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie child of the (exited) router still answers kill(0)
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(") ")[-1][:1] != "Z"
    except OSError:
        return False
