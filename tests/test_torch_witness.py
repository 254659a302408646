"""The port's lock witness and its crosscheck
(``predictionio_tpu_torch/analysis/witness.py``, ``lock_witness.py``)
against the cases of ``tests/test_witness.py`` and
``tests/test_lock_witness.py``.

The reference's cases that take their locks from scratch modules under a
given root, their static programs from fixture sources, or only the
classifier run again on the port's classes: the modules' globals and the
``predictionio_tpu.analysis`` entries of ``sys.modules`` rebound to the
port's. The cases that drive real workloads or the console are written
here for the port: its fsync protocol (a default-rooted witness records
the port's frames only, so a root is given), its fleet and its
partitioned ingest (every witnessed edge mapped to one static lock of the
port's package and found in its static digraph), and ``pio tsan`` and
``pio lint --witness`` through the port's console.
"""

from __future__ import annotations

import importlib
import inspect
import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest

import predictionio_tpu_torch.analysis as port_analysis
from predictionio_tpu_torch.analysis import witness as port_witness
from predictionio_tpu_torch.analysis.lock_witness import (
    FsyncWitness,
    crosscheck,
    run_with_lock_witness,
)
from tests import test_lock_witness as ref_lock
from tests import test_witness as ref_witness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = ("callgraph", "engine", "manifest", "rules_program", "witness", "lock_witness")
JAX = {name: importlib.import_module(f"predictionio_tpu.analysis.{name}") for name in MODULES}
PORT = {name: importlib.import_module(f"predictionio_tpu_torch.analysis.{name}") for name in MODULES}

#: the reference's cases written for the port below: they drive the JAX
#: package's workloads or console, or a default-rooted fsync witness
WRITTEN_FOR_THE_PORT = {
    "test_fsync_witness_records_protocol",
    "test_fleet_workload_every_dynamic_edge_is_a_static_edge",
    "test_partitioned_ingest_workload_has_no_lock_gaps",
    "test_pio_lint_witness_cli",
    "test_pio_tsan_cli_smoke",
}
CASES = [
    (mod, name)
    for mod in (ref_witness, ref_lock)
    for name, fn in sorted(vars(mod).items())
    if name.startswith("test_") and inspect.isfunction(fn) and name not in WRITTEN_FOR_THE_PORT
]


def _twins() -> dict:
    out = {}
    for name, mod in JAX.items():
        for attr, value in vars(mod).items():
            if isinstance(value, (int, float, str, type(None))) or attr.startswith("__"):
                continue
            if hasattr(PORT[name], attr):
                out.setdefault(id(value), getattr(PORT[name], attr))
    return out


@pytest.fixture
def on_port(monkeypatch):
    """The reference test modules rebound to the port's analysis package."""
    twins = _twins()
    for mod in (ref_witness, ref_lock):
        for name, value in list(vars(mod).items()):
            twin = twins.get(id(value))
            if twin is not None and not name.startswith("__"):
                monkeypatch.setattr(mod, name, twin)
    monkeypatch.setitem(sys.modules, "predictionio_tpu.analysis", port_analysis)
    for name in MODULES:
        monkeypatch.setitem(sys.modules, f"predictionio_tpu.analysis.{name}", PORT[name])


@pytest.fixture()
def witness(tmp_path):
    """``tests/test_witness.py``'s fixture, on the port's class."""
    w = port_witness.LockWitness(root=str(tmp_path), long_hold_ms=20.0)
    w.install()
    yield w
    w.uninstall()


@pytest.mark.parametrize("mod, case", CASES, ids=[f"{m.__name__.split('.')[-1]}::{c}" for m, c in CASES])
def test_reference_case_on_the_port(mod, case, on_port, request):
    fn = getattr(mod, case)
    fn(**{p: request.getfixturevalue(p) for p in inspect.signature(fn).parameters})


def test_rebinding_reaches_the_port_classes(on_port):
    assert ref_witness.LockWitness is port_witness.LockWitness
    assert ref_lock.crosscheck is crosscheck
    assert ref_lock.FileContext is PORT["engine"].FileContext


# ---------------------------------------------------------------------------
# The port's scope: repo-allocated means a predictionio_tpu_torch frame
# ---------------------------------------------------------------------------


def test_default_witness_wraps_only_the_port_locks():
    """With the default root, a lock a test frame allocates stays raw and
    one the port's code allocates is wrapped under its static name."""
    from predictionio_tpu_torch.resilience.breaker import CircuitBreaker

    w = port_witness.LockWitness()
    w.install()
    try:
        mine = threading.Lock()
        breaker = CircuitBreaker(name="x")
    finally:
        w.uninstall()
    assert not isinstance(mine, port_witness._WitnessLock)
    assert isinstance(breaker._lock, (port_witness._WitnessLock, port_witness._WitnessRLock))
    assert breaker._lock._site == "CircuitBreaker._lock"


def test_static_side_is_the_port_package():
    """The witness's static program is the port's package: its lock ids are
    the port's, so a short name like ``QueryService._lock`` maps to one id
    (over the whole repository the JAX package's twin class would make
    every such name ambiguous)."""
    program = port_witness.build_program(REPO)
    paths = set(program.contexts)
    assert paths and all(p.startswith("predictionio_tpu_torch/") for p in paths)
    ids = {a.lock_id for fi in program.graph.functions.values() for a in fi.acquisitions}
    assert any(i.startswith("predictionio_tpu_torch.") for i in ids)
    assert not any(i.startswith("predictionio_tpu.") for i in ids)


def test_fsync_witness_records_protocol(tmp_path):
    """``test_lock_witness.test_fsync_witness_records_protocol`` on the
    port, with the repository as the root (this test's frames are the
    ones issuing the syscalls); a default-rooted witness records none of
    them."""
    outside = FsyncWitness()
    w = FsyncWitness(root=REPO)
    outside.install()
    w.install()
    try:
        good = tmp_path / "state.json"
        tmp = tmp_path / "state.json.tmp"
        with open(tmp, "w") as f:
            f.write("{}")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, good)
        dfd = os.open(tmp_path, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        bad = tmp_path / "torn.json"
        with open(str(bad) + ".tmp", "w") as f:
            f.write("{}")
        os.replace(str(bad) + ".tmp", bad)
    finally:
        w.uninstall()
        outside.uninstall()
    rep = w.report()
    assert rep["fsyncCalls"] >= 2
    by_dst = {r["dst"]: r for r in rep["renames"]}
    assert len(by_dst) == 2
    assert by_dst[os.path.realpath(good)]["srcFsynced"] and by_dst[os.path.realpath(good)]["dirFsynced"]
    assert not by_dst[os.path.realpath(bad)]["srcFsynced"]
    assert [r["dst"] for r in rep["renamesWithoutFsync"]] == [os.path.realpath(bad)]
    assert outside.report()["renames"] == [] and outside.report()["fsyncCalls"] == 0
    assert os.fsync.__module__ in ("posix", "nt", "os")
    assert os.replace.__module__ in ("posix", "nt", "os")


# ---------------------------------------------------------------------------
# Real workloads of the port under the composed witness
# ---------------------------------------------------------------------------


def _mapped(payload: dict) -> None:
    cc = payload["crosscheck"]
    assert cc["gaps"] == [], json.dumps(cc["gaps"], indent=2)
    assert cc["unwaivedStaticCycles"] == []
    assert payload["witness"]["inversions"] == []
    assert payload["ok"]


def test_fleet_workload_every_dynamic_edge_is_a_static_edge(tmp_path):
    """The port's replica state and model registry under the witness:
    the breaker's lock taken under the replica's is a witnessed edge that
    maps to one static lock each and is an edge of the port's static
    digraph; the registry publish runs the full durability protocol."""
    from predictionio_tpu_torch.fleet.registry import ModelRegistry
    from predictionio_tpu_torch.fleet.router import ReplicaState, RouterConfig

    def workload():
        r = ReplicaState("r0", "127.0.0.1", 1234, RouterConfig())
        r.note_success(generation=1)
        r.to_json()
        reg = ModelRegistry(str(tmp_path))
        reg.publish("inst-1", meta={"models": 1})
        return reg.current()

    record, payload = run_with_lock_witness(workload, waivers=[])
    assert record is not None and record.generation == 1
    witnessed = {(e["from"], e["to"]) for e in payload["witness"]["edges"]}
    assert ("ReplicaState._lock", "CircuitBreaker._lock") in witnessed
    _mapped(payload)
    # mapped, not set aside: both names are one lock of the port's package
    assert payload["crosscheck"]["unmappedEdges"] == []
    registry_path = os.path.realpath(tmp_path / "model-registry.json")
    renames = [r for r in payload["witness"]["fsync"]["renames"] if r["dst"] == registry_path]
    assert renames and all(r["srcFsynced"] and r["dirFsynced"] for r in renames)


def test_partitioned_ingest_workload_has_no_lock_gaps(tmp_path):
    """The port's partitioned pipeline (P appender threads) and a
    quorum-replicated append under the witness: no inversion, no gap, no
    unwaived static cycle."""
    from predictionio_tpu_torch.data.event import event_from_json
    from predictionio_tpu_torch.data.ingest import IngestPipeline
    from predictionio_tpu_torch.data.storage.partitioned import open_partitioned
    from predictionio_tpu_torch.data.storage.replication import ReplicatedEvents

    payload_nd = b"".join(
        json.dumps({"eventId": f"lw-{i}", "event": "rate", "entityType": "user", "entityId": f"u{i % 41}",
                    "properties": {"rating": 3.0}}).encode() + b"\n"
        for i in range(200)
    )

    def workload():
        ev = open_partitioned(str(tmp_path / "part"), partitions=4, segment_rows=64, fsync=False)
        ev.init(1)
        pipe = IngestPipeline(ev, app_id=1, chunk_rows=32)
        pipe.feed(payload_nd)
        stored = sum(r.stored for r in pipe.finish())
        ev.close()
        rep = ReplicatedEvents([str(tmp_path / f"replica_{r}") for r in range(2)], 2, segment_rows=64)
        rep.init(1)
        rep.insert_batch_dedup([
            event_from_json({"eventId": f"lwr-{i}", "event": "view", "entityType": "user", "entityId": "u1",
                             "targetEntityType": "item", "targetEntityId": f"i{i}",
                             "eventTime": f"2024-01-01T00:00:0{i}.000Z"})
            for i in range(5)
        ], 1)
        health = rep.replication_health()
        rep.close()
        return stored, health

    (stored, health), payload = run_with_lock_witness(workload, waivers=[])
    assert stored == 200
    assert health["quorumOk"] is True
    assert payload["witness"]["locks"], "the port's ingest allocated no witnessed lock"
    _mapped(payload)


# ---------------------------------------------------------------------------
# pio tsan and pio lint --witness through the port's console
# ---------------------------------------------------------------------------


def _console(args: list, **env_extra) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), **env_extra)
    return subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.tools.console", *args],
                          capture_output=True, text=True, timeout=180, env=env, cwd=REPO)


def test_pio_tsan_cli_smoke(tmp_path):
    """``pio tsan -- version`` runs the nested command under the witness
    and writes the joined report; a failing nested command exits 1 with
    its code in the report."""
    report_path = str(tmp_path / "tsan.json")
    proc = _console(["tsan", "--report", report_path, "--", "version"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = json.load(open(report_path))
    assert rec["ok"] is True and rec["exitCode"] == 0 and rec["command"] == ["version"]
    assert rec["witness"]["inversions"] == [] and rec["crosscheck"]["gaps"] == []
    assert rec["commandSeconds"] >= 0
    for cyc in rec["staticLockCycles"]:
        assert cyc["status"] in ("CONFIRMED", "PLAUSIBLE")
    bad = _console(["tsan", "--", "app", "show", "no-such-app"], PIO_FS_BASEDIR=str(tmp_path / "store"))
    assert bad.returncode == 1
    assert _console(["tsan"]).returncode == 1


_GAP_SOURCE = ref_lock._GAP_SOURCES["predictionio_tpu/m1.py"]


def test_pio_lint_witness_cli(tmp_path):
    """``pio lint --witness REPORT`` joins a recorded witness run against
    the static graph of ``--root``: an analyzer gap exits 1 and names both
    sides; an unreadable report is an internal error, exit 2."""
    pkg = tmp_path / "predictionio_tpu_torch"
    pkg.mkdir()
    (pkg / "m1.py").write_text(textwrap.dedent(_GAP_SOURCE))
    base = ["lint", "--root", str(tmp_path)]
    ok_report = tmp_path / "ok.json"
    ok_report.write_text(json.dumps({"witness": {
        "edges": [{"from": "A._a_lock", "to": "A._b_lock", "count": 2}], "inversions": [], "locks": {}}}))
    proc = _console(base + ["--witness", str(ok_report)])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 analyzer gap(s)" in proc.stdout
    gap_report = tmp_path / "gap.json"
    gap_report.write_text(json.dumps({"edges": [{"from": "C._c_lock", "to": "A._a_lock", "count": 5}]}))
    proc = _console(base + ["--witness", str(gap_report), "--format", "json"])
    assert proc.returncode == 1, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["ok"] is False
    assert doc["witnessCrosscheck"]["gaps"][0]["staticFrom"] == "predictionio_tpu_torch.m1.C._c_lock"
    missing = _console(base + ["--witness", str(tmp_path / "missing.json")])
    assert missing.returncode == 2 and "internal error" in missing.stderr
