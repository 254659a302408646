"""The port's compile and transfer witness
(``predictionio_tpu_torch/analysis/jit_witness.py``) and ``pio
jitwitness``.

* ``TestLedger`` and ``TestClassification`` of ``tests/test_jit_witness.py``
  on the port's functions, with the port's site paths and its ledger
  (``compile-budget-torch.json``).
* The witness on torch, on the CPU: a ``torch.compile``d function counted
  at its site (Dynamo's graph and Inductor's compile, none more on a
  second call with the same shapes), its answers and the process's
  compile counts equal to those of the same function without the
  witness; the host crossings recorded with their bytes through the
  witness's device predicate, patched here (the CPU has no device copy);
  the port's noted compiles (``nvcc``, ``aoti_load_package``) with their
  seconds; nesting and restoring.
* ``pio jitwitness -- train --device cpu`` through the port's console on
  a small engine, with its JSON report.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from predictionio_tpu_torch.analysis import jit_witness as jw
from predictionio_tpu_torch.analysis.engine import Finding
from predictionio_tpu_torch.tools import console

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = "tests/test_torch_jit_witness.py"


# ---------------------------------------------------------------------------
# The ledger (tests/test_jit_witness.py::TestLedger on the port)
# ---------------------------------------------------------------------------


class TestLedger:
    def test_check_budget_split(self):
        rep = {"compiles": {
            "predictionio_tpu_torch/ops/_build.py:build": {"count": 2},
            "predictionio_tpu_torch/ops/_build.py:other_fn": {"count": 2},
            "predictionio_tpu_torch/workflow/aot.py:load_runtime": {"count": 99},
            "predictionio_tpu_torch/workflow/mystery.py:serve": {"count": 1},
            "predictionio_tpu/ops/ivf.py:query_topk": {"count": 50},  # the JAX package's: not the port's site
            "tests/test_x.py:drive": {"count": 50},  # not a package site
        }}
        ledger = {"entries": [
            {"entrypoint": "predictionio_tpu_torch/ops/_build.py:build", "maxCompiles": 2},
            {"entrypoint": "predictionio_tpu_torch/ops/_build.py", "maxCompiles": 4},
            {"entrypoint": "predictionio_tpu_torch/workflow/aot.py:load_runtime", "maxCompiles": 18},
        ]}
        out = jw.check_budget(rep, ledger)
        assert out["checked"] == 4
        assert [v["entrypoint"] for v in out["violations"]] == ["predictionio_tpu_torch/workflow/aot.py:load_runtime"]
        assert out["violations"][0]["maxCompiles"] == 18
        assert [u["entrypoint"] for u in out["unbudgeted"]] == ["predictionio_tpu_torch/workflow/mystery.py:serve"]

    def test_path_level_budget_is_shared_across_functions(self):
        rep = {"compiles": {f"predictionio_tpu_torch/workflow/aot.py:f{i}": {"count": 3} for i in range(5)}}
        ledger = {"entries": [{"entrypoint": "predictionio_tpu_torch/workflow/aot.py", "maxCompiles": 8}]}
        out = jw.check_budget(rep, ledger)
        (v,) = out["violations"]
        assert v["entrypoint"] == "predictionio_tpu_torch/workflow/aot.py"
        assert v["compiles"] == 15 and v["maxCompiles"] == 8 and len(v["sites"]) == 5
        ledger["entries"].append({"entrypoint": "predictionio_tpu_torch/workflow/aot.py:f0", "maxCompiles": 4})
        assert jw.check_budget(rep, ledger)["violations"][0]["compiles"] == 12

    def test_the_port_ledger_budgets_every_compiling_site(self):
        """``compile-budget-torch.json`` names the port's sites that compile,
        each with a justification, and a kernel build on every request
        blows it."""
        ledger = jw.load_ledger(jw.default_ledger_path(REPO))
        entries = {e["entrypoint"]: e for e in ledger["entries"]}
        assert {
            "predictionio_tpu_torch/ops/_build.py:build",
            "predictionio_tpu_torch/workflow/aot.py:load_runtime",
            "predictionio_tpu_torch/workflow/aot.py:_compile",
        } <= set(entries)
        assert all(e["justification"].strip() and int(e["maxCompiles"]) >= 1 for e in entries.values())
        assert jw.prune_ledger(jw.default_ledger_path(REPO), REPO) == 0  # every entrypoint exists
        regressed = {"compiles": {"predictionio_tpu_torch/ops/_build.py:build": {"count": 40}}}
        assert jw.check_budget(regressed, ledger)["violations"]

    def test_prune_ledger(self, tmp_path):
        path = str(tmp_path / jw.LEDGER_NAME)
        jw.write_ledger(path, {"entries": [
            {"entrypoint": "predictionio_tpu_torch/ops/_build.py:build", "maxCompiles": 2, "justification": "keep"},
            {"entrypoint": "predictionio_tpu_torch/ops/topk.py", "maxCompiles": 8},
            {"entrypoint": "predictionio_tpu_torch/ops/gone.py:f", "maxCompiles": 4},
            {"entrypoint": "predictionio_tpu_torch/ops/_build.py:no_such_function", "maxCompiles": 4},
        ]})
        assert jw.prune_ledger(path, REPO) == 2
        kept = jw.load_ledger(path)["entries"]
        assert {e["entrypoint"] for e in kept} == {
            "predictionio_tpu_torch/ops/_build.py:build", "predictionio_tpu_torch/ops/topk.py"}
        assert kept[0]["justification"] == "keep"
        assert jw.prune_ledger(path, REPO) == 0

    def test_prune_via_pio_lint_cli(self, tmp_path, capsys):
        pkg = tmp_path / "predictionio_tpu_torch"
        pkg.mkdir()
        (pkg / "mod.py").write_text("def live():\n    return 1\n")
        jw.write_ledger(str(tmp_path / jw.LEDGER_NAME), {"entries": [
            {"entrypoint": "predictionio_tpu_torch/mod.py:live", "maxCompiles": 2},
            {"entrypoint": "predictionio_tpu_torch/gone.py:dead", "maxCompiles": 2},
        ]})
        assert console.main(["lint", "--root", str(tmp_path), "--prune-baseline"]) == 0
        assert "1 stale compile-budget entry pruned" in capsys.readouterr().out
        kept = jw.load_ledger(str(tmp_path / jw.LEDGER_NAME))
        assert [e["entrypoint"] for e in kept["entries"]] == ["predictionio_tpu_torch/mod.py:live"]


# ---------------------------------------------------------------------------
# CONFIRMED / PLAUSIBLE (tests/test_jit_witness.py::TestClassification)
# ---------------------------------------------------------------------------


class TestClassification:
    def _root_with(self, tmp_path, source: str) -> str:
        pkg = tmp_path / "predictionio_tpu_torch"
        pkg.mkdir()
        (pkg / "svc.py").write_text(source)
        return str(tmp_path)

    def test_confirmed_vs_plausible(self, tmp_path):
        root = self._root_with(tmp_path, "def serve(body):\n    x = body\n    return x\n\ndef fold(batch):\n"
                                         "    return batch\n")
        findings = [
            Finding("PIO306", "predictionio_tpu_torch/svc.py", 2, "retrace"),
            Finding("PIO307", "predictionio_tpu_torch/svc.py", 3, "transfer"),
            Finding("PIO308", "predictionio_tpu_torch/svc.py", 6, "percall"),
        ]
        rep = {
            "compiles": {"predictionio_tpu_torch/svc.py:serve": {"count": 5}},
            "transfers": {"predictionio_tpu_torch/svc.py:serve": {"count": 2, "bytes": 64}},
            "jitConstructions": {},
        }
        by_code = {o["code"]: o for o in jw.classify_findings(findings, rep, root)}
        assert by_code["PIO306"]["status"] == "CONFIRMED" and by_code["PIO306"]["witnessedEvents"] == 5
        assert by_code["PIO306"]["function"] == "serve"
        assert by_code["PIO307"]["status"] == "CONFIRMED"
        assert by_code["PIO308"]["status"] == "PLAUSIBLE" and by_code["PIO308"]["witnessedEvents"] == 0

    def test_single_compile_is_not_a_confirmed_retrace(self, tmp_path):
        root = self._root_with(tmp_path, "def serve(body):\n    return 1\n")
        findings = [Finding("PIO306", "predictionio_tpu_torch/svc.py", 2, "retrace")]
        rep = {"compiles": {"predictionio_tpu_torch/svc.py:serve": {"count": 1}}}
        assert jw.classify_findings(findings, rep, root)[0]["status"] == "PLAUSIBLE"

    def test_jitwitness_report_shape(self):
        """The port's tree ships PIO306-308-clean; the report's static
        pass is the port's package."""
        payload = jw.jitwitness_report({"compiles": {}, "transfers": {}, "jitConstructions": {}}, root=REPO)
        assert payload["ok"] is True
        assert payload["staticCompileFindings"] == []
        assert payload["ledgerEntries"] >= 3
        assert payload["budget"] == {"checked": 0, "violations": [], "unbudgeted": []}
        json.dumps(payload)


# ---------------------------------------------------------------------------
# The witness on torch (CPU)
# ---------------------------------------------------------------------------


def _score(x, y):
    z = (x @ y).relu()
    return z.sum(dim=0) * 2.0


def _fresh(fn, tag: str):
    """``fn`` with a code object of its own: Dynamo caches by code object,
    so each run compiles as a process's first would."""
    return type(fn)(fn.__code__.replace(co_name=f"{fn.__name__}_{tag}"), fn.__globals__, f"{fn.__name__}_{tag}")


def _compiled_run(tag: str) -> tuple:
    """Compile a fresh copy of ``_score``, call it twice with the same
    shapes; the answers and the process's compiles by kind over the run."""
    import torch._inductor.config as inductor_config

    before = jw.compile_counts()
    with inductor_config.patch(fx_graph_cache=False):
        fn = torch.compile(_fresh(_score, tag))
        gen = torch.Generator().manual_seed(0)
        x, y = torch.randn(8, 4, generator=gen), torch.randn(4, 3, generator=gen)
        first, second = fn(x, y), fn(x, y)
    after = jw.compile_counts()
    return (first, second), {k: after[k] - before[k] for k in after}


def test_torch_compile_counted_at_its_site_and_equal_without_the_witness():
    plain_out, plain_counts = _compiled_run("plain")
    (wit_out, wit_counts), rep = jw.run_with_jit_witness(lambda: _compiled_run("witnessed"), root=REPO)
    # the witness changes neither the answers nor what compiles
    assert all(torch.equal(a, b) for a, b in zip(plain_out, wit_out))
    assert wit_counts == plain_counts
    assert plain_counts["dynamo"] == 1 and plain_counts["inductor"] == 1
    # one Dynamo graph and one Inductor compile at the call's site, none on
    # the second call
    site = f"{HERE}:_compiled_run"
    assert set(rep["compiles"]) == {site}
    st = rep["compiles"][site]
    assert st["kinds"] == {"dynamo": 1, "inductor": 1} and st["count"] == 2
    assert st["totalCompileMs"] > 0
    assert rep["compileCounts"]["dynamo"] == 1 and rep["compileCounts"]["inductor"] == 1
    assert set(rep["jitConstructions"]) == {site}
    assert rep["jitConstructions"][site]["count"] == 1 and rep["jitConstructions"][site]["kinds"] == ["torch.compile"]
    assert rep["torchPatched"] is True


def test_transfers_recorded_with_bytes(monkeypatch):
    """Every host crossing of a device tensor, with its bytes; none for a
    host tensor, a device-side ``.to``, or when the witness is off."""
    on_device = set()
    monkeypatch.setattr(jw, "_on_device", lambda t: id(t) in on_device)
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    host = torch.ones(5)
    on_device.add(id(x))

    def work():
        x.cpu()
        x.to("cpu")
        x.to(device=torch.device("cpu"), dtype=torch.float64)
        x.to(torch.float64)  # a dtype change on the same device: no crossing
        x[0, 0].item()  # a new tensor: not marked
        x.tolist()
        x.numpy()
        host.cpu()
        with pytest.raises((AssertionError, RuntimeError)):
            torch.cuda.synchronize()  # recorded, then refused: no CUDA here

    _, rep = jw.run_with_jit_witness(work, root=REPO)
    (site,) = rep["transfers"]
    assert site == f"{HERE}:work"
    st = rep["transfers"][site]
    assert st["count"] == 6 and st["bytes"] == 5 * 48
    assert st["kinds"] == [".cpu()", '.to("cpu")', ".tolist()", ".numpy()", "torch.cuda.synchronize()"]
    assert rep["totalTransferBytes"] == 240
    x.cpu()  # uninstalled: no record anywhere
    assert jw.report() == {} or jw.active() is None


def test_noted_compiles_with_seconds_and_constructions():
    def work():
        with jw.compiling("nvcc"):
            time.sleep(0.01)
        with jw.compiling("aoti_load_package"):
            pass

    counts_before = jw.compile_counts()
    _, rep = jw.run_with_jit_witness(work, root=REPO)
    st = rep["compiles"][f"{HERE}:work"]
    assert st["kinds"] == {"nvcc": 1, "aoti_load_package": 1}
    assert st["totalCompileMs"] >= 10.0
    assert rep["jitConstructions"][f"{HERE}:work"]["kinds"] == ["aoti_load_package"]
    after = jw.compile_counts()
    assert after["nvcc"] == counts_before["nvcc"] + 1
    assert after["aoti_load_package"] == counts_before["aoti_load_package"] + 1


def test_uninstall_restores_and_nests():
    tensor_cpu, compile_fn, sync = torch.Tensor.cpu, torch.compile, torch.cuda.synchronize
    assert "cpu" not in torch.Tensor.__dict__
    outer = jw.JitWitness(root=REPO)
    outer.install()
    outer_cpu = torch.Tensor.cpu
    inner = jw.JitWitness(root=REPO)
    inner.install()
    assert torch.Tensor.cpu is not outer_cpu
    inner.uninstall()
    assert torch.Tensor.cpu is outer_cpu and outer.installed
    outer.uninstall()
    assert "cpu" not in torch.Tensor.__dict__ and "to" not in torch.Tensor.__dict__
    assert torch.Tensor.cpu is tensor_cpu and torch.compile is compile_fn and torch.cuda.synchronize is sync


# ---------------------------------------------------------------------------
# pio jitwitness through the port's console
# ---------------------------------------------------------------------------


def _console(args: list, **env_extra) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), **env_extra)
    return subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.tools.console", *args],
                          capture_output=True, text=True, timeout=300, env=env, cwd=REPO)


def test_pio_jitwitness_train_on_the_cpu(tmp_path):
    """``pio jitwitness --report R -- train --device cpu`` of a small
    engine: the train exits 0 under the witness, the report carries the
    command, its exit code and seconds, no budget violation and no
    compiled program constructed per call; without a command it exits 1."""
    store = {"PIO_FS_BASEDIR": str(tmp_path / "store")}
    events = tmp_path / "events.json"
    events.write_text("".join(
        json.dumps({"event": "rate", "entityType": "user", "entityId": f"u{u}", "targetEntityType": "item",
                    "targetEntityId": f"i{(u * 7 + j) % 23}", "properties": {"rating": float(1 + (u + j) % 5)}})
        + "\n" for u in range(30) for j in range(6)))
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps({
        "id": "jw", "version": "1", "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
        "datasource": {"params": {"appName": "jw"}},
        "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 2, "lambda": 0.1, "seed": 3}}],
    }))
    setup = ("from predictionio_tpu_torch.tools import console\n"
             "assert console.main(['app', 'new', 'jw']) == 0\n"
             f"assert console.main(['import', '--appname', 'jw', '--input', {str(events)!r}]) == 0\n")
    env = dict(os.environ, PYTHONPATH=REPO, **store)
    done = subprocess.run([sys.executable, "-c", setup], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
    report = tmp_path / "jw.json"
    proc = _console(["jitwitness", "--report", str(report), "--", "train", "--engine-json", str(engine_json),
                     "--device", "cpu"], **store)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rec = json.loads(report.read_text())
    assert rec["ok"] is True and rec["exitCode"] == 0
    assert rec["command"] == ["train", "--engine-json", str(engine_json), "--device", "cpu"]
    assert rec["commandSeconds"] > 0
    assert rec["budget"]["violations"] == []
    assert rec["witness"]["totalConstructions"] == 0 and rec["witness"]["torchPatched"] is True
    assert rec["witness"]["transfers"] == {}  # host tensors only on the CPU
    assert rec["staticCompileFindings"] == []
    assert console.main(["jitwitness"]) == 1
