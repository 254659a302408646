"""The port's pytest witness options (``tests/torch_witness_plugin.py``),
each in a pytest subprocess.

``--torch-lock-witness`` over the port's concurrency cases (the
``[torch]`` cases of ``tests/test_torch_microbatcher.py`` and
``tests/test_torch_online.py``), as ``tests/test_ci_guards.py``'s
``test_lock_witness_over_tier1_concurrency_suites`` runs the reference's
suites under ``--lock-witness``: a green exit inside 240 s, locks seen,
no inversion, every static cycle CONFIRMED or PLAUSIBLE, and every
witnessed lock order an edge of the port's static lock graph.
``--torch-jit-witness`` over a small test file of port calls: the report
exists and counts the host copies (on the CPU a test marks its tensors
as device tensors, as ``tests/test_torch_jit_witness.py`` does). The
plugin loaded with no option changes neither the exit code nor the
outcome and writes no report; both packages' lock options together are
a usage error.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PLUGIN = ("-p", "tests.torch_witness_plugin")

COPIES = textwrap.dedent('''
    import torch

    from predictionio_tpu_torch import convert
    from predictionio_tpu_torch.analysis import jit_witness


    def test_a_port_copy_to_the_host(monkeypatch):
        monkeypatch.setattr(jit_witness, "_on_device", lambda t: True)
        out = convert._host(torch.ones((4, 8)))
        assert out.shape == (4, 8)
''')


def pytest_run(args: list, env: dict, timeout: float) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", *args],
        cwd=ROOT, env=dict(os.environ, **env), capture_output=True, text=True, timeout=timeout,
    )


def test_lock_witness_over_the_ports_concurrency_cases(tmp_path):
    report = tmp_path / "lock.json"
    proc = pytest_run(
        ["tests/test_torch_microbatcher.py", "tests/test_torch_online.py", "-k", "torch", *PLUGIN,
         "--torch-lock-witness"],
        {"PIO_TORCH_LOCK_WITNESS_REPORT": str(report)}, timeout=240,
    )
    assert proc.returncode == 0, f"rc={proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-1000:]}"
    assert "torch-lock-witness:" in proc.stdout
    payload = json.loads(report.read_text())
    wit = payload["witness"]
    assert wit["locks"], "the witness saw no port lock allocations"
    assert {"OnlineRunner._cycle_lock", "TailFollower._lock"} <= set(wit["locks"])
    assert wit["inversions"] == [], wit["inversions"]
    assert payload["ok"] is True
    for cycle in payload["staticLockCycles"]:
        assert cycle["status"] in ("CONFIRMED", "PLAUSIBLE"), cycle
    cc = payload["crosscheck"]
    assert cc["gaps"] == [], json.dumps(cc["gaps"], indent=2)
    assert cc["unwaivedStaticCycles"] == [] and cc["staleWaivers"] == []
    assert cc["dynamicEdges"] > 0 and cc["unmappedEdges"] == []


def test_jit_witness_reports_the_copies_of_a_port_file(tmp_path):
    (tmp_path / "test_copies.py").write_text(COPIES)
    report = tmp_path / "jit.json"
    proc = pytest_run([str(tmp_path / "test_copies.py"), *PLUGIN, "--torch-jit-witness"],
                      {"PIO_TORCH_JIT_WITNESS_REPORT": str(report)}, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-1000:]
    assert "torch-jit-witness:" in proc.stdout
    payload = json.loads(report.read_text())
    wit = payload["witness"]
    assert wit["torchPatched"] is True
    sites = [site for site in wit["transfers"] if site.startswith("predictionio_tpu_torch/convert.py")]
    assert sites and wit["totalTransfers"] >= 1, wit["transfers"]
    assert wit["totalTransferBytes"] >= 4 * 8 * 4
    assert payload["ok"] is True and "staticCompileFindings" in payload


def test_the_plugin_without_an_option_changes_nothing(tmp_path):
    (tmp_path / "test_copies.py").write_text(COPIES)
    env = {"PIO_TORCH_JIT_WITNESS_REPORT": str(tmp_path / "jit.json"),
           "PIO_TORCH_LOCK_WITNESS_REPORT": str(tmp_path / "lock.json")}
    plain = pytest_run([str(tmp_path / "test_copies.py")], env, timeout=240)
    loaded = pytest_run([str(tmp_path / "test_copies.py"), *PLUGIN], env, timeout=240)
    assert plain.returncode == loaded.returncode == 0
    assert "1 passed" in plain.stdout and "1 passed" in loaded.stdout
    assert "witness" not in loaded.stdout
    assert not (tmp_path / "jit.json").exists() and not (tmp_path / "lock.json").exists()


def test_both_packages_lock_witnesses_is_a_usage_error():
    proc = pytest_run(["tests/test_torch_topk.py", *PLUGIN, "--torch-lock-witness", "--lock-witness"],
                      {}, timeout=240)
    assert proc.returncode == 4, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "--torch-lock-witness and --lock-witness" in proc.stderr
