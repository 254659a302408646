"""The console verbs the port took last from the JAX console:
``dashboard``, ``adminserver``, ``chaos-ingest``, ``chaos-serve``,
``chaos-fleet``, ``build``, ``run`` and ``upgrade``.

* ``tests/test_dashboard.py`` and ``TestAdminServer`` of
  ``tests/test_e2_and_aux.py`` run on both packages, ``[jax]`` and
  ``[torch]`` (``tests/torch_package_swap.py``): under ``[torch]`` the
  test module's controller classes, ``run_evaluation``, the fake DASE
  engine (the port's copy in ``tests/test_torch_dase.py``) and the
  ``sys.modules`` entries of the services are the port's, on its memory
  driver.
* Both consoles parse every one of these verbs to the same values, the
  serving drills' ``--device`` aside.
* ``build`` and ``upgrade`` exit 0; ``pio run`` gives its command the
  same ``PIO_FS_BASEDIR`` from both consoles, with the repository root
  on ``PYTHONPATH``; none of these verbs imports torch.
* ``dashboard`` and ``adminserver`` started with ``--port 0`` as
  subprocesses print ``Bound port N`` and answer ``GET /`` and
  ``/readyz``.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

import predictionio_tpu_torch.controller as port_controller
import predictionio_tpu_torch.data.storage as port_storage
import predictionio_tpu_torch.tools.adminserver as port_adminserver
import predictionio_tpu_torch.tools.dashboard as port_dashboard
import test_dashboard as jax_dashboard_cases
import test_e2_and_aux as jax_aux_cases
import test_torch_dase as port_fake
from predictionio_tpu.tools import console as jax_console
from predictionio_tpu_torch.tools import console
from predictionio_tpu_torch.workflow import run_evaluation as port_run_evaluation
from torch_package_swap import PACKAGES, cpu_context, memory_storage, use_port

ROOT = Path(__file__).resolve().parents[1]


class PortMAE(port_controller.AverageMetric):
    calculate_unit = jax_dashboard_cases.MAE.calculate_unit


@pytest.fixture(params=PACKAGES)
def package(request, monkeypatch):
    if request.param == "torch":
        names = {name: getattr(port_controller, name)
                 for name in ("EngineParams", "EngineParamsGenerator", "Evaluation", "AverageMetric", "FirstServing")}
        names.update(local_context=cpu_context, DashboardService=port_dashboard.DashboardService,
                     run_evaluation=port_run_evaluation, MAE=PortMAE, AlgoParams=port_fake.AlgoParams,
                     DSParams=port_fake.DSParams, engine0=port_fake.engine0)
        use_port(monkeypatch, jax_dashboard_cases, names, {
            "predictionio_tpu.tools.adminserver": port_adminserver,
            "predictionio_tpu.tools.dashboard": port_dashboard,
            "predictionio_tpu.data.storage": port_storage,
        })
    return request.param


@pytest.fixture()
def memory_storage_env(package):
    yield from memory_storage(package)


def test_dashboard_lists_evaluations(memory_storage_env, package):
    jax_dashboard_cases.test_dashboard_lists_evaluations(memory_storage_env)
    want = "predictionio_tpu_torch." if package == "torch" else "predictionio_tpu."
    assert jax_dashboard_cases.DashboardService.__module__.startswith(want)


class TestAdminServer(jax_aux_cases.TestAdminServer):
    pass


#: every verb of the slice, with its flags, as a user would type them
VERB_ARGVS = [
    ["dashboard"],
    ["dashboard", "--ip", "0.0.0.0", "--port", "0", "--drain-deadline-s", "5"],
    ["adminserver"],
    ["adminserver", "--port", "0", "--cert", "c.pem", "--key", "k.pem"],
    ["chaos-ingest"],
    ["chaos-ingest", "--cycles", "2", "--writers", "3", "--events", "30", "--backend", "columnar", "--seed", "4",
     "--bulk-events", "0", "--drain-deadline-s", "2", "--partitions", "4", "--replication", "2",
     "--ack-quorum", "2", "--keep"],
    ["chaos-serve"],
    ["chaos-serve", "--replicas", "3", "--clients", "8", "--kills", "2", "--seconds", "3", "--reloads", "0",
     "--events", "100", "--seed", "1", "--aot", "--sharded-point", "--keep"],
    ["chaos-fleet"],
    ["chaos-fleet", "--replicas-per-host", "2", "--clients", "4", "--seconds", "2", "--events", "90",
     "--lease-ttl-s", "0.5", "--seed", "2", "--skip-autoscale", "--keep"],
    ["build"],
    ["run", "python", "script.py", "--flag"],
    ["run", "--", "env"],
    ["upgrade"],
]


@pytest.mark.parametrize("argv", VERB_ARGVS, ids=[" ".join(a) for a in VERB_ARGVS])
def test_both_consoles_parse_the_verb_alike(argv):
    port = vars(console.build_parser().parse_args(argv))
    ref = vars(jax_console.build_parser().parse_args(argv))
    if argv[0] in ("chaos-serve", "chaos-fleet"):
        assert port.pop("device") == "cuda"
    assert port == ref


@pytest.mark.parametrize("verb", ["chaos-serve", "chaos-fleet"])
def test_serving_drills_take_a_device(verb):
    assert console.build_parser().parse_args([verb, "--device", "cpu"]).device == "cpu"


def test_chaos_cli_carries_bulk_events():
    """``tests/test_bulk_ingest.py``'s parser case on the port."""
    args = console.build_parser().parse_args(["chaos-ingest"])
    assert args.bulk_events == 1000


@pytest.mark.parametrize("verb", ["build", "upgrade"])
def test_build_and_upgrade_exit_0(verb, capsys):
    assert console.main([verb]) == 0
    out = capsys.readouterr().out
    assert jax_console.main([verb]) == 0
    ref = capsys.readouterr().out
    assert out.replace("predictionio_tpu_torch", "predictionio_tpu") == ref


@pytest.mark.parametrize("basedir", [True, False], ids=["set", "default"])
def test_run_sees_the_same_base_dir_from_both_consoles(basedir, tmp_path, monkeypatch, capfd):
    monkeypatch.setenv("HOME", str(tmp_path))
    if basedir:
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    else:
        monkeypatch.delenv("PIO_FS_BASEDIR", raising=False)
    script = "import os; print(os.environ['PIO_FS_BASEDIR']); print(os.environ['PYTHONPATH'].split(os.pathsep)[0])"
    seen = []
    for main in (console.main, jax_console.main):
        assert main(["run", sys.executable, "-c", script]) == 0
        seen.append(capfd.readouterr().out.split())
    assert seen[0] == seen[1]
    want = str(tmp_path / "store") if basedir else str(tmp_path / ".pio_store")
    assert seen[0] == [want, str(ROOT)]
    assert console.main(["run"]) == 1


def test_the_verbs_import_no_torch():
    script = (
        "import sys\n"
        "from predictionio_tpu_torch.tools import console, dashboard, adminserver\n"
        "from predictionio_tpu_torch.resilience import chaos\n"
        "assert console.main(['build']) == 0 and console.main(['upgrade']) == 0\n"
        "for verb in ('dashboard', 'adminserver', 'chaos-ingest', 'chaos-serve', 'chaos-fleet'):\n"
        "    console.build_parser().parse_args([verb])\n"
        "print('torch' in sys.modules, 'jax' in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["False", "False"]


@pytest.mark.parametrize("verb,status", [("dashboard", "Evaluation Dashboard"), ("adminserver", "alive")])
def test_server_verbs_bind_port_0_and_answer(verb, status, tmp_path):
    env = dict(os.environ, PIO_FS_BASEDIR=str(tmp_path),
               PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    for key in [k for k in env if k.startswith("PIO_STORAGE_")]:
        del env[key]
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.console", verb, "--ip", "127.0.0.1", "--port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        lines = [proc.stdout.readline(), proc.stdout.readline()]
        assert lines[0].endswith("is listening on 127.0.0.1:0\n"), lines
        assert lines[1].startswith("Bound port"), lines or proc.stderr.read()
        url = f"http://127.0.0.1:{int(lines[1].split()[-1])}"
        with urllib.request.urlopen(url + "/", timeout=10) as resp:
            assert resp.status == 200
            assert status in resp.read().decode()
        with urllib.request.urlopen(url + "/readyz", timeout=10) as resp:
            assert resp.status == 200
            assert json.loads(resp.read())["ready"] is True
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=15)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=15)
