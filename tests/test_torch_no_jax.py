"""The PyTorch port stands alone: no module of ``predictionio_tpu_torch/``
and neither ``chip_smoke.py``, ``gj_solve_split.py``, the graft entry
points (``__graft_entry_torch__.py``), the port's pytest witness plugin
(``tests/torch_witness_plugin.py``) nor the arrays engine they share
with the tests (``tests/torch_arrays_engine.py``) imports ``jax`` or anything of the JAX package
``predictionio_tpu``, and importing every module of the port leaves
``jax`` out of ``sys.modules``. The event data plane (the columnar store,
the event server, the data verbs) starts without torch as well, and the
serving runtime (``serving/``: the micro-batcher, the result cache, the
``--ann`` config) imports neither torch nor jax. The online-learning
package (``online/``) is covered like every module; its ``__init__`` and
``types`` import neither torch nor jax, and a deploy without ``--online``
imports nothing of it. The approximate and int8 retrieval modules
(``ops/ivf.py``, ``ops/quant.py``) are covered too, and a deploy without
``--ann`` or ``--quantize`` imports neither. So are the Similar-Product,
E-Commerce, Classification and Text-Classification templates and the
copies they run on (``ops/text.py``,
``controller/cleaning.py``, ``e2/``). The fleet (``fleet/``) and the A/B
split (``experiments/split.py``) import neither torch nor jax (the router
is a host process), and a default deploy imports neither the fleet nor
the experiments package. The sharded serving package (``parallel/``) is
covered, and a deploy without ``--shard-factors`` imports nothing of it.
The AOT tier (``workflow/aot.py``) and the compile counter
(``analysis/``, stdlib only) are covered, and a deploy without ``--aot``
imports none of ``workflow.aot``, ``torch._inductor`` and
``torch.export``'s tracer."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "predictionio_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "gj_solve_split.py", ROOT / "tests" / "torch_arrays_engine.py",
    ROOT / "__graft_entry_torch__.py", ROOT / "tests" / "torch_witness_plugin.py",
]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "predictionio_tpu")


def _imports(path: Path) -> list:
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.append((node.lineno, node.module))
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ):
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                found.append((node.lineno, arg.value))
    return found


def test_sources_exist():
    assert (PORT / "__init__.py").exists() and (ROOT / "chip_smoke.py").exists()
    assert len(SOURCES) > 10


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    bad = [f"{path.name}:{line} imports {name}" for line, name in _imports(path) if _forbidden(name)]
    assert not bad, bad


def test_forbidden_names():
    assert _forbidden("jax.numpy") and _forbidden("predictionio_tpu.ops.als")
    assert not _forbidden("predictionio_tpu_torch.ops.als") and not _forbidden("torch")


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    probe = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke, __graft_entry_torch__\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'predictionio_tpu'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert run.returncode == 0, run.stdout + run.stderr


DATA_PLANE = [
    "predictionio_tpu_torch.api",
    "predictionio_tpu_torch.api.http",
    "predictionio_tpu_torch.api.health",
    "predictionio_tpu_torch.api.lifecycle",
    "predictionio_tpu_torch.resilience",
    "predictionio_tpu_torch.data.storage.columnar",
    "predictionio_tpu_torch.data.storage.compaction",
    "predictionio_tpu_torch.tools.commands",
    "predictionio_tpu_torch.tools.console",
]


def test_the_probe_covers_the_data_plane():
    modules = {".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
               for p in PORT.rglob("*.py")}
    assert set(DATA_PLANE) <= modules


def test_data_plane_loads_neither_jax_nor_torch():
    # what `pio eventserver` and the data verbs import: a columnar store
    # opened, an event service built and its console parser made
    probe = (
        "import importlib, sys, tempfile\n"
        f"for m in {DATA_PLANE!r}: importlib.import_module(m)\n"
        "from predictionio_tpu_torch.api import EventService\n"
        "from predictionio_tpu_torch.data.storage import Storage\n"
        "d = tempfile.mkdtemp()\n"
        "Storage.configure({'PIO_FS_BASEDIR': d, 'PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE': 'C',\n"
        "                   'PIO_STORAGE_SOURCES_C_TYPE': 'columnar', 'PIO_STORAGE_SOURCES_C_PATH': d})\n"
        "Storage.get_l_events().init(1)\n"
        "assert EventService().dispatch('GET', '/', {}).status == 200\n"
        "sys.modules['predictionio_tpu_torch.tools.console'].build_parser().parse_args(['eventserver'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'predictionio_tpu', 'torch'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert run.returncode == 0, run.stdout + run.stderr


def test_console_help_loads_no_jax():
    # `python -m predictionio_tpu_torch.tools.console --help` as a user runs it
    probe = (
        "import runpy, sys\n"
        "sys.argv = ['console', '--help']\n"
        "try:\n"
        "    runpy.run_module('predictionio_tpu_torch.tools.console', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'predictionio_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert run.returncode == 0, run.stdout + run.stderr
    assert "train" in run.stdout and "deploy" in run.stdout


SERVING = sorted((PORT / "serving").glob("*.py"))


@pytest.mark.parametrize("path", SERVING, ids=lambda p: str(p.relative_to(ROOT)))
def test_serving_sources_import_neither_torch_nor_jax(path):
    bad = [
        f"{path.name}:{line} imports {name}"
        for line, name in _imports(path)
        if _forbidden(name) or name.split(".")[0] == "torch"
    ]
    assert not bad, bad


def test_serving_runtime_loads_neither_torch_nor_jax():
    # a micro-batcher answering one batch and a result cache filled once
    probe = (
        "import sys\n"
        "from predictionio_tpu_torch.serving import BatcherConfig, CacheConfig, MicroBatcher, ResultCache\n"
        "b = MicroBatcher(lambda bodies: [(200, x) for x in bodies], BatcherConfig(max_batch_size=4))\n"
        "assert b.submit({'q': 1}) == (200, {'q': 1}); b.close()\n"
        "c = ResultCache(CacheConfig(result_cache=True)); c.commit(c.reserve('k'), (200, 1))\n"
        "assert c.get('k') == (True, (200, 1))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'predictionio_tpu', 'torch'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert run.returncode == 0, run.stdout + run.stderr


ONLINE = ["__init__", "types", "follower", "foldin", "trainer", "runner"]


@pytest.mark.parametrize("name", ONLINE)
def test_online_modules_are_checked(name):
    assert PORT / "online" / f"{name}.py" in SOURCES


def test_online_package_loads_neither_torch_nor_jax():
    # what constructing an OnlineConfig costs: the package and its types
    probe = (
        "import sys\n"
        "import predictionio_tpu_torch.online\n"
        "from predictionio_tpu_torch.online import OnlineConfig\n"
        "from predictionio_tpu_torch.online.types import EventDelta, latest_wins\n"
        "assert OnlineConfig(enabled=True, interval_s=0.25).enabled\n"
        "assert latest_wins([EventDelta('rate', 'u', 'i', 1, 2.0)]) == {('u', 'i'): (1, 2.0)}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'predictionio_tpu', 'torch'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert run.returncode == 0, run.stdout + run.stderr


def test_a_deploy_without_online_imports_nothing_of_it():
    # the query server, both templates and the console's deploy flags
    # without --online: no module under predictionio_tpu_torch.online
    probe = (
        "import sys\n"
        "import predictionio_tpu_torch.workflow.serving\n"
        "import predictionio_tpu_torch.templates.recommendation.engine\n"
        "import predictionio_tpu_torch.templates.twotower.engine\n"
        "from predictionio_tpu_torch.tools import console\n"
        "args = console.build_parser().parse_args(['deploy', '--device', 'cpu', '--pin-model'])\n"
        "assert console._online_from_args(args) is None\n"
        "bad = sorted(m for m in sys.modules if m.startswith('predictionio_tpu_torch.online'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert run.returncode == 0, run.stdout + run.stderr


RETRIEVAL = ["ops/ivf.py", "ops/quant.py", "ops/topk.py", "serving/ann.py"]


@pytest.mark.parametrize("name", RETRIEVAL)
def test_retrieval_modules_are_checked(name):
    assert PORT / name in SOURCES


def test_default_deploy_imports_neither_ivf_nor_quant():
    """The port's counterpart of ``tests/test_ivf.py``'s
    ``test_default_import_path_never_touches_ivf``: a deploy without
    ``--ann`` or ``--quantize`` (the console, the query server and both
    templates) imports neither ``ops.ivf`` nor ``ops.quant``."""
    probe = (
        "import sys\n"
        "import predictionio_tpu_torch.tools.console\n"
        "import predictionio_tpu_torch.workflow.serving\n"
        "import predictionio_tpu_torch.templates.recommendation\n"
        "import predictionio_tpu_torch.templates.twotower\n"
        "bad = [m for m in ('predictionio_tpu_torch.ops.ivf', 'predictionio_tpu_torch.ops.quant') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert run.returncode == 0, run.stdout + run.stderr


SHARDED = ["parallel/__init__.py", "parallel/sharding.py"]


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_serving_modules_are_checked(name):
    """The port's ``parallel/`` package (``pio deploy --shard-factors``)
    is scanned above and imported by the probes."""
    assert PORT / name in SOURCES


def test_default_deploy_imports_no_sharding():
    """The port's counterpart of the JAX package's opt-in rule for
    ``--shard-factors``: a deploy without it (the console, the query
    server and both templates) imports nothing of ``parallel``; importing
    ``parallel.sharding`` loads no jax."""
    probe = (
        "import sys\n"
        "import predictionio_tpu_torch.tools.console\n"
        "import predictionio_tpu_torch.workflow.serving\n"
        "import predictionio_tpu_torch.templates.recommendation\n"
        "import predictionio_tpu_torch.templates.twotower\n"
        "bad = [m for m in sys.modules if m.startswith('predictionio_tpu_torch.parallel')]\n"
        "assert not bad, bad\n"
        "import predictionio_tpu_torch.parallel.sharding\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'predictionio_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert run.returncode == 0, run.stdout + run.stderr


TEMPLATES = [
    "ops/classify.py", "ops/text.py", "controller/cleaning.py",
    "e2/__init__.py", "e2/engine.py", "e2/evaluation.py",
    *(f"templates/{name}/{part}.py" for name in ("similarproduct", "ecommerce", "classification",
                                                 "textclassification") for part in ("__init__", "engine")),
]


@pytest.mark.parametrize("name", TEMPLATES)
def test_template_modules_are_checked(name):
    """The four templates of the reference's ``BUILTIN_TEMPLATES`` beside
    Recommendation and Two-Tower, and the modules they run on: each is
    scanned and imported by the probe above."""
    assert PORT / name in SOURCES


HOST_ONLY = sorted((PORT / "fleet").glob("*.py")) + [PORT / "experiments" / "split.py"]


@pytest.mark.parametrize("path", HOST_ONLY, ids=lambda p: str(p.relative_to(ROOT)))
def test_fleet_and_split_sources_import_neither_torch_nor_jax(path):
    bad = [
        f"{path.name}:{line} imports {name}"
        for line, name in _imports(path)
        if _forbidden(name) or name.split(".")[0] in ("torch", "numpy")
    ]
    assert not bad, bad


def test_fleet_and_split_load_neither_torch_nor_jax():
    """What the router process holds: the fleet package, a split, a
    router with the split, a hash ring and the registries."""
    probe = (
        "import sys, tempfile\n"
        "import predictionio_tpu_torch.fleet as fleet\n"
        "from predictionio_tpu_torch.experiments.split import SplitConfig, TrafficSplit\n"
        "split = TrafficSplit(SplitConfig.parse('a:1,b:2'))\n"
        "assert split.assign('s:u1') in ('a', 'b')\n"
        "d = tempfile.mkdtemp()\n"
        "router = fleet.RouterService([], fleet.RouterConfig(), registry=fleet.ModelRegistry(d), split=split,\n"
        "                             endpoint_registry=fleet.EndpointRegistry(d))\n"
        "assert router.dispatch('GET', '/experiments.json', {}).status == 200\n"
        "assert fleet.HashRing(['r0', 'r1']).owner('s:u1') in ('r0', 'r1')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'predictionio_tpu', 'torch'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert run.returncode == 0, run.stdout + run.stderr


def test_default_deploy_imports_neither_fleet_nor_experiments():
    """The port's counterpart of ``tests/test_ci_guards.py``'s
    ``test_fleet_defaults_are_opt_in`` and
    ``test_experiments_defaults_are_opt_in``: without ``--replicas``,
    ``--explore`` or ``--variants`` (and without ``eval --grid``) the
    console, the query server and both templates import nothing under
    ``predictionio_tpu_torch.fleet`` or ``.experiments``; the flags
    default off and a query server without a replica id adds no fleet
    headers."""
    probe = (
        "import inspect, sys\n"
        "import predictionio_tpu_torch.workflow.serving as serving\n"
        "import predictionio_tpu_torch.templates.recommendation.engine\n"
        "import predictionio_tpu_torch.templates.twotower.engine\n"
        "from predictionio_tpu_torch.tools import console\n"
        "args = console.build_parser().parse_args(['deploy', '--device', 'cpu', '--pin-model'])\n"
        "assert args.replicas == 0 and args.replica_id is None and not args.router_only\n"
        "assert args.explore is None and args.variants == '' and console._explore_from_args(args) is None\n"
        "assert not console.build_parser().parse_args(['eval', 'm:e']).grid\n"
        "sig = inspect.signature(serving.QueryService.__init__)\n"
        "assert sig.parameters['explore'].default is None and sig.parameters['replica_id'].default is None\n"
        "assert 'if self.replica_id is None' in inspect.getsource(serving.QueryService._tag_replica)\n"
        "bad = sorted(m for m in sys.modules if m.startswith(('predictionio_tpu_torch.fleet',\n"
        "                                                     'predictionio_tpu_torch.experiments')))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert run.returncode == 0, run.stdout + run.stderr


AOT = ["workflow/aot.py", "analysis/__init__.py", "analysis/jit_witness.py"]


@pytest.mark.parametrize("name", AOT)
def test_aot_modules_are_checked(name):
    """The AOT tier (``pio train --aot`` / ``pio deploy --aot``) and the
    serve-time compile counter are scanned above."""
    assert PORT / name in SOURCES


@pytest.mark.parametrize("path", sorted((PORT / "analysis").glob("*.py")), ids=lambda p: p.name)
def test_the_compile_counter_imports_neither_torch_nor_jax(path):
    """``analysis/`` is stdlib only: ``ops/_build.py`` counts its nvcc runs
    through it, and it reads torch's counters only where torch loaded them."""
    bad = [f"{path.name}:{line} imports {name}" for line, name in _imports(path)
           if _forbidden(name) or name.split(".")[0] == "torch"]
    assert not bad, bad


def test_a_deploy_without_aot_imports_nothing_of_it(tmp_path):
    """A deploy without ``--aot`` — the console's deploy flags, a trained
    instance served by the query server on the CPU, a query — imports none
    of ``workflow.aot``, ``torch._inductor`` and ``torch.export``'s tracer
    (``torch.export._trace``; ``import torch`` itself loads the
    ``torch.export`` package)."""
    probe = (
        "import sys\n"
        "import numpy as np\n"
        "from predictionio_tpu_torch.tools import console\n"
        "args = console.build_parser().parse_args(['deploy', '--device', 'cpu', '--pin-model'])\n"
        "assert args.aot is False\n"
        "from predictionio_tpu_torch.controller.context import local_context\n"
        "from predictionio_tpu_torch.data.event import DataMap, Event\n"
        "from predictionio_tpu_torch.data.storage import Storage\n"
        "from predictionio_tpu_torch.data.storage.base import App\n"
        "from predictionio_tpu_torch.serving import CacheConfig\n"
        "from predictionio_tpu_torch.workflow import load_engine_variant, run_train\n"
        "from predictionio_tpu_torch.workflow.serving import QueryService\n"
        f"Storage.configure({{'PIO_FS_BASEDIR': {str(tmp_path)!r}}})\n"
        "app = Storage.get_meta_data_apps().insert(App(id=0, name='a'))\n"
        "Storage.get_p_events().write((Event(event='rate', entity_type='user', entity_id=str(i % 7),\n"
        "    target_entity_type='item', target_entity_id=str(i % 11), properties=DataMap({'rating': 3.0}))\n"
        "    for i in range(60)), app)\n"
        "v = load_engine_variant({'id': 'e', 'version': '1',\n"
        "    'engineFactory': 'predictionio_tpu.templates.recommendation:engine_factory',\n"
        "    'datasource': {'params': {'appName': 'a'}},\n"
        "    'algorithms': [{'name': 'als', 'params': {'rank': 4, 'numIterations': 1, 'lambda': 0.1, 'seed': 1}}]})\n"
        "run_train(v, local_context('cpu'))\n"
        "qs = QueryService(v, local_context('cpu'), cache=CacheConfig(pin_model=True))\n"
        "status, answer = qs.handle_query({'user': '1', 'num': 3})\n"
        "qs.close()\n"
        "assert status == 200 and len(answer['itemScores']) == 3, answer\n"
        "assert 'aot' not in qs.stats_json() and qs.status_json()['aot'] is False\n"
        "bad = [m for m in ('predictionio_tpu_torch.workflow.aot', 'torch._inductor', 'torch.export._trace')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert run.returncode == 0, run.stdout + run.stderr


def test_importing_the_analysis_package_loads_neither_torch_nor_jax():
    """``predictionio_tpu_torch.analysis`` and its witnesses, imported and
    a jit witness installed in a fresh interpreter: neither torch nor
    jax (nor numpy, nor the JAX package) is loaded; the witness wraps
    the torch its process loaded, and here there is none."""
    probe = ("import sys\nimport predictionio_tpu_torch.analysis\n"
             "from predictionio_tpu_torch.analysis import jit_witness, lock_witness, witness\n"
             "w = jit_witness.JitWitness(); w.install(); w.uninstall()\n"
             "assert w.report()['torchPatched'] is False\n"
             "bad = [m for m in ('torch', 'jax', 'jaxlib', 'numpy', 'predictionio_tpu') if m in sys.modules]\n"
             "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    run = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
