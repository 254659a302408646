"""The port's piolint (``predictionio_tpu_torch/analysis``) against the
reference's (``predictionio_tpu/analysis``).

* Every fixture case of ``tests/test_piolint.py`` that lints sources
  (not the whole tree, not a subprocess) runs again on the port's
  analyzer: the module's globals and the ``predictionio_tpu.analysis``
  entries of ``sys.modules`` rebound to the port's modules, so the case's
  own assertions hold the port; and every ``lint_file`` /
  ``lint_sources`` call it makes is also made on the reference, whose
  findings (code, path, line, message) must be the port's.
* The port's own rules — torch's host crossings (PIO307), torch's
  compiled-program constructors (PIO308) and the port's manifest —
  each with a positive and a negative fixture, and the reference's
  findings on the same sources unchanged.
* One full-tree lint by each package: the port's clean with no baseline
  entries, its findings outside ``predictionio_tpu_torch/`` the
  reference's.
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys
import textwrap

import pytest

import predictionio_tpu.analysis as jax_analysis
import predictionio_tpu_torch.analysis as port_analysis
from predictionio_tpu.analysis import engine as jax_engine
from predictionio_tpu_torch.analysis import engine as port_engine
from tests import test_piolint as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = (
    "callgraph", "engine", "manifest", "rules_compile", "rules_concurrency", "rules_durability",
    "rules_jax", "rules_layering", "rules_program", "rules_server",
)
JAX = {name: importlib.import_module(f"predictionio_tpu.analysis.{name}") for name in MODULES}
PORT = {name: importlib.import_module(f"predictionio_tpu_torch.analysis.{name}") for name in MODULES}

#: the reference's cases that lint the whole tree or run the JAX console
#: in a subprocess: the full-tree comparison below and the port's CLI
#: tests cover those
WHOLE_TREE_OR_CLI = {
    "test_full_tree_lints_clean_and_fast",
    "test_sarif_output_schema",
    "test_deleting_a_pow2_bucket_step_is_caught",
    "test_analysis_package_is_stdlib_only",
    "test_pio_lint_prune_baseline_cli",
    "test_pio_lint_cli_exit_codes",
    "test_pio_lint_sarif_cli",
    "test_cli_exit_code_contract",
}
CASES = sorted(
    name for name, fn in vars(ref).items()
    if name.startswith("test_") and inspect.isfunction(fn) and name not in WHOLE_TREE_OR_CLI
)


def _key(findings) -> list:
    return [(f.code, f.path, f.line, f.message) for f in findings]


def _twins() -> dict:
    """id(reference object) -> the port's object of the same name."""
    out = {}
    for name, mod in JAX.items():
        for attr, value in vars(mod).items():
            if isinstance(value, (int, float, str, type(None))):
                continue  # constants: equal in both, and ids of small values are shared
            if not attr.startswith("__") and hasattr(PORT[name], attr):
                out.setdefault(id(value), getattr(PORT[name], attr))
    return out


@pytest.fixture
def on_port(monkeypatch):
    """Rebind ``tests/test_piolint.py`` to the port's analyzer, each lint
    call checked against the reference's. Yields the number of calls
    compared."""
    compared = [0]

    def checked(port_fn, jax_fn, findings_of):
        def call(*args, **kwargs):
            got = port_fn(*args, **kwargs)
            want = jax_fn(*args, **kwargs)
            assert _key(findings_of(got)) == _key(findings_of(want)), (args, kwargs)
            compared[0] += 1
            return got
        return call

    lint_file = checked(port_engine.lint_file, jax_engine.lint_file, lambda r: r[0])
    lint_sources = checked(port_engine.lint_sources, jax_engine.lint_sources, lambda r: r[0])
    twins = _twins()
    for name, value in list(vars(ref).items()):
        twin = twins.get(id(value))
        if twin is not None and not name.startswith("__"):
            monkeypatch.setattr(ref, name, twin)
    monkeypatch.setattr(ref, "lint_file", lint_file)
    monkeypatch.setattr(ref, "lint_sources", lint_sources)
    # the cases' own function-local imports
    monkeypatch.setitem(sys.modules, "predictionio_tpu.analysis", port_analysis)
    for name in MODULES:
        monkeypatch.setitem(sys.modules, f"predictionio_tpu.analysis.{name}", PORT[name])
    monkeypatch.setattr(port_engine, "lint_file", lint_file)
    monkeypatch.setattr(port_engine, "lint_sources", lint_sources)
    yield compared


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_the_port(case, on_port, request):
    fn = getattr(ref, case)
    kwargs = {}
    for param in inspect.signature(fn).parameters:
        kwargs[param] = request.getfixturevalue(param)
    fn(**kwargs)


def test_every_lint_case_is_compared(on_port, tmp_path):
    """The comparison is live: the cases that lint call through it."""
    ref.test_pio101_forbidden_import_fires_and_suppresses()
    ref.test_pio206_suppression_and_baseline(tmp_path)
    assert on_port[0] >= 5


def test_the_port_keeps_the_reference_rule_set():
    """Same codes, names and descriptions; the reference's manifest is
    the head of the port's."""
    assert {c: (r.name, r.description) for c, r in port_analysis.all_rules().items()} == {
        c: (r.name, r.description) for c, r in jax_analysis.all_rules().items()
    }
    ref_manifest = JAX["manifest"].DEFAULT_MANIFEST
    port_manifest = PORT["manifest"].DEFAULT_MANIFEST
    assert [vars(r) for r in port_manifest[: len(ref_manifest)]] == [vars(r) for r in ref_manifest]
    assert all(r.package.startswith("predictionio_tpu_torch") for r in port_manifest[len(ref_manifest):])


# ---------------------------------------------------------------------------
# The port's own rules: torch's host crossings, compiled programs, manifest
# ---------------------------------------------------------------------------


def _program(files: dict) -> tuple:
    files = {p: textwrap.dedent(s) for p, s in files.items()}
    return port_engine.lint_sources(files)[0], jax_engine.lint_sources(files)[0]


_SERVE = """\
from predictionio_tpu_torch.ops.score import top

class Algo:
    def predict(self, model, query):
        return top(model, query)
"""


@pytest.mark.parametrize("call, what", [
    ("scores.cpu()", ".cpu()"),
    ('scores.to("cpu")', '.to("cpu")'),
    ('scores.to(device="cpu", dtype=torch.float64)', '.to("cpu")'),
    ("scores.numpy()", ".numpy()"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("scores.item()", ".item()"),
])
def test_pio307_torch_transfer_on_a_serving_path(call, what):
    port, jax = _program({
        "predictionio_tpu_torch/serve.py": _SERVE,
        "predictionio_tpu_torch/ops/score.py": f"""\
        import torch

        def top(model, query):
            scores = model @ query
            return {call}
        """,
    })
    hits = [f for f in port if f.code == "PIO307"]
    assert len(hits) == 1 and hits[0].path == "predictionio_tpu_torch/ops/score.py" and hits[0].line == 5
    assert hits[0].message.startswith(f"{what} in predictionio_tpu_torch.ops.score.top transfers")
    assert "predict" in hits[0].detail
    # outside the reference's scope: the reference finds nothing here
    assert [f for f in jax if f.code == "PIO307"] == []


@pytest.mark.parametrize("call", ['scores.to("cuda")', "scores.to(torch.float16)", "scores.cuda()", "scores.sum()"])
def test_pio307_device_side_calls_are_no_transfer(call):
    port, _ = _program({
        "predictionio_tpu_torch/serve.py": _SERVE,
        "predictionio_tpu_torch/ops/score.py": f"""\
        import torch

        def top(model, query):
            scores = model @ query
            return {call}
        """,
    })
    assert [f for f in port if f.code == "PIO307"] == []


def test_pio307_torch_methods_outside_the_port_keep_the_reference_findings():
    """``.cpu()`` in the JAX package's scope is not one of the reference's
    crossings, so the port does not report it either; ``.item()`` is."""
    files = {
        "predictionio_tpu/serve.py": _SERVE.replace("predictionio_tpu_torch", "predictionio_tpu"),
        "predictionio_tpu/ops/score.py": """\
        def top(model, query):
            scores = model @ query
            scores.cpu()
            return scores.item()
        """,
    }
    port, jax = _program(files)
    assert _key(port) == _key(jax)
    assert [(f.code, f.line) for f in port if f.code == "PIO307"] == [("PIO307", 4)]


def test_pio307_port_allow_list_and_unreached_functions():
    port, _ = _program({
        "predictionio_tpu_torch/serve.py": """\
        from predictionio_tpu_torch.ops.ivf import trim_row

        class Algo:
            def predict(self, model, query):
                return trim_row(model, query, 3)
        """,
        "predictionio_tpu_torch/ops/ivf.py": """\
        def trim_row(ids, scores, n):
            return ids.tolist(), scores.cpu()

        def offline(x):
            return x.cpu()
        """,
    })
    assert [f for f in port if f.code == "PIO307"] == []


@pytest.mark.parametrize("body, what", [
    ("fn = torch.compile(model)\nreturn fn(query)", "torch.compile"),
    ("return functools.partial(torch.compile, mode='reduce-overhead')(model)(query)", "torch.compile"),
    ("@torch.compile\ndef inner(q):\n    return q\nreturn inner(query)", "torch.compile"),
    ("return torch._inductor.aoti_load_package(query)", "aoti_load_package"),
    ("return aoti_load_package(query)", "aoti_load_package"),
])
def test_pio308_torch_compiled_program_per_call(body, what):
    head = "import functools\n\nimport torch\nfrom torch._inductor import aoti_load_package\n\n"
    source = head + "def handle_query(model, query):\n" + textwrap.indent(body, "    ") + "\n"
    port, jax = _program({"predictionio_tpu_torch/serve.py": source})
    hits = [f for f in port if f.code == "PIO308"]
    assert len(hits) == 1
    assert hits[0].message.startswith(f"{what} constructed inside predictionio_tpu_torch.serve.handle_query")
    assert [f for f in jax if f.code == "PIO308"] == []


@pytest.mark.parametrize("source", [
    # module scope
    "import torch\n\nFN = torch.compile(abs)\n\ndef handle_query(q):\n    return FN(q)\n",
    # behind functools.lru_cache
    "import functools\nimport torch\n\n@functools.lru_cache(8)\ndef compiled(k):\n"
    "    return torch.compile(abs)\n\ndef handle_query(q):\n    return compiled(1)(q)\n",
    # a keyed cache slot
    "import torch\n\nCACHE = {}\n\ndef handle_query(q):\n    fn = CACHE.get(1)\n    if fn is None:\n"
    "        fn = torch.compile(abs)\n        CACHE[1] = fn\n    return fn(q)\n",
    # not on a request/fold path
    "import torch\n\ndef export(m):\n    return torch.compile(m)\n",
])
def test_pio308_sanctioned_torch_shapes(source):
    port, _ = _program({"predictionio_tpu_torch/serve.py": source})
    assert [f for f in port if f.code == "PIO308"] == []


def _codes(rel: str, source: str) -> list:
    found, _ = port_engine.lint_file(rel, textwrap.dedent(source))
    return [f.code for f in found]


@pytest.mark.parametrize("rel, source", [
    ("predictionio_tpu_torch/ops/x.py", "import jax\n"),
    ("predictionio_tpu_torch/ops/x.py", "from jax import numpy as jnp\n"),
    ("predictionio_tpu_torch/workflow/x.py", "from predictionio_tpu.ops import als\n"),
    ("predictionio_tpu_torch/x.py", "import predictionio_tpu\n"),
    ("predictionio_tpu_torch/serving/x.py", "import torch\n"),
    ("predictionio_tpu_torch/serving/x.py", "from predictionio_tpu_torch.ops import als\n"),
    ("predictionio_tpu_torch/data/x.py", "def f():\n    import torch\n"),
    ("predictionio_tpu_torch/api/x.py", "import torch\n"),
    ("predictionio_tpu_torch/e2/x.py", "import torch\n"),
    ("predictionio_tpu_torch/online/x.py", "from predictionio_tpu_torch.templates import twotower\n"),
])
def test_port_manifest_forbids(rel, source):
    assert _codes(rel, source) == ["PIO101"]


@pytest.mark.parametrize("rel, source, code", [
    ("predictionio_tpu_torch/analysis/x.py", "import torch\n", "PIO102"),
    ("predictionio_tpu_torch/analysis/jit_witness.py", "import numpy\n", "PIO102"),
    ("predictionio_tpu_torch/resilience/x.py", "import numpy\n", "PIO102"),
    ("predictionio_tpu_torch/fleet/x.py", "from predictionio_tpu_torch.data import storage\n", "PIO102"),
    ("predictionio_tpu_torch/templates/ecommerce/engine.py",
     "from predictionio_tpu_torch.templates.similarproduct.engine import keyed_coo\n", "PIO103"),
])
def test_port_manifest_stdlib_only_and_siblings(rel, source, code):
    assert _codes(rel, source) == [code]


@pytest.mark.parametrize("rel, source", [
    # whole-component matching: the port's own modules are not the JAX package
    ("predictionio_tpu_torch/ops/x.py", "import predictionio_tpu_torch.ops.als\n"),
    ("predictionio_tpu_torch/ops/x.py", "import torch\nimport numpy\n"),
    ("predictionio_tpu_torch/analysis/jit_witness.py", "def f():\n    import torch\n"),
    ("predictionio_tpu_torch/analysis/engine.py", "from predictionio_tpu_torch.version import __version__\n"),
    ("predictionio_tpu_torch/fleet/x.py", "from predictionio_tpu_torch.serving.cache import affinity_key\n"),
    ("predictionio_tpu_torch/templates/ecommerce/engine.py",
     "from predictionio_tpu_torch.templates.als_util import keyed_coo\n"),
    ("predictionio_tpu_torch/templates/textclassification/engine.py",
     "from predictionio_tpu_torch.templates.classifier_util import ClassifierBase\n"),
    # the reference's contracts do not reach the port's paths
    ("predictionio_tpu_torch/serving_extra/x.py", "import torch\n"),
    ("predictionio_tpu/ops/x.py", "import jax\nimport predictionio_tpu.ops\n"),
])
def test_port_manifest_allows(rel, source):
    assert _codes(rel, source) == []


_REGISTRY = """\
import importlib
import threading


class Registry:
    def __init__(self):
        self._lock = threading.Lock()

    def client(self, name):
        with self._lock:
            cls = getattr(importlib.import_module(name), "Driver", None)
            return cls(name)
"""

_DRIVER = """\
import os


class Driver:
    def __init__(self, name):
        os.fsync(os.open(name, os.O_RDONLY))
"""


@pytest.mark.parametrize("package", ["predictionio_tpu_torch", "predictionio_tpu"])
def test_a_class_named_by_getattr_is_built_under_the_lock_in_the_port_only(package):
    """Under ``predictionio_tpu_torch/`` ``cls = getattr(module, "Driver")``
    then ``cls(...)`` calls every port class named ``Driver`` (the storage
    registry builds its drivers so, under its lock): the fsync in its
    constructor is reached under the lock. Elsewhere the graph is the
    reference's, which does not follow the call."""
    port, jax = _program({f"{package}/registry.py": _REGISTRY, f"{package}/driver.py": _DRIVER})
    hits = [(f.code, f.path, f.line) for f in port if f.code == "PIO211"]
    if package == "predictionio_tpu_torch":
        assert hits == [("PIO211", "predictionio_tpu_torch/registry.py", 12)]
        assert "Driver.__init__" in next(f for f in port if f.code == "PIO211").render()
    else:
        assert hits == [] and _key(port) == _key(jax)


# ---------------------------------------------------------------------------
# The whole tree, once a package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def full_tree():
    return port_analysis.run_lint(root=REPO), jax_analysis.run_lint(root=REPO)


def test_port_lints_the_tree_clean_without_a_baseline(full_tree):
    port, _ = full_tree
    assert port.files_scanned > 250
    assert port.ok, "\n".join(f.render() for f in port.new_findings)
    assert port.baselined == [] and port.stale_baseline == 0
    assert port_engine.load_baseline(os.path.join(REPO, "piolint-baseline.json")) == {}
    assert port.lock_cycles == []


def _driver_constructor_edges() -> int:
    """The call edges only the port's graph has: under
    ``predictionio_tpu_torch/`` a class looked up by ``getattr(module,
    "StorageClient")`` resolves to each of the port's driver classes (the
    storage registry's constructor call)."""
    from predictionio_tpu_torch.analysis.witness import build_program

    fi = build_program().graph.functions["predictionio_tpu_torch.data.storage.registry._Registry.client_for_source"]
    return sum(len(s.callees) for s in fi.calls
               if s.callees and all(c.endswith(".StorageClient.__init__") for c in s.callees))


def test_port_findings_outside_the_port_are_the_reference_findings(full_tree):
    port, jax = full_tree
    outside = [f for f in port.new_findings + port.baselined if not f.path.startswith("predictionio_tpu_torch/")]
    assert _key(outside) == _key(jax.new_findings + jax.baselined)
    assert port.files_scanned == jax.files_scanned
    extra = _driver_constructor_edges()
    assert extra > 0
    assert {**port.callgraph, "callEdges": port.callgraph["callEdges"] - extra} == jax.callgraph
    assert port.lock_cycles == jax.lock_cycles


def test_port_sarif_names_the_port_version(full_tree):
    from predictionio_tpu_torch import __version__

    doc = full_tree[0].to_sarif()
    driver = doc["runs"][0]["tool"]["driver"]
    assert driver["name"] == "piolint" and driver["version"] == __version__
    assert {"PIO307", "PIO308"} <= {r["id"] for r in driver["rules"]}
