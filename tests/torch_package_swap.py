"""Run a test module of the JAX package on the port's classes.

``tests/test_torch_microbatcher.py`` and ``tests/test_torch_serving_cache.py``
subclass the JAX package's own test classes and parametrise every case
over both packages: under ``"torch"`` the :func:`use_port` fixture
rebinds the JAX test module's globals, and the module paths its cases
import inside their bodies, to the port's objects. The port runs on the
CPU there, which the tests ask for (its ``local_context()`` default is
the card). The JAX test files stay as they are.

:func:`port_copy` goes one step further for the suites whose modules
subclass the JAX package's bases at module level or start the JAX
console in a subprocess: it loads the JAX test module's own text with
the package path renamed to the port's, and :func:`reference_suite`
collects its classes and functions into a port test file, `[torch]`
only, with the cases it leaves out named.
"""

from __future__ import annotations

import ast
import functools
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from _pytest.assertion.rewrite import rewrite_asserts
from _pytest.fixtures import FixtureFunctionDefinition

from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu_torch.controller.context import local_context
from predictionio_tpu_torch.data.storage import Storage

__all__ = [
    "MEMORY",
    "PACKAGES",
    "controller_module",
    "cpu_context",
    "cpu_module",
    "memory_storage",
    "jax_globals",
    "on_cpu",
    "port_copy",
    "reference_suite",
    "suite_memory_storage_env",
    "suite_package",
    "tensor_numpy",
    "tensor_top_k_items_batch",
    "use_port",
]

PACKAGES = ("jax", "torch")

#: all three repository roles on the in-memory driver (tests/conftest.py)
MEMORY = {
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
}


def cpu_context(*_args, **_kwargs):
    """The port's ``local_context`` on the CPU, whatever it is asked."""
    return local_context("cpu")


def memory_storage(package: str):
    """The package's ``Storage`` on the memory driver, reset afterwards."""
    storage = JaxStorage if package == "jax" else Storage
    storage.configure(MEMORY)
    try:
        yield storage
    finally:
        storage.configure(None)


def use_port(monkeypatch, jax_module, names: dict, modules: dict) -> None:
    """Rebind ``jax_module``'s globals (``names``) and ``sys.modules``
    entries (``modules``) to the port's objects for one test, and make
    the port's query server default to the CPU."""
    import predictionio_tpu_torch.workflow.serving as port_serving

    for name, value in names.items():
        monkeypatch.setattr(jax_module, name, value)
    for name, module in modules.items():
        monkeypatch.setitem(sys.modules, name, module)
    monkeypatch.setattr(port_serving, "local_context", cpu_context)


def controller_module() -> types.ModuleType:
    """A stand-in for ``predictionio_tpu.controller`` whose
    ``local_context`` is the port's on the CPU."""
    module = types.ModuleType("predictionio_tpu.controller")
    module.local_context = cpu_context
    return module


def cpu_module(name: str, module: types.ModuleType, **on_cpu) -> types.ModuleType:
    """A stand-in for the JAX module ``name``: the port's ``module`` with
    the callables named in ``on_cpu`` bound to ``device="cpu"`` (the
    port's entry points default to the card)."""
    stand_in = types.ModuleType(name)
    stand_in.__dict__.update({k: v for k, v in vars(module).items() if not k.startswith("__")})
    for attr, fn in on_cpu.items():
        setattr(stand_in, attr, functools.partial(fn, device="cpu"))
    return stand_in


def tensor_numpy() -> types.ModuleType:
    """A stand-in for ``jax.numpy`` in a JAX test module run on the port:
    ``asarray`` makes a CPU tensor, which the port's functions take where
    the JAX ones take a device array."""
    module = types.ModuleType("jax.numpy")

    def asarray(a, dtype=None):
        return torch.as_tensor(np.asarray(a) if dtype is None else np.asarray(a, dtype))

    module.asarray = asarray
    return module


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def tensor_top_k_items_batch(user_idx, user_factors, item_factors, k):
    """The port's ``top_k_items_batch`` on a JAX case's arrays (numpy or
    :func:`tensor_numpy` tensors)."""
    from predictionio_tpu_torch.ops.als import top_k_items_batch

    return top_k_items_batch(_tensor(user_idx).to(torch.int64), _tensor(user_factors), _tensor(item_factors), k)


#: the console verbs that take ``--device`` (the port's default is the card)
DEVICE_VERBS = frozenset({"status", "train", "deploy", "batchpredict", "eval", "chaos-serve", "chaos-fleet"})

_TESTS = Path(__file__).resolve().parent


def port_copy(name: str) -> types.ModuleType:
    """The JAX test module ``tests/<name>.py`` loaded from its own text with
    every ``predictionio_tpu`` path renamed to ``predictionio_tpu_torch``
    (imports, module-level subclasses, an engine factory's path, a
    subprocess's ``-m`` target) and ``fake_dase`` to its copy on the port
    (``torch_fake_dase``, this same rewrite of ``tests/fake_dase.py``), as
    is another JAX test module it imports from (``torch_test_<name>``).
    Registered in ``sys.modules`` as ``torch_<name>``; line numbers are
    the reference file's, and its asserts are rewritten as pytest's."""
    key = f"torch_{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = _TESTS / f"{name}.py"
    text = re.sub(r"\bpredictionio_tpu\b", "predictionio_tpu_torch", path.read_text())
    text = re.sub(r"\b(?:tests\.)?fake_dase\b", "torch_fake_dase", text)
    helpers = set(re.findall(r"^\s*from (?:tests\.)?(test_\w+) import", text, re.M))
    text = re.sub(r"^(\s*from )(?:tests\.)?(test_\w+)( import)", r"\1torch_\2\3", text, flags=re.M)
    if name != "fake_dase" and "torch_fake_dase" in text:
        helpers.add("fake_dase")
    for helper in sorted(helpers):
        port_copy(helper)
    tree = ast.parse(text, str(path))
    rewrite_asserts(tree, text.encode(), str(path))
    module = types.ModuleType(key, (ast.get_docstring(tree) or ""))
    module.__file__ = str(path)
    sys.modules[key] = module
    try:
        exec(compile(tree, str(path), "exec", dont_inherit=True), module.__dict__)
    except BaseException:
        del sys.modules[key]
        raise
    if hasattr(module, "local_context"):
        module.local_context = cpu_context
    if getattr(module, "main", None) is _port_main():
        module.main = cpu_main
    return module


@functools.cache
def _port_main():
    """The port's console ``main`` as it was before :func:`on_cpu`."""
    from predictionio_tpu_torch.tools import console

    return console.main


def cpu_main(argv) -> int:
    """The port's console ``main`` with ``--device cpu`` added to a verb
    that takes a device and was given none."""
    argv = list(argv)
    if argv and argv[0] in DEVICE_VERBS and "--device" not in argv:
        argv[1:1] = ["--device", "cpu"]
    return _port_main()(argv)


def on_cpu(monkeypatch) -> None:
    """Point the port's default-device entry points a case reaches by
    import inside its body at the CPU: ``controller.local_context``, the
    query server's context and ``tools.console.main``."""
    import predictionio_tpu_torch.controller as port_controller
    import predictionio_tpu_torch.workflow.serving as port_serving
    from predictionio_tpu_torch.tools import console

    _port_main()
    monkeypatch.setattr(port_controller, "local_context", cpu_context)
    monkeypatch.setattr(port_serving, "local_context", cpu_context)
    monkeypatch.setattr(console, "main", cpu_main)


@pytest.fixture(name="package", params=("torch",), autouse=True)
def suite_package(request, monkeypatch):
    """A rerun suite's cases, ``[torch]`` only, with the port's
    default-device entry points on the CPU (:func:`on_cpu`)."""
    on_cpu(monkeypatch)
    return request.param


@pytest.fixture(name="memory_storage_env")
def suite_memory_storage_env(package):
    """``tests/conftest.py``'s ``memory_storage_env`` on the port's ``Storage``."""
    yield from memory_storage(package)


def reference_suite(namespace: dict, name: str, excluded: dict) -> types.ModuleType:
    """Collect the port copy of ``tests/<name>.py`` into a test file's
    ``namespace``: each ``Test*`` class as a subclass named
    ``Test<Module><Class>`` (the suites share class names), each module
    level ``test_*`` function and fixture under its own name. ``excluded``
    maps ``"Class.test"`` or ``"test"`` to the reason it does not run on
    the port; an excluded case is set to ``None`` (pytest collects
    nothing there) and a name that matches no case raises."""
    module = port_copy(name)
    stem = "".join(part.title() for part in name.split("_")[1:])
    found = set()
    for attr, value in vars(module).items():
        if isinstance(value, type) and attr.startswith("Test") and value.__module__ == module.__name__:
            body = {"__module__": namespace["__name__"], "__doc__": value.__doc__}
            for case in dir(value):
                if f"{attr}.{case}" in excluded:
                    body[case] = None
                    found.add(f"{attr}.{case}")
            namespace[f"Test{stem}{attr[4:]}"] = type(f"Test{stem}{attr[4:]}", (value,), body)
        elif attr.startswith("test_") and callable(value):
            if attr in excluded:
                found.add(attr)
            else:
                namespace[attr] = value
        elif isinstance(value, FixtureFunctionDefinition):
            namespace[attr] = value
    missing = set(excluded) - found
    if missing:
        raise LookupError(f"excluded cases not in {name}: {sorted(missing)}")
    return module


def jax_globals(module: types.ModuleType) -> list:
    """The globals of ``module`` that are, or come from, the JAX package."""
    out = []
    for attr, value in vars(module).items():
        origin = value.__name__ if isinstance(value, types.ModuleType) else getattr(value, "__module__", None)
        if isinstance(origin, str) and (origin == "predictionio_tpu" or origin.startswith("predictionio_tpu.")):
            out.append(attr)
    return out
