"""Run a test module of the JAX package on the port's classes.

``tests/test_torch_microbatcher.py`` and ``tests/test_torch_serving_cache.py``
subclass the JAX package's own test classes and parametrise every case
over both packages: under ``"torch"`` the :func:`use_port` fixture
rebinds the JAX test module's globals, and the module paths its cases
import inside their bodies, to the port's objects. The port runs on the
CPU there, which the tests ask for (its ``local_context()`` default is
the card). The JAX test files stay as they are.
"""

from __future__ import annotations

import functools
import sys
import types

import numpy as np
import torch

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
