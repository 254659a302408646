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

import sys
import types

from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu_torch.controller.context import local_context
from predictionio_tpu_torch.data.storage import Storage

__all__ = ["MEMORY", "PACKAGES", "controller_module", "cpu_context", "memory_storage", "use_port"]

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
