"""Import-path resolution shared by the reflective entry points.

Counterpart of ``predictionio_tpu/utils/reflection.py``. Parity: the
reference resolves ``engineFactory`` / ``PersistentModelLoader`` class
names via JVM reflection (``core/workflow/CreateWorkflow.scala``,
``core/controller/PersistentModel.scala``); here a path is either
``"package.module:Qualified.Name"`` or a plain dotted path whose last
segment is the attribute.

A path into the JAX package (``predictionio_tpu.…``) resolves to the same
path in the port (``predictionio_tpu_torch.…``), by text: the port never
imports the JAX package. So one engine.json drives both packages, and a
path whose counterpart the port lacks fails with a message that says so.
"""

from __future__ import annotations

import importlib
from typing import Any

__all__ = ["resolve_attr", "port_path"]

JAX_PACKAGE = "predictionio_tpu"
PORT_PACKAGE = "predictionio_tpu_torch"


def port_path(path: str) -> str:
    """``predictionio_tpu.x.y:z`` -> ``predictionio_tpu_torch.x.y:z``; any
    other path is returned unchanged."""
    for sep in (".", ":"):
        if path.startswith(JAX_PACKAGE + sep):
            return PORT_PACKAGE + path[len(JAX_PACKAGE):]
    return path


def resolve_attr(path: str) -> Any:
    """Resolve ``module:qualname`` (preferred) or ``module.attr`` to an object."""
    target = port_path(path)
    if ":" in target:
        module_name, _, qualname = target.partition(":")
    else:
        module_name, _, qualname = target.rpartition(".")
        if not module_name:
            raise ValueError(f"Cannot resolve import path '{path}'")
    if module_name.split(".")[0] == JAX_PACKAGE:
        raise ImportError(f"'{path}' names the JAX package itself; the port never imports it")
    in_port = module_name.split(".")[0] == PORT_PACKAGE
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError as e:
        missing = e.name or ""
        if in_port and (module_name == missing or module_name.startswith(missing + ".")):
            raise ImportError(
                f"'{path}' has no counterpart in the port yet: no module '{module_name}'"
            ) from e
        raise
    obj: Any = module
    for part in qualname.split("."):
        try:
            obj = getattr(obj, part)
        except AttributeError as e:
            if in_port:
                raise ImportError(
                    f"'{path}' has no counterpart in the port yet: "
                    f"'{module_name}' defines no '{qualname}'"
                ) from e
            raise
    return obj
