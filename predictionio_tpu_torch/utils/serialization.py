"""Model blob (de)serialization across the train->serve boundary.

Counterpart of ``predictionio_tpu/utils/serialization.py``, with the same
format: the magic ``PIOTPU1\\x00`` and a pickle. Parity: the reference
java-serializes models into the ``Models`` repo
(``core/controller/Engine.scala`` ``makeSerializableModels``).

Tensors become host numpy arrays when pickled, wherever they sit in the
model (as the JAX package's ``_to_host`` does for ``jax.Array``): a blob
never pins a device. Deploy-time placement is the algorithm's
``prepare_model_for_serving``.

:func:`loads_model` also reads blobs the JAX package wrote. Its unpickler
maps the JAX package's model classes to the port's through an explicit
table, refuses every other class of the JAX package with a clear error,
and never imports one. The two ``BiMap`` classes have the same
``__slots__``, so their pickled state is the same.
"""

from __future__ import annotations

import io
import pickle
from typing import Any

import torch

from predictionio_tpu_torch.utils.reflection import JAX_PACKAGE

__all__ = ["dumps_model", "loads_model"]

_MAGIC = b"PIOTPU1\x00"

#: (module, name) of a JAX-package class -> (module, name) of the port's
_JAX_CLASSES = {
    ("predictionio_tpu.templates.recommendation.engine", "ALSModel"): (
        "predictionio_tpu_torch.templates.recommendation.engine", "ALSModel"),
    ("predictionio_tpu.data.aggregator", "BiMap"): (
        "predictionio_tpu_torch.data.bimap", "BiMap"),
    ("predictionio_tpu.controller.persistent", "PersistentModelManifest"): (
        "predictionio_tpu_torch.controller.persistent", "PersistentModelManifest"),
}


class _HostPickler(pickle.Pickler):
    """Pickles every tensor as the numpy array of its host copy."""

    def reducer_override(self, obj: Any) -> Any:
        if isinstance(obj, torch.Tensor):
            return obj.detach().cpu().numpy().__reduce__()
        return NotImplemented


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        mapped = _JAX_CLASSES.get((module, name))
        if mapped is not None:
            module, name = mapped
        elif module == JAX_PACKAGE or module.startswith(JAX_PACKAGE + "."):
            raise pickle.UnpicklingError(
                f"model blob holds {module}.{name}, a class of the JAX package "
                "that the port has no counterpart for (known: "
                + ", ".join(f"{m}.{n}" for m, n in _JAX_CLASSES) + ")"
            )
        return super().find_class(module, name)


def dumps_model(model: Any) -> bytes:
    """Object -> bytes. Tensors become numpy arrays."""
    buf = io.BytesIO()
    buf.write(_MAGIC)
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(model)
    return buf.getvalue()


def loads_model(blob: bytes) -> Any:
    """Inverse of :func:`dumps_model`, and reader of the JAX package's
    blobs; arrays stay numpy until the algorithm's
    ``prepare_model_for_serving`` places them on the device."""
    if not blob.startswith(_MAGIC):
        raise ValueError("Not a predictionio_tpu model blob (bad magic)")
    return _PortUnpickler(io.BytesIO(blob[len(_MAGIC):])).load()
