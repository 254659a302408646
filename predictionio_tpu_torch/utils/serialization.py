"""Model blob (de)serialization across the train->serve boundary.

Counterpart of ``predictionio_tpu/utils/serialization.py``, with the same
format: the magic ``PIOTPU1\\x00`` and a pickle. Parity: the reference
java-serializes models into the ``Models`` repo
(``core/controller/Engine.scala`` ``makeSerializableModels``).

Tensors become host numpy arrays when pickled, wherever they sit in the
model (as the JAX package's ``_to_host`` does for ``jax.Array``): a blob
never pins a device. Deploy-time placement is the algorithm's
``prepare_model_for_serving``.

A blob has one format whichever package wrote it. The model classes the
two packages share (:data:`_JAX_CLASSES`) are written under the JAX
package's paths, so the JAX package's plain ``pickle.loads`` reads a port
blob as its own classes, and :func:`loads_model` maps those paths back to
the port's classes. Neither direction imports the JAX package: the
writer is the pure-Python pickler with its class-path check skipped for
the mapped classes (the C pickler imports a class's module to check it),
and the reader refuses every other class of the JAX package with a clear
error. The two ``BiMap`` classes have the same ``__slots__``, each
mapped dataclass the same fields and each mapped NamedTuple (the
classifiers' models, the fitted TF-IDF) the same fields in the same
order, so their pickled state is the same.
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
    ("predictionio_tpu.templates.twotower.engine", "TwoTowerServingModel"): (
        "predictionio_tpu_torch.templates.twotower.engine", "TwoTowerServingModel"),
    ("predictionio_tpu.templates.similarproduct.engine", "SimilarProductModel"): (
        "predictionio_tpu_torch.templates.similarproduct.engine", "SimilarProductModel"),
    ("predictionio_tpu.templates.ecommerce.engine", "ECommModel"): (
        "predictionio_tpu_torch.templates.ecommerce.engine", "ECommModel"),
    ("predictionio_tpu.ops.classify", "NaiveBayesModel"): (
        "predictionio_tpu_torch.ops.classify", "NaiveBayesModel"),
    ("predictionio_tpu.ops.classify", "LogRegModel"): (
        "predictionio_tpu_torch.ops.classify", "LogRegModel"),
    ("predictionio_tpu.ops.text", "HashingTfIdf"): (
        "predictionio_tpu_torch.ops.text", "HashingTfIdf"),
}

#: the inverse table: the port's (module, name) -> the JAX package's
_PORT_CLASSES = {port: jax for jax, port in _JAX_CLASSES.items()}


class _HostPickler(pickle._Pickler):
    """Pickles every tensor as the numpy array of its host copy, and each
    class of :data:`_PORT_CLASSES` under the JAX package's path."""

    def reducer_override(self, obj: Any) -> Any:
        if isinstance(obj, torch.Tensor):
            return obj.detach().cpu().numpy().__reduce__()
        return NotImplemented

    def save_global(self, obj: Any, name: str | None = None) -> None:
        key = (getattr(obj, "__module__", None), name or getattr(obj, "__qualname__", None))
        mapped = _PORT_CLASSES.get(key)
        if mapped is None:
            super().save_global(obj, name)
            return
        # what the base class writes at protocol >= 4, without importing
        # the module it names
        self.save(mapped[0])
        self.save(mapped[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


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
    """Object -> bytes. Tensors become numpy arrays; the mapped classes are
    written under the JAX package's paths."""
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
