"""Persistent models — models that save themselves outside the blob store.

Parity: ``core/controller/PersistentModel.scala`` (``trait PersistentModel``
+ ``PersistentModelLoader``). The reference uses this for PAlgorithm models
too big / too distributed for java serialization (factors on HDFS). Here
the analog is a model checkpointed to its own directory (e.g. an orbax
checkpoint of sharded arrays) rather than pickled into the ``Models`` repo.

A model class opts in by implementing :class:`PersistentModel`; the engine
then stores only a :class:`PersistentModelManifest` in the blob store and
calls ``<ModelClass>.load(instance_id, params)`` at deploy
(``Engine.prepareDeploy`` parity).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, ClassVar

from predictionio_tpu_torch.controller.params import Params

__all__ = ["PersistentModel", "PersistentModelManifest"]


@dataclasses.dataclass(frozen=True)
class PersistentModelManifest:
    """Marker persisted in place of the model bytes
    (parity: the reference's ``PersistentModelManifest`` case class)."""

    class_path: str  # "package.module:ClassName"


class PersistentModel(abc.ABC):
    """Mixin for self-persisting models."""

    @abc.abstractmethod
    def save(self, instance_id: str, params: Params) -> bool:
        """Persist; return True if saved (False -> fall back to pickling)."""

    @classmethod
    @abc.abstractmethod
    def load(cls, instance_id: str, params: Params) -> "PersistentModel":
        """Restore what :meth:`save` wrote."""

    @classmethod
    def class_path(cls) -> str:
        return f"{cls.__module__}:{cls.__qualname__}"


def load_persistent_model(manifest: PersistentModelManifest, instance_id: str, params: Params) -> Any:
    """Resolve a manifest back to a live model (``PersistentModelLoader``)."""
    from predictionio_tpu_torch.utils.reflection import resolve_attr

    return resolve_attr(manifest.class_path).load(instance_id, params)
