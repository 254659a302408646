"""engine.json loading — the engine variant manifest.

Counterpart of ``predictionio_tpu/workflow/engine_json.py``. Parity: the engine-variant parsing half of
``core/workflow/CreateWorkflow.scala`` + ``core/workflow/WorkflowUtils.scala``.
The file format is kept byte-compatible with the reference so existing
engine.json files work unchanged::

    {
      "id": "default",
      "description": "Default settings",
      "engineFactory": "my_engine:RecommendationEngine",
      "datasource": {"params": {"appName": "MyApp"}},
      "algorithms": [{"name": "als", "params": {"rank": 10}}]
    }

(The reference's ``engineFactory`` is a JVM FQCN; here it is a Python
import path, ``module:attr`` or dotted. A path into the JAX package
builds the port's engine of the same path, so the engine.json that ``pio
template get`` writes drives both packages.)
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping

from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineParams,
    resolve_engine_factory,
)

__all__ = ["EngineVariant", "load_engine_variant"]


@dataclasses.dataclass(frozen=True)
class EngineVariant:
    """One parsed engine.json variant."""

    id: str
    version: str
    description: str
    engine_factory: str
    raw: dict  # the full JSON object (component params blocks live here)

    def build_engine(self) -> Engine:
        return resolve_engine_factory(self.engine_factory)()

    def engine_params(self, engine: Engine) -> EngineParams:
        return engine.params_from_json(self.raw)


def load_engine_variant(path_or_obj: str | Mapping[str, Any]) -> EngineVariant:
    """Load engine.json from a path (or an already-parsed object).

    ``engineFactory`` is required (parity: CreateWorkflow fails without it).
    """
    if isinstance(path_or_obj, str):
        if not os.path.exists(path_or_obj):
            raise FileNotFoundError(f"engine variant file not found: {path_or_obj}")
        with open(path_or_obj) as f:
            obj = json.load(f)
    else:
        obj = dict(path_or_obj)
    factory = obj.get("engineFactory")
    if not factory:
        raise ValueError("engine.json must declare 'engineFactory'")
    return EngineVariant(
        id=str(obj.get("id", "default")),
        version=str(obj.get("version", "")),
        description=str(obj.get("description", "")),
        engine_factory=str(factory),
        raw=obj,
    )
