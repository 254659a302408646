"""DASE controller API — the user-facing engine framework of the port.

Counterpart of ``predictionio_tpu/controller/``. Engine templates import
from here:

    from predictionio_tpu_torch.controller import (
        Engine, EngineParams, DataSource, Preparator, IdentityPreparator,
        TorchAlgorithm, LocalAlgorithm, Serving, FirstServing, Params,
        AverageMetric, Evaluation, EngineParamsGenerator,
    )

``mesh_context`` arranges one process's devices as a ``(data, model)``
training mesh (``pio train --mesh``); the data axis spans the processes
of a multi-process job.
"""

from predictionio_tpu_torch.controller.base import create_doer
from predictionio_tpu_torch.controller.components import (
    Algorithm,
    AverageServing,
    DataSource,
    FirstServing,
    IdentityPreparator,
    LocalAlgorithm,
    Preparator,
    SanityCheck,
    Serving,
    TorchAlgorithm,
)
from predictionio_tpu_torch.controller.context import TrainingMesh, WorkflowContext, local_context, mesh_context
from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineFactory,
    EngineParams,
    SimpleEngine,
    resolve_engine_factory,
)
from predictionio_tpu_torch.controller.evaluation import (
    EngineParamsGenerator,
    Evaluation,
    MetricEvaluator,
    MetricEvaluatorResult,
    MetricScores,
)
from predictionio_tpu_torch.controller.metrics import (
    AverageMetric,
    Metric,
    OptionAverageMetric,
    StdevMetric,
    SumMetric,
    ZeroMetric,
)
from predictionio_tpu_torch.controller.params import (
    EmptyParams,
    Params,
    ParamsError,
    params_from_json,
    params_to_json,
)
from predictionio_tpu_torch.controller.persistent import PersistentModel, PersistentModelManifest

__all__ = [
    "Algorithm",
    "AverageMetric",
    "AverageServing",
    "DataSource",
    "EmptyParams",
    "Engine",
    "EngineFactory",
    "EngineParams",
    "EngineParamsGenerator",
    "Evaluation",
    "FirstServing",
    "IdentityPreparator",
    "LocalAlgorithm",
    "Metric",
    "MetricEvaluator",
    "MetricEvaluatorResult",
    "MetricScores",
    "OptionAverageMetric",
    "Params",
    "ParamsError",
    "PersistentModel",
    "PersistentModelManifest",
    "Preparator",
    "SanityCheck",
    "Serving",
    "SimpleEngine",
    "StdevMetric",
    "SumMetric",
    "TorchAlgorithm",
    "TrainingMesh",
    "WorkflowContext",
    "ZeroMetric",
    "create_doer",
    "local_context",
    "mesh_context",
    "params_from_json",
    "params_to_json",
    "resolve_engine_factory",
]
