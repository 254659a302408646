"""Workflow runtime of the port — train and deploy drivers.

Counterpart of ``predictionio_tpu/workflow/``. Parity:
``core/src/main/scala/org/apache/predictionio/workflow/``: ``CreateWorkflow``
(train entry), ``CoreWorkflow`` (train and evaluation orchestration with
their lineage records) and ``CreateServer`` (the query server, in
:mod:`predictionio_tpu_torch.workflow.serving`). ``pio train`` runs the
workflow in-process, on one device.
"""

from predictionio_tpu_torch.workflow.core import WorkflowParams, run_evaluation, run_train
from predictionio_tpu_torch.workflow.engine_json import EngineVariant, load_engine_variant

__all__ = [
    "EngineVariant",
    "WorkflowParams",
    "load_engine_variant",
    "run_evaluation",
    "run_train",
]
