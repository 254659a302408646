"""An engine whose DataSource hands the workflow a ``TrainingData`` already
made in memory, so the port's tests and ``chip_smoke.py`` train through
``run_train`` into a store and serve the stored instance without writing
events first.

:func:`arrays_variant` takes the training data and the algorithm class
and returns the engine variant of :func:`arrays_engine`, whose factory
path ``torch_arrays_engine:arrays_engine`` a ``QueryService`` resolves
again at deploy. Imports nothing of JAX: ``chip_smoke.py`` imports it on
the card machine.
"""

from __future__ import annotations

from predictionio_tpu_torch.controller import DataSource, SimpleEngine
from predictionio_tpu_torch.workflow import load_engine_variant

#: the training data the DataSource hands over and the algorithm class the
#: factory builds, as the last :func:`arrays_variant` left them
ARRAYS: dict = {}


class ArraysDataSource(DataSource):
    def read_training(self, ctx):
        return ARRAYS["td"]


def arrays_engine() -> SimpleEngine:
    return SimpleEngine(ArraysDataSource, ARRAYS["algorithm"])


def arrays_variant(name: str, td, algorithm: type, params: dict):
    """The engine variant ``<name>-arrays`` of :func:`arrays_engine` over
    ``td`` with one ``algorithm`` of ``params``."""
    ARRAYS.clear()
    ARRAYS.update(td=td, algorithm=algorithm)
    return load_engine_variant({
        "id": f"{name}-arrays", "version": "1", "engineFactory": "torch_arrays_engine:arrays_engine",
        "algorithms": [{"name": "", "params": params}],
    })
