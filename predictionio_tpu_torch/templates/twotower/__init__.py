"""Two-Tower retrieval engine template on the card."""

from predictionio_tpu_torch.templates.twotower.engine import (
    ItemScore,
    PredictedResult,
    Query,
    RecallAtK,
    TrainingData,
    TwoTowerAlgorithm,
    TwoTowerParams,
    TwoTowerServingModel,
)

__all__ = [
    "ItemScore",
    "PredictedResult",
    "Query",
    "RecallAtK",
    "TrainingData",
    "TwoTowerAlgorithm",
    "TwoTowerParams",
    "TwoTowerServingModel",
]
