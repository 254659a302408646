"""Two-Tower retrieval engine template on the card."""

from predictionio_tpu_torch.templates.twotower.engine import (
    DataSourceParams,
    ItemScore,
    PredictedResult,
    Query,
    RecallAtK,
    TrainingData,
    TwoTowerAlgorithm,
    TwoTowerDataSource,
    TwoTowerParams,
    TwoTowerServingModel,
    engine_factory,
)

__all__ = [
    "DataSourceParams",
    "ItemScore",
    "PredictedResult",
    "Query",
    "RecallAtK",
    "TrainingData",
    "TwoTowerAlgorithm",
    "TwoTowerDataSource",
    "TwoTowerParams",
    "TwoTowerServingModel",
    "engine_factory",
]
