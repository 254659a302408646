"""Recommendation engine template on the card (ALS)."""

from predictionio_tpu_torch.templates.recommendation.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    ALSModel,
    Actual,
    DataSourceParams,
    ItemScore,
    PrecisionAtK,
    PredictedResult,
    Query,
    RecommendationDataSource,
    TrainingData,
    engine_factory,
)

__all__ = [
    "ALSAlgorithm",
    "ALSAlgorithmParams",
    "ALSModel",
    "Actual",
    "DataSourceParams",
    "ItemScore",
    "PrecisionAtK",
    "PredictedResult",
    "Query",
    "RecommendationDataSource",
    "TrainingData",
    "engine_factory",
]
