"""Similar-Product engine template on the card (implicit ALS item similarity)."""

from predictionio_tpu_torch.templates.similarproduct.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    DataSourceParams,
    Query,
    SimilarProductDataSource,
    SimilarProductModel,
    TrainingData,
    engine_factory,
)

__all__ = [
    "ALSAlgorithm",
    "ALSAlgorithmParams",
    "DataSourceParams",
    "Query",
    "SimilarProductDataSource",
    "SimilarProductModel",
    "TrainingData",
    "engine_factory",
]
