"""E-Commerce Recommendation engine template on the card (implicit ALS with
serving-time business rules)."""

from predictionio_tpu_torch.templates.ecommerce.engine import (
    DataSourceParams,
    ECommAlgorithm,
    ECommAlgorithmParams,
    ECommerceDataSource,
    ECommModel,
    Query,
    TrainingData,
    engine_factory,
)

__all__ = [
    "DataSourceParams",
    "ECommAlgorithm",
    "ECommAlgorithmParams",
    "ECommModel",
    "ECommerceDataSource",
    "Query",
    "TrainingData",
    "engine_factory",
]
