"""Classification engine template on the device (Naive Bayes / Logistic
Regression)."""

from predictionio_tpu_torch.templates.classification.engine import (
    Accuracy,
    ClassificationDataSource,
    DataSourceParams,
    LRAlgorithm,
    LRParams,
    NaiveBayesAlgorithm,
    NaiveBayesParams,
    PredictedResult,
    TrainingData,
    engine_factory,
)

__all__ = [
    "Accuracy",
    "ClassificationDataSource",
    "DataSourceParams",
    "LRAlgorithm",
    "LRParams",
    "NaiveBayesAlgorithm",
    "NaiveBayesParams",
    "PredictedResult",
    "TrainingData",
    "engine_factory",
]
