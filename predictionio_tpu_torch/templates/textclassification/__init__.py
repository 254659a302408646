"""Text-Classification engine template on the device (hashing TF-IDF +
NB / LR)."""

from predictionio_tpu_torch.templates.textclassification.engine import (
    DataSourceParams,
    LRTextAlgorithm,
    LRTextParams,
    NBTextAlgorithm,
    NBTextParams,
    PreparatorParams,
    TextDataSource,
    TfIdfPreparator,
    engine_factory,
)

__all__ = [
    "DataSourceParams",
    "LRTextAlgorithm",
    "LRTextParams",
    "NBTextAlgorithm",
    "NBTextParams",
    "PreparatorParams",
    "TextDataSource",
    "TfIdfPreparator",
    "engine_factory",
]
