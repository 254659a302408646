"""Classification engine: $set attribute events -> NB / LR on the device -> label queries.

Counterpart of ``predictionio_tpu/templates/classification/engine.py``
(parity: the reference's scala-parallel-classification template):

* :class:`ClassificationDataSource` reads each user entity's current
  properties (attributes + label) through the port's
  ``PEventStore.aggregate_properties``, sorted by entity id, and
  ``read_eval`` splits them round-robin into ``evalK`` folds;
* :class:`NaiveBayesAlgorithm` and :class:`LRAlgorithm` train with
  :mod:`predictionio_tpu_torch.ops.classify` on the context's device (LR
  on standardised features, the transform kept in the model); the model
  is a dict of host numpy (the NamedTuples keep the reference's fields),
  and ``prepare_model_for_serving`` places the NB or LR tensors on the
  algorithm's device, where ``predict`` and ``batch_predict`` score;
* :class:`Accuracy` scores ``pio eval``.

Query ``{"attr0": 2, "attr1": 0, "attr2": 0}`` -> ``{"label": "...",
"confidence": p}``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    AverageMetric,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    Params,
    SanityCheck,
    WorkflowContext,
)
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.store import PEventStore
from predictionio_tpu_torch.templates.classifier_util import ClassifierBase, features_on
from predictionio_tpu_torch.ops.classify import (
    logreg_predict_proba,
    nb_predict_log_proba,
    to_numpy,
    train_logreg,
    train_naive_bayes,
)

__all__ = [
    "DataSourceParams",
    "TrainingData",
    "ClassificationDataSource",
    "NaiveBayesParams",
    "NaiveBayesAlgorithm",
    "LRParams",
    "LRAlgorithm",
    "PredictedResult",
    "Accuracy",
    "engine_factory",
]


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    label: str
    confidence: float | None = None

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {"label": self.label}
        if self.confidence is not None:
            out["confidence"] = self.confidence
        return out


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    entity_type: str = "user"
    attributes: tuple = ("attr0", "attr1", "attr2")
    label: str = "plan"
    eval_k: int = 3
    json_aliases = {"appName": "app_name", "entityType": "entity_type", "evalK": "eval_k"}


@dataclasses.dataclass
class TrainingData(SanityCheck):
    x: np.ndarray  # [N, F]
    y: np.ndarray  # [N] int
    label_index: BiMap
    attributes: tuple

    def sanity_check(self) -> None:
        if len(self.x) == 0:
            raise ValueError("No labeled entities found — check appName/attributes")
        if len(self.x) != len(self.y):
            raise ValueError("features/labels misaligned")


class ClassificationDataSource(DataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        super().__init__(params)

    def _read_rows(self, ctx: WorkflowContext) -> list[tuple[tuple, str]]:
        p = self.params
        props = PEventStore.aggregate_properties(
            app_name=p.app_name,
            entity_type=p.entity_type,
            required=list(p.attributes) + [p.label],
        )
        rows = []
        for _entity_id, pm in sorted(props.items()):
            feats = tuple(float(pm.get_as(a, float)) for a in p.attributes)
            rows.append((feats, str(pm[p.label])))
        return rows

    @staticmethod
    def _to_training_data(rows: Sequence[tuple[tuple, str]], attributes: tuple) -> TrainingData:
        label_index = BiMap.string_index(label for _, label in rows)
        x = np.asarray([f for f, _ in rows], dtype=np.float32).reshape(len(rows), len(attributes))
        y = np.fromiter((label_index[l] for _, l in rows), np.int64, len(rows))
        return TrainingData(x, y, label_index, attributes)

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        return self._to_training_data(self._read_rows(ctx), self.params.attributes)

    def read_eval(self, ctx: WorkflowContext):
        rows = self._read_rows(ctx)
        k = max(2, self.params.eval_k)
        folds = []
        for fold in range(k):
            train = [r for i, r in enumerate(rows) if i % k != fold]
            held = [r for i, r in enumerate(rows) if i % k == fold]
            td = self._to_training_data(train, self.params.attributes)
            qa = [(dict(zip(self.params.attributes, feats)), label) for feats, label in held]
            folds.append((td, {"fold": fold}, qa))
        return folds


@dataclasses.dataclass(frozen=True)
class NaiveBayesParams(Params):
    lambda_: float = 1.0
    json_aliases = {"lambda": "lambda_"}


class NaiveBayesAlgorithm(ClassifierBase):
    params_class = NaiveBayesParams
    kind = "nb"

    def __init__(self, params: NaiveBayesParams, device: str | torch.device | None = None):
        super().__init__(params, device)

    def train(self, ctx: WorkflowContext, pd: TrainingData):
        model = train_naive_bayes(
            pd.x, pd.y, num_classes=len(pd.label_index), smoothing=self.params.lambda_, device=self.device
        )
        return {"nb": to_numpy(model), "label_index": pd.label_index, "attributes": tuple(pd.attributes)}

    def _proba(self, model, x: np.ndarray) -> np.ndarray:
        nb = self._placed(model)
        return nb_predict_log_proba(nb, features_on(nb, x)).cpu().numpy()

    def _result(self, model, logp: np.ndarray) -> PredictedResult:
        idx = int(np.argmax(logp))
        # normalized posterior as confidence
        p = np.exp(logp - logp.max())
        p /= p.sum()
        return PredictedResult(label=model["label_index"].inverse(idx), confidence=float(p[idx]))


@dataclasses.dataclass(frozen=True)
class LRParams(Params):
    iterations: int = 200
    step_size: float = 1.0
    reg: float = 1e-4
    json_aliases = {"stepSize": "step_size"}


class LRAlgorithm(ClassifierBase):
    params_class = LRParams
    kind = "lr"

    def __init__(self, params: LRParams, device: str | torch.device | None = None):
        super().__init__(params, device)

    def train(self, ctx: WorkflowContext, pd: TrainingData):
        # standardize features for GD conditioning; bake the transform
        # into the model so serving applies it identically
        mean = pd.x.mean(axis=0)
        std = pd.x.std(axis=0)
        std[std == 0] = 1.0
        xs = (pd.x - mean) / std
        model = train_logreg(
            xs, pd.y, num_classes=len(pd.label_index),
            iterations=self.params.iterations, lr=self.params.step_size,
            reg=self.params.reg, device=self.device,
        )
        return {
            "lr": to_numpy(model),
            "mean": mean,
            "std": std,
            "label_index": pd.label_index,
            "attributes": tuple(pd.attributes),
        }

    def _proba(self, model, x: np.ndarray) -> np.ndarray:
        xs = (x - model["mean"]) / model["std"]
        lr = self._placed(model)
        return logreg_predict_proba(lr, features_on(lr, xs)).cpu().numpy()

    def _result(self, model, proba: np.ndarray) -> PredictedResult:
        idx = int(np.argmax(proba))
        return PredictedResult(label=model["label_index"].inverse(idx), confidence=float(proba[idx]))


class Accuracy(AverageMetric):
    """Fraction of correct labels (parity: the template's Accuracy metric)."""

    def calculate_unit(self, query, predicted: PredictedResult, actual: str) -> float:
        return 1.0 if predicted.label == str(actual) else 0.0


def engine_factory() -> Engine:
    return Engine(
        datasource_class=ClassificationDataSource,
        preparator_class=IdentityPreparator,
        algorithms_class_map={"naive": NaiveBayesAlgorithm, "lr": LRAlgorithm},
        serving_class=FirstServing,
    )
