"""Text-Classification engine: text events -> TF-IDF -> NB/LR on the device -> category.

Counterpart of ``predictionio_tpu/templates/textclassification/engine.py``
(parity: the reference's text-classification template):

* :class:`TextDataSource` reads labelled texts from ``$set`` events of
  ``content`` entities, sorted by entity id; ``read_eval`` splits them
  round-robin into ``evalK`` folds;
* :class:`TfIdfPreparator` fits the hashing TF-IDF of
  :mod:`predictionio_tpu_torch.ops.text` (``numFeatures`` wide, default
  4,096) on the host and vectorises the corpus;
* :class:`NBTextAlgorithm` and :class:`LRTextAlgorithm` train with
  :mod:`predictionio_tpu_torch.ops.classify` on the context's device; the
  model keeps the fitted featurizer and host numpy NamedTuples, and
  ``prepare_model_for_serving`` places the NB or LR tensors on the
  algorithm's device, where ``predict`` and ``batch_predict`` score.

Query ``{"text": "..."}`` -> ``{"category": "...", "confidence": p}``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    DataSource,
    Engine,
    FirstServing,
    Params,
    Preparator,
    SanityCheck,
    WorkflowContext,
)
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.store import PEventStore
from predictionio_tpu_torch.ops.classify import (
    logreg_predict_proba,
    nb_predict_log_proba,
    to_numpy,
    train_logreg,
    train_naive_bayes,
)
from predictionio_tpu_torch.ops.text import HashingTfIdf, fit_tfidf
from predictionio_tpu_torch.templates.classifier_util import ClassifierBase, features_on

__all__ = [
    "DataSourceParams",
    "TextDataSource",
    "TfIdfPreparator",
    "PreparatorParams",
    "NBTextParams",
    "NBTextAlgorithm",
    "LRTextParams",
    "LRTextAlgorithm",
    "PredictedResult",
    "engine_factory",
]


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    category: str
    confidence: float

    def to_json(self) -> dict[str, Any]:
        return {"category": self.category, "confidence": self.confidence}


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    entity_type: str = "content"
    text_property: str = "text"
    label_property: str = "category"
    eval_k: int = 3
    json_aliases = {
        "appName": "app_name",
        "entityType": "entity_type",
        "evalK": "eval_k",
    }


@dataclasses.dataclass
class TextTrainingData(SanityCheck):
    texts: list
    labels: list

    def sanity_check(self) -> None:
        if not self.texts:
            raise ValueError("No labeled text found — check appName/entityType")


class TextDataSource(DataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        super().__init__(params)

    def _read_rows(self, ctx: WorkflowContext) -> TextTrainingData:
        p = self.params
        props = PEventStore.aggregate_properties(
            app_name=p.app_name,
            entity_type=p.entity_type,
            required=[p.text_property, p.label_property],
        )
        texts, labels = [], []
        for _eid, pm in sorted(props.items()):
            texts.append(str(pm[p.text_property]))
            labels.append(str(pm[p.label_property]))
        return TextTrainingData(texts, labels)

    def read_training(self, ctx: WorkflowContext) -> TextTrainingData:
        return self._read_rows(ctx)

    def read_eval(self, ctx: WorkflowContext):
        td = self._read_rows(ctx)
        k = max(2, self.params.eval_k)
        folds = []
        for fold in range(k):
            tr_t = [t for i, t in enumerate(td.texts) if i % k != fold]
            tr_l = [l for i, l in enumerate(td.labels) if i % k != fold]
            qa = [({"text": t}, l) for i, (t, l) in enumerate(zip(td.texts, td.labels)) if i % k == fold]
            folds.append((TextTrainingData(tr_t, tr_l), {"fold": fold}, qa))
        return folds


@dataclasses.dataclass(frozen=True)
class PreparatorParams(Params):
    num_features: int = 4096
    stopwords: tuple = ()
    json_aliases = {"numFeatures": "num_features"}


@dataclasses.dataclass
class PreparedTextData:
    x: np.ndarray  # [N, F] tf-idf
    y: np.ndarray  # [N]
    label_index: BiMap
    featurizer: HashingTfIdf


class TfIdfPreparator(Preparator):
    """Fits TF-IDF on the corpus and vectorizes
    (parity: the template's Preparator with HashingTF/IDF)."""

    params_class = PreparatorParams

    def __init__(self, params: PreparatorParams):
        super().__init__(params)

    def prepare(self, ctx: WorkflowContext, td: TextTrainingData) -> PreparedTextData:
        featurizer = fit_tfidf(td.texts, num_features=self.params.num_features, stopwords=self.params.stopwords)
        label_index = BiMap.string_index(td.labels)
        x = featurizer.transform(td.texts)
        y = np.fromiter((label_index[l] for l in td.labels), np.int64, len(td.labels))
        return PreparedTextData(x, y, label_index, featurizer)


class _TextAlgoBase(ClassifierBase):
    """The classifiers' plumbing over the fitted featurizer: a query's text
    -> its TF-IDF row -> the category."""

    def _features(self, model, query: Mapping[str, Any]) -> np.ndarray:
        if not isinstance(query, Mapping) or "text" not in query:
            raise ValueError('Query must be {"text": "..."}')
        return model["featurizer"].transform([str(query["text"])])


@dataclasses.dataclass(frozen=True)
class NBTextParams(Params):
    lambda_: float = 1.0
    json_aliases = {"lambda": "lambda_"}


class NBTextAlgorithm(_TextAlgoBase):
    params_class = NBTextParams
    kind = "nb"

    def __init__(self, params: NBTextParams, device: str | torch.device | None = None):
        super().__init__(params, device)

    def train(self, ctx: WorkflowContext, pd: PreparedTextData):
        nb = train_naive_bayes(
            pd.x, pd.y, num_classes=len(pd.label_index), smoothing=self.params.lambda_, device=self.device
        )
        return {"nb": to_numpy(nb), "label_index": pd.label_index, "featurizer": pd.featurizer}

    def _proba(self, model, x: np.ndarray) -> np.ndarray:
        nb = self._placed(model)
        return nb_predict_log_proba(nb, features_on(nb, x)).cpu().numpy()

    def _result(self, model, logp: np.ndarray) -> PredictedResult:
        p = np.exp(logp - logp.max())
        p /= p.sum()
        idx = int(np.argmax(p))
        return PredictedResult(model["label_index"].inverse(idx), float(p[idx]))


@dataclasses.dataclass(frozen=True)
class LRTextParams(Params):
    iterations: int = 300
    step_size: float = 1.0
    reg: float = 1e-4
    json_aliases = {"stepSize": "step_size"}


class LRTextAlgorithm(_TextAlgoBase):
    params_class = LRTextParams
    kind = "lr"

    def __init__(self, params: LRTextParams, device: str | torch.device | None = None):
        super().__init__(params, device)

    def train(self, ctx: WorkflowContext, pd: PreparedTextData):
        lr = train_logreg(
            pd.x, pd.y, num_classes=len(pd.label_index),
            iterations=self.params.iterations, lr=self.params.step_size,
            reg=self.params.reg, device=self.device,
        )
        return {"lr": to_numpy(lr), "label_index": pd.label_index, "featurizer": pd.featurizer}

    def _proba(self, model, x: np.ndarray) -> np.ndarray:
        lr = self._placed(model)
        return logreg_predict_proba(lr, features_on(lr, x)).cpu().numpy()

    def _result(self, model, proba: np.ndarray) -> PredictedResult:
        idx = int(np.argmax(proba))
        return PredictedResult(model["label_index"].inverse(idx), float(proba[idx]))


def engine_factory() -> Engine:
    return Engine(
        datasource_class=TextDataSource,
        preparator_class=TfIdfPreparator,
        algorithms_class_map={"nb": NBTextAlgorithm, "lr": LRTextAlgorithm},
        serving_class=FirstServing,
    )
