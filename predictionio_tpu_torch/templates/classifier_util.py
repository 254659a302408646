"""Shared code of the classification templates (classification and
text classification): the query-to-label plumbing of a Naive Bayes or
logistic-regression classifier whose model tensors sit on the
algorithm's device. A helper module directly under ``templates/``, so
each template stays copy-out-able on its own.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.controller import TorchAlgorithm
from predictionio_tpu_torch.ops.classify import to_device

__all__ = ["ClassifierBase", "features_on"]


class ClassifierBase(TorchAlgorithm):
    """Shared plumbing: query dict -> feature vector -> label, the model's
    NB or LR tensors on :attr:`device` for serving."""

    #: the model key of the classifier's NamedTuple ("nb" or "lr")
    kind = ""

    def _features(self, model, query: Mapping[str, Any]) -> np.ndarray:
        attrs = model["attributes"]
        missing = [a for a in attrs if a not in query]
        if missing:
            raise ValueError(f"Query is missing attribute(s) {missing}")
        return np.asarray([[float(query[a]) for a in attrs]], dtype=np.float32)

    def prepare_model_for_serving(self, model: dict) -> dict:
        model = dict(model)
        model[self.kind] = to_device(model[self.kind], self.device)
        self.warm_up(model)
        return model

    def _placed(self, model):
        """The model's NB or LR NamedTuple as tensors: as placed by
        :meth:`prepare_model_for_serving`, else moved to :attr:`device`."""
        part = model[self.kind]
        return part if isinstance(part[0], torch.Tensor) else to_device(part, self.device)

    def _proba(self, model, x: np.ndarray) -> np.ndarray:
        """Host ``[B, F]`` features -> host ``[B, C]`` log-posteriors (NB) or
        probabilities (LR), computed on the model's device."""
        raise NotImplementedError

    def _result(self, model, row: np.ndarray) -> Any:
        raise NotImplementedError

    def predict(self, model, query: Mapping[str, Any]) -> Any:
        return self._result(model, self._proba(model, self._features(model, query))[0])

    def batch_predict(self, model, queries: Sequence[tuple[int, Any]]) -> list[tuple[int, Any]]:
        """Every query's features through one product on the model's device."""
        if not queries:
            return []
        x = np.concatenate([self._features(model, q) for _, q in queries])
        out = self._proba(model, x)
        return [(idx, self._result(model, row)) for (idx, _), row in zip(queries, out)]


def features_on(part, x: np.ndarray) -> torch.Tensor:
    """``x`` as a float32 tensor on the device of a model's tensors."""
    return torch.as_tensor(x, dtype=torch.float32, device=part[0].device)
