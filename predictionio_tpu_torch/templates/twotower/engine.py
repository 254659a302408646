"""Two-Tower retrieval engine: interaction pairs -> towers trained on the
card -> personalised top-N queries.

Counterpart of ``predictionio_tpu/templates/twotower/engine.py``. This
slice carries the algorithm and its wire types: ``train`` takes a
:class:`TrainingData` of distinct (user, item) pairs built from arrays,
``prepare_model_for_serving`` moves the towers to the device, and
``predict``/``batch_predict`` rank the catalog there by cosine score with
the seen-item filter. engine.json params are byte-compatible
(``embeddingDim``, ``batchSize``, ``learningRate``, ``gemmDtype``,
``fusedCe``, ...); the wire shapes are the Recommendation template's.
"""

from __future__ import annotations

import dataclasses
from types import MappingProxyType
from typing import Any, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.controller.params import Params
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.als import predict_scores, top_k_items_batch
from predictionio_tpu_torch.ops.topk import bucket_k, top_k_scores
from predictionio_tpu_torch.ops.twotower import TwoTowerConfig, train_two_tower
from predictionio_tpu_torch.templates.results import ItemScore, PredictedResult

__all__ = [
    "Query",
    "ItemScore",
    "PredictedResult",
    "TrainingData",
    "TwoTowerParams",
    "TwoTowerServingModel",
    "TwoTowerAlgorithm",
    "RecallAtK",
]


@dataclasses.dataclass(frozen=True)
class Query:
    """``{"user": "u1", "num": 10}`` (wire-compatible with the reference)."""

    user: str
    num: int = 10


@dataclasses.dataclass
class TrainingData:
    """Distinct (user, item) pairs as dense indices, the id maps, and each
    user's seen items (the serving-time filter)."""

    rows: np.ndarray  # user idx, one entry per (user, item) pair
    cols: np.ndarray  # item idx
    user_index: BiMap
    item_index: BiMap
    seen: dict  # user id -> set of item ids

    def sanity_check(self) -> None:
        if self.rows.size == 0:
            raise ValueError("No interaction events found — check appName/eventNames")
        if self.rows.size != self.cols.size:
            raise ValueError("TrainingData arrays are misaligned")


@dataclasses.dataclass(frozen=True)
class TwoTowerParams(Params):
    embedding_dim: int = 32
    batch_size: int = 256
    epochs: int = 5
    learning_rate: float = 0.05
    temperature: float = 0.1
    seed: int = 0
    #: accepted for engine.json compatibility; the port always serves from
    #: the device it trained on
    serve_on_device: bool = False
    device_latency_budget_ms: float = 10.0
    #: "bfloat16" (the fused kernels' type) or "float32"
    gemm_dtype: str = "bfloat16"
    #: fused softmax-CE: "auto" | "off" | "interpret" (ops/fused_ce.py)
    fused_ce: str = "auto"
    json_aliases = {
        "embeddingDim": "embedding_dim",
        "batchSize": "batch_size",
        "learningRate": "learning_rate",
        "serveOnDevice": "serve_on_device",
        "deviceLatencyBudgetMs": "device_latency_budget_ms",
        "gemmDtype": "gemm_dtype",
        "fusedCe": "fused_ce",
    }


@dataclasses.dataclass
class TwoTowerServingModel:
    """L2-normalised towers + id maps + seen filter: host numpy after
    ``train``, device tensors after ``prepare_model_for_serving``."""

    user_vecs: Any  # [U, D]
    item_vecs: Any  # [I, D]
    user_index: BiMap
    item_index: BiMap
    seen: dict
    loss_history: tuple = ()
    #: the training run's phase seconds (``TwoTowerModel.timings``)
    timings: Any = MappingProxyType({})


class TwoTowerAlgorithm:
    params_class = TwoTowerParams
    query_class = Query

    #: queries per scoring product in batch_predict
    BATCH_PREDICT_CHUNK = 2048

    def __init__(self, params: TwoTowerParams, device: str | torch.device | None = None):
        self.params = params
        self.device = resolve_device(device)

    def train(self, pd: TrainingData) -> TwoTowerServingModel:
        pd.sanity_check()
        p = self.params
        model = train_two_tower(
            pd.rows,
            pd.cols,
            num_users=len(pd.user_index),
            num_items=len(pd.item_index),
            config=TwoTowerConfig(
                dim=p.embedding_dim,
                batch_size=p.batch_size,
                epochs=p.epochs,
                learning_rate=p.learning_rate,
                temperature=p.temperature,
                seed=p.seed,
                gemm_dtype=p.gemm_dtype,
                fused_ce=p.fused_ce,
            ),
            device=self.device,
        )
        return TwoTowerServingModel(
            user_vecs=model.user_vecs,
            item_vecs=model.item_vecs,
            user_index=pd.user_index,
            item_index=pd.item_index,
            seen=pd.seen,
            loss_history=model.loss_history,
            timings=model.timings,
        )

    def prepare_model_for_serving(self, model: TwoTowerServingModel) -> TwoTowerServingModel:
        """Move the towers to the device once, then warm the scoring path
        with one query."""
        for name in ("user_vecs", "item_vecs"):
            host = np.asarray(getattr(model, name), np.float32)
            setattr(model, name, torch.as_tensor(host, device=self.device).contiguous())
        self.warm_up(model)
        return model

    def warm_up(self, model: TwoTowerServingModel) -> None:
        """Make the calling thread ready to serve: the device current, and
        one query through the scoring path."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if len(model.user_index):
            self.predict(model, Query(user=model.user_index.keys()[0], num=4))

    @staticmethod
    def _unseen(model: TwoTowerServingModel, ids, scores, seen, num: int) -> PredictedResult:
        """The first ``num`` ranked items not in ``seen``."""
        out = []
        inverse = model.item_index.inverse
        for i, s in zip(ids, scores):
            item = inverse(i)
            if item in seen:
                continue
            out.append(ItemScore(item=item, score=s))
            if len(out) >= num:
                break
        return PredictedResult(tuple(out))

    def predict(self, model: TwoTowerServingModel, query: Query) -> PredictedResult:
        uidx = model.user_index.get(query.user)
        num = int(query.num)
        if uidx is None or num <= 0:
            return PredictedResult(())
        seen = model.seen.get(query.user, ())
        # over-fetch num + |seen| so the seen filter still leaves num items
        n_items = len(model.item_index)
        k = min(num + len(seen), n_items)
        if k <= 0:
            return PredictedResult(())
        scores = predict_scores(model.user_vecs[uidx], model.item_vecs)
        idx, vals = top_k_scores(scores, bucket_k(k, n_items))
        return self._unseen(model, idx[:k].tolist(), vals[:k].tolist(), seen, num)

    def batch_predict(
        self, model: TwoTowerServingModel, queries: Sequence[tuple[int, Query]]
    ) -> list[tuple[int, PredictedResult]]:
        """Score chunks of queries with one ``[B,D]@[D,I]`` product and one
        top-k each (:func:`top_k_items_batch`); the seen filter as in
        :meth:`predict`."""
        n_items = len(model.item_index)
        results: list[tuple[int, PredictedResult]] = []
        valid: list[tuple[int, int, int, int, Any]] = []  # (orig idx, uidx, k, num, seen)
        for idx, q in queries:
            uidx = model.user_index.get(q.user)
            num = int(q.num)
            seen = model.seen.get(q.user, ())
            k = min(num + len(seen), n_items)
            if uidx is None or num <= 0 or k <= 0:
                results.append((idx, PredictedResult(())))
            else:
                valid.append((idx, uidx, k, num, seen))
        step = self.BATCH_PREDICT_CHUNK
        for lo in range(0, len(valid), step):
            part = valid[lo : lo + step]
            user_idx = torch.as_tensor([v[1] for v in part], device=self.device)
            kmax = bucket_k(max(v[2] for v in part), n_items)
            ids, scores = top_k_items_batch(user_idx, model.user_vecs, model.item_vecs, kmax)
            for (oi, _, k, num, seen), row_ids, row_scores in zip(part, ids.tolist(), scores.tolist()):
                results.append((oi, self._unseen(model, row_ids[:k], row_scores[:k], seen, num)))
        return results


class RecallAtK:
    """Fraction of held-out positives recovered in the top-k."""

    def __init__(self, k: int = 10):
        self.k = k

    def header(self) -> str:
        return f"Recall@{self.k}"

    def calculate_unit(self, query, predicted: PredictedResult, actual) -> float | None:
        positives = set(actual)
        if not positives:
            return None
        top = {s.item for s in predicted.item_scores[: self.k]}
        return len(top & positives) / len(positives)
