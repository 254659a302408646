"""Similar-Product engine: view events -> implicit ALS on the card -> similar items.

Counterpart of ``predictionio_tpu/templates/similarproduct/engine.py``
(parity: the reference's scala-parallel-similarproduct template):

* :class:`SimilarProductDataSource` reads ``view`` events (user -> item)
  through the columnar bulk scan, one count per (user, item) pair
  (``templates/columnar_util.py``), and each item's ``$set``
  ``categories``; ``$set``-only items join the item vocabulary, so the
  catalog filters can address items nobody viewed;
* :class:`ALSAlgorithm` trains implicit ALS (Hu-Koren-Volinsky
  confidence, MLlib's init) with :func:`predictionio_tpu_torch.ops.als.train_als`
  on the context's device, so its solves run through the hand-written
  Gauss-Jordan kernel on the card wherever the rank is a multiple of 8
  (``pio template get`` writes rank 32; rank 10, the default, takes
  Cholesky in both packages). The item rows are L2-normalised and the
  model stays host numpy in the blob;
* on the card, ``prepare_model_for_serving`` pins the unit item table
  there and ``predict`` sums the basket's rows, scores every item by
  cosine with one GEMV, applies the exclusion / ``whiteList`` /
  ``blackList`` / ``categories`` mask and takes :func:`top_k_scores`; on
  the CPU, which the caller asks for, it runs the JAX package's numpy
  code and :func:`top_k_host`. The answers keep the reference's
  contract: ``k = min(num, allowed)``, non-finite scores dropped, unknown
  items or a zero basket give ``()``;
* ``pio deploy --ann`` (``build_ann_for_serving``) builds an IVF index
  over the unit item table (:mod:`predictionio_tpu_torch.ops.ivf`); a
  query then over-fetches ``num + |excluded|`` candidates, and
  ``whiteList`` and ``categories`` queries take the exact masked path.

Query ``{"items": ["i1"], "num": 4, "categories"?: [...], "whiteList"?:
[...], "blackList"?: [...]}`` -> ``{"itemScores": [...]}``.

Multi-process (``PIO_COORDINATOR_*``): each process reads its shard of
the events; the view counts are summed across processes by user and
every process builds the same sorted BiMaps (``sharded_pair_counts``,
``keyed_coo``); ``train`` runs on the context's mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    Params,
    SanityCheck,
    TorchAlgorithm,
    WorkflowContext,
)
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.store import PEventStore
from predictionio_tpu_torch.templates.als_util import (
    implicit_als,
    keyed_coo,
    read_categories,
    sharded_pair_counts,
)
from predictionio_tpu_torch.templates.columnar_util import aggregate_pairs, densify_pairs
from predictionio_tpu_torch.templates.results import ItemScore, PredictedResult
from predictionio_tpu_torch.templates.serving_util import (
    allowed_items,
    build_ann,
    masked_topk,
    pin_tables,
    release_tables,
)

__all__ = [
    "Query",
    "DataSourceParams",
    "TrainingData",
    "SimilarProductDataSource",
    "ALSAlgorithmParams",
    "SimilarProductModel",
    "ALSAlgorithm",
    "engine_factory",
]

@dataclasses.dataclass(frozen=True)
class Query:
    items: tuple = ()
    num: int = 4
    categories: tuple | None = None
    white_list: tuple | None = None
    black_list: tuple | None = None
    json_aliases = {"whiteList": "white_list", "blackList": "black_list"}


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    view_event: str = "view"
    item_entity_type: str = "item"
    json_aliases = {"appName": "app_name", "viewEvent": "view_event"}


@dataclasses.dataclass
class TrainingData(SanityCheck):
    rows: np.ndarray  # user idx
    cols: np.ndarray  # item idx
    vals: np.ndarray  # view counts
    user_index: BiMap
    item_index: BiMap
    categories: dict  # item id -> tuple of category strings

    def sanity_check(self) -> None:
        if self.rows.size == 0:
            raise ValueError("No view events found — check appName/viewEvent")


class SimilarProductDataSource(DataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        super().__init__(params)

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        """Columnar bulk scan + numpy per-pair view counting (the JAX
        package's single-host read); user vocab: viewed users only; item
        vocab: viewed + ``$set``-only. Multi-process: this process's shard
        of the events, the counts summed across processes by user
        (:func:`~predictionio_tpu_torch.parallel.exchange.merge_keyed`) and
        the job's BiMaps (:func:`~predictionio_tpu_torch.parallel.exchange.global_vocab`)."""
        p = self.params
        categories = read_categories(p.app_name, p.item_entity_type)
        if ctx.num_hosts != 1:
            counts = sharded_pair_counts(ctx, p.app_name, {p.view_event: 1.0})
            return TrainingData(*keyed_coo(counts, categories), categories)
        cols = PEventStore.find_columns(app_name=p.app_name, event_names=[p.view_event])
        u_sel, i_sel, counts = aggregate_pairs(cols)
        rows, cols_idx, user_vocab, item_vocab = densify_pairs(cols, u_sel, i_sel, extra_items=categories)
        return TrainingData(
            rows=rows,
            cols=cols_idx,
            vals=counts,
            user_index=BiMap.string_index(user_vocab),
            item_index=BiMap.string_index(item_vocab),
            categories=categories,
        )


@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int | None = 3
    json_aliases = {"numIterations": "num_iterations", "lambda": "lambda_"}


@dataclasses.dataclass
class SimilarProductModel:
    """The unit item table and its id map: host numpy after ``train`` and
    in blobs, a tensor on the algorithm's device once pinned."""

    item_factors: Any  # [I, K], L2-normalized rows for cosine scoring
    item_index: BiMap
    categories: dict


class ALSAlgorithm(TorchAlgorithm):
    params_class = ALSAlgorithmParams
    query_class = Query

    #: optional ``on_sweep(step, user, item)`` hook handed to train_als
    on_sweep: Callable[[int, torch.Tensor, torch.Tensor], None] | None = None

    def __init__(self, params: ALSAlgorithmParams, device: str | torch.device | None = None):
        super().__init__(params, device)

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> SimilarProductModel:
        item = implicit_als(self, pd, self.params, ctx.mesh).item.cpu().numpy()
        norms = np.linalg.norm(item, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        return SimilarProductModel(item_factors=item / norms, item_index=pd.item_index, categories=pd.categories)

    def prepare_model_for_serving(self, model: SimilarProductModel) -> SimilarProductModel:
        """On the card, pin the unit item table there; on the CPU, keep it
        host numpy (the JAX package's host serving)."""
        if self.device.type == "cuda":
            model, _ = self.pin_model_for_serving(model)
        else:
            model.item_factors = np.ascontiguousarray(model.item_factors)
        self.warm_up(model)
        return model

    def pin_model_for_serving(self, model: SimilarProductModel) -> tuple[SimilarProductModel, int]:
        return pin_tables(model, self.device, "item_factors")

    def release_pinned_model(self, model: SimilarProductModel) -> None:
        release_tables(model, "item_factors")

    def build_ann_for_serving(self, model: SimilarProductModel, ann) -> tuple[SimilarProductModel, dict]:
        """``--ann``: IVF over the unit item table (cosine scoring is the
        inner product on unit rows, so the clustered layout is the metric
        the queries use)."""
        return build_ann(model, "item_factors", ann, self.device, type(self).__name__)

    def release_ann_state(self, model: SimilarProductModel) -> None:
        if getattr(model, "_pio_ann", None) is not None:
            model._pio_ann = None

    def warm_up(self, model: SimilarProductModel) -> None:
        super().warm_up(model)
        if len(model.item_index):
            self.predict(model, Query(items=(model.item_index.inverse(0),), num=4))

    def predict(self, model: SimilarProductModel, query: Query) -> PredictedResult:
        idxs = [i for i in (model.item_index.get(item) for item in query.items) if i is not None]
        if not idxs:
            return PredictedResult(())
        factors = model.item_factors
        if isinstance(factors, np.ndarray):
            target = factors[idxs].sum(axis=0)
            norm = np.linalg.norm(target)
        else:
            target = factors[torch.as_tensor(idxs, device=factors.device)].sum(dim=0)
            norm = float(torch.linalg.vector_norm(target))
        if norm == 0:
            return PredictedResult(())
        ann = getattr(model, "_pio_ann", None)
        if ann is not None and not query.white_list and not query.categories:
            # over-fetch num + |excluded| before dropping the excluded:
            # an exact-num fetch would answer fewer than num whenever the
            # excluded items are the most similar ones
            from predictionio_tpu_torch.ops import ivf

            num = int(query.num)
            if num <= 0:
                return PredictedResult(())
            exclude = set(idxs)
            exclude.update(r for item in query.black_list or () if (r := model.item_index.get(item)) is not None)
            ids, scores = ivf.query_topk(ann, target / norm, num + len(exclude))
            inverse = model.item_index.inverse
            return PredictedResult(tuple(
                ItemScore(item=inverse(int(i)), score=float(s)) for i, s in zip(ids, scores) if i not in exclude
            )[:num])
        scores = factors @ (target / norm)  # cosine against every item
        allowed = allowed_items(model, int(factors.shape[0]), set(idxs), query.white_list, query.black_list,
                                query.categories)
        return masked_topk(self, model, scores, allowed, query.num)


def engine_factory() -> Engine:
    return Engine(
        datasource_class=SimilarProductDataSource,
        preparator_class=IdentityPreparator,
        algorithms_class_map={"als": ALSAlgorithm},
        serving_class=FirstServing,
    )
