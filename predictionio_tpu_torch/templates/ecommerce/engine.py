"""E-Commerce engine: view/buy events -> implicit ALS on the card + business rules.

Counterpart of ``predictionio_tpu/templates/ecommerce/engine.py``
(parity: the reference's scala-parallel-ecommercerecommendation template):

* :class:`ECommerceDataSource` reads ``view`` and ``buy`` events through
  the columnar bulk scan into one weighted value per (user, item) pair
  (a buy weighs 5, a view 1), each item's ``$set`` ``categories`` and the
  popularity vector (the weighted sums per item);
* :class:`ECommAlgorithm` trains implicit ALS on the context's device
  (the Similar-Product template's :func:`implicit_als`: the hand-written
  Gauss-Jordan kernel on the card at a rank that is a multiple of 8).
  At serving time it looks up, through the port's ``LEventStore``, the
  items of the user's ``view``/``buy`` events and the ``items`` of the
  ``constraint``/``unavailableItems`` entity (errors there give no
  exclusion, as in the reference), applies the ``whiteList`` /
  ``blackList`` / ``categories`` rules, and ranks a known user by one
  GEMV and a cold user by popularity, under the shared tie rule
  (ascending item index among equal counts);
* on the card ``prepare_model_for_serving`` pins both factor tables and
  the popularity vector there and the scores and top-k run there; on the
  CPU, which the caller asks for, ``predict`` is the JAX package's numpy
  code and :func:`top_k_host`.

Query ``{"user": "u1", "num": 4, "categories"?, "whiteList"?,
"blackList"?}`` -> ``{"itemScores": [...]}``.

Multi-process (``PIO_COORDINATOR_*``): the SimilarProduct template's
sharded read with buys weighing 5, and the popularity summed across
processes; ``train`` runs on the context's mesh.
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
from predictionio_tpu_torch.data.store import LEventStore, PEventStore
from predictionio_tpu_torch.templates.columnar_util import aggregate_pairs, densify_pairs, event_name_mask
from predictionio_tpu_torch.templates.results import PredictedResult
from predictionio_tpu_torch.templates.serving_util import allowed_items, masked_topk, pin_tables, release_tables
from predictionio_tpu_torch.templates.als_util import (
    implicit_als,
    keyed_coo,
    read_categories,
    sharded_pair_counts,
)

__all__ = [
    "Query",
    "DataSourceParams",
    "TrainingData",
    "ECommerceDataSource",
    "ECommAlgorithmParams",
    "ECommModel",
    "ECommAlgorithm",
    "engine_factory",
]


@dataclasses.dataclass(frozen=True)
class Query:
    user: str = ""
    num: int = 4
    categories: tuple | None = None
    white_list: tuple | None = None
    black_list: tuple | None = None
    json_aliases = {"whiteList": "white_list", "blackList": "black_list"}


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    view_event: str = "view"
    buy_event: str = "buy"
    item_entity_type: str = "item"
    json_aliases = {
        "appName": "app_name",
        "viewEvent": "view_event",
        "buyEvent": "buy_event",
    }


@dataclasses.dataclass
class TrainingData(SanityCheck):
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray  # weighted counts (buys weigh more than views)
    user_index: BiMap
    item_index: BiMap
    categories: dict  # item id -> tuple of categories
    popularity: np.ndarray  # [I] view+buy counts

    def sanity_check(self) -> None:
        if self.rows.size == 0:
            raise ValueError("No view/buy events found — check appName")


class ECommerceDataSource(DataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        super().__init__(params)

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        """Columnar bulk scan + grouped weighted sums (the JAX package's
        single-host read). Multi-process: this process's shard of the
        events, the weighted counts summed across processes, the job's
        BiMaps, and the popularity summed over every process's pairs."""
        p = self.params
        categories = read_categories(p.app_name, p.item_entity_type)
        if ctx.num_hosts != 1:
            from predictionio_tpu_torch.parallel.exchange import global_sum_array

            # a buy is a much stronger signal than a view
            counts = sharded_pair_counts(ctx, p.app_name, {p.view_event: 1.0, p.buy_event: 5.0})
            rows, cols, vals, user_index, item_index = keyed_coo(counts, categories)
            popularity = np.zeros(len(item_index), dtype=np.float32)
            np.add.at(popularity, cols, vals)
            return TrainingData(rows, cols, vals, user_index, item_index, categories,
                                global_sum_array(popularity))
        cols_batch = PEventStore.find_columns(app_name=p.app_name, event_names=[p.view_event, p.buy_event])
        weights = np.ones(len(cols_batch), np.float32)
        weights[event_name_mask(cols_batch, p.buy_event)] = 5.0
        u_sel, i_sel, vals = aggregate_pairs(cols_batch, weights)
        rows, cols_idx, user_vocab, item_vocab = densify_pairs(cols_batch, u_sel, i_sel, extra_items=categories)
        item_index = BiMap.string_index(item_vocab)
        popularity = np.zeros(len(item_index), dtype=np.float32)
        np.add.at(popularity, cols_idx, vals)
        return TrainingData(
            rows, cols_idx, vals, BiMap.string_index(user_vocab), item_index, categories, popularity,
        )


@dataclasses.dataclass(frozen=True)
class ECommAlgorithmParams(Params):
    app_name: str = ""  # for serving-time LEventStore lookups
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int | None = 3
    #: exclude items of these recent user events at serving time
    unseen_only: bool = True
    seen_events: tuple = ("view", "buy")
    json_aliases = {
        "appName": "app_name",
        "numIterations": "num_iterations",
        "lambda": "lambda_",
        "unseenOnly": "unseen_only",
        "seenEvents": "seen_events",
    }


@dataclasses.dataclass
class ECommModel:
    """Both factor tables, the id maps, the categories and the popularity
    vector: host numpy after ``train`` and in blobs, tensors on the
    algorithm's device once pinned."""

    user_factors: Any
    item_factors: Any
    user_index: BiMap
    item_index: BiMap
    categories: dict
    popularity: Any  # [I]


#: the tables ``pin_model_for_serving`` places on the card
_TABLES = ("user_factors", "item_factors", "popularity")


class ECommAlgorithm(TorchAlgorithm):
    params_class = ECommAlgorithmParams
    query_class = Query

    #: optional ``on_sweep(step, user, item)`` hook handed to train_als
    on_sweep: Callable[[int, torch.Tensor, torch.Tensor], None] | None = None

    def __init__(self, params: ECommAlgorithmParams, device: str | torch.device | None = None):
        super().__init__(params, device)

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> ECommModel:
        factors = implicit_als(self, pd, self.params, ctx.mesh)
        return ECommModel(
            user_factors=factors.user.cpu().numpy(),
            item_factors=factors.item.cpu().numpy(),
            user_index=pd.user_index,
            item_index=pd.item_index,
            categories=pd.categories,
            popularity=pd.popularity,
        )

    def prepare_model_for_serving(self, model: ECommModel) -> ECommModel:
        """On the card, pin the tables there; on the CPU, keep them host
        numpy (the JAX package's host serving)."""
        if self.device.type == "cuda":
            model, _ = self.pin_model_for_serving(model)
        self.warm_up(model)
        return model

    def pin_model_for_serving(self, model: ECommModel) -> tuple[ECommModel, int]:
        return pin_tables(model, self.device, *_TABLES)

    def release_pinned_model(self, model: ECommModel) -> None:
        release_tables(model, *_TABLES)

    def warm_up(self, model: ECommModel) -> None:
        super().warm_up(model)
        if len(model.user_index):
            self._score(model, model.user_index.inverse(0), np.ones(len(model.item_index), bool), 4)

    # ------------------------------------------------------------- serving
    def _seen_items(self, user: str) -> set:
        """Items of the user's recent view/buy events, via the serving-time
        ``LEventStore`` path (parity: ECommAlgorithm's seen-events lookup)."""
        if not self.params.unseen_only or not self.params.app_name:
            return set()
        try:
            events = LEventStore.find_by_entity(
                app_name=self.params.app_name,
                entity_type="user",
                entity_id=user,
                event_names=list(self.params.seen_events),
                limit=None,
            )
        except Exception:
            return set()
        return {e.target_entity_id for e in events if e.target_entity_id}

    def _unavailable_items(self) -> set:
        """Current ``$set`` properties of the ``constraint_unavailableItems``
        entity (parity: the template's availability constraint)."""
        if not self.params.app_name:
            return set()
        try:
            pm = LEventStore.aggregate_properties_of_entity(
                app_name=self.params.app_name,
                entity_type="constraint",
                entity_id="unavailableItems",
            )
        except Exception:
            return set()
        if pm is None:
            return set()
        return set(pm.opt("items", list, []))

    def _score(self, model: ECommModel, user: str, allowed: np.ndarray, num: int) -> PredictedResult:
        """A known user's GEMV scores, or the popularity of a cold one,
        ranked over the ``allowed`` items."""
        uidx = model.user_index.get(user)
        if isinstance(model.item_factors, np.ndarray):
            if uidx is not None:
                scores = model.item_factors @ np.asarray(model.user_factors[uidx])
            else:
                # cold start: popularity ranking (parity: the template's
                # fallback to recent/popular items)
                scores = np.asarray(model.popularity, dtype=np.float64).copy()
        elif uidx is not None:
            scores = model.item_factors @ model.user_factors[uidx]
        else:
            scores = model.popularity
        return masked_topk(self, model, scores, allowed, num)

    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        index = model.item_index
        exclude = {r for item in self._seen_items(query.user) | self._unavailable_items()
                   if (r := index.get(item)) is not None}
        allowed = allowed_items(model, len(index), exclude, query.white_list, query.black_list, query.categories)
        return self._score(model, query.user, allowed, query.num)


def engine_factory() -> Engine:
    return Engine(
        datasource_class=ECommerceDataSource,
        preparator_class=IdentityPreparator,
        algorithms_class_map={"ecomm": ECommAlgorithm},
        serving_class=FirstServing,
    )
