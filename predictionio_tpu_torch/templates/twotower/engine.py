"""Two-Tower retrieval engine: interaction events -> towers trained on the
card -> personalised top-N queries.

Counterpart of ``predictionio_tpu/templates/twotower/engine.py``, on the
DASE spine (:func:`engine_factory`):

* :class:`TwoTowerDataSource` reads the distinct (user, item) pairs of any
  of ``eventNames`` through the columnar bulk scan (in-batch softmax has
  no per-pair weight, so a set of pairs is the right shape), with each
  user's seen items for the serving-time filter; ``read_eval`` splits the
  pairs into k folds by a stable hash of (user, item);
* :class:`TwoTowerAlgorithm` trains the towers with
  :func:`predictionio_tpu_torch.ops.twotower.train_two_tower` on the
  context's device (the fused softmax-CE kernels on the card; from a
  previous model's aligned towers under ``pio train --warm-start``), or
  on its mesh (``pio train --mesh``: sharded tables, the unfused loss).
  ``prepare_model_for_serving`` pins the towers on the card, or keeps
  them host numpy on the CPU (the JAX package's host branch), and
  ``predict``/``batch_predict`` rank the catalog there by cosine score
  with the seen-item filter;
* serving is the framework's :class:`FirstServing`; :class:`RecallAtK`
  scores ``pio eval``.
* under ``pio deploy --online`` (:mod:`predictionio_tpu_torch.online`),
  ``online_trainer_spec`` opts the towers into the streaming trainer,
  and ``apply_online_update`` swaps its rows into the live towers and
  grows the seen filter.
* ``pio deploy --shard-factors``, ``--quantize int8`` and ``--ann`` take
  the Recommendation template's hooks over the towers
  (``shard_model_for_serving``, ``quantize_model_for_serving``,
  ``build_ann_for_serving``); the seen filter keeps its over-fetch
  (``num + |seen|`` candidates fetched before the merge) under all three.
* ``pio train --aot`` / ``pio deploy --aot`` (``aot_export_for_serving``):
  the same programs as the Recommendation template's, over the towers.

engine.json is the JAX package's, byte for byte::

    {"engineFactory": "predictionio_tpu.templates.twotower:engine_factory",
     "datasource": {"params": {"appName": "myapp",
                               "eventNames": ["view", "buy"]}},
     "algorithms": [{"name": "twotower",
                     "params": {"embeddingDim": 64, "batchSize": 512,
                                "epochs": 5, "learningRate": 0.05}}]}

Multi-process (``PIO_COORDINATOR_*``): each process reads its shard of
the events, and the distinct pairs are all-gathered, so every process
trains on the job's pairs.
"""

from __future__ import annotations

import dataclasses
import logging
import zlib
from typing import Any, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    OptionAverageMetric,
    Params,
    SanityCheck,
    TorchAlgorithm,
    WorkflowContext,
)
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.store import PEventStore
from predictionio_tpu_torch.ops.als import predict_scores
from predictionio_tpu_torch.ops.topk import bucket_k, top_k_host, top_k_scores
from predictionio_tpu_torch.ops.twotower import TwoTowerConfig, train_two_tower
from predictionio_tpu_torch.templates.columnar_util import aggregate_pairs, densify_pairs
from predictionio_tpu_torch.templates.results import ItemScore, PredictedResult
from predictionio_tpu_torch.templates.serving_util import (
    TOPK_CHUNK,
    aligned_factor_init,
    aot_predict,
    aot_serving_programs,
    build_ann,
    chunked_topk,
    pin_tables,
    quantize_tables,
    release_tables,
    shard_tables,
)

__all__ = [
    "DataSourceParams",
    "Query",
    "ItemScore",
    "PredictedResult",
    "TrainingData",
    "TwoTowerDataSource",
    "TwoTowerParams",
    "TwoTowerServingModel",
    "TwoTowerAlgorithm",
    "RecallAtK",
    "engine_factory",
]


@dataclasses.dataclass(frozen=True)
class Query:
    """``{"user": "u1", "num": 10}`` (wire-compatible with the reference)."""

    user: str
    num: int = 10


# --------------------------------------------------------------- data source
@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    event_names: Sequence[str] = ("view", "rate", "buy", "like")
    eval_k: int = 2
    json_aliases = {
        "appName": "app_name",
        "eventNames": "event_names",
        "evalK": "eval_k",
    }


@dataclasses.dataclass
class TrainingData(SanityCheck):
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


class TwoTowerDataSource(DataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        super().__init__(params)

    def _columns(self, ctx: WorkflowContext):
        p = self.params
        return PEventStore.find_columns(app_name=p.app_name, event_names=list(p.event_names))

    def _read_pairs(self, ctx: WorkflowContext) -> list:
        """Sorted distinct (user, item) id pairs — the JOB's set on every
        process: the batches are global and the seen filter must cover
        every user, so a multi-process read all-gathers each process's
        shard of the pairs (two ids each, small next to the events they
        dedup). One process: the dedup runs over code arrays, so the
        remaining Python is O(distinct pairs)."""
        if ctx.num_hosts == 1:
            cols = self._columns(ctx)
            u_sel, i_sel, _ = aggregate_pairs(cols)
            return sorted(zip(cols.entity_vocab[u_sel].tolist(), cols.target_vocab[i_sel].tolist()))
        from predictionio_tpu_torch.parallel.exchange import allgather_objects

        p = self.params
        pairs = {
            (e.entity_id, e.target_entity_id)
            for e in PEventStore.find(
                app_name=p.app_name, event_names=list(p.event_names),
                shard_index=ctx.host_index, num_shards=ctx.num_hosts,
            )
            if e.target_entity_id is not None
        }
        merged: set = set()
        for contrib in allgather_objects(sorted(pairs)):
            merged.update(tuple(pr) for pr in contrib)
        return sorted(merged)

    @staticmethod
    def _to_training_data(pairs: Sequence) -> TrainingData:
        user_index = BiMap.string_index(sorted({u for u, _ in pairs}))
        item_index = BiMap.string_index(sorted({i for _, i in pairs}))
        n = len(pairs)
        rows = np.fromiter((user_index[u] for u, _ in pairs), np.int64, n)
        cols = np.fromiter((item_index[i] for _, i in pairs), np.int64, n)
        seen: dict[str, set] = {}
        for u, i in pairs:
            seen.setdefault(u, set()).add(i)
        return TrainingData(rows, cols, user_index, item_index, seen)

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        """Vectorized read: the columnar bulk scan and a grouped pair
        dedup, no per-event Python; the seen filter is built from the
        (much smaller) distinct pairs. Multi-process: the job's pairs on
        every process (:meth:`_read_pairs`)."""
        if ctx.num_hosts != 1:
            return self._to_training_data(self._read_pairs(ctx))
        cols = self._columns(ctx)
        u_sel, i_sel, _counts = aggregate_pairs(cols)
        rows, cols_idx, user_vocab, item_vocab = densify_pairs(cols, u_sel, i_sel)
        seen: dict[str, set] = {}
        for r, c in zip(rows.tolist(), cols_idx.tolist()):
            seen.setdefault(user_vocab[r], set()).add(item_vocab[c])
        return TrainingData(
            rows, cols_idx, BiMap.string_index(user_vocab), BiMap.string_index(item_vocab), seen
        )

    def read_eval(self, ctx: WorkflowContext):
        """K-fold split by stable hash of (user, item): train on k-1
        folds, query each user with held-out interactions for the full
        ranking, actual = the held-out item ids (consumed by
        :class:`RecallAtK`)."""
        pairs = self._read_pairs(ctx)
        k = max(2, self.params.eval_k)

        def fold_of(u: str, i: str) -> int:
            return zlib.crc32(f"{u}\x00{i}".encode()) % k

        folds = []
        for fold in range(k):
            train = [pr for pr in pairs if fold_of(*pr) != fold]
            held = [pr for pr in pairs if fold_of(*pr) == fold]
            td = self._to_training_data(train)
            by_user: dict[str, list] = {}
            for u, i in held:
                # only users the fold's model knows can be queried
                if u in td.user_index:
                    by_user.setdefault(u, []).append(i)
            num_items = len(td.item_index)
            qa = [
                (Query(user=u, num=num_items), tuple(items))
                for u, items in by_user.items()
                if items
            ]
            folds.append((td, {"fold": fold}, qa))
        return folds


# ----------------------------------------------------------------- algorithm
@dataclasses.dataclass(frozen=True)
class TwoTowerParams(Params):
    embedding_dim: int = 32
    batch_size: int = 256
    epochs: int = 5
    learning_rate: float = 0.05
    temperature: float = 0.1
    seed: int = 0
    #: recorded, not switches (see the ALS template's params): the
    #: deploy's device decides where the towers serve
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
    ``train`` and in blobs, tensors on the algorithm's device once pinned
    (``pin_model_for_serving``). The JAX package's class has these
    fields, so a blob of either package reads as the other's class
    (:mod:`predictionio_tpu_torch.utils.serialization`)."""

    user_vecs: Any  # [U, D]
    item_vecs: Any  # [I, D]
    user_index: BiMap
    item_index: BiMap
    seen: dict
    loss_history: tuple = ()


class TwoTowerAlgorithm(TorchAlgorithm):
    params_class = TwoTowerParams
    query_class = Query

    def __init__(self, params: TwoTowerParams, device: str | torch.device | None = None):
        super().__init__(params, device)
        #: the last ``train``'s seconds of upload, epoch loop and readback
        #: (``TwoTowerModel.timings``)
        self.train_timings: dict = {}

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> TwoTowerServingModel:
        """The towers on :attr:`device` (the engine builds the algorithm on
        ``ctx.device``); the model comes back as host numpy. With a
        previous model in ``ctx.warm_model`` (``pio train --warm-start``)
        users and items present in both catalogs keep their embeddings
        and new ones draw the towers' own signed-normal cold init
        (:func:`aligned_factor_init`), as in the JAX package."""
        p = self.params
        init_user = init_item = None
        warm = ctx.warm_model
        if isinstance(warm, TwoTowerServingModel):

            def fresh(rng, shape):
                return rng.standard_normal(shape) / np.sqrt(shape[1])

            init_user, n_u = aligned_factor_init(
                warm.user_vecs, warm.user_index, pd.user_index, p.embedding_dim, p.seed, fresh=fresh
            )
            init_item, n_i = aligned_factor_init(
                warm.item_vecs, warm.item_index, pd.item_index, p.embedding_dim, p.seed + 1, fresh=fresh
            )
            logging.getLogger(__name__).info(
                "Warm start: carried %d/%d user and %d/%d item embeddings",
                n_u, len(pd.user_index), n_i, len(pd.item_index),
            )
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
            init_user=init_user,
            init_item=init_item,
            device=self.device,
            mesh=ctx.mesh,
        )
        self.train_timings = dict(model.timings)
        return TwoTowerServingModel(
            user_vecs=model.user_vecs,
            item_vecs=model.item_vecs,
            user_index=pd.user_index,
            item_index=pd.item_index,
            seen=pd.seen,
            loss_history=model.loss_history,
        )

    def prepare_model_for_serving(self, model: TwoTowerServingModel) -> TwoTowerServingModel:
        """On the card, pin the towers there; on the CPU, keep them host
        numpy (the JAX package's host serving). Then warm the scoring
        path with one query."""
        if self.device.type == "cuda":
            model, _ = self.pin_model_for_serving(model)
        else:
            model.user_vecs = np.ascontiguousarray(model.user_vecs)
            model.item_vecs = np.ascontiguousarray(model.item_vecs)
        self.warm_up(model)
        return model

    def pin_model_for_serving(self, model: TwoTowerServingModel) -> tuple[TwoTowerServingModel, int]:
        """The ``--pin-model`` tier: the ALS template's contract for the
        tower tables (tensors on :attr:`device` once per generation, the
        host arrays kept for :meth:`release_pinned_model`)."""
        return pin_tables(model, self.device, "user_vecs", "item_vecs")

    def release_pinned_model(self, model: TwoTowerServingModel) -> None:
        """Drop a superseded generation's pinned towers (the host arrays
        come back, or the streamed towers are copied back once an online
        update made the pin-time arrays stale; the device tensors lose
        their last reference)."""
        release_tables(model, "user_vecs", "item_vecs")

    def shard_model_for_serving(self, model: TwoTowerServingModel) -> tuple[TwoTowerServingModel, int]:
        """The ``--shard-factors`` tier over the towers (the Recommendation
        template's contract): row shards over the serving mesh, retrieval
        through the sharded kernels; one device pins replicated, with the
        JAX package's warning."""
        return shard_tables(model, self.device, "user_vecs", "item_vecs")

    def quantize_model_for_serving(
        self, model: TwoTowerServingModel, mode: str = "int8", shard: bool = False
    ) -> tuple[TwoTowerServingModel, int]:
        """The ``--quantize int8`` tier over the towers (the Recommendation
        template's contract): int8 codes and per-row scales on
        :attr:`device`, retrieval through the two-stage top-k; ``shard=True``
        shards the codes and scales over the serving mesh."""
        return quantize_tables(model, "user_vecs", "item_vecs", self.device, mode, shard)

    def build_ann_for_serving(self, model: TwoTowerServingModel, ann) -> tuple[TwoTowerServingModel, dict]:
        """The ``--ann`` tier: an IVF index over the item tower on
        :attr:`device`; serving scores only ``nprobe`` cluster slabs a
        query, and the seen filter keeps its over-fetch."""
        return build_ann(model, "item_vecs", ann, self.device, type(self).__name__)

    def release_ann_state(self, model: TwoTowerServingModel) -> None:
        if getattr(model, "_pio_ann", None) is not None:
            model._pio_ann = None

    # ---------------------------------------------------- AOT serving export
    def aot_export_for_serving(self, model: TwoTowerServingModel, buckets: list) -> dict:
        """The ``--aot`` tier: the ALS template's programs over the towers
        (``predict_scores``, per bucket the top-k of a score row and the
        batch top-k over chunks of ``TOPK_CHUNK``). Sharded and int8
        generations export nothing."""
        return aot_serving_programs(model, "user_vecs", "item_vecs", buckets, TOPK_CHUNK, self.device)

    def aot_warm_serving(self, model: TwoTowerServingModel) -> None:
        """One query through the loaded programs at boot (the ALS
        template's twin)."""
        if getattr(model, "_pio_pinned", False) and getattr(model, "_pio_aot", None) is not None and len(model.user_index):
            self.predict(model, Query(user=model.user_index.keys()[0], num=4))

    # ----------------------------------------------- online streaming SGD
    def online_trainer_spec(self, model: TwoTowerServingModel) -> dict:
        """Opt into the streaming mini-batch trainer (``pio deploy
        --online``; online/trainer.py): towers have no closed-form
        fold-in, so their online path is small SGD steps on fresh pairs
        with the in-batch softmax objective training uses, on
        :attr:`device`."""
        p = self.params
        return {"learning_rate": p.learning_rate, "temperature": p.temperature, "seed": p.seed,
                "device": str(self.device)}

    def apply_online_update(self, model: TwoTowerServingModel, upd) -> dict:
        """Swap streamed rows into the live towers — the query server runs
        it on its device thread after the generation check (row swaps
        only; the SGD ran on the trainer's thread). Also grows the
        serving-time seen filter with the folded pairs, copy-on-write per
        user, so fresh interactions leave the user's recommendations at
        once. The pin-time host arrays go stale with the first swap and
        are dropped."""
        from predictionio_tpu_torch.workflow import device_state

        model._pio_host = None
        info = {"usersUpdated": 0, "itemsUpdated": 0, "usersAdded": 0, "itemsAdded": 0}
        if upd.user_ids:
            info["usersUpdated"], info["usersAdded"] = device_state.swap_side_rows(
                model, upd.user_ids, upd.user_rows, "user_vecs", "user_index", rows_before_index=True
            )
        if upd.item_ids:
            info["itemsUpdated"], info["itemsAdded"] = device_state.swap_side_rows(
                model, upd.item_ids, upd.item_rows, "item_vecs", "item_index", rows_before_index=False
            )
            ann_info = device_state.update_ann_items(model, upd.item_ids, upd.item_rows, factors_attr="item_vecs")
            if ann_info is not None:
                info["ann"] = ann_info
        for u, i in upd.seen_pairs:
            # copy-on-write per user: a reader iterating the old set never
            # observes a mutation
            model.seen[u] = set(model.seen.get(u, ())) | {i}
        return info

    def warm_up(self, model: TwoTowerServingModel) -> None:
        """Make the calling thread ready to serve: the device current, and
        one query through the scoring path."""
        super().warm_up(model)
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
        ann = getattr(model, "_pio_ann", None)
        quantrt = getattr(model, "_pio_quant", None)
        shards = getattr(model, "_pio_shards", None)
        if isinstance(model.item_vecs, np.ndarray):
            self.check_host_serving()
        if ann is not None:
            from predictionio_tpu_torch.ops import ivf

            if quantrt is not None:
                qvec = model.user_vecs[np.asarray([uidx], np.int64)][0]
            else:
                qvec = model.user_vecs[uidx]
            idx, vals = ivf.query_topk(ann, qvec, k)
            return self._unseen(model, idx, vals, seen, num)
        if quantrt is not None:
            from predictionio_tpu_torch.ops import quant

            idx, vals = quant.topk_users(quantrt, model.user_vecs, model.item_vecs, [uidx], k, shards=shards)
            return self._unseen(model, idx[0].tolist(), vals[0].tolist(), seen, num)
        if shards is not None:
            from predictionio_tpu_torch.parallel import sharding

            idx, vals = sharding.topk_users(shards, model.user_vecs, model.item_vecs, [uidx], k)
            return self._unseen(model, idx[0].tolist(), vals[0].tolist(), seen, num)
        if isinstance(model.item_vecs, np.ndarray):
            # host branch (the CPU, asked for): the JAX package's code
            scores = model.item_vecs @ np.asarray(model.user_vecs[uidx])
            idx, vals = top_k_host(scores, k)
        else:
            # under --aot the exported programs of k's bucket, sliced to k
            aot = getattr(model, "_pio_aot", None)
            top = aot_predict(aot, model.user_vecs[uidx], model.item_vecs, k, n_items) if aot is not None else None
            if top is None:
                top = top_k_scores(predict_scores(model.user_vecs[uidx], model.item_vecs), bucket_k(k, n_items))
            idx, vals = top
        return self._unseen(model, idx[:k].tolist(), vals[:k].tolist(), seen, num)

    def batch_predict(
        self, model: TwoTowerServingModel, queries: Sequence[tuple[int, Query]]
    ) -> list[tuple[int, PredictedResult]]:
        """Chunks of queries through :func:`chunked_topk` (one
        ``[B,D]@[D,I]`` product and one top-k each); the seen filter as in
        :meth:`predict`."""
        n_items = len(model.item_index)
        results: list[tuple[int, PredictedResult]] = []
        valid: list[tuple[int, int, int]] = []
        seen_num: dict[int, tuple[Any, int]] = {}
        for idx, q in queries:
            uidx = model.user_index.get(q.user)
            num = int(q.num)
            seen = model.seen.get(q.user, ())
            k = min(num + len(seen), n_items)
            if uidx is None or num <= 0 or k <= 0:
                results.append((idx, PredictedResult(())))
            else:
                seen_num[idx] = (seen, num)
                valid.append((idx, uidx, k))
        if isinstance(model.item_vecs, np.ndarray) and valid:
            self.check_host_serving()
        for part, idx_l, score_l in chunked_topk(
            model.user_vecs, model.item_vecs, valid,
            ann=getattr(model, "_pio_ann", None), quant=getattr(model, "_pio_quant", None),
            shards=getattr(model, "_pio_shards", None), aot=getattr(model, "_pio_aot", None),
        ):
            for (oi, _, k), ids, scs in zip(part, idx_l, score_l):
                seen, num = seen_num[oi]
                results.append((oi, self._unseen(model, ids[:k], scs[:k], seen, num)))
        return results


class RecallAtK(OptionAverageMetric):
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


def engine_factory() -> Engine:
    return Engine(
        datasource_class=TwoTowerDataSource,
        preparator_class=IdentityPreparator,
        algorithms_class_map={"twotower": TwoTowerAlgorithm},
        serving_class=FirstServing,
    )
