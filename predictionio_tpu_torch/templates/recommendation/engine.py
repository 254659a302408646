"""Recommendation engine: event store -> ALS on the card -> top-N item queries.

Counterpart of ``predictionio_tpu/templates/recommendation/engine.py``
(parity: the reference's scala-parallel-recommendation template):

* :class:`RecommendationDataSource` reads ``rate`` events (explicit
  rating property) and ``buy`` events (implicit rating 4.0) through the
  columnar bulk scan; the latest event per (user, item) wins, and equal
  times go to the higher rating. On the columnar event store a repeat
  train reads only the segments and tail lines added since the last one
  and merges them with the training cache
  (``<PIO_FS_BASEDIR>/train_cache/<tag>.{npz,json}``, the JAX package's
  format, so a cache either package writes is valid in the other);
  ``read_eval`` splits the same ratings into k folds by a stable hash of
  (user, item);
* :class:`ALSAlgorithm` trains with :func:`predictionio_tpu_torch.ops.als.train_als`
  on the context's device (from a previous model's aligned factors under
  ``pio train --warm-start``). For serving, on the card the factors are
  pinned there (``pin_model_for_serving``) and ``predict``/
  ``batch_predict`` score there; on the CPU, which the caller asks for,
  they stay host numpy and take the JAX package's host branch (numpy
  GEMV/GEMM and ``top_k_host``);
* serving is the framework's :class:`FirstServing`
  (:func:`engine_factory`); :class:`PrecisionAtK` scores ``pio eval``.
* under ``pio deploy --online`` (:mod:`predictionio_tpu_torch.online`),
  ``online_foldin`` re-solves the rows a batch of fresh ``rate``/``buy``
  events touched against the fixed opposite factors, on the algorithm's
  device, and ``apply_online_update`` swaps them into the live model.

engine.json params are byte-compatible: ``rank``, ``numIterations``,
``lambda``, ``seed``, ``implicitPrefs``, ``alpha``, ``serveOnDevice``,
``deviceLatencyBudgetMs``, and the datasource's ``appName``/``evalK``.
``serveOnDevice`` and ``deviceLatencyBudgetMs`` are recorded, not
switches: the deploy's device decides where a model serves.

* ``pio deploy --quantize int8`` (``quantize_model_for_serving``) serves
  both tables as int8 codes and per-row scales through the two-stage
  top-k of :mod:`predictionio_tpu_torch.ops.quant`; ``pio deploy --ann``
  (``build_ann_for_serving``) builds an IVF index over the item table
  (:mod:`predictionio_tpu_torch.ops.ivf`, int8 slabs under
  ``--quantize``), and ``predict``/``batch_predict`` probe it; online
  folds update the index's touched items.
* ``pio deploy --shard-factors`` (``shard_model_for_serving``, and
  ``quantize_model_for_serving(shard=True)`` with ``--quantize``) serves
  both tables row-sharded over the local devices
  (:mod:`predictionio_tpu_torch.parallel.sharding`): the exact, int8 and
  IVF routes take the sharded kernels, whose answers equal the
  replicated ones; online folds gather the rows they read from their
  owner shards and write each solved row there.

* ``pio train --aot`` / ``pio deploy --aot`` (``aot_export_for_serving``,
  :mod:`predictionio_tpu_torch.workflow.aot`): the pinned exact serving
  programs compiled ahead of time per k bucket; ``predict`` and
  ``batch_predict`` run them where they fit, with the eager path's bits.

* multi-process (``PIO_COORDINATOR_*``): each process reads its shard of
  the events (``PEventStore.find(shard_index=, num_shards=)``), the
  latest-wins rule is applied across processes by
  :func:`~predictionio_tpu_torch.parallel.exchange.merge_keyed`, and every
  process builds the same BiMaps from
  :func:`~predictionio_tpu_torch.parallel.exchange.global_vocab`; the COO
  stays each process's own, and ``train`` passes the context's mesh.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import uuid
import zipfile
import zlib
from collections import OrderedDict
from typing import Any, Callable, Mapping, Sequence

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
from predictionio_tpu_torch.data.event import EventValidationError
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.store import PEventStore, resolve_app
from predictionio_tpu_torch.ops.als import ALSConfig, predict_scores, train_als
from predictionio_tpu_torch.ops.topk import top_k_host, top_k_scores
from predictionio_tpu_torch.templates.columnar_util import event_name_mask
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
from predictionio_tpu_torch.templates.results import ItemScore, PredictedResult

__all__ = [
    "Query",
    "Actual",
    "ItemScore",
    "PredictedResult",
    "DataSourceParams",
    "TrainingData",
    "RecommendationDataSource",
    "ALSAlgorithmParams",
    "ALSModel",
    "ALSAlgorithm",
    "PrecisionAtK",
    "engine_factory",
]


@dataclasses.dataclass(frozen=True)
class Query:
    """``{"user": "1", "num": 4}`` (wire-compatible with the reference)."""

    user: str
    num: int = 4


@dataclasses.dataclass(frozen=True)
class Actual:
    """Ground truth for one eval query: held-out positive items plus the
    items the user already rated in the training split (skipped — not
    penalized — by :class:`PrecisionAtK`)."""

    items: tuple = ()
    seen: tuple = ()


# ---------------------------------------------------------------- datasource
@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    #: events read as explicit ratings (property ``rating``)
    rate_event: str = "rate"
    #: events read as implicit positive signal with this rating value
    buy_event: str = "buy"
    buy_rating: float = 4.0
    #: eval folds for read_eval
    eval_k: int = 3
    #: on an append-only columnar event store, repeat trains read only
    #: the segments/tail added since the cached previous read; a full
    #: read whenever the cache is stale or the store is not columnar
    incremental: bool = True
    json_aliases = {"appName": "app_name", "evalK": "eval_k"}


@dataclasses.dataclass
class TrainingData(SanityCheck):
    """COO ratings + the entity-id <-> dense-index BiMaps."""

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    user_index: BiMap
    item_index: BiMap

    def sanity_check(self) -> None:
        if self.rows.size == 0:
            raise ValueError(
                "TrainingData is empty — no rate/buy events found; "
                "check appName and imported events"
            )
        if not (self.rows.size == self.cols.size == self.vals.size):
            raise ValueError("TrainingData arrays are misaligned")


class RecommendationDataSource(DataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        super().__init__(params)

    def _extract_ratings_arrays(self, cols):
        """EventColumns -> (u_code, i_code, event_time_us, rating) in the
        columns' own vocab space; validates that rate events carry a
        numeric rating."""
        p = self.params
        # exact-match lookup: a third-party driver's event_vocab need not
        # be sorted (the EventColumns contract doesn't promise it)
        is_buy = event_name_mask(cols, p.buy_event)
        if is_buy.any():
            vals = np.where(is_buy, np.float32(p.buy_rating), cols.prop)
        else:
            vals = cols.prop
        keep = cols.target_code >= 0  # events without a target are skipped
        bad = keep & ~is_buy & np.isnan(vals)
        if bad.any():
            n_bad = int(bad.sum())
            u = cols.entity_vocab[cols.entity_code[np.argmax(bad)]]
            raise EventValidationError(
                f"{n_bad} '{p.rate_event}' event(s) lack a numeric 'rating' "
                f"property (first offender: entity {u!r})"
            )
        if keep.all():
            return (
                cols.entity_code,
                cols.target_code,
                cols.event_time_us,
                vals.astype(np.float32, copy=False),
            )
        return (
            cols.entity_code[keep],
            cols.target_code[keep],
            cols.event_time_us[keep],
            vals[keep].astype(np.float32, copy=False),
        )

    @staticmethod
    def _assemble_training_data(u_code, i_code, t_arr, v, user_vocab, item_vocab):
        """Dedup (latest wins, ties -> higher rating) + vocabulary
        compaction; returns ``(TrainingData, cache_payload)``. One argsort
        groups the pairs; only rows inside duplicate groups (usually a
        tiny fraction) pay the 3-key lexsort. The pair key uses the
        narrowest dtype that fits."""
        span = int(user_vocab.size) * (int(item_vocab.size) + 1)
        pair_dt = np.uint32 if span < 2**32 else np.int64
        pair = u_code.astype(pair_dt) * pair_dt(item_vocab.size + 1) + i_code.astype(pair_dt)
        # stability is irrelevant: duplicate groups are re-ranked below by
        # (time, rating), so the faster introsort wins over kind="stable"
        order = np.argsort(pair)
        ps = pair[order]
        n = ps.size
        last = np.flatnonzero(np.r_[ps[1:] != ps[:-1], n > 0])
        first = np.r_[0, last[:-1] + 1] if n else last
        sizes = last - first + 1
        sel = order[last]
        dup_groups = np.flatnonzero(sizes > 1)
        if dup_groups.size:
            rows_d = order[np.repeat(sizes > 1, sizes)]
            dsizes = sizes[dup_groups]
            group_of = np.repeat(np.arange(dup_groups.size), dsizes)
            o2 = np.lexsort((v[rows_d], t_arr[rows_d], group_of))
            sel[dup_groups] = rows_d[o2[np.cumsum(dsizes) - 1]]
        u_sel = u_code[sel]
        i_sel = i_code[sel]
        v_sel = v[sel]
        # compact the vocabularies to ids that survived (bincount is O(N),
        # unlike a sort-based unique)
        used_u = np.flatnonzero(np.bincount(u_sel, minlength=user_vocab.size))
        used_i = np.flatnonzero(np.bincount(i_sel, minlength=item_vocab.size))
        u_lut = np.zeros(user_vocab.size, np.int64)
        u_lut[used_u] = np.arange(used_u.size)
        i_lut = np.zeros(item_vocab.size, np.int64)
        i_lut[used_i] = np.arange(used_i.size)
        rows = u_lut[u_sel]
        cols = i_lut[i_sel]
        uv_arr = user_vocab[used_u]
        iv_arr = item_vocab[used_i]
        td = TrainingData(
            rows=rows,
            cols=cols,
            vals=v_sel,
            user_index=BiMap.string_index(uv_arr.tolist()),
            item_index=BiMap.string_index(iv_arr.tolist()),
        )
        cache_payload = {
            "u_code": rows.astype(np.int32),
            "i_code": cols.astype(np.int32),
            "t_us": t_arr[sel].astype(np.int64),
            "vals": v_sel,
            "user_vocab": uv_arr,
            "item_vocab": iv_arr,
        }
        return td, cache_payload

    # ---------------------------------------------------- incremental cache
    def _cache_paths(self) -> tuple[str, str]:
        # the readable prefix is sanitized; the crc suffix keeps distinct
        # app names (e.g. "my/app" vs "my_app") from sharing a cache file
        name = self.params.app_name
        safe = re.sub(r"[^A-Za-z0-9_-]", "_", name)
        tag = f"{safe}-{zlib.crc32(name.encode()):08x}"
        base = os.path.join(Storage.base_dir(), "train_cache")
        return os.path.join(base, f"{tag}.npz"), os.path.join(base, f"{tag}.json")

    def _cache_manifest(self) -> dict:
        p = self.params
        return {
            "version": 1,
            "app": p.app_name,
            "rate_event": p.rate_event,
            "buy_event": p.buy_event,
            "buy_rating": p.buy_rating,
        }

    def _try_incremental(self, pe, app_id) -> TrainingData | None:
        """Delta re-index on an append-only columnar store: if a previous
        train's cache is still a valid prefix of the store (its segments
        all exist, no new tombstones, the tail only appended, no
        compaction since), read ONLY the segments/tail lines added since,
        merge them with the cached deduped matrix, and re-dedup. None
        when the cache cannot serve this read."""
        npz_path, json_path = self._cache_paths()
        try:
            with open(json_path) as f:
                meta = json.load(f)
        except (FileNotFoundError, ValueError):
            return None
        if meta.get("manifest") != self._cache_manifest():
            return None
        state = pe.scan_state(app_id)
        cached_segments = set(meta.get("segments", ()))
        if (
            meta.get("stream_id") != state.get("stream_id")
            or not meta.get("stream_id")
            or meta.get("tombstones") != state["tombstones"]
            or not cached_segments.issubset(set(state["segments"]))
            or meta.get("tail_lines", 0) > state["tail_lines"]
            # a compaction CONSUMED the recorded tail lines; once the
            # tail regrows past the recorded length, tail_skip would
            # silently skip genuinely new events — the generation
            # counter makes any pre-compaction manifest stale
            or meta.get("compactions", 0) != state.get("compactions", 0)
        ):
            return None
        new_segments = [s for s in state["segments"] if s not in cached_segments]
        try:
            with np.load(npz_path, allow_pickle=False) as z:
                cache = {k: z[k] for k in z.files}
        except (FileNotFoundError, ValueError, EOFError, OSError, zipfile.BadZipFile):
            # a truncated/empty payload invalidates the cache
            return None
        # manifest and payload must be from the SAME save: concurrent
        # trains can interleave the two atomic replaces
        if str(cache.pop("__payload_id__", "")) != meta.get("payload_id"):
            return None
        p = self.params
        delta = pe.find_columns(
            app_id,
            entity_type="user",
            event_names=[p.rate_event, p.buy_event],
            prop="rating",
            segments=new_segments,
            tail_skip=int(meta.get("tail_lines", 0)),
        )
        # TOCTOU guard: a compaction landing between the scan_state above
        # and this delta read moves the uncached tail lines into a
        # segment that is NOT in new_segments while emptying the tail —
        # the delta would silently miss them. Each storage call is
        # snapshot-consistent on its own; the two-call sequence is only
        # valid if the generation did not move underneath it.
        if pe.scan_state(app_id).get("compactions", 0) != state.get("compactions", 0):
            return None
        du, di, dt_us, dv = self._extract_ratings_arrays(delta)
        log = logging.getLogger(__name__)
        if du.size == 0:
            # nothing new: the cache IS the training data. Still advance
            # the manifest when rating-free segments/tail appeared, so
            # they are not re-scanned next time.
            if (
                meta.get("segments") != state["segments"]
                or meta.get("tail_lines") != state["tail_lines"]
            ):
                self._save_cache(dict(cache), state)
            log.info(
                "Incremental re-index: store unchanged, reusing %d cached ratings",
                cache["vals"].size,
            )
            return TrainingData(
                rows=cache["u_code"].astype(np.int64),
                cols=cache["i_code"].astype(np.int64),
                vals=cache["vals"],
                user_index=BiMap.string_index(cache["user_vocab"].tolist()),
                item_index=BiMap.string_index(cache["item_vocab"].tolist()),
            )
        # unify vocabularies (the cache vocab is exactly its used ids; du
        # is non-empty here, so the delta vocabs are non-empty too)
        user_vocab = np.unique(np.concatenate([cache["user_vocab"], delta.entity_vocab]))
        item_vocab = np.unique(np.concatenate([cache["item_vocab"], delta.target_vocab]))
        cu = np.searchsorted(user_vocab, cache["user_vocab"]).astype(np.int64)[cache["u_code"]]
        ci = np.searchsorted(item_vocab, cache["item_vocab"]).astype(np.int64)[cache["i_code"]]
        du = np.searchsorted(user_vocab, delta.entity_vocab).astype(np.int64)[du]
        di = np.searchsorted(item_vocab, delta.target_vocab).astype(np.int64)[di]
        td, payload = self._assemble_training_data(
            np.concatenate([cu, du]),
            np.concatenate([ci, di]),
            np.concatenate([cache["t_us"], dt_us]),
            np.concatenate([cache["vals"], dv]).astype(np.float32),
            user_vocab,
            item_vocab,
        )
        self._save_cache(payload, state)
        log.info(
            "Incremental re-index: merged %d cached ratings with %d delta "
            "events (%d new segments, %d new tail lines)",
            cache["vals"].size, dv.size, len(new_segments),
            state["tail_lines"] - int(meta.get("tail_lines", 0)),
        )
        return td

    def _save_cache(self, payload: dict, state: dict) -> None:
        npz_path, json_path = self._cache_paths()
        os.makedirs(os.path.dirname(npz_path), exist_ok=True)
        # the same id is stored INSIDE both files: two concurrent trains
        # interleaving their two atomic replaces could otherwise pair one
        # run's manifest with the other's payload
        payload_id = uuid.uuid4().hex
        tmp = npz_path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, __payload_id__=np.array(payload_id), **payload)
        # the cache is a pure optimization: a torn/absent file fails the
        # payload_id pairing check on load and the next train re-indexes
        # from the event store, so fsync latency here buys nothing
        os.replace(tmp, npz_path)  # piolint: waive=PIO501 -- rebuildable cache: torn files fail payload_id validation and trigger a full re-index; no acked data rides on this rename
        tmp = json_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"manifest": self._cache_manifest(), "payload_id": payload_id, **state}, f)
        os.replace(tmp, json_path)

    def _read_full(self) -> tuple[TrainingData, dict]:
        """A full read of the store: ``(TrainingData, cache_payload)``."""
        p = self.params
        cols = PEventStore.find_columns(
            app_name=p.app_name,
            entity_type="user",
            event_names=[p.rate_event, p.buy_event],
            prop="rating",
        )
        u_code, i_code, t_arr, v = self._extract_ratings_arrays(cols)
        return self._assemble_training_data(
            u_code, i_code, t_arr, v, cols.entity_vocab, cols.target_vocab
        )

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        """Vectorized single-host read: the columnar bulk scan
        (``PEventStore.find_columns``) plus numpy dedup and BiMaps, no
        per-event Python. On a store with ``scan_state`` (the columnar
        driver) and ``incremental`` on, a repeat train reads only the new
        segments/tail through :meth:`_try_incremental`, and every read
        leaves the cache for the next one. Multi-process: this process's
        shard of the events, merged across processes
        (:meth:`_read_ratings_stream`), with the job's BiMaps."""
        if ctx.num_hosts != 1:
            return self._to_training_data(self._read_ratings_stream(ctx), ctx)
        p = self.params
        pe = Storage.get_p_events()
        if not (p.incremental and hasattr(pe, "scan_state")):
            return self._read_full()[0]
        app_id, _ = resolve_app(p.app_name)
        try:
            td = self._try_incremental(pe, app_id)
            if td is not None:
                return td
        except Exception:
            logging.getLogger(__name__).warning(
                "Incremental re-index failed; falling back to a full read", exc_info=True
            )
        # BEFORE the read: a concurrent append between read and state
        # snapshot must invalidate, not count as already consumed
        state = pe.scan_state(app_id)
        td, payload = self._read_full()
        try:
            self._save_cache(payload, state)
        except OSError:
            logging.getLogger(__name__).warning("Could not persist the training cache", exc_info=True)
        return td

    def _read_ratings(self, ctx: WorkflowContext) -> list[tuple[str, str, float]]:
        """``(user, item, rating)`` per distinct pair, from a full columnar
        read (read_eval's input; it neither reads nor writes the cache), or
        multi-process from :meth:`_read_ratings_stream`."""
        if ctx.num_hosts != 1:
            return self._read_ratings_stream(ctx)
        td = self._read_full()[0]
        users = td.user_index.keys()
        items = td.item_index.keys()
        return [
            (users[r], items[c], float(v))
            for r, c, v in zip(td.rows.tolist(), td.cols.tolist(), td.vals.tolist())
        ]

    def _read_ratings_stream(self, ctx: WorkflowContext) -> list[tuple[str, str, float]]:
        """The per-event read of this process's shard of the store (the JAX
        package's multi-host path): the latest event per (user, item) wins,
        equal times go to the higher rating, and the same rule folds the
        processes' maps together (:func:`merge_keyed`, by user), so every
        pair lands on one process."""
        p = self.params
        ratings: dict[tuple[str, str], tuple[Any, float]] = {}
        for e in PEventStore.find(
            app_name=p.app_name,
            entity_type="user",
            event_names=[p.rate_event, p.buy_event],
            shard_index=ctx.host_index,
            num_shards=ctx.num_hosts,
        ):
            if e.target_entity_id is None:
                continue
            if e.event == p.buy_event:
                rating = p.buy_rating
            else:
                rating = float(e.properties.get_as("rating", float))
            key = (e.entity_id, e.target_entity_id)
            prev = ratings.get(key)
            if prev is None or (e.event_time, rating) >= prev:
                ratings[key] = (e.event_time, rating)
        if ctx.num_hosts > 1:
            from predictionio_tpu_torch.parallel.exchange import merge_keyed

            ratings = merge_keyed(ratings, combine=max)
        # float32, as training and the columnar read hold ratings
        return [(u, i, float(np.float32(r))) for (u, i), (_, r) in ratings.items()]

    @staticmethod
    def _to_training_data(
        triples: Sequence[tuple[str, str, float]], ctx: WorkflowContext | None = None
    ) -> TrainingData:
        if ctx is not None and ctx.num_hosts > 1:
            # every process builds the SAME BiMaps: only the sorted
            # vocabularies are all-gathered
            from predictionio_tpu_torch.parallel.exchange import global_vocab

            user_index = BiMap.string_index(global_vocab(u for u, _, _ in triples))
            item_index = BiMap.string_index(global_vocab(i for _, i, _ in triples))
        else:
            user_index = BiMap.string_index(u for u, _, _ in triples)
            item_index = BiMap.string_index(i for _, i, _ in triples)
        rows = np.fromiter((user_index[u] for u, _, _ in triples), np.int64, len(triples))
        cols = np.fromiter((item_index[i] for _, i, _ in triples), np.int64, len(triples))
        vals = np.fromiter((r for _, _, r in triples), np.float32, len(triples))
        return TrainingData(rows, cols, vals, user_index, item_index)

    def read_eval(self, ctx: WorkflowContext):
        """K-fold split by stable hash of (user, item): train on k-1 folds,
        query each held-out user for the full ranking, actual = the
        held-out items rated 3.5 or more, and the user's training items
        (parity: the template's ``readEval`` + e2 ``splitData``)."""
        triples = self._read_ratings(ctx)
        k = max(2, self.params.eval_k)

        def fold_of(u: str, i: str) -> int:
            return zlib.crc32(f"{u}\x00{i}".encode()) % k

        num_items = len({i for _, i, _ in triples})
        folds = []
        for fold in range(k):
            train = [t for t in triples if fold_of(t[0], t[1]) != fold]
            held = [t for t in triples if fold_of(t[0], t[1]) == fold]
            td = self._to_training_data(train)
            seen_by_user: dict[str, set] = {}
            for u, i, _ in train:
                seen_by_user.setdefault(u, set()).add(i)
            by_user: dict[str, list[str]] = {}
            for u, i, r in held:
                if r >= 3.5:  # positively-rated held-out items
                    by_user.setdefault(u, []).append(i)
            # the full ranking: PrecisionAtK skips the user's training
            # items (Actual.seen) rather than penalizing them
            qa = [
                (
                    Query(user=u, num=num_items),
                    Actual(items=tuple(items), seen=tuple(seen_by_user.get(u, ()))),
                )
                for u, items in by_user.items()
                if items
            ]
            folds.append((td, {"fold": fold}, qa))
        return folds


# ----------------------------------------------------------------- algorithm
@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    seed: int | None = 3
    implicit_prefs: bool = False
    alpha: float = 1.0
    #: the JAX package's choice between host numpy and device serving,
    #: and its latency budget for falling back to the host. Recorded, not
    #: switches: the port serves where the deploy's device says (pinned
    #: on the card, host numpy on the CPU) and never moves to the host
    #: on its own; the keys stay so the JAX package's engine.json and
    #: engine instances bind unchanged
    serve_on_device: bool = False
    device_latency_budget_ms: float = 10.0
    json_aliases = {
        "numIterations": "num_iterations",
        "lambda": "lambda_",
        "implicitPrefs": "implicit_prefs",
        "serveOnDevice": "serve_on_device",
        "deviceLatencyBudgetMs": "device_latency_budget_ms",
    }


@dataclasses.dataclass
class ALSModel:
    """Factor matrices + id maps: host numpy after ``train`` and in blobs,
    tensors on the algorithm's device once pinned
    (``pin_model_for_serving``)."""

    user_factors: Any  # [U, K]
    item_factors: Any  # [I, K]
    user_index: BiMap
    item_index: BiMap


def _call(fn: Callable, *args: Any) -> Any:
    return fn(*args)


class ALSAlgorithm(TorchAlgorithm):
    params_class = ALSAlgorithmParams
    query_class = Query

    #: queries per scoring product in batch_predict (shared with the
    #: JAX package: serving_util.TOPK_CHUNK; a class attribute so tests can
    #: shrink it to force several chunks)
    BATCH_PREDICT_CHUNK = TOPK_CHUNK

    def __init__(self, params: ALSAlgorithmParams, device: str | torch.device | None = None):
        super().__init__(params, device)
        #: optional ``on_sweep(step, user, item)`` hook handed to train_als
        self.on_sweep: Callable[[int, torch.Tensor, torch.Tensor], None] | None = None

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> ALSModel:
        """ALS on :attr:`device` (the engine builds the algorithm on
        ``ctx.device``), or on ``ctx.mesh`` when the context has one; the
        model comes back as host numpy. With a
        previous model in ``ctx.warm_model`` (``pio train --warm-start``)
        the users and items present in both id spaces start from their
        previous rows (:func:`aligned_factor_init`), the others from the
        cold draw of the JAX package's warm start."""
        p = self.params
        seed = 0 if p.seed is None else p.seed
        init_user = init_item = None
        warm = ctx.warm_model
        if isinstance(warm, ALSModel):
            init_user, n_u = aligned_factor_init(
                warm.user_factors, warm.user_index, pd.user_index, p.rank, seed
            )
            init_item, n_i = aligned_factor_init(
                warm.item_factors, warm.item_index, pd.item_index, p.rank, seed + 1
            )
            logging.getLogger(__name__).info(
                "Warm start: carried %d/%d user and %d/%d item vectors",
                n_u, len(pd.user_index), n_i, len(pd.item_index),
            )
        factors = train_als(
            pd.rows,
            pd.cols,
            pd.vals,
            num_users=len(pd.user_index),
            num_items=len(pd.item_index),
            config=ALSConfig(
                rank=p.rank,
                iterations=p.num_iterations,
                reg=p.lambda_,
                implicit=p.implicit_prefs,
                alpha=p.alpha,
                seed=seed,
            ),
            init_user=init_user,
            init_item=init_item,
            device=self.device,
            on_sweep=self.on_sweep,
            mesh=ctx.mesh,
        )
        return ALSModel(
            user_factors=factors.user.cpu().numpy(),
            item_factors=factors.item.cpu().numpy(),
            user_index=pd.user_index,
            item_index=pd.item_index,
        )

    def prepare_model_for_serving(self, model: ALSModel) -> ALSModel:
        """On the card, pin the factor tables there; on the CPU, keep them
        host numpy (the JAX package's host serving). Then warm the
        scoring path with one query."""
        if self.device.type == "cuda":
            model, _ = self.pin_model_for_serving(model)
        else:
            model.user_factors = np.ascontiguousarray(model.user_factors)
            model.item_factors = np.ascontiguousarray(model.item_factors)
        self.warm_up(model)
        return model

    # ------------------------------------------------------ pinned serving
    def pin_model_for_serving(self, model: ALSModel) -> tuple[ALSModel, int]:
        """The ``--pin-model`` tier (workflow/device_state.py): the factor
        tables become tensors on :attr:`device` once per model generation,
        and predict/batch_predict score there. Returns the model and the
        bytes it now holds there (``bytesPinned`` on /stats.json).
        Idempotent. The host arrays are kept on the model, so
        :meth:`release_pinned_model` drops the device tables without a
        copy back while no online update has moved a row."""
        return pin_tables(model, self.device, "user_factors", "item_factors")

    def release_pinned_model(self, model: ALSModel) -> None:
        """Drop a superseded generation's pinned tables: the model gets its
        host arrays back and the device tensors lose their last
        reference, so their memory is freed at once. After an online
        update the pin-time host arrays are stale (``apply_online_update``
        dropped them), so the folded tables are copied back instead; int8
        tables come back dequantized, as host f32; sharded tables gathered
        from every shard, without their padding rows."""
        release_tables(model, "user_factors", "item_factors")

    # ------------------------------------------------------ sharded serving
    def shard_model_for_serving(self, model: ALSModel) -> tuple[ALSModel, int]:
        """The ``--shard-factors`` tier (workflow/device_state.py): each
        device of the serving mesh holds a ``[rows/S, K]`` part of each
        factor table instead of a replica; predict/batch_predict take the
        sharded kernels (``parallel/sharding.py``), whose answers equal
        the replicated exact path's. With one device visible it logs the
        JAX package's warning and pins replicated. Returns the model and
        the bytes of the padded tables."""
        return shard_tables(model, self.device, "user_factors", "item_factors")

    # ---------------------------------------------------- quantized serving
    def quantize_model_for_serving(
        self, model: ALSModel, mode: str = "int8", shard: bool = False
    ) -> tuple[ALSModel, int]:
        """The ``--quantize int8`` tier: both factor tables as int8 codes
        and per-row f32 scales on :attr:`device` (``rank + 4`` bytes a row
        instead of ``4·rank``); predict/batch_predict then take the
        two-stage top-k (int8 coarse scan over-fetching ``max(4k, k+64)``,
        f32 rescore, the shared tie rule). ``shard=True`` (with
        ``--shard-factors``) shards the codes and scales over the serving
        mesh. Returns ``(model, bytes pinned)``."""
        return quantize_tables(model, "user_factors", "item_factors", self.device, mode, shard)

    # --------------------------------------------------- ANN retrieval
    def build_ann_for_serving(self, model: ALSModel, ann) -> tuple[ALSModel, dict]:
        """The ``--ann`` tier: cluster the item factors into an IVF index on
        :attr:`device` once per model generation (int8 slabs under
        ``--quantize``); predict/batch_predict then score only ``nprobe``
        cluster slabs a query. Sharded tables: k-means over the logical
        rows, then the index laid out over the mesh. Returns the model
        (``model._pio_ann`` attached) and the build info for
        ``/stats.json``."""
        return build_ann(model, "item_factors", ann, self.device, type(self).__name__)

    def release_ann_state(self, model: ALSModel) -> None:
        """Drop a superseded generation's IVF index (a hot-reloading server
        must not hold one index per swap)."""
        if getattr(model, "_pio_ann", None) is not None:
            model._pio_ann = None

    # ---------------------------------------------------- AOT serving export
    def aot_export_for_serving(self, model: ALSModel, buckets: list) -> dict:
        """The ``--aot`` tier (``workflow/aot.py``): the pinned exact
        serving programs, the k-independent ``predict_scores`` and per
        bucket the top-k of one score row and the batch product's top-k
        over chunks of :attr:`BATCH_PREDICT_CHUNK` (:func:`aot_serving_programs`).
        Scoring and selection stay two programs, as in the eager path, so
        no bucket changes a score's bits. Sharded and int8 generations
        export nothing."""
        return aot_serving_programs(model, "user_factors", "item_factors", buckets, self.BATCH_PREDICT_CHUNK, self.device)

    def aot_warm_serving(self, model: ALSModel) -> None:
        """One query through the loaded programs at boot, on the serving
        thread, so the first user's query finds the tier-1 path ready; a
        model without pinned tables or programs is left as it is."""
        if getattr(model, "_pio_pinned", False) and getattr(model, "_pio_aot", None) is not None and len(model.user_index):
            self.predict(model, Query(user=model.user_index.keys()[0], num=4))

    # ------------------------------------------------------ online fold-in
    @staticmethod
    def _online_state(model: ALSModel, max_entities: int) -> dict:
        """Per-model online rating accumulator (LRU-bounded per side):
        the follower only sees events since deploy, so each touched
        entity's re-solve uses its accumulated ONLINE history anchored to
        its trained row (online/foldin.py). Dies with the model on a full
        /reload — by then a retrain owns the history."""
        state = getattr(model, "_pio_online", None)
        if state is None:
            state = {"users": OrderedDict(), "items": OrderedDict(), "max": max_entities}
            model._pio_online = state
        return state

    @staticmethod
    def _remember(side: OrderedDict, key: str, other: str, t_us: int, rating: float, cap: int) -> None:
        hist = side.get(key)
        if hist is None:
            hist = side[key] = {}
        side.move_to_end(key)
        prev = hist.get(other)
        if prev is None or (t_us, rating) >= prev:
            hist[other] = (t_us, rating)
        while len(side) > cap:
            side.popitem(last=False)

    def online_foldin(self, model: ALSModel, deltas, ds_params, config, run: Callable | None = None):
        """Re-solved rows for the users/items a delta batch touched —
        fixed opposite-side factors, ALS-WR objective, prior anchor
        (online/foldin.py), solved on :attr:`device`. Read-only. The
        history and the systems are built on the calling thread; ``run``
        runs the torch calls (the prior rows' gather, the Gramian of an
        implicit model and the solves)."""
        from predictionio_tpu_torch.online.foldin import foldin_rows, gram_yty
        from predictionio_tpu_torch.online.types import OnlineUpdate, latest_wins
        from predictionio_tpu_torch.workflow import device_state

        run = run or _call
        p = self.params
        rate_event = ds_params.get("rate_event", ds_params.get("rateEvent", "rate"))
        buy_event = ds_params.get("buy_event", ds_params.get("buyEvent", "buy"))
        buy_rating = float(ds_params.get("buy_rating", ds_params.get("buyRating", 4.0)))
        # map the event mix to ratings, then collapse with the shared
        # latest-wins rule (one source of truth with the training read)
        rated = latest_wins(
            [
                dataclasses.replace(d, rating=buy_rating) if d.event == buy_event else d
                for d in deltas
                if d.event in (rate_event, buy_event)
            ]
        )
        if not rated:
            return None
        state = self._online_state(model, config.max_entities)
        for (u, i), (t_us, r) in rated.items():
            self._remember(state["users"], u, i, t_us, r, state["max"])
            self._remember(state["items"], i, u, t_us, r, state["max"])
        touched_users = sorted({u for u, _ in rated})
        touched_items = sorted({i for _, i in rated})
        implicit = p.implicit_prefs
        yty_item = yty_user = None
        if implicit:
            # the implicit objective's Gramian over the opposite factors,
            # once per model object (it dies with the model on /reload);
            # folds move a few rows, so it drifts slightly — the
            # approximation MLlib's fold-in makes with the training-time
            # Gramian
            if "yty_item" not in state:
                state["yty_item"] = run(gram_yty, model.item_factors)
                state["yty_user"] = run(gram_yty, model.user_factors)
            yty_item = state["yty_item"]
            yty_user = state["yty_user"]

        def solve_side(touched, side_hist, own_factors, own_index, opp_index, opp_factors, yty):
            ids, entries, prior_rows = [], [], []
            n_own = int(own_factors.shape[0])
            for ent in touched:
                hist = side_hist.get(ent, {})
                pairs = [(idx, r) for other, (_, r) in hist.items() if (idx := opp_index.get(other)) is not None]
                if not pairs:
                    continue  # nothing resolvable yet (opposite unseen)
                row = own_index.get(ent)
                ids.append(ent)
                entries.append(([ix for ix, _ in pairs], [r for _, r in pairs]))
                # -1 = cold start: pure fold-in from first events
                prior_rows.append(row if row is not None and row < n_own else -1)
            if not ids:
                return [], None
            # gather ONLY the touched prior rows: on the card one device
            # gather and a len(ids)-row copy, never the whole table
            prior_rows = np.asarray(prior_rows, np.int64)
            known = prior_rows >= 0
            if n_own:
                gathered = run(device_state.get_rows, own_factors, np.where(known, prior_rows, 0))
            else:
                gathered = np.zeros((len(ids), int(own_factors.shape[1])), np.float32)
            priors = np.where(known[:, None], gathered, 0.0).astype(np.float32)
            weights = np.where(known, config.prior_weight, 0.0).astype(np.float32)
            rows = foldin_rows(
                opp_factors, entries, reg=p.lambda_, priors=priors, prior_weights=weights,
                implicit=implicit, alpha=p.alpha, yty=yty, device=self.device, run=run,
            )
            return ids, rows

        user_ids, user_rows = solve_side(
            touched_users, state["users"], model.user_factors,
            model.user_index, model.item_index, model.item_factors, yty_item,
        )
        item_ids, item_rows = solve_side(
            touched_items, state["items"], model.item_factors,
            model.item_index, model.user_index, model.user_factors, yty_user,
        )
        if not user_ids and not item_ids:
            return None
        return OnlineUpdate(
            user_ids=user_ids,
            user_rows=user_rows,
            item_ids=item_ids,
            item_rows=item_rows,
            # every user who RATED in this batch sees changed results even
            # when only the item side of their pair moved
            extra_scopes=sorted({u for u, _ in rated}),
            info={"ratings": len(rated)},
        )

    def apply_online_update(self, model: ALSModel, upd) -> dict:
        """Swap the computed rows into the live model — the query server
        runs it on its device thread after the generation check: row
        swaps (out of place on the pinned tables), id-map extension for
        cold starts. The pin-time host arrays go stale with the first
        swap, so they are dropped (:meth:`release_pinned_model` then
        copies the folded tables back)."""
        from predictionio_tpu_torch.workflow import device_state

        model._pio_host = None
        info = {"usersUpdated": 0, "itemsUpdated": 0, "usersAdded": 0, "itemsAdded": 0}
        if upd.user_ids:
            info["usersUpdated"], info["usersAdded"] = device_state.swap_side_rows(
                model, upd.user_ids, upd.user_rows, "user_factors", "user_index", rows_before_index=True
            )
        if upd.item_ids:
            info["itemsUpdated"], info["itemsAdded"] = device_state.swap_side_rows(
                model, upd.item_ids, upd.item_rows, "item_factors", "item_index", rows_before_index=False
            )
            if info["itemsAdded"]:
                # the batchpredict fast path caches per-item JSON prefixes
                # by index — a grown catalog invalidates them
                model._item_json_prefix = None
            ann_info = device_state.update_ann_items(model, upd.item_ids, upd.item_rows)
            if ann_info is not None:
                info["ann"] = ann_info
        return info

    def warm_up(self, model: ALSModel) -> None:
        """Make the calling thread ready to serve: the device current, and
        one query through the scoring path (a CUDA thread sets up its
        context and cuBLAS handle on its first product)."""
        super().warm_up(model)
        if len(model.user_index):
            self.predict(model, Query(user=model.user_index.keys()[0], num=4))

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        uidx = model.user_index.get(query.user)
        if uidx is None:
            return PredictedResult(())
        k = min(int(query.num), len(model.item_index))
        if k <= 0:
            return PredictedResult(())
        ann = getattr(model, "_pio_ann", None)
        quantrt = getattr(model, "_pio_quant", None)
        shards = getattr(model, "_pio_shards", None)
        if isinstance(model.item_factors, np.ndarray):
            self.check_host_serving()
        if ann is not None:
            from predictionio_tpu_torch.ops import ivf

            if quantrt is not None:
                # int8 user table: only this row dequantizes
                qvec = model.user_factors[np.asarray([uidx], np.int64)][0]
            else:
                qvec = model.user_factors[uidx]  # sharded: from its owner shard
            pairs = zip(*ivf.query_topk(ann, qvec, k))
        elif quantrt is not None:
            # int8 exact: coarse scan with over-fetch, f32 rescore (the
            # sharded kernel under --shard-factors)
            from predictionio_tpu_torch.ops import quant

            ids_b, scores_b = quant.topk_users(
                quantrt, model.user_factors, model.item_factors, [uidx], k, shards=shards
            )
            pairs = zip(ids_b[0].tolist(), scores_b[0].tolist())
        elif shards is not None:
            # sharded exact: each shard scores its items, S·k finalists merge
            from predictionio_tpu_torch.parallel import sharding

            ids_b, scores_b = sharding.topk_users(shards, model.user_factors, model.item_factors, [uidx], k)
            pairs = zip(ids_b[0].tolist(), scores_b[0].tolist())
        elif isinstance(model.item_factors, np.ndarray):
            # host branch (the CPU, asked for): one GEMV + partial sort,
            # the JAX package's code (shared tie rule: ops/topk.py)
            scores = model.item_factors @ np.asarray(model.user_factors[uidx])
            top, vals = top_k_host(scores, k)
            pairs = zip(top.tolist(), vals.tolist())
        else:
            # pinned branch: the k-independent GEMV, then the stable sort;
            # under --aot the exported programs of k's bucket, sliced to k
            aot = getattr(model, "_pio_aot", None)
            top = None
            if aot is not None:
                top = aot_predict(aot, model.user_factors[uidx], model.item_factors, k, len(model.item_index))
            if top is None:
                top = top_k_scores(predict_scores(model.user_factors[uidx], model.item_factors), k)
            idx, vals = top
            pairs = zip(idx.tolist(), vals.tolist())
        inverse = model.item_index.inverse
        return PredictedResult(tuple(ItemScore(item=inverse(i), score=s) for i, s in pairs))

    def batch_predict(
        self, model: ALSModel, queries: Sequence[tuple[int, Query]]
    ) -> list[tuple[int, PredictedResult]]:
        """Score chunks of queries with one ``[B,K]@[K,I]`` product and one
        top-k each (:func:`chunked_topk`: on the pinned tables' device
        with one crossing to the host, or numpy on the CPU)."""
        n_items = len(model.item_index)
        results: list[tuple[int, PredictedResult]] = []
        valid: list[tuple[int, int, int]] = []  # (orig idx, uidx, k)
        for idx, q in queries:
            uidx = model.user_index.get(q.user)
            k = min(int(q.num), n_items)
            if uidx is None or k <= 0:
                results.append((idx, PredictedResult(())))
            else:
                valid.append((idx, uidx, k))
        inverse = model.item_index.inverse
        for part, idx_l, score_l in self._topk_staged(model, valid):
            for (oi, _, k), ids, scs in zip(part, idx_l, score_l):
                results.append((oi, PredictedResult(tuple(
                    ItemScore(item=inverse(i), score=s) for i, s in zip(ids[:k], scs[:k])
                ))))
        return results

    def _topk_staged(self, model: ALSModel, valid: list):
        """Chunked top-k over ``valid = [(slot, uidx, k), ...]``
        (:func:`chunked_topk`; through the IVF index under ``--ann``, the
        two-stage int8 top-k under ``--quantize``)."""
        if isinstance(model.item_factors, np.ndarray):
            self.check_host_serving()
        return chunked_topk(
            model.user_factors, model.item_factors, valid, chunk=self.BATCH_PREDICT_CHUNK,
            ann=getattr(model, "_pio_ann", None), quant=getattr(model, "_pio_quant", None),
            shards=getattr(model, "_pio_shards", None), aot=getattr(model, "_pio_aot", None),
        )

    def batch_predict_json(self, model: ALSModel, bodies: Sequence[Any]) -> list[str | None]:
        """Bulk scoring straight to JSON payload strings (the ``pio
        batchpredict`` fast path — ``QueryService.handle_batch_jsonlines``;
        the JAX package's code). Only bodies that bind trivially
        (``{"user": str, "num"?: int}``) are answered; anything else is
        ``None`` in its slot, for the caller's exact slow path. Each
        string is ``PredictedResult.to_json`` serialized: same scores,
        same order."""
        n_items = len(model.item_index)
        get_u = model.user_index.get
        out: list[str | None] = [None] * len(bodies)
        valid: list[tuple[int, int, int]] = []
        for j, b in enumerate(bodies):
            if not isinstance(b, Mapping) or set(b) - {"user", "num"}:
                continue  # the slow path replicates the exact bind/error behavior
            user = b.get("user")
            num = b.get("num", 4)
            if not isinstance(user, str) or type(num) is not int:
                continue
            uidx = get_u(user)
            k = min(num, n_items)
            if uidx is None or k <= 0:
                out[j] = '{"itemScores": []}'
            else:
                valid.append((j, uidx, k))
        if not valid:
            return out
        # per-item prefix strings, built once per model by index order
        pre = getattr(model, "_item_json_prefix", None)
        if pre is None:
            inverse = model.item_index.inverse
            pre = ['{"item": %s, "score": ' % json.dumps(inverse(i)) for i in range(n_items)]
            model._item_json_prefix = pre
        for part, idx_l, score_l in self._topk_staged(model, valid):
            for (j, _, k), ids, scs in zip(part, idx_l, score_l):
                out[j] = (
                    '{"itemScores": ['
                    + ", ".join(pre[i] + repr(s) + "}" for i, s in zip(ids[:k], scs[:k]))
                    + "]}"
                )
        return out


class PrecisionAtK(OptionAverageMetric):
    """Fraction of recommended items that are in the held-out positives
    (parity: the eval metric of the reference recommendation template)."""

    def __init__(self, k: int = 10):
        self.k = k

    def header(self) -> str:
        return f"Precision@{self.k}"

    def calculate_unit(self, query, predicted: PredictedResult, actual) -> float | None:
        if not predicted.item_scores:
            return None
        if isinstance(actual, Actual):
            positives, seen = set(actual.items), set(actual.seen)
        else:  # plain iterable of positive items
            positives, seen = set(actual), set()
        top = [s.item for s in predicted.item_scores if s.item not in seen][: self.k]
        if not top:
            return None
        hits = sum(1 for i in top if i in positives)
        return hits / len(top)


def engine_factory() -> Engine:
    return Engine(
        datasource_class=RecommendationDataSource,
        preparator_class=IdentityPreparator,
        algorithms_class_map={"als": ALSAlgorithm},
        serving_class=FirstServing,
    )
