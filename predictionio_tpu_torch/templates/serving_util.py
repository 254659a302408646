"""Shared serving-path helpers for engine templates.

Counterpart of ``predictionio_tpu/templates/serving_util.py``:

* :func:`chunked_topk`. Its host branch is the JAX package's numpy code
  (one GEMM and :func:`top_k_host` a chunk), so the two packages' host
  answers are equal to the bit wherever no tie straddles the k-th place
  (there the port keeps the lowest indices, as ``jax.lax.top_k`` does,
  and the reference's ``top_k_host`` arbitrary ones); its device branch
  scores each chunk (``ops/als.score_rows``) on the tensors' device and
  crosses to the host once for the whole call. The IVF (``ann=``), int8
  (``quant=``) and sharded (``shards=``) branches keep that rule
  (:func:`_drain_staged`). Under ``pio deploy --aot`` (``aot=``, the
  model's :class:`~predictionio_tpu_torch.workflow.aot.AotRuntime`) the
  exact device branch runs each chunk through the exported batch program
  of its bucket, the ids padded to the product's multiple of 8 rows as
  ``score_rows`` pads the queries, so the answers keep the eager bits.
* :func:`aot_serving_programs` and :func:`aot_predict`: both templates'
  export hook and their pinned single-query path under ``--aot``.
* :func:`aligned_factor_init`, a copy: a warm retrain's carried rows.
* :func:`pin_tables`, :func:`shard_tables`, :func:`release_tables`,
  :func:`quantize_tables` and :func:`build_ann`: the templates' pin and
  release of their tables, their ``--shard-factors`` and ``--quantize
  int8`` pins and their ``--ann`` index build.
* :func:`allowed_items` and :func:`masked_topk`: the business rules of the
  SimilarProduct and ECommerce templates (excluded items, ``whiteList``,
  ``blackList``, ``categories``; the category test done by item rows
  instead of a Python loop over the catalog) and their ranking of the
  allowed items.

``device_latency_ok`` is not ported on purpose: in the JAX package it
moves serving to the host when the device answers slowly, and the port
never leaves the device without being asked (ROADMAP queue 3).
"""

from __future__ import annotations

import logging
from typing import Callable, Iterator, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from predictionio_tpu_torch.ops.als import SCORE_QUERY_ROWS, top_k_items_batch
from predictionio_tpu_torch.ops.topk import bucket_k, top_k_host, top_k_scores
from predictionio_tpu_torch.templates.results import ItemScore, PredictedResult

__all__ = [
    "TOPK_CHUNK", "chunked_topk", "aligned_factor_init", "pin_tables", "shard_tables", "release_tables",
    "quantize_tables", "build_ann", "allowed_items", "masked_topk", "aot_serving_programs", "aot_predict",
]

logger = logging.getLogger(__name__)

#: the JAX package's warning when --shard-factors finds one device
_ONE_DEVICE = "--shard-factors requested but only one device is visible; falling back to --pin-model replication"

#: queries per score product in :func:`chunked_topk` (the JAX package's
#: value, so a host chunk's GEMM has the same shape in both packages)
TOPK_CHUNK = 2048


def _drain_staged(staged: list, n_items: int) -> Iterator[tuple[list, list, list]]:
    """Drain chunk-staged device results ``[(part, ids, scores), ...]``
    with ONE crossing to the host: every chunk's ids (int32) and the bit
    patterns of its scores pack into one tensor, then each row drops its
    sentinel padding (``id >= n_items`` at ``-inf``) before any consumer
    sees it. Shared by the exact, IVF and int8 paths."""
    packed = [
        torch.cat([ids.to(torch.int32), scores.to(torch.float32).view(torch.int32)], dim=1)
        for _, ids, scores in staged
    ]
    width = packed[0].shape[1] // 2
    host = torch.cat(packed).cpu().numpy() if len(packed) > 1 else packed[0].cpu().numpy()
    ids_all = host[:, :width]
    scores_all = np.ascontiguousarray(host[:, width:]).view(np.float32)
    off = 0
    for part, _, _ in staged:
        ids_b = ids_all[off : off + len(part)]
        scores_b = scores_all[off : off + len(part)]
        keep = ids_b < n_items
        if keep.all():
            yield part, ids_b.tolist(), scores_b.tolist()
        else:
            yield part, [i[m].tolist() for i, m in zip(ids_b, keep)], [s[m].tolist() for s, m in zip(scores_b, keep)]
        off += len(part)


def chunked_topk(
    user_mat, item_mat, valid: Sequence[tuple], chunk: int = TOPK_CHUNK,
    ann=None, shards=None, quant=None, aot=None,
) -> Iterator[tuple[list, list, list]]:
    """Chunked batch top-k over ``valid = [(slot, uidx, k), ...]``;
    yields ``(part, ids, scores)`` with ids/scores as Python lists of up
    to ``bucket_k(max k)`` entries a row (each caller trims its own k).

    Host tables (numpy) take one numpy GEMM and :func:`top_k_host` a
    chunk. Tensor tables (pinned on the card, or on the CPU when the
    caller asked for it) take one :func:`top_k_items_batch` a chunk, at
    the chunk's own row count (the micro-batcher already pads to its
    buckets); every chunk's ids and scores cross to the host together.

    ``ann`` (an :class:`~predictionio_tpu_torch.ops.ivf.AnnRuntime`)
    routes the scoring through the IVF probe: only ``nprobe`` cluster
    slabs are scored a query. The chunk's user rows are gathered where
    the user table lives (host rows for a numpy table, as the JAX
    unpinned branch does; dequantized rows for an int8 table), at the
    chunk's own row count, so the full probe (``nprobe >= nlist``)
    computes exactly what the exact branch does for the same rows.
    ``quant`` (a :class:`~predictionio_tpu_torch.ops.quant.QuantRuntime`)
    runs the two-stage int8 top-k on int8 tables. ``shards`` (the model's
    :class:`~predictionio_tpu_torch.parallel.sharding.ShardInfo`, ``pio
    deploy --shard-factors``) means both tables are row-sharded: the exact
    and int8 branches take the sharded kernels, the IVF branch gathers the
    chunk's user rows from their owner shards and probes the
    cluster-sharded index; the catalog is the logical item count. All keep
    the one-crossing rule and trim sentinel padding here. ``aot`` (the
    model's :class:`~predictionio_tpu_torch.workflow.aot.AotRuntime`,
    ``pio deploy --aot``) serves the exact device branch's chunks through
    the exported ``top_k_items_batch_c{chunk}_b{k}`` program where one
    fits (:func:`_aot_batch`), the eager product where none does."""
    if not valid:
        return
    # sharded tables are padded to an even split: the LOGICAL catalog
    # lives on the ShardInfo
    n_items = int(shards.rows["item"]) if shards is not None else int(item_mat.shape[0])
    k_max = bucket_k(max(k for _, _, k in valid), n_items)
    if ann is not None:
        from predictionio_tpu_torch.ops import ivf

        # one index for the whole call: an online update swaps ann.index
        # whole, and a call that started on the old one finishes on it
        index = ann.index
        staged = []
        for lo in range(0, len(valid), chunk):
            part = list(valid[lo : lo + chunk])
            uidx = np.fromiter((u for _, u, _ in part), np.int64, len(part))
            if shards is not None:
                from predictionio_tpu_torch.parallel import sharding

                # the chunk's user rows from their owner shards (an int8
                # table's dequantized), then the cluster-sharded probe
                idx_b, score_b = sharding.sharded_ivf_topk(user_mat[uidx], index, k_max, ann.nprobe)
            elif isinstance(user_mat, torch.Tensor):
                idx_b, score_b = ivf.ivf_topk_users(
                    torch.as_tensor(uidx, device=user_mat.device), user_mat, index, k_max, ann.nprobe
                )
            else:
                # a numpy table: the chunk's host rows; an int8 table: its
                # dequantized rows, on the table's device
                idx_b, score_b = ivf.ivf_topk_batch(user_mat[uidx], index, k_max, ann.nprobe)
            ann.note_queries(len(part))
            staged.append((part, idx_b, score_b))
        yield from _drain_staged(staged, n_items)
        return
    if quant is not None:
        from predictionio_tpu_torch.ops import quant as quant_ops

        staged = []
        for lo in range(0, len(valid), chunk):
            part = list(valid[lo : lo + chunk])
            uidx = np.fromiter((u for _, u, _ in part), np.int64, len(part))
            idx_b, score_b = quant_ops.run_topk(quant, user_mat, item_mat, uidx, k_max, shards=shards)
            staged.append((part, idx_b, score_b))
        yield from _drain_staged(staged, n_items)
        return
    if isinstance(item_mat, np.ndarray):
        for lo in range(0, len(valid), chunk):
            part = list(valid[lo : lo + chunk])
            uidx_arr = np.fromiter((u for _, u, _ in part), np.int32, len(part))
            scores = np.asarray(user_mat)[uidx_arr] @ np.asarray(item_mat).T  # [B, I]
            # descending score, ties to the lower item index (ops/topk.py)
            idx_b, score_b = top_k_host(scores, k_max)
            yield part, idx_b.tolist(), score_b.tolist()
        return
    staged = []
    for lo in range(0, len(valid), chunk):
        part = list(valid[lo : lo + chunk])
        uidx = torch.as_tensor(
            np.fromiter((u for _, u, _ in part), np.int64, len(part)), device=item_mat.device
        )
        if shards is not None:
            from predictionio_tpu_torch.parallel import sharding

            idx_b, score_b = sharding.sharded_topk_users(uidx, user_mat, item_mat, k_max, n_items)
        else:
            out = _aot_batch(aot, uidx, user_mat, item_mat, chunk, k_max) if aot is not None else None
            idx_b, score_b = out if out is not None else top_k_items_batch(uidx, user_mat, item_mat, k_max)
        staged.append((part, idx_b, score_b))
    yield from _drain_staged(staged, n_items)


def _aot_batch(aot, uidx: torch.Tensor, user_mat, item_mat, chunk: int, k: int):
    """One chunk through the exported batch program of bucket ``k``:
    ``([n, k], [n, k])``, or ``None`` when no program fits. The ids are
    padded with row 0 to the multiple of ``SCORE_QUERY_ROWS`` that
    ``score_rows`` pads the queries to, so the product, and every real
    row's scores, are the eager path's; the padding rows are dropped."""
    n = int(uidx.shape[0])
    padded = F.pad(uidx, (0, -n % SCORE_QUERY_ROWS))
    out = aot.run(f"top_k_items_batch_c{chunk}_b{k}", padded, user_mat, item_mat)
    if out is None:
        return None
    idx_b, score_b = out
    return idx_b[:n], score_b[:n]


def aot_predict(aot, user_vec: torch.Tensor, items, k: int, n_items: int):
    """Both templates' pinned single query under ``pio deploy --aot``:
    the exported k-independent ``predict_scores``, then ``top_k_scores``
    of ``k``'s bucket, sliced to ``k``. ``None`` (serve eagerly) when the
    scoring program does not fit; a bucket without its program selects
    eagerly from the program's scores, which are the eager path's bits."""
    scores = aot.run("predict_scores", user_vec, items)
    if scores is None:
        return None
    kb = bucket_k(k, n_items)
    top = aot.run(f"top_k_scores_b{kb}", scores)
    idx, vals = top if top is not None else top_k_scores(scores, kb)
    return idx[:k], vals[:k]


def aot_serving_programs(model, user_attr: str, item_attr: str, buckets: Sequence[int], chunk: int, device) -> dict:
    """Both templates' ``aot_export_for_serving`` (``workflow/aot.py``):
    the k-independent ``predict_scores``, then for each k bucket
    ``top_k_scores_b{k}`` and ``top_k_items_batch_c{chunk}_b{k}`` (its
    query rows any multiple of 8 up to the chunk), as
    :class:`~predictionio_tpu_torch.workflow.aot.ServingProgram` s over
    the model's f32 tables on their device (host tables go to
    ``device``). Sharded and int8 generations export nothing: their
    kernels read live runtime objects (the mesh, the codes)."""
    if getattr(model, "_pio_shards", None) is not None or getattr(model, "_pio_quant", None) is not None:
        return {}
    from predictionio_tpu_torch.ops.als import PredictScoresProgram, TopKItemsBatchProgram, TopKScoresProgram
    from predictionio_tpu_torch.workflow.aot import ServingProgram

    users, items = (
        t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t, np.float32), device=device).contiguous()
        for t in (getattr(model, user_attr), getattr(model, item_attr))
    )
    # at least 16 rows, so the exported row count is never specialised to 8
    rows = max(2 * SCORE_QUERY_ROWS, -(-int(chunk) // SCORE_QUERY_ROWS) * SCORE_QUERY_ROWS)
    uidx = torch.zeros(rows, dtype=torch.int64, device=users.device)
    scores = torch.zeros(int(items.shape[0]), dtype=torch.float32, device=items.device)
    out = {"predict_scores": ServingProgram(PredictScoresProgram(), (users[0], items))}
    for kb in buckets:
        out[f"top_k_scores_b{kb}"] = ServingProgram(TopKScoresProgram(kb), (scores,))
        out[f"top_k_items_batch_c{chunk}_b{kb}"] = ServingProgram(
            TopKItemsBatchProgram(kb), (uidx, users, items), {0: (0, SCORE_QUERY_ROWS, rows)}
        )
    return out


def aligned_factor_init(
    old_factors: np.ndarray,
    old_index,
    new_index,
    rank: int,
    seed: int,
    fresh: Callable | None = None,
) -> tuple[np.ndarray, int]:
    """Carry a previous model's factor/embedding rows over to a new id
    space: entities present in both keep their vectors (overlapping
    columns when the rank changed); new entities get the standard
    abs(normal)/sqrt(rank) draw. This is what makes a warm retrain start
    near the previous optimum even as the catalog shifts (shared by the
    ALS and two-tower templates). Returns (init matrix, number of carried
    rows).

    ``fresh(rng, shape)`` draws the init for NON-carried rows; the
    default is ALS's nonnegative abs(normal)/sqrt(rank). Templates whose
    cold init differs (e.g. the two-tower's signed normal) must pass
    their own draw, or new entities would start in the wrong
    distribution — for towers, all in the positive orthant with pairwise
    cosine ~0.64 instead of ~0."""
    rng = np.random.default_rng(seed)
    shape = (len(new_index), rank)
    if fresh is None:
        out = (np.abs(rng.standard_normal(shape)) / np.sqrt(rank)).astype(
            np.float32
        )
    else:
        out = np.asarray(fresh(rng, shape), np.float32)
        if out.shape != shape:
            raise ValueError(f"fresh draw returned {out.shape}, want {shape}")
    old = np.asarray(old_factors)
    k = min(rank, old.shape[1])
    old_d, new_d = old_index.to_dict(), new_index.to_dict()
    if not old_d or not new_d:
        return out, 0
    # vectorized key intersection — a per-key Python loop would cost
    # minutes at catalog scale
    old_keys = np.asarray(list(old_d), dtype=np.str_)
    old_rows = np.fromiter(old_d.values(), np.int64, len(old_d))
    new_keys = np.asarray(list(new_d), dtype=np.str_)
    new_rows = np.fromiter(new_d.values(), np.int64, len(new_d))
    o_sort = np.argsort(old_keys)
    pos = np.searchsorted(old_keys, new_keys, sorter=o_sort)
    pos_c = np.minimum(pos, old_keys.size - 1)
    hit = old_keys[o_sort[pos_c]] == new_keys
    src = old_rows[o_sort[pos_c[hit]]]
    ok = src < old.shape[0]
    out[new_rows[hit][ok], :k] = old[src[ok], :k]
    return out, int(ok.sum())


def pin_tables(model, device, *attrs: str) -> tuple[object, int]:
    """The templates' ``pin_model_for_serving`` (the ``--pin-model`` tier,
    and every deploy on the card): the host arrays ``attrs`` become
    float32 tensors on ``device`` once per model generation (idempotent),
    and stay on the model as ``_pio_host`` for :func:`release_tables`.
    Returns the model and the bytes its tables hold there."""
    if all(isinstance(getattr(model, a), np.ndarray) for a in attrs):
        model._pio_host = tuple(getattr(model, a) for a in attrs)
        for attr, arr in zip(attrs, model._pio_host):
            setattr(model, attr, torch.as_tensor(np.asarray(arr, np.float32), device=device).contiguous())
    model._pio_pinned = True
    nbytes = sum(getattr(model, a).numel() * getattr(model, a).element_size() for a in attrs)
    model._pio_bytes_by_dtype = {"float32": nbytes}
    return model, nbytes


def shard_tables(model, device, user_attr: str, item_attr: str) -> tuple[object, int]:
    """Both templates' ``shard_model_for_serving`` (``pio deploy
    --shard-factors``): each table's rows split over the serving mesh
    (``parallel/sharding.py``), a ``[rows/S, K]`` float32 part a device,
    and ``model._pio_shards`` (the mesh, the logical row counts) set for
    the sharded query paths. With fewer than two devices visible it logs
    the JAX package's warning and pins replicated (:func:`pin_tables`).
    Returns the model and the bytes of the padded tables."""
    from predictionio_tpu_torch.parallel import sharding

    mesh = sharding.serving_mesh(device=device)
    if mesh is None:
        logger.warning(_ONE_DEVICE)
        return pin_tables(model, device, user_attr, item_attr)
    host = (getattr(model, user_attr), getattr(model, item_attr))
    rows = {"user": int(host[0].shape[0]), "item": int(host[1].shape[0])}
    user, item = (sharding.shard_table(_host_f32(t), mesh) for t in host)
    setattr(model, user_attr, user)
    setattr(model, item_attr, item)
    # the host arrays (the model's, or those a replicated pin kept), for
    # release while no online update moved a row
    model._pio_host = host if all(isinstance(t, np.ndarray) for t in host) else getattr(model, "_pio_host", None)
    model._pio_shards = sharding.ShardInfo(mesh=mesh, rows=rows)
    model._pio_pinned = True
    nbytes = user.nbytes + item.nbytes
    model._pio_bytes_by_dtype = {"float32": nbytes}
    return model, nbytes


def release_tables(model, *attrs: str) -> None:
    """Release a model's pinned tables ``attrs`` (user, then item: the
    templates' ``release_pinned_model``): the pin-time host arrays come
    back while they are current; once an online update dropped them as
    stale, the updated tables are copied back to the host instead, so
    nothing that reads the model later sees pre-update rows. An int8
    table comes back as its dequantized host f32, and the model's
    ``QuantRuntime`` goes with it; a sharded table comes back gathered
    from every shard, its padding stripped by the logical row counts, and
    the ``ShardInfo`` goes with it, so no shard of any device stays
    referenced."""
    host = getattr(model, "_pio_host", None)
    shards = getattr(model, "_pio_shards", None)
    if host is not None:
        for attr, arr in zip(attrs, host):
            setattr(model, attr, arr)
    elif getattr(model, "_pio_pinned", False):
        for side, attr in zip(("user", "item"), attrs):
            table = getattr(model, attr)
            if isinstance(table, torch.Tensor):
                table = table.cpu().numpy()
            elif not isinstance(table, np.ndarray):
                table = np.asarray(table)  # an int8 table dequantizes, a sharded one gathers
                if shards is not None:
                    table = table[: shards.rows[side]]
            setattr(model, attr, table)
    model._pio_host = None
    model._pio_pinned = False
    model._pio_quant = None
    model._pio_shards = None
    # the generation's AOT programs go with its tables (pio deploy --aot)
    model._pio_aot = None


def _host_f32(table) -> np.ndarray:
    if isinstance(table, torch.Tensor):
        return table.detach().to(torch.float32).cpu().numpy()
    return np.asarray(table, np.float32)


def quantize_tables(model, user_attr: str, item_attr: str, device, mode: str = "int8",
                    shard: bool = False) -> tuple[object, int]:
    """Both templates' ``quantize_model_for_serving``: the two tables
    become int8 codes and per-row scales on ``device`` (quantized there,
    ``ops/quant``'s one rule). ``shard=True`` (``--shard-factors
    --quantize int8``) shards the codes and scales over the serving mesh
    instead (quantized on the host, the same codes) and sets
    ``model._pio_shards``; with fewer than two devices visible it logs the
    JAX package's warning and quantizes replicated. Sets the per-dtype
    byte ledger (``model._pio_bytes_by_dtype``) and ``model._pio_quant``
    (the ``QuantRuntime``, with the item table's quantization error) and
    returns ``(model, bytes pinned)``."""
    from predictionio_tpu_torch.ops import quant

    if mode != "int8":
        raise ValueError(f"unsupported quantize mode {mode!r} (int8)")
    user_f, item_f = _host_f32(getattr(model, user_attr)), _host_f32(getattr(model, item_attr))
    mesh = None
    if shard:
        from predictionio_tpu_torch.parallel import sharding

        mesh = sharding.serving_mesh(device=device)
        if mesh is None:
            logger.warning(_ONE_DEVICE)
    if mesh is not None:
        user, item = (sharding.shard_quantized_table(t, mesh) for t in (user_f, item_f))
        model._pio_shards = sharding.ShardInfo(mesh=mesh, rows={"user": len(user_f), "item": len(item_f)})
        # the error over the logical rows (the padding rows are exact zeros)
        item_codes, item_scales = (np.asarray(t)[: len(item_f)] for t in (item.codes, item.scales))
    else:
        user, item = quant.quantize_table(user_f, device), quant.quantize_table(item_f, device)
        item_codes, item_scales = item.codes, item.scales
    setattr(model, user_attr, user)
    setattr(model, item_attr, item)
    model._pio_host = None
    model._pio_pinned = True
    breakdown = {
        "int8": user.nbytes_codes + item.nbytes_codes,
        "scalesFloat32": user.nbytes_scales + item.nbytes_scales,
    }
    model._pio_bytes_by_dtype = breakdown
    model._pio_quant = quant.QuantRuntime(
        mode=mode,
        bytes_by_dtype=breakdown,
        bytes_f32=user_f.nbytes + item_f.nbytes,
        # the item side's error is what reorders results
        error=quant.quantization_error(item_f, item_codes, item_scales),
    )
    return model, sum(breakdown.values())


def build_ann(model, item_attr: str, ann, device, algorithm: str) -> tuple[object, dict]:
    """Both templates' ``build_ann_for_serving``: an IVF index over the
    item table on ``device`` (int8 slabs when the model serves int8),
    keeping the table itself for the full probe; attached as
    ``model._pio_ann``. Sharded tables (``model._pio_shards``): k-means
    runs on the logical item rows on the lead device, then the index is
    laid out over the mesh (:func:`~predictionio_tpu_torch.ops.ivf.shard_runtime`,
    the model's sharded table its full probe's). Returns ``(model, build
    info)``."""
    from predictionio_tpu_torch.ops import ivf

    items = getattr(model, item_attr)
    shards = getattr(model, "_pio_shards", None)
    source = items
    if shards is not None:
        # the padding rows are no items: cluster the logical catalog
        source = np.asarray(items)[: shards.rows["item"]]
        device = shards.mesh[0]
    index, info = ivf.build_ivf(
        source, nlist=ann.nlist, seed=ann.seed, iters=ann.kmeans_iters,
        quantize=getattr(model, "_pio_quant", None) is not None, device=device, table=items,
    )
    model._pio_ann = ivf.AnnRuntime(index, ann.nprobe, info)
    if shards is not None:
        info = dict(info, **ivf.shard_runtime(model._pio_ann, shards.mesh, items, shards.rows["item"]))
    return model, dict(info, algorithm=algorithm, nprobe=model._pio_ann.nprobe)


def _category_rows(model) -> dict:
    """``category -> item rows`` of a model's ``categories`` (item id ->
    tuple of categories) and ``item_index``, built once per model."""
    rows = getattr(model, "_pio_category_rows", None)
    if rows is None:
        by_cat: dict = {}
        for item, cats in model.categories.items():
            row = model.item_index.get(item)
            if row is not None:
                for c in cats:
                    by_cat.setdefault(c, []).append(row)
        rows = {c: np.asarray(r, np.int64) for c, r in by_cat.items()}
        model._pio_category_rows = rows
    return rows


def allowed_items(
    model, n: int, exclude, white_list=None, black_list=None, categories=None
) -> np.ndarray:
    """Bool ``[n]``: the items a SimilarProduct or ECommerce query may
    answer (the reference's ``_allowed_mask`` rules). ``exclude`` holds
    item rows; ``white_list``/``black_list`` item ids (unknown ids are
    ignored); ``categories`` keeps only the items that carry one of them
    in ``model.categories``."""
    allowed = np.ones(n, dtype=bool)
    allowed[np.fromiter(exclude, np.int64)] = False
    index = model.item_index
    if white_list:
        listed = np.zeros(n, dtype=bool)
        listed[[r for i in white_list if (r := index.get(i)) is not None]] = True
        allowed &= listed
    if black_list:
        allowed[[r for i in black_list if (r := index.get(i)) is not None]] = False
    if categories:
        by_cat = _category_rows(model)
        wanted = np.zeros(n, dtype=bool)
        for c in set(categories):
            rows = by_cat.get(c)
            if rows is not None:
                wanted[rows] = True
        allowed &= wanted
    return allowed


def masked_topk(algo, model, scores, allowed: np.ndarray, num: int) -> PredictedResult:
    """The SimilarProduct and ECommerce answer: the top ``min(num,
    allowed)`` of ``scores`` over the ``allowed`` items (the others at
    ``-inf``), non-finite scores dropped, under the shared tie rule —
    :func:`top_k_host` on host scores (the CPU, which ``algo`` must be
    on), :func:`top_k_scores` on a tensor."""
    k = min(int(num), int(allowed.sum()))
    if k <= 0:
        return PredictedResult(())
    if isinstance(scores, np.ndarray):
        algo.check_host_serving()
        scores = np.where(allowed, scores, -np.inf)
        top, _ = top_k_host(scores, k)
        pairs = zip(top.tolist(), scores[top].tolist())
    else:
        mask = torch.from_numpy(allowed).to(scores.device)
        idx, vals = top_k_scores(scores.masked_fill(~mask, float("-inf")), k)
        pairs = zip(idx.tolist(), vals.tolist())
    inverse = model.item_index.inverse
    return PredictedResult(tuple(ItemScore(item=inverse(i), score=s) for i, s in pairs if np.isfinite(s)))
