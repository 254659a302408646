"""Pinned serving state — the ``--pin-model``, ``--shard-factors``,
``--quantize`` and ``--ann`` tiers.

Counterpart of ``predictionio_tpu/workflow/device_state.py``
(``pin_pairs``, ``build_ann_pairs``, ``release_pairs``,
``bytes_by_dtype``, ``shard_count``). Each successful (re)load of a query server pins the
deployed models' scoring tables on the algorithm's device once per model
generation, so every request scores against resident tensors.
Algorithms opt in by implementing ``pin_model_for_serving(model) ->
(model, bytes_pinned)`` and ``release_pinned_model(model)``; any other
pair is served as it is. ``--shard-factors`` prefers the
``shard_model_for_serving(model)`` hook (row shards over the serving
mesh, ``parallel/sharding.py``); ``--quantize int8`` prefers the
``quantize_model_for_serving(model, mode, shard)`` hook above both (int8
codes and per-row scales, ``ops/quant.py``; sharded too with ``shard``);
``--ann`` asks each algorithm with a
``build_ann_for_serving(model, ann_config)`` hook for an IVF index
(``ops/ivf.py``) once per generation, and :func:`release_pairs` drops
the superseded generation's pinned tables and index together. Nothing
here imports ``ops.quant`` or ``ops.ivf`` unless a table or a deploy
asks for it.

One difference from the JAX package, which the port's rules require: a
pin, shard, quantize or index-build hook that raises is not swallowed
(the JAX package serves the pair unpinned, replicated, f32 or exact), and
a deploy asking for ``--quantize`` or ``--ann`` from an algorithm without
the hook raises. An algorithm without a shard hook pins replicated, with
a warning, as the JAX package does.
The error reaches the caller, so a deploy's first load fails loudly and a
``/reload`` leaves the service degraded on its last-good generation;
nothing falls back to the host, to f32 or to exact retrieval quietly.

The online fold-in's row swaps (``pio deploy --online``): :func:`get_rows`,
:func:`set_rows`, :func:`append_rows`, :func:`swap_side_rows` and
:func:`update_ann_items`. Host arrays update copy-on-write and swap
whole, as in the JAX package. Pinned tensors update out of place
(``index_copy`` into a new table, ``torch.cat`` for growth): a tensor that
``QueryService.snapshot_pairs`` or an in-flight query holds never
changes under it, as with JAX's ``.at[].set``. An int8 table re-quantizes
only the rows touched or added (the host quantizer, bit-equal to the
card's). A sharded table routes each touched row to its owner shard;
cold-start rows fill its padding first and re-lay it out past that
(:func:`swap_side_rows`).

The ``--aot`` tier (:func:`pin_pairs` with ``aot=``): after the pin, the
generation's compiled serving programs are loaded and attached as
``model._pio_aot`` (``workflow/aot.py``), with the load's tier report on
``model._pio_aot_report`` (:func:`aot_stats`, ``/stats.json`` ``aot``).
A load that fails is the JAX package's loud fallback to the eager path on
the same device, never a quiet move off it.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np

__all__ = [
    "aot_stats",
    "append_rows",
    "build_ann_pairs",
    "bytes_by_dtype",
    "get_rows",
    "pin_pairs",
    "release_pairs",
    "set_rows",
    "shard_count",
    "swap_side_rows",
    "update_ann_items",
]

logger = logging.getLogger(__name__)


def pin_pairs(
    pairs: Sequence, shard: bool = False, quantize: str | None = None, prepared: bool = True,
    aot=None, instance_id: str | None = None,
) -> tuple[list, int]:
    """Pin every (algorithm, model) pair whose algorithm has the hook.

    ``shard`` (``pio deploy --shard-factors``) takes the
    ``shard_model_for_serving`` hook (row shards over the serving mesh;
    the hook pins replicated, with the JAX package's warning, when fewer
    than two devices are visible); an algorithm without it pins
    replicated, with a warning. ``quantize`` (``pio deploy --quantize
    int8``) takes the ``quantize_model_for_serving(model, mode, shard)``
    hook above both; an algorithm without it raises (the module
    docstring). ``prepared=False``: the models come as the blob holds
    them (``Engine.prepare_deploy(prepare=False)``), so a shard or
    quantize hook builds its tables from the host arrays, with no
    replicated f32 copy on the card first, and the algorithm's
    ``warm_up`` runs after it; a pair no such hook takes goes through
    ``prepare_model_for_serving`` first. Returns ``(pairs,
    bytes_pinned)`` — the pair list with the pinned models and the bytes
    of every table they now hold on their devices. A hook that raises
    propagates.

    ``aot`` (an enabled :class:`~predictionio_tpu_torch.workflow.aot.AotConfig`,
    ``pio deploy --aot``) then loads instance ``instance_id``'s artifact
    set from ``aot.root`` onto the pinned models' device
    (:func:`_attach_aot`)."""
    out = []
    total = 0
    for algo, model in pairs:
        pin = getattr(algo, "pin_model_for_serving", None)
        tier = None  # the shard or quantize hook, when one takes the pair
        if shard:
            tier = getattr(algo, "shard_model_for_serving", None)
            if tier is None:
                logger.warning(
                    "--shard-factors: %s has no shard_model_for_serving hook; pinning replicated",
                    type(algo).__name__,
                )
        if quantize is not None:
            qhook = getattr(algo, "quantize_model_for_serving", None)
            if qhook is None:
                raise NotImplementedError(
                    f"--quantize {quantize}: {type(algo).__name__} has no quantize_model_for_serving hook"
                )

            def tier(m, _q=qhook):
                return _q(m, mode=quantize, shard=shard)

        if tier is not None:
            model, nbytes = tier(model)
            total += int(nbytes)
            warm_up = getattr(algo, "warm_up", None)
            if not prepared and warm_up is not None:
                warm_up(model)
        else:
            if not prepared:
                model = algo.prepare_model_for_serving(model)
            if pin is not None:
                model, nbytes = pin(model)
                total += int(nbytes)
        out.append((algo, model))
    if aot is not None and aot.active:
        _attach_aot(out, aot, instance_id)
    return out, total


def _attach_aot(pairs: list, aot, instance_id: str | None) -> None:
    """Load the generation's artifact set once and attach the runtime and
    its tier report to every pinned model; a failed load is reported
    (``workflow/aot.py``'s loud fallback) and the models serve eagerly.
    Then each algorithm's ``aot_warm_serving`` hook runs one query through
    the programs."""
    from predictionio_tpu_torch.workflow import aot as aot_mod

    pinned = [(algo, model) for algo, model in pairs if getattr(model, "_pio_pinned", False)]
    if not pinned:
        return
    if not instance_id or not aot.root:
        logger.warning("--aot requested but no engine instance id or artifact root is known; serving eagerly")
        return
    device = getattr(pinned[0][0], "device", None)
    runtime, report = aot_mod.load_runtime(instance_id, aot.root, device=device)
    for algo, model in pinned:
        model._pio_aot = runtime
        model._pio_aot_report = report
        warm = getattr(algo, "aot_warm_serving", None)
        if warm is not None and runtime is not None:
            warm(model)


def aot_stats(pairs: Sequence) -> dict | None:
    """The ``aot`` block of ``/stats.json``: the load's tier report joined
    with the live runtime's counters (hits, misses, disabled), or
    ``None`` when no served model carries AOT state."""
    report = runtime = None
    for _, model in pairs:
        if report is None:
            report = getattr(model, "_pio_aot_report", None)
        if runtime is None:
            runtime = getattr(model, "_pio_aot", None)
    if report is None and runtime is None:
        return None
    out = dict(report or {})
    if runtime is not None:
        out.update(runtime.stats())
    return out


def build_ann_pairs(pairs: Sequence, ann_config) -> tuple[list, list]:
    """Build the IVF retrieval state of every pair whose algorithm has a
    ``build_ann_for_serving`` hook. Returns ``(pairs, infos)`` — one build
    info dict per built index (``/stats.json`` ``ann``). A build that
    raises propagates, and a deploy whose algorithms have no hook at all
    raises: ``--ann`` never serves exact retrieval quietly."""
    out = []
    infos = []
    for algo, model in pairs:
        build = getattr(algo, "build_ann_for_serving", None)
        if build is not None:
            model, info = build(model, ann_config)
            infos.append(info)
            logger.info(
                "Built IVF retrieval index for %s: nlist=%s nprobe=%s slabWidth=%s build=%ss",
                type(algo).__name__, info.get("nlist"), info.get("nprobe"),
                info.get("slabWidth"), info.get("buildSeconds"),
            )
        out.append((algo, model))
    if pairs and not infos:
        names = sorted({type(algo).__name__ for algo, _ in pairs})
        raise NotImplementedError(f"--ann: no algorithm of this engine has a build_ann_for_serving hook ({names})")
    return out, infos


def bytes_by_dtype(pairs: Sequence) -> dict:
    """Per-dtype ledger of the pinned tables across the served models —
    ``cache.bytesByDtype`` on ``/stats.json``. Each pin hook records its
    own breakdown on ``model._pio_bytes_by_dtype`` from the tensors it
    placed."""
    agg: dict = {}
    for _, model in pairs:
        for dtype, nbytes in (getattr(model, "_pio_bytes_by_dtype", None) or {}).items():
            agg[dtype] = agg.get(dtype, 0) + int(nbytes)
    return agg


def shard_count(pairs: Sequence) -> int:
    """The serving mesh's size across the served models (0 when nothing is
    sharded) — ``cache.factorShards`` on ``/stats.json``."""
    n = 0
    for _, model in pairs:
        shards = getattr(model, "_pio_shards", None)
        if shards is not None:
            n = max(n, shards.num_shards)
    return n


def _sharding(mat):
    """``parallel.sharding`` when ``mat`` is a sharded table, else None —
    without importing it for the other tiers."""
    if type(mat).__name__ != "ShardedTable":
        return None
    from predictionio_tpu_torch.parallel import sharding

    return sharding


def get_rows(mat, idx) -> np.ndarray:
    """Rows ``idx`` of a factor table as host float32: a numpy fancy
    index, or one gather on the tensor's device and a ``len(idx)``-row
    copy — never the whole table. An int8 table dequantizes only those
    rows; a sharded table gathers them from their owner shards."""
    idx = np.asarray(idx, np.int64)
    if isinstance(mat, np.ndarray):
        return np.asarray(mat[idx], np.float32)
    import torch

    sharding = _sharding(mat)
    if sharding is not None:
        return sharding.gather_rows(idx, mat).to(torch.float32).cpu().numpy()
    if getattr(mat, "is_quantized", False):
        rows = mat[idx]
        return rows.cpu().numpy() if isinstance(rows, torch.Tensor) else np.asarray(rows, np.float32)
    return mat.index_select(0, torch.from_numpy(idx).to(mat.device)).to(torch.float32).cpu().numpy()


def _quantized_parts(rows):
    """An int8 table's touched rows, quantized on the host (``ops/quant``'s
    one rule; the card's quantizer writes the same codes)."""
    from predictionio_tpu_torch.ops import quant

    return quant.quantize_table_host(np.asarray(rows, np.float32))


def set_rows(mat, idx, rows):
    """Replace factor rows ``idx`` of ``mat`` with ``rows`` — the online
    fold-in's delta swap. A host array updates copy-on-write; a tensor
    out of place (``index_copy``), so only the touched rows cross to the
    device and every holder of the old table keeps it intact; a sharded
    table does that on each touched row's owner shard only. An int8
    table re-quantizes only the touched rows, then swaps its codes and
    scales through this same function."""
    if getattr(mat, "is_quantized", False):
        codes, scales = _quantized_parts(rows)
        return type(mat)(set_rows(mat.codes, idx, codes), set_rows(mat.scales, idx, scales))
    if isinstance(mat, np.ndarray):
        out = mat.copy()
        out[np.asarray(idx, np.int64)] = np.asarray(rows, mat.dtype)
        return out
    sharding = _sharding(mat)
    if sharding is not None:
        return sharding.set_rows(mat, idx, rows)
    import torch

    index = torch.as_tensor(np.asarray(idx, np.int64)).to(mat.device)
    src = torch.as_tensor(np.asarray(rows)).to(device=mat.device, dtype=mat.dtype)
    return mat.index_copy(0, index, src)


def append_rows(mat, rows):
    """Grow a factor table by cold-start rows (fold-in injection for
    never-seen entities); a new table on the same device. An int8 table
    quantizes only the new rows and grows its codes and scales in step.
    (A sharded table grows in :func:`swap_side_rows`.)"""
    if getattr(mat, "is_quantized", False):
        codes, scales = _quantized_parts(rows)
        return type(mat)(append_rows(mat.codes, codes), append_rows(mat.scales, scales))
    if isinstance(mat, np.ndarray):
        return np.concatenate([mat, np.asarray(rows, mat.dtype)], axis=0)
    import torch

    src = torch.as_tensor(np.asarray(rows)).to(device=mat.device, dtype=mat.dtype)
    return torch.cat([mat, src], dim=0)


def swap_side_rows(
    model, ids, rows, factors_attr: str, index_attr: str, rows_before_index: bool
) -> tuple[int, int]:
    """Swap one side's online-update rows into a live model: split
    ``ids`` into known (:func:`set_rows`) and new (cold start:
    :func:`append_rows` + ``BiMap.extended``), mutating the model's
    attributes by whole-object assignment only. The ordering contract
    both templates rely on (the JAX package's):

    ``rows_before_index=True`` (user side) — a racing query resolving a
    fresh user must find its row already present; until the index
    lands, the user reads as unknown.

    ``rows_before_index=False`` (item side) — scoring runs over the
    factor table, so a new row must not become rankable before the index
    can translate it back to an item id.

    Sharded (``model._pio_shards``), the tables are padded to an even
    split: new rows first fill padding slots on their owner shards
    (:func:`set_rows`); past the padding the table is laid out anew with
    ``GROW_STEP`` rows of headroom. The logical row count on the
    ``ShardInfo``, by which every sharded kernel masks, advances only
    after the rows landed, so a slot becomes rankable with its row.

    Returns ``(rows updated, rows added)``."""
    index = getattr(model, index_attr)
    known = [(j, idx) for j, e in enumerate(ids) if (idx := index.get(e)) is not None]
    new = [j for j, e in enumerate(ids) if index.get(e) is None]
    rows = np.asarray(rows, np.float32)
    if known:
        setattr(
            model,
            factors_attr,
            set_rows(getattr(model, factors_attr), [idx for _, idx in known], rows[[j for j, _ in known]]),
        )
    if new:
        new_ids = [ids[j] for j in new]
        shards = getattr(model, "_pio_shards", None)
        side = "user" if rows_before_index else "item"

        def grow(mat):
            if shards is None:
                return append_rows(mat, rows[new])
            from predictionio_tpu_torch.parallel import sharding

            logical = int(shards.rows[side])
            if logical + len(new) <= int(mat.shape[0]):
                # padding slots on their owner shards; no re-layout
                return set_rows(mat, list(range(logical, logical + len(new))), rows[new])
            return sharding.relayout(mat, logical, rows[new], logical + len(new) + sharding.GROW_STEP)

        def advance():
            if shards is not None:
                shards.rows[side] = int(shards.rows[side]) + len(new)

        if rows_before_index:
            setattr(model, factors_attr, grow(getattr(model, factors_attr)))
            advance()
            setattr(model, index_attr, index.extended(new_ids))
        else:
            setattr(model, index_attr, index.extended(new_ids))
            setattr(model, factors_attr, grow(getattr(model, factors_attr)))
            advance()
    return len(known), len(new)


def update_ann_items(model, item_ids, rows, index_attr: str = "item_index", factors_attr: str = "item_factors"):
    """Fold changed/new item rows into the model's IVF index (when one is
    built), after :func:`swap_side_rows` swapped them into the table: the
    index keeps the model's new table for its full probe. Returns the
    update info dict, or ``None`` without an index."""
    ann = getattr(model, "_pio_ann", None)
    if ann is None:
        return None
    index = getattr(model, index_attr)
    all_idx = np.asarray([index[i] for i in item_ids], np.int64)
    return ann.update_items(
        all_idx, np.asarray(rows, np.float32), total_items=len(index), table=getattr(model, factors_attr)
    )


def release_pairs(pairs: Sequence) -> None:
    """Drop a superseded generation's pinned tables and IVF index so their
    device memory is freed at once (a hot-reloading server must not hold
    one catalog, or one index, per reload). The query server calls it on
    its device thread, where no query of the old generation can still be
    running."""
    for algo, model in pairs:
        for name in ("release_pinned_model", "release_ann_state"):
            release = getattr(algo, name, None)
            if release is None:
                continue
            try:
                release(model)
            except Exception:
                logger.exception("%s failed for %s", name, type(algo).__name__)
