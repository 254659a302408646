"""IVF (inverted-file) approximate top-K retrieval on the card.

Counterpart of ``predictionio_tpu/ops/ivf.py``. Per-query cost scales
with ``nprobe * (catalog / nlist)`` instead of the catalog:

* **Build** (:func:`build_ivf`, once per model generation) — k-means on
  the item factors: k-means++ seeding on a bounded subsample, Lloyd
  iterations with a chunked assignment, the final assignment, the
  balancing cap (host numpy, the JAX package's code), then the
  cluster-major layout: one ``[nlist, W, K]`` slab tensor (zero-padded)
  and a ``[nlist, W]`` map back to item ids (padding carries the
  ``num_items`` sentinel). With ``quantize=True`` the slabs hold
  :mod:`~predictionio_tpu_torch.ops.quant` int8 codes and per-lane
  scales.
* **Query** (:func:`ivf_topk_batch` / :func:`ivf_topk_users`) — score
  the centroids, take the ``nprobe`` best clusters, score only their
  slabs, merge a global top-K through the id map with
  :func:`~predictionio_tpu_torch.ops.topk.top_k_permuted` (tie-stable in
  item id). Padding lanes score 0, which could outrank real negative
  scores, so they are masked by id, never by value.
* **Full probe** (``nprobe >= nlist``; larger values clamp to it) is
  exact retrieval, to the bit: the index keeps the model's id-ordered
  item table (``IVFIndex.items``; the pinned table itself, so nothing is
  doubled) and scores it through the exact path's own function —
  :func:`~predictionio_tpu_torch.ops.als.top_k_items_batch` on tensors,
  the numpy GEMM and ``top_k_host`` on a host table — so ids and scores
  equal the exact batch top-K of the same rows at the same batch shape.
  The JAX package scores its cluster-major slabs there and misses the
  exact scores by an ulp. In int8 mode the full probe is ``(q @
  codes.T) * scales`` over the table's id-ordered codes: per-row
  quantization gives a slab lane the codes and scale of its row.

Randomness: every draw of a build (the seeding subsample, the first
centroid, one uniform per further centroid) comes from one
``torch.Generator`` seeded with ``seed`` on the CPU, so a build is
deterministic per seed on any device; the device turns each uniform into
a D²-weighted pick by an inverse CDF. ``jax.random`` cannot be replayed,
so the port's index differs from the JAX package's for the same seed;
given the same initial centroids (:func:`seed_centroids`), Lloyd, the
assignment, balancing and the layout are the JAX package's. The
Lloyd mean update sums with one-hot products over fixed chunks, in a
fixed order (``index_add_`` on CUDA sums floats in no fixed order);
``argmin`` ties go to the lower centroid.

Incremental maintenance (:func:`update_ivf`, :meth:`AnnRuntime.update_items`)
is the JAX package's host numpy mirror: nearest-centroid placement, spill
to the nearest cluster with room, tombstones, capacity grown in
:data:`_CAPACITY_STEP` steps, touched int8 lanes re-quantized.

Sharded (``pio deploy --shard-factors --ann``, :func:`shard_runtime`):
the slabs, slab ids and lane scales shard over the serving mesh by
cluster, the centroids stay on the lead device, and the full probe scores
the model's row-sharded item table; queries take
:func:`~predictionio_tpu_torch.parallel.sharding.sharded_ivf_topk`. An
online update folds into the unsharded layout, kept on the host, and
shards the result anew.
"""

from __future__ import annotations

import threading
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops import quant
from predictionio_tpu_torch.ops.als import score_rows, top_k_items_batch
from predictionio_tpu_torch.ops.topk import bucket_k, top_k_host, top_k_permuted, top_k_scores

__all__ = [
    "IVFIndex",
    "AnnRuntime",
    "build_ivf",
    "update_ivf",
    "ivf_topk_batch",
    "ivf_topk_users",
    "query_topk",
    "auto_nlist",
    "trim_row",
    "shard_runtime",
]

#: id-capacity rounding for incrementally grown indexes (the JAX
#: package's value: there it bounds retraces, here it keeps the sentinel
#: and the mask bound the same as the reference's)
_CAPACITY_STEP = 1024

#: rows per chunk of the Lloyd assignment and mean update: bounds the
#: transient [chunk, nlist] blocks
_ASSIGN_CHUNK = 16_384

#: k-means++ seeds on at most max(4096, 16 * nlist) subsampled rows
_SEED_SAMPLE_PER_LIST = 16
_SEED_SAMPLE_MIN = 4096

class IVFIndex(NamedTuple):
    """Cluster-major retrieval state. ``slab_scales is None`` is the f32
    layout; with ``--quantize int8`` ``slabs`` holds int8 codes and
    ``slab_scales`` the per-lane scales. ``items`` is the id-ordered item
    table the full probe scores (a tensor, a
    :class:`~predictionio_tpu_torch.ops.quant.QuantizedTable` or a host
    numpy array); it is not counted in the index's bytes. A sharded index
    (:func:`shard_runtime`) holds :class:`~predictionio_tpu_torch.parallel.sharding.ShardedTable` tables,
    and ``item_rows`` is its item table's logical row count."""

    centroids: Any  # [nlist, K] f32 (always f32: stage 1 stays exact)
    slabs: Any  # [nlist, W, K] f32 (or int8 codes), zero-padded
    slab_ids: Any  # [nlist, W] int32 item id per lane; padding = num_items
    num_items: int
    nlist: int
    slab_width: int
    slab_scales: Any = None  # [nlist, W] f32 per-lane scales (int8 mode)
    items: Any = None  # [num real items, K] id-ordered table
    item_rows: int = 0  # logical rows of a sharded ``items`` (padding beyond)

    @property
    def device(self) -> torch.device:
        return self.centroids.device


def auto_nlist(num_items: int) -> int:
    """Default cluster count: ~sqrt(catalog), the standard IVF sizing
    rule."""
    return max(1, int(round(float(num_items) ** 0.5)))


def _host_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).cpu().numpy()
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# Build: k-means++ seeding + Lloyd iterations
# ---------------------------------------------------------------------------


def _assign(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """argmin_c ||x - c||^2 per row, one [chunk, nlist] block at a time;
    ||x||^2 is row-constant, so the keys are c.c - 2 x.c. Ties go to the
    lower centroid."""
    c2 = (cents * cents).sum(dim=-1)
    out = [
        torch.argmin(c2[None, :] - 2.0 * (x[lo : lo + _ASSIGN_CHUNK] @ cents.T), dim=1)
        for lo in range(0, x.shape[0], _ASSIGN_CHUNK)
    ]
    return torch.cat(out)


def _kmeans_pp(x: torch.Tensor, nlist: int, first: int, uniforms: torch.Tensor) -> torch.Tensor:
    """k-means++ seeding: centroid 0 is row ``first``; centroid i is the
    row where ``uniforms[i-1] * sum(d2)`` falls in the running sum of the
    squared distances to the nearest centroid so far (a D²-weighted pick
    by inverse CDF). Rows already covered (d2 == 0) have no width and are
    never picked; if every row is covered the pick is uniform."""
    n = x.shape[0]
    cents = x.new_zeros((nlist, x.shape[1]))
    cents[0] = x[first]
    d2 = ((x - x[first]) ** 2).sum(dim=-1)
    for i in range(1, nlist):
        u = uniforms[i - 1]
        cdf = torch.cumsum(d2, dim=0)
        total = cdf[-1]
        pick = torch.searchsorted(cdf, (u * total).reshape(1), right=True)
        uniform = (u * n).to(torch.int64).reshape(1)
        pick = torch.where(total > 0, pick, uniform).clamp(max=n - 1)
        c = x.index_select(0, pick)  # [1, K]
        cents[i] = c[0]
        d2 = torch.minimum(d2, ((x - c) ** 2).sum(dim=-1))
    return cents


def _lloyd(x: torch.Tensor, cents: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` Lloyd iterations: assignment, then the mean update with
    sums in a fixed order (one-hot products over fixed chunks). Empty
    clusters keep their old centroid."""
    nlist = cents.shape[0]
    for _ in range(iters):
        a = _assign(x, cents)
        sums = torch.zeros_like(cents)
        for lo in range(0, x.shape[0], _ASSIGN_CHUNK):
            onehot = torch.nn.functional.one_hot(a[lo : lo + _ASSIGN_CHUNK], nlist).to(x.dtype)
            sums = sums + onehot.T @ x[lo : lo + _ASSIGN_CHUNK]
        counts = torch.bincount(a, minlength=nlist).to(x.dtype)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        cents = torch.where(counts[:, None] > 0, new, cents)
    return cents


def _balance_assignment(
    x: np.ndarray, cents: np.ndarray, assign: np.ndarray, nlist: int, cap: int
) -> np.ndarray:
    """Cap every cluster at ``cap`` items: overloaded clusters keep their
    ``cap`` closest members and spill the rest, in spill order, to the
    nearest cluster with room (the JAX package's code). ``nlist * cap >=
    items``, so placement always succeeds."""
    counts = np.bincount(assign, minlength=nlist)
    if counts.max() <= cap:
        return assign
    own = cents[assign]
    d_own = ((x - own) ** 2).sum(axis=1)
    spilled: list = []
    for c in np.nonzero(counts > cap)[0]:
        members = np.nonzero(assign == c)[0]
        keep = members[np.argsort(d_own[members], kind="stable")]
        spilled.extend(keep[cap:].tolist())
    counts = np.minimum(counts, cap)
    spill = np.asarray(spilled)
    c2 = (cents * cents).sum(axis=1)
    for lo in range(0, spill.size, 65_536):
        part = spill[lo : lo + 65_536]
        keys = c2[None, :] - 2.0 * (x[part] @ cents.T)
        prefs = np.argsort(keys, axis=1, kind="stable")
        for item, pref in zip(part, prefs):
            for c in pref:
                if counts[c] < cap:
                    assign[item] = c
                    counts[c] += 1
                    break
    return assign


def seed_centroids(x: torch.Tensor, nlist: int, seed: int) -> torch.Tensor:
    """The build's initial centroids: the mean for one list, else
    k-means++ on a seeded subsample. All draws come from one CPU
    ``torch.Generator`` (the module docstring)."""
    num_items = x.shape[0]
    if nlist == 1:
        return x.mean(dim=0, keepdim=True)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    n_seed = min(num_items, max(_SEED_SAMPLE_MIN, _SEED_SAMPLE_PER_LIST * nlist))
    sample = x
    if n_seed < num_items:
        rows = torch.randperm(num_items, generator=gen)[:n_seed]
        sample = x.index_select(0, rows.to(x.device))
    first = int(torch.randint(n_seed, (1,), generator=gen))
    uniforms = torch.rand(nlist - 1, generator=gen, dtype=torch.float32).to(x.device)
    return _kmeans_pp(sample, nlist, first, uniforms)


def build_ivf(
    item_factors,
    nlist: int = 0,
    seed: int = 0,
    iters: int = 8,
    balance: float = 1.3,
    quantize: bool = False,
    *,
    device: str | torch.device | None = None,
    table=None,
) -> tuple[IVFIndex, dict]:
    """Partition ``item_factors [I, K]`` (numpy, a tensor or a
    ``QuantizedTable``, read as f32) into ``nlist`` clusters on
    ``device`` (default: the card) and lay them out cluster-major.
    ``nlist <= 0`` picks :func:`auto_nlist`. ``balance`` caps every
    cluster at ``ceil(items / nlist * balance)`` members (``<= 0`` keeps
    the raw assignment). ``table`` is the id-ordered table the full
    probe scores — the model's pinned table; by default the factors are
    placed on ``device`` (quantized with ``quantize``). Returns ``(index,
    build_info)`` (``/stats.json`` ``ann``)."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    x = _host_f32(item_factors)
    if x.ndim != 2:
        raise ValueError(f"item_factors must be [I, K], got {x.shape}")
    num_items, dim = x.shape
    if num_items == 0:
        raise ValueError("cannot build an IVF index over an empty catalog")
    nlist = int(nlist) if nlist > 0 else auto_nlist(num_items)
    nlist = max(1, min(nlist, num_items))
    xd = torch.as_tensor(x, device=dev)
    cents = seed_centroids(xd, nlist, seed)
    if nlist > 1:
        cents = _lloyd(xd, cents, max(0, int(iters)))
    assign = _assign(xd, cents).cpu().numpy()
    cents_np = cents.cpu().numpy()
    if balance and balance > 0:
        cap = max(1, int(np.ceil(num_items / nlist * balance)))
        assign = _balance_assignment(x, cents_np, assign, nlist, cap)

    counts = np.bincount(assign, minlength=nlist)
    slab_width = int(max(1, counts.max()))
    # cluster-major reorder; the stable sort keeps ascending ids within
    # each cluster, so the layout is deterministic
    order = np.argsort(assign, kind="stable")
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    lane = np.arange(num_items) - np.repeat(starts, counts)
    slab_ids = np.full((nlist, slab_width), num_items, dtype=np.int32)
    slab_ids[assign[order], lane] = order.astype(np.int32)
    slabs = np.zeros((nlist, slab_width, dim), dtype=np.float32)
    slabs[assign[order], lane] = x[order]
    scale_arr = None
    if quantize:
        # k-means and the layout ran on the f32 values; only the served
        # slabs quantize (per lane, ops/quant's one rule)
        codes, lane_scales = quant.quantize_slabs(slabs)
        slabs = codes
        scale_arr = torch.as_tensor(lane_scales, device=dev)
    if table is None:
        table = quant.quantize_table(x, dev) if quantize else xd
    index = IVFIndex(
        centroids=cents,
        slabs=torch.as_tensor(slabs, device=dev),
        slab_ids=torch.as_tensor(slab_ids, device=dev),
        num_items=num_items,
        nlist=nlist,
        slab_width=slab_width,
        slab_scales=scale_arr,
        items=table,
    )
    info = {
        "nlist": nlist,
        "slabWidth": slab_width,
        "catalogItems": num_items,
        # fraction of slab lanes holding real items
        "fill": round(num_items / float(nlist * slab_width), 4),
        "emptyClusters": int((counts == 0).sum()),
        "balance": float(balance),
        "kmeansIters": int(iters),
        "seed": int(seed),
        "quantized": bool(quantize),
        "bytesIndex": _index_bytes(index),
        "buildSeconds": round(time.perf_counter() - t0, 3),
    }
    return index, info


def _index_bytes(index: IVFIndex) -> int:
    """Served bytes of the index tensors (int8 slabs 1 byte an element,
    their scales 4); the id-ordered table is the model's and not
    counted."""
    parts = [index.centroids, index.slabs, index.slab_ids, index.slab_scales]
    return sum(t.numel() * t.element_size() for t in parts if t is not None)


# ---------------------------------------------------------------------------
# Incremental update: fold-in without a k-means rebuild
# ---------------------------------------------------------------------------


def _host_mirror(index: IVFIndex) -> dict:
    """Mutable host-side view of an index for incremental maintenance:
    numpy slab copies (int8 codes and per-lane scales when quantized),
    per-cluster fill counts and an item -> slab-slot map. Built once per
    index generation, reused across folds."""
    slabs = index.slabs.cpu().numpy().copy()
    slab_ids = index.slab_ids.cpu().numpy().astype(np.int32)
    cents = index.centroids.cpu().numpy().astype(np.float32)
    sentinel = index.num_items
    pos = np.full(sentinel, -1, np.int64)
    cl, lane = np.nonzero(slab_ids != sentinel)
    pos[slab_ids[cl, lane]] = cl * index.slab_width + lane
    return {
        "slabs": slabs,
        "slab_ids": slab_ids,
        "scales": (
            index.slab_scales.cpu().numpy().astype(np.float32).copy()
            if index.slab_scales is not None
            else None
        ),
        "centroids": cents,
        "c2": (cents * cents).sum(axis=1),
        "fill": (slab_ids != sentinel).sum(axis=1).astype(np.int64),
        "pos": pos,
        "capacity": sentinel,
    }


def _grow_width(state: dict, extra: int) -> None:
    nlist, width, dim = state["slabs"].shape
    pad = max(1, extra, width // 4)
    slabs = np.zeros((nlist, width + pad, dim), state["slabs"].dtype)
    slabs[:, :width] = state["slabs"]
    ids = np.full((nlist, width + pad), state["capacity"], np.int32)
    ids[:, :width] = state["slab_ids"]
    if state.get("scales") is not None:
        scales = np.zeros((nlist, width + pad), np.float32)
        scales[:, :width] = state["scales"]
        state["scales"] = scales
    # re-derive positions: lane arithmetic changed with the width
    pos = np.full(state["capacity"], -1, np.int64)
    cl, lane = np.nonzero(ids != state["capacity"])
    pos[ids[cl, lane]] = cl * (width + pad) + lane
    state["slabs"] = slabs
    state["slab_ids"] = ids
    state["pos"] = pos


def _with_rows(mat, ids: np.ndarray, rows: np.ndarray, total: int):
    """``mat`` grown to ``total`` rows with rows ``ids`` replaced — a new
    array or tensor; the old one stays intact for whoever holds it."""
    if isinstance(mat, np.ndarray):
        out = np.zeros((max(total, mat.shape[0]),) + mat.shape[1:], mat.dtype)
        out[: mat.shape[0]] = mat
        out[ids] = rows
        return out
    grow = total - mat.shape[0]
    if grow > 0:
        mat = torch.cat([mat, mat.new_zeros((grow,) + tuple(mat.shape[1:]))])
    src = torch.as_tensor(np.asarray(rows)).to(device=mat.device, dtype=mat.dtype)
    return mat.index_copy(0, torch.as_tensor(ids, device=mat.device), src)


def _table_with_rows(table, ids: np.ndarray, vectors: np.ndarray, total: int):
    """The id-ordered table with the folded rows (re-quantized when the
    table is int8)."""
    if getattr(table, "is_quantized", False):
        codes, scales = quant.quantize_table_host(vectors)
        return quant.QuantizedTable(
            _with_rows(table.codes, ids, codes, total), _with_rows(table.scales, ids, scales, total)
        )
    return _with_rows(table, ids, vectors, total)


def update_ivf(
    index: IVFIndex,
    item_ids: np.ndarray,
    vectors: np.ndarray,
    total_items: int,
    state: dict | None = None,
    table=None,
) -> tuple[IVFIndex, dict, dict]:
    """Fold changed/new item vectors into an existing index without a
    k-means rebuild (the JAX package's algorithm, on its host mirror):
    each vector goes to its nearest existing centroid's slab, spilling to
    the nearest cluster with room, growing the slab width as a last
    resort. An item whose nearest centroid is unchanged updates in
    place; one that moved is tombstoned out of its old slab (sentinel id,
    zero lane) and re-inserted; a new item (``id >= capacity``) grows the
    id capacity in :data:`_CAPACITY_STEP` steps.

    ``state`` is the reusable host mirror of a previous call; ``table``
    the id-ordered table after the fold (the model's; by default the
    index's own table with the folded rows). Returns ``(new index,
    state, info)``."""
    if state is None:
        state = _host_mirror(index)
    item_ids = np.asarray(item_ids, np.int64)
    vectors = np.ascontiguousarray(np.asarray(vectors, np.float32))
    old_capacity = state["capacity"]
    capacity = old_capacity
    if total_items > capacity:
        capacity = -(-total_items // _CAPACITY_STEP) * _CAPACITY_STEP
        # rewrite the sentinel: an id equal to the OLD capacity is real now
        pad_mask = state["slab_ids"] == old_capacity
        state["slab_ids"][pad_mask] = capacity
        pos = np.full(capacity, -1, np.int64)
        pos[: state["pos"].size] = state["pos"]
        state["pos"] = pos
        state["capacity"] = capacity
    slabs = state["slabs"]
    ids = state["slab_ids"]
    fill = state["fill"]
    pos = state["pos"]
    scales = state.get("scales")
    width = slabs.shape[1]
    if scales is not None:
        # int8 slabs: only the touched lanes re-quantize
        lane_vals, lane_scales = quant.quantize_table_host(vectors)
    else:
        lane_vals, lane_scales = vectors, None

    def write_lane(cl, lane, j):
        slabs[cl, lane] = lane_vals[j]
        if scales is not None:
            scales[cl, lane] = lane_scales[j]

    keys = state["c2"][None, :] - 2.0 * (vectors @ state["centroids"].T)
    prefs = np.argsort(keys, axis=1, kind="stable")
    moved = inserted = in_place = spilled = 0
    for j, (iid, pref) in enumerate(zip(item_ids.tolist(), prefs)):
        cur = pos[iid]
        target = int(pref[0])
        if cur >= 0:
            cl, lane = divmod(int(cur), width)
            if cl == target:
                write_lane(cl, lane, j)
                in_place += 1
                continue
            ids[cl, lane] = capacity  # tombstone out of the old slab
            slabs[cl, lane] = 0
            if scales is not None:
                scales[cl, lane] = 0.0
            fill[cl] -= 1
            pos[iid] = -1
            moved += 1
        else:
            inserted += 1
        placed = False
        for rank_i, c in enumerate(pref.tolist()):
            if fill[c] >= width:
                continue
            lane = int(np.argmax(ids[c] == capacity))
            ids[c, lane] = iid
            write_lane(c, lane, j)
            fill[c] += 1
            pos[iid] = c * width + lane
            spilled += int(rank_i > 0)
            placed = True
            break
        if not placed:  # every slab full: widen, then place
            _grow_width(state, 1)
            slabs = state["slabs"]
            ids = state["slab_ids"]
            pos = state["pos"]
            scales = state.get("scales")
            width = slabs.shape[1]
            lane = int(np.argmax(ids[target] == capacity))
            ids[target, lane] = iid
            write_lane(target, lane, j)
            fill[target] += 1
            pos[iid] = target * width + lane
    if table is None and index.items is not None:
        table = _table_with_rows(index.items, item_ids, vectors, total_items)
    dev = index.device
    new_index = IVFIndex(
        centroids=index.centroids,
        # copies: `state` mutates these arrays on the next update while
        # in-flight queries may still score this index
        slabs=torch.tensor(slabs, device=dev),
        slab_ids=torch.tensor(ids, device=dev),
        num_items=capacity,
        nlist=index.nlist,
        slab_width=width,
        slab_scales=torch.tensor(scales, device=dev) if scales is not None else None,
        items=table,
    )
    info = {
        "inPlace": in_place,
        "moved": moved,
        "inserted": inserted,
        "spilled": spilled,
        "capacity": capacity,
        "slabWidth": width,
    }
    return new_index, state, info


def _shard_index(index: IVFIndex, mesh, items=None, item_rows: int = 0) -> IVFIndex:
    """An index laid out over the serving mesh: ``nlist`` padded to a
    multiple of the mesh (zero slabs, sentinel ids, masked by id), the
    slabs, slab ids and lane scales sharded cluster-major, the centroids
    (``[nlist, K]``, stage 1 runs on the lead) on the lead device, and
    the id-ordered item table row-sharded: ``items`` (the model's sharded
    table) when given, else the index's own table's rows as they are."""
    from predictionio_tpu_torch.parallel import sharding

    if items is None:
        items = index.items
        item_rows = item_rows or (int(items.shape[0]) if items is not None else 0)
        if items is not None and not sharding.is_sharded(items):
            items = sharding.shard_rows(items, mesh)
    nlist_pad = sharding.padded_rows(index.nlist, len(mesh))
    ids = index.slab_ids
    if nlist_pad > index.nlist:
        # padded clusters: sentinel ids (their zero lanes are masked by id)
        pad = torch.full((nlist_pad - index.nlist, index.slab_width), index.num_items, dtype=ids.dtype,
                         device=ids.device)
        ids = torch.cat([ids, pad])
    return IVFIndex(
        centroids=index.centroids.to(mesh[0]),
        slabs=sharding.shard_rows(index.slabs, mesh, nlist_pad),
        slab_ids=sharding.shard_rows(ids, mesh),
        num_items=index.num_items,
        nlist=index.nlist,
        slab_width=index.slab_width,
        slab_scales=None if index.slab_scales is None else sharding.shard_rows(index.slab_scales, mesh, nlist_pad),
        items=items,
        item_rows=int(item_rows),
    )


def _on_host(index: IVFIndex) -> IVFIndex:
    """The unsharded layout kept for online updates: on the host, without
    the item table (the model's sharded table takes its place), so the
    card holds the index once."""
    cpu = torch.device("cpu")
    return index._replace(
        centroids=index.centroids.to(cpu), slabs=index.slabs.to(cpu), slab_ids=index.slab_ids.to(cpu),
        slab_scales=index.slab_scales.to(cpu) if index.slab_scales is not None else None, items=None,
    )


def shard_runtime(runtime: "AnnRuntime", mesh, items=None, item_rows: int = 0) -> dict:
    """Lay a runtime's index out over the serving mesh (``pio deploy
    --shard-factors --ann``): queries then take
    :func:`~predictionio_tpu_torch.parallel.sharding.sharded_ivf_topk`.
    ``items``/``item_rows`` are the model's row-sharded item table and
    its logical rows (by default the index's own table, sharded). The
    unsharded layout stays on the runtime, on the host, as ``host_index``
    for :meth:`AnnRuntime.update_items`. Returns the info for
    ``/stats.json`` (``shards``, ``bytesIndexPerDevice``)."""
    with runtime._lock:
        index = runtime.index
    sharded = _shard_index(index, mesh, items, item_rows)
    parts = [sharded.slabs, sharded.slab_ids, sharded.slab_scales]
    per_device = sharded.centroids.numel() * sharded.centroids.element_size() + sum(
        max(t.numel() * t.element_size() for t in p.shards) for p in parts if p is not None
    )
    delta = {"shards": len(mesh), "bytesIndexPerDevice": int(per_device)}
    with runtime._lock:
        runtime.host_index = _on_host(index)
        runtime.index = sharded
        runtime.shard_mesh = mesh
        runtime.build_info.update(delta)
    return delta


# ---------------------------------------------------------------------------
# Query: two-stage retrieval
# ---------------------------------------------------------------------------


def _full_probe(qvecs, index: IVFIndex, k: int):
    """Exact top-k over the index's id-ordered table (``nprobe >=
    nlist``), through the exact path's own computation (``score_rows``)."""
    items = index.items
    if isinstance(items, np.ndarray):
        # the host table: the numpy GEMM and top_k_host of the exact
        # host branch
        q = qvecs.cpu().numpy() if isinstance(qvecs, torch.Tensor) else np.asarray(qvecs, np.float32)
        idx, vals = top_k_host(q @ items.T, min(k, items.shape[0]))
        return torch.from_numpy(idx), torch.from_numpy(np.ascontiguousarray(vals))
    q = torch.as_tensor(qvecs).to(device=index.device, dtype=torch.float32).contiguous()
    scores = score_rows(q, items)
    return top_k_scores(scores, min(k, scores.shape[-1]))


def _ivf_topk(qvecs, index: IVFIndex, k: int, nprobe: int):
    """The query body: score centroids, select clusters, score their
    slabs, tie-stable global merge; the full probe for ``nprobe >=
    nlist``."""
    k = max(1, int(k))
    if int(nprobe) >= index.nlist:
        if index.items is None:
            raise ValueError("the full probe needs the index's id-ordered table (IVFIndex.items)")
        return _full_probe(qvecs, index, k)
    q = torch.as_tensor(qvecs).to(device=index.device, dtype=torch.float32)
    nprobe = max(1, int(nprobe))
    lane_scales = index.slab_scales  # not None => int8 slab codes
    probe = top_k_scores(q @ index.centroids.T, nprobe)[0]  # [B, nprobe], ties to the lower cluster
    score_l, id_l = [], []
    for j in range(nprobe):
        # one gather and product per probe slot: [B, W, K] stays bounded
        sel = probe[:, j]
        cand = index.slabs[sel]
        if lane_scales is not None:
            # dequantize after the dot: one multiply per lane
            s_j = torch.einsum("bwk,bk->bw", cand.to(torch.float32), q) * lane_scales[sel]
        else:
            s_j = torch.einsum("bwk,bk->bw", cand, q)
        score_l.append(s_j)
        id_l.append(index.slab_ids[sel])
    scores = torch.cat(score_l, dim=1)  # [B, nprobe*W]
    ids = torch.cat(id_l, dim=1)
    # padding lanes are zero vectors scoring 0: mask by the id sentinel
    scores = torch.where(ids < index.num_items, scores, torch.full_like(scores, -torch.inf))
    k = min(k, scores.shape[-1])
    return top_k_permuted(scores, ids, k, big_ids=index.num_items >= (1 << 24))


def ivf_topk_batch(qvecs, index: IVFIndex, k: int, nprobe: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k for a batch of query VECTORS ``[B, K]``: ``([B,
    k] item ids, [B, k] scores)``, descending score, ties by ascending
    id. Rows whose probed clusters hold fewer than ``k`` real items carry
    the ``num_items`` sentinel (score ``-inf``) in the tail; callers drop
    it (:func:`trim_row`)."""
    return _ivf_topk(qvecs, index, k, nprobe)


def ivf_topk_users(user_idx, user_factors, index: IVFIndex, k: int, nprobe: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k for a batch of USERS: gather the user rows on the
    device, then :func:`ivf_topk_batch`. At the full probe over a tensor
    table this IS :func:`top_k_items_batch` on the same arguments."""
    idx = torch.as_tensor(np.asarray(user_idx, np.int64) if not isinstance(user_idx, torch.Tensor) else user_idx)
    items = index.items
    if (
        int(nprobe) >= index.nlist
        and isinstance(items, torch.Tensor)
        and isinstance(user_factors, torch.Tensor)
    ):
        return top_k_items_batch(idx.to(user_factors.device), user_factors, items, min(max(1, int(k)), items.shape[0]))
    if isinstance(user_factors, np.ndarray):
        return _ivf_topk(user_factors[idx.numpy()], index, k, nprobe)
    return _ivf_topk(user_factors[idx.to(user_factors.device)], index, k, nprobe)


def trim_row(ids: np.ndarray, scores: np.ndarray, num_items: int):
    """Drop sentinel padding from one result row; returns plain lists."""
    keep = ids < num_items
    return ids[keep].tolist(), scores[keep].tolist()


class AnnRuntime:
    """Per-model serving state: the index, the deploy-time ``nprobe``,
    build info and thread-safe query counters for ``/stats.json``.

    Attached to a model as ``model._pio_ann`` by the algorithm's
    ``build_ann_for_serving`` hook (``workflow/device_state.py`` drives it
    at (re)load), detached by ``release_ann_state`` when the generation is
    superseded."""

    def __init__(self, index: IVFIndex, nprobe: int, build_info: dict):
        self.index = index
        self.nprobe = max(1, min(int(nprobe), index.nlist))
        self.build_info = dict(build_info)
        self._lock = threading.Lock()
        self.queries = 0
        self.clusters_scored = 0
        self.candidates_scored = 0
        #: incremental-maintenance host mirror (built on the first update)
        self._update_state: dict | None = None
        self.incremental_updates = 0
        self.items_folded = 0
        #: --shard-factors (:func:`shard_runtime`): the mesh, and the
        #: unsharded host layout updates fold into; ``index`` is sharded
        self.shard_mesh = None
        self.host_index: IVFIndex | None = None

    def update_items(self, item_ids: np.ndarray, vectors: np.ndarray, total_items: int, table=None) -> dict:
        """Fold changed/new item vectors into the live index
        (:func:`update_ivf`) and swap ``self.index`` whole: a query that
        already took the old index finishes on it. Sharded, the update
        folds into the host layout and the result is sharded anew, with
        ``table`` (the model's sharded item table after the fold, of
        ``total_items`` logical rows) as its item table."""
        with self._lock:
            state = self._update_state
            mesh = self.shard_mesh
            index = self.host_index if mesh is not None else self.index
        new_index, state, info = update_ivf(
            index, item_ids, vectors, total_items, state, table=table if mesh is None else None
        )
        if mesh is not None:
            if table is None:
                raise ValueError("a sharded index's update needs the model's sharded item table")
            host_index, new_index = new_index, _shard_index(new_index, mesh, table, total_items)
        with self._lock:
            if mesh is not None:
                self.host_index = host_index
            self.index = new_index
            self._update_state = state
            self.incremental_updates += 1
            self.items_folded += len(np.asarray(item_ids))
        return info

    def note_queries(self, n: int) -> None:
        """Account ``n`` queries' worth of scored clusters/candidates."""
        index = self.index
        probed = self.nprobe
        candidates = index.num_items if probed >= index.nlist else probed * index.slab_width
        with self._lock:
            self.queries += n
            self.clusters_scored += n * probed
            self.candidates_scored += n * candidates

    def stats_json(self) -> dict:
        with self._lock:
            q = self.queries
            clusters = self.clusters_scored
            candidates = self.candidates_scored
            inc = self.incremental_updates
            folded = self.items_folded
            total = q * self.index.num_items
        out = {
            "nprobe": self.nprobe,
            "queries": q,
            "clustersScored": clusters,
            "candidatesScored": candidates,
            "incrementalUpdates": inc,
            "itemsFolded": folded,
            # what fraction of the catalog each query paid for, vs 1.0
            # on the exact path
            "fractionOfCatalogScored": round(candidates / total, 4) if total else 0.0,
        }
        out.update(self.build_info)
        return out


def query_topk(runtime: AnnRuntime, qvec, k: int) -> tuple[list, list]:
    """Single-query retrieval through the index: top-``k`` as ``(item id
    list, score list)`` with sentinel padding trimmed. Callers applying
    blacklist/seen filters over-fetch here (``k = wanted +
    len(excluded)``) and drop excluded ids from the longer list. ``k``
    buckets to a power of two (floor 16), like ``chunked_topk``."""
    index = runtime.index
    k = min(int(k), index.num_items)
    if k <= 0:
        return [], []
    kb = bucket_k(k, index.num_items)
    if isinstance(qvec, torch.Tensor):
        q = qvec.reshape(1, -1)
    else:
        q = torch.as_tensor(np.asarray(qvec, dtype=np.float32).reshape(1, -1))
    if runtime.shard_mesh is not None:
        from predictionio_tpu_torch.parallel import sharding

        ids, scores = sharding.sharded_ivf_topk(q, index, kb, runtime.nprobe)
    else:
        ids, scores = ivf_topk_batch(q, index, kb, runtime.nprobe)
    runtime.note_queries(1)
    ids_l, scores_l = trim_row(ids.cpu().numpy()[0], scores.cpu().numpy()[0], index.num_items)
    return ids_l[:k], scores_l[:k]
