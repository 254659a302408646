"""Model-axis sharded factor serving — ``pio deploy --shard-factors``.

Counterpart of ``predictionio_tpu/parallel/sharding.py``. Served
replicated, a factor table costs every device the whole catalog; sharded,
each device of a one-axis ``model`` mesh holds a ``[rows/S, K]`` slice of
each table, so a device's factor memory is ``O((U+I)·K / S)`` and the
largest servable catalog grows with the mesh.

The serving mesh is the local devices of one process, addressed one by
one (the training mesh, ``controller/context.py``'s ``mesh_context``,
spans the processes of a job; its tables are :class:`ShardedTable`\\ s
too):

* :class:`ServingMesh` — an ordered tuple of ``torch.device``\\ s, one per
  shard. The first leads: query rows, finalists and results land there.
  :func:`serving_mesh` builds it over the card's local devices (over the
  CPU when the caller asks for the CPU) and returns ``None`` below two
  devices, where sharding is replication and the templates pin
  replicated with the JAX package's warning. :func:`local_devices` sets
  the device list for a block: a mesh over one repeated device,
  ``(cuda:0,)*8`` or ``(cpu,)*8``, is the port's counterpart of the JAX
  package's forced host-device count (its tests' 8-way mesh). Nothing
  reads it from the environment, and ``pio deploy`` never sets it.
* :class:`ShardedTable` — one tensor a mesh position, its rows padded to
  an even split (:func:`padded_rows`; ``capacity`` adds headroom for
  online cold starts). :class:`ShardInfo` carries the mesh and the
  LOGICAL row counts; every kernel masks the padding by them, and the
  callers slice by them.
* The collectives are copies to the lead device: the JAX package's
  masked row gather plus ``psum`` is a gather from each row's owner
  shard (:func:`gather_rows`), its all-gather of finalists a ``cat``.

Top-K (:func:`sharded_topk_users`, :func:`sharded_quantized_topk_users`,
:func:`sharded_ivf_topk`): every shard scores only its own rows, takes a
local top-k under the shared tie rule (``ops/topk.py``, never
``torch.topk``), and only ``S·k`` finalists a query reach the lead, where
:func:`~predictionio_tpu_torch.ops.topk.sort_merge_topk` merges them.
Exact scores go through :func:`~predictionio_tpu_torch.ops.als.score_rows`,
whose products have one shape whatever the table's row count, so a shard
scores an item to the same bits as the replicated table does and the
merged ranking is the replicated path's, ties and all.

Every call runs on the deploy's one device thread. Nothing imports this
module until a deploy passes ``--shard-factors``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.als import score_rows
from predictionio_tpu_torch.ops.topk import bucket_k, sort_merge_topk, top_k_scores

__all__ = [
    "MODEL_AXIS",
    "GROW_STEP",
    "ServingMesh",
    "ShardInfo",
    "ShardedTable",
    "local_devices",
    "visible_devices",
    "serving_mesh",
    "padded_rows",
    "shard_table",
    "shard_quantized_table",
    "shard_rows",
    "set_rows",
    "relayout",
    "gather_rows",
    "sharded_topk_users",
    "sharded_quantized_topk_users",
    "sharded_ivf_topk",
    "topk_users",
    "is_sharded",
    "table_bytes",
    "sharded_table_bytes",
    "per_device_bytes",
    "per_device_bytes_quantized",
]

#: the serving mesh's one axis (the JAX package's name)
MODEL_AXIS = "model"

#: cold-start growth headroom (rows) when a sharded table must be laid
#: out anew: growing by at least this much spreads the re-layout's cost
#: over many fold-ins
GROW_STEP = 1024

#: the device list :func:`local_devices` set (None: the real devices)
_LOCAL_DEVICES: tuple | None = None


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def local_devices(devices: Sequence) -> Iterator[tuple]:
    """Within the block, :func:`serving_mesh` sees ``devices`` (any
    ``torch.device`` specs, repeats allowed) instead of the real local
    devices — ``local_devices([torch.device("cuda", 0)] * 8)`` gives an
    8-way mesh on one card. The tests' fixtures and ``chip_smoke.py`` set
    it; nothing reads it from the environment."""
    global _LOCAL_DEVICES
    saved = _LOCAL_DEVICES
    _LOCAL_DEVICES = tuple(torch.device(d) for d in devices)
    try:
        yield _LOCAL_DEVICES
    finally:
        _LOCAL_DEVICES = saved


def visible_devices(device=None) -> tuple:
    """The devices a serving mesh may span: :func:`local_devices`' list
    when one is set, else the card's local devices (``device`` names the
    card, as everywhere in the port) or, when the caller asks for the
    CPU, the CPU alone."""
    if _LOCAL_DEVICES is not None:
        return _LOCAL_DEVICES
    dev = resolve_device(device)
    if dev.type == "cpu":
        return (dev,)
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


class ServingMesh(tuple):
    """An ordered tuple of ``torch.device``\\ s, one a shard; position
    ``s`` holds rows ``[s·rps, (s+1)·rps)`` of every sharded table, and
    the first device leads."""

    @property
    def shape(self) -> dict:
        return {MODEL_AXIS: len(self)}


def serving_mesh(shards: int = 0, device=None) -> ServingMesh | None:
    """A one-axis mesh over :func:`visible_devices`; ``shards`` caps its
    size (0: every device). ``None`` when fewer than two devices are
    visible: sharding over one device is replication, so the callers pin
    replicated."""
    devs = visible_devices(device)
    n = len(devs) if shards <= 0 else max(1, min(int(shards), len(devs)))
    if n < 2:
        return None
    return ServingMesh(devs[:n])


@dataclasses.dataclass
class ShardInfo:
    """Per-model sharded-serving state (``model._pio_shards``, set by the
    templates' ``shard_model_for_serving`` and
    ``quantize_model_for_serving(shard=True)``). ``rows`` maps ``"user"``
    and ``"item"`` to the LOGICAL row counts; mutable on purpose, as online
    cold starts advance them (``workflow/device_state.swap_side_rows``)."""

    mesh: ServingMesh
    rows: dict

    @property
    def num_shards(self) -> int:
        return len(self.mesh)


class Shard(NamedTuple):
    """One mesh position's part of a :class:`ShardedTable`."""

    device: torch.device
    data: torch.Tensor


class ShardedTable:
    """A table row-sharded over a :class:`ServingMesh`: ``shards[s]`` is
    position ``s``'s ``[rows/S, ...]`` tensor on ``mesh[s]``. The shape is
    the padded physical one; ``np.asarray`` gathers every shard to the
    host, padding included; indexing with row ids gathers those rows to
    the lead device (:func:`gather_rows`). Immutable: an update
    (:func:`set_rows`) makes a new table that shares the untouched
    shards."""

    __slots__ = ("shards", "mesh", "__weakref__")

    def __init__(self, shards: Sequence[torch.Tensor], mesh: ServingMesh):
        self.shards = tuple(shards)
        self.mesh = mesh

    @property
    def rows_per_shard(self) -> int:
        return int(self.shards[0].shape[0])

    @property
    def shape(self) -> tuple:
        return (self.rows_per_shard * len(self.shards),) + tuple(self.shards[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """Where gathered rows and results land: the lead device."""
        return self.mesh[0]

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.shards)

    @property
    def addressable_shards(self) -> tuple:
        return tuple(Shard(d, t) for d, t in zip(self.mesh, self.shards))

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return gather_rows([int(idx)], self)[0]
        if isinstance(idx, slice):
            idx = np.arange(len(self))[idx]
        return gather_rows(idx, self)

    def __array__(self, dtype=None, copy=None):
        host = np.concatenate([t.detach().cpu().numpy() for t in self.shards])
        return host.astype(dtype) if dtype is not None else host

    def __repr__(self) -> str:
        return f"ShardedTable(shape={self.shape}, dtype={self.dtype}, mesh={tuple(str(d) for d in self.mesh)})"


def is_sharded(table) -> bool:
    """A :class:`ShardedTable`, or an int8 table whose codes are one."""
    return isinstance(getattr(table, "codes", table), ShardedTable)


def _mesh_of(table) -> ServingMesh:
    return getattr(table, "codes", table).mesh


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def padded_rows(n: int, shards: int) -> int:
    """Physical row count: ``n`` padded up so every shard is even."""
    return -(-max(int(n), 1) // shards) * shards


def _place(arr, mesh: ServingMesh, capacity: int = 0) -> ShardedTable:
    """Split ``arr`` (numpy or a tensor, any dtype and rank) by rows over
    ``mesh``, zero-padded to :func:`padded_rows` of ``max(rows,
    capacity)``. Every shard is a tensor of its own, so no shard keeps the
    others' memory alive."""
    S = len(mesh)
    n = int(arr.shape[0])
    n_pad = padded_rows(max(n, int(capacity)), S)
    rps = n_pad // S
    parts = []
    for s, dev in enumerate(mesh):
        lo, hi = min(s * rps, n), min((s + 1) * rps, n)
        if isinstance(arr, torch.Tensor):
            part = arr[lo:hi].to(dev, copy=True)
        else:
            part = torch.tensor(np.ascontiguousarray(arr[lo:hi]), device=dev)
        if hi - lo < rps:
            part = torch.cat([part, part.new_zeros((rps - (hi - lo),) + tuple(part.shape[1:]))])
        parts.append(part)
    return ShardedTable(parts, mesh)


def _host_f32(mat) -> np.ndarray:
    if isinstance(mat, torch.Tensor):
        return mat.detach().to(torch.float32).cpu().numpy()
    return np.asarray(mat, dtype=np.float32)


def shard_table(mat, mesh: ServingMesh, capacity: int = 0) -> ShardedTable:
    """A factor table (host numpy or a tensor) as float32 rows sharded
    over ``mesh``: each device receives only its ``[rows/S, K]`` part,
    zero rows pad the split (up to ``capacity`` rows when given)."""
    mat = _host_f32(mat)
    if mat.ndim != 2:
        raise ValueError(f"factor table must be 2-D, got {mat.shape}")
    return _place(mat, mesh, capacity)


def shard_quantized_table(mat, mesh: ServingMesh, capacity: int = 0):
    """Quantize a host f32 table (``ops/quant``'s one rule) and shard its
    int8 codes and per-row scales over ``mesh``: a device holds
    ``rows/S · (rank + 4)`` bytes a table, the two tiers' savings
    multiplied (``pio deploy --shard-factors --quantize int8``). Padding
    rows are zero codes with a zero scale, masked like the f32 layout's."""
    from predictionio_tpu_torch.ops import quant

    mat = _host_f32(mat)
    if mat.ndim != 2:
        raise ValueError(f"factor table must be 2-D, got {mat.shape}")
    codes, scales = quant.quantize_table_host(mat)
    return quant.QuantizedTable(_place(codes, mesh, capacity), _place(scales, mesh, capacity))


def shard_rows(table, mesh: ServingMesh, capacity: int = 0):
    """A replicated table's rows, as they are, sharded over ``mesh``: a
    tensor keeps its dtype, an int8 table its codes and scales (nothing
    re-quantizes)."""
    if getattr(table, "is_quantized", False):
        from predictionio_tpu_torch.ops import quant

        return quant.QuantizedTable(_place(table.codes, mesh, capacity), _place(table.scales, mesh, capacity))
    return _place(table, mesh, capacity)


def set_rows(table: ShardedTable, idx, rows) -> ShardedTable:
    """Rows ``idx`` (global ids) of ``table`` replaced by ``rows``: each row
    goes to its owner shard (an out-of-place ``index_copy`` there), the
    other shards are shared with ``table`` as they are, and ``table``
    itself does not change."""
    idx = np.asarray(idx, np.int64).reshape(-1)
    rows = np.asarray(rows)
    rps = table.rows_per_shard
    if idx.size and (idx.min() < 0 or idx.max() >= len(table)):
        raise IndexError(f"row ids outside the sharded table's {len(table)} rows")
    owner = idx // rps
    parts = list(table.shards)
    for s in np.unique(owner).tolist():
        mine = owner == s
        part = parts[s]
        local = torch.as_tensor(idx[mine] - s * rps, device=part.device)
        src = torch.as_tensor(rows[mine]).to(device=part.device, dtype=part.dtype)
        parts[s] = part.index_copy(0, local, src)
    return ShardedTable(parts, table.mesh)


def relayout(table, logical: int, new_rows: np.ndarray, capacity: int):
    """Past its padding, a sharded table laid out anew: its first
    ``logical`` rows, then ``new_rows``, over the same mesh with room for
    ``capacity`` rows. An int8 table keeps its codes and scales and
    quantizes only the new rows."""
    if getattr(table, "is_quantized", False):
        from predictionio_tpu_torch.ops import quant

        codes, scales = quant.quantize_table_host(np.asarray(new_rows, np.float32))
        mesh = table.codes.mesh
        host_codes = np.concatenate([np.asarray(table.codes)[:logical], codes])
        host_scales = np.concatenate([np.asarray(table.scales)[:logical], scales])
        return quant.QuantizedTable(_place(host_codes, mesh, capacity), _place(host_scales, mesh, capacity))
    host = np.concatenate([np.asarray(table)[:logical], np.asarray(new_rows, np.float32)])
    return _place(host, table.mesh, capacity)


# ---------------------------------------------------------------------------
# Byte accounting (shape math, and the bytes each position really holds)
# ---------------------------------------------------------------------------


def table_bytes(rows: int, rank: int, itemsize: int = 4) -> int:
    """Bytes of one replicated factor table: what every device pays
    without sharding."""
    return int(rows) * int(rank) * itemsize


def sharded_table_bytes(rows: int, rank: int, shards: int, itemsize: int = 4) -> int:
    """A device's bytes of the same table sharded ``shards``-way, the
    even-split padding included (at most ``(shards-1)·rank·itemsize``)."""
    return padded_rows(rows, shards) // shards * int(rank) * itemsize


def per_device_bytes(arr) -> int:
    """MEASURED bytes of ``arr`` at its largest mesh position: read from
    the tensors of each position, so it stays true on a mesh over one
    repeated device (where the device holds every position)."""
    if isinstance(arr, ShardedTable):
        return max(t.numel() * t.element_size() for t in arr.shards)
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(np.asarray(arr).nbytes)


def per_device_bytes_quantized(qt) -> int:
    """Measured bytes of a sharded int8 table at its largest position:
    codes and scales."""
    return per_device_bytes(qt.codes) + per_device_bytes(qt.scales)


# ---------------------------------------------------------------------------
# Collectives and top-K
# ---------------------------------------------------------------------------


def _indices(idx, device: torch.device) -> torch.Tensor:
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.int64).reshape(-1)
    return torch.as_tensor(np.asarray(idx, np.int64).reshape(-1), device=device)


def gather_rows(idx, tbl: ShardedTable, mesh=None) -> torch.Tensor:
    """Rows ``idx`` (global ids) of a sharded table, on the lead device —
    the sharded ``tbl[idx]``, which moves only the rows asked for: every
    shard gathers its clamped local rows, and each row is taken from its
    owner (a select, so the bits are the stored ones)."""
    del mesh  # the table carries its mesh
    lead = tbl.mesh[0]
    idx = _indices(idx, lead)
    rps = tbl.rows_per_shard
    owner = torch.div(idx, rps, rounding_mode="floor")
    out = None
    for s, (dev, part) in enumerate(zip(tbl.mesh, tbl.shards)):
        local = (idx - s * rps).clamp(0, rps - 1).to(dev, non_blocking=True)
        rows = part.index_select(0, local).to(lead, non_blocking=True)
        if out is None:
            out = rows  # right for shard 0's rows; the others overwrite theirs
        else:
            mine = (owner == s).reshape((-1,) + (1,) * (rows.dim() - 1))
            out = torch.where(mine, rows, out)
    return out


def _part(table, s: int):
    """Shard ``s`` of a sharded f32 table, or of an int8 one as a
    ``QuantizedTable`` of its two parts."""
    if getattr(table, "is_quantized", False):
        return type(table)(table.codes.shards[s], table.scales.shards[s])
    return table.shards[s]


def _merge(vals: list, ids: list, k: int, lead: torch.device, total_order: bool = False):
    """The cross-shard reduce: every shard's finalists to the lead, then
    the shared two-key tie rule over them."""
    gv = torch.cat([v.to(lead, non_blocking=True) for v in vals], dim=1)
    gi = torch.cat([i.to(lead, non_blocking=True) for i in ids], dim=1)
    return sort_merge_topk(gv, gi, min(int(k), gv.shape[1]), total_order=total_order)


def _exact_topk(q: torch.Tensor, table, k: int, num_rows: int):
    """Exact top-``k`` of query vectors ``q`` (on the lead) over a sharded
    f32 or int8 table's first ``num_rows`` rows: per shard
    :func:`score_rows` (the replicated path's per-item bits), the padding
    masked to ``-inf``, a local :func:`top_k_scores`, then a merge keyed
    on the same bits-order as :func:`top_k_scores` (``0.0`` above
    ``-0.0``), so the result is the replicated ``top_k_scores`` of the
    whole row. A shard holding only padding is skipped."""
    mesh = _mesh_of(table)
    rps = getattr(table, "codes", table).rows_per_shard
    kk = min(int(k), rps)
    vals, ids = [], []
    for s, dev in enumerate(mesh):
        base = s * rps
        if base >= num_rows:
            continue
        scores = score_rows(q.to(dev, non_blocking=True), _part(table, s))  # [B, rps]
        if base + rps > num_rows:
            gid = torch.arange(base, base + rps, device=dev)
            scores = scores.masked_fill(gid[None, :] >= num_rows, float("-inf"))
        p, v = top_k_scores(scores, kk)
        vals.append(v)
        ids.append(p + base)
    return _merge(vals, ids, min(int(k), int(num_rows)), mesh[0], total_order=True)


def sharded_topk_users(user_idx, user_tbl: ShardedTable, item_tbl: ShardedTable, k: int, num_items: int,
                       mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over sharded factor tables: ``([B, k] item ids, [B, k]
    scores)`` on the lead, descending score, ties by ascending id — the
    replicated :func:`~predictionio_tpu_torch.ops.als.top_k_items_batch`'s
    answer on the same factors. ``num_items`` (the logical catalog, read
    once a batch) masks the padding rows, which would otherwise outrank
    real negative scores. Each shard does one gather of the query rows'
    owners, its ``[B,K]@[K,I/S]`` products and a local top-k; ``S·k``
    finalists a query reach the lead."""
    del mesh  # the tables carry their mesh
    q = gather_rows(user_idx, user_tbl)
    return _exact_topk(q, item_tbl, int(k), int(num_items))


def sharded_quantized_topk_users(user_idx, u_codes: ShardedTable, u_scales: ShardedTable, i_codes: ShardedTable,
                                 i_scales: ShardedTable, k: int, kp: int, num_items: int,
                                 mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-stage int8 top-k over sharded int8 tables (``pio deploy
    --shard-factors --quantize int8``): the query rows gathered from their
    owner shards and dequantized on the lead, re-quantized; then per shard
    the exact int8 coarse scan of its own rows, a local over-fetch of
    ``kp`` (``ops/quant``'s rule on the caller's bucket), the f32 rescore
    of only those local candidates, and a local tie-stable merge; the
    lead merges the ``S·k`` rescored finalists. Each stage applies
    ``ops/quant``'s arithmetic in its order, so the scores are the
    replicated two-stage kernel's, and so are the ids wherever its global
    over-fetch holds the true top-k (a shard's over-fetch is a superset
    of its part of the global one)."""
    from predictionio_tpu_torch.ops import quant

    del mesh  # the tables carry their mesh
    mesh_ = i_codes.mesh
    lead = mesh_[0]
    num_items = int(num_items)
    q = quant.dequantize(gather_rows(user_idx, u_codes), gather_rows(user_idx, u_scales))
    q_codes, q_scales = quant.quantize_rows(q)
    rps = i_codes.rows_per_shard
    kp = int(kp)
    kk = min(int(k), rps)
    kpp = max(kk, min(kp, rps))
    vals, ids = [], []
    for s, dev in enumerate(mesh_):
        base = s * rps
        if base >= num_items:
            continue
        ic, isc = i_codes.shards[s], i_scales.shards[s]
        acc = quant.int8_matmul(q_codes.to(dev, non_blocking=True), ic)  # [B, rps] int32
        approx = acc.to(torch.float32) * q_scales.to(dev, non_blocking=True)[:, None] * isc[None, :]
        if base + rps > num_items:
            gid = torch.arange(base, base + rps, device=dev)
            approx = approx.masked_fill(gid[None, :] >= num_items, float("-inf"))
        cand = top_k_scores(approx, kpp)[0]  # local over-fetch; positions are local ids
        deq = quant.dequantize(ic[cand], isc[cand])  # [B, kpp, K]
        if kpp < kp:
            # the rescore product at the replicated kernel's width (kp
            # candidates): its per-candidate sums then have the same bits
            deq = torch.cat([deq, deq.new_zeros((deq.shape[0], kp - kpp, deq.shape[2]))], dim=1)
        exact = torch.einsum("bpk,bk->bp", deq, q.to(dev, non_blocking=True))[:, :kpp]
        gid = cand + base
        valid = gid < num_items
        exact = torch.where(valid, exact, torch.full_like(exact, float("-inf")))
        gid = torch.where(valid, gid, torch.full_like(gid, num_items))
        li, lv = sort_merge_topk(exact, gid, kk)
        vals.append(lv)
        ids.append(li)
    return _merge(vals, ids, int(k), lead)


def sharded_ivf_topk(qvecs, index, k: int, nprobe: int, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """IVF retrieval over cluster-sharded slabs (``index`` from
    :func:`predictionio_tpu_torch.ops.ivf.shard_runtime`: slabs, slab ids
    and lane scales :class:`ShardedTable`\\ s over the cluster axis,
    centroids on the lead, the id-ordered item table sharded by rows).

    Stage 1 (centroid scores, probe selection) runs once on the lead, as
    the unsharded probe computes it. Stage 2: every shard scores only the
    probed clusters it owns (slots owned elsewhere are masked), merges
    its candidates tie-stably in id space, and ``S·k`` finalists reach
    the lead for the same merge the unsharded probe ends with: the ids
    are :func:`~predictionio_tpu_torch.ops.ivf.ivf_topk_batch`'s on the
    unsharded index, ties included. ``nprobe >= nlist`` is exact
    retrieval over the sharded item table (:func:`sharded_topk_users`'s
    computation), to the bit the exact path's answer."""
    del mesh  # the index carries its mesh
    slabs = index.slabs
    lead = slabs.mesh[0]
    q = torch.as_tensor(qvecs).to(device=lead, dtype=torch.float32)
    k = max(1, int(k))
    if int(nprobe) >= index.nlist:
        if index.items is None:
            raise ValueError("the full probe needs the index's id-ordered table (IVFIndex.items)")
        return _exact_topk(q, index.items, k, index.item_rows)
    nprobe = max(1, int(nprobe))
    num_items = index.num_items
    lists_per = slabs.rows_per_shard
    quantized = index.slab_scales is not None
    kk = max(1, min(k, nprobe * index.slab_width))
    probe = top_k_scores(q @ index.centroids.T, nprobe)[0]  # [B, nprobe] global cluster ids
    vals, ids = [], []
    for s, dev in enumerate(slabs.mesh):
        slabs_l, ids_l = slabs.shards[s], index.slab_ids.shards[s]
        scales_l = index.slab_scales.shards[s] if quantized else None
        qs = q.to(dev, non_blocking=True)
        lp = (probe - s * lists_per).to(dev, non_blocking=True)
        own = (lp >= 0) & (lp < lists_per)
        score_l, id_l = [], []
        # one gather and product a probe SLOT (the unsharded probe's
        # shapes); a slot owned elsewhere reads cluster 0 and is masked
        for j in range(nprobe):
            sel = torch.where(own[:, j], lp[:, j], torch.zeros_like(lp[:, j]))
            cand = slabs_l[sel]  # [B, W, K]
            lane_ids = ids_l[sel]  # [B, W]
            if quantized:
                s_j = torch.einsum("bwk,bk->bw", cand.to(torch.float32), qs) * scales_l[sel]
            else:
                s_j = torch.einsum("bwk,bk->bw", cand, qs)
            valid = own[:, j, None] & (lane_ids < num_items)
            score_l.append(torch.where(valid, s_j, torch.full_like(s_j, float("-inf"))))
            id_l.append(torch.where(valid, lane_ids, torch.full_like(lane_ids, num_items)))
        # a shard's candidates are in (slot, lane) order, not id order:
        # the local merge is already tie-stable in id space
        li, lv = sort_merge_topk(torch.cat(score_l, dim=1), torch.cat(id_l, dim=1), kk)
        vals.append(lv)
        ids.append(li)
    return _merge(vals, ids, kk, lead)


# ---------------------------------------------------------------------------
# Host-facing wrapper (numpy out — what the templates' predict calls)
# ---------------------------------------------------------------------------


def topk_users(info: ShardInfo, user_tbl: ShardedTable, item_tbl: ShardedTable, user_idx,
               k: int) -> tuple[np.ndarray, np.ndarray]:
    """Top-``k`` for a batch of user INDICES through
    :func:`sharded_topk_users`, as numpy ``([B, k] ids, [B, k] scores)``;
    ``k`` buckets to a power of two (floor 16), like every other tier."""
    num_items = int(info.rows["item"])
    k = max(1, min(int(k), num_items))
    ids, scores = sharded_topk_users(user_idx, user_tbl, item_tbl, bucket_k(k, num_items), num_items)
    return ids.cpu().numpy()[:, :k], scores.cpu().numpy()[:, :k]
