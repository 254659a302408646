"""Two-tower retrieval training in PyTorch, on one device or a mesh.

Counterpart of ``predictionio_tpu/ops/twotower.py``. The model and its
training are the JAX package's:

* **Towers** — a user and an item embedding table ``[N, D]``, cold-drawn
  from a seeded normal scaled by ``1/√D`` (or injected); the tower output
  is the L2-normalised row (``x / (‖x‖ + 1e-8)``).
* **In-batch sampled softmax** — each (user, item) pair of a batch treats
  the batch's other items as negatives, symmetrically (u→i and i→u):
  :func:`inbatch_loss`. With bf16 GEMMs and a supported shape it is the
  fused loss of :mod:`predictionio_tpu_torch.ops.fused_ce` (the
  hand-written CUDA kernels on the card); otherwise two logit products
  and ``F.cross_entropy``.
* **Adam** with optax's defaults (b1 0.9, b2 0.999, eps 1e-8) on the dense
  table gradients, as ``optax.adam`` does it.
* **Batches** — the pairs are padded to whole batches by resampling real
  pairs, uploaded once, and reshuffled on the device every epoch.

The epoch is a Python loop of eager steps (the JAX package scans a jitted
step); losses stay on the device and are read back once per epoch.

On a mesh (``train_two_tower(mesh=...)``, a
:class:`~predictionio_tpu_torch.controller.context.TrainingMesh`):

* **Sharded embedding tables** — both tables row-sharded over the model
  positions (one
  :class:`~predictionio_tpu_torch.parallel.sharding.ShardedTable` a data
  position); :func:`sharded_embedding_lookup` gathers each id from its
  owner shard, and its backward scatter-adds into each shard's own rows,
  so no gradient holds the whole table.
* **Data-sharded batches** — each data position (of every process) takes
  its slice of the global batch; the loss needs every negative, so the
  other slices' embeddings join each position's logits (copies in
  process; across processes each process looks the other slices up in
  its own tables, which hold every row, as the model axis lives within a
  process). The table gradients are summed over the data positions and
  all-reduced across processes before one Adam step a position.
* The mesh path takes the unfused loss, as the JAX package's does
  (its in-batch negatives are global); the shard padding keeps the
  canonical draw: the tables are drawn at their unpadded shape and
  zero rows pad the split.
"""

from __future__ import annotations

import dataclasses
import time
from types import MappingProxyType
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.fused_ce import fused_ce_supported, fused_inbatch_ce

__all__ = [
    "GEMM_DTYPES",
    "FUSED_CE_SETTINGS",
    "TwoTowerConfig",
    "TwoTowerModel",
    "AdamState",
    "adam_update",
    "l2_normalize",
    "inbatch_loss",
    "uses_fused_ce",
    "train_step",
    "sharded_embedding_lookup",
    "train_two_tower",
]

#: logit-product operand types: "bfloat16" (f32 accumulation; the fused
#: kernels' type) or "float32"
GEMM_DTYPES = ("bfloat16", "float32")

#: ``TwoTowerConfig.fused_ce``: "auto" (the CUDA kernels on the card, their
#: plain versions on the CPU), "off" (the unfused path), "interpret" (the
#: plain versions anywhere)
FUSED_CE_SETTINGS = ("auto", "off", "interpret")


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    dim: int = 32
    batch_size: int = 256
    epochs: int = 5
    learning_rate: float = 0.05
    temperature: float = 0.1
    seed: int = 0
    #: keep a loss-history entry every N steps (losses are computed every
    #: step on the device and read back once per epoch)
    log_every: int = 50
    #: operand type of the in-batch logit products (see ``GEMM_DTYPES``)
    gemm_dtype: str = "bfloat16"
    #: the fused softmax-CE (see ``FUSED_CE_SETTINGS``): used when
    #: ``gemm_dtype`` is bfloat16 and the batch shape is supported
    fused_ce: str = "auto"


class TwoTowerModel(NamedTuple):
    """Serving-ready tower outputs: dot(user_vec, item_vec) ranks items.
    Rows are L2-normalised host numpy, so scores are cosine similarities."""

    user_vecs: Any  # [U, D]
    item_vecs: Any  # [I, D]
    loss_history: tuple  # ((step, loss), ...)
    #: wall seconds of the phases: ingest (interaction upload), train (the
    #: epoch loop), finalize (normalise + host readback)
    timings: Any = MappingProxyType({})


class AdamState:
    """``optax.adam``'s state for a list of tables: the step count and the
    first and second moments, zeros at the start."""

    def __init__(self, tables: Sequence[torch.Tensor]):
        self.count = 0
        self.mu = [torch.zeros_like(t) for t in tables]
        self.nu = [torch.zeros_like(t) for t in tables]


@torch.no_grad()
def adam_update(
    tables: Sequence[torch.Tensor],
    grads: Sequence[torch.Tensor],
    state: AdamState,
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> None:
    """One ``optax.adam(learning_rate)`` step, in place:
    ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² + b2·nu``, then
    ``p -= lr · mu_hat / (sqrt(nu_hat) + eps)`` with the bias corrections
    ``1 - b**count``."""
    state.count += 1
    bc1 = 1.0 - b1**state.count
    bc2 = 1.0 - b2**state.count
    for p, g, mu, nu in zip(tables, grads, state.mu, state.nu):
        mu.copy_(g * (1.0 - b1) + mu * b1)
        nu.copy_(g * g * (1.0 - b2) + nu * b2)
        p.sub_((mu / bc1) / ((nu / bc2).sqrt_() + eps) * learning_rate)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit L2 norm, ``x / (‖x‖ + 1e-8)``."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def uses_fused_ce(B: int, D: int, inv_temp: float, gemm_dtype: str, fused_ce: str) -> bool:
    """Whether :func:`inbatch_loss` takes the fused loss: bf16 GEMMs, the
    fused loss not switched off, and a shape it supports."""
    return gemm_dtype == "bfloat16" and fused_ce != "off" and fused_ce_supported(B, D, inv_temp)


def _logits(a: torch.Tensor, b: torch.Tensor, inv_temp: float, gemm_dtype: str) -> torch.Tensor:
    """``a @ b.T · inv_temp`` from ``gemm_dtype`` operands, f32 results."""
    if gemm_dtype == "bfloat16":
        # a product of two bf16 values is exact in f32: this is the bf16
        # product with f32 accumulation
        a = a.to(torch.bfloat16).to(torch.float32)
        b = b.to(torch.bfloat16).to(torch.float32)
    return (a @ b.T) * inv_temp


def inbatch_loss(
    ue: torch.Tensor, ie: torch.Tensor, inv_temp: float,
    gemm_dtype: str = "bfloat16", fused_ce: str = "auto",
) -> torch.Tensor:
    """Mean symmetric in-batch softmax CE of normalised towers ``[B, D]``.

    The fused loss where :func:`uses_fused_ce`; else the unfused path:
    ``[B, B]`` logits from ``gemm_dtype`` operands with f32 results, then
    ``F.cross_entropy`` both ways, averaged."""
    B, D = ue.shape
    if uses_fused_ce(B, D, inv_temp, gemm_dtype, fused_ce):
        return fused_inbatch_ce(ue, ie, inv_temp, "interpret" if fused_ce == "interpret" else "auto")
    labels = torch.arange(B, device=ue.device)
    return 0.5 * (
        F.cross_entropy(_logits(ue, ie, inv_temp, gemm_dtype), labels)
        + F.cross_entropy(_logits(ie, ue, inv_temp, gemm_dtype), labels)
    )


def train_step(
    tables: Sequence[torch.Tensor],
    state: AdamState,
    u_ids: torch.Tensor,
    i_ids: torch.Tensor,
    config: TwoTowerConfig,
) -> torch.Tensor:
    """One training step on a batch of pair ids: look up and normalise
    both towers, the loss, its gradient with respect to both tables, and
    one adam update of the tables (in place). Returns the loss (on the
    device)."""
    ue = l2_normalize(tables[0][u_ids])
    ie = l2_normalize(tables[1][i_ids])
    loss = inbatch_loss(ue, ie, 1.0 / config.temperature, config.gemm_dtype, config.fused_ce)
    grads = torch.autograd.grad(loss, tables)
    adam_update(tables, grads, state, config.learning_rate)
    return loss.detach()


class _ShardedLookup(torch.autograd.Function):
    """Rows ``ids`` of a row-sharded table: each shard gathers the ids it
    owns (the others read its row 0 and are masked to zero) and the parts
    are summed on ``out``; the backward scatter-adds each shard's rows of
    the gradient into a ``[rows/S, D]`` tensor of its own."""

    @staticmethod
    def forward(ctx, ids: torch.Tensor, out: torch.device, rps: int, *shards: torch.Tensor) -> torch.Tensor:
        emb = None
        for s, shard in enumerate(shards):
            local = ids.to(shard.device) - s * rps
            inr = (local >= 0) & (local < rps)
            part = (shard.index_select(0, torch.where(inr, local, 0)) * inr[:, None]).to(out)
            emb = part if emb is None else emb + part
        ctx.save_for_backward(ids)
        ctx.rps = rps
        ctx.shapes = [(shard.shape, shard.device, shard.dtype) for shard in shards]
        return emb

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        grads = []
        for s, (shape, device, dtype) in enumerate(ctx.shapes):
            local = ids.to(device) - s * ctx.rps
            inr = (local >= 0) & (local < ctx.rps)
            g = torch.zeros(shape, device=device, dtype=dtype)
            g.index_add_(0, local[inr], grad.to(device)[inr])
            grads.append(g)
        return (None, None, None, *grads)


def sharded_embedding_lookup(table, ids: torch.Tensor) -> torch.Tensor:
    """Differentiable embedding lookup (the JAX package's
    ``sharded_embedding_lookup``): a plain tensor is ``table[ids]``; a
    :class:`~predictionio_tpu_torch.parallel.sharding.ShardedTable` gathers
    each id from its owner shard onto the table's lead device, and the
    gradient of each shard holds only that shard's rows. The values are
    the stored ones: every id has exactly one owner, the other shards add
    zeros."""
    if isinstance(table, torch.Tensor):
        return table[ids]
    return _ShardedLookup.apply(ids, table.mesh[0], table.rows_per_shard, *table.shards)


def _mesh_step(
    tables: Sequence[tuple],
    states: Sequence[AdamState],
    u_ids: torch.Tensor,
    i_ids: torch.Tensor,
    config: TwoTowerConfig,
    B: int,
) -> torch.Tensor:
    """One training step on a mesh: ``tables[d]`` is data position ``d``'s
    ``(user, item)`` sharded tables (identical on every position),
    ``u_ids``/``i_ids`` the global batch on the lead device. Each local
    data position takes its slice of the batch; its logits see the whole
    batch (the other local slices' embeddings copied in, other processes'
    looked up in its own tables); the table gradients are summed over the
    data positions and all-reduced across the processes, then every
    position takes the same Adam step. Returns the job's loss (lead)."""
    from predictionio_tpu_torch.parallel import distributed

    P, me = distributed.process_count(), distributed.process_index()
    D = len(tables)
    G = P * D
    Bp = B // G
    lead = tables[0][0].mesh[0]
    inv_temp = 1.0 / config.temperature

    def embed(d: int, g: int) -> tuple:
        ut, it = tables[d]
        dev = ut.mesh[0]
        sl = slice(g * Bp, (g + 1) * Bp)
        return (l2_normalize(sharded_embedding_lookup(ut, u_ids[sl].to(dev))),
                l2_normalize(sharded_embedding_lookup(it, i_ids[sl].to(dev))))

    own = [embed(d, me * D + d) for d in range(D)]
    loss = None
    for d in range(D):
        dev = tables[d][0].mesh[0]
        cols = [
            tuple(e.to(dev) for e in own[g - me * D]) if g // D == me else embed(d, g)
            for g in range(G)
        ]
        ue_all = torch.cat([c[0] for c in cols])
        ie_all = torch.cat([c[1] for c in cols])
        g = me * D + d
        labels = torch.arange(g * Bp, (g + 1) * Bp, device=dev)
        ue, ie = own[d]
        part = (
            F.cross_entropy(_logits(ue, ie_all, inv_temp, config.gemm_dtype), labels, reduction="sum")
            + F.cross_entropy(_logits(ie, ue_all, inv_temp, config.gemm_dtype), labels, reduction="sum")
        ) * (0.5 / B)
        loss = part.to(lead) if loss is None else loss + part.to(lead)
    leaves = [[s for tbl in tables[d] for s in tbl.shards] for d in range(D)]
    grads = torch.autograd.grad(loss, [leaf for row in leaves for leaf in row])
    n = len(leaves[0])
    summed = []
    for k in range(n):  # the psum over the data positions, then the processes
        g = grads[k]
        for d in range(1, D):
            g = g + grads[d * n + k].to(g.device)
        summed.append(distributed.all_reduce_(g))
    for d in range(D):
        adam_update(leaves[d], [g.to(leaf.device) for g, leaf in zip(summed, leaves[d])], states[d],
                    config.learning_rate)
    return distributed.all_reduce_(loss.detach().clone())


def _pad_rows(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_two_tower(
    rows: np.ndarray,
    cols: np.ndarray,
    num_users: int,
    num_items: int,
    config: TwoTowerConfig = TwoTowerConfig(),
    init_user: np.ndarray | None = None,
    init_item: np.ndarray | None = None,
    device: str | torch.device | None = None,
    mesh=None,
    data_axis: str = "data",
    model_axis: str = "model",
) -> TwoTowerModel:
    """Train user/item towers from implicit interaction pairs, on
    ``device`` (default: the card) or on ``mesh`` (a
    :class:`~predictionio_tpu_torch.controller.context.TrainingMesh`; one
    position is the single-device path there).

    ``rows[i]``/``cols[i]`` is one (user, item) interaction; in a
    multi-process job every process holds the same pairs (the batches are
    global, the tables are what shard). Returns L2-normalised tower
    vectors as host numpy. ``init_user``/``init_item`` (``[num_users, D]``
    / ``[num_items, D]``) replace the cold draw."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if rows.shape != cols.shape or rows.ndim != 1:
        raise ValueError("rows/cols must be equal-length 1-D arrays")
    if rows.size == 0:
        raise ValueError("two-tower training needs at least one interaction")
    if rows.min() < 0 or rows.max() >= num_users:
        raise ValueError("row index out of range")
    if cols.min() < 0 or cols.max() >= num_items:
        raise ValueError("column index out of range")
    if config.gemm_dtype not in GEMM_DTYPES:
        raise ValueError(f"gemm_dtype must be one of {GEMM_DTYPES}, got {config.gemm_dtype!r}")
    if config.fused_ce not in FUSED_CE_SETTINGS:
        raise ValueError(f"fused_ce must be one of {FUSED_CE_SETTINGS}, got {config.fused_ce!r}")
    if mesh is not None and mesh.size == 1:
        device, mesh = mesh.devices[0], None
    dev = resolve_device(device if mesh is None else mesh.devices[0])
    if dev.type == "cuda":
        # f32 products in full f32, as the JAX package's default precision
        torch.backends.cuda.matmul.allow_tf32 = False
    D, B = config.dim, config.batch_size
    if mesh is not None:
        B = _pad_rows(B, mesh.shape.get(data_axis, 1))

    # cold init at the unpadded shape from an explicit generator, on the
    # host so the card and the CPU (and every process) draw the same tables
    gen = torch.Generator().manual_seed(config.seed)
    scale = 1.0 / np.sqrt(D)
    host = []
    for name, init, n in (("user", init_user, num_users), ("item", init_item, num_items)):
        base = torch.randn((n, D), generator=gen, dtype=torch.float32) * scale
        if init is not None:
            init = np.asarray(init, np.float32)
            if init.shape != (n, D):
                raise ValueError(f"init_{name} must have shape {(n, D)}, got {init.shape}")
            base = torch.from_numpy(init.copy())
        host.append(base)
    if mesh is None:
        tables = [t.to(dev).requires_grad_(True) for t in host]
        state = AdamState(tables)
    else:
        from predictionio_tpu_torch.parallel.sharding import ServingMesh, shard_table

        positions = []
        for d in range(mesh.local_size // mesh.local(model_axis)):
            row = ServingMesh(mesh.row(d, model_axis))
            pair = tuple(shard_table(t.numpy(), row) for t in host)  # zero rows pad the split
            for tbl in pair:
                for shard in tbl.shards:
                    shard.requires_grad_(True)
            positions.append(pair)
        states = [AdamState([s for tbl in pair for s in tbl.shards]) for pair in positions]

    # pad to a whole number of batches by resampling real pairs (padding
    # with a sentinel would inject a fake item); upload once
    nnz = rows.size
    n_pad = _pad_rows(nnz, B)
    reps = np.arange(n_pad) % nnz
    t_ingest = time.perf_counter()
    r_base = torch.as_tensor(rows[reps], device=dev)
    c_base = torch.as_tensor(cols[reps], device=dev)
    _sync(dev)
    t_ingest = time.perf_counter() - t_ingest

    steps_per_epoch = n_pad // B
    total_steps = config.epochs * steps_per_epoch
    perm_gen = torch.Generator(device=dev).manual_seed(config.seed + 1)
    losses = torch.empty(steps_per_epoch, dtype=torch.float32, device=dev)
    history = []
    t_train = time.perf_counter()
    for epoch in range(config.epochs):
        # a fresh permutation every epoch: in-batch negatives come from the
        # batch, so a fixed batching would freeze each pair's negatives
        perm = torch.randperm(n_pad, generator=perm_gen, device=dev)
        r_all, c_all = r_base[perm], c_base[perm]
        for step in range(steps_per_epoch):
            sl = slice(step * B, (step + 1) * B)
            if mesh is None:
                losses[step] = train_step(tables, state, r_all[sl], c_all[sl], config)
            else:
                losses[step] = _mesh_step(positions, states, r_all[sl], c_all[sl], config, B)
        for i, loss in enumerate(losses.tolist()):  # one readback per epoch
            step = epoch * steps_per_epoch + i
            if step % config.log_every == 0 or step == total_steps - 1:
                history.append((step, float(loss)))
    _sync(dev)
    t_train = time.perf_counter() - t_train

    t_final = time.perf_counter()
    with torch.no_grad():
        if mesh is None:
            user_vecs = l2_normalize(tables[0]).cpu().numpy()
            item_vecs = l2_normalize(tables[1]).cpu().numpy()
        else:  # assembled on the host from data position 0's shards
            user_vecs = l2_normalize(torch.from_numpy(np.asarray(positions[0][0]))).numpy()[:num_users]
            item_vecs = l2_normalize(torch.from_numpy(np.asarray(positions[0][1]))).numpy()[:num_items]
    t_final = time.perf_counter() - t_final
    return TwoTowerModel(
        user_vecs=user_vecs,
        item_vecs=item_vecs,
        loss_history=tuple(history),
        timings={
            "ingest_seconds": round(t_ingest, 4),
            "train_seconds": round(t_train, 4),
            "finalize_seconds": round(t_final, 4),
        },
    )
