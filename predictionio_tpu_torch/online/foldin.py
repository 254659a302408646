"""Batched ALS fold-in — re-solve only the touched rows.

Counterpart of ``predictionio_tpu/online/foldin.py``. The classic
MLlib-era incremental update: with the opposite-side factors ``Y`` held
FIXED, the least-squares optimum for one row is independent of every
other row, so fresh events only require re-solving the rows they
touched::

    x_u = argmin_x  ||r_u - Y_u x||^2  +  reg * n_u * ||x||^2
                    +  prior_weight * ||x - x_old||^2

The ``prior_weight`` anchor keeps a row near its trained optimum while
its online-observed history is still thin; cold-start rows (entities the
model has never seen) use ``x_old = 0`` with no anchor.

:func:`foldin_solve` is the JAX package's ``_foldin_kernel`` as a plain
function on tensors: the normal equations from the pre-gathered opposite
rows (masked products), the ALS-WR ridge ``reg * max(n, 1)`` plus the
anchor, and the port's Cholesky solve. Implicit-feedback models add the
``YtY`` Gramian and confidence weights (MLlib ``implicitPrefs``
fold-in). The JAX package's shapes are kept: rows solve in chunks of
exactly :data:`B_CHUNK`, the rating window pads to a power-of-two width
bucket (floor 8, at most :data:`MAX_WIDTH`, most recent entries kept).

Two things differ from the JAX package, both about systems that are not
positive definite (``torch.linalg.cholesky`` raises where XLA's Cholesky
returns NaN):

* a chunk's padding rows solve the identity system (``x = 0``), so a
  ``lambda = 0`` fold, whose padding systems are all zero, solves its
  real rows exactly as the reference does;
* a REAL row whose system is not positive definite (``lambda = 0``, no
  anchor and fewer independent ratings than the rank) raises
  :class:`NotPositiveDefiniteError` naming it, where the JAX package
  returns a NaN row and serves it. The solve is
  :func:`~predictionio_tpu_torch.ops.solve.cholesky_solve_ex`, whose
  per-system status is read with the rows, so the check adds no host
  sync of its own.

The device is explicit: the rows solve on ``device`` (the algorithm's),
whatever holds the opposite table. The gather of the opposite rows runs
where the table lives (a host fancy-index for numpy, one
``index_select`` for a tensor, the gathered rows dequantized for an int8
table), so a host table on a card deploy still
folds on the card. ``run(fn, *args)`` runs each chunk's torch calls (the
query server passes its ``run_on_device``); building the padded systems
stays on the caller's thread.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.solve import cholesky_solve_ex

__all__ = ["B_CHUNK", "MAX_WIDTH", "NotPositiveDefiniteError", "foldin_rows", "foldin_solve", "gram_yty"]

#: floor for the padded per-row rating width buckets
_MIN_BUCKET = 8
#: widest per-row rating window the solve takes; heavier histories keep
#: their most recent entries (a bounded window keeps one fold's latency
#: flat as an entity's online history grows)
MAX_WIDTH = 512
#: fixed solve-batch shape: every call chunks its rows into batches of
#: exactly this many (padded), the JAX package's shape
B_CHUNK = 128


class NotPositiveDefiniteError(ValueError):
    """A real row's normal equations are not positive definite (see the
    module docstring)."""


def _bucket(n: int, floor: int = _MIN_BUCKET) -> int:
    return max(floor, 1 << (max(1, n) - 1).bit_length())


def _direct(fn: Callable, *args: Any) -> Any:
    return fn(*args)


def foldin_solve(
    Yg: torch.Tensor,  # [B, L, K] pre-gathered opposite rows
    val: torch.Tensor,  # [B, L] ratings
    mask: torch.Tensor,  # [B, L] 1 = real entry
    prior: torch.Tensor,  # [B, K] anchor rows (0 for cold starts)
    prior_w: torch.Tensor,  # [B] per-row anchor strength
    reg: float,
    alpha: float,
    yty: torch.Tensor | None,  # [K, K], implicit only
    implicit: bool,
    n_real: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve the anchored normal equations of rows ``[0, n_real)`` of a
    padded chunk; rows from ``n_real`` on are padding and solve ``I x =
    0``. Returns ``(x [B, K], info [B])``; ``info > 0`` marks a system
    that is not positive definite."""
    Yg = Yg * mask[..., None]  # masked entries zero out
    n = mask.sum(dim=-1)  # [B]
    K = Yg.shape[-1]
    Yt = Yg.transpose(1, 2)  # [B, K, L]
    eye = torch.eye(K, dtype=Yg.dtype, device=Yg.device)
    if implicit:
        # MLlib implicit fold-in: A = YtY + alpha * sum r y y^T,
        # b = sum (1 + alpha r) y  (preference 1 for every observed pair)
        A = torch.bmm(Yt * (alpha * val)[:, None, :], Yg) + yty[None]
        b = torch.bmm(Yt, ((1.0 + alpha * val) * mask)[..., None])[..., 0]
    else:
        A = torch.bmm(Yt, Yg)
        b = torch.bmm(Yt, (val * mask)[..., None])[..., 0]
    ridge = reg * torch.clamp(n, min=1.0) + prior_w  # ALS-WR + anchor
    A = A + ridge[:, None, None] * eye
    b = b + prior_w[:, None] * prior
    A[n_real:] = eye
    b[n_real:] = 0.0
    return cholesky_solve_ex(A, b)


def gram_yty(opposite):
    """``Y^T Y`` of the opposite factors — computed once per model
    generation by implicit-model callers. A tensor table gives a tensor
    on its own device (an int8 table its dequantized rows'); a numpy
    table the JAX package's float32 numpy."""
    if not isinstance(opposite, (torch.Tensor, np.ndarray)):
        # an int8 or a sharded table (the serving tiers): its rows as one
        # tensor on its (lead) device
        opposite = opposite[:]
    if isinstance(opposite, torch.Tensor):
        Y = opposite.to(torch.float32)
        return Y.T @ Y
    Y = np.asarray(opposite, dtype=np.float32)
    return Y.T @ Y


def _solve_chunk(Y, idx, val, mask, pr, pw, reg, alpha, yty, implicit, n_real, device):
    """One chunk's torch calls: gather where the table lives, solve on
    ``device``, read the rows and their status back to the host."""
    B, L = idx.shape
    K = int(Y.shape[1])
    if isinstance(Y, np.ndarray):
        Yg = torch.from_numpy(np.asarray(Y, np.float32)[idx.reshape(-1)]).to(device)
    elif isinstance(Y, torch.Tensor):
        rows = Y.index_select(0, torch.from_numpy(idx.reshape(-1)).to(Y.device))
        Yg = rows.to(device=device, dtype=torch.float32)
    else:
        # an int8 table (--quantize: only the gathered rows dequantize) or a
        # sharded one (--shard-factors: each row from its owner shard)
        Yg = torch.as_tensor(Y[idx.reshape(-1)]).to(device=device, dtype=torch.float32)

    def placed(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    yty_t = torch.as_tensor(yty, dtype=torch.float32).to(device) if implicit else None
    x, info = foldin_solve(
        Yg.reshape(B, L, K), placed(val), placed(mask), placed(pr), placed(pw), reg, alpha, yty_t, implicit, n_real
    )
    return x.cpu().numpy(), info.cpu().numpy()


def foldin_rows(
    opposite,
    entries: list[tuple[list[int], list[float]]],
    reg: float,
    priors: np.ndarray | None = None,
    prior_weights: np.ndarray | None = None,
    implicit: bool = False,
    alpha: float = 1.0,
    yty=None,
    *,
    device: str | torch.device | None = None,
    run: Callable | None = None,
) -> np.ndarray:
    """Re-solve a batch of rows against fixed ``opposite`` factors.

    ``entries[i] = (opposite row indices, ratings)`` is row ``i``'s full
    online-observed history (rows beyond :data:`MAX_WIDTH` keep their
    most recent entries — callers append chronologically). ``priors``
    [B, K] / ``prior_weights`` [B] anchor each solve to its previous row
    (omit or pass weight 0 for pure fold-in / cold starts). Returns the
    solved rows ``[B, K]`` float32 on the host.

    ``device`` is where the rows solve: by default a tensor table's own
    device, and the card for a numpy table (the port's rule). ``run``
    runs each chunk's torch calls (default: on the calling thread)."""
    Y = opposite
    if device is None and not isinstance(Y, np.ndarray):
        device = Y.device  # a tensor's, an int8 table's, a sharded table's lead
    device = resolve_device(device)
    run = run or _direct
    B = len(entries)
    K = int(Y.shape[1])
    if B == 0:
        return np.zeros((0, K), np.float32)
    width = min(MAX_WIDTH, max(len(ix) for ix, _ in entries))
    L = _bucket(width)
    if implicit and yty is None:
        yty = np.zeros((K, K), np.float32)
    priors = None if priors is None else np.asarray(priors, np.float32)
    prior_weights = None if prior_weights is None else np.asarray(prior_weights, np.float32)
    out_parts = []
    for lo in range(0, B, B_CHUNK):
        part = entries[lo : lo + B_CHUNK]
        n = len(part)
        idx = np.zeros((B_CHUNK, L), np.int64)
        val = np.zeros((B_CHUNK, L), np.float32)
        mask = np.zeros((B_CHUNK, L), np.float32)
        for i, (ix, vs) in enumerate(part):
            if len(ix) > L:  # keep the most recent window
                ix, vs = ix[-L:], vs[-L:]
            m = len(ix)
            if m == 0:
                continue
            idx[i, :m] = ix
            val[i, :m] = vs
            mask[i, :m] = 1.0
        pr = np.zeros((B_CHUNK, K), np.float32)
        pw = np.zeros(B_CHUNK, np.float32)
        if priors is not None:
            pr[:n] = priors[lo : lo + B_CHUNK]
        if prior_weights is not None:
            pw[:n] = prior_weights[lo : lo + B_CHUNK]
        x, info = run(_solve_chunk, Y, idx, val, mask, pr, pw, float(reg), float(alpha), yty, implicit, n, device)
        bad = np.flatnonzero(info[:n])
        if bad.size:
            raise NotPositiveDefiniteError(
                f"fold-in rows {(bad + lo).tolist()[:8]} have normal equations that are not positive "
                f"definite (lambda={reg}, prior weights {pw[bad].tolist()[:8]}, "
                f"{mask[bad].sum(axis=1).astype(int).tolist()[:8]} ratings at rank {K})"
            )
        out_parts.append(x[:n])
    return np.concatenate(out_parts, axis=0)
