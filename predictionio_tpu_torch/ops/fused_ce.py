"""Fused in-batch softmax cross-entropy — the Two-Tower loss, as two
hand-written Hopper kernels.

Counterpart of ``predictionio_tpu/ops/fused_ce.py``. The symmetric
in-batch loss of L2-normalised towers ``ue, ie [B, D]``::

    0.5 * (ce(ue·ieᵀ·t, arange) + ce(ie·ueᵀ·t, arange))

is computed without ever holding the ``[B, B]`` logits in device memory
(268 MB in f32 at B=8192). Its arithmetic is the JAX kernel's: bf16
operands with f32 accumulation, logits rounded to bf16, ``exp`` rounded to
bf16, no running max (the towers are L2-normalised, so a logit is at most
``inv_temp`` <= ``MAX_INV_TEMP``).

* :func:`fused_ce_fwd_reference` / :func:`fused_ce_bwd_reference` — the
  plain PyTorch versions of that arithmetic, on whole ``[B, B]`` tiles.
* :func:`fused_ce_fwd_cuda` / :func:`fused_ce_bwd_cuda` — the kernel
  wrappers. On a CUDA tensor each launches ``ops/csrc/fused_ce.cu`` and
  counts the kernel's launches in its ``.launches`` (one forward, two
  backward); on a CPU tensor it takes the plain version. A failed launch raises: nothing falls back.
  They take every shape :func:`fused_ce_supported` accepts: above
  ``NARROW_KERNEL_D`` the kernels walk D in chunks and the backward splits
  it into slices (:func:`kernel_d_slices`).
* :func:`fused_inbatch_ce` — the loss as a ``torch.autograd.Function``.

The forward is one pass, as the TPU kernel is: it returns both the row
sums ``rs`` and the column sums ``cs`` of the exponentiated logit tile,
summed in a fixed order without atomics. The backward's ``d_ue`` and
``d_ie`` come from two launches of one call, the second with the towers
swapped, ``d_ie = bwd(ie, ue, cs, rs)``: a one-pass ``d_ie`` would need
``[B/128, B, D]`` partial sums (134 MB at B=8192, D=64). Two calls on the
same input give bit-identical outputs.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "MAX_INV_TEMP",
    "ROW_BLOCK",
    "NARROW_KERNEL_D",
    "kernel_d_slices",
    "kernel_shape_error",
    "FUSED_CE_MODES",
    "fused_ce_supported",
    "fused_ce_fwd_reference",
    "fused_ce_bwd_reference",
    "fused_ce_fwd_cuda",
    "fused_ce_bwd_cuda",
    "choose_splits",
    "fused_inbatch_ce",
]

#: rows of the batch per block of the JAX kernel's grid; B must be a
#: multiple (the JAX package's ``_TI``)
ROW_BLOCK = 128

#: the kernels carry no running max, so exp(inv_temp) * B must stay finite
#: in f32: inv_temp <= 60 leaves exp(60) * 2^20 ~ 1.2e32 (the JAX package's
#: ``MAX_INV_TEMP``)
MAX_INV_TEMP = 60.0

#: widest tower of the CUDA kernels' full-width path (``kNarrowD`` in
#: ops/csrc/fused_ce.cu). Above it the logit product walks D in chunks of
#: 128 columns, and the backward grid splits D into slices of at most this
#: many columns: a warp keeps its ``[16, slice]`` gradient rows in
#: registers, 128 per thread at 256
NARROW_KERNEL_D = 256

#: rows of ``b`` per forward column tile (``kCols`` in
#: ops/csrc/fused_ce.cu; a CUDA block owns ``ROW_BLOCK`` rows of ``a``,
#: ``kRows`` there)
_KERNEL_COLS = 64

#: most column splits a launch takes (partial sums summed in split order)
_MAX_SPLITS = 16

#: ``fused_inbatch_ce`` modes: "auto" (the kernels on CUDA, the plain
#: versions on the CPU), "interpret" (the plain versions on any device)
FUSED_CE_MODES = ("auto", "interpret")


def fused_ce_supported(B: int, D: int, inv_temp: float = 1.0) -> bool:
    """Shapes/scales the fused loss handles: whole row blocks, D a
    multiple of 8, and a temperature that cannot overflow the max-free
    exp (the JAX package's answers, case for case)."""
    return (
        B % ROW_BLOCK == 0
        and D % 8 == 0
        and B >= ROW_BLOCK
        and 0.0 < inv_temp <= MAX_INV_TEMP
    )


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 and back: the kernels' operand rounding."""
    return x.to(torch.bfloat16).to(torch.float32)


def _exp_tile(a16: torch.Tensor, b16: torch.Tensor, inv_temp: float) -> torch.Tensor:
    """``bf16(exp(bf16(a16·b16ᵀ·inv_temp)))`` as f32, whole ``[B, B]``: a
    product of two bf16 values is exact in f32, so the f32 product of the
    rounded operands is the bf16 product with f32 accumulation."""
    logits = (a16 @ b16.T) * inv_temp
    return torch.exp(logits.to(torch.bfloat16)).to(torch.float32)


def fused_ce_fwd_reference(
    a: torch.Tensor, b: torch.Tensor, inv_temp: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row and column sums ``([B], [B])`` of the exponentiated logit tile
    of ``a, b [B, D]``: ``(rs, cs)`` for ``(ue, ie)``, from one tile."""
    e = _exp_tile(_bf16(a), _bf16(b), inv_temp)
    return e.sum(dim=1), e.sum(dim=0)


def fused_ce_bwd_reference(
    a: torch.Tensor, b: torch.Tensor, r: torch.Tensor, s: torch.Tensor, inv_temp: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The softmax part of the loss's gradients with respect to ``a`` and
    ``b``, from one tile: ``dL = bf16(e·(c/r_i) + e·(c/s_j))`` with ``c =
    0.5·inv_temp/B``, then ``(dL·bf16(b), dLᵀ·bf16(a))``. ``(ue, ie, rs,
    cs)`` gives ``(d_ue, d_ie)``, as the JAX kernel's ``_bwd_call``."""
    a16, b16 = _bf16(a), _bf16(b)
    e = _exp_tile(a16, b16, inv_temp)
    c = torch.full((), 0.5 * inv_temp / a.shape[0], dtype=torch.float32, device=a.device)
    # true divisions (a scalar over a tensor would be a reciprocal times c)
    dl = _bf16(e * (c / r)[:, None] + e * (c / s)[None, :])
    return dl @ b16, dl.T @ a16


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def kernel_d_slices(D: int) -> int:
    """D-slices of one backward launch at width D (its grid's third
    dimension; ``d_slices`` in ops/csrc/fused_ce.cu)."""
    if D <= NARROW_KERNEL_D:
        return 1
    return -(-(-(-D // 16) * 16) // NARROW_KERNEL_D)


def kernel_shape_error(B: int, D: int, inv_temp: float, splits: int = 1) -> str | None:
    """Why the CUDA kernels refuse ``[B, D]`` at ``inv_temp`` with
    ``splits`` column splits, or None: the C entries' ``bad_shape`` and
    the temperature bound, a function of the shape alone."""
    if not fused_ce_supported(B, D, inv_temp):
        return (f"takes B a multiple of {ROW_BLOCK}, D a multiple of 8 and 0 < inv_temp <= {MAX_INV_TEMP}, "
                f"got B={B}, D={D}, inv_temp={inv_temp}")
    if not 1 <= splits <= B // _KERNEL_COLS:
        return f"takes 1 to {B // _KERNEL_COLS} column splits at B={B}, got {splits}"
    return None


def _check_kernel_args(name: str, tensors: tuple, inv_temp: float) -> tuple[int, int]:
    a = tensors[0]
    if a.device.type != "cuda" or any(t.device != a.device for t in tensors):
        raise ValueError(f"{name} needs every tensor on one CUDA device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes float32, got {[t.dtype for t in tensors]}")
    if a.dim() != 2 or tensors[1].shape != a.shape:
        raise ValueError(f"{name} takes a and b of one shape [B, D], got {[tuple(t.shape) for t in tensors[:2]]}")
    B, D = a.shape
    if any(t.shape != (B,) for t in tensors[2:]):
        raise ValueError(f"{name} takes row sums of shape [{B}], got {[tuple(t.shape) for t in tensors[2:]]}")
    refused = kernel_shape_error(B, D, inv_temp)
    if refused:
        raise ValueError(f"{name} {refused}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors[:2]):
        raise ValueError(f"{name} needs a and b aligned to 16 bytes (the kernel reads float4)")
    return B, D


def _kernel_lib() -> ctypes.CDLL:
    """The built ``ops/csrc/fused_ce.cu`` with its C signatures declared."""
    from predictionio_tpu_torch.ops import _build

    lib = _build.load("fused_ce")
    if lib.fused_ce_bwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_ce_workspace.argtypes = [i, i, i, i]
        lib.fused_ce_workspace.restype = ctypes.c_size_t
        lib.fused_ce_capacity.argtypes = [i, i]
        lib.fused_ce_capacity.restype = i
        lib.fused_ce_fwd.argtypes = [p, p, p, p, i, i, i, f, p]
        lib.fused_ce_fwd.restype = i
        lib.fused_ce_bwd.restype = i
        lib.fused_ce_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, f, f, p]  # last: marks the library bound
    return lib


def choose_splits(row_blocks: int, tiles: int, capacity: int) -> int:
    """Column splits per row block. The launch has ``row_blocks * S``
    blocks, a block walks at most ``ceil(tiles / S)`` column tiles, and the
    card holds ``capacity`` blocks at once, so the launch takes about
    ``waves * ceil(tiles / S)`` tile times. Returns the smallest S (at most
    ``tiles`` and 16) within 10 % of the least such time: more splits mean
    more partial sums to add, for a gain in the last wave."""
    costs = [
        -(-row_blocks * s // capacity) * -(-tiles // s) for s in range(1, min(tiles, _MAX_SPLITS) + 1)
    ]
    best = min(costs)
    return next(s for s, cost in enumerate(costs, start=1) if cost <= 1.1 * best)


_capacity: dict = {}  # (device index, D, backward) -> resident blocks on the card


def _splits_and_workspace(
    lib: ctypes.CDLL, device: torch.device, B: int, D: int, backward: bool
) -> tuple[int, torch.Tensor]:
    """Column splits for one call, from the kernel's occupancy on the
    current device, and a workspace of the bytes the call needs (bf16
    copies of the towers, partial-sum slabs), allocated for this call."""
    key = (device.index, D, backward)
    cap = _capacity.get(key)
    if cap is None:
        cap = int(lib.fused_ce_capacity(D, int(backward)))
        if cap <= 0:
            raise RuntimeError(f"fused_ce occupancy query failed: cudaError {-cap} at D={D}")
        _capacity[key] = cap
    # a wide backward launch has a block per row block, split and D-slice
    row_blocks = B // ROW_BLOCK * (kernel_d_slices(D) if backward else 1)
    splits = choose_splits(row_blocks, B // _KERNEL_COLS, cap)
    nbytes = int(lib.fused_ce_workspace(B, D, splits, int(backward)))
    return splits, torch.empty(nbytes, dtype=torch.uint8, device=device)


def fused_ce_fwd_cuda(a: torch.Tensor, b: torch.Tensor, inv_temp: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Row and column sums ``(rs, cs)`` by the hand-written CUDA forward
    kernel, in one pass. A CPU tensor takes :func:`fused_ce_fwd_reference`;
    a CUDA tensor launches the kernel (and counts it) or raises."""
    if a.device.type == "cpu":
        return fused_ce_fwd_reference(a, b, inv_temp)
    B, D = _check_kernel_args("fused_ce_fwd_cuda", (a, b), inv_temp)
    lib = _kernel_lib()
    with torch.cuda.device(a.device):
        splits, work = _splits_and_workspace(lib, a.device, B, D, backward=False)
        sums = torch.empty((2, B), dtype=torch.float32, device=a.device)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.fused_ce_fwd(
            a.data_ptr(), b.data_ptr(), sums.data_ptr(), work.data_ptr(), B, D, splits, inv_temp, stream
        )
    if err != 0:
        raise RuntimeError(f"fused_ce forward kernel launch failed: cudaError {err} at B={B}, D={D}")
    fused_ce_fwd_cuda.launches += 1
    return sums.unbind(0)


fused_ce_fwd_cuda.launches = 0


def fused_ce_bwd_cuda(
    a: torch.Tensor, b: torch.Tensor, r: torch.Tensor, s: torch.Tensor, inv_temp: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(d_a, d_b)`` ``[B, D]`` by the hand-written CUDA backward kernel,
    launched twice: ``d_a = bwd(a, b, r, s)``, then ``d_b = bwd(b, a, s,
    r)`` on the same bf16 copies of the towers. A CPU tensor takes
    :func:`fused_ce_bwd_reference`; a CUDA tensor launches the kernel (and
    counts both launches) or raises."""
    if a.device.type == "cpu":
        return fused_ce_bwd_reference(a, b, r, s, inv_temp)
    B, D = _check_kernel_args("fused_ce_bwd_cuda", (a, b, r, s), inv_temp)
    lib = _kernel_lib()
    with torch.cuda.device(a.device):
        splits, work = _splits_and_workspace(lib, a.device, B, D, backward=True)
        out = torch.empty((2, B, D), dtype=torch.float32, device=a.device)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.fused_ce_bwd(
            a.data_ptr(), b.data_ptr(), r.data_ptr(), s.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            work.data_ptr(), B, D, splits, inv_temp, 0.5 * inv_temp / B, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_ce backward kernel launch failed: cudaError {err} at B={B}, D={D}")
    fused_ce_bwd_cuda.launches += 2
    return out.unbind(0)


fused_ce_bwd_cuda.launches = 0


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------


class _FusedInbatchCE(torch.autograd.Function):
    """Forward: one pass for both sums, then the loss closed outside the
    kernel, ``0.5/B·(Σ log rs + Σ log cs − 2 Σ diag)``, with the positive
    logits ``diag`` the rowwise dot in f32. Backward: one call for both
    gradient passes, then the positive pair's ``−(inv_temp/B)·(ie, ue)`` correction
    and the upstream gradient, also outside the kernels."""

    @staticmethod
    def forward(ctx, ue, ie, inv_temp, mode):
        fwd = fused_ce_fwd_reference if mode == "interpret" else fused_ce_fwd_cuda
        ue, ie = ue.contiguous(), ie.contiguous()
        rs, cs = fwd(ue, ie, inv_temp)
        B = ue.shape[0]
        diag = (ue * ie).sum(dim=1) * inv_temp
        loss = 0.5 * (rs.log().sum() + cs.log().sum() - 2.0 * diag.sum()) / B
        ctx.save_for_backward(ue, ie, rs, cs)
        ctx.inv_temp, ctx.mode = inv_temp, mode
        return loss

    @staticmethod
    def backward(ctx, g):
        ue, ie, rs, cs = ctx.saved_tensors
        inv_temp = ctx.inv_temp
        bwd = fused_ce_bwd_reference if ctx.mode == "interpret" else fused_ce_bwd_cuda
        due, die = bwd(ue, ie, rs, cs, inv_temp)
        c2 = inv_temp / ue.shape[0]
        return (due - c2 * ie) * g, (die - c2 * ue) * g, None, None


def fused_inbatch_ce(
    ue: torch.Tensor, ie: torch.Tensor, inv_temp: float, mode: str = "auto"
) -> torch.Tensor:
    """Mean symmetric in-batch softmax CE of L2-normalised towers ``ue, ie
    [B, D]`` (``fused_ce_supported(B, D, inv_temp)`` must hold), with the
    kernels' bf16 arithmetic. ``mode="auto"`` runs the CUDA kernels on a
    CUDA tensor and the plain versions on the CPU; ``"interpret"`` runs the
    plain versions anywhere."""
    if mode not in FUSED_CE_MODES:
        raise ValueError(f"fused_inbatch_ce mode must be one of {FUSED_CE_MODES}, got {mode!r}")
    B, D = ue.shape
    if not fused_ce_supported(B, D, inv_temp):
        raise ValueError(f"fused_inbatch_ce does not take B={B}, D={D}, inv_temp={inv_temp}")
    return _FusedInbatchCE.apply(ue, ie, inv_temp, mode)
