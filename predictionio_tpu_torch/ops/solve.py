"""Batched SPD solves — the ALS hot op, as a hand-written Hopper kernel.

Counterpart of ``predictionio_tpu/ops/solve.py``:

* :func:`gj_solve_cuda` — the kernel wrapper. On a CUDA tensor it
  launches ``ops/csrc/gj_solve.cu`` (Gauss-Jordan without pivoting: one
  warp per system with ``[A|b]`` in registers for K <= 64, one thread
  block per system above) and counts the launch in
  ``gj_solve_cuda.launches``; on a CPU tensor it takes the plain version.
  A failed launch raises: nothing falls back.
* :func:`gj_solve_plan` — the launch the kernel makes at a shape (shared
  bytes, threads, resident blocks per SM, grid), for measurement.
* :func:`gj_solve_reference` — the plain PyTorch mirror of the JAX
  package's ``_gj_kernel``: pivot blocks of P=8, each inverted by an
  unrolled GJ, then eliminated from every row by two rank-P products.
* :func:`cholesky_solve` — ``torch.linalg.cholesky`` + ``torch.cholesky_solve``,
  the path for the shapes the kernel does not take.
* :func:`spd_solve` — the JAX package's shape dispatch: K a multiple of 8
  and K <= 256 go to Gauss-Jordan, everything else to Cholesky.

Gauss-Jordan without pivoting is safe here: every ALS normal matrix is
SPD with an ALS-WR ridge (λ·max(n,1)·I), so the pivots stay away from 0.
All arithmetic is float32.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "PIVOT_BLOCK",
    "MAX_GJ_K",
    "SPD_METHODS",
    "spd_solve",
    "WARP_MAX_K",
    "gj_solve_cuda",
    "gj_solve_plan",
    "gj_solve_reference",
    "cholesky_solve",
]

#: pivot-block width of the plain mirror, and the K granularity the
#: Gauss-Jordan path takes (the JAX package's ``_PIVOT_BLOCK``)
PIVOT_BLOCK = 8

#: largest K the Gauss-Jordan path takes (the JAX package's ``_MAX_PALLAS_K``)
MAX_GJ_K = 256

#: largest K of the one-warp-per-system kernel (``gj_solve_warp_kernel``);
#: wider systems take the one-block-per-system kernel
WARP_MAX_K = 64

#: ``spd_solve`` methods: "auto" (kernel on CUDA, plain GJ on CPU),
#: "plain" (the plain GJ on any device)
SPD_METHODS = ("auto", "plain")


def cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve via Cholesky: A [.., K, K], b [.., K]."""
    L = torch.linalg.cholesky(A)
    return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)


def gj_solve_reference(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain blocked Gauss-Jordan solve of A [B,K,K] x = b [B,K] — the
    arithmetic of the JAX package's ``_gj_kernel`` on whole batches.

    Per pivot block: invert the [B,P,P] diagonal block with a P-step GJ,
    then clear its P columns from every row with two batched products.
    After K/P blocks A is the identity and b holds x."""
    P = PIVOT_BLOCK
    B, K = b.shape
    if K % P:
        raise ValueError(f"K={K} must be a multiple of {P}")
    A = A.clone()
    b = b.clone()
    eye = torch.eye(P, dtype=A.dtype, device=A.device)
    for s in range(0, K, P):
        R = A[:, s : s + P, :]  # pivot rows [B,P,K]
        rb = b[:, s : s + P]  # [B,P]
        M = R[:, :, s : s + P].clone()  # diagonal block [B,P,P]
        Di = eye.expand(B, P, P).clone()
        for j in range(P):
            inv = 1.0 / M[:, j, j]
            prow = M[:, j, :] * inv[:, None]
            irow = Di[:, j, :] * inv[:, None]
            f = M[:, :, j].clone()
            f[:, j] = 0.0
            M = M - f[:, :, None] * prow[:, None, :]
            Di = Di - f[:, :, None] * irow[:, None, :]
            M[:, j, :] = prow
            Di[:, j, :] = irow
        F = torch.bmm(A[:, :, s : s + P], Di)  # [B,K,P]
        # pivot rows take G = F - Di so they land on Di @ R (row-reduced
        # form); all other rows use F
        G = F.clone()
        G[:, s : s + P] -= Di
        A = A - torch.bmm(G, R)
        b = b - torch.bmm(G, rb[..., None])[..., 0]
    return b


def _check_kernel_args(A: torch.Tensor, b: torch.Tensor) -> None:
    if A.device.type != "cuda" or b.device != A.device:
        raise ValueError(f"gj_solve_cuda needs A and b on one CUDA device, got {A.device} and {b.device}")
    if A.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"gj_solve_cuda takes float32, got {A.dtype} and {b.dtype}")
    if A.dim() != 3 or b.dim() != 2 or A.shape[0] != b.shape[0]:
        raise ValueError(f"gj_solve_cuda takes A [B,K,K] and b [B,K], got {tuple(A.shape)} and {tuple(b.shape)}")
    K = b.shape[1]
    if A.shape[1] != K or A.shape[2] != K:
        raise ValueError(f"A {tuple(A.shape)} does not match b {tuple(b.shape)}")
    if K % PIVOT_BLOCK or not 0 < K <= MAX_GJ_K:
        raise ValueError(f"gj_solve_cuda takes K a multiple of {PIVOT_BLOCK} up to {MAX_GJ_K}, got K={K}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("gj_solve_cuda needs contiguous A and b")


def _kernel_lib() -> ctypes.CDLL:
    """The built ``ops/csrc/gj_solve.cu`` with its C signatures declared."""
    from predictionio_tpu_torch.ops import _build

    lib = _build.load("gj_solve")
    if lib.gj_solve_f32.argtypes is None:
        lib.gj_solve_scratch_floats.argtypes = [ctypes.c_longlong, ctypes.c_int]
        lib.gj_solve_scratch_floats.restype = ctypes.c_longlong
        lib.gj_solve_plan.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.gj_solve_plan.restype = ctypes.c_int
        lib.gj_solve_f32.restype = ctypes.c_int
        lib.gj_solve_f32.argtypes = [  # last: marks the library bound
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
    return lib


def gj_solve_cuda(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve A [B,K,K] x = b [B,K] by the hand-written CUDA
    Gauss-Jordan kernel. A CPU tensor takes :func:`gj_solve_reference`;
    a CUDA tensor launches the kernel (and counts it) or raises."""
    if A.device.type == "cpu":
        return gj_solve_reference(A, b)
    _check_kernel_args(A, b)
    lib = _kernel_lib()
    B, K = b.shape
    x = torch.empty_like(b)
    if B == 0:
        return x
    if K <= WARP_MAX_K and (A.data_ptr() % 16 or b.data_ptr() % 16):
        # the warp kernel copies 16-byte chunks: a view at an odd offset
        # is solved from an aligned copy
        A, b = A.clone(), b.clone()
    n_scratch = int(lib.gj_solve_scratch_floats(B, K))
    scratch = (
        torch.empty(n_scratch, dtype=torch.float32, device=A.device) if n_scratch else None
    )
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.gj_solve_f32(
            A.data_ptr(), b.data_ptr(), x.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, K, stream,
        )
    if err != 0:
        raise RuntimeError(f"gj_solve kernel launch failed: cudaError {err} at B={B}, K={K}")
    gj_solve_cuda.launches += 1
    return x


gj_solve_cuda.launches = 0


def gj_solve_plan(B: int, K: int, device: torch.device | str = "cuda") -> dict:
    """The launch :func:`gj_solve_cuda` makes for a ``[B,K,K]`` batch on
    ``device`` (a CUDA device): which kernel, its shared bytes and threads
    per block, resident blocks and warps per SM (the occupancy query), and
    the grid. Launches nothing."""
    lib = _kernel_lib()
    plan = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = lib.gj_solve_plan(B, K, plan)
    if err != 0:
        raise RuntimeError(f"gj_solve plan failed: cudaError {err} at B={B}, K={K}")
    smem, threads, per_sm, grid = plan
    return {
        "kernel": "warp" if K <= WARP_MAX_K else "block",
        "smem_per_block": smem, "threads_per_block": threads,
        "blocks_per_sm": per_sm, "warps_per_sm": per_sm * threads // 32, "grid": grid,
    }


def spd_solve(A: torch.Tensor, b: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """Batched SPD solve A [.., K, K] x = b [.., K].

    K a multiple of 8 and at most 256 goes to Gauss-Jordan: the CUDA
    kernel on a CUDA tensor, the plain mirror on the CPU, or the plain
    mirror everywhere when ``method="plain"``. Any other K takes
    :func:`cholesky_solve`."""
    if method not in SPD_METHODS:
        raise ValueError(f"spd_solve method must be one of {SPD_METHODS}, got {method!r}")
    K = A.shape[-1]
    if K % PIVOT_BLOCK == 0 and K <= MAX_GJ_K:
        A2 = A.reshape(-1, K, K).contiguous()
        b2 = b.reshape(-1, K).contiguous()
        solve = gj_solve_reference if method == "plain" else gj_solve_cuda
        return solve(A2, b2).reshape(b.shape)
    return cholesky_solve(A, b)
