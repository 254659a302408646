"""Batched SPD solves — the ALS hot op, as a hand-written Hopper kernel.

Counterpart of ``predictionio_tpu/ops/solve.py``:

* :func:`gj_solve_cuda` — the kernel wrapper. On a CUDA tensor it
  launches ``ops/csrc/gj_solve.cu`` (Gauss-Jordan without pivoting: one
  warp per system with ``[A|b]`` in registers for K <= 64; above, the
  blocked elimination of the JAX package's kernel with A in registers,
  one thread block a system to K = 128 and a cluster of two or four
  above) and counts the launch in ``gj_solve_cuda.launches``; on a CPU
  tensor it takes the plain version. A failed launch raises: nothing
  falls back.
* :func:`gj_solve_plan` — the launch the kernel makes at a shape (kernel,
  shared bytes, threads, cluster, resident blocks per SM, grid,
  registers), for measurement.
* :func:`gj_solve_reference` — the plain PyTorch mirror of the JAX
  package's ``_gj_kernel``: pivot blocks of P=8, each inverted by an
  unrolled GJ, then eliminated from every row by two rank-P products.
  The plain version of the warp kernel (K <= 64), which eliminates one
  pivot at a time.
* :func:`gj_solve_wide_reference` — the plain version of the kernel
  above K = 64: the same pivot blocks, but the pivot rows become
  ``Di @ R`` where ``_gj_kernel`` takes ``R - (D Di - Di) R``, which
  cancels where the pivots are large (ALS Gramians of much-rated items).
  :func:`gj_solve_plain` picks the plain version of a width.
* :func:`cholesky_solve` — ``torch.linalg.cholesky`` + ``torch.cholesky_solve``,
  the path for the shapes the kernel does not take; :func:`cholesky_solve_ex`
  is the same solve without the error check's host sync (the online
  fold-in's, ``online/foldin.py``).
* :func:`spd_solve` — the JAX package's shape dispatch: K a multiple of 8
  and K <= 256 go to Gauss-Jordan, everything else to Cholesky; a method
  forces the kernel, its plain mirror or Cholesky (``ALSConfig.solver``).

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
    "gj_solve_wide_reference",
    "gj_solve_plain",
    "cholesky_solve",
    "cholesky_solve_ex",
]

#: pivot-block width of the plain mirror, and the K granularity the
#: Gauss-Jordan path takes (the JAX package's ``_PIVOT_BLOCK``)
PIVOT_BLOCK = 8

#: largest K the Gauss-Jordan path takes (the JAX package's ``_MAX_PALLAS_K``)
MAX_GJ_K = 256

#: largest K of the one-warp-per-system kernel (``gj_solve_warp_kernel``);
#: wider systems take the blocked kernel (``gj_solve_tile_kernel``)
WARP_MAX_K = 64

#: ``spd_solve`` methods: "auto" (kernel on CUDA, plain GJ on CPU),
#: "plain" (the kernel's plain GJ on any device), "kernel" (the kernel; a CPU
#: tensor raises), "cholesky" (Cholesky at every K)
SPD_METHODS = ("auto", "plain", "kernel", "cholesky")


def cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve via Cholesky: A [.., K, K], b [.., K]."""
    L = torch.linalg.cholesky(A)
    return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)


def cholesky_solve_ex(A: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`cholesky_solve` without the host sync of its error check:
    ``(x, info)``, where ``info[..] > 0`` marks a system that is not
    positive definite (its row of ``x`` is then no solution). The caller
    reads ``info`` when it reads ``x``."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1), info


def _blocked_gj(A: torch.Tensor, b: torch.Tensor, pivot_rows_di: bool) -> torch.Tensor:
    """Blocked Gauss-Jordan of A [B,K,K] x = b [B,K] in pivot blocks of P:
    Di, the inverse of the [B,P,P] diagonal block, by a P-step GJ; then
    ``F = C Di`` (C the block's P columns of every row) and every row less
    ``F R`` (R the pivot rows). The pivot rows become ``Di R`` with
    ``pivot_rows_di``, else ``R - (D Di - Di) R`` as ``_gj_kernel`` takes
    them. After K/P blocks A is the identity and b holds x."""
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
        if pivot_rows_di:
            A_next = A - torch.bmm(F, R)
            b_next = b - torch.bmm(F, rb[..., None])[..., 0]
            A_next[:, s : s + P] = torch.bmm(Di, R)
            b_next[:, s : s + P] = torch.bmm(Di, rb[..., None])[..., 0]
            A, b = A_next, b_next
        else:
            # pivot rows take G = F - Di so they land on Di @ R (row-reduced
            # form); all other rows use F
            G = F.clone()
            G[:, s : s + P] -= Di
            A = A - torch.bmm(G, R)
            b = b - torch.bmm(G, rb[..., None])[..., 0]
    return b


def gj_solve_reference(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain blocked Gauss-Jordan solve of A [B,K,K] x = b [B,K] — the
    arithmetic of the JAX package's ``_gj_kernel`` on whole batches
    (:func:`_blocked_gj` with the pivot rows ``R - (D Di - Di) R``)."""
    return _blocked_gj(A, b, pivot_rows_di=False)


def gj_solve_wide_reference(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain blocked Gauss-Jordan solve of A [B,K,K] x = b [B,K] — the
    arithmetic of the kernel above K = 64 on whole batches
    (:func:`_blocked_gj` with the pivot rows ``Di R``). The pivot rows of
    :func:`gj_solve_reference` lose their leading digits where the pivots
    are large: R and ``(D Di - Di) R`` then agree in them."""
    return _blocked_gj(A, b, pivot_rows_di=True)


def gj_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernel that :func:`gj_solve_cuda` launches
    at this width: :func:`gj_solve_reference` to K = ``WARP_MAX_K``,
    :func:`gj_solve_wide_reference` above."""
    return (gj_solve_reference if b.shape[-1] <= WARP_MAX_K else gj_solve_wide_reference)(A, b)


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
        lib.gj_solve_plan.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.gj_solve_plan.restype = ctypes.c_int
        lib.gj_solve_f32.restype = ctypes.c_int
        lib.gj_solve_f32.argtypes = [  # last: marks the library bound
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
    return lib


def gj_solve_cuda(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve A [B,K,K] x = b [B,K] by the hand-written CUDA
    Gauss-Jordan kernel. A CPU tensor takes its plain version
    (:func:`gj_solve_plain`); a CUDA tensor launches the kernel (and
    counts it) or raises."""
    if A.device.type == "cpu":
        return gj_solve_plain(A, b)
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
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.gj_solve_f32(A.data_ptr(), b.data_ptr(), x.data_ptr(), B, K, stream)
    if err != 0:
        raise RuntimeError(f"gj_solve kernel launch failed: cudaError {err} at B={B}, K={K}")
    gj_solve_cuda.launches += 1
    return x


gj_solve_cuda.launches = 0


def gj_solve_plan(B: int, K: int, device: torch.device | str = "cuda") -> dict:
    """The launch :func:`gj_solve_cuda` makes for a ``[B,K,K]`` batch on
    ``device`` (a CUDA device): which kernel, its shared bytes and threads
    per block, the blocks of a cluster (one system's), resident blocks and
    warps per SM (the occupancy query), the grid and a thread's
    registers. Launches nothing."""
    lib = _kernel_lib()
    plan = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = lib.gj_solve_plan(B, K, plan)
    if err != 0:
        raise RuntimeError(f"gj_solve plan failed: cudaError {err} at B={B}, K={K}")
    smem, threads, per_sm, grid, cluster, registers = plan
    return {
        "kernel": "gj_solve_warp_kernel" if K <= WARP_MAX_K else "gj_solve_tile_kernel",
        "smem_per_block": smem, "threads_per_block": threads, "cluster": cluster,
        "blocks_per_sm": per_sm, "warps_per_sm": per_sm * -(-threads // 32), "grid": grid,
        "registers": registers,
    }


def spd_solve(A: torch.Tensor, b: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """Batched SPD solve A [.., K, K] x = b [.., K].

    K a multiple of 8 and at most 256 goes to Gauss-Jordan: the CUDA
    kernel on a CUDA tensor, its plain version (:func:`gj_solve_plain`)
    on the CPU, or the plain version everywhere when ``method="plain"``;
    ``method="kernel"`` takes
    the kernel and raises on a CPU tensor. Any other K, and every K with
    ``method="cholesky"``, takes :func:`cholesky_solve`."""
    if method not in SPD_METHODS:
        raise ValueError(f"spd_solve method must be one of {SPD_METHODS}, got {method!r}")
    if method == "kernel" and A.device.type != "cuda":
        raise ValueError(f"spd_solve method 'kernel' launches the CUDA kernel; A is on {A.device}")
    K = A.shape[-1]
    if method != "cholesky" and K % PIVOT_BLOCK == 0 and K <= MAX_GJ_K:
        A2 = A.reshape(-1, K, K).contiguous()
        b2 = b.reshape(-1, K).contiguous()
        solve = gj_solve_plain if method == "plain" else gj_solve_cuda
        return solve(A2, b2).reshape(b.shape)
    return cholesky_solve(A, b)
