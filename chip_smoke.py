"""Drive the PyTorch/CUDA port's two paths once on one NVIDIA card.

    python3 chip_smoke.py

The Recommendation path: ALS trains on ML-20M-shaped ratings (137,931
users x 27,027 items, 20M ratings, rank 64) through the hand-written CUDA
Gauss-Jordan solve kernel (one warp per system at rank 64), the trained model is served by the port's
query server, and 64 ``POST /queries.json`` requests are checked against
a float64 numpy top-10 of the same factors.

The Two-Tower path: the towers train on the JAX package bench's
planted-preference pairs (1M pairs over 20,000 users x 10,000 items,
dim 64, batch 8192, 10 epochs) through the hand-written CUDA fused
in-batch softmax-CE kernels (forward and backward), and the trained towers
answer 64 queries, checked against a float64 numpy top-10 with the seen
filter.

Phases, in order; any failure exits non-zero and prints no result:

1. device — the card's name, power limit and count; no CUDA device fails.
2. build  — every kernel built from ``predictionio_tpu_torch/ops/csrc``, one
   ``nvcc`` per source, all at once (``-Xptxas -v``: register and
   shared-memory lines printed; a spill in any function fails), and the
   count of tensor-core ``HMMA`` instructions in the built fused-CE
   library (``cuobjdump -sass``).
3. kernel — each kernel held against its plain PyTorch version and the
   library call at the shapes its path gives it, on inputs made on the
   card; times by CUDA events, and the host's time to issue a call. A
   solve row adds the launch plan (kernel, shared bytes per block, warps
   per SM, grid) and the achieved GB/s, then the K <= 64 kernel is timed
   per system at each of ``SOLVE_WIDTHS``. The fused-CE forward is one
   call (both sums), the backward one call of two launches (``d_ue``,
   then ``d_ie`` with the towers swapped); each row adds the achieved
   tensor-core FLOP/s and exponentials/s.
4. ALS    — the launch counts are set to 0, ``ALSAlgorithm.train`` runs on
   the card, the query server answers 64 queries, and the counts are read
   and checked against the bucket plan; then one user half-sweep is held
   against the same half-sweep with the plain solve, and one more sweep
   runs under torch.profiler: device time by kernel and busy share.
5. Two-Tower — the counts are set to 0, ``TwoTowerAlgorithm.train`` runs
   on the card and the counts are read and checked against the step plan;
   the loss must fall below 0.8x its first value and recall@10 on held-out
   pairs exceed 5x random; the query server answers 64 queries; one
   steady training step runs under torch.profiler.
6. a ``[summary]`` line, the ``{"kernels": [...]}`` line, the card's
   ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.

Imports only the port, torch, numpy and the standard library.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops.als import (
    ALSConfig,
    als_sweep,
    build_buckets,
    half_sweep,
    planned_solves,
    to_device_buckets,
)
from predictionio_tpu_torch.ops.fused_ce import (
    fused_ce_bwd_cuda,
    fused_ce_bwd_reference,
    fused_ce_fwd_cuda,
    fused_ce_fwd_reference,
    fused_inbatch_ce,
)
from predictionio_tpu_torch.ops.solve import cholesky_solve, gj_solve_cuda, gj_solve_plan, gj_solve_reference
from predictionio_tpu_torch.ops.twotower import AdamState, TwoTowerConfig, inbatch_loss, l2_normalize, train_step
from predictionio_tpu_torch.templates import twotower as tt
from predictionio_tpu_torch.templates.recommendation.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    Query,
    TrainingData,
)
from predictionio_tpu_torch.utils.movielens import ml20m_shaped
from predictionio_tpu_torch.utils.synthetic import distinct_pairs, planted_pairs
from predictionio_tpu_torch.workflow.serving import QueryServer

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32
#: (non-tensor-core) FLOP/s and dense bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

#: exponentials per SM per clock on compute capability 9.0 (the MUFU's
#: base-2 exponential; CUDA C++ Programming Guide, arithmetic instruction
#: throughput table); times SMs and the max SM clock read on the card
MUFU_PER_SM_PER_CLOCK = 16

#: the main path: ML-20M's 20M ratings, the flagship 10 sweeps at rank 64
#: (K % 8 == 0, so the kernel is on the path), 64 queries of top-10
NNZ = 20_000_000
SWEEPS = 10
RANK = 64
QUERIES = 64
TOP_K = 10

#: kernel-vs-plain tolerances (the JAX package's on-TPU solve checks)
MAX_REL_ERR = 1e-4
MAX_RESIDUAL = 1e-4

#: [B, K] solve shapes: the ALS chunk cap (chunk_rows), a width-192 user
#: chunk of the ML-20M run, a hot group, and the K=128 / K=256 regimes
SOLVE_SHAPES = ((32768, 64), (21840, 64), (2049, 64), (4096, 128), (64, 256))

#: widths of the one-warp-per-system kernel timed at the ALS chunk cap
SOLVE_WIDTHS = (16, 32, 48, 64)

#: the Two-Tower path: the JAX package bench's configuration
#: (bench.py::_bench_twotower at its accelerator scale)
TT_NNZ = 1_000_000
TT_DIM = 64
TT_BATCH = 8192
TT_EPOCHS = 10
TT_INV_TEMP = 10.0  # temperature 0.1
TT_RECALL_PROBE = 2048

#: [B, D] fused-CE shapes: the main path, the JAX package's on-TPU test
#: (tests/test_pallas_tpu.py), and twice the main path's batch
FUSED_CE_SHAPES = ((8192, 64), (1024, 32), (16384, 64))

#: fused CE kernel vs plain: row sums relative (largest and mean), gradient
#: passes against max|plain|. The kernel and cuBLAS sum a logit's dot
#: product in different orders, so a logit on a bf16 rounding boundary may
#: round to the other neighbour and move its exponential by up to 6.5 %
#: (tests/test_torch_gpu.py)
FUSED_SUM_RTOL = 2e-3
FUSED_SUM_MEAN_RTOL = 5e-5
FUSED_GRAD_ATOL = 5e-3

#: the kernels of both paths: wrapper, plain version, library call
KERNELS = {
    "gj_solve": {
        "route": "cuda",
        "source": "predictionio_tpu_torch/ops/csrc/gj_solve.cu",
        "replaces": "predictionio_tpu/ops/solve.py:95",
        "wrapper": gj_solve_cuda,
    },
    "fused_ce_fwd": {
        "route": "cuda",
        "source": "predictionio_tpu_torch/ops/csrc/fused_ce.cu",
        "replaces": "predictionio_tpu/ops/fused_ce.py:82",
        "wrapper": fused_ce_fwd_cuda,
    },
    "fused_ce_bwd": {
        "route": "cuda",
        "source": "predictionio_tpu_torch/ops/csrc/fused_ce.cu",
        "replaces": "predictionio_tpu/ops/fused_ce.py:111",
        "wrapper": fused_ce_bwd_cuda,
    },
}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_launch_counts() -> None:
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0


def read_launch_counts() -> dict:
    return {name: int(spec["wrapper"].launches) for name, spec in KERNELS.items()}


# --------------------------------------------------------------- 1. device
def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script runs on the card only")
    max_sm_mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    info = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "smi": _smi("name,power.limit"),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "sms": sms,
        "max_sm_mhz": max_sm_mhz,
        "exp_per_s": MUFU_PER_SM_PER_CLOCK * sms * max_sm_mhz * 1e6,
    }
    log(f"[device] {info['kind']} x{info['count']}  torch {info['torch']}  cuda {info['cuda']}  "
        f"{sms} SMs, max SM clock {max_sm_mhz:g} MHz")
    log(info["smi"])  # nvidia-smi: name, power.limit
    return info


# ---------------------------------------------------------------- 2. build
def ptxas_spills(out: str) -> list:
    """(function, spill store bytes, spill load bytes) for every function
    in nvcc's ``-Xptxas -v`` output: "N bytes spill stores" stands on a
    line of its own after "Function properties for <function>"."""
    spills, current = [], "?"
    for line in out.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills.append((current, int(m.group(1)), int(m.group(2))))
    return spills


def phase_build() -> None:
    t0 = time.perf_counter()
    names = sorted(_build.SOURCES)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        outputs = list(pool.map(_build.build, names))
    for name, out in zip(names, outputs):
        for line in out.splitlines():
            if "spill" in line or ("ptxas" in line and ("registers" in line or "smem" in line or "Compiling" in line)):
                log(f"[build] {name}: {line.strip()}")
        if not out:
            log(f"[build] {name}: library was built already; no ptxas lines")
        spilled = [s for s in ptxas_spills(out) if s[1] or s[2]]
        if spilled:
            raise RuntimeError(f"build: ptxas spills registers in {name}: {spilled}")
    log(f"[build] {names} built in {time.perf_counter() - t0:.3f} s into {_build.BUILD_DIR}; no spills")
    # the fused-CE kernels' products run on the tensor cores: count HMMA
    sass = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass", str(_build.lib_path("fused_ce"))],
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    hmma = sum(1 for line in sass.splitlines() if "HMMA" in line)
    log(f"[build] fused_ce: {hmma} HMMA instructions in the built library (cuobjdump -sass)")
    if hmma == 0:
        raise RuntimeError("build: the fused-CE library has no tensor-core (HMMA) instruction")


# ---------------------------------------------------------------- 3. kernel
def spd_batch(batch: int, k: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """ALS-shaped SPD systems made on the device: QQᵀ/K + 0.1·I."""
    gen = torch.Generator(device=device).manual_seed(seed)
    Q = torch.randn((batch, k, k), generator=gen, device=device)
    A = torch.bmm(Q, Q.transpose(1, 2)) / k
    A.diagonal(dim1=-2, dim2=-1).add_(0.1)
    b = torch.randn((batch, k), generator=gen, device=device)
    return A.contiguous(), b


def rel_err(xa: torch.Tensor, xb: torch.Tensor) -> float:
    num = (xa - xb).abs().amax(dim=-1)
    den = xb.abs().amax(dim=-1).clamp_min(1e-6)
    return float((num / den).max())


def residual(A: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> float:
    r = torch.bmm(A.double(), x.double()[..., None])[..., 0] - b.double()
    return float((r.norm(dim=-1) / b.double().norm(dim=-1).clamp_min(1e-6)).max())


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls
    after one warm-up call. The calls are issued back to back, so where a
    call's host work outlasts its kernels (small shapes) the host's pace
    sets this time: :func:`host_ms` says how much."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Mean host time to issue one call (the wrapper's Python, allocation
    and launches, not waiting for the card), over ``reps`` calls after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return issued * 1e3 / reps


def solve_bytes(batch: int, k: int) -> float:
    """Bytes a solve must move: A and b read once, x written once."""
    return 4.0 * batch * (k * k + 2 * k)


def solve_bound(batch: int, k: int) -> tuple[float, str]:
    """Least time for the solve on the card: :func:`solve_bytes` over the
    memory rate; Cholesky's K³/3 + 2K² FLOP per system over the f32 peak.
    Returns (ms, which bound)."""
    byte_ms = solve_bytes(batch, k) / PEAK_BYTES_PER_S * 1e3
    flop_ms = batch * (k**3 / 3 + 2 * k**2) / PEAK_F32_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= flop_ms else (flop_ms, "operations")


def phase_kernel(device) -> list:
    rows = []
    for i, (batch, k) in enumerate(SOLVE_SHAPES):
        A, b = spd_batch(batch, k, seed=100 + i, device=device)
        x = gj_solve_cuda(A, b)
        torch.cuda.synchronize()
        x_plain = gj_solve_reference(A, b)
        x_chol = cholesky_solve(A, b)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"gj_solve: non-finite solution at [{batch},{k},{k}]")
        err_plain = rel_err(x, x_plain)
        err_chol = rel_err(x, x_chol)
        res = residual(A, x, b)
        res_plain = residual(A, x_plain, b)
        max_abs = float((x - x_plain).abs().max())
        reps = 20 if batch * k * k <= (1 << 28) else 10
        ms = time_ms(lambda: gj_solve_cuda(A, b), reps)
        issue_ms = host_ms(lambda: gj_solve_cuda(A, b), reps)
        plain_ms = time_ms(lambda: gj_solve_reference(A, b), 3)
        library_ms = time_ms(lambda: cholesky_solve(A, b), 5)
        bound_ms, bound_by = solve_bound(batch, k)
        row = {
            "shape": [batch, k, k], "plan": gj_solve_plan(batch, k, device),
            "rel_err_plain": err_plain, "rel_err_cholesky": err_chol,
            "residual": res, "residual_plain": res_plain, "max_abs_err": max_abs, "ms": ms, "host_ms": issue_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # A and b read once, x written once, over the kernel's time
            "gb_per_s": solve_bytes(batch, k) / ms / 1e6, "bound_share": bound_ms / ms,
        }
        log(f"[kernel] gj_solve {json.dumps(row)}")
        if not (err_plain < MAX_REL_ERR and err_chol < MAX_REL_ERR and res < MAX_RESIDUAL):
            raise RuntimeError(
                f"gj_solve disagrees at [{batch},{k},{k}]: rel err vs plain {err_plain:.3g}, "
                f"vs cholesky {err_chol:.3g}, residual {res:.3g} (limit {MAX_REL_ERR:g})"
            )
        rows.append(row)
        del A, b, x, x_plain, x_chol
        torch.cuda.empty_cache()
    return rows


def phase_solve_widths(device) -> list:
    """The K <= 64 kernel at B = 32768 for each of ``SOLVE_WIDTHS``: time
    per system and FMA instructions a warp issues per ns, beside the plain
    mirror's agreement. The register kernel's code grows as K², so a time
    per system that rises faster than its instructions from K = 32 to K = 64
    points at instruction fetch."""
    rows = []
    batch = SOLVE_SHAPES[0][0]
    for k in SOLVE_WIDTHS:
        A, b = spd_batch(batch, k, seed=300 + k, device=device)
        err = rel_err(gj_solve_cuda(A, b), gj_solve_reference(A, b))
        ms = time_ms(lambda: gj_solve_cuda(A, b), 20)
        # a lane holds ceil(K/32) rows: each pivot p is that many FMA
        # instructions per column to its right (and b)
        fma_instr = -(-k // 32) * k * (k + 1) // 2 * batch
        row = {"shape": [batch, k, k], "rel_err_plain": err, "ms": ms, "ns_per_system": ms * 1e6 / batch,
               "fma_instr_per_ns": fma_instr / (ms * 1e6), "bound_ms": solve_bound(batch, k)[0]}
        log(f"[kernel] gj_solve width {json.dumps(row)}")
        if not err < MAX_REL_ERR:
            raise RuntimeError(f"gj_solve disagrees at [{batch},{k},{k}]: rel err vs plain {err:.3g}")
        rows.append(row)
        del A, b
        torch.cuda.empty_cache()
    return rows


def unit_towers(B: int, D: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """L2-normalised random towers ``[B, D]`` made on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ue = l2_normalize(torch.randn((B, D), generator=gen, device=device))
    ie = l2_normalize(torch.randn((B, D), generator=gen, device=device))
    return ue.contiguous(), ie.contiguous()


def fused_ce_bound(B: int, D: int, backward: bool, exp_per_s: float) -> tuple[float, str, str]:
    """Least time for one call of the TPU kernel's work (its CostEstimate:
    2·B²·D FLOP forward, 6·B²·D backward, B² exponentials each), the
    larger of FLOP over the bf16 tensor-core peak, exponentials over the
    MUFU rate, and bytes (towers and sums read once, outputs written once)
    over the memory rate. Returns (ms, "bytes"/"operations", the term)."""
    nbytes = 4 * (2 * B * D + 2 * B + (2 * B * D if backward else 0))
    terms = {
        "bytes": nbytes / PEAK_BYTES_PER_S,
        "flop": (6 if backward else 2) * B * B * D / PEAK_BF16_FLOPS,
        "exp": B * B / exp_per_s,
    }
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, "bytes" if term == "bytes" else "operations", term


def loss_and_grads(ue: torch.Tensor, ie: torch.Tensor, loss_fn) -> tuple[float, tuple]:
    u = ue.clone().requires_grad_(True)
    i = ie.clone().requires_grad_(True)
    loss = loss_fn(u, i)
    return float(loss.detach()), torch.autograd.grad(loss, (u, i))


def phase_fused_kernel(device, exp_per_s: float) -> list:
    """Both fused-CE kernels against their plain versions, and the fused
    loss against the unfused path, at each of ``FUSED_CE_SHAPES``."""
    T = TT_INV_TEMP
    rows = []
    for n, (B, D) in enumerate(FUSED_CE_SHAPES):
        ue, ie = unit_towers(B, D, 200 + n, device)
        rs, cs = fused_ce_fwd_cuda(ue, ie, T)
        due, die = fused_ce_bwd_cuda(ue, ie, rs, cs, T)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(t).all()) for t in (rs, cs, due, die)):
            raise RuntimeError(f"fused_ce: non-finite output at [{B},{D}]")
        sums = list(zip((rs, cs), fused_ce_fwd_reference(ue, ie, T)))
        grads = list(zip((due, die), fused_ce_bwd_reference(ue, ie, rs, cs, T)))
        sum_rel = max(float(((k - p).abs() / p.abs()).max()) for k, p in sums)
        sum_mean_rel = max(float(((k - p).abs() / p.abs()).mean()) for k, p in sums)
        grad_rel = max(float((k - p).abs().max() / p.abs().max()) for k, p in grads)
        fwd_abs = max(float((k - p).abs().max()) for k, p in sums)
        bwd_abs = max(float((k - p).abs().max()) for k, p in grads)
        del sums, grads
        # the loss and its gradients against the unfused path, at the JAX
        # package's on-TPU bar (tests/test_pallas_tpu.py)
        loss, g = loss_and_grads(ue, ie, lambda u, i: fused_inbatch_ce(u, i, T))
        ref, g_ref = loss_and_grads(ue, ie, lambda u, i: inbatch_loss(u, i, T, "bfloat16", "off"))
        loss_ok = abs(loss - ref) < 5e-3 * max(1.0, abs(ref))
        grads_ok = all(
            bool(torch.allclose(a, b, rtol=5e-2, atol=5e-3 * float(b.abs().max()))) for a, b in zip(g, g_ref)
        )
        off_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g, g_ref))
        del g, g_ref
        torch.cuda.empty_cache()

        reps = 20 if B <= 8192 else 10
        fwd_ms = time_ms(lambda: fused_ce_fwd_cuda(ue, ie, T), reps)
        bwd_ms = time_ms(lambda: fused_ce_bwd_cuda(ue, ie, rs, cs, T), reps)
        fwd_host_ms = host_ms(lambda: fused_ce_fwd_cuda(ue, ie, T), reps)
        bwd_host_ms = host_ms(lambda: fused_ce_bwd_cuda(ue, ie, rs, cs, T), reps)
        fwd_plain_ms = time_ms(lambda: fused_ce_fwd_reference(ue, ie, T), 3)
        bwd_plain_ms = time_ms(lambda: fused_ce_bwd_reference(ue, ie, rs, cs, T), 3)
        # the library calls: the unfused loss (two logit products and two
        # cross-entropies), and its backward by autograd
        fwd_lib_ms = time_ms(lambda: inbatch_loss(ue, ie, T, "bfloat16", "off"), 5)
        u, i = ue.clone().requires_grad_(True), ie.clone().requires_grad_(True)
        lib_loss = inbatch_loss(u, i, T, "bfloat16", "off")
        bwd_lib_ms = time_ms(lambda: torch.autograd.grad(lib_loss, (u, i), retain_graph=True), 5)
        del lib_loss, u, i
        torch.cuda.empty_cache()

        row = {"shape": [B, D], "loss": loss, "loss_unfused": ref, "grad_err_vs_unfused": off_err,
               "sum_mean_rel_err": sum_mean_rel}
        # what the kernels execute: the logit product over D padded to 16
        # (2·B²·Dp) once forward and in each of the two backward launches,
        # which add dL·b (2·B²·Dp); B² exponentials a launch
        dp = -(-D // 16) * 16
        for key, ms, issue_ms, plain_ms, lib_ms, err_abs, err_rel, backward, flop, exps in (
            ("fwd", fwd_ms, fwd_host_ms, fwd_plain_ms, fwd_lib_ms, fwd_abs, sum_rel, False, 2 * B * B * dp, B * B),
            ("bwd", bwd_ms, bwd_host_ms, bwd_plain_ms, bwd_lib_ms, bwd_abs, grad_rel, True, 8 * B * B * dp,
             2 * B * B),
        ):
            bound_ms, bound_by, term = fused_ce_bound(B, D, backward, exp_per_s)
            row[key] = {
                "max_abs_err": err_abs, "max_rel_err": err_rel, "ms": ms, "host_ms": issue_ms,
                "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_term": term, "tc_tflops": flop / ms / 1e9, "exp_per_s": exps / ms * 1e3,
            }
        log(f"[kernel] fused_ce {json.dumps(row)}")
        if not (sum_rel <= FUSED_SUM_RTOL and sum_mean_rel <= FUSED_SUM_MEAN_RTOL and grad_rel <= FUSED_GRAD_ATOL
                and loss_ok and grads_ok):
            raise RuntimeError(
                f"fused_ce disagrees at [{B},{D}]: sums rel err {sum_rel:.3g}, mean {sum_mean_rel:.3g} "
                f"(limits {FUSED_SUM_RTOL:g}, {FUSED_SUM_MEAN_RTOL:g}), "
                f"gradient passes {grad_rel:.3g} of max (limit {FUSED_GRAD_ATOL:g}), loss {loss} vs unfused "
                f"{ref}, gradients within the on-TPU bar: {grads_ok}"
            )
        rows.append(row)
        del ue, ie, rs, cs, due, die
        torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------- 4. ALS train
def train_rmse(U: torch.Tensor, V: torch.Tensor, r: torch.Tensor, c: torch.Tensor, v: torch.Tensor) -> float:
    se = torch.zeros((), dtype=torch.float64, device=U.device)
    step = 1 << 22
    for lo in range(0, r.numel(), step):
        pred = (U[r[lo : lo + step]] * V[c[lo : lo + step]]).sum(dim=-1)
        se += ((pred - v[lo : lo + step]).double() ** 2).sum()
    return float(torch.sqrt(se / r.numel()))


def phase_train(device, nnz: int, sweeps: int, rank: int) -> dict:
    t0 = time.perf_counter()
    rows, cols, vals, num_users, num_items = ml20m_shaped(nnz, seed=5)
    td = TrainingData(
        rows=rows, cols=cols, vals=vals,
        user_index=BiMap.string_index(str(i) for i in range(num_users)),
        item_index=BiMap.string_index(str(i) for i in range(num_items)),
    )
    log(f"[train] data: {num_users} users x {num_items} items, {rows.size} ratings "
        f"({time.perf_counter() - t0:.3f} s)")
    params = ALSAlgorithmParams(rank=rank, num_iterations=sweeps, lambda_=0.01, seed=3)
    cfg = ALSConfig(rank=rank)
    expected = sweeps * (
        planned_solves(rows, num_users, cfg) + planned_solves(cols, num_items, cfg)
    )
    algo = ALSAlgorithm(params, device=device)
    r_d = torch.as_tensor(rows, device=device)
    c_d = torch.as_tensor(cols, device=device)
    v_d = torch.as_tensor(vals, device=device)
    marks: list = []  # (step, time at sweep end, rmse)
    clock = {"t": None}

    def on_sweep(step: int, U: torch.Tensor, V: torch.Tensor) -> None:
        torch.cuda.synchronize(device)
        t_end = time.perf_counter()
        rmse = train_rmse(U, V, r_d, c_d, v_d)
        sweep_s = None if clock["t"] is None else t_end - clock["t"]
        marks.append({"sweep": step + 1, "seconds": sweep_s, "rmse": rmse})
        log(f"[train] sweep {step + 1}: rmse {rmse:.6f}"
            + ("" if sweep_s is None else f", {sweep_s:.4f} s"))
        clock["t"] = time.perf_counter()

    algo.on_sweep = on_sweep
    torch.cuda.reset_peak_memory_stats(device)
    t1 = time.perf_counter()
    model = algo.train(td)
    torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated(device)
    U, V = model.user_factors, model.item_factors
    if not (np.isfinite(U).all() and np.isfinite(V).all()):
        raise RuntimeError("train: non-finite factors")
    if U.shape != (num_users, rank) or V.shape != (num_items, rank):
        raise RuntimeError(f"train: factor shapes {U.shape}, {V.shape}")
    if not marks[-1]["rmse"] < marks[0]["rmse"]:
        raise RuntimeError(f"train: rmse did not fall ({marks[0]['rmse']} -> {marks[-1]['rmse']})")
    steady = [m["seconds"] for m in marks if m["seconds"] is not None]
    log(f"[train] {sweeps} sweeps at rank {rank} in {train_s:.3f} s "
        f"(sweep 1 incl. bucketing and upload; later sweeps {steady}); "
        f"peak device memory {peak / 2**30:.3f} GiB")
    return {
        "algo": algo, "model": model, "td": td, "expected_launches": expected,
        "sweeps": marks, "train_s": train_s, "peak_bytes": peak,
        "ratings_per_s": rows.size * len(steady) / sum(steady) if steady else None,
    }


# ----------------------------------------------------------------- 4. ALS serve
def reference_top(
    U64: np.ndarray, V64: np.ndarray, uidx: int, k: int, exclude: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """The float64 top-k of one user, ties to the lower index, without the
    items in ``exclude``; and all the user's scores."""
    scores = V64 @ U64[uidx]
    order = np.lexsort((np.arange(scores.size), -scores))
    if exclude is not None and exclude.size:
        order = order[~np.isin(order, exclude)]
    return order[:k], scores


def check_ranking(got: list, ref: np.ndarray, scores: np.ndarray, rtol: float = 1e-5) -> bool:
    """Item ids equal the reference's, except where the two differing
    items' float64 scores are within ``rtol`` (relative) — a near-tie."""
    if len(got) != len(ref):
        return False
    for g, r in zip(got, ref):
        if g != r and abs(scores[g] - scores[r]) > rtol * max(abs(scores[r]), 1e-12):
            return False
    return True


def phase_serve(algo, model, td, U64: np.ndarray, V64: np.ndarray, n_queries: int, k: int, card: str,
                seed: int = 11) -> dict:
    """``n_queries`` single queries of top-``k`` over HTTP for distinct
    random users (ids ``str(i)`` for index ``i``), each held against the
    float64 numpy top-``k`` of ``U64``/``V64`` without the user's seen
    items (``td.seen``, where the template filters them); then the same
    queries through ``predict`` alone."""
    seen = getattr(td, "seen", None)
    rng = np.random.default_rng(seed)
    users = rng.choice(len(td.user_index), size=n_queries, replace=False)
    lat = []
    bad = []
    with QueryServer(algo, model) as server:
        for u in users:
            body = json.dumps({"user": str(u), "num": k}).encode()
            req = urllib.request.Request(
                server.url + "/queries.json", data=body,
                headers={"Content-Type": "application/json"}, method="POST",
            )
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=60) as resp:
                status = resp.status
                payload = json.loads(resp.read())
            lat.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise RuntimeError(f"serve: status {status} for user {u}")
            got = [td.item_index[s["item"]] for s in payload["itemScores"]]
            exclude = None
            if seen is not None:
                exclude = np.array([td.item_index[i] for i in seen.get(str(u), ())], dtype=np.int64)
            ref, scores = reference_top(U64, V64, int(u), k, exclude)
            if not check_ranking(got, ref, scores):
                bad.append((int(u), got, ref.tolist()))
    if bad:
        raise RuntimeError(f"serve: {len(bad)} of {n_queries} top-{k} lists differ from float64 numpy: {bad[:3]}")
    # the same queries through predict alone, on this (warmed) thread: the
    # part of the HTTP latency that scoring and top-k take
    pred = []
    for u in users:
        t0 = time.perf_counter()
        algo.predict(model, algo.query_class(user=str(u), num=k))
        pred.append((time.perf_counter() - t0) * 1e3)
    p50, p99 = np.percentile(lat, [50, 99])
    pp50, pp99 = np.percentile(pred, [50, 99])
    log(f"[serve] {type(algo).__name__}: {n_queries} POST /queries.json, all 200, top-{k} equal float64 numpy"
        f"{' without seen items' if seen is not None else ''}; p50 {p50:.3f} ms, p99 {p99:.3f} ms; "
        f"predict alone p50 {pp50:.3f} ms, p99 {pp99:.3f} ms on {card}")
    return {"p50_ms": float(p50), "p99_ms": float(p99),
            "predict_p50_ms": float(pp50), "predict_p99_ms": float(pp99)}


def phase_als_serve(trained: dict, n_queries: int, k: int, card: str) -> dict:
    algo, td = trained["algo"], trained["td"]
    U64 = trained["model"].user_factors.astype(np.float64)
    V64 = trained["model"].item_factors.astype(np.float64)
    model = algo.prepare_model_for_serving(trained["model"])
    return dict(phase_serve(algo, model, td, U64, V64, n_queries, k, card), model=model)


def phase_half_sweep(trained: dict, device, rank: int) -> tuple:
    """One user half-sweep from the trained factors: kernel solve vs the
    plain solve on the card (rtol 5e-3, atol 5e-4). Returns the factor
    tables (with the zero sentinel row) and both sides' device buckets."""
    td = trained["td"]
    cfg = ALSConfig(rank=rank)
    kw = dict(widths=cfg.bucket_widths, chunk_entries=cfg.chunk_entries,
              hot_group_slots=cfg.hot_group_slots)
    U, I = len(td.user_index), len(td.item_index)
    ub = to_device_buckets(build_buckets(td.rows, td.cols, td.vals, U, I, **kw), device)
    ib = to_device_buckets(build_buckets(td.cols, td.rows, td.vals, I, U, **kw), device)
    model = trained["model"]
    zero = torch.zeros((1, rank), device=device)
    uf = torch.cat([model.user_factors, zero])
    vf = torch.cat([model.item_factors, zero])
    with torch.no_grad():
        got = half_sweep(uf.clone(), vf, ub, 0.01, False, 1.0, "auto")
        ref = half_sweep(uf.clone(), vf, ub, 0.01, False, 1.0, "plain")
    torch.cuda.synchronize(device)
    torch.testing.assert_close(got, ref, rtol=5e-3, atol=5e-4)
    log(f"[train] user half-sweep, kernel vs plain solve: max abs diff {float((got - ref).abs().max()):.3g}")
    return uf, vf, ub, ib


def profile_once(fn, label: str) -> dict:
    """Device time by kernel and the device's busy share of the wall time
    of one call of ``fn`` (which ends in a synchronise) under
    torch.profiler, after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", 0) or 0
        if us > 0:
            kernels.append((us / 1e3, evt.count, evt.key))
    kernels.sort(reverse=True)
    busy_ms = sum(ms for ms, _, _ in kernels)
    if not kernels:
        log(f"[profile] {label} wall {wall_ms:.3f} ms; device time not measured (the profiler saw no CUDA kernels)")
        return {"wall_ms": wall_ms, "busy_share": None}
    out = {
        "what": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
        "device_ops": sum(n for _, n, _ in kernels),
        "top": [{"kernel": name[:90], "ms": ms, "calls": n, "share": ms / busy_ms}
                for ms, n, name in kernels[:8]],
    }
    log(f"[profile] {json.dumps(out)}")
    return out


def phase_profile(uf, vf, ub, ib, device) -> dict:
    """Where one steady ALS sweep spends the card's time."""

    def sweep() -> None:
        als_sweep(uf.clone(), vf.clone(), ub, ib, 0.01, False, 1.0)
        torch.cuda.synchronize(device)

    return profile_once(sweep, "one steady ALS sweep")


# ------------------------------------------------------------ 5. Two-Tower
def tt_training_data(nnz: int):
    """The bench's planted pairs, deduplicated as the Two-Tower DataSource
    does, as a ``TrainingData`` (ids ``str(i)`` for every index) with each
    user's seen items; and the held-out pairs."""
    r_tr, c_tr, r_te, c_te, num_users, num_items = planted_pairs(nnz, seed=11)
    rows, cols = distinct_pairs(r_tr, c_tr, num_items)
    starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
    item_ids = np.array([str(i) for i in range(num_items)], dtype=object)
    seen = {
        str(u): set(group)
        for u, group in zip(rows[starts].tolist(), np.split(item_ids[cols], starts[1:]))
    }
    td = tt.TrainingData(
        rows=rows, cols=cols,
        user_index=BiMap.string_index(str(u) for u in range(num_users)),
        item_index=BiMap.string_index(item_ids.tolist()),
        seen=seen,
    )
    return td, r_te, c_te, num_items


def recall_at_10(user_vecs: np.ndarray, item_vecs: np.ndarray, r_te, c_te, device) -> float:
    """Share of the first ``TT_RECALL_PROBE`` held-out pairs whose item is in
    the user's top-10 over all items (bench.py::_bench_twotower)."""
    probe = min(TT_RECALL_PROBE, r_te.size)
    pu = torch.as_tensor(r_te[:probe], device=device)
    pi = torch.as_tensor(c_te[:probe], device=device)
    uv = torch.as_tensor(user_vecs, device=device)
    iv = torch.as_tensor(item_vecs, device=device)
    top = torch.topk(uv[pu] @ iv.T, 10, dim=1).indices
    return float((top == pi[:, None]).any(dim=1).float().mean())


def phase_tt_train(device, nnz: int, dim: int, batch: int, epochs: int) -> dict:
    t0 = time.perf_counter()
    td, r_te, c_te, num_items = tt_training_data(nnz)
    n = td.rows.size
    log(f"[tt-train] data: {len(td.user_index)} users x {num_items} items, {nnz} pairs, {n} distinct "
        f"({time.perf_counter() - t0:.3f} s)")
    params = tt.TwoTowerParams(embedding_dim=dim, batch_size=batch, epochs=epochs,
                               learning_rate=0.05, temperature=1.0 / TT_INV_TEMP, seed=2)
    algo = tt.TwoTowerAlgorithm(params, device=device)
    steps = epochs * -(-n // batch)
    torch.cuda.reset_peak_memory_stats(device)
    t1 = time.perf_counter()
    model = algo.train(td)
    torch.cuda.synchronize(device)
    wall_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated(device)
    if not (np.isfinite(model.user_vecs).all() and np.isfinite(model.item_vecs).all()):
        raise RuntimeError("tt-train: non-finite towers")
    if model.user_vecs.shape != (len(td.user_index), dim) or model.item_vecs.shape != (num_items, dim):
        raise RuntimeError(f"tt-train: tower shapes {model.user_vecs.shape}, {model.item_vecs.shape}")
    hist = model.loss_history
    loss_first, loss_last = hist[0][1], hist[-1][1]
    if not loss_last < 0.8 * loss_first:
        raise RuntimeError(f"tt-train: loss did not fall below 0.8x its first value ({loss_first} -> {loss_last})")
    recall = recall_at_10(model.user_vecs, model.item_vecs, r_te, c_te, device)
    random_recall = 10.0 / num_items
    if not recall > 5 * random_recall:
        raise RuntimeError(f"tt-train: recall@10 {recall} is not above 5x random ({random_recall})")
    train_s = model.timings["train_seconds"]
    out = {
        "pairs": n, "steps": steps, "train_s": train_s, "wall_s": wall_s,
        "interactions_per_s": n * epochs / train_s, "steps_per_s": steps / train_s,
        "loss_first": loss_first, "loss_last": loss_last, "recall_at_10": recall,
        "random_recall_at_10": random_recall, "peak_gib": peak / 2**30, "timings": dict(model.timings),
    }
    log(f"[tt-train] {json.dumps(out)}")
    return dict(out, algo=algo, model=model, td=td, params=params,
                expected_launches={"fused_ce_fwd": steps, "fused_ce_bwd": 2 * steps})


def phase_tt_serve(trained: dict, n_queries: int, k: int, card: str) -> dict:
    algo, td = trained["algo"], trained["td"]
    U64 = trained["model"].user_vecs.astype(np.float64)
    V64 = trained["model"].item_vecs.astype(np.float64)
    model = algo.prepare_model_for_serving(trained["model"])
    return dict(phase_serve(algo, model, td, U64, V64, n_queries, k, card, seed=12), model=model)


def phase_tt_profile(trained: dict, device) -> dict:
    """Where one steady Two-Tower training step spends the card's time: a
    step on a random batch of the pairs, from the trained towers."""
    p, model, td = trained["params"], trained["model"], trained["td"]
    cfg = TwoTowerConfig(dim=p.embedding_dim, batch_size=p.batch_size, learning_rate=p.learning_rate,
                         temperature=p.temperature, seed=p.seed)
    tables = [model.user_vecs.clone().requires_grad_(True), model.item_vecs.clone().requires_grad_(True)]
    state = AdamState(tables)
    gen = torch.Generator(device=device).manual_seed(3)
    pick = torch.randint(0, td.rows.size, (p.batch_size,), generator=gen, device=device)
    u_ids = torch.as_tensor(td.rows, device=device)[pick]
    i_ids = torch.as_tensor(td.cols, device=device)[pick]

    def step() -> None:
        train_step(tables, state, u_ids, i_ids, cfg)
        torch.cuda.synchronize(device)

    return profile_once(step, "one steady Two-Tower training step")


def check_launches(path: str, launches: dict, expected: dict) -> None:
    log(f"[{path}] launches on the path: {json.dumps({k: launches[k] for k in expected})}, "
        f"plan {json.dumps(expected)}")
    for name, want in expected.items():
        if launches[name] != want or launches[name] == 0:
            raise RuntimeError(f"{path}: {name} launched {launches[name]} times, the plan says {want}")


def kernel_row(name: str, launches: int, m: dict) -> dict:
    spec = KERNELS[name]
    return {
        "name": name, "route": spec["route"], "source": spec["source"], "replaces": spec["replaces"],
        "launches": launches, "max_abs_err": m["max_abs_err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"], "bound_by": m["bound_by"], "library_ms": m["library_ms"],
    }


def main() -> int:
    t_start = time.perf_counter()
    info = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    solve_rows = phase_kernel(device)
    phase_solve_widths(device)
    fused_rows = phase_fused_kernel(device, info["exp_per_s"])

    # the Recommendation path
    reset_launch_counts()
    trained = phase_train(device, NNZ, SWEEPS, RANK)
    served = phase_als_serve(trained, QUERIES, TOP_K, info["kind"])
    als_launches = read_launch_counts()
    check_launches("train", als_launches, {"gj_solve": trained["expected_launches"]})
    trained["model"] = served["model"]
    profile = phase_profile(*phase_half_sweep(trained, device, RANK), device)

    # the Two-Tower path
    reset_launch_counts()
    tt_trained = phase_tt_train(device, TT_NNZ, TT_DIM, TT_BATCH, TT_EPOCHS)
    tt_launches = read_launch_counts()
    check_launches("tt-train", tt_launches, tt_trained["expected_launches"])
    tt_served = phase_tt_serve(tt_trained, QUERIES, TOP_K, info["kind"])
    tt_trained["model"] = tt_served["model"]
    tt_profile = phase_tt_profile(tt_trained, device)

    main_fused = fused_rows[0]  # [8192, 64], the Two-Tower path's shape
    kernels = [
        kernel_row("gj_solve", als_launches["gj_solve"], solve_rows[0]),
        kernel_row("fused_ce_fwd", tt_launches["fused_ce_fwd"], main_fused["fwd"]),
        kernel_row("fused_ce_bwd", tt_launches["fused_ce_bwd"], main_fused["bwd"]),
    ]
    summary = {
        "card": info["smi"], "nnz": NNZ, "rank": RANK, "sweeps": len(trained["sweeps"]),
        "rmse_first": trained["sweeps"][0]["rmse"], "rmse_last": trained["sweeps"][-1]["rmse"],
        "train_s": trained["train_s"], "ratings_per_s": trained["ratings_per_s"],
        "peak_gib": trained["peak_bytes"] / 2**30,
        "p50_ms": served["p50_ms"], "p99_ms": served["p99_ms"],
        "predict_p50_ms": served["predict_p50_ms"], "predict_p99_ms": served["predict_p99_ms"],
        "sweep_busy_share": profile["busy_share"],
        "tt": {
            "pairs": tt_trained["pairs"], "dim": TT_DIM, "batch": TT_BATCH, "epochs": TT_EPOCHS,
            "steps": tt_trained["steps"], "train_s": tt_trained["train_s"],
            "interactions_per_s": tt_trained["interactions_per_s"], "steps_per_s": tt_trained["steps_per_s"],
            "loss_first": tt_trained["loss_first"], "loss_last": tt_trained["loss_last"],
            "recall_at_10": tt_trained["recall_at_10"], "peak_gib": tt_trained["peak_gib"],
            "p50_ms": tt_served["p50_ms"], "p99_ms": tt_served["p99_ms"],
            "predict_p50_ms": tt_served["predict_p50_ms"], "predict_p99_ms": tt_served["predict_p99_ms"],
            "step_busy_share": tt_profile["busy_share"],
        },
        "wall_s": time.perf_counter() - t_start,
    }
    log(f"[summary] {json.dumps(summary)}")
    log(json.dumps({"kernels": kernels}))
    log(info["smi"])
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
