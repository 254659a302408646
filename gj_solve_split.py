"""Split the time of the port's K <= 64 Gauss-Jordan solve kernel on one
NVIDIA card, by timing copies of its source with one part taken out.

    python3 gj_solve_split.py

Each copy of ``predictionio_tpu_torch/ops/csrc/gj_solve.cu`` is compiled
with the flags of ``ops/_build.py`` (all at once) into ``build/gj_split/``
and timed at ``[32768, K, K]`` for each K of ``WIDTHS`` by
``chip_smoke.time_ms``:

* ``kernel``       — the source as it is;
* ``no_load``      — without the copy of each warp's next system: a warp
  solves its first system again and again, so this is the elimination
  without device-memory traffic (its ``x`` is wrong);
* ``no_elim``      — without the elimination: the copies in, the moves into
  registers and the stores of ``x`` (its ``x`` is wrong);
* ``min_blocks_3`` — ``__launch_bounds__(128, 3)`` (168 registers a
  thread, 3 blocks a SM) in place of ``(128, 2)``.

Prints each copy's registers per K and ptxas spills and, per shape, its time
and whether its ``x`` is bit-equal to the kernel's. Exits non-zero without
a card.

    python3 gj_solve_split.py --against OTHER/gj_solve.cu

also builds another version of the source (the parent commit's, say) and,
at each of ``chip_smoke.SOLVE_SHAPES`` on chip_smoke's inputs, times it and
the kernel in turns in this one process (other, kernel, kernel, other) and
says whether their ``x`` are bit-equal.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke
from predictionio_tpu_torch.ops import _build

WIDTHS = (64, 32)
BATCH = 32768
SPLIT_DIR = _build.BUILD_DIR.parent / "gj_split"

#: copy name -> (text in gj_solve.cu, its replacement)
CUTS = {
    "kernel": None,
    "no_load": ("    if (sys + stride < B) stage_system<K>(stage, A, b, sys + stride, lane);\n", ""),
    "no_elim": ("    eliminate<K, 0>(M, diag, pivot_rows, lane);\n", ""),
    "min_blocks_3": ("constexpr int kWarpMinBlocks = 2;", "constexpr int kWarpMinBlocks = 3;"),
}


def cut_source(name: str) -> str:
    """gj_solve.cu with copy ``name``'s part taken out."""
    src = _build.SOURCES["gj_solve"].read_text()
    cut = CUTS[name]
    if cut is not None:
        if cut[0] not in src:
            raise RuntimeError(f"{name}: {cut[0].strip()!r} is not in gj_solve.cu")
        src = src.replace(cut[0], cut[1])
    return src


def build(name: str, src: str) -> tuple[str, str]:
    """Compile ``src`` as copy ``name``; returns its library path and ptxas lines."""
    SPLIT_DIR.mkdir(parents=True, exist_ok=True)
    cu = SPLIT_DIR / f"{name}.cu"
    cu.write_text(src)
    lib = SPLIT_DIR / f"lib{name}.so"
    proc = subprocess.run(
        [_build.cuda_tool("nvcc"), *_build._NVCC_FLAGS, "-I", str(_build._CSRC), "-o", str(lib), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    return str(lib), proc.stdout


def warp_registers(ptxas: str) -> dict:
    """K -> registers a thread of ``gj_solve_warp_kernel<K>``, from ptxas."""
    regs, width = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Function properties for \S*warp_kernelILi(\d+)E", line)
        if m:
            width = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and width is not None:
            regs[width] = int(m.group(1))
            width = None
    return regs


def solver(path: str):
    lib = ctypes.CDLL(path)
    lib.gj_solve_f32.restype = ctypes.c_int
    lib.gj_solve_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]

    lib.gj_solve_scratch_floats.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.gj_solve_scratch_floats.restype = ctypes.c_longlong

    def solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        B, K = b.shape
        x = torch.empty_like(b)
        n_scratch = int(lib.gj_solve_scratch_floats(B, K))
        scratch = torch.empty(n_scratch, device=b.device) if n_scratch else None
        err = lib.gj_solve_f32(A.data_ptr(), b.data_ptr(), x.data_ptr(),
                               None if scratch is None else scratch.data_ptr(), B, K,
                               torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return x

    return solve


def against(ours, theirs) -> None:
    """The kernel and another version of it at chip_smoke's solve shapes
    and inputs, timed in turns: theirs, ours, ours, theirs."""
    for i, (batch, k) in enumerate(chip_smoke.SOLVE_SHAPES):
        A, b = chip_smoke.spd_batch(batch, k, seed=100 + i, device="cuda")
        x_ours, x_theirs = ours(A, b), theirs(A, b)
        torch.cuda.synchronize()
        reps = 20 if batch * k * k <= (1 << 28) else 10
        t = [chip_smoke.time_ms(lambda f=f: f(A, b), reps) for f in (theirs, ours, ours, theirs)]
        row = {"shape": [batch, k, k], "bit_equal": bool(torch.equal(x_ours, x_theirs)),
               "kernel_ms": t[1:3], "against_ms": [t[0], t[3]]}
        print(f"[against] {json.dumps(row)}", flush=True)
        del A, b, x_ours, x_theirs
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, help="another gj_solve.cu to time the kernel against")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gj_solve_split: torch.cuda.is_available() is false; this script runs on the card only")
    print(chip_smoke._smi("name,power.limit"), flush=True)
    sources = {name: cut_source(name) for name in CUTS}
    if args.against is not None:
        sources["against"] = args.against.read_text()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources, sources.values())))
    if args.against is not None:
        against(solver(built["kernel"][0]), solver(built.pop("against")[0]))
    inputs = {k: chip_smoke.spd_batch(BATCH, k, seed=400 + k, device="cuda") for k in WIDTHS}
    reference = {}
    for name, (path, ptxas) in built.items():
        spills = [s for s in chip_smoke.ptxas_spills(ptxas) if s[1] or s[2]]
        solve = solver(path)
        row = {"copy": name, "registers": warp_registers(ptxas), "spills": spills}
        for k, (A, b) in inputs.items():
            x = solve(A, b)
            torch.cuda.synchronize()
            reference.setdefault(k, x)
            row[f"ms_{k}"] = chip_smoke.time_ms(lambda: solve(A, b), 20)
            row[f"bit_equal_{k}"] = bool(torch.equal(x, reference[k]))
        print(f"[split] {json.dumps(row)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
