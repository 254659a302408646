"""Hold this checkout's fused-CE kernels against another checkout's on a
CUDA card, to the bit, at widths of the full-width path (D <= 256).

The other checkout's ``predictionio_tpu_torch/ops/csrc/fused_ce.cu`` (an
earlier commit's, unpacked with ``git archive`` into a directory) is
built with the same flags into a library beside this checkout's, and
both run the same calls through this checkout's wrappers: the row and
column sums and both gradient passes on L2-normalised towers made on the
card from a seed, at ``SHAPES``. Prints one JSON line a shape (whether
every output is bit-equal), then the card's name and power limit; exits
1 when a shape differs. Needs one card and ``nvcc``::

    python3 probe_fused_ce_bits.py OTHER_CHECKOUT
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops import fused_ce as fc

SHAPES = ((8192, 64), (1024, 32), (16384, 64), (4096, 128), (2048, 256), (1024, 200))
INV_TEMP = 10.0
SEED = 11


def towers(B: int, D: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(SEED)
    ue = torch.nn.functional.normalize(torch.randn((B, D), generator=gen, device=device), dim=1)
    ie = torch.nn.functional.normalize(torch.randn((B, D), generator=gen, device=device), dim=1)
    return ue.contiguous(), ie.contiguous()


def outputs(lib: ctypes.CDLL, B: int, D: int, device) -> list:
    """The four outputs of one forward and one backward call through
    ``lib`` (the wrappers load ``_build``'s library by name)."""
    _build._loaded["fused_ce"] = lib
    fc._capacity.clear()
    ue, ie = towers(B, D, device)
    rs, cs = fc.fused_ce_fwd_cuda(ue, ie, INV_TEMP)
    due, die = fc.fused_ce_bwd_cuda(ue, ie, rs, cs, INV_TEMP)
    torch.cuda.synchronize(device)
    return [t.clone() for t in (rs, cs, due, die)]


def main(other: str) -> int:
    if not torch.cuda.is_available():
        print("probe_fused_ce_bits: no CUDA device", file=sys.stderr)
        return 1
    source = Path(other) / "predictionio_tpu_torch" / "ops" / "csrc" / "fused_ce.cu"
    out = _build.BUILD_DIR / "other_fused_ce.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    built = subprocess.run([_build.cuda_tool("nvcc"), *_build._NVCC_FLAGS, "-I", str(source.parent), "-o", str(out),
                            str(source)], capture_output=True, text=True)
    if built.returncode != 0:
        print(built.stderr[-3000:], file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    mine, theirs = _build.load("fused_ce"), ctypes.CDLL(str(out))
    differing = 0
    for B, D in SHAPES:
        a, b = outputs(theirs, B, D, device), outputs(mine, B, D, device)
        equal = all(torch.equal(x, y) for x, y in zip(a, b))
        differing += not equal
        print(json.dumps({"shape": [B, D], "bit_equal": equal}), flush=True)
    _build._loaded["fused_ce"] = mine
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 1 if differing else 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
