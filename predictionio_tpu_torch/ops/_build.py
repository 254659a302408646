"""Build and load the port's hand-written CUDA kernels.

Each ``ops/csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface under ``build/torch_kernels/``
of the checkout (git-ignored), and loaded with ``ctypes``; the wrapper
that owns a kernel declares its C signature. Nothing is built at import:
the first call that needs a kernel builds it, so a fresh checkout builds
inside its first run. A library is named by a hash of its source, every
``csrc/*.cuh`` header and the flags, so an edited source or header is
never served a stale build. Every nvcc run is counted
(``analysis/jit_witness.py``: a build on the query path is a serve-time
compile under ``pio deploy --aot``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from predictionio_tpu_torch.analysis.jit_witness import compiling

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "lib_path", "cuda_tool"]

_CSRC = Path(__file__).resolve().parent / "csrc"

#: kernel name -> its CUDA source
SOURCES = {"gj_solve": _CSRC / "gj_solve.cu", "fused_ce": _CSRC / "fused_ce.cu"}

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_lock = threading.Lock()
_loaded: dict = {}  # name -> ctypes.CDLL


def cuda_tool(tool: str) -> str:
    """The path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    found = shutil.which(tool)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", tool)
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(f"{tool} not found: the CUDA kernels build only where the CUDA toolkit is installed")


def lib_path(name: str) -> Path:
    """Where kernel ``name``'s library is (or will be) built."""
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile kernel ``name`` unless it is built already. Returns nvcc's
    output (the ptxas register and shared-memory lines), "" when the
    library was there; raises with the compiler's output on failure."""
    out = lib_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # concurrent builds are safe: each writes its own temporary file,
    # renamed atomically
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    with compiling("nvcc"):
        proc = subprocess.run(
            [cuda_tool("nvcc"), *_NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc={proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build(name)  # outside the lock: nvcc takes seconds
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(lib_path(name)))
        return lib
