"""Deploy-time AOT serving artifacts: the request path compiles nothing.

Counterpart of ``predictionio_tpu/workflow/aot.py``, on ``torch.export``
and AOTInductor instead of ``jax.export``:

* ``pio train --aot`` **exports** each algorithm's serving programs per
  pow2 bucket: the algorithm's ``aot_export_for_serving(model, buckets)``
  hook gives :class:`ServingProgram` s (an ``nn.Module`` wrapping the
  port's own scoring function and its example arguments),
  :func:`export_instance` traces each with ``torch.export.export`` and
  compiles it with ``torch._inductor.aoti_compile_and_package`` into one
  ``.pt2`` file a program. The files go into an atomic, fsync'd artifact
  directory under the fleet mount (``<basedir>/fleet/aot/<instance>/``,
  the schema of ``fleet/registry.py``) beside a ``manifest.json`` with
  the environment **fingerprint** (torch and CUDA versions, backend,
  device kind and capability) and per-program SHA-256, byte and
  argument-shape records.
* A replica **boots by loading**: :func:`load_runtime` (called from
  ``device_state.pin_pairs``) verifies the set, then the fingerprint,
  loads every program with ``aoti_load_package`` on the serving device
  and calls each once with zeros of its argument shapes, then attaches an
  :class:`AotRuntime` that the templates' pinned serving paths consult
  before their eager code.
* Failure is **loud and never fatal**: a missing, foreign or corrupt set
  logs the exact reason and the deploy serves through the eager pinned
  path on the same device. The bytes served do not change: the programs
  run the same aten products and the same stable sort as the eager path
  (``ops/als.py``'s ``score_rows_program``), with Inductor's shape and
  stride padding off.

Tiers. ``fallback_tier()`` says 2 when a persistent compilation cache is
configured (``--compilation-cache-dir``, ``PIO_COMPILATION_CACHE_DIR`` or
the console's default, which set ``TORCHINDUCTOR_CACHE_DIR`` and
``TRITON_CACHE_DIR``) and 3 otherwise, as the JAX package reports it. The port's fallback is its
eager path, which compiles nothing, so tiers 2 and 3 serve alike: the
cache only shortens a later export.

A program is compiled for static shapes (the batch program's query rows
excepted: a multiple of 8 up to its chunk) and AOTInductor does not check
its inputs, so :meth:`AotRuntime.run` checks every argument's shape,
dtype, device and layout against the manifest before the call; a
mismatch (a table an online fold grew, say) disables the program with the
reference's warning and the eager path serves that shape.

``torch.export`` and ``torch._inductor`` are imported inside the
functions that need them; a deploy without ``--aot`` never imports this
module.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import subprocess
import tempfile
import time
from typing import Any, Sequence

from predictionio_tpu_torch.fleet.registry import (
    AOT_MANIFEST_NAME as MANIFEST_NAME,
    _fsync_dir,
    aot_artifact_dir as artifact_dir,
    read_aot_manifest as read_manifest,
    verify_aot_artifacts as verify_artifacts,
)

__all__ = [
    "AotConfig",
    "AotRuntime",
    "BLOB_SUFFIX",
    "MANIFEST_NAME",
    "ServingProgram",
    "artifact_dir",
    "current_fingerprint",
    "export_instance",
    "fallback_tier",
    "fingerprint_mismatches",
    "ledger_max_buckets",
    "load_runtime",
    "read_manifest",
    "serving_buckets",
    "verify_artifacts",
]

logger = logging.getLogger(__name__)

#: compiled-program filename suffix (one AOTInductor package a program)
BLOB_SUFFIX = ".pt2"

#: fingerprint fields that must match exactly for a tier-1 load: a
#: package holds code for one torch build, one backend and one device
#: architecture. ``deviceCount`` is reported, not matched.
_STRICT_FIELDS = ("torchVersion", "cudaVersion", "backend", "deviceKind", "deviceCapability")

#: the compile-budget ledger entry that bounds the exported bucket count
_LEDGER_ENTRY = "predictionio_tpu/templates/serving_util.py:chunked_topk"

#: Inductor settings of every export: no padding of a product's shapes or
#: of a buffer's strides, so each aten product gets the eager path's
#: operands (its kernel, and with it each score's bits, follows them). The
#: rest only shorten the compile: the C++ wrapper, which launches kernels,
#: at -O0; no probe of the host's vector ISA (test builds with the torch
#: headers; the programs' own CPU kernels only move data, so scalar code
#: computes the same); the Triton kernels built in process, with no pool
#: of compile workers to start
_INDUCTOR_CONFIGS = {
    "shape_padding": False,
    "comprehensive_padding": False,
    "max_autotune": False,
    "aot_inductor.compile_wrapper_opt_level": "O0",
    "cpp.vec_isa_ok": False,
    "compile_threads": 1,
}


@dataclasses.dataclass(frozen=True)
class AotConfig:
    """``pio deploy --aot`` / ``pio train --aot`` settings. Opt-in:
    without it (or with ``enabled=False``) nothing of this module runs."""

    enabled: bool = False
    #: artifact root (default ``<basedir>/fleet/aot``, the fleet mount)
    root: str | None = None

    @property
    def active(self) -> bool:
        return self.enabled


@dataclasses.dataclass(frozen=True)
class ServingProgram:
    """One serving program as an algorithm's export hook gives it."""

    #: the ``nn.Module`` whose ``forward`` is the program
    module: Any
    #: example arguments: their shapes, dtypes and device are the program's
    args: tuple
    #: ``{argument position: (dim, multiple, max)}``: dims that may be any
    #: multiple of ``multiple`` up to ``max`` (the batch program's rows)
    dynamic: dict = dataclasses.field(default_factory=dict)


def _device_of(device) -> "Any":
    import torch

    if device is None:
        return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    return torch.device(device)


def current_fingerprint(device=None) -> dict:
    """The environment a compiled program is valid in, for ``device``
    (default: the first card, or the CPU without one)."""
    import torch

    dev = _device_of(device)
    if dev.type == "cuda":
        index = dev.index or 0
        kind = torch.cuda.get_device_name(index)
        capability = ".".join(str(v) for v in torch.cuda.get_device_capability(index))
        count = torch.cuda.device_count()
    else:
        kind, capability, count = "cpu", "", 1
    return {
        "torchVersion": torch.__version__,
        "cudaVersion": torch.version.cuda or "",
        "backend": dev.type,
        "deviceKind": kind,
        "deviceCapability": capability,
        "deviceCount": count,
    }


def fingerprint_mismatches(manifest_fp: dict, live_fp: dict) -> list[str]:
    """Field-level differences that rule a tier-1 load out: the strict
    fields, and any other identity field the artifact records
    (``deviceCount`` aside), so a set the JAX package wrote (``jaxVersion``,
    ``jaxlibVersion``, no ``torchVersion``) names what makes it foreign."""
    fields = list(_STRICT_FIELDS) + [f for f in manifest_fp if f not in _STRICT_FIELDS and f != "deviceCount"]
    return [
        f"{field}: artifact={manifest_fp.get(field)!r} live={live_fp.get(field)!r}"
        for field in fields
        if manifest_fp.get(field) != live_fp.get(field)
    ]


def serving_buckets(n_items: int, max_buckets: int = 6, floor: int = 16) -> list[int]:
    """The pow2 k-buckets to export: ``ops.topk.bucket_k``'s math (pow2,
    floor 16, capped at the catalog) enumerated, at most ``max_buckets``
    of them."""
    out: list[int] = []
    b = floor
    while len(out) < max_buckets:
        out.append(min(b, int(n_items)))
        if b >= n_items:
            break
        b <<= 1
    seen: set[int] = set()
    return [k for k in out if not (k in seen or seen.add(k))]


def _default_ledger_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "compile-budget.json")


def ledger_max_buckets(ledger_path: str | None, entrypoint: str, default: int = 6) -> int:
    """The bucket count bound of one entrypoint, from the compile-budget
    ledger (``compile-budget.json``, read as plain JSON): an entrypoint
    budgeted for N compiles never exports more than N bucket programs."""
    try:
        with open(ledger_path or _default_ledger_path(), encoding="utf-8") as fh:
            ledger = json.load(fh)
    except (OSError, ValueError):
        return default
    for entry in ledger.get("entries", []):
        if entry.get("entrypoint") == entrypoint:
            try:
                return max(1, min(default, int(entry["maxCompiles"])))
            except (KeyError, TypeError, ValueError):
                return default
    return default


# ---------------------------------------------------------------------------
# Export (pio train --aot)
# ---------------------------------------------------------------------------


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _links_openmp(cxx: str) -> bool:
    """Whether the C++ compiler ``cxx`` finds OpenMP's link spec, which
    AOTInductor's ``-fopenmp`` link needs (gcc prints the bare name when
    it does not)."""
    try:
        found = subprocess.run(
            [cxx, "-print-file-name=libgomp.spec"], capture_output=True, text=True, timeout=30
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.isabs(found)


def _wrapper_compiler() -> str | None:
    """The C++ compiler for AOTInductor's wrapper when Inductor's own
    (``$CXX``, else ``g++``) cannot link OpenMP: the first ``g++`` or
    ``c++`` on ``PATH`` that can, with a warning. ``None`` keeps
    Inductor's."""
    from torch._inductor import config as inductor_config

    own = inductor_config.cpp.cxx[1] or "g++"
    if _links_openmp(own):
        return None
    for name in ("g++", "c++"):
        other = shutil.which(name)
        if other and other != shutil.which(own) and _links_openmp(other):
            logger.warning("AOT export: %s cannot link OpenMP (no libgomp.spec); compiling with %s", own, other)
            return other
    return None


def _compile(program: ServingProgram, path: str, cxx: str | None = None) -> None:
    """``torch.export`` then AOTInductor of one program into ``path``
    (with the C++ compiler ``cxx`` when given)."""
    import torch
    from torch._inductor import aoti_compile_and_package
    from torch._inductor import config as inductor_config

    from predictionio_tpu_torch.analysis.jit_witness import compile_region

    dynamic_shapes = None
    if program.dynamic:
        dynamic_shapes = []
        for pos, _arg in enumerate(program.args):
            spec = program.dynamic.get(pos)
            if spec is None:
                dynamic_shapes.append(None)
                continue
            dim, multiple, most = spec
            n = torch.export.Dim(f"n{pos}", min=1, max=max(1, most // multiple))
            dynamic_shapes.append({dim: multiple * n})
        dynamic_shapes = tuple(dynamic_shapes)
    configs = {k: v for k, v in _INDUCTOR_CONFIGS.items() if _has_setting(inductor_config, k)}
    if cxx is not None:
        configs["cpp.cxx"] = (None, cxx)
    with compile_region():
        exported = torch.export.export(program.module, tuple(program.args), dynamic_shapes=dynamic_shapes)
        aoti_compile_and_package(exported, package_path=path, inductor_configs=configs)


def _has_setting(config, dotted: str) -> bool:
    for part in dotted.split("."):
        if not hasattr(config, part):
            return False
        config = getattr(config, part)
    return True


def _compile_job(module, arg_specs: list, dynamic: dict, path: str, cxx: str | None) -> float:
    """One program's compile in a worker process, on zeros of its
    arguments' shapes, dtypes and device; returns its seconds."""
    import torch

    args = tuple(torch.zeros(shape, dtype=getattr(torch, dtype), device=dev) for shape, dtype, dev in arg_specs)
    t0 = time.perf_counter()
    _compile(ServingProgram(module, args, dynamic), path, cxx)
    return time.perf_counter() - t0


def _export_workers(device, n_programs: int) -> int:
    """Compile processes for an export: a CUDA program takes seconds of
    single-threaded C++ compile, so they compile side by side, one a core
    but one; CPU programs (tests, small tables) compile in this process."""
    if device is None or getattr(device, "type", "cpu") != "cuda":
        return 1
    return max(1, min(n_programs, (os.cpu_count() or 2) - 1))


def _compile_all(jobs: list, cxx: str | None, workers: int) -> list:
    """``[(program, path), ...]`` compiled; their seconds, in order."""
    if workers <= 1:
        seconds = []
        for program, path in jobs:
            t0 = time.perf_counter()
            _compile(program, path, cxx)
            seconds.append(time.perf_counter() - t0)
        return seconds
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        futures = [
            pool.submit(
                _compile_job, program.module,
                [(list(a.shape), _dtype_name(a.dtype), str(a.device)) for a in program.args],
                program.dynamic, path, cxx,
            )
            for program, path in jobs
        ]
        return [f.result() for f in futures]


def export_instance(
    pairs: Sequence, engine_instance_id: str, root: str, ledger_path: str | None = None
) -> dict | None:
    """Compile every serving program of the deployed (algorithm, model)
    pairs into an atomic artifact directory. An algorithm opts in with
    ``aot_export_for_serving(model, buckets) -> {key: ServingProgram}``;
    pairs without the hook contribute nothing. Returns the manifest, or
    ``None`` when nothing was exported. A hook that raises is logged and
    skipped, as in the JAX package.

    The programs and the manifest are written into a ``.aot.*`` sibling,
    every file fsync'd, then the directory is renamed into place and the
    parent fsync'd: a reader (or a crash) sees the previous whole set or
    the next, never a torn one. The programs compile side by side in
    worker processes where they are CUDA programs (:func:`_export_workers`)."""
    programs: dict[str, ServingProgram] = {}
    device = None
    for algo, model in pairs:
        hook = getattr(algo, "aot_export_for_serving", None)
        if hook is None:
            continue
        buckets = serving_buckets(_catalog_items(model), max_buckets=ledger_max_buckets(ledger_path, _LEDGER_ENTRY))
        try:
            exported = hook(model, buckets)
        except Exception:
            logger.exception("aot_export_for_serving failed for %s; skipping", type(algo).__name__)
            continue
        for key, program in (exported or {}).items():
            if key in programs:
                # two algorithms of one class serving one engine
                key = f"{key}#{len(programs)}"
            programs[key] = program
            if device is None:
                device = next((a.device for a in program.args if hasattr(a, "device")), None)
    if not programs:
        return None

    final_dir = artifact_dir(root, engine_instance_id)
    os.makedirs(root, exist_ok=True)
    tmp_dir = tempfile.mkdtemp(prefix=".aot.", dir=root)
    entries = []
    started = time.perf_counter()
    try:
        ordered = sorted(programs.items())
        jobs = [(program, os.path.join(tmp_dir, _blob_filename(key))) for key, program in ordered]
        workers = _export_workers(device, len(jobs))
        all_seconds = _compile_all(jobs, _wrapper_compiler(), workers)
        for (key, program), (_, path), seconds in zip(ordered, jobs, all_seconds):
            fname = os.path.basename(path)
            _fsync_file(path)
            with open(path, "rb") as f:
                blob = f.read()
            entries.append(
                {
                    "key": key,
                    "file": fname,
                    "bytes": len(blob),
                    "sha256": hashlib.sha256(blob).hexdigest(),
                    "argShapes": [[list(a.shape), _dtype_name(a.dtype)] for a in program.args],
                    "dynamic": [[pos, *spec] for pos, spec in sorted(program.dynamic.items())],
                    "exportSeconds": round(seconds, 3),
                }
            )
        manifest = {
            "version": 1,
            "engineInstanceId": engine_instance_id,
            "fingerprint": current_fingerprint(device),
            "exportSeconds": round(time.perf_counter() - started, 3),
            "exportWorkers": workers,
            "entries": entries,
        }
        _write_durable(
            os.path.join(tmp_dir, MANIFEST_NAME), json.dumps(manifest, indent=2, sort_keys=True).encode()
        )
        _fsync_dir(tmp_dir)
        # retire a previous set by rename first, so a crash mid-publish
        # leaves either the old set or the new one addressable
        old = None
        if os.path.isdir(final_dir):
            old = f"{final_dir}.old.{os.getpid()}"
            os.rename(final_dir, old)
        os.rename(tmp_dir, final_dir)
        _fsync_dir(root)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise
    logger.info("Exported %d AOT serving program(s) for instance %s -> %s", len(entries), engine_instance_id, final_dir)
    return manifest


def _blob_filename(key: str) -> str:
    safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in key)
    return f"{safe}{BLOB_SUFFIX}"


def _write_durable(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _catalog_items(model) -> int:
    for attr in ("item_factors", "item_vecs"):
        items = getattr(model, attr, None)
        if items is not None and hasattr(items, "shape"):
            return int(items.shape[0])
    return 1


def fallback_tier() -> int:
    """The tier a failed tier-1 load lands on: 2 when ``pio train`` or
    ``pio deploy`` configured a persistent compilation cache
    (``PIO_COMPILATION_CACHE_DIR``, which the console sets beside
    ``TORCHINDUCTOR_CACHE_DIR``; Inductor sets the latter to its own
    temporary default on its first compile, so it alone says nothing),
    3 otherwise. Both serve through the eager path (the module
    docstring)."""
    value = os.environ.get("PIO_COMPILATION_CACHE_DIR")
    return 2 if value and value != "0" else 3


# ---------------------------------------------------------------------------
# Load (replica boot: device_state.pin_pairs)
# ---------------------------------------------------------------------------


class AotRuntime:
    """The loaded serving programs of one model generation.

    The templates' pinned paths call :meth:`run`: it checks the arguments
    against the manifest, calls the program, and on a mismatch or an
    error disables the key, so that shape is served by the eager path from
    then on (a degraded tier, never an error answer)."""

    def __init__(self, programs: dict, manifest: dict, tier: int = 1):
        self._programs = programs
        self.manifest = manifest
        self.tier = tier
        self.hits = 0
        self.misses = 0
        self._disabled: set[str] = set()
        self._entries = {e["key"]: e for e in manifest.get("entries", [])}

    def get(self, key: str):
        """The program ``key`` (a hit), or ``None`` when it is missing or
        disabled (a miss)."""
        fn = self._programs.get(key)
        if fn is None or key in self._disabled:
            self.misses += 1
            return None
        self.hits += 1
        return fn

    def disable(self, key: str, reason: str) -> None:
        if key not in self._disabled:
            self._disabled.add(key)
            logger.warning(
                "AOT program %s disabled at serve time (%s); the eager path serves this shape from now on",
                key, reason,
            )

    def mismatch(self, key: str, args: Sequence) -> str | None:
        """Why ``args`` do not fit program ``key``'s manifest record (shape,
        dtype, device, layout), or ``None`` when they do."""
        entry = self._entries.get(key) or {}
        shapes = entry.get("argShapes") or []
        if len(args) != len(shapes):
            return f"{len(args)} arguments for {len(shapes)}"
        dynamic = {int(pos): (int(dim), int(mult), int(most)) for pos, dim, mult, most in entry.get("dynamic", [])}
        backend = (self.manifest.get("fingerprint") or {}).get("backend")
        for pos, (arg, (shape, dtype)) in enumerate(zip(args, shapes)):
            got = list(arg.shape)
            want = list(shape)
            spec = dynamic.get(pos)
            if spec is not None and len(got) == len(want):
                dim, mult, most = spec
                if got[dim] % mult == 0 and 0 < got[dim] <= most:
                    want[dim] = got[dim]
            if got != want:
                return f"argument {pos} shape {got} != {list(shape)}"
            if _dtype_name(arg.dtype) != dtype:
                return f"argument {pos} dtype {_dtype_name(arg.dtype)} != {dtype}"
            if backend and arg.device.type != backend:
                return f"argument {pos} on {arg.device.type}, program for {backend}"
            if not arg.is_contiguous():
                return f"argument {pos} is not contiguous"
        return None

    def run(self, key: str, *args):
        """Program ``key`` on ``args`` after :meth:`mismatch`; ``None``
        (the caller serves eagerly) when it is missing, disabled, does not
        fit, or raises."""
        fn = self.get(key)
        if fn is None:
            return None
        problem = self.mismatch(key, args)
        if problem is not None:
            self.hits -= 1
            self.misses += 1
            self.disable(key, problem)
            return None
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001 - degrade to the eager path, never an error answer
            self.disable(key, f"{type(e).__name__}: {e}")
            return None

    def __len__(self) -> int:
        return len(self._programs) - len(self._disabled)

    def stats(self) -> dict:
        return {
            "tier": self.tier,
            "programs": len(self._programs),
            "disabled": len(self._disabled),
            "hits": self.hits,
            "misses": self.misses,
        }


def load_runtime(
    engine_instance_id: str, root: str, warm: bool = True, device=None
) -> tuple[AotRuntime | None, dict]:
    """Load one instance's artifact set onto ``device`` as an
    :class:`AotRuntime`. Returns ``(runtime, report)``; the runtime is
    ``None`` on any failure (missing directory, corrupt blob, fingerprint
    mismatch, load or warm-call error), and the report says which tier
    serving fell back to and why. Verification comes first, then the
    fingerprint, then the loads; ``warm=True`` calls every program once
    with zeros of its ``argShapes``, so its first launch happens here."""
    report: dict[str, Any] = {"tier": 1, "instance": engine_instance_id, "loaded": 0, "problems": []}
    try:
        instance_dir = artifact_dir(root, engine_instance_id)
    except ValueError as e:
        report["problems"].append(str(e))
        return _fallback(report)
    check = verify_artifacts(instance_dir, deep=True)
    if not check["ok"]:
        report["problems"].extend(check["problems"])
        return _fallback(report)
    manifest = read_manifest(instance_dir)
    if manifest is None:  # removed between the check and the read
        report["problems"].append(f"missing or torn {MANIFEST_NAME}")
        return _fallback(report)
    dev = _device_of(device)
    live_fp = current_fingerprint(dev)
    diffs = fingerprint_mismatches(manifest.get("fingerprint") or {}, live_fp)
    if diffs:
        report["problems"].append("fingerprint mismatch: " + "; ".join(diffs))
        return _fallback(report)

    import torch
    from torch._inductor import aoti_load_package
    from torch._inductor import config as inductor_config

    from predictionio_tpu_torch.analysis.jit_witness import compiling

    # a load compares the package's recorded CPU vector ISA with the
    # host's; the export recorded none (_INDUCTOR_CONFIGS), and probing the
    # host's would build test programs at every boot
    no_isa_probe = {"cpp.vec_isa_ok": False} if _has_setting(inductor_config, "cpp.vec_isa_ok") else {}
    programs: dict[str, Any] = {}
    for entry in manifest.get("entries", []):
        path = os.path.join(instance_dir, entry["file"])
        try:
            with compiling("aoti_load_package"), inductor_config.patch(no_isa_probe):
                fn = aoti_load_package(path, device_index=dev.index if dev.type == "cuda" and dev.index is not None else -1)
        except Exception as e:
            report["problems"].append(f"load failed for {entry.get('key')}: {type(e).__name__}: {e}")
            return _fallback(report)
        if warm:
            try:
                fn(*(
                    torch.zeros(shape, dtype=getattr(torch, dtype), device=dev)
                    for shape, dtype in entry.get("argShapes", [])
                ))
            except Exception as e:
                report["problems"].append(f"warm call failed for {entry.get('key')}: {type(e).__name__}: {e}")
                return _fallback(report)
        programs[entry["key"]] = fn
    report["loaded"] = len(programs)
    report["fingerprint"] = live_fp
    return AotRuntime(programs, manifest, tier=1), report


def _fallback(report: dict) -> tuple[None, dict]:
    tier = fallback_tier()
    report["tier"] = tier
    logger.warning(
        "AOT artifact load failed for instance %s — falling back to tier %d (%s): %s",
        report.get("instance"), tier,
        "eager path; persistent compilation cache configured" if tier == 2 else "eager path",
        "; ".join(report["problems"]) or "unknown",
    )
    return None, report
