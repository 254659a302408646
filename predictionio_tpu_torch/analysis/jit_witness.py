"""The serve-time compile counter of ``pio deploy --aot``.

Counterpart of ``ServeCompileCounter`` and ``zero_compile_gate`` in
``predictionio_tpu/analysis/jit_witness.py`` (the rest of that witness is
ROADMAP queue 1 item 16). The JAX package counts XLA backend compiles
through ``jax.monitoring``; the port has no such single event, so
:class:`ServeCompileCounter` counts every kind of compile its process can
make:

* ``nvcc``: a run of the CUDA compiler in ``ops/_build.py::build`` (a
  hand-written kernel built on its first launch; a library found built
  is no compile);
* ``aoti_load_package``: an AOTInductor package loaded
  (``workflow/aot.py::load_runtime``);
* ``inductor``: an Inductor graph compile, AOTInductor's included
  (``torch._dynamo.utils.compilation_time_metrics["compile_fx_inner"]``);
* ``dynamo``: a graph captured by ``torch._dynamo``
  (``counters["stats"]["unique_graphs"]``).

The last two are read only where ``torch._dynamo`` is already imported:
nothing here imports torch. The first two are noted by their call sites
through :func:`note_compile`.
"""

from __future__ import annotations

import sys
import threading
from collections import Counter

__all__ = ["ServeCompileCounter", "compile_counts", "note_compile", "zero_compile_gate"]

_noted: Counter = Counter()
_noted_lock = threading.Lock()


def note_compile(kind: str) -> None:
    """Count one compile of ``kind`` made by the port's own code."""
    with _noted_lock:
        _noted[kind] += 1


def compile_counts() -> dict:
    """Every compile of this process so far, by kind."""
    with _noted_lock:
        out = {"nvcc": _noted["nvcc"], "aoti_load_package": _noted["aoti_load_package"], "inductor": 0, "dynamo": 0}
    utils = sys.modules.get("torch._dynamo.utils")
    if utils is not None:
        metrics = getattr(utils, "compilation_time_metrics", None) or {}
        out["inductor"] = len(metrics.get("compile_fx_inner", ()))
        counters = getattr(utils, "counters", None) or {}
        out["dynamo"] = int(counters.get("stats", {}).get("unique_graphs", 0))
    return out


class ServeCompileCounter:
    """The process's compile count split at the boot/serve boundary: the
    query server marks the boundary after every successful load or
    ``/reload`` (:meth:`mark_boot_complete`), and ``/stats.json`` reports
    the compiles since as ``aot.serveTimeCompiles``, the number the
    ``--aot`` contract keeps at zero. One process singleton (the counts it
    reads are process-wide)."""

    _instance: "ServeCompileCounter | None" = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._baseline = 0

    @classmethod
    def install(cls) -> "ServeCompileCounter":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def total_compiles(self) -> int:
        return sum(compile_counts().values())

    def mark_boot_complete(self) -> None:
        """Everything compiled so far was boot work (program loads and
        warm calls, kernel builds of the load); compiles after this mark
        are serve-time."""
        total = self.total_compiles()
        with self._mu:
            self._baseline = total

    def serve_time_compiles(self) -> int:
        total = self.total_compiles()
        with self._mu:
            return total - self._baseline


def zero_compile_gate(witness_report: dict, ledger: dict | None = None) -> dict:
    """The ``--aot`` warmed-phase gate: every witnessed compile fails it,
    within budget or not; the ledger (when given) only annotates each
    offending site with the budget it would have had. Returns ``{"ok",
    "compiles", "sites": [...]}``."""
    entries = {e["entrypoint"]: e for e in ledger.get("entries", ())} if ledger is not None else {}
    sites = []
    total = 0
    for key, st in sorted(witness_report.get("compiles", {}).items()):
        total += st["count"]
        entry = entries.get(key) or entries.get(key.rsplit(":", 1)[0])
        sites.append(
            {
                "entrypoint": key,
                "compiles": st["count"],
                "budgetedMax": int(entry["maxCompiles"]) if entry is not None else None,
            }
        )
    return {"ok": total == 0, "compiles": total, "sites": sites}
