"""Runtime jit-witness sanitizer for the port — the dynamic half of
piolint's compile/transfer story, and the serve-time compile counter of
``pio deploy --aot``.

Counterpart of ``predictionio_tpu/analysis/jit_witness.py``. The JAX
package counts XLA backend compiles through ``jax.monitoring``; the port
has no such single event, so it counts every kind of compile its process
can make (:func:`compile_counts`):

* ``nvcc``: a run of the CUDA compiler in ``ops/_build.py::build`` (a
  hand-written kernel built on its first launch; a library found built
  is no compile);
* ``aoti_load_package``: an AOTInductor package loaded
  (``workflow/aot.py::load_runtime``);
* ``inductor``: an Inductor graph compile, AOTInductor's included
  (``torch._dynamo.utils.compilation_time_metrics["compile_fx_inner"]``);
* ``dynamo``: a graph captured by ``torch._dynamo``
  (``counters["stats"]["unique_graphs"]``).

The last two are read only where ``torch._dynamo`` is already imported.
The first two are noted by their call sites (:func:`compiling`), and an
AOTInductor export marks its block (:func:`compile_region`).

While installed (``pio jitwitness -- <pio cmd>``), :class:`JitWitness`
records, attributed to the innermost ``predictionio_tpu_torch`` frame
active at the event (falling back to the innermost repository frame):

* **compiles per site**, by kind, with seconds: ``nvcc`` and
  ``aoti_load_package`` through :func:`compiling`; Dynamo and Inductor
  through ``torch._dynamo``'s compile start/end callbacks and
  :func:`compile_region`, each measured as the change of
  :func:`compile_counts` over the compile. A change no hook saw (a
  ``torch._dynamo.reset()`` drops the callbacks) is reported under
  ``<unattributed>``, so the per-site sums equal the process's counts;
* **device-to-host transfers per site, with bytes**: ``Tensor.cpu()``,
  ``.to(<host device>)``, ``.item()``, ``.tolist()`` and ``.numpy()`` on
  a tensor that is not on the CPU, and ``torch.cuda.synchronize()``
  (a host sync, 0 bytes). Unlike the reference, which cannot see
  ``.item()``, the port sees every one of these;
* **compiled-program constructions per call**: ``torch.compile(...)``
  and ``aoti_load_package`` evaluated inside a function body
  (module-scope constructions report ``<module>`` frames and are the
  sanctioned shape), reported as ``jitConstructions`` for the
  reference's report shape.

The wrappers change nothing torch computes or captures: each calls the
original, and records nothing while Dynamo traces
(``torch.compiler.is_compiling()``), so a compiled function's graphs
are the ones it has without the witness.

:func:`jitwitness_report` joins a capture against a static PIO306–PIO308
pass over the port's package, classifying every finding CONFIRMED or
PLAUSIBLE, and checks ``compile-budget-torch.json`` (the port's own
ledger: every port site that compiles, with its budget and
justification).

Stdlib only, and it imports nothing of torch itself, not even lazily:
the witness wraps the ``torch`` its process has loaded (the console's
``jitwitness`` verb imports it first); without it, only the noted
compiles are recorded. Known blind spots: compiles and copies in
subprocesses (``pio train --aot``'s export workers on the card), and
host syncs outside the methods above (``float(t)``, ``bool(t)``, a
``copy_`` into a host tensor).
"""

from __future__ import annotations

import ast
import contextlib
import json
import os
import sys
import threading
import time
from collections import Counter
from typing import Any, Callable, Iterator

__all__ = [
    "JitWitness",
    "LEDGER_NAME",
    "ServeCompileCounter",
    "active",
    "check_budget",
    "classify_findings",
    "compile_counts",
    "compile_region",
    "compiling",
    "install",
    "jitwitness_report",
    "load_ledger",
    "note_compile",
    "prune_ledger",
    "report",
    "run_with_jit_witness",
    "static_compile_findings",
    "uninstall",
    "write_ledger",
    "write_report",
    "zero_compile_gate",
]

#: the port's compile-budget ledger, resolved against the repo root (the
#: reference's ``compile-budget.json`` budgets the JAX package)
LEDGER_NAME = "compile-budget-torch.json"

#: the package whose frames the witness attributes to
_PORT = "predictionio_tpu_torch/"

#: compile kinds a witness measures as a change of :func:`compile_counts`
_TORCH_KINDS = ("inductor", "dynamo")

#: the tensor methods that cross to the host from a device tensor
_TRANSFER_METHODS = ("cpu", "numpy", "item", "tolist", "to")

_noted: Counter = Counter()
_noted_lock = threading.Lock()


def _repo_root() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


# ---------------------------------------------------------------------------
# The process's compile counts
# ---------------------------------------------------------------------------


def note_compile(kind: str, seconds: float = 0.0) -> None:
    """Count one compile of ``kind`` made by the port's own code (and
    record it at its site when a witness is installed)."""
    with _noted_lock:
        _noted[kind] += 1
    w = _ACTIVE
    if w is not None and w.installed:
        w.record_compile(kind, seconds)
        if kind == "aoti_load_package":
            w.record_construction(kind)


@contextlib.contextmanager
def compiling(kind: str) -> Iterator[None]:
    """Time one compile of ``kind`` (``nvcc``, ``aoti_load_package``) and
    note it when the block ends, whether it succeeded or not."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        note_compile(kind, time.perf_counter() - t0)


@contextlib.contextmanager
def compile_region() -> Iterator[None]:
    """A block that compiles through torch without Dynamo's callbacks
    (an AOTInductor export): an installed witness records the Inductor
    and Dynamo compiles it made at the block's site."""
    w = _ACTIVE
    if w is None or not w.installed:
        yield
        return
    with w._measured():
        yield


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


def _on_device(t: Any) -> bool:
    """Does tensor ``t`` live off the host? (Tests patch this: the CPU
    has no device copy to witness.)"""
    return t.device.type != "cpu"


def _nbytes(t: Any) -> int:
    return int(t.numel()) * int(t.element_size())


def _to_host(torch: Any, args: tuple, kwargs: dict) -> bool:
    """Does ``Tensor.to(*args, **kwargs)`` target the host?"""
    dev = kwargs.get("device")
    if dev is None and args:
        first = args[0]
        if isinstance(first, (str, torch.device)):
            dev = first
        elif isinstance(first, torch.Tensor):
            dev = first.device
    if dev is None or isinstance(dev, int):
        return False
    return torch.device(dev).type == "cpu"


# ---------------------------------------------------------------------------
# The witness
# ---------------------------------------------------------------------------


class JitWitness:
    """Recording state + the patch set. One instance is installed at a
    time (module-level :func:`install`); nested installs hand back the
    displaced attributes on uninstall, mirroring the lock-witness."""

    def __init__(self, root: str | None = None):
        self.root = os.path.abspath(root or _repo_root()) + os.sep
        self._pkg_dir = os.path.join(os.path.abspath(_repo_root()), _PORT.rstrip("/")) + os.sep
        self._self_dir = os.path.dirname(os.path.abspath(__file__)) + os.sep
        self._mu = threading.Lock()
        self._tls = threading.local()
        # "path:function" -> stats
        self.compiles: dict[str, dict] = {}
        self.transfers: dict[str, dict] = {}
        self.constructions: dict[str, dict] = {}
        self.installed = False
        self.torch_patched = False  # torch's entry points were wrapped (for the report)
        self._saved: dict[str, Any] = {}
        self._tensor_own: dict[str, bool] = {}
        self._baseline: dict = {}
        self._dynamo_hooks: tuple | None = None
        self._dynamo_start: list = []

    # ------------------------------------------------------------ attribution
    def _site(self) -> tuple[str, str, int] | None:
        """``(rel_path, function, line)`` of the innermost
        ``predictionio_tpu_torch`` frame on the current stack, falling
        back to the innermost repository frame (``chip_smoke.py``,
        ``tests/``); None when the whole stack is external."""
        f = sys._getframe(2)
        fallback: tuple[str, str, int] | None = None
        while f is not None:
            fn = f.f_code.co_filename
            if not fn.startswith(self._self_dir):
                if fn.startswith(self._pkg_dir):
                    rel = os.path.relpath(fn, self.root).replace(os.sep, "/")
                    return rel, f.f_code.co_name, f.f_lineno
                if fallback is None and fn.startswith(self.root):
                    rel = os.path.relpath(fn, self.root).replace(os.sep, "/")
                    fallback = (rel, f.f_code.co_name, f.f_lineno)
            f = f.f_back
        return fallback

    @staticmethod
    def _key(site: tuple[str, str, int]) -> str:
        return f"{site[0]}:{site[1]}"

    # -------------------------------------------------------------- recording
    def record_compile(self, kind: str, seconds: float, count: int = 1, key: str | None = None) -> None:
        site = self._site() if key is None else None
        if key is None:
            key = self._key(site) if site is not None else "<external>"
        with self._mu:
            st = self.compiles.get(key)
            if st is None:
                st = {
                    "count": 0,
                    "kinds": {},
                    "firstCompileMs": round(seconds * 1e3, 3),
                    "totalCompileMs": 0.0,
                    "lines": [],
                }
                self.compiles[key] = st
            st["count"] += count
            st["kinds"][kind] = st["kinds"].get(kind, 0) + count
            st["totalCompileMs"] = round(st["totalCompileMs"] + seconds * 1e3, 3)
            if site is not None and site[2] not in st["lines"] and len(st["lines"]) < 16:
                st["lines"].append(site[2])

    def record_transfer(self, kind: str, nbytes: int) -> None:
        site = self._site()
        if site is None:
            return  # external code moving external data: not ours
        key = self._key(site)
        with self._mu:
            st = self.transfers.setdefault(key, {"count": 0, "bytes": 0, "kinds": []})
            st["count"] += 1
            st["bytes"] += int(nbytes)
            if kind not in st["kinds"]:
                st["kinds"].append(kind)

    def record_construction(self, kind: str = "torch.compile") -> None:
        site = self._site()
        if site is None or site[1] == "<module>":
            return  # import-time module-scope construction: sanctioned
        key = self._key(site)
        with self._mu:
            st = self.constructions.setdefault(key, {"count": 0, "lines": [], "kinds": []})
            st["count"] += 1
            if site[2] not in st["lines"] and len(st["lines"]) < 16:
                st["lines"].append(site[2])
            if kind not in st["kinds"]:
                st["kinds"].append(kind)

    @contextlib.contextmanager
    def _measured(self) -> Iterator[None]:
        """Record the Dynamo and Inductor compiles of a block at its site
        (nested blocks and callbacks inside one are the outer's)."""
        depth = getattr(self._tls, "depth", 0)
        self._tls.depth = depth + 1
        before = compile_counts() if depth == 0 else None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._tls.depth = depth
            if before is not None:
                self._record_delta(before, time.perf_counter() - t0)

    def _record_delta(self, before: dict, seconds: float) -> None:
        after = compile_counts()
        for kind in _TORCH_KINDS:
            n = after[kind] - before[kind]
            if n > 0:
                self.record_compile(kind, seconds, count=n)

    # ------------------------------------------------------ dynamo callbacks
    def _on_dynamo_start(self, *_args) -> None:
        if getattr(self._tls, "depth", 0) == 0:
            self._dynamo_start.append((compile_counts(), time.perf_counter()))
        else:
            self._dynamo_start.append(None)

    def _on_dynamo_end(self, *_args) -> None:
        if not self._dynamo_start:
            return
        start = self._dynamo_start.pop()
        if start is not None and self.installed:
            self._record_delta(start[0], time.perf_counter() - start[1])

    def _ensure_dynamo_hooks(self) -> None:
        """Register the compile start/end callbacks once Dynamo is loaded
        (it is imported by the first ``torch.compile``)."""
        cb = sys.modules.get("torch._dynamo.callback")
        handler = getattr(cb, "callback_handler", None)
        if handler is None or not hasattr(handler, "register_start_callback"):
            return
        with self._mu:
            if self._dynamo_hooks is not None or not self.installed:
                return
            self._dynamo_hooks = (handler, self._on_dynamo_start, self._on_dynamo_end)
        handler.register_start_callback(self._on_dynamo_start)
        handler.register_end_callback(self._on_dynamo_end)

    # -------------------------------------------------------------- patching
    def install(self) -> None:
        if self.installed:
            return
        baseline = compile_counts()
        torch = sys.modules.get("torch")
        if torch is None:  # nothing of torch to wrap: only noted compiles count
            with self._mu:
                self._baseline = baseline
                self.installed = True
            return
        witness = self
        tensor = torch.Tensor
        is_compiling = torch.compiler.is_compiling
        saved = {name: getattr(tensor, name) for name in _TRANSFER_METHODS}
        own = {name: name in tensor.__dict__ for name in _TRANSFER_METHODS}
        saved["torch.compile"] = torch.compile
        saved["torch.cuda.synchronize"] = torch.cuda.synchronize

        def crossing(name: str):
            orig = saved[name]

            def method(self, *args, **kwargs):
                if not is_compiling() and _on_device(self):
                    witness.record_transfer(f".{name}()", _nbytes(self))
                return orig(self, *args, **kwargs)

            method.__name__ = method.__qualname__ = name
            method.__doc__ = orig.__doc__
            return method

        def to(self, *args, **kwargs):
            if not is_compiling() and _on_device(self) and _to_host(torch, args, kwargs):
                witness.record_transfer('.to("cpu")', _nbytes(self))
            return saved["to"](self, *args, **kwargs)

        to.__doc__ = saved["to"].__doc__

        def compile_wrapper(*args, **kwargs):
            witness.record_construction("torch.compile")
            out = saved["torch.compile"](*args, **kwargs)
            witness._ensure_dynamo_hooks()
            return out

        def synchronize(*args, **kwargs):
            witness.record_transfer("torch.cuda.synchronize()", 0)
            return saved["torch.cuda.synchronize"](*args, **kwargs)

        with self._mu:
            self._saved = saved
            self._tensor_own = own
            self._baseline = baseline
            self.installed = self.torch_patched = True
        for name in ("cpu", "numpy", "item", "tolist"):
            setattr(tensor, name, crossing(name))
        tensor.to = to
        torch.compile = compile_wrapper
        torch.cuda.synchronize = synchronize
        self._ensure_dynamo_hooks()

    def uninstall(self) -> None:
        if not self.installed:
            return
        with self._mu:
            saved = self._saved
            self._saved = {}
            self.installed = False
            hooks, self._dynamo_hooks = self._dynamo_hooks, None
        if hooks is not None:
            handler, start, end = hooks
            for remove, fn in ((handler.remove_start_callback, start), (handler.remove_end_callback, end)):
                with contextlib.suppress(ValueError):  # a torch._dynamo.reset() cleared it
                    remove(fn)
        if not saved:  # torch was not loaded at install(): nothing wrapped
            return
        torch = sys.modules["torch"]
        # hand back whatever install() displaced — possibly an OUTER
        # witness's wrappers (the lock-witness's nested-restore contract)
        for name in _TRANSFER_METHODS:
            if self._tensor_own[name]:
                setattr(torch.Tensor, name, saved[name])
            else:
                delattr(torch.Tensor, name)
        torch.compile = saved["torch.compile"]
        torch.cuda.synchronize = saved["torch.cuda.synchronize"]

    # ---------------------------------------------------------------- report
    def report(self) -> dict:
        now = compile_counts()
        counts = {k: now[k] - self._baseline.get(k, 0) for k in now}
        with self._mu:
            compiles = {k: {**v, "kinds": dict(v["kinds"])} for k, v in sorted(self.compiles.items())}
            transfers = {k: dict(v) for k, v in sorted(self.transfers.items())}
            cons = {k: dict(v) for k, v in sorted(self.constructions.items())}
        seen = Counter()
        for st in compiles.values():
            seen.update(st["kinds"])
        missing = {k: counts[k] - seen[k] for k in counts if counts[k] > seen[k]}
        if missing:
            compiles["<unattributed>"] = {
                "count": sum(missing.values()),
                "kinds": missing,
                "firstCompileMs": None,
                "totalCompileMs": 0.0,
                "lines": [],
            }
        return {
            "compiles": compiles,
            "transfers": transfers,
            "jitConstructions": cons,
            "compileCounts": counts,
            "torchPatched": self.torch_patched,
            "totalCompiles": sum(v["count"] for v in compiles.values()),
            "totalCompileMs": round(sum(v["totalCompileMs"] for v in compiles.values()), 3),
            "totalTransfers": sum(v["count"] for v in transfers.values()),
            "totalTransferBytes": sum(v["bytes"] for v in transfers.values()),
            "totalConstructions": sum(v["count"] for v in cons.values()),
        }


# ---------------------------------------------------------------------------
# Module-level singleton
# ---------------------------------------------------------------------------

_ACTIVE: JitWitness | None = None


def install(root: str | None = None) -> JitWitness:
    global _ACTIVE
    if _ACTIVE is not None and _ACTIVE.installed:
        return _ACTIVE
    _ACTIVE = JitWitness(root=root)
    _ACTIVE.install()
    return _ACTIVE


def active() -> JitWitness | None:
    return _ACTIVE if (_ACTIVE is not None and _ACTIVE.installed) else None


def uninstall() -> None:
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.uninstall()


def report() -> dict:
    return _ACTIVE.report() if _ACTIVE is not None else {}


def run_with_jit_witness(thunk: Callable[[], Any], root: str | None = None) -> tuple[Any, dict]:
    """Run ``thunk`` under a freshly-installed jit witness; returns
    ``(thunk_result, witness_report)``. Always uninstalls and restores
    any previously-active witness."""
    global _ACTIVE
    prev = _ACTIVE
    w = JitWitness(root=root)
    _ACTIVE = w
    w.install()
    try:
        result = thunk()
    finally:
        w.uninstall()
        _ACTIVE = prev
    return result, w.report()


# ---------------------------------------------------------------------------
# AOT serving: the zero-compile gate + the long-lived serve counter
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Compile-budget ledger
# ---------------------------------------------------------------------------


def default_ledger_path(root: str | None = None) -> str:
    return os.path.join(os.path.abspath(root or _repo_root()), LEDGER_NAME)


def load_ledger(path: str) -> dict:
    """``{"version": 1, "entries": [{"entrypoint", "maxCompiles",
    "justification"}, ...]}``; a missing file is an empty ledger. An
    ``entrypoint`` is ``path:function`` (one entrypoint) or a bare
    ``path`` (every function in the file shares the budget)."""
    if not os.path.exists(path):
        return {"version": 1, "entries": []}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return {"version": 1, "entries": list(data.get("entries", ()))}


def write_ledger(path: str, ledger: dict) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "entries": ledger["entries"]}, fh, indent=2, sort_keys=True)
        fh.write("\n")


def check_budget(witness_report: dict, ledger: dict) -> dict:
    """Join witnessed compile sites against the ledger. Only the port's
    sites participate (``predictionio_tpu_torch/...`` — test and script
    frames drive the package, they are not entrypoints themselves).
    Returns ``{"checked", "violations": [...], "unbudgeted": [...]}``
    where a violation is a budgeted entrypoint that compiled MORE than
    its entry allows, and an unbudgeted site is a package entrypoint that
    compiled with no ledger entry at all.

    A ``path:function`` entry budgets that one entrypoint; a bare
    ``path`` entry budgets the whole file — every exact-entry-less
    function in it SHARES the budget (their counts sum against
    ``maxCompiles``)."""
    entries = {e["entrypoint"]: e for e in ledger.get("entries", ())}
    violations: list[dict] = []
    unbudgeted: list[dict] = []
    shared: dict[str, dict] = {}
    checked = 0
    for key, st in sorted(witness_report.get("compiles", {}).items()):
        if not key.startswith(_PORT):
            continue
        checked += 1
        path = key.rsplit(":", 1)[0]
        entry = entries.get(key)
        if entry is not None:
            if st["count"] > int(entry["maxCompiles"]):
                violations.append(
                    {
                        "entrypoint": key,
                        "compiles": st["count"],
                        "maxCompiles": int(entry["maxCompiles"]),
                        "justification": entry.get("justification", ""),
                    }
                )
        elif path in entries:
            pool = shared.setdefault(path, {"compiles": 0, "sites": []})
            pool["compiles"] += st["count"]
            pool["sites"].append(key)
        else:
            unbudgeted.append({"entrypoint": key, "compiles": st["count"]})
    for path, pool in sorted(shared.items()):
        entry = entries[path]
        if pool["compiles"] > int(entry["maxCompiles"]):
            violations.append(
                {
                    "entrypoint": path,
                    "compiles": pool["compiles"],
                    "maxCompiles": int(entry["maxCompiles"]),
                    "sites": pool["sites"],
                    "justification": entry.get("justification", ""),
                }
            )
    return {"checked": checked, "violations": violations, "unbudgeted": unbudgeted}


def prune_ledger(path: str, root: str | None = None) -> int:
    """Drop ledger entries whose entrypoint no longer exists — the file
    is gone, or the named function is no longer defined in it (AST
    check; the linter still imports nothing it lints). Returns the
    number of entries removed (``pio lint --prune-baseline``)."""
    ledger = load_ledger(path)
    if not ledger["entries"]:
        return 0
    root = os.path.abspath(root or _repo_root())
    kept = []
    pruned = 0
    for e in ledger["entries"]:
        ep = e.get("entrypoint", "")
        fpath, _, func = ep.partition(":")
        abs_path = os.path.join(root, fpath)
        ok = os.path.exists(abs_path)
        if ok and func:
            try:
                with open(abs_path, "r", encoding="utf-8") as fh:
                    tree = ast.parse(fh.read())
                ok = any(
                    isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name == func
                    for n in ast.walk(tree)
                )
            except SyntaxError:
                ok = True  # unparseable file: leave the entry alone
        if ok:
            kept.append(e)
        else:
            pruned += 1
    if pruned:
        write_ledger(path, {"version": 1, "entries": kept})
    return pruned


# ---------------------------------------------------------------------------
# CONFIRMED / PLAUSIBLE classification of the static findings
# ---------------------------------------------------------------------------


def _function_spans(abs_path: str) -> list[tuple[int, int, str]]:
    """``(start, end, name)`` for every def in the file, innermost
    last — used to find a finding's enclosing function."""
    try:
        with open(abs_path, "r", encoding="utf-8", errors="replace") as fh:
            tree = ast.parse(fh.read())
    except (OSError, SyntaxError):
        return []
    spans = []
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            spans.append((n.lineno, n.end_lineno or n.lineno, n.name))
    spans.sort()
    return spans


def _enclosing_function(spans: list[tuple[int, int, str]], line: int) -> str | None:
    best: tuple[int, str] | None = None
    for start, end, name in spans:
        if start <= line <= end:
            if best is None or start > best[0]:
                best = (start, name)
    return best[1] if best else None


def classify_findings(findings, witness_report: dict, root: str | None = None) -> list[dict]:
    """Join static ``PIO306``–``PIO308`` findings against a witness
    capture. A finding is CONFIRMED when the matching runtime event was
    witnessed inside its enclosing function: ≥ 2 compiles for a PIO306
    retrace risk, any transfer for PIO307, any construction for PIO308.
    Everything else is PLAUSIBLE — statically derivable, not exercised
    by this workload."""
    root = os.path.abspath(root or _repo_root())
    spans_cache: dict[str, list] = {}
    out = []
    for f in findings:
        code = getattr(f, "code", None) or f["code"]
        path = getattr(f, "path", None) or f["path"]
        line = getattr(f, "line", None) or f["line"]
        message = getattr(f, "message", None) or f.get("message", "")
        if path not in spans_cache:
            spans_cache[path] = _function_spans(os.path.join(root, path))
        func = _enclosing_function(spans_cache[path], line)
        key = f"{path}:{func}" if func else None
        status = "PLAUSIBLE"
        witnessed = 0
        if key is not None:
            if code == "PIO306":
                st = witness_report.get("compiles", {}).get(key)
                if st is not None and st["count"] >= 2:
                    status, witnessed = "CONFIRMED", st["count"]
            elif code == "PIO307":
                st = witness_report.get("transfers", {}).get(key)
                if st is not None and st["count"] >= 1:
                    status, witnessed = "CONFIRMED", st["count"]
            elif code == "PIO308":
                st = witness_report.get("jitConstructions", {}).get(key)
                if st is not None and st["count"] >= 1:
                    status, witnessed = "CONFIRMED", st["count"]
        out.append(
            {
                "code": code,
                "path": path,
                "line": line,
                "function": func,
                "message": message,
                "status": status,
                "witnessedEvents": witnessed,
            }
        )
    return out


def static_compile_findings(root: str | None = None):
    """The current static ``PIO306``–``PIO308`` finding set of the port's
    package under ``root`` (suppressions applied, baseline NOT applied —
    the witness classifies baselined findings too). The program is the
    port's package alone: the witness attributes to its frames, and no
    code outside it is on its request paths."""
    from predictionio_tpu_torch.analysis.engine import default_root, lint_tree
    from predictionio_tpu_torch.analysis.witness import program_package

    root = os.path.abspath(root or default_root())
    findings, _files, _sup, _stats, _cycles = lint_tree(root, package=program_package(root))
    return [f for f in findings if f.code in ("PIO306", "PIO307", "PIO308")]


def jitwitness_report(witness_report: dict, root: str | None = None, ledger_path: str | None = None) -> dict:
    """The ``pio jitwitness`` report body: the raw witness capture, the
    CONFIRMED/PLAUSIBLE classification of every static PIO306–308
    finding, and the compile-budget check. ``ok`` fails only on budget
    VIOLATIONS (a budgeted entrypoint exceeding its max) — unbudgeted
    compiles are reported but expected under arbitrary workloads."""
    root = os.path.abspath(root or _repo_root())
    ledger = load_ledger(ledger_path or default_ledger_path(root))
    findings = static_compile_findings(root)
    budget = check_budget(witness_report, ledger)
    return {
        "witness": witness_report,
        "staticCompileFindings": classify_findings(findings, witness_report, root),
        "budget": budget,
        "ledgerEntries": len(ledger["entries"]),
        "ok": not budget["violations"],
    }


def write_report(path: str, payload: dict) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
