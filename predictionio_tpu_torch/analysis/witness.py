"""Runtime lock-witness sanitizer — the dynamic half of piolint's
concurrency story.

Static analysis proposes; executions confirm. While installed, the
witness replaces :func:`threading.Lock`/`threading.RLock` with recording
wrappers (only for locks **allocated from this repo's code** — stdlib
and third-party internals stay untouched) and observes every real
acquisition during a test run, a ``pio chaos-ingest`` drill, or an
arbitrary command under ``pio tsan``:

* the **held-lock set** per thread and the **acquisition-order digraph**
  (edge ``A -> B`` whenever B is taken while A is held), with per-edge
  counts;
* **hold times** per lock site (p50/p95/p99/max) plus a long-hold
  counter — the runtime signature of the PIO202/PIO206 convoy;
* ``time.sleep`` while holding any witnessed lock — a *witnessed*
  blocking-under-lock event, not just a reachable one;
* **lock-order inversions**: cycles in the witnessed digraph — the
  runtime proof of a PIO203/PIO207 deadlock hazard.

The report classifies every static ``PIO207`` cycle as **CONFIRMED**
(every edge of the cycle was witnessed in this run) or **PLAUSIBLE**
(statically derivable, not fully exercised by this workload) — the
triage split an operator needs: CONFIRMED cycles are one unlucky
schedule away from a real deadlock.

Lock identity is the *allocation site*, normalized to match the static
rules' naming: ``ClassName.attr`` for ``self._lock = threading.Lock()``
inside ``__init__``, ``filestem.NAME`` for module-level locks,
``path:line`` otherwise — so every instance of a class shares one
identity, exactly like the static lock ids.

Known blind spots (docs/operations.md): locks allocated *before*
:func:`install` (module-level locks of already-imported modules),
``from time import sleep`` aliases bound before install, and locks in
subprocesses (the chaos harness's event servers witness only the
harness side). Stdlib-only by the analysis package's own manifest
entry.

The port's copy of ``predictionio_tpu/analysis/witness.py``. With the
default root a lock is repo-allocated when a ``predictionio_tpu_torch``
frame allocates it (test and script frames drive the port, they are not
its locks); a root given explicitly keeps the reference's rule, any file
under it. The static side is the port's package too
(:func:`build_program`): its classes carry the reference's names, so over
the whole repository every short lock name would match two static ids
and no witnessed edge could be attributed.
"""

from __future__ import annotations

import json
import linecache
import os
import re
import sys
import threading
import time
from typing import Any, Callable

from predictionio_tpu_torch.analysis.callgraph import digraph_cycles

__all__ = [
    "PORT_PACKAGE",
    "LockWitness",
    "active",
    "build_program",
    "classify_static_cycles",
    "install",
    "report",
    "run_with_witness",
    "uninstall",
]

#: one acquisition held longer than this is counted as a "long hold" —
#: the witnessed analog of blocking-while-holding-the-serving-lock
DEFAULT_LONG_HOLD_MS = 50.0

#: bounded per-site hold-time reservoir
_SAMPLES = 512

#: the real factories, captured at import — before any witness could
#: have patched them, so nested witness construction can never capture
#: a wrapper as "the original"
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_SLEEP = time.sleep

#: the package whose frames and sources the port's witnesses cover
PORT_PACKAGE = "predictionio_tpu_torch"


def _repo_root() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def witnessed_prefix(root: str | None) -> tuple[str, str]:
    """``(root, rel_prefix)`` a witness records under: the repo root and
    the port's package by default, else everything under ``root``."""
    if root is None:
        return os.path.abspath(_repo_root()) + os.sep, PORT_PACKAGE + "/"
    return os.path.abspath(root) + os.sep, ""


def program_package(root: str) -> str | None:
    """The part of ``root`` the static side reads: the port's package
    where ``root`` holds it, else the whole tree."""
    return PORT_PACKAGE if os.path.isdir(os.path.join(root, PORT_PACKAGE)) else None


_ASSIGN_RE = re.compile(r"(?:self\.)?([A-Za-z_][A-Za-z0-9_]*)\s*(?::[^=]+)?=")


def _percentile(samples: list[float], q: float) -> float | None:
    if not samples:
        return None
    s = sorted(samples)
    return s[min(len(s) - 1, int(q * len(s)))]


class _Entry:
    """One live acquisition. Mutable on purpose: a ``threading.Lock``
    may legally be released by a thread other than the acquirer (handoff
    patterns), and that releasing thread cannot reach the owner's
    thread-local stack — it retires the entry through the wrapper
    instead (``alive = False``), and the owner's stack drops the husk
    lazily on its next acquisition."""

    __slots__ = ("site", "wrapper", "t0", "alive")

    def __init__(self, site: str, wrapper: Any, t0: float) -> None:
        self.site = site
        self.wrapper = wrapper
        self.t0 = t0
        self.alive = True


class _Held:
    """Per-thread stack of live :class:`_Entry` acquisitions."""

    __slots__ = ("stack",)

    def __init__(self) -> None:
        self.stack: list[_Entry] = []


class LockWitness:
    """Recording state + the Lock/RLock wrapper factories. One instance
    is installed at a time (module-level :func:`install`)."""

    def __init__(
        self,
        root: str | None = None,
        long_hold_ms: float = DEFAULT_LONG_HOLD_MS,
    ):
        self.root, self.prefix = witnessed_prefix(root)
        self.long_hold_ms = long_hold_ms
        # the import-time real factories: raw-lock allocation and the
        # wrapper's actual sleeping always go through these, so nesting
        # can never stack wrapper-on-wrapper
        self._orig_lock: Callable[..., Any] = _REAL_LOCK
        self._orig_rlock: Callable[..., Any] = _REAL_RLOCK
        self._orig_sleep: Callable[..., Any] = _REAL_SLEEP
        # whatever install() displaced — possibly an OUTER witness's
        # factories, which uninstall() must hand back, not clobber with
        # the real ones (a nested run_with_witness/pio tsan would
        # otherwise silently un-patch the outer witness)
        self._saved_lock: Callable[..., Any] | None = None
        self._saved_rlock: Callable[..., Any] | None = None
        self._saved_sleep: Callable[..., Any] | None = None
        # internal mutex from the REAL lock factory (never witnessed,
        # even when constructed while another witness is installed)
        self._mu = _REAL_LOCK()
        self._tls = threading.local()
        # site -> {"acquisitions": int, "contended": int, "long_holds":
        #          int, "holds": [ms, ...]}
        self.locks: dict[str, dict] = {}
        # (outer_site, inner_site) -> count
        self.edges: dict[tuple[str, str], int] = {}
        # lock site -> {"count": int, "seconds": float} for time.sleep
        # while the lock is held (innermost witnessed lock attributed)
        self.sleeps_under_lock: dict[str, dict] = {}
        self.installed = False

    # ------------------------------------------------------------ plumbing
    def _held(self) -> _Held:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = _Held()
            self._tls.held = h
        return h

    def _site_name(self) -> str | None:
        """Allocation site of the Lock() call being intercepted, or None
        when the allocation is not from code under ``root``."""
        # the immediate caller decides: a repo file -> witness the lock;
        # anything else (stdlib threading.py allocating an Event/
        # Condition lock on a repo object's behalf, queue internals,
        # third-party code) -> hand back a raw lock. Walking further up
        # would wrap stdlib-internal locks and attribute them to repo
        # call sites — phantom nodes in the order digraph.
        f = sys._getframe(2)  # caller of the factory wrapper
        here = os.path.dirname(os.path.abspath(__file__))
        while f is not None and f.f_code.co_filename.startswith(here):
            f = f.f_back
        if f is None:
            return None
        fn = os.path.abspath(f.f_code.co_filename)
        if not fn.startswith(self.root):
            return None
        rel = fn[len(self.root):].replace(os.sep, "/")
        if not rel.startswith(self.prefix):
            return None
        line = linecache.getline(fn, f.f_lineno).strip()
        m = _ASSIGN_RE.match(line)
        attr = m.group(1) if m else None
        if attr and f.f_code.co_name == "__init__" and "self" in f.f_locals:
            cls = type(f.f_locals["self"]).__name__
            return f"{cls}.{attr}"
        if attr and f.f_code.co_name == "<module>":
            stem = os.path.splitext(os.path.basename(rel))[0]
            return f"{stem}.{attr}"
        return f"{rel}:{f.f_lineno}"

    def _stats_for(self, site: str) -> dict:
        st = self.locks.get(site)
        if st is None:
            st = {"acquisitions": 0, "contended": 0, "long_holds": 0, "holds": []}
            self.locks[site] = st
        return st

    # ------------------------------------------------------------- recording
    def record_acquire(self, site: str, wrapper: Any, waited_s: float) -> None:
        now = time.perf_counter()
        held = self._held()
        # drop husks: entries retired by a cross-thread release, plus any
        # earlier entry for this same wrapper (re-acquiring a plain Lock
        # proves it was released elsewhere) — a dead entry must never
        # fabricate ordering edges
        held.stack = [
            e for e in held.stack if e.alive and e.wrapper is not wrapper
        ]
        with self._mu:
            st = self._stats_for(site)
            st["acquisitions"] += 1
            if waited_s > 0.001:
                st["contended"] += 1
            for outer in held.stack:
                if outer.site != site:
                    key = (outer.site, site)
                    self.edges[key] = self.edges.get(key, 0) + 1
        entry = _Entry(site, wrapper, now)
        held.stack.append(entry)
        # the release side's cross-thread handle: real-lock semantics
        # order this store before any other thread's legal release
        wrapper._entry = entry

    def _finish(self, entry: _Entry, now: float) -> None:
        entry.alive = False
        if entry.wrapper._entry is entry:
            entry.wrapper._entry = None
        hold_ms = (now - entry.t0) * 1e3
        with self._mu:
            st = self._stats_for(entry.site)
            if len(st["holds"]) < _SAMPLES:
                st["holds"].append(hold_ms)
            else:  # keep extremes visible: replace the minimum
                mn = min(range(_SAMPLES), key=lambda j: st["holds"][j])
                if hold_ms > st["holds"][mn]:
                    st["holds"][mn] = hold_ms
            if hold_ms >= self.long_hold_ms:
                st["long_holds"] += 1

    def record_release(self, site: str, wrapper: Any) -> None:
        held = self._held()
        now = time.perf_counter()
        for i in range(len(held.stack) - 1, -1, -1):
            e = held.stack[i]
            if e.wrapper is wrapper and e.alive:
                held.stack.pop(i)
                self._finish(e, now)
                return
        # not on this thread's stack: a cross-thread Lock release
        # (handoff pattern). Retire the acquirer's entry through the
        # wrapper so its hold time is recorded and the husk left in the
        # acquirer's stack can never count as "held" again.
        e = wrapper._entry
        if e is not None and e.alive:
            self._finish(e, now)

    def record_sleep(self, seconds: float) -> None:
        held = self._held()
        site = None
        for e in reversed(held.stack):  # innermost witnessed lock
            if e.alive:
                site = e.site
                break
        if site is None:
            return
        with self._mu:
            ev = self.sleeps_under_lock.setdefault(
                site, {"count": 0, "seconds": 0.0}
            )
            ev["count"] += 1
            ev["seconds"] += float(seconds)

    # ------------------------------------------------------------- patching
    def install(self) -> None:
        if self.installed:
            return
        witness = self

        def make_lock():
            site = witness._site_name()
            real = witness._orig_lock()
            if site is None:
                return real
            return _WitnessLock(witness, site, real)

        def make_rlock():
            site = witness._site_name()
            real = witness._orig_rlock()
            if site is None:
                return real
            return _WitnessRLock(witness, site, real)

        def sleep(seconds):
            witness.record_sleep(seconds)
            return witness._orig_sleep(seconds)

        self._saved_lock = threading.Lock
        self._saved_rlock = threading.RLock
        self._saved_sleep = time.sleep
        threading.Lock = make_lock  # type: ignore[assignment]
        threading.RLock = make_rlock  # type: ignore[assignment]
        time.sleep = sleep  # type: ignore[assignment]
        self.installed = True

    def uninstall(self) -> None:
        if not self.installed:
            return
        threading.Lock = self._saved_lock  # type: ignore[assignment]
        threading.RLock = self._saved_rlock  # type: ignore[assignment]
        time.sleep = self._saved_sleep  # type: ignore[assignment]
        self._saved_lock = self._saved_rlock = self._saved_sleep = None
        self.installed = False

    # --------------------------------------------------------------- report
    def inversions(
        self, edges: dict[tuple[str, str], int] | None = None
    ) -> list[dict]:
        """Cycles in the witnessed acquisition digraph — lock-order
        inversions actually exercised by this run. Cycle enumeration is
        :func:`callgraph.digraph_cycles`, the same helper the static
        PIO207 rule uses, so the two halves of the concurrency story can
        never drift on what counts as a cycle. ``edges`` is a snapshot
        already taken under ``_mu`` (``report()``'s case); without one,
        snapshot here — wrappers created before :meth:`uninstall` keep
        recording after it, so iterating ``self.edges`` live would race
        their inserts."""
        if edges is None:
            with self._mu:
                edges = dict(self.edges)
        out = []
        for nodes in digraph_cycles(edges):
            ring = nodes + [nodes[0]]
            out.append(
                {
                    "cycle": ring,
                    "counts": [
                        edges.get((a, b), 0) for a, b in zip(ring, ring[1:])
                    ],
                }
            )
        return out

    def report(self) -> dict:
        with self._mu:
            edges_snapshot = dict(self.edges)
            locks = {
                site: {
                    "acquisitions": st["acquisitions"],
                    "contended": st["contended"],
                    "longHolds": st["long_holds"],
                    "holdMs": {
                        "p50": _percentile(st["holds"], 0.50),
                        "p95": _percentile(st["holds"], 0.95),
                        "p99": _percentile(st["holds"], 0.99),
                        "max": max(st["holds"]) if st["holds"] else None,
                    },
                }
                for site, st in sorted(self.locks.items())
            }
            edges = [
                {"from": a, "to": b, "count": n}
                for (a, b), n in sorted(self.edges.items())
            ]
            sleeps = [
                {"lock": site, "count": ev["count"],
                 "seconds": round(ev["seconds"], 3)}
                for site, ev in sorted(self.sleeps_under_lock.items())
            ]
        return {
            "longHoldThresholdMs": self.long_hold_ms,
            "locks": locks,
            "edges": edges,
            "inversions": self.inversions(edges_snapshot),
            "sleepsUnderLock": sleeps,
        }


class _WitnessLock:
    """Drop-in for a ``threading.Lock`` instance. No ``_release_save``
    etc. on purpose: ``threading.Condition`` detects their absence and
    uses its plain-lock fallbacks."""

    __slots__ = ("_w", "_site", "_real", "_entry")

    def __init__(self, witness: LockWitness, site: str, real: Any):
        self._w = witness
        self._site = site
        self._real = real
        self._entry = None  # current _Entry, for cross-thread release

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        t0 = time.perf_counter()
        got = self._real.acquire(blocking, timeout)
        if got:
            self._w.record_acquire(
                self._site, self, time.perf_counter() - t0
            )
        return got

    def release(self) -> None:
        self._w.record_release(self._site, self)
        self._real.release()

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<WitnessLock {self._site} {self._real!r}>"


class _WitnessRLock:
    """Drop-in for ``threading.RLock``: reentrant, and it exposes the
    ``_release_save``/``_acquire_restore``/``_is_owned`` trio so
    ``threading.Condition`` keeps its RLock fast path — with held-set
    bookkeeping in both, so a Condition.wait() releasing the lock never
    leaves a phantom entry in the witness's held stack."""

    __slots__ = ("_w", "_site", "_real", "_depth", "_entry")

    def __init__(self, witness: LockWitness, site: str, real: Any):
        self._w = witness
        self._site = site
        self._real = real
        self._depth = 0  # owner-thread only state (guarded by the lock)
        self._entry = None  # current _Entry, for record_release symmetry

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        t0 = time.perf_counter()
        got = self._real.acquire(blocking, timeout)
        if got:
            self._depth += 1
            if self._depth == 1:
                self._w.record_acquire(
                    self._site, self, time.perf_counter() - t0
                )
        return got

    def release(self) -> None:
        self._depth -= 1
        if self._depth == 0:
            self._w.record_release(self._site, self)
        self._real.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition integration ------------------------------------------------
    def _release_save(self):
        depth = self._depth
        self._depth = 0
        self._w.record_release(self._site, self)
        state = self._real._release_save()
        return (state, depth)

    def _acquire_restore(self, state) -> None:
        real_state, depth = state
        self._real._acquire_restore(real_state)
        self._depth = depth
        self._w.record_acquire(self._site, self, 0.0)

    def _is_owned(self) -> bool:
        return self._real._is_owned()

    def __repr__(self) -> str:
        return f"<WitnessRLock {self._site} {self._real!r}>"


# ---------------------------------------------------------------------------
# Module-level singleton + static-cycle classification
# ---------------------------------------------------------------------------

_ACTIVE: LockWitness | None = None


def install(
    root: str | None = None, long_hold_ms: float = DEFAULT_LONG_HOLD_MS
) -> LockWitness:
    """Install (or return the already-installed) witness."""
    global _ACTIVE
    if _ACTIVE is not None and _ACTIVE.installed:
        return _ACTIVE
    _ACTIVE = LockWitness(root=root, long_hold_ms=long_hold_ms)
    _ACTIVE.install()
    return _ACTIVE


def active() -> LockWitness | None:
    return _ACTIVE if (_ACTIVE is not None and _ACTIVE.installed) else None


def uninstall() -> None:
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.uninstall()


def report() -> dict:
    return _ACTIVE.report() if _ACTIVE is not None else {}


def _short2(lock_id: str) -> str:
    """Static lock id -> witness site name: the last two dotted
    components (``pkg.mod.Class.attr`` -> ``Class.attr``; module-level
    ``pkg.mod.NAME`` -> ``mod.NAME``)."""
    return ".".join(lock_id.split(".")[-2:])


def classify_static_cycles(
    static_cycles: list[dict], witness_report: dict
) -> list[dict]:
    """Join the static ``PIO207`` cycles against a witness run: a cycle
    whose every edge was witnessed is CONFIRMED (this workload really
    acquires those locks in both orders — a deadlock needs only an
    unlucky schedule); anything less stays PLAUSIBLE (fix or prove the
    path dead).

    The join truncates static ids to the witness's site naming
    (``Class.attr``); when two static lock ids across the cycle set
    collapse to the SAME short name (same-named classes in different
    modules, same-stem module files), an edge touching that name can no
    longer prove anything about a specific cycle — it is excluded from
    the join, so a name collision degrades to PLAUSIBLE instead of
    falsely CONFIRMING an unexercised cycle."""
    witnessed = {
        (e["from"], e["to"]) for e in witness_report.get("edges", ())
    }
    by_short: dict[str, set[str]] = {}
    for cyc in static_cycles:
        for n in cyc["cycle"]:
            by_short.setdefault(_short2(n), set()).add(n)
    ambiguous = {s for s, ids in by_short.items() if len(ids) > 1}
    out = []
    for cyc in static_cycles:
        ring = [_short2(n) for n in cyc["cycle"]]
        pairs = list(zip(ring, ring[1:]))
        seen = [
            p
            for p in pairs
            if p in witnessed
            and p[0] not in ambiguous
            and p[1] not in ambiguous
        ]
        out.append(
            {
                "cycle": cyc["cycle"],
                "status": "CONFIRMED" if len(seen) == len(pairs) else "PLAUSIBLE",
                "witnessedEdges": len(seen),
                "totalEdges": len(pairs),
            }
        )
    return out


def build_program(root: str | None = None):
    """Parse ``root`` (defaults to this checkout) into the same
    :class:`~predictionio_tpu_torch.analysis.callgraph.ProgramContext` the
    program-scope lint rules receive — the shared entry point for every
    runtime-witness crosscheck (lock cycles here, the full lock-order
    edge join in :mod:`predictionio_tpu_torch.analysis.lock_witness`).
    Where ``root`` holds the port's package, only that package
    (:func:`program_package`)."""
    from predictionio_tpu_torch.analysis.engine import (
        FileContext,
        default_root,
        iter_tree_files,
    )
    from predictionio_tpu_torch.analysis.manifest import DEFAULT_MANIFEST
    from predictionio_tpu_torch.analysis.callgraph import (
        ProgramContext,
        build_callgraph,
    )

    root = os.path.abspath(root or default_root())
    contexts: dict[str, FileContext] = {}
    for abs_path, rel_path in iter_tree_files(root, program_package(root)):
        try:
            with open(abs_path, "r", encoding="utf-8", errors="replace") as fh:
                contexts[rel_path.replace(os.sep, "/")] = FileContext(
                    rel_path, fh.read(), DEFAULT_MANIFEST
                )
        except SyntaxError:
            continue
    graph = build_callgraph(contexts)
    return ProgramContext(contexts, graph)


def static_lock_cycles(root: str | None = None) -> list[dict]:
    """The static PIO207/PIO210 cycle set for ``root`` (defaults to this
    checkout), shared by ``pio tsan`` and the bench lint section."""
    from predictionio_tpu_torch.analysis.rules_program import lock_order_cycles

    return lock_order_cycles(build_program(root))


def run_with_witness(
    thunk: Callable[[], Any],
    root: str | None = None,
    long_hold_ms: float = DEFAULT_LONG_HOLD_MS,
) -> tuple[Any, dict]:
    """Run ``thunk`` under a freshly-installed witness; returns
    ``(thunk_result, witness_report)``. Always uninstalls."""
    global _ACTIVE
    prev = _ACTIVE
    w = LockWitness(root=root, long_hold_ms=long_hold_ms)
    _ACTIVE = w
    w.install()
    try:
        result = thunk()
    finally:
        w.uninstall()
        _ACTIVE = prev
    return result, w.report()


def tsan_report(
    witness_report: dict, root: str | None = None
) -> dict:
    """The ``pio tsan`` / pytest ``--lock-witness`` report body: the raw
    witness data plus the CONFIRMED/PLAUSIBLE classification of every
    static PIO207 cycle."""
    cycles = static_lock_cycles(root)
    classified = classify_static_cycles(cycles, witness_report)
    return {
        "witness": witness_report,
        "staticLockCycles": classified,
        "ok": not witness_report.get("inversions"),
    }


def write_report(path: str, payload: dict) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
