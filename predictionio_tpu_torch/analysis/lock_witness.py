"""Runtime lock/fsync witness — the dynamic half of the whole-program
race & crash-consistency story (PIO207/PIO210/PIO211 and PIO501-504).

:mod:`predictionio_tpu_torch.analysis.witness` records what locks *actually*
nest at runtime; this module composes it with a **durability witness**
that records what actually gets fsynced and renamed, then cross-checks
both against the static analyzer — in BOTH directions:

* **dynamic -> static** (analyzer completeness): every lock-order edge
  witnessed at runtime must exist in the static lock digraph
  (:func:`rules_program.lock_order_edges`). A witnessed edge with no
  static counterpart is an **analyzer gap** — the callgraph missed a
  call path or a lock acquisition — and fails the crosscheck, so the
  static rules can never silently rot as the codebase grows.
* **static -> dynamic** (finding liveness): every static lock-order
  cycle that never manifests under the workload must carry an explicit
  waiver entry in ``lock-witness-waivers.json`` (with a reason), or the
  crosscheck fails — a cycle nobody can reproduce *or* justify is
  either a false positive to fix in the analyzer or a latent deadlock
  nobody has exercised yet; both demand a human decision on record.

The durability half patches :func:`os.fsync`/:func:`os.fdatasync` (fd
resolved to a path via ``/proc/self/fd``) and
:func:`os.replace`/:func:`os.rename`, recording for every repo-issued
rename whether the source was fsynced before it and whether the
destination's parent directory was fsynced after it — the runtime shape
of the PIO501/PIO502 protocol. Those lists are informational (test tmp
files legitimately skip fsync); the lock crosscheck is the gate.

Wired behind ``pio lint --witness REPORT.json`` (join a recorded run
against the current tree) and pytest's ``--lock-witness`` flag (record
the suite and crosscheck at session end). Stdlib-only by the analysis
package's manifest contract.

Known blind spots: fd->path resolution needs ``/proc`` (non-Linux hosts
record fsyncs without paths, so ``srcFsynced`` stays False there), and
renames performed by subprocesses are invisible — same scope rules as
the lock witness itself.

The port's copy of ``predictionio_tpu/analysis/lock_witness.py``: with
the default root it records the port's frames and joins against the
port's package (:func:`~predictionio_tpu_torch.analysis.witness.build_program`);
waivers come from the repository's ``lock-witness-waivers.json``.
"""

from __future__ import annotations

import json
import os
import sys
import threading  # noqa: F401  (documents what we deliberately do NOT patch)
from typing import Any, Callable

from predictionio_tpu_torch.analysis.witness import (
    DEFAULT_LONG_HOLD_MS,
    LockWitness,
    _REAL_LOCK,
    _repo_root as _default_root,
    _short2,
    build_program,
    witnessed_prefix,
)

__all__ = [
    "FsyncWitness",
    "LockFsyncWitness",
    "crosscheck",
    "default_waivers_path",
    "load_waivers",
    "lockwitness_report",
    "run_with_lock_witness",
]

#: the real syscall wrappers, captured at import time — nested installs
#: always call through these, never through a wrapper
_REAL_FSYNC = os.fsync
_REAL_FDATASYNC = os.fdatasync
_REAL_REPLACE = os.replace
_REAL_RENAME = os.rename


class FsyncWitness:
    """Records fsync/rename orderings issued by code under ``root``."""

    def __init__(self, root: str | None = None):
        self.root, self.prefix = witnessed_prefix(root)
        # real lock on purpose: allocating threading.Lock() here while a
        # LockWitness is installed would witness OUR bookkeeping mutex
        # and attribute it to whatever repo frame called install()
        self._mu = _REAL_LOCK()
        self.fsync_calls = 0
        #: realpaths fsynced so far (files and directories)
        self.fsynced: set[str] = set()
        #: rename records, in issue order
        self.renames: list[dict] = []
        self._saved: dict[str, Any] = {}
        self.installed = False

    # ------------------------------------------------------------ plumbing
    def _caller_site(self) -> str | None:
        """``relpath:line`` of the repo frame issuing the syscall, or
        None when the call comes from stdlib/third-party code (pytest
        and tempfile rename constantly; only repo-issued operations are
        evidence about OUR durability protocol)."""
        f = sys._getframe(2)  # caller of the patched os.* wrapper
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
        return f"{rel}:{f.f_lineno}"

    @staticmethod
    def _fd_path(fd: int) -> str | None:
        try:
            return os.readlink(f"/proc/self/fd/{int(fd)}")
        except (OSError, ValueError, TypeError):
            return None

    # ------------------------------------------------------------ recording
    def _record_fsync(self, fd: Any) -> None:
        site = self._caller_site()
        if site is None:
            return
        path = self._fd_path(fd)
        with self._mu:
            self.fsync_calls += 1
            if path is None:
                return
            self.fsynced.add(path)
            if os.path.isdir(path):
                # a directory fsync makes every prior rename INTO that
                # directory durable — close out the pending records
                for r in self.renames:
                    if not r["dirFsynced"] and r["dstDir"] == path:
                        r["dirFsynced"] = True

    def _record_rename(self, op: str, asrc: str, adst: str) -> None:
        site = self._caller_site()
        if site is None:
            return
        dst_dir = os.path.dirname(adst)
        with self._mu:
            self.renames.append(
                {
                    "op": op,
                    "src": asrc,
                    "dst": adst,
                    "dstDir": dst_dir,
                    "site": site,
                    "srcFsynced": asrc in self.fsynced,
                    "dirFsynced": False,
                }
            )

    # ------------------------------------------------------------- patching
    def install(self) -> None:
        if self.installed:
            return
        w = self

        def fsync(fd):
            result = _REAL_FSYNC(fd)
            w._record_fsync(fd)  # only a COMPLETED fsync counts
            return result

        def fdatasync(fd):
            result = _REAL_FDATASYNC(fd)
            w._record_fsync(fd)
            return result

        def _renaming(op: str, real: Callable[..., Any]):
            def wrapper(src, dst, *, src_dir_fd=None, dst_dir_fd=None):
                # resolve BEFORE the real call: src stops existing after
                asrc = adst = None
                if src_dir_fd is None and dst_dir_fd is None:
                    try:
                        asrc = os.path.realpath(os.fspath(src))
                        adst = os.path.join(
                            os.path.realpath(
                                os.path.dirname(os.path.abspath(
                                    os.fspath(dst)
                                )) or "."
                            ),
                            os.path.basename(os.fspath(dst)),
                        )
                    except (TypeError, ValueError, OSError):
                        asrc = adst = None
                result = real(
                    src, dst, src_dir_fd=src_dir_fd, dst_dir_fd=dst_dir_fd
                )
                if asrc is not None and adst is not None:
                    w._record_rename(op, asrc, adst)
                return result

            return wrapper

        self._saved = {
            "fsync": os.fsync,
            "fdatasync": os.fdatasync,
            "replace": os.replace,
            "rename": os.rename,
        }
        os.fsync = fsync  # type: ignore[assignment]
        os.fdatasync = fdatasync  # type: ignore[assignment]
        os.replace = _renaming("replace", _REAL_REPLACE)  # type: ignore
        os.rename = _renaming("rename", _REAL_RENAME)  # type: ignore
        self.installed = True

    def uninstall(self) -> None:
        if not self.installed:
            return
        # hand back whatever install() displaced (possibly an outer
        # witness's wrappers), mirroring LockWitness nesting semantics
        os.fsync = self._saved["fsync"]  # type: ignore[assignment]
        os.fdatasync = self._saved["fdatasync"]  # type: ignore[assignment]
        os.replace = self._saved["replace"]  # type: ignore[assignment]
        os.rename = self._saved["rename"]  # type: ignore[assignment]
        self._saved = {}
        self.installed = False

    # --------------------------------------------------------------- report
    def report(self) -> dict:
        with self._mu:
            renames = [dict(r) for r in self.renames]
            fsync_calls = self.fsync_calls
        for r in renames:
            r.pop("dstDir", None)
        return {
            "fsyncCalls": fsync_calls,
            "renames": renames,
            "renamesWithoutFsync": [
                r for r in renames if not r["srcFsynced"]
            ],
            "renamesWithoutDirFsync": [
                r for r in renames if not r["dirFsynced"]
            ],
        }


class LockFsyncWitness:
    """The composed witness: lock-order digraph + fsync/rename record,
    installed and uninstalled as one unit."""

    def __init__(
        self,
        root: str | None = None,
        long_hold_ms: float = DEFAULT_LONG_HOLD_MS,
    ):
        self.locks = LockWitness(root=root, long_hold_ms=long_hold_ms)
        self.fsyncs = FsyncWitness(root=root)

    def install(self) -> None:
        self.locks.install()
        self.fsyncs.install()

    def uninstall(self) -> None:
        # LIFO, so nested installs unwind cleanly
        self.fsyncs.uninstall()
        self.locks.uninstall()

    def report(self) -> dict:
        rep = self.locks.report()
        rep["fsync"] = self.fsyncs.report()
        return rep


# ---------------------------------------------------------------------------
# Waivers
# ---------------------------------------------------------------------------


def default_waivers_path(root: str | None = None) -> str:
    return os.path.join(
        os.path.abspath(root or _default_root()), "lock-witness-waivers.json"
    )


def load_waivers(path: str | None = None) -> list[dict]:
    """``lock-witness-waivers.json`` entries: ``{"cycle": [lock ids in
    canonical order], "reason": "..."}``. Absent file means no waivers.
    Entries without a non-empty reason are dropped (same contract as the
    in-source ``waive=`` pragma: a justification is mandatory)."""
    path = path or default_waivers_path()
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        return []
    entries = doc.get("cycles", []) if isinstance(doc, dict) else []
    out = []
    for e in entries:
        if (
            isinstance(e, dict)
            and isinstance(e.get("cycle"), list)
            and str(e.get("reason", "")).strip()
        ):
            out.append({"cycle": [str(n) for n in e["cycle"]],
                        "reason": str(e["reason"]).strip()})
    return out


# ---------------------------------------------------------------------------
# Crosscheck: dynamic <-> static, both directions
# ---------------------------------------------------------------------------


def crosscheck(
    witness_report: dict,
    root: str | None = None,
    waivers: list[dict] | None = None,
    program=None,
) -> dict:
    """Join a witness run against the static lock graph, both ways.

    Returns ``{"ok", "dynamicEdges", "staticEdges", "gaps",
    "unmappedEdges", "unwaivedStaticCycles", "waivedStaticCycles",
    "staleWaivers"}``. ``ok`` is False when any **gap** exists (a
    witnessed edge between two statically-known locks that the static
    digraph lacks) or any static cycle neither manifested fully at
    runtime nor carries a waiver.

    The dynamic->static join uses the witness's site naming
    (``Class.attr`` / ``stem.NAME``): a dynamic site that matches no
    static lock id, or whose short name is ambiguous across static ids
    (same-named classes in different modules), cannot prove a gap — its
    edges land in ``unmappedEdges`` instead of failing the run, so the
    gate never fires on evidence it cannot attribute."""
    from predictionio_tpu_torch.analysis.rules_program import (
        lock_order_cycles,
        lock_order_edges,
    )

    if program is None:
        program = build_program(root)
    static_edges = lock_order_edges(program)
    static_cycles = lock_order_cycles(program)

    # universe of statically-known lock ids, short-name indexed
    static_ids: set[str] = set()
    for fi in program.graph.functions.values():
        for acq in fi.acquisitions:
            static_ids.add(acq.lock_id)
    by_short: dict[str, set[str]] = {}
    for lid in static_ids:
        by_short.setdefault(_short2(lid), set()).add(lid)

    def _map(site: str) -> tuple[str | None, str]:
        """-> (static id | None, why-unmapped)."""
        if ":" in site:  # path:line fallback naming — no static analog
            return None, "anonymous-site"
        cands = by_short.get(site, set())
        if not cands:
            return None, "unknown-to-static"
        if len(cands) > 1:
            return None, "ambiguous-short-name"
        return next(iter(cands)), ""

    static_pairs = {(e["from"], e["to"]) for e in static_edges}
    gaps: list[dict] = []
    unmapped: list[dict] = []
    dynamic_edges = witness_report.get("edges", [])
    for e in dynamic_edges:
        a, b, n = e["from"], e["to"], e.get("count", 1)
        sa, why_a = _map(a)
        sb, why_b = _map(b)
        if sa is None or sb is None:
            unmapped.append(
                {"from": a, "to": b, "count": n,
                 "why": why_a or why_b}
            )
            continue
        if (sa, sb) not in static_pairs:
            gaps.append(
                {"from": a, "to": b, "count": n,
                 "staticFrom": sa, "staticTo": sb}
            )

    # static -> dynamic: every cycle must fully manifest or be waived
    witnessed_pairs = {(e["from"], e["to"]) for e in dynamic_edges}
    waivers = load_waivers() if waivers is None else waivers
    waived_cycles = {tuple(w["cycle"]): w["reason"] for w in waivers}
    unwaived: list[dict] = []
    waived_out: list[dict] = []
    manifested_keys: set[tuple] = set()
    for cyc in static_cycles:
        # cycle rings arrive closed (first node repeated last): the
        # consecutive pairs already wrap, no re-closing needed
        ring = [_short2(n) for n in cyc["cycle"]]
        if len(ring) > 1 and ring[0] == ring[-1]:
            ring = ring[:-1]
        pairs = list(zip(ring, ring[1:] + ring[:1]))
        # short-name ambiguity degrades "manifested" exactly like
        # classify_static_cycles degrades CONFIRMED
        ambiguous = any(len(by_short.get(s, ())) > 1 for s in ring)
        manifested = (not ambiguous) and all(
            p in witnessed_pairs for p in pairs
        )
        key = tuple(cyc["cycle"])
        if manifested:
            manifested_keys.add(key)
            continue
        if key in waived_cycles:
            waived_out.append(
                {"cycle": cyc["cycle"], "reason": waived_cycles[key]}
            )
        else:
            unwaived.append(
                {
                    "cycle": cyc["cycle"],
                    "witnessedEdges": sum(
                        1 for p in pairs if p in witnessed_pairs
                    ),
                    "totalEdges": len(pairs),
                }
            )

    # waiver hygiene: entries naming cycles that no longer exist
    # statically, or that DID manifest this run, should be deleted
    static_keys = {tuple(c["cycle"]) for c in static_cycles}
    stale = [
        {"cycle": list(k), "reason": r}
        for k, r in waived_cycles.items()
        if k not in static_keys or k in manifested_keys
    ]

    return {
        "ok": not gaps and not unwaived,
        "dynamicEdges": len(dynamic_edges),
        "staticEdges": len(static_edges),
        "gaps": gaps,
        "unmappedEdges": unmapped,
        "unwaivedStaticCycles": unwaived,
        "waivedStaticCycles": waived_out,
        "staleWaivers": stale,
    }


def lockwitness_report(
    combined_report: dict,
    root: str | None = None,
    waivers: list[dict] | None = None,
) -> dict:
    """The full ``pio lint --witness`` / pytest ``--lock-witness``
    payload: raw witness data, the ``pio tsan``-style CONFIRMED/
    PLAUSIBLE classification of every static cycle, and the two-way
    crosscheck verdict. ``ok`` is the overall gate: no witnessed
    inversion AND a passing crosscheck."""
    from predictionio_tpu_torch.analysis.rules_program import lock_order_cycles
    from predictionio_tpu_torch.analysis.witness import classify_static_cycles

    program = build_program(root)
    cc = crosscheck(
        combined_report, root=root, waivers=waivers, program=program
    )
    return {
        "witness": combined_report,
        "staticLockCycles": classify_static_cycles(
            lock_order_cycles(program), combined_report
        ),
        "crosscheck": cc,
        "ok": not combined_report.get("inversions") and cc["ok"],
    }


def run_with_lock_witness(
    thunk: Callable[[], Any],
    root: str | None = None,
    long_hold_ms: float = DEFAULT_LONG_HOLD_MS,
    waivers: list[dict] | None = None,
) -> tuple[Any, dict]:
    """Run ``thunk`` under a fresh composed witness; returns
    ``(thunk_result, lockwitness_report payload)``. Always uninstalls."""
    import predictionio_tpu_torch.analysis.witness as _witness_mod

    w = LockFsyncWitness(root=root, long_hold_ms=long_hold_ms)
    prev = _witness_mod._ACTIVE
    _witness_mod._ACTIVE = w.locks
    w.install()
    try:
        result = thunk()
    finally:
        w.uninstall()
        _witness_mod._ACTIVE = prev
    rep = w.report()
    payload = lockwitness_report(rep, root=root, waivers=waivers)
    return result, payload
