"""PIO5xx — crash-consistency (durability protocol) rules.

The durable state this server cannot lose — registry lease entries,
stream segments, checkpoints, fleet topology, the model registry — is
published by exactly one idiom, the one ``data/storage/localfs.py``
spells out in full:

    write to a same-directory temp file -> flush -> ``os.fsync(fd)``
    -> ``os.replace(tmp, final)`` -> ``os.fsync(dir_fd)``

Each rule here catches one way of shortening that protocol. All four
are *flow-sensitive within one function* (event order by source
position), which is what distinguishes them from ``PIO403``'s coarse
"a replace and no fsync anywhere" check — and they run over the fleet/
online/ checkpoint surfaces ``PIO403`` deliberately leaves alone:

* ``PIO501`` rename without prior fsync of the temp file: the rename is
  durable before the data is — after a crash the final path exists but
  is empty or torn. Fires anywhere in the tree a function writes a file
  and then renames it into place (protocol intent is the write+rename
  pair itself), except under ``data/storage/`` where ``PIO403`` already
  owns the coarse version of this finding.
* ``PIO502`` missing parent-directory fsync after rename, durable roots
  only: the rename itself lives in the directory inode — without the
  directory fsync a crash can forget the file ever had its new name.
* ``PIO503`` direct write to a final path in a module that uses the
  temp+rename protocol elsewhere: readers (and crashes) can observe the
  half-written file.
* ``PIO504`` truncate-then-write of a live file: ``open(p, "w")`` on a
  path that is elsewhere in the same file the *destination* of an
  ``os.replace``/``os.rename`` — the atomically-published file is being
  clobbered in place, so a concurrent reader sees it empty.

Exemptions, shared with ``PIO403``: classes exposing an fsync toggle
(an ``fsync`` constructor parameter or ``self.*fsync*`` attribute) are
the operator's explicit durability dial — their write paths are a
choice, not an oversight. Individual reviewed sites use the waiver
pragma (``# piolint: waive=PIO502 -- reason``), never the baseline.
"""

from __future__ import annotations

import ast
from typing import Iterator

from predictionio_tpu_torch.analysis.engine import FileContext, Finding, rule
from predictionio_tpu_torch.analysis.rules_server import (
    _class_has_fsync_toggle,
    _opens_for_write,
)

#: packages whose files ARE the durability surface: everything under
#: them that renames must run the full protocol (directory fsync
#: included), and direct writes to final paths are findings
_DURABLE_PREFIXES = (
    "predictionio_tpu/data/storage/",
    "predictionio_tpu/fleet/",
    "predictionio_tpu/online/",
)

#: PIO403 owns the coarse fsyncless-replace finding here; PIO501 skips
#: the prefix so one bug never fires under two codes
_PIO403_PREFIX = "predictionio_tpu/data/storage/"


def _call_name(ctx: FileContext, node: ast.Call) -> str:
    """Dotted name of the call if resolvable, else the bare attribute /
    name text — enough to pattern-match fsync-ish helpers."""
    dotted = ctx.dotted_name(node.func)
    if dotted:
        return dotted
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return ""


def _is_fsync_call(name: str) -> bool:
    """``os.fsync``/``os.fdatasync`` or any helper whose name admits it
    syncs (``self._fsync_file``, ``_sync_dir``) — a helper-mediated
    fsync satisfies the protocol just as well."""
    low = name.lower()
    return "fsync" in low or "fdatasync" in low or "sync_dir" in low


def _expr_text(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on our input
        return ""


def _looks_tmp(text: str) -> bool:
    low = text.lower()
    return "tmp" in low or "temp" in low


class _FnScan:
    """Source-ordered durability events of one function body."""

    def __init__(self, ctx: FileContext, fn: ast.FunctionDef):
        self.writes: list[tuple[int, ast.Call, str]] = []  # (line, node, target text)
        self.fsyncs: list[int] = []  # lines of fsync-ish calls
        self.renames: list[tuple[int, ast.Call, str, str]] = []  # (line, node, src, dst)
        self.mkstemp = False
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(ctx, node)
            if name in ("os.replace", "os.rename") and len(node.args) >= 2:
                self.renames.append(
                    (
                        node.lineno,
                        node,
                        _expr_text(node.args[0]),
                        _expr_text(node.args[1]),
                    )
                )
            elif _is_fsync_call(name):
                self.fsyncs.append(node.lineno)
            elif name == "os.fdopen":
                # fd-based write: the path is unknowable here (and in
                # practice it is an mkstemp temp) — counts as a write
                # for ordering, never as a final-path target
                self.writes.append((node.lineno, node, ""))
            elif _opens_for_write(ctx, node):
                target = _expr_text(node.args[0]) if node.args else ""
                self.writes.append((node.lineno, node, target))
            elif name in ("tempfile.mkstemp", "mkstemp",
                          "tempfile.NamedTemporaryFile"):
                self.mkstemp = True

    def fsync_before(self, line: int) -> bool:
        return any(ln <= line for ln in self.fsyncs)

    def fsync_after(self, line: int) -> bool:
        return any(ln > line for ln in self.fsyncs)

    def write_before(self, line: int) -> bool:
        return any(ln < line for ln, _n, _t in self.writes)


def _exempt_functions(ctx: FileContext) -> set[ast.FunctionDef]:
    """Every function of every fsync-toggle class (PIO403's exemption:
    the operator chose the durability level)."""
    out: set[ast.FunctionDef] = set()
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        if not _class_has_fsync_toggle(cls):
            continue
        for fn in ast.walk(cls):
            if isinstance(fn, ast.FunctionDef):
                out.add(fn)
    return out


def _protocol_functions(
    ctx: FileContext,
) -> list[tuple[ast.FunctionDef, _FnScan]]:
    # all four PIO50x rules consume the same per-function scan; cache it
    # on the context so the tree is walked once per file, not once per rule
    cached = getattr(ctx, "_pio5xx_scans", None)
    if cached is not None:
        return cached
    exempt = _exempt_functions(ctx)
    scans = [
        (fn, _FnScan(ctx, fn))
        for fn in ast.walk(ctx.tree)
        if isinstance(fn, ast.FunctionDef) and fn not in exempt
    ]
    ctx._pio5xx_scans = scans
    return scans


@rule(
    "PIO501",
    "rename-before-fsync",
    "a written file is renamed into place before (or without) fsync of "
    "its data",
)
def check_rename_before_fsync(ctx: FileContext) -> Iterator[Finding]:
    if ctx.rel_path.startswith(_PIO403_PREFIX):
        return  # PIO403's coarse finding owns storage/
    for fn, scan in _protocol_functions(ctx):
        for line, node, src, _dst in scan.renames:
            if not scan.write_before(line):
                continue  # rename of a file this function never wrote
                # (claim/mv patterns): not a publish, not this rule
            if scan.fsync_before(line):
                continue
            yield ctx.finding(
                "PIO501",
                node,
                "os.replace publishes a write whose data was never "
                "fsync'd — after a crash the final path exists but is "
                "empty or torn; fsync the temp file's fd before the "
                "rename",
            )
            break  # one finding per function: the fix is one protocol


@rule(
    "PIO502",
    "rename-without-dir-fsync",
    "an atomic rename on a durable root is never followed by a "
    "parent-directory fsync",
)
def check_rename_without_dir_fsync(ctx: FileContext) -> Iterator[Finding]:
    if not ctx.rel_path.startswith(_DURABLE_PREFIXES):
        return
    for fn, scan in _protocol_functions(ctx):
        for line, node, src, _dst in scan.renames:
            if not scan.write_before(line):
                continue  # not a write-publish rename
            if not scan.fsync_before(line):
                continue  # PIO501's (or PIO403's) finding, worse first
            if scan.fsync_after(line):
                continue
            yield ctx.finding(
                "PIO502",
                node,
                "rename published without a parent-directory fsync — "
                "the new directory entry is only in the page cache; a "
                "crash can forget the file's new name (os.open the dir, "
                "os.fsync the fd, close)",
            )
            break


@rule(
    "PIO503",
    "direct-write-final-path",
    "a file is written in place (no temp + rename) in a module that "
    "uses the atomic-publish protocol",
)
def check_direct_write_final_path(ctx: FileContext) -> Iterator[Finding]:
    if not ctx.rel_path.startswith(_DURABLE_PREFIXES):
        return
    module_renames = any(
        isinstance(n, ast.Call)
        and _call_name(ctx, n) in ("os.replace", "os.rename")
        for n in ast.walk(ctx.tree)
    )
    if not module_renames:
        return  # no protocol intent anywhere in this module
    for fn, scan in _protocol_functions(ctx):
        if scan.renames or scan.mkstemp:
            continue  # this function runs (some of) the protocol
        for line, node, target in scan.writes:
            if not target or _looks_tmp(target):
                continue
            # append mode never truncates published bytes
            mode = ""
            if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
                mode = str(node.args[1].value)
            for kw in node.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = str(kw.value.value)
            if "a" in mode or "r" in mode:
                continue
            yield ctx.finding(
                "PIO503",
                node,
                "direct write to a final path in a module that publishes "
                "via temp+rename elsewhere — a crash or concurrent "
                "reader observes the half-written file; write a temp "
                "and os.replace it into place",
            )
            break


#: call-name fragments that count as replicating data toward a quorum
#: member (the mirror/append half of an ack protocol)
_MIRROR_FRAGMENTS = ("mirror", "append", "insert", "ingest", "write")


def _is_quorum_fn(name: str) -> bool:
    """Functions whose name claims quorum/ack semantics. Exact word
    parts, not substrings — ``rollback``/``fallback``/``pack`` must not
    match."""
    parts = name.lower().strip("_").split("_")
    return "quorum" in parts or "ack" in parts or "acked" in parts


@rule(
    "PIO505",
    "quorum-ack-before-fsync",
    "a quorum-ack function returns after replicating data with no fsync "
    "between the replication call and the return",
)
def check_quorum_ack_before_fsync(ctx: FileContext) -> Iterator[Finding]:
    """The replicated-append contract (``data/storage/replication.py``):
    an ack may only count a replica once that replica's bytes are
    fsync-durable — so in any function that *names itself* an ack/quorum
    step, every ``return`` must be preceded, between it and the last
    mirror/append-ish call, by an fsync-ish call. A return that follows
    a mirror with no fsync in between is an ack of page-cache bytes: a
    crash on the replica un-acknowledges an acknowledged write."""
    if not ctx.rel_path.startswith(_PIO403_PREFIX):
        return  # the quorum protocol lives on the storage surface only
    for fn, scan in _protocol_functions(ctx):
        if not _is_quorum_fn(fn.name):
            continue
        mirrors = [
            node.lineno
            for node in ast.walk(fn)
            if isinstance(node, ast.Call)
            and any(
                f in _call_name(ctx, node).lower()
                for f in _MIRROR_FRAGMENTS
            )
        ]
        if not mirrors:
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Return):
                continue
            last_mirror = max(
                (ln for ln in mirrors if ln < node.lineno), default=None
            )
            if last_mirror is None:
                continue  # return before any replication: nothing acked
            if any(last_mirror < ln <= node.lineno for ln in scan.fsyncs):
                continue
            yield ctx.finding(
                "PIO505",
                node,
                "quorum ack returns after a mirror/append with no fsync "
                "between them — the Q-th copy is page-cache only, so a "
                "replica crash silently un-acks an acknowledged write; "
                "fsync the replica's stream before counting it toward "
                "the quorum",
            )
            break  # one finding per function: the fix is one barrier


@rule(
    "PIO504",
    "truncate-live-file",
    "open(path, 'w') truncates a path that is elsewhere the destination "
    "of an atomic rename",
)
def check_truncate_live_file(ctx: FileContext) -> Iterator[Finding]:
    if not ctx.rel_path.startswith(_DURABLE_PREFIXES):
        return
    rename_dsts: set[str] = set()
    for n in ast.walk(ctx.tree):
        if (
            isinstance(n, ast.Call)
            and _call_name(ctx, n) in ("os.replace", "os.rename")
            and len(n.args) >= 2
        ):
            dst = _expr_text(n.args[1])
            if dst:
                rename_dsts.add(dst)
    if not rename_dsts:
        return
    for fn, scan in _protocol_functions(ctx):
        for line, node, target in scan.writes:
            if target in rename_dsts and not _looks_tmp(target):
                yield ctx.finding(
                    "PIO504",
                    node,
                    "truncate-then-write of a live file: this path is "
                    "elsewhere published by an atomic rename, and "
                    "open('w') empties it in place — readers between the "
                    "truncate and the close see nothing",
                )
