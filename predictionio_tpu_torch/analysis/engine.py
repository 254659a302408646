"""piolint core: rule registry, AST walker, suppressions, baseline.

Everything here is file-local and syntactic: a rule receives one parsed
module (:class:`FileContext`) and yields :class:`Finding`s. The engine
owns the cross-cutting mechanics every rule gets for free:

* ``file:line`` diagnostics with stable, line-free messages (so the
  baseline survives unrelated edits that shift line numbers);
* inline suppressions — ``# piolint: disable=PIO201`` on the reported
  line, or ``# piolint: disable-file=PIO301`` anywhere in the file;
* inline **waivers** — ``# piolint: waive=PIO501 -- reason text`` on the
  reported line: like a disable, but the engine verifies the reason is
  non-empty (``PIO001`` fires on a reasonless waiver, and the waived
  code still fires too). Waivers are the sanctioned way to accept a
  reviewed finding without growing the baseline, which is ratcheted to
  only ever shrink (tests/test_ci_guards.py);
* a checked-in JSON baseline (``piolint-baseline.json`` at the repo
  root): pre-existing, reviewed findings don't fail CI while any NEW
  finding does. Baseline entries match on (code, path, message) with a
  count, never on line numbers.

Stdlib-only by contract (manifest entry for this package): the linter
parses source text and must never import what it lints.

The port's copy of ``predictionio_tpu/analysis/engine.py``, with the
reference's skipped directories, baseline and exit-code contract; its
rule registry is its own. ``lint_tree`` can stop at one package of the
tree (``package=``), which the port's witnesses use: they record the
port's frames only, and no code outside the port's package is on its
paths.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Iterable, Iterator

from predictionio_tpu_torch.analysis.manifest import DEFAULT_MANIFEST, Manifest

__all__ = [
    "FileContext",
    "Finding",
    "LintResult",
    "all_rules",
    "lint_file",
    "lint_sources",
    "lint_tree",
    "load_baseline",
    "program_rule",
    "prune_baseline",
    "rule",
    "run_lint",
    "write_baseline",
]

#: default baseline filename, resolved against the lint root
BASELINE_NAME = "piolint-baseline.json"

#: directories never descended into by :func:`lint_tree`
_SKIP_DIRS = frozenset(
    {
        "tests", "__pycache__", "docs", "bin", "node_modules",
        # local tooling/vendored trees a dev checkout commonly grows —
        # linting third-party code would fail CI on a clean repo
        "venv", "build", "dist", "site-packages", "__pypackages__",
    }
)

_DISABLE_RE = re.compile(r"#\s*piolint:\s*disable=([A-Za-z0-9,\s]+)")
_DISABLE_FILE_RE = re.compile(r"#\s*piolint:\s*disable-file=([A-Za-z0-9,\s]+)")
#: ``# piolint: waive=PIO501 -- reviewed: cache file, rebuilt on boot``
#: — group 1 is the code list, group 2 the (mandatory) reason text
_WAIVE_RE = re.compile(
    r"#\s*piolint:\s*waive=([A-Za-z0-9,\s]+?)\s*(?:--\s*(.*))?$"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic. ``path`` is repo-relative posix; ``message`` must
    be stable across unrelated edits (no line numbers, no volatile
    state) because the baseline keys on (code, path, message). Anything
    volatile but useful — a shortest call chain that changes whenever an
    unrelated refactor adds a shorter path — goes in ``detail``: shown
    by :meth:`render`, never part of the baseline key."""

    code: str
    path: str
    line: int
    message: str
    detail: str = ""

    def render(self) -> str:
        tail = f" [{self.detail}]" if self.detail else ""
        return f"{self.path}:{self.line}: {self.code} {self.message}{tail}"

    def key(self) -> tuple[str, str, str]:
        return (self.code, self.path, self.message)


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    name: str
    description: str
    check: Callable[..., Iterable[Finding]]
    #: program-scope rules receive a ProgramContext (every parsed file +
    #: the cross-module call graph) instead of one FileContext, and run
    #: once per tree instead of once per file
    program: bool = False


#: code -> Rule; populated by the :func:`rule` decorator at import time
_RULES: dict[str, Rule] = {}


def rule(code: str, name: str, description: str):
    """Register a rule function under ``code`` (e.g. ``PIO201``). The
    function receives a :class:`FileContext` and yields findings; the
    engine applies suppressions and the baseline afterwards."""

    def deco(fn: Callable[["FileContext"], Iterable[Finding]]):
        if code in _RULES:
            raise ValueError(f"duplicate piolint rule code {code}")
        _RULES[code] = Rule(code, name, description, fn)
        return fn

    return deco


def program_rule(code: str, name: str, description: str):
    """Register a whole-program rule (``PIO206``–``PIO209``). The
    function receives a :class:`~predictionio_tpu.analysis.callgraph
    .ProgramContext` and yields findings anywhere in the tree; inline
    suppressions on the reported line and the baseline apply exactly as
    for per-file rules."""

    def deco(fn):
        if code in _RULES:
            raise ValueError(f"duplicate piolint rule code {code}")
        _RULES[code] = Rule(code, name, description, fn, program=True)
        return fn

    return deco


def all_rules() -> dict[str, Rule]:
    return dict(_RULES)


class FileContext:
    """One parsed module plus the lookups every rule wants.

    ``import_map`` resolves local names to absolute dotted modules —
    ``import numpy as np`` maps ``np -> numpy``; ``from time import
    sleep`` maps ``sleep -> time.sleep``; relative imports are resolved
    against the file's package path so layering rules compare absolute
    names only.
    """

    def __init__(self, rel_path: str, source: str, manifest: Manifest):
        self.rel_path = rel_path.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.manifest = manifest
        self.tree = ast.parse(source, filename=rel_path)
        self.import_map = self._build_import_map()

    # -------------------------------------------------------------- imports
    def package_parts(self) -> list[str]:
        """Dotted-package parts of this file's directory, e.g.
        ``predictionio_tpu/serving/batcher.py`` ->
        ``["predictionio_tpu", "serving"]``."""
        parts = self.rel_path.split("/")[:-1]
        return [p for p in parts if p]

    def resolve_relative(self, node: ast.ImportFrom) -> str:
        """Absolute dotted module for a (possibly relative) ImportFrom."""
        if node.level == 0:
            return node.module or ""
        base = self.package_parts()
        # level=1 is the current package, each extra level climbs one up
        up = node.level - 1
        base = base[: len(base) - up] if up else base
        mod = ".".join(base)
        if node.module:
            mod = f"{mod}.{node.module}" if mod else node.module
        return mod

    def iter_imports(self) -> Iterator[tuple[ast.AST, str]]:
        """Yield ``(node, absolute_module)`` for every import statement,
        including function-local ones (ast.walk)."""
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    yield node, alias.name
            elif isinstance(node, ast.ImportFrom):
                yield node, self.resolve_relative(node)

    def _build_import_map(self) -> dict[str, str]:
        out: dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else alias.name.split(".")[0]
                    out[local] = target
            elif isinstance(node, ast.ImportFrom):
                mod = self.resolve_relative(node)
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    out[local] = f"{mod}.{alias.name}" if mod else alias.name
        return out

    def dotted_name(self, node: ast.AST) -> str | None:
        """Absolute dotted name of a Name/Attribute chain, resolved
        through the import map: with ``import numpy as np``,
        ``np.asarray`` -> ``numpy.asarray``. None for anything fancier
        (subscripts, calls)."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.import_map.get(node.id, node.id)
        parts.append(root)
        return ".".join(reversed(parts))

    # -------------------------------------------------------------- helpers
    def finding(
        self, code: str, node: ast.AST | int, message: str, detail: str = ""
    ) -> Finding:
        line = node if isinstance(node, int) else getattr(node, "lineno", 1)
        return Finding(
            code=code,
            path=self.rel_path,
            line=line,
            message=message,
            detail=detail,
        )

    # --------------------------------------------------------- suppressions
    def file_suppressions(self) -> set[str]:
        codes: set[str] = set()
        for m in _DISABLE_FILE_RE.finditer(self.source):
            codes.update(c.strip() for c in m.group(1).split(",") if c.strip())
        return codes

    def line_suppressions(self, line: int) -> set[str]:
        if 1 <= line <= len(self.lines):
            m = _DISABLE_RE.search(self.lines[line - 1])
            if m:
                return {c.strip() for c in m.group(1).split(",") if c.strip()}
        return set()

    def is_suppressed(self, f: Finding, _file_codes: set[str] | None = None) -> bool:
        file_codes = (
            _file_codes if _file_codes is not None else self.file_suppressions()
        )
        if f.code in file_codes or "all" in file_codes:
            return True
        line_codes = self.line_suppressions(f.line)
        return f.code in line_codes or "all" in line_codes

    # -------------------------------------------------------------- waivers
    def line_waivers(self, line: int) -> dict[str, str]:
        """``{code: reason}`` for a ``# piolint: waive=...`` pragma on
        ``line``, or on a comment-only line directly above it (for call
        sites too long to carry an inline pragma) — reason may be empty,
        which :func:`check_waiver_reasons` reports and :meth:`is_waived`
        refuses to honor."""
        if not (1 <= line <= len(self.lines)):
            return {}
        m = _WAIVE_RE.search(self.lines[line - 1])
        if m is None and line >= 2:
            above = self.lines[line - 2].strip()
            if above.startswith("#"):
                m = _WAIVE_RE.search(above)
        if not m:
            return {}
        reason = (m.group(2) or "").strip()
        return {
            c.strip(): reason for c in m.group(1).split(",") if c.strip()
        }

    def is_waived(self, f: Finding) -> bool:
        """True only for a waiver naming this finding's code WITH a
        non-empty reason — a reasonless waiver does not waive (the
        finding still fires, plus ``PIO001`` on the pragma itself)."""
        return bool(self.line_waivers(f.line).get(f.code, "").strip())


# ---------------------------------------------------------------------------
# Running
# ---------------------------------------------------------------------------


@rule(
    "PIO001",
    "waiver-missing-reason",
    "a `# piolint: waive=CODE` pragma carries no reason text",
)
def check_waiver_reasons(ctx: FileContext) -> Iterator[Finding]:
    """The engine's own pragma hygiene: every waiver must say WHY. A
    reasonless waiver is inert (the waived code still fires) and this
    rule flags the pragma itself, so CI fails on both counts."""
    for i, line in enumerate(ctx.lines, 1):
        m = _WAIVE_RE.search(line)
        if m and not (m.group(2) or "").strip():
            yield ctx.finding(
                "PIO001",
                i,
                "waiver pragma without a reason — write "
                "`# piolint: waive=CODE -- <why this is acceptable>`",
            )


def _parse_failure(rel_path: str, e: SyntaxError) -> Finding:
    """The one ``PIO100`` shape — the baseline keys on this message, so
    there must be exactly one place that spells it."""
    return Finding(
        "PIO100",
        rel_path.replace(os.sep, "/"),
        e.lineno or 1,
        "file does not parse",
    )


def _lint_context(ctx: FileContext) -> tuple[list[Finding], int]:
    """Run every per-file rule on one parsed module with suppression
    accounting — the single body behind both :func:`lint_file` and the
    per-file half of :func:`lint_sources`."""
    file_codes = ctx.file_suppressions()
    kept: list[Finding] = []
    suppressed = 0
    for r in _RULES.values():
        if r.program:
            continue  # program rules need the whole tree (lint_tree)
        for f in r.check(ctx):
            if ctx.is_suppressed(f, file_codes) or ctx.is_waived(f):
                suppressed += 1
            else:
                kept.append(f)
    return kept, suppressed


def lint_file(
    rel_path: str, source: str, manifest: Manifest | None = None
) -> tuple[list[Finding], int]:
    """Lint one module. Returns ``(findings, suppressed_count)``; a file
    that does not parse yields a single ``PIO100`` finding (the parse-all
    CI guard owns syntax errors, but the linter must not crash)."""
    manifest = manifest or DEFAULT_MANIFEST
    try:
        ctx = FileContext(rel_path, source, manifest)
    except SyntaxError as e:
        return [_parse_failure(rel_path, e)], 0
    return _lint_context(ctx)


def iter_tree_files(
    root: str, package: str | None = None
) -> Iterator[tuple[str, str]]:
    """Yield ``(abs_path, rel_path)`` for every lintable ``*.py`` under
    ``root``, skipping tests, hidden and tooling directories; with
    ``package`` (a directory relative to ``root``), only those under it."""
    root = os.path.abspath(root)
    top = os.path.join(root, package) if package else root
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = sorted(
            d
            for d in dirnames
            if d not in _SKIP_DIRS and not d.startswith(".")
        )
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            abs_path = os.path.join(dirpath, name)
            yield abs_path, os.path.relpath(abs_path, root)


def lint_sources(
    files: dict[str, str], manifest: Manifest | None = None
) -> tuple[list[Finding], int, dict, list[dict]]:
    """Lint a set of ``{rel_path: source}`` modules as one program:
    per-file rules on each module, then the whole-program rules
    (``PIO206``+) over the cross-module call graph built from every
    module that parsed. Returns ``(findings, suppressed_count,
    callgraph_stats, lock_order_cycles)`` — the cycle set is the one the
    ``PIO207`` rule already computed (memoized on the program context),
    handed out so the witness classification and the bench ``lint``
    section never rebuild the graph for it."""
    manifest = manifest or DEFAULT_MANIFEST
    findings: list[Finding] = []
    suppressed = 0
    contexts: dict[str, FileContext] = {}
    for rel_path in sorted(files):
        source = files[rel_path]
        try:
            ctx = FileContext(rel_path, source, manifest)
        except SyntaxError as e:
            findings.append(_parse_failure(rel_path, e))
            continue
        contexts[ctx.rel_path] = ctx
        kept, sup = _lint_context(ctx)
        findings.extend(kept)
        suppressed += sup
    # program scope: build the call graph once, run every program rule,
    # then apply the same per-line/per-file suppressions via the context
    # each finding lands in
    from predictionio_tpu_torch.analysis.callgraph import ProgramContext, build_callgraph

    graph = build_callgraph(contexts)
    program = ProgramContext(contexts, graph)
    file_codes = {p: c.file_suppressions() for p, c in contexts.items()}
    for r in _RULES.values():
        if not r.program:
            continue
        for f in r.check(program):
            ctx = contexts.get(f.path)
            if ctx is not None and (
                ctx.is_suppressed(f, file_codes[f.path]) or ctx.is_waived(f)
            ):
                suppressed += 1
            else:
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    stats = {
        "functions": len(graph.functions),
        "classes": len(graph.classes),
        "callEdges": sum(
            len(s.callees) for fi in graph.functions.values() for s in fi.calls
        ),
        "lockSites": sum(
            len(fi.acquisitions) for fi in graph.functions.values()
        ),
    }
    from predictionio_tpu_torch.analysis.rules_program import lock_order_cycles

    return findings, suppressed, stats, lock_order_cycles(program)


def lint_tree(
    root: str, manifest: Manifest | None = None, package: str | None = None
) -> tuple[list[Finding], int, int, dict, list[dict]]:
    """Lint every file under ``root`` (under ``root/package`` only, as
    one program, when ``package`` is given). Returns ``(findings,
    files_scanned, suppressed_count, callgraph_stats,
    lock_order_cycles)``."""
    files: dict[str, str] = {}
    for abs_path, rel_path in iter_tree_files(root, package):
        with open(abs_path, "r", encoding="utf-8", errors="replace") as fh:
            files[rel_path] = fh.read()
    findings, suppressed, stats, cycles = lint_sources(files, manifest)
    return findings, len(files), suppressed, stats, cycles


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


def load_baseline(path: str) -> dict[tuple[str, str, str], dict]:
    """Baseline file -> ``{(code, path, message): entry}`` where entry
    keeps ``count`` (how many identical findings are accepted) and the
    maintainer's ``justification``. A missing file is an empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    out: dict[tuple[str, str, str], dict] = {}
    for e in data.get("entries", ()):
        out[(e["code"], e["path"], e["message"])] = {
            "count": int(e.get("count", 1)),
            "justification": e.get("justification", ""),
        }
    return out


def write_baseline(findings: list[Finding], path: str) -> None:
    """Write ``findings`` as the new baseline, preserving justifications
    of entries that survive (``pio lint --update-baseline``)."""
    old = load_baseline(path)
    counts: dict[tuple[str, str, str], int] = {}
    for f in findings:
        counts[f.key()] = counts.get(f.key(), 0) + 1
    entries = []
    for (code, fpath, message), count in sorted(counts.items()):
        prev = old.get((code, fpath, message), {})
        entries.append(
            {
                "code": code,
                "path": fpath,
                "message": message,
                "count": count,
                "justification": prev.get("justification", "")
                or "TODO: justify or fix",
            }
        )
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "entries": entries}, fh, indent=2, sort_keys=True)
        fh.write("\n")


def split_by_baseline(
    findings: list[Finding], baseline: dict[tuple[str, str, str], dict]
) -> tuple[list[Finding], list[Finding]]:
    """Partition into (new, baselined). Each baseline entry absorbs at
    most ``count`` identical findings — if a rule starts firing MORE
    times at the same (code, path, message), the extras are new."""
    budget = {k: v["count"] for k, v in baseline.items()}
    new: list[Finding] = []
    old: list[Finding] = []
    for f in findings:
        k = f.key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old


# ---------------------------------------------------------------------------
# Public entry point (pio lint, bench --smoke, tier-1 test)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LintResult:
    root: str
    files_scanned: int
    new_findings: list[Finding]
    baselined: list[Finding]
    suppressed_count: int
    stale_baseline: int  # baseline entries no current finding matched
    #: whole-program pass sizes (functions/classes/callEdges/lockSites)
    callgraph: dict = dataclasses.field(default_factory=dict)
    #: stale entries removed by --prune-baseline (0 when not pruning)
    pruned_baseline: int = 0
    #: the PIO207 lock-order cycle set from this pass, for the witness
    #: CONFIRMED/PLAUSIBLE join — consumers must not re-parse the tree
    lock_cycles: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.new_findings

    def counts_by_code(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.new_findings + self.baselined:
            out[f.code] = out.get(f.code, 0) + 1
        return dict(sorted(out.items()))

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "filesScanned": self.files_scanned,
            "rules": len(_RULES),
            "newFindings": [dataclasses.asdict(f) for f in self.new_findings],
            "baselinedCount": len(self.baselined),
            "suppressedCount": self.suppressed_count,
            "staleBaselineEntries": self.stale_baseline,
            "prunedBaselineEntries": self.pruned_baseline,
            "countsByCode": self.counts_by_code(),
            "callgraph": dict(self.callgraph),
            "lockOrderCycles": len(self.lock_cycles),
        }

    def to_sarif(self) -> dict:
        """SARIF 2.1.0 document (``pio lint --format sarif``) so findings
        render as inline annotations in code-review tooling. New findings
        are ``error`` (they fail CI), baselined ones ``note`` (accepted
        debt, still visible in review). URIs are repo-relative posix
        against the ``SRCROOT`` base — exactly the paths the baseline
        keys on."""
        from predictionio_tpu_torch.version import __version__

        def result(f: Finding, level: str) -> dict:
            text = f.message if not f.detail else f"{f.message} [{f.detail}]"
            return {
                "ruleId": f.code,
                "level": level,
                "message": {"text": text},
                "locations": [
                    {
                        "physicalLocation": {
                            "artifactLocation": {
                                "uri": f.path,
                                "uriBaseId": "SRCROOT",
                            },
                            "region": {"startLine": max(1, f.line)},
                        }
                    }
                ],
            }

        rules = [
            {
                "id": r.code,
                "name": r.name,
                "shortDescription": {"text": r.description},
            }
            for r in sorted(_RULES.values(), key=lambda r: r.code)
        ]
        return {
            "$schema": "https://raw.githubusercontent.com/oasis-tcs/"
            "sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
            "version": "2.1.0",
            "runs": [
                {
                    "tool": {
                        # no informationUri: SARIF requires an ABSOLUTE
                        # URI there and piolint has no public homepage —
                        # schema-validating ingesters reject a relative
                        # path (rule docs live in docs/development.md)
                        "driver": {
                            "name": "piolint",
                            "version": __version__,
                            "rules": rules,
                        }
                    },
                    "originalUriBaseIds": {
                        "SRCROOT": {"uri": f"file://{self.root}/"}
                    },
                    "results": [
                        *(result(f, "error") for f in self.new_findings),
                        *(result(f, "note") for f in self.baselined),
                    ],
                }
            ],
        }


def default_root() -> str:
    """The repo root when running from a checkout: the parent of the
    ``predictionio_tpu_torch`` package directory."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def prune_baseline(findings: list[Finding], path: str) -> int:
    """Drop baseline entries no current finding matches, and cap each
    surviving entry's ``count`` at the number of identical findings that
    still fire (``pio lint --prune-baseline``). Justifications survive.
    Returns the number of entries removed or shrunk. A missing baseline
    file is a no-op (nothing to prune)."""
    old = load_baseline(path)
    if not old:
        return 0
    counts: dict[tuple[str, str, str], int] = {}
    for f in findings:
        counts[f.key()] = counts.get(f.key(), 0) + 1
    entries = []
    pruned = 0
    for key, entry in sorted(old.items()):
        live = min(entry["count"], counts.get(key, 0))
        if live < entry["count"]:
            pruned += 1
        if live <= 0:
            continue
        code, fpath, message = key
        entries.append(
            {
                "code": code,
                "path": fpath,
                "message": message,
                "count": live,
                "justification": entry.get("justification", ""),
            }
        )
    if pruned:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(
                {"version": 1, "entries": entries}, fh, indent=2, sort_keys=True
            )
            fh.write("\n")
    return pruned


def run_lint(
    root: str | None = None,
    baseline_path: str | None = None,
    update_baseline: bool = False,
    manifest: Manifest | None = None,
    prune_stale: bool = False,
) -> LintResult:
    """Lint the tree under ``root`` against the checked-in baseline.

    ``update_baseline=True`` rewrites the baseline file to exactly the
    current findings (preserving justifications) and reports them all as
    baselined — the follow-up commit review supplies the justifications.
    ``prune_stale=True`` instead only REMOVES baseline entries that no
    current finding matches (fixed findings), never adding any.
    """
    root = os.path.abspath(root or default_root())
    baseline_path = baseline_path or os.path.join(root, BASELINE_NAME)
    findings, files, suppressed, cg_stats, cycles = lint_tree(root, manifest)
    if update_baseline:
        write_baseline(findings, baseline_path)
    pruned = 0
    if prune_stale and not update_baseline:
        pruned = prune_baseline(findings, baseline_path)
    baseline = load_baseline(baseline_path)
    new, old = split_by_baseline(findings, baseline)
    matched_keys = {f.key() for f in old}
    stale = sum(1 for k in baseline if k not in matched_keys)
    return LintResult(
        root=root,
        files_scanned=files,
        new_findings=new,
        baselined=old,
        suppressed_count=suppressed,
        stale_baseline=stale,
        callgraph=cg_stats,
        pruned_baseline=pruned,
        lock_cycles=cycles,
    )
