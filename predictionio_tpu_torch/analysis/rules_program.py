"""PIO206–PIO211 — whole-program concurrency rules.

These are the interprocedural halves of the ``PIO2xx`` family: each one
closes a blind spot a per-file rule demonstrably missed (bugs that
cross a module boundary: the stop()/_rebind race and a
hook-under-serving-lock convoy were caught by hand). All four run over the :mod:`callgraph` built in
:func:`engine.lint_sources`:

* ``PIO206`` transitive blocking-under-lock: a call made while a lock is
  held *reaches* ``time.sleep``/``urlopen``/``subprocess`` through the
  call graph. ``PIO202`` only sees the blocking call lexically inside
  the ``with`` block; the convoy is just as real three frames down.
* ``PIO207`` cross-module lock-order cycle, **lexical edges only**: two
  modules nest each other's locks in opposite orders, every acquisition
  visible as a literal ``with`` nesting. Cycles inside one module's
  lexical nesting are left to ``PIO203``; cycles needing at least one
  call hop are ``PIO210``'s.
* ``PIO210`` interprocedural lock-order cycle: the same global digraph,
  but at least one edge of the ring only exists through the call graph
  (router → registry → ring class of deadlock). The finding carries the
  full call chain of every interprocedural edge — the provenance a
  maintainer needs to decide whether the path is live.
* ``PIO211`` durable syscall under a foreign lock: a call made while
  holding a lock reaches ``os.fsync``/``os.replace``/``os.rename`` in a
  function that does NOT own that lock — every thread contending for
  the lock now waits on another component's disk flush (tens of ms per
  sync on a busy volume). Syncing under one's OWN lock (the columnar
  appender's single-writer contract) is deliberate and not flagged;
  ``PIO206`` keeps its disjoint sleep/socket/subprocess primitive set.
* ``PIO208`` deadline non-propagation: a function *receives* a
  deadline/timeout but calls a network primitive — or a package function
  that itself accepts a deadline — without forwarding any of it. The
  budget silently resets to infinity at that hop.
* ``PIO209`` thread-escape: ``threading.Thread(target=f, args=(self,
  ...))`` hands an object whose class declares a lock to a plain
  function, and that function mutates the object's private state without
  taking the owning lock. ``PIO201`` checks the class's own methods;
  this checks the state that escaped them.
"""

from __future__ import annotations

import ast
from typing import Iterator

from predictionio_tpu_torch.analysis.callgraph import (
    CallGraph,
    FunctionInfo,
    ProgramContext,
    _self_attr,
    digraph_cycles,
)
from predictionio_tpu_torch.analysis.engine import Finding, program_rule
from predictionio_tpu_torch.analysis.rules_concurrency import _BLOCKING_CALLS

__all__ = ["lock_order_cycles", "lock_order_edges"]

#: reachability fuse: a deeper chain exists but the diagnostic is
#: unreadable and the convoy is already proven by hop one
_MAX_CHAIN = 8

#: network entry points a received deadline must reach (PIO208); the
#: internal half of the rule is any in-package callee that itself
#: declares a deadline-ish parameter
_NETWORK_PRIMITIVES = frozenset(
    {
        "urllib.request.urlopen",
        "socket.create_connection",
        "http.client.HTTPConnection",
        "http.client.HTTPSConnection",
    }
)


def _short(qname: str) -> str:
    """Readable-but-stable function label: strip the root package."""
    return qname.removeprefix("predictionio_tpu.")


# ---------------------------------------------------------------------------
# PIO206 — blocking call transitively reachable under a lock
# ---------------------------------------------------------------------------


def _call_paths(
    graph: CallGraph, targets: frozenset[str]
) -> dict[str, tuple[str, tuple[str, ...]]]:
    """For every function: the nearest external call in ``targets``
    reachable from its body, as ``(target_dotted, call_chain)`` where the
    chain starts at the function itself. Bottom-up fixpoint — seed the
    direct callers of a target primitive, then propagate shortest chains
    one call hop per pass until stable. A memoized cut-on-recursion DFS
    is wrong here: the value computed for a function while one of its
    (mutually) recursive peers was on-stack would be cached *without*
    the paths through that peer, permanently hiding convoys inside
    recursive call clusters."""
    paths: dict[str, tuple[str, tuple[str, ...]]] = {}
    for fq, fi in graph.functions.items():
        for site in fi.calls:
            if site.external in targets:
                paths[fq] = (site.external, (fq,))
                break
    # each pass extends chains by one hop; _MAX_CHAIN passes bound the
    # chain length exactly like the old depth fuse did
    for _ in range(_MAX_CHAIN):
        changed = False
        for fq in graph.functions:
            fi = graph.functions[fq]
            best = paths.get(fq)
            for site in fi.calls:
                for callee in site.callees:
                    sub = paths.get(callee)
                    if sub is not None and (
                        best is None or len(sub[1]) + 1 < len(best[1])
                    ):
                        best = (sub[0], (fq,) + sub[1])
            if best is not None and best is not paths.get(fq):
                paths[fq] = best
                changed = True
        if not changed:
            break
    return paths


@program_rule(
    "PIO206",
    "transitive-blocking-under-lock",
    "a call made while holding a lock reaches time.sleep/urlopen/"
    "subprocess through the call graph",
)
def check_transitive_blocking(program: ProgramContext) -> Iterator[Finding]:
    graph = program.graph
    blocking = _call_paths(graph, _BLOCKING_CALLS)
    reported: set[tuple[str, str, str, str]] = set()
    for fq in sorted(graph.functions):
        fi = graph.functions[fq]
        for site in fi.calls:
            if not site.held:
                continue
            # the DIRECT blocking call under a lexical lock is PIO202's
            # finding — do not double-report it here
            for callee in site.callees:
                path = blocking.get(callee)
                if path is None:
                    continue
                dotted, chain = path
                lock = next(
                    (h for h in site.held if h != "<lock>"), site.held[0]
                )
                key = (fq, lock, callee, dotted)
                if key in reported:
                    continue
                reported.add(key)
                ctx = program.contexts[fi.rel_path]
                # the chain is the most useful part of the diagnostic but
                # the LEAST stable (any refactor that shortens a path
                # rewrites it): keep the baseline key on the stable
                # endpoints only and carry the chain as render-only detail
                yield ctx.finding(
                    "PIO206",
                    site.line,
                    f"call from {_short(fq)} while holding {_short(lock)} "
                    f"reaches blocking {dotted}() (convoys every thread "
                    "contending for the lock)",
                    detail="via " + " -> ".join(_short(c) for c in chain),
                )


# ---------------------------------------------------------------------------
# PIO207 — cross-module lock-order cycles
# ---------------------------------------------------------------------------


def _lock_chains(
    graph: CallGraph,
) -> dict[str, dict[str, tuple[str, ...]]]:
    """Function qname -> {lock id -> shortest call chain to an
    acquisition of it}, where the chain starts at the function itself
    and ends at the function that lexically acquires the lock. Bottom-up
    fixpoint over the call graph (seed each function's own acquisitions,
    extend callees' chains one hop per pass) — the same reasoning as
    :func:`_call_paths`: a cut-on-recursion DFS memoizes partial sets
    for members of recursive call clusters, losing PIO207/PIO210 edges
    through them."""
    reach: dict[str, dict[str, tuple[str, ...]]] = {
        fq: {a.lock_id: (fq,) for a in fi.acquisitions}
        for fq, fi in graph.functions.items()
    }
    for _ in range(_MAX_CHAIN):
        changed = False
        for fq in graph.functions:
            fi = graph.functions[fq]
            mine = reach[fq]
            for site in fi.calls:
                for callee in site.callees:
                    # list(): a self-recursive callee aliases `mine`
                    for lock, chain in list(reach.get(callee, {}).items()):
                        cand = (fq,) + chain
                        cur = mine.get(lock)
                        if cur is None or len(cand) < len(cur):
                            mine[lock] = cand
                            changed = True
        if not changed:
            break
    return reach


def _locks_reachable(graph: CallGraph) -> dict[str, frozenset[str]]:
    """Function qname -> every lock id acquired by it or any transitive
    callee (the chain-free view of :func:`_lock_chains`)."""
    return {
        fq: frozenset(chains) for fq, chains in _lock_chains(graph).items()
    }


def _lock_edges(program: ProgramContext) -> dict[tuple[str, str], dict]:
    """The global acquisition-order digraph: ``(outer, inner) ->
    {path, line, kind, via, chain}`` (first occurrence wins; lexical
    beats interprocedural for attribution). ``chain`` is the call chain
    from the function holding ``outer`` to the function that acquires
    ``inner`` — a single element for lexical edges."""
    graph = program.graph
    reach = _lock_chains(graph)
    edges: dict[tuple[str, str], dict] = {}

    def add(
        outer: str,
        inner: str,
        fi: FunctionInfo,
        line: int,
        kind: str,
        chain: tuple[str, ...],
    ):
        if outer == inner:
            return
        prev = edges.get((outer, inner))
        if prev is None or (prev["kind"] == "interproc" and kind == "lexical"):
            edges[(outer, inner)] = {
                "path": fi.rel_path,
                "line": line,
                "kind": kind,
                "via": fi.qname,
                "chain": list(chain),
            }

    for fq in sorted(graph.functions):
        fi = graph.functions[fq]
        for acq in fi.acquisitions:
            for outer in acq.held:
                add(outer, acq.lock_id, fi, acq.line, "lexical", (fq,))
        for site in fi.calls:
            held = [h for h in site.held if h != "<lock>"]
            if not held:
                continue
            for callee in site.callees:
                for inner, chain in sorted(reach.get(callee, {}).items()):
                    for outer in held:
                        add(
                            outer, inner, fi, site.line, "interproc",
                            (fq,) + chain,
                        )
    return edges


def lock_order_edges(program: ProgramContext) -> list[dict]:
    """Every edge of the global lock-acquisition digraph, serialized for
    the runtime witness crosscheck (:mod:`lock_witness`): a dynamically
    observed acquisition order with no counterpart here is an analyzer
    gap."""
    return [
        {"from": a, "to": b, **meta}
        for (a, b), meta in sorted(_lock_edges(program).items())
    ]


def lock_order_cycles(program: ProgramContext) -> list[dict]:
    """Cycles in the global lock-acquisition digraph, canonicalized
    (rotated so the smallest lock id leads, deduplicated). Each entry:
    ``{"cycle": [lock, ..., lock0], "edges": [edge-dict, ...],
    "lexical_only": bool, "modules": [..]}``. Shared by the ``PIO207``
    rule and the runtime witness's CONFIRMED/PLAUSIBLE classification
    (:mod:`predictionio_tpu_torch.analysis.witness`)."""
    if program._lock_cycles is not None:
        return program._lock_cycles
    edges = _lock_edges(program)

    out: list[dict] = []
    for nodes in digraph_cycles(edges):
        ring = nodes + [nodes[0]]
        cyc_edges = [
            {"from": a, "to": b, **edges[(a, b)]}
            for a, b in zip(ring, ring[1:])
            if (a, b) in edges
        ]
        if len(cyc_edges) != len(nodes):
            continue  # a rotation artifact, not a real ring
        modules = sorted({e["path"] for e in cyc_edges})
        out.append(
            {
                "cycle": ring,
                "edges": cyc_edges,
                "lexical_only": all(e["kind"] == "lexical" for e in cyc_edges),
                "modules": modules,
            }
        )
    program._lock_cycles = out
    return out


@program_rule(
    "PIO207",
    "cross-module-lock-cycle",
    "lexically nested lock acquisitions form a cycle across modules",
)
def check_cross_module_lock_order(program: ProgramContext) -> Iterator[Finding]:
    for cyc in lock_order_cycles(program):
        if not cyc["lexical_only"]:
            continue  # needs a call hop: PIO210's finding
        if len(cyc["modules"]) == 1:
            continue  # PIO203's per-module lexical finding
        first = cyc["edges"][0]
        ctx = program.contexts.get(first["path"])
        if ctx is None:
            continue
        yield ctx.finding(
            "PIO207",
            first["line"],
            "cross-module lock-order cycle: "
            + " -> ".join(_short(n) for n in cyc["cycle"])
            + " (two modules nest these locks in opposite orders: "
            "deadlock)",
        )


@program_rule(
    "PIO210",
    "interprocedural-lock-cycle",
    "lock-acquisition order forms a cycle through at least one "
    "cross-function call chain",
)
def check_interprocedural_lock_order(
    program: ProgramContext,
) -> Iterator[Finding]:
    """The whole-program half of the lock-order story: the ring only
    closes through the call graph (a function holding lock A calls into
    code that takes lock B, while another path nests them the other way
    round). The full call chain of every interprocedural edge rides in
    ``detail`` — chains are the provenance a maintainer needs, but they
    are volatile under refactors, so the baseline key stays on the
    ring itself."""
    for cyc in lock_order_cycles(program):
        if cyc["lexical_only"]:
            continue  # PIO203/PIO207 territory
        first = next(e for e in cyc["edges"] if e["kind"] == "interproc")
        ctx = program.contexts.get(first["path"])
        if ctx is None:
            continue
        chains = "; ".join(
            f"{_short(e['from'])} -> {_short(e['to'])} via "
            + " -> ".join(_short(c) for c in e.get("chain", ()))
            for e in cyc["edges"]
            if e["kind"] == "interproc"
        )
        yield ctx.finding(
            "PIO210",
            first["line"],
            "interprocedural lock-order cycle: "
            + " -> ".join(_short(n) for n in cyc["cycle"])
            + " (two call paths acquire these locks in opposite orders: "
            "deadlock needs only an unlucky schedule)",
            detail=chains,
        )


# ---------------------------------------------------------------------------
# PIO211 — durable syscall (fsync/rename) under a foreign lock
# ---------------------------------------------------------------------------

#: syscalls that publish bytes to disk — each one can stall for tens of
#: milliseconds on a busy volume, which is a convoy when a lock the
#: caller does not own is held across it. Disjoint from
#: ``_BLOCKING_CALLS`` so PIO206 and PIO211 can never double-report.
_DURABLE_SYSCALLS = frozenset(
    {"os.fsync", "os.fdatasync", "os.replace", "os.rename"}
)


def _owner(dotted: str) -> str:
    """``pkg.mod.Class.attr`` -> ``pkg.mod.Class`` (a lock's owning
    class, or a function's owning class/module)."""
    return dotted.rsplit(".", 1)[0]


@program_rule(
    "PIO211",
    "durable-syscall-under-foreign-lock",
    "a call made while holding a lock reaches os.fsync/os.replace/"
    "os.rename in code that does not own the lock",
)
def check_durable_under_foreign_lock(
    program: ProgramContext,
) -> Iterator[Finding]:
    graph = program.graph
    durable = _call_paths(graph, _DURABLE_SYSCALLS)
    reported: set[tuple[str, str, str, str]] = set()
    for fq in sorted(graph.functions):
        fi = graph.functions[fq]
        for site in fi.calls:
            held = [h for h in site.held if h != "<lock>"]
            if not held:
                continue
            # (performing function, durable dotted, chain from here)
            hits: list[tuple[str, str, tuple[str, ...]]] = []
            if site.external in _DURABLE_SYSCALLS:
                hits.append((fq, site.external, (fq,)))
            for callee in site.callees:
                path = durable.get(callee)
                if path is not None:
                    dotted, chain = path
                    hits.append((chain[-1], dotted, (fq,) + chain))
            for performer, dotted, chain in hits:
                for lock in held:
                    if _owner(lock) == _owner(performer):
                        continue  # syncing under one's own lock: a choice
                    key = (fq, lock, performer, dotted)
                    if key in reported:
                        continue
                    reported.add(key)
                    ctx = program.contexts[fi.rel_path]
                    yield ctx.finding(
                        "PIO211",
                        site.line,
                        f"call from {_short(fq)} while holding "
                        f"{_short(lock)} reaches durable {dotted}() in "
                        f"{_short(performer)}, which does not own that "
                        "lock — every contender now waits on a foreign "
                        "disk flush",
                        detail="via " + " -> ".join(_short(c) for c in chain),
                    )


# ---------------------------------------------------------------------------
# PIO208 — deadline non-propagation
# ---------------------------------------------------------------------------


def _deadline_params(fi: FunctionInfo) -> set[str]:
    return {
        p
        for p in fi.params
        if "deadline" in p.lower() or "timeout" in p.lower()
    }


def _names_in(node: ast.AST) -> set[str]:
    return {
        n.id for n in ast.walk(node) if isinstance(n, ast.Name)
    }


def _tainted_locals(fn: ast.AST, seeds: set[str]) -> set[str]:
    """Names data-dependent on the deadline params: fixpoint over simple
    assignments (``t = min(timeout, 5)`` taints ``t``)."""
    tainted = set(seeds)
    for _ in range(4):
        grew = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                if _names_in(node.value) & tainted:
                    for t in node.targets:
                        for n in ast.walk(t):
                            if (
                                isinstance(n, ast.Name)
                                and n.id not in tainted
                            ):
                                tainted.add(n.id)
                                grew = True
            elif isinstance(node, ast.AugAssign):
                if _names_in(node.value) & tainted and isinstance(
                    node.target, ast.Name
                ):
                    if node.target.id not in tainted:
                        tainted.add(node.target.id)
                        grew = True
        if not grew:
            break
    return tainted


@program_rule(
    "PIO208",
    "deadline-not-propagated",
    "a function receives a deadline/timeout but calls a network/storage "
    "primitive without forwarding any of it",
)
def check_deadline_propagation(program: ProgramContext) -> Iterator[Finding]:
    graph = program.graph
    for fq in sorted(graph.functions):
        fi = graph.functions[fq]
        seeds = _deadline_params(fi)
        if not seeds:
            continue
        ctx = program.contexts[fi.rel_path]
        tainted = _tainted_locals(fi.node, seeds)
        # exact (line, col) -> resolved internal callees, so a nested
        # call on the same line (`f(deadline=time.monotonic()+t)`) can
        # never inherit the outer call's resolution
        internal_by_pos: dict[tuple[int, int], list[str]] = {}
        for site in fi.calls:
            for callee in site.callees:
                internal_by_pos.setdefault((site.line, site.col), []).append(
                    callee
                )

        def forwarded(call: ast.Call, guards: list[ast.AST]) -> bool:
            for part in (*call.args, *call.keywords):
                node = part.value if isinstance(part, ast.keyword) else part
                if _names_in(node) & tainted:
                    return True
            # ambient propagation: `with deadline_scope(deadline):`, or a
            # poll loop bounded by the budget (`while now() - t0 <
            # timeout_s:`) — the budget is enforced around the call, not
            # through its arguments
            for g in guards:
                if isinstance(g, ast.With):
                    if any(
                        _names_in(i.context_expr) & tainted for i in g.items
                    ):
                        return True
                elif isinstance(g, ast.While):
                    if _names_in(g.test) & tainted:
                        return True
            return False

        def walk(node: ast.AST, guards: list[ast.AST]) -> Iterator[Finding]:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    continue  # deferred body: budget semantics differ
                stack = guards
                if isinstance(child, (ast.With, ast.While)):
                    stack = guards + [child]
                if isinstance(child, ast.Call):
                    dotted = ctx.dotted_name(child.func)
                    target: str | None = None
                    if dotted in _NETWORK_PRIMITIVES:
                        target = dotted
                    else:
                        for callee in internal_by_pos.get(
                            (child.lineno, child.col_offset), ()
                        ):
                            cfi = graph.functions.get(callee)
                            if cfi is not None and _deadline_params(cfi):
                                target = callee
                                break
                    if target is not None and not forwarded(child, stack):
                        yield ctx.finding(
                            "PIO208",
                            child,
                            f"{_short(fq)} receives "
                            f"{sorted(seeds)[0]} but calls "
                            f"{_short(target)} without forwarding any "
                            "deadline — the budget resets to infinity at "
                            "this hop",
                        )
                yield from walk(child, stack)

        yield from walk(fi.node, [])


# ---------------------------------------------------------------------------
# PIO209 — thread-escape: locked state mutated by a Thread target
# ---------------------------------------------------------------------------


def _param_writes_unlocked(
    fn: ast.AST, param: str, lock_attrs: set[str]
) -> Iterator[tuple[int, str]]:
    """(line, attr) for writes to ``<param>._x`` not under ``with
    <param>.<lock>``. Mirrors PIO201's guarded-walk semantics."""

    def guarded_by_param(item: ast.withitem) -> bool:
        e = item.context_expr
        return (
            isinstance(e, ast.Attribute)
            and isinstance(e.value, ast.Name)
            and e.value.id == param
            and (e.attr in lock_attrs or "lock" in e.attr.lower())
        )

    def walk(node: ast.AST, guarded: bool) -> Iterator[tuple[int, str]]:
        for child in ast.iter_child_nodes(node):
            child_guarded = guarded
            if isinstance(child, ast.With) and any(
                guarded_by_param(i) for i in child.items
            ):
                child_guarded = True
            elif isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                child_guarded = False
            if not child_guarded and isinstance(
                child, (ast.Assign, ast.AugAssign, ast.AnnAssign)
            ):
                targets = (
                    child.targets
                    if isinstance(child, ast.Assign)
                    else [child.target]
                )
                for t in targets:
                    if isinstance(t, ast.Tuple):
                        elts = t.elts
                    else:
                        elts = [t]
                    for e in elts:
                        if (
                            isinstance(e, ast.Attribute)
                            and isinstance(e.value, ast.Name)
                            and e.value.id == param
                            and e.attr.startswith("_")
                            and e.attr not in lock_attrs
                        ):
                            yield child.lineno, e.attr
            yield from walk(child, child_guarded)

    yield from walk(fn, False)


@program_rule(
    "PIO209",
    "thread-escape-unlocked-write",
    "state handed to a threading.Thread target is mutated without the "
    "owning class's declared lock",
)
def check_thread_escape(program: ProgramContext) -> Iterator[Finding]:
    graph = program.graph
    reported: set[tuple[str, int, str]] = set()
    for fq in sorted(graph.functions):
        fi = graph.functions[fq]
        ctx = program.contexts[fi.rel_path]
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            if ctx.dotted_name(node.func) != "threading.Thread":
                continue
            target = next(
                (k.value for k in node.keywords if k.arg == "target"), None
            )
            args_kw = next(
                (k.value for k in node.keywords if k.arg == "args"), None
            )
            if target is None or args_kw is None:
                continue
            if _self_attr(target) is not None:
                continue  # bound method: PIO201 owns the class's methods
            # resolve a plain-function target through the import map
            tq: str | None = None
            if isinstance(target, (ast.Name, ast.Attribute)):
                dotted = ctx.dotted_name(target)
                if dotted in graph.functions:
                    tq = dotted
                elif isinstance(target, ast.Name):
                    local = f"{fi.module}.{target.id}"
                    if local in graph.functions:
                        tq = local
            if tq is None:
                continue
            tfi = graph.functions[tq]
            if not isinstance(args_kw, (ast.Tuple, ast.List)):
                continue
            for pos, arg in enumerate(args_kw.elts):
                owner: str | None = None
                if isinstance(arg, ast.Name) and arg.id == "self" and fi.cls:
                    owner = f"{fi.module}.{fi.cls}"
                else:
                    attr = _self_attr(arg)
                    if attr is not None and fi.cls:
                        ci = graph.classes.get(f"{fi.module}.{fi.cls}")
                        if ci is not None:
                            owner = ci.attr_types.get(attr)
                if owner is None or pos >= len(tfi.params):
                    continue
                locks = graph.class_locks(owner)
                if not locks:
                    continue
                param = tfi.params[pos]
                tctx = program.contexts[tfi.rel_path]
                for line, wattr in _param_writes_unlocked(
                    tfi.node, param, locks
                ):
                    key = (tfi.rel_path, line, wattr)
                    if key in reported:
                        continue
                    reported.add(key)
                    yield tctx.finding(
                        "PIO209",
                        line,
                        f"{_short(tq)} (a Thread target) writes "
                        f"{param}.{wattr} without `with {param}."
                        f"{sorted(locks)[0]}` — the state escaped "
                        f"{_short(owner)}'s declared lock",
                    )
