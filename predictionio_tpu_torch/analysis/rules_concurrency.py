"""PIO2xx — concurrency rules for the host-side subsystems.

The micro-batcher, resilience layer and remote-storage RPC are all
multi-threaded stdlib code whose invariants live in the heads of their
authors: shared counters are written under ``self._lock``, nothing
blocking runs while a lock is held, locks nest in one global order.
These rules turn each of those into a diagnostic:

* ``PIO201`` unguarded shared write: a class declares a lock attribute
  (``self.*lock* = threading.Lock()``), but a method assigns a private
  ``self._x`` attribute outside any ``with self.<lock>:`` block.
  ``__init__``/``__post_init__`` are exempt (the object is not shared
  yet), and so are the lock attributes themselves.
* ``PIO202`` blocking call under a lock: ``time.sleep``, ``urlopen``,
  ``socket.create_connection`` or a ``subprocess`` call lexically inside
  a ``with``-lock block — the classic convoy maker.
* ``PIO203`` lock-order cycle: a module whose functions acquire lock A
  inside lock B *and* (elsewhere) B inside A can deadlock; the rule
  builds the acquisition graph across the file and reports any cycle.
* ``PIO204`` thread without explicit daemon flag: every
  ``threading.Thread(...)`` must pass ``daemon=`` — an implicit
  non-daemon worker silently blocks interpreter shutdown.
* ``PIO205`` unbounded dict cache in the server hot paths: a module- or
  instance-level dict under ``serving/`` or ``api/`` that is grown by
  subscript assignment / ``setdefault`` but never evicted from
  (``pop``/``popitem``/``clear``/``del``/rebind). Request-keyed maps on
  a long-lived server are memory leaks an attacker can drive (the
  event-server access-key cache and the result cache are LRUs for
  exactly this reason).
"""

from __future__ import annotations

import ast
from typing import Iterator

from predictionio_tpu_torch.analysis.engine import FileContext, Finding, rule

_EXEMPT_METHODS = frozenset({"__init__", "__post_init__", "__new__"})

#: dotted callables that block the calling thread (resolved through the
#: file's import map, so `from time import sleep` is caught too)
_BLOCKING_CALLS = frozenset(
    {
        "time.sleep",
        "urllib.request.urlopen",
        "socket.create_connection",
        "subprocess.run",
        "subprocess.call",
        "subprocess.check_call",
        "subprocess.check_output",
        "subprocess.Popen",
    }
)


def _lock_attrs(ctx: FileContext, cls: ast.ClassDef) -> set[str]:
    """Attribute names assigned ``threading.Lock()`` / ``RLock()``
    anywhere in the class body (usually ``__init__``). Resolved through
    the import map so ``from threading import Lock`` counts too."""
    locks: set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        v = node.value
        if not (
            isinstance(v, ast.Call)
            and ctx.dotted_name(v.func) in ("threading.Lock", "threading.RLock")
        ):
            continue
        for t in node.targets:
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ):
                locks.add(t.attr)
    return locks


def _is_self_lock_item(item: ast.withitem, locks: set[str]) -> str | None:
    e = item.context_expr
    if (
        isinstance(e, ast.Attribute)
        and isinstance(e.value, ast.Name)
        and e.value.id == "self"
        and e.attr in locks
    ):
        return e.attr
    return None


def _write_targets(stmt: ast.stmt) -> list[ast.Attribute]:
    """``self.x`` attributes written by an Assign/AugAssign/AnnAssign."""
    targets: list[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    out = []
    for t in targets:
        if isinstance(t, ast.Tuple):
            out.extend(e for e in t.elts if isinstance(e, ast.Attribute))
        elif isinstance(t, ast.Attribute):
            out.append(t)
    return [
        t
        for t in out
        if isinstance(t.value, ast.Name) and t.value.id == "self"
    ]


@rule(
    "PIO201",
    "unguarded-shared-write",
    "write to self._* shared state outside `with self.<lock>` in a class "
    "that declares a lock",
)
def check_unguarded_writes(ctx: FileContext) -> Iterator[Finding]:
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _lock_attrs(ctx, cls)
        if not locks:
            continue
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if method.name in _EXEMPT_METHODS:
                continue
            yield from _walk_method(ctx, cls, method, locks, guarded=False)


def _walk_method(
    ctx: FileContext,
    cls: ast.ClassDef,
    node: ast.AST,
    locks: set[str],
    guarded: bool,
) -> Iterator[Finding]:
    for child in ast.iter_child_nodes(node):
        child_guarded = guarded
        if isinstance(child, ast.With):
            if any(_is_self_lock_item(i, locks) for i in child.items):
                child_guarded = True
        elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # a function DEFINED under the lock does not necessarily RUN
            # under it (it may be deferred to a thread/callback): its
            # writes must justify themselves
            child_guarded = False
        if not child_guarded and isinstance(
            child, (ast.Assign, ast.AugAssign, ast.AnnAssign)
        ):
            for t in _write_targets(child):
                if t.attr.startswith("_") and t.attr not in locks:
                    yield ctx.finding(
                        "PIO201",
                        child,
                        f"write to self.{t.attr} outside `with self."
                        f"{sorted(locks)[0]}` in {cls.name} (class "
                        "declares a lock; guard shared state or suppress "
                        "with a justification)",
                    )
        yield from _walk_method(ctx, cls, child, locks, child_guarded)


@rule(
    "PIO202",
    "blocking-call-under-lock",
    "time.sleep / socket / subprocess call while holding a lock",
)
def check_blocking_under_lock(ctx: FileContext) -> Iterator[Finding]:
    def looks_like_lock(item: ast.withitem) -> bool:
        e = item.context_expr
        name = None
        if isinstance(e, ast.Attribute):
            name = e.attr
        elif isinstance(e, ast.Name):
            name = e.id
        return name is not None and "lock" in name.lower()

    def walk(node: ast.AST, held: bool) -> Iterator[Finding]:
        for child in ast.iter_child_nodes(node):
            child_held = held
            if isinstance(child, ast.With) and any(
                looks_like_lock(i) for i in child.items
            ):
                child_held = True
            if child_held and isinstance(child, ast.Call):
                dotted = ctx.dotted_name(child.func)
                if dotted in _BLOCKING_CALLS:
                    yield ctx.finding(
                        "PIO202",
                        child,
                        f"blocking call {dotted}() while holding a lock "
                        "(convoys every thread contending for it)",
                    )
            # a nested function DEF under a with-lock does not run there
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                yield from walk(child, False)
            else:
                yield from walk(child, child_held)

    yield from walk(ctx.tree, False)


@rule(
    "PIO203",
    "lock-order-cycle",
    "inconsistent nested lock acquisition order across a module",
)
def check_lock_order(ctx: FileContext) -> Iterator[Finding]:
    """Builds a lock-acquisition digraph for the whole file: an edge
    A -> B for every ``with B`` lexically inside ``with A``. Lock
    identity is ``ClassName.attr`` for ``self.<attr>`` and the bare name
    for module-level locks; only names containing "lock" participate.
    Any cycle is a potential deadlock."""

    edges: dict[tuple[str, str], int] = {}  # (outer, inner) -> first line

    def lock_id(item: ast.withitem, cls: str | None) -> str | None:
        e = item.context_expr
        if isinstance(e, ast.Attribute) and "lock" in e.attr.lower():
            if isinstance(e.value, ast.Name) and e.value.id == "self":
                return f"{cls or '?'}.{e.attr}"
            return None  # other.obj._lock: identity unknowable statically
        if isinstance(e, ast.Name) and "lock" in e.id.lower():
            return e.id
        return None

    def walk(node: ast.AST, held: list[str], cls: str | None) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, held, child.name)
                continue
            stack = held
            if isinstance(child, ast.With):
                acquired = [
                    l
                    for l in (lock_id(i, cls) for i in child.items)
                    if l is not None
                ]
                if acquired:
                    for outer in held:
                        for inner in acquired:
                            if outer != inner:
                                edges.setdefault(
                                    (outer, inner), child.lineno
                                )
                    stack = held + acquired
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a function body runs later, under whatever locks its
                # caller holds — start its stack fresh
                walk(child, [], cls)
            else:
                walk(child, stack, cls)

    walk(ctx.tree, [], None)

    graph: dict[str, set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)

    seen: set[str] = set()

    def find_cycle(start: str) -> list[str] | None:
        path: list[str] = []
        on_path: set[str] = set()

        def dfs(n: str) -> list[str] | None:
            path.append(n)
            on_path.add(n)
            for m in sorted(graph.get(n, ())):
                if m in on_path:
                    return path[path.index(m):] + [m]
                if m not in seen:
                    got = dfs(m)
                    if got:
                        return got
            on_path.discard(n)
            path.pop()
            seen.add(n)
            return None

        return dfs(start)

    reported: set[frozenset[str]] = set()
    for start in sorted(graph):
        if start in seen:
            continue
        cycle = find_cycle(start)
        if cycle and frozenset(cycle) not in reported:
            reported.add(frozenset(cycle))
            line = edges.get((cycle[0], cycle[1]), 1)
            yield ctx.finding(
                "PIO203",
                line,
                "lock-order cycle: " + " -> ".join(cycle) + " (two code "
                "paths acquire these locks in opposite orders: deadlock)",
            )


#: packages whose long-lived processes make an unbounded request-keyed
#: dict a leak (the query/event servers); workflow code and one-shot
#: tools are out of scope
_CACHE_RULE_PATHS = ("predictionio_tpu/serving/", "predictionio_tpu/api/")

#: zero-arg constructors whose result is a growable mapping
_DICT_INITS = frozenset(
    {"dict", "collections.OrderedDict", "collections.defaultdict"}
)

#: method calls that shrink (or reset) a mapping
_EVICT_METHODS = frozenset({"pop", "popitem", "clear"})


def _is_dict_init(ctx: FileContext, v: ast.AST) -> bool:
    if isinstance(v, ast.Dict) and not v.keys:
        return True
    if isinstance(v, ast.Call):
        dotted = ctx.dotted_name(v.func)
        if dotted == "collections.defaultdict":
            return True
        return not v.args and not v.keywords and dotted in _DICT_INITS
    return False


def _self_attr(node: ast.AST) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


@rule(
    "PIO205",
    "unbounded-dict-cache",
    "dict grown in a serving/api hot path with no eviction "
    "(pop/popitem/clear/del/rebind)",
)
def check_unbounded_dict_cache(ctx: FileContext) -> Iterator[Finding]:
    if not ctx.rel_path.startswith(_CACHE_RULE_PATHS):
        return
    # ---------------------------------------------------- instance caches
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        dict_attrs: set[str] = set()
        grown: dict[str, int] = {}  # attr -> line of first growth
        evicted: set[str] = set()
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            exempt = method.name in _EXEMPT_METHODS
            for node in ast.walk(method):
                if isinstance(node, (ast.Assign, ast.AnnAssign)):
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    for t in targets:
                        attr = _self_attr(t)
                        if attr is not None and node.value is not None:
                            if _is_dict_init(ctx, node.value):
                                dict_attrs.add(attr)
                            if not exempt:
                                # any rebind outside __init__ resets the
                                # map — an eviction mechanism
                                evicted.add(attr)
                        # self.x[key] = value — growth
                        if (
                            isinstance(t, ast.Subscript)
                            and _self_attr(t.value) is not None
                            and not exempt
                        ):
                            grown.setdefault(_self_attr(t.value), node.lineno)
                elif isinstance(node, ast.Call):
                    f = node.func
                    if isinstance(f, ast.Attribute):
                        attr = _self_attr(f.value)
                        if attr is not None:
                            if f.attr == "setdefault" and not exempt:
                                grown.setdefault(attr, node.lineno)
                            elif f.attr in _EVICT_METHODS:
                                evicted.add(attr)
                elif isinstance(node, ast.Delete):
                    for t in node.targets:
                        if isinstance(t, ast.Subscript):
                            attr = _self_attr(t.value)
                            if attr is not None:
                                evicted.add(attr)
        for attr, line in sorted(grown.items(), key=lambda kv: kv[1]):
            if attr in dict_attrs and attr not in evicted:
                yield ctx.finding(
                    "PIO205",
                    line,
                    f"self.{attr} grows in {cls.name} with no eviction "
                    "(unbounded dict cache on a long-lived server; bound "
                    "it — LRU/TTL — or suppress with a justification)",
                )
    # ------------------------------------------------------ module caches
    module_dicts: set[str] = set()
    for stmt in ctx.tree.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = (
                stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            )
            for t in targets:
                if (
                    isinstance(t, ast.Name)
                    and stmt.value is not None
                    and _is_dict_init(ctx, stmt.value)
                ):
                    module_dicts.add(t.id)
    if not module_dicts:
        return
    grown_mod: dict[str, int] = {}
    evicted_mod: set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id in module_dicts
                ):
                    grown_mod.setdefault(t.value.id, node.lineno)
        elif isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id in module_dicts
            ):
                if f.attr == "setdefault":
                    grown_mod.setdefault(f.value.id, node.lineno)
                elif f.attr in _EVICT_METHODS:
                    evicted_mod.add(f.value.id)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id in module_dicts
                ):
                    evicted_mod.add(t.value.id)
    for name, line in sorted(grown_mod.items(), key=lambda kv: kv[1]):
        if name not in evicted_mod:
            yield ctx.finding(
                "PIO205",
                line,
                f"module dict {name} grows with no eviction (unbounded "
                "cache in a server module; bound it or suppress with a "
                "justification)",
            )


@rule(
    "PIO204",
    "thread-daemon-implicit",
    "threading.Thread(...) without an explicit daemon= keyword, or a "
    "ThreadPoolExecutor without a bounded max_workers",
)
def check_thread_daemon(ctx: FileContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = ctx.dotted_name(node.func)
        if dotted == "threading.Thread":
            if not any(k.arg == "daemon" for k in node.keywords):
                yield ctx.finding(
                    "PIO204",
                    node,
                    "threading.Thread without explicit daemon= (an "
                    "implicit non-daemon thread blocks interpreter "
                    "shutdown)",
                )
        elif dotted in (
            "concurrent.futures.ThreadPoolExecutor",
            "concurrent.futures.thread.ThreadPoolExecutor",
        ):
            # the default pool size scales with the host's core count
            # (min(32, cpu+4)): a server that constructs one per request
            # or runs on a big host silently multiplies its thread count.
            # An explicit bound — positional or keyword, and not None —
            # is the contract.
            bound = node.args[0] if node.args else None
            for k in node.keywords:
                if k.arg == "max_workers":
                    bound = k.value
            if bound is None or (
                isinstance(bound, ast.Constant) and bound.value is None
            ):
                yield ctx.finding(
                    "PIO204",
                    node,
                    "ThreadPoolExecutor without a bounded max_workers "
                    "(the default scales with host cores; pass an "
                    "explicit bound)",
                )
