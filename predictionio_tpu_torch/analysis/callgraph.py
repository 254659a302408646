"""Whole-program call graph for the interprocedural piolint rules.

Every concurrency bug the per-file rules missed crossed a boundary the
per-file rules cannot see: the stop()/_rebind race spanned
``online/runner.py`` and ``workflow/serving.py``; the hook-under-lock
convoy spanned three modules. This module gives the ``PIO206``–``PIO209``
rules (:mod:`rules_program`) the missing half: a package-internal call
graph built purely from the ASTs the engine already parsed — stdlib-only
like the rest of the package, the linter still never imports what it
lints.

Resolution model (documented blind spots in docs/development.md):

* **functions** are indexed by qualified name ``module.func`` /
  ``module.Class.method`` (top-level classes only; nested defs belong to
  their enclosing function and are not call targets);
* a call resolves through, in order: ``self.method()`` (own class, then
  package-internal base classes), ``Class.method()`` / ``Class()``
  constructors via the file's import map, module-level and imported
  functions via the import map, ``self.<attr>.method()`` where the
  attribute's class is known from a constructor assignment or an
  annotation, ``local = Class(...); local.method()`` flow inside one
  function, and annotated parameters (``service: QueryService``, string
  annotations included). A short-name fallback resolves a method on an
  *unambiguous* class name when imports cannot be traced (duck-typed
  hand-offs like the runner's ``service`` are the norm in this tree);
* anything else — ``getattr``, decorators that rebind, containers of
  callables, ``**kwargs`` dispatch — is unresolved: the graph is a
  sound-enough under-approximation for diagnostics, not a verifier.

The graph also precomputes the two facts the rules need per function:
which locks it acquires (``with self._lock`` / ``with MOD_LOCK``) and
which calls happen while a lock is held — so the interprocedural passes
are single BFS/DFS sweeps with memoization and the full-tree lint stays
well inside its CI budget.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable

from predictionio_tpu_torch.analysis.engine import FileContext

__all__ = [
    "CallGraph",
    "CallSite",
    "ClassInfo",
    "FunctionInfo",
    "LockAcquisition",
    "ProgramContext",
    "build_callgraph",
    "digraph_cycles",
    "module_name",
]

#: method names so common across stdlib/protocol objects that a
#: unique-in-package match proves nothing about the receiver's type
_UBIQUITOUS_METHODS = frozenset(
    {
        "acquire", "add", "append", "clear", "close", "commit", "copy",
        "decode", "encode", "flush", "get", "items", "join", "keys",
        "kill", "open", "poll", "pop", "put", "read", "recv", "release",
        "run", "send", "set", "start", "stop", "terminate", "update",
        "values", "wait", "write",
    }
)

#: the port's package: the only code whose ``getattr``-named classes the
#: graph resolves (:meth:`_Resolver._local_types`)
_PORT_PACKAGE = "predictionio_tpu_torch."

#: may-call alternatives a duck-typed dispatch fans out to before the
#: resolver gives up as too ambiguous. Sized to the deepest real
#: wrapper stack: five storage classes define ``tail_follow`` (columnar
#: driver + client wrapper + partitioned store + its per-partition view
#: + the replicated store) and the runtime lock witness flags analyzer
#: gaps the moment an over-tight bound drops that chain
_DUCK_MAX = 6


def module_name(rel_path: str) -> str:
    """``predictionio_tpu/serving/batcher.py`` ->
    ``predictionio_tpu.serving.batcher``; ``__init__.py`` maps to its
    package."""
    parts = rel_path.replace("\\", "/").split("/")
    parts[-1] = parts[-1][:-3]  # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(p for p in parts if p)


@dataclasses.dataclass
class LockAcquisition:
    """One ``with <lock>`` acquisition site."""

    lock_id: str  #: global identity, e.g. ``pkg.mod.Class.attr``
    line: int
    #: lock ids already held lexically at this acquisition (outer withs)
    held: tuple[str, ...]


@dataclasses.dataclass
class CallSite:
    line: int
    col: int
    #: resolved package-internal callee qualified names (possibly several
    #: when only an ambiguous short-name match exists: the rule treats
    #: them as may-call alternatives)
    callees: tuple[str, ...]
    #: absolute dotted name when the callee is external (``time.sleep``)
    external: str | None
    #: lock ids held lexically at the call
    held: tuple[str, ...]


@dataclasses.dataclass
class FunctionInfo:
    qname: str
    rel_path: str
    module: str
    cls: str | None  #: bare class name for methods
    name: str
    node: ast.AST
    lineno: int
    #: parameter names in positional order (excluding self/cls)
    params: tuple[str, ...]
    calls: list[CallSite] = dataclasses.field(default_factory=list)
    acquisitions: list[LockAcquisition] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ClassInfo:
    qname: str  #: ``module.Class``
    rel_path: str
    name: str
    node: ast.ClassDef
    #: method name -> function qname
    methods: dict[str, str] = dataclasses.field(default_factory=dict)
    #: self attributes assigned ``threading.Lock()``/``RLock()``
    lock_attrs: set[str] = dataclasses.field(default_factory=set)
    #: self attribute -> class qname inferred from ``self.x = Class(...)``
    #: or an annotation naming a known class
    attr_types: dict[str, str] = dataclasses.field(default_factory=dict)
    #: attrs constructed from a class OUTSIDE the package (``self._t =
    #: threading.Thread(...)``) — known-foreign, so method calls on them
    #: must never duck-resolve to in-package methods
    attr_foreign: set[str] = dataclasses.field(default_factory=set)
    #: resolved package-internal base class qnames
    bases: tuple[str, ...] = ()


class ProgramContext:
    """What a program-scope rule receives: every parsed file plus the
    call graph built over them."""

    def __init__(self, contexts: dict[str, FileContext], graph: "CallGraph"):
        self.contexts = contexts
        self.graph = graph
        #: memoized lock_order_cycles() result — the PIO207 rule, the
        #: engine's LintResult and the witness classification all need
        #: the same cycle set; compute it once per program pass
        self._lock_cycles: list[dict] | None = None


def digraph_cycles(edges: Iterable[tuple[str, str]]) -> list[list[str]]:
    """Every elementary cycle of a digraph as canonical node lists (the
    smallest node leads, no trailing repeat). Deterministic: start nodes
    and neighbors are visited sorted. Shared by the static lock-order
    rule (PIO207) and the runtime witness's inversion detection so the
    two halves of the concurrency story can never drift on what counts
    as a cycle.

    Each cycle is enumerated exactly once, rooted at its smallest node:
    the DFS from ``start`` only walks nodes ``> start`` and emits a
    cycle when an edge closes back to ``start``. A single global
    visited set would be wrong here — a node can participate in several
    elementary cycles (A->B->C->A and A->C->A share C), and pruning it
    after the first would silently drop real deadlock rings."""
    graph: dict[str, set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)

    out: list[list[str]] = []

    def dfs(start: str, n: str, path: list[str], on_path: set[str]) -> None:
        for m in sorted(graph.get(n, ())):
            if m == start:
                out.append(list(path))
            elif m > start and m not in on_path:
                path.append(m)
                on_path.add(m)
                dfs(start, m, path, on_path)
                path.pop()
                on_path.discard(m)

    for start in sorted(graph):
        dfs(start, start, [start], {start})
    return out


class CallGraph:
    def __init__(self) -> None:
        #: function qname -> FunctionInfo
        self.functions: dict[str, FunctionInfo] = {}
        #: class qname -> ClassInfo
        self.classes: dict[str, ClassInfo] = {}
        #: bare class name -> [class qname] (for last-resort resolution)
        self.class_short: dict[str, list[str]] = {}
        #: bare function name -> [function qname] (module-level only)
        self.func_short: dict[str, list[str]] = {}

    # ------------------------------------------------------------- queries
    def methods_named(self, name: str) -> list[str]:
        """Function qnames of every method called ``name`` anywhere —
        the explicit may-call fallback for duck-typed dispatch."""
        return [
            fq
            for fq, fi in self.functions.items()
            if fi.cls is not None and fi.name == name
        ]

    def resolve_method(self, class_qname: str, method: str) -> str | None:
        """Method lookup through the (package-internal) base chain."""
        seen: set[str] = set()
        stack = [class_qname]
        while stack:
            cq = stack.pop(0)
            if cq in seen:
                continue
            seen.add(cq)
            ci = self.classes.get(cq)
            if ci is None:
                continue
            if method in ci.methods:
                return ci.methods[method]
            stack.extend(ci.bases)
        return None

    def class_locks(self, class_qname: str) -> set[str]:
        """Lock attrs declared by a class or its internal bases."""
        out: set[str] = set()
        seen: set[str] = set()
        stack = [class_qname]
        while stack:
            cq = stack.pop(0)
            if cq in seen:
                continue
            seen.add(cq)
            ci = self.classes.get(cq)
            if ci is None:
                continue
            out |= ci.lock_attrs
            stack.extend(ci.bases)
        return out


# ---------------------------------------------------------------------------
# Building
# ---------------------------------------------------------------------------


def _param_names(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> tuple[str, ...]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args]
    return tuple(n for n in names if n not in ("self", "cls"))


def _annotation_name(node: ast.AST | None) -> str | None:
    """Best-effort class name out of an annotation: ``QueryService``,
    ``"QueryService"``, ``Optional[QueryService]``, ``QueryService |
    None``, ``serving.QueryService`` (returns the dotted text)."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        # string annotation: re-parse the text
        try:
            return _annotation_name(ast.parse(node.value, mode="eval").body)
        except SyntaxError:
            return None
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        parts: list[str] = []
        cur: ast.AST = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if isinstance(cur, ast.Name):
            parts.append(cur.id)
            return ".".join(reversed(parts))
        return None
    if isinstance(node, ast.Subscript):  # Optional[X], list[X] — take X
        inner = node.slice
        if isinstance(inner, ast.Tuple) and inner.elts:
            inner = inner.elts[0]
        return _annotation_name(inner)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        # X | None — prefer the non-None side
        left = _annotation_name(node.left)
        if left and left != "None":
            return left
        return _annotation_name(node.right)
    return None


def _dotted(node: ast.AST) -> str | None:
    """Raw dotted text of a Name/Attribute chain (no import resolution)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


class _Indexer:
    """Pass 1: function/class/lock/attr-type index over every file."""

    def __init__(self, graph: CallGraph):
        self.graph = graph

    def index_file(self, ctx: FileContext) -> None:
        mod = module_name(ctx.rel_path)
        for stmt in ctx.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_function(ctx, mod, None, stmt)
            elif isinstance(stmt, ast.ClassDef):
                self._index_class(ctx, mod, stmt)

    def _add_function(
        self,
        ctx: FileContext,
        mod: str,
        cls: str | None,
        node: ast.FunctionDef | ast.AsyncFunctionDef,
    ) -> FunctionInfo:
        qname = f"{mod}.{cls}.{node.name}" if cls else f"{mod}.{node.name}"
        fi = FunctionInfo(
            qname=qname,
            rel_path=ctx.rel_path,
            module=mod,
            cls=cls,
            name=node.name,
            node=node,
            lineno=node.lineno,
            params=_param_names(node),
        )
        # first definition wins (overloads/if-TYPE_CHECKING double defs)
        self.graph.functions.setdefault(qname, fi)
        if cls is None:
            self.graph.func_short.setdefault(node.name, []).append(qname)
        return fi

    def _index_class(self, ctx: FileContext, mod: str, cls: ast.ClassDef) -> None:
        cq = f"{mod}.{cls.name}"
        ci = ClassInfo(qname=cq, rel_path=ctx.rel_path, name=cls.name, node=cls)
        self.graph.classes.setdefault(cq, ci)
        self.graph.class_short.setdefault(cls.name, []).append(cq)
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = self._add_function(ctx, mod, cls.name, stmt)
                ci.methods.setdefault(stmt.name, fi.qname)
        # lock attrs + constructor-typed attrs, anywhere in the class body
        for node in ast.walk(cls):
            if isinstance(node, ast.AnnAssign):
                attr = _self_attr(node.target)
                ann = _annotation_name(node.annotation)
                if attr and ann:
                    ci.attr_types.setdefault(attr, ann)  # resolved in pass 2
                continue
            if not isinstance(node, ast.Assign):
                continue
            v = node.value
            if not isinstance(v, ast.Call):
                continue
            callee = ctx.dotted_name(v.func)
            for t in node.targets:
                attr = _self_attr(t)
                if attr is None:
                    continue
                if callee in ("threading.Lock", "threading.RLock"):
                    ci.lock_attrs.add(attr)
                elif callee:
                    ci.attr_types.setdefault(attr, callee)


def _self_attr(node: ast.AST) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class _Resolver:
    """Pass 2: resolve bases, attr types, calls, and lock acquisitions."""

    def __init__(self, graph: CallGraph):
        self.graph = graph

    # -------------------------------------------------------- name helpers
    def _class_qname_for(self, ctx: FileContext, name: str | None) -> str | None:
        """Dotted or bare name (as written in source) -> class qname."""
        if not name:
            return None
        # through the import map: `from x.y import QueryService` or the
        # local module's own class
        head, _, rest = name.partition(".")
        resolved = ctx.import_map.get(head, head)
        dotted = f"{resolved}.{rest}" if rest else resolved
        if dotted in self.graph.classes:
            return dotted
        local = f"{module_name(ctx.rel_path)}.{name}"
        if local in self.graph.classes:
            return local
        # unambiguous short name (duck-typed hand-offs: `service`)
        short = name.rsplit(".", 1)[-1]
        hits = self.graph.class_short.get(short, ())
        if len(hits) == 1:
            return hits[0]
        return None

    def _lock_id(
        self,
        ctx: FileContext,
        item: ast.withitem,
        fi: FunctionInfo,
        local_types: dict[str, str],
    ) -> str | None:
        return self._lock_id_expr(ctx, item.context_expr, fi, local_types)

    def _lock_id_expr(
        self,
        ctx: FileContext,
        e: ast.AST,
        fi: FunctionInfo,
        local_types: dict[str, str],
    ) -> str | None:
        """Global lock identity for a lock expression (a with-item's
        context or the receiver of an explicit ``.acquire()``), or None
        when unknowable. ``self._lock`` -> ``module.Class._lock``
        (declared-or-inherited locks only); bare module-level names
        containing "lock" -> ``module.NAME``; ``self.<attr>._lock``-style
        foreign locks and arbitrary expressions stay anonymous."""
        attr = _self_attr(e)
        if attr is not None and fi.cls is not None:
            cq = f"{fi.module}.{fi.cls}"
            if attr in self.graph.class_locks(cq):
                return f"{cq}.{attr}"
            if "lock" in attr.lower():
                return f"{cq}.{attr}"
            return None
        if isinstance(e, ast.Name):
            if e.id in local_types:
                return None  # a local object, identity not a lock name
            if "lock" in e.id.lower():
                resolved = ctx.import_map.get(e.id)
                if resolved and "." in resolved:
                    return resolved  # imported module-level lock
                return f"{fi.module}.{e.id}"
            return None
        # obj.attr where obj's class is known and declares the lock
        if isinstance(e, ast.Attribute):
            base = e.value
            base_cls: str | None = None
            if isinstance(base, ast.Name):
                base_cls = local_types.get(base.id)
            else:
                battr = _self_attr(base)
                if battr is not None and fi.cls is not None:
                    own = self.graph.classes.get(f"{fi.module}.{fi.cls}")
                    if own is not None:
                        base_cls = self._class_qname_for(
                            ctx, own.attr_types.get(battr)
                        )
            if base_cls and (
                e.attr in self.graph.class_locks(base_cls)
                or "lock" in e.attr.lower()
            ):
                return f"{base_cls}.{e.attr}"
        return None

    # ----------------------------------------------------------- resolution
    def finalize_classes(self, ctx: FileContext) -> None:
        """Resolve this file's class bases and annotation-typed attrs to
        qnames. Must run for EVERY file before any file's functions are
        resolved: method resolution walks base chains and attr types of
        classes in OTHER files, and a per-file interleave would make
        call edges into alphabetically-later files silently vanish."""
        for cq, ci in self.graph.classes.items():
            if ci.rel_path != ctx.rel_path:
                continue
            bases = []
            for b in ci.node.bases:
                bq = self._class_qname_for(ctx, _dotted(b))
                if bq:
                    bases.append(bq)
            ci.bases = tuple(bases)
            for attr, tname in list(ci.attr_types.items()):
                tq = self._class_qname_for(ctx, tname)
                if tq:
                    ci.attr_types[attr] = tq
                    continue
                del ci.attr_types[attr]
                # only a CLASS constructor of an unresolvable class is
                # known-foreign (threading.Thread, http.client.*): the
                # duck-typed fallback must stay available for attrs
                # assigned from lowercase FACTORY calls (`self._pe =
                # Storage.get_p_events()`) — their return type is simply
                # unknown, and treating them as foreign hid every lock
                # edge through the storage driver from the static graph
                last = tname.rsplit(".", 1)[-1]
                if last[:1].isupper():
                    ci.attr_foreign.add(attr)

    def resolve_file(self, ctx: FileContext) -> None:
        for fq, fi in self.graph.functions.items():
            if fi.rel_path == ctx.rel_path:
                self._resolve_function(ctx, fi)

    def _local_types(
        self, ctx: FileContext, fi: FunctionInfo
    ) -> tuple[dict[str, str], dict[str, str], dict[str, tuple[str, ...]]]:
        """-> (name -> class qname, name -> aliased self attr, name ->
        class qnames) for one function body: annotated params and
        constructor assignments in the first map; bare ``svc =
        self.service`` aliases in the second — so a method call through
        the alias resolves exactly like the ``self.service.method()``
        spelling (the alias idiom otherwise hid whole call chains, and
        with them their lock edges, from the static graph). The third,
        under ``predictionio_tpu_torch/`` only (elsewhere the graph is the
        reference's): ``cls = getattr(module, "StorageClient", None)``, a
        class looked up by a constant name, which may be any of the port's
        classes of that name — the storage registry builds its drivers
        so, under its lock, and the lock witness saw that order."""
        out: dict[str, str] = {}
        aliases: dict[str, str] = {}
        classes: dict[str, tuple[str, ...]] = {}
        in_port = fi.module.startswith(_PORT_PACKAGE)
        node = fi.node
        assert isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        for a in (*node.args.posonlyargs, *node.args.args, *node.args.kwonlyargs):
            if a.arg in ("self", "cls"):
                continue
            tq = self._class_qname_for(ctx, _annotation_name(a.annotation))
            if tq:
                out[a.arg] = tq
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Assign):
                continue
            named = _getattr_constant(sub.value) if in_port else None
            if named is not None:
                port = tuple(cq for cq in self.graph.class_short.get(named, ()) if cq.startswith(_PORT_PACKAGE))
                for t in sub.targets:
                    if port and isinstance(t, ast.Name):
                        classes.setdefault(t.id, port)
                continue
            if isinstance(sub.value, ast.Call):
                tq = self._class_qname_for(ctx, _dotted(sub.value.func))
                if tq:
                    for t in sub.targets:
                        if isinstance(t, ast.Name):
                            out.setdefault(t.id, tq)
                continue
            battr = _self_attr(sub.value)
            if battr is not None:
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        aliases.setdefault(t.id, battr)
        return out, aliases, classes

    def _resolve_call(
        self,
        ctx: FileContext,
        fi: FunctionInfo,
        call: ast.Call,
        local_types: dict[str, str],
        local_aliases: dict[str, str] | None = None,
        local_classes: dict[str, tuple[str, ...]] | None = None,
    ) -> tuple[tuple[str, ...], str | None]:
        """-> (internal callee qnames, external dotted name)."""
        local_aliases = local_aliases or {}
        func = call.func
        if isinstance(func, ast.Name) and local_classes and func.id in local_classes:
            # cls(config) after cls = getattr(module, "Name"): the
            # constructor of each of the port's classes of that name
            inits = (self.graph.resolve_method(cq, "__init__") for cq in local_classes[func.id])
            return tuple(i for i in inits if i), None
        # self.method()
        attr = _self_attr(func)
        if attr is not None and fi.cls is not None:
            target = self.graph.resolve_method(f"{fi.module}.{fi.cls}", attr)
            if target:
                return (target,), None
            # self.<hook>() with no such method: a duck-typed injected
            # callable — may-call every method of that name in-package
            return tuple(self.graph.methods_named(attr))[:_DUCK_MAX], None
        if isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Subscript):
                # container element dispatch — `self.followers[i].poll()`
                # (or through a bare alias): _annotation_name already
                # collapses a `list[TailFollower]` attr annotation to the
                # element class, so the subscripted call resolves exactly
                # like the unsubscripted spelling. Without this the
                # per-partition follower fan-out dropped the whole
                # runner->follower->store lock chain (runtime witness gap)
                base = base.value
            # obj.method() with a known obj type
            base_cls: str | None = None
            if isinstance(base, ast.Name):
                base_cls = local_types.get(base.id)
            battr = _self_attr(base)
            if (
                battr is None
                and isinstance(base, ast.Name)
                and base.id not in local_types
            ):
                # `svc = self.service; svc.method()` — the alias carries
                # the self attr through, typed path and duck-typed
                # fallback alike
                battr = local_aliases.get(base.id)
            if battr is not None and fi.cls is not None:
                own = self.graph.classes.get(f"{fi.module}.{fi.cls}")
                if own is not None:
                    base_cls = own.attr_types.get(battr) or base_cls
            if base_cls:
                target = self.graph.resolve_method(base_cls, func.attr)
                if target:
                    return (target,), None
            dotted = ctx.dotted_name(func)
            if dotted:
                # Class.method via imports (or the local module's class)
                head = dotted.rsplit(".", 1)[0]
                hq = head if head in self.graph.classes else None
                if hq is None and f"{fi.module}.{head}" in self.graph.classes:
                    hq = f"{fi.module}.{head}"
                if hq is not None:
                    target = self.graph.resolve_method(hq, func.attr)
                    if target:
                        return (target,), None
                if dotted in self.graph.functions:
                    return (dotted,), None
                # external only when the chain is rooted at an imported
                # module alias — `self.x.y()` / `local.y()` are objects,
                # not modules, and must not masquerade as dotted calls
                root = dotted.split(".", 1)[0]
                cur: ast.AST = base
                while isinstance(cur, ast.Attribute):
                    cur = cur.value
                root_is_import = (
                    isinstance(cur, ast.Name) and cur.id in ctx.import_map
                )
                if root_is_import and root not in ("self", "cls"):
                    return (), dotted
            # duck-typed hand-off (`self.service.apply_online_update()`
            # where `service` was injected untyped): treat every
            # in-package method of that name as a may-call alternative,
            # same bound as the self.<hook>() fallback above — requiring
            # exactly one definition hid the whole storage-driver lock
            # chain (two classes define tail_follow: the driver and its
            # wrapper), which the runtime witness caught as analyzer
            # gaps. Only for self-attributes of UNKNOWN origin — bare
            # locals and attrs constructed from foreign classes
            # (threads, sockets) are overwhelmingly stdlib objects — and
            # never for ubiquitous protocol names.
            if (
                battr is not None
                and fi.cls is not None
                and func.attr not in _UBIQUITOUS_METHODS
            ):
                own = self.graph.classes.get(f"{fi.module}.{fi.cls}")
                if own is not None and battr not in own.attr_foreign:
                    hits = self.graph.methods_named(func.attr)
                    if 1 <= len(hits) <= _DUCK_MAX:
                        return tuple(hits), None
            return (), None
        if isinstance(func, ast.Name):
            resolved = ctx.import_map.get(func.id, func.id)
            # constructor?
            cq = self._class_qname_for(ctx, func.id)
            if cq is not None and cq.rsplit(".", 1)[-1] == func.id:
                init = self.graph.resolve_method(cq, "__init__")
                return ((init,) if init else ()), None
            for cand in (resolved, f"{fi.module}.{func.id}"):
                if cand in self.graph.functions:
                    return (cand,), None
            if "." in resolved:
                return (), resolved
            return (), None
        return (), None

    def _resolve_function(self, ctx: FileContext, fi: FunctionInfo) -> None:
        local_types, local_aliases, local_classes = self._local_types(ctx, fi)

        def walk(node: ast.AST, held: tuple[str, ...], anon: int) -> None:
            #: locks taken by an explicit `X.acquire()` STATEMENT among
            #: this body's earlier children — held by every later sibling
            #: (and its subtree) until a matching `X.release()` at the
            #: same level. The `acquire(); try: ... finally: release()`
            #: idiom thus marks the whole try as held, release included —
            #: close enough to `with` semantics for ordering edges, and
            #: the only way the router's _reload_lock is visible at all.
            explicit: list[str] = []
            for child in ast.iter_child_nodes(node):
                child_held = held + tuple(explicit)
                child_anon = anon
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                    # nested defs run later, under their caller's locks —
                    # never under these (mirrors PIO201/202)
                    walk(child, (), 0)
                    continue
                # `if not X.acquire(...): <bail>` — the try-acquire idiom:
                # every path PAST the If holds the lock (the If body is
                # the didn't-get-it bail, walked below without it)
                if (
                    isinstance(child, ast.If)
                    and isinstance(child.test, ast.UnaryOp)
                    and isinstance(child.test.op, ast.Not)
                    and isinstance(child.test.operand, ast.Call)
                    and isinstance(child.test.operand.func, ast.Attribute)
                    and child.test.operand.func.attr == "acquire"
                ):
                    lid = self._lock_id_expr(
                        ctx, child.test.operand.func.value, fi, local_types
                    )
                    if lid is not None:
                        fi.acquisitions.append(
                            LockAcquisition(
                                lock_id=lid,
                                line=child.lineno,
                                held=child_held,
                            )
                        )
                        explicit.append(lid)
                        walk(child, child_held, child_anon)
                        continue
                call = None
                if isinstance(
                    child, (ast.Expr, ast.Assign)
                ) and isinstance(child.value, ast.Call):
                    call = child.value
                if (
                    call is not None
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr in ("acquire", "release")
                ):
                    lid = self._lock_id_expr(
                        ctx, call.func.value, fi, local_types
                    )
                    if lid is not None:
                        if call.func.attr == "acquire":
                            fi.acquisitions.append(
                                LockAcquisition(
                                    lock_id=lid,
                                    line=child.lineno,
                                    held=child_held,
                                )
                            )
                            explicit.append(lid)
                        elif lid in explicit:
                            explicit.remove(lid)
                        continue  # the acquire/release call itself is no edge
                if isinstance(child, ast.With):
                    acquired: list[str] = []
                    anon_acquired = 0
                    for item in child.items:
                        lid = self._lock_id(ctx, item, fi, local_types)
                        if lid is not None:
                            acquired.append(lid)
                        elif _looks_like_lock(item):
                            anon_acquired += 1
                    for lid in acquired:
                        fi.acquisitions.append(
                            LockAcquisition(
                                lock_id=lid, line=child.lineno, held=child_held
                            )
                        )
                    if acquired or anon_acquired:
                        child_held = child_held + tuple(acquired)
                        child_anon = anon + anon_acquired
                if isinstance(child, ast.Call):
                    callees, external = self._resolve_call(
                        ctx, fi, child, local_types, local_aliases, local_classes
                    )
                    if callees or external:
                        fi.calls.append(
                            CallSite(
                                line=child.lineno,
                                col=child.col_offset,
                                callees=callees,
                                external=external,
                                # an anonymous lock still counts as "a
                                # lock is held" for PIO206's purposes
                                held=child_held
                                + (("<lock>",) * child_anon if child_anon else ()),
                            )
                        )
                walk(child, child_held, child_anon)

        walk(fi.node, (), 0)


def _getattr_constant(node: ast.AST) -> str | None:
    """``"Name"`` of a ``getattr(obj, "Name"[, default])`` call, else None."""
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "getattr"
        and len(node.args) >= 2
        and isinstance(node.args[1], ast.Constant)
        and isinstance(node.args[1].value, str)
    ):
        return node.args[1].value
    return None


def _looks_like_lock(item: ast.withitem) -> bool:
    e = item.context_expr
    name = None
    if isinstance(e, ast.Attribute):
        name = e.attr
    elif isinstance(e, ast.Name):
        name = e.id
    return name is not None and "lock" in name.lower()


def build_callgraph(contexts: dict[str, FileContext]) -> CallGraph:
    graph = CallGraph()
    indexer = _Indexer(graph)
    ordered = [contexts[p] for p in sorted(contexts)]
    for ctx in ordered:
        indexer.index_file(ctx)
    resolver = _Resolver(graph)
    for ctx in ordered:
        resolver.finalize_classes(ctx)
    for ctx in ordered:
        resolver.resolve_file(ctx)
    return graph
