"""PIO306–PIO308 — whole-program compile/transfer hygiene rules.

Every serving tier this repo has grown (batching, cache/pin, ANN,
sharding, int8) is fast only as long as XLA compiles each hot program
ONCE and never round-trips to host mid-path — the compile-once/
execute-many property ALX (arxiv 2112.02194) and the MLlib pipeline
idiom both hinge on. The per-file ``PIO301``–``PIO305`` rules check a
jitted function's own body; these three close the whole-program half
over :mod:`callgraph`, the same way ``PIO206``–``PIO209`` closed
it for locks:

* ``PIO306`` unbounded retrace risk: a **static** argument of a jitted
  function is fed — through the call graph — from a request-derived
  value with no bucketing step in between. Statics key the jit cache,
  so request-cardinality statics mean request-cardinality compiles; the
  sanctioned fix is the pow2-bucket idiom (``1 << (n-1).bit_length()``,
  ``ops/ivf.query_topk`` / ``serving_util.chunked_topk`` /
  ``online/foldin._bucket``), recognized declaratively below.
* ``PIO307`` host transfer on a serving path: ``np.asarray``/
  ``np.array``/``jax.device_get``/``.item()``/``.tolist()``/
  ``.block_until_ready()`` in a device-facing module (``ops/``,
  ``parallel/``, ``workflow/device_state.py``) reachable from a
  QueryService request/fold entrypoint. The per-path chain is rendered
  like ``PIO206``; the known boundary crossings (the device_state
  pin/swap layer, the documented single-transfer result
  materializations) live in a declarative allow-list with per-entry
  justifications.
* ``PIO308`` jit constructed per call: ``jax.jit(...)`` (or
  ``functools.partial(jax.jit, ...)``) evaluated inside a function body
  on a request/fold path. Every evaluation builds a fresh jit wrapper
  with an EMPTY cache — each call pays a full trace+compile. Sanctioned
  shapes: module scope, an ``functools.lru_cache``-decorated factory,
  or the cached-per-key slot idiom (``CACHE[key] = jax.jit(...)``,
  see ``device_state._sharded_set_rows``).

Request/fold entrypoints are matched by NAME (declarative:
:data:`_REQUEST_ROOTS`) because the serving hand-offs in this tree are
duck-typed — ``QueryService.handle_query`` calls ``algo.predict_base``
through an untyped pair list the call graph cannot resolve, so every
in-package implementation of a serving hook is a root of its own.
Parameters named ``self``/``cls``/``model`` are not request-derived
(model state is generation-bounded, not request-bounded).

The runtime half lives in :mod:`predictionio_tpu_torch.analysis.jit_witness`:
``pio jitwitness`` / ``pytest --jit-witness`` classify each of these
findings CONFIRMED (a retrace / transfer / jit construction was
actually witnessed at the site) vs PLAUSIBLE, and the checked-in
``compile-budget.json`` ledger turns a witnessed retrace regression
into a red CI (docs/development.md).

This is the port's copy of ``predictionio_tpu/analysis/rules_compile.py``.
On code outside ``predictionio_tpu_torch/`` it finds what the reference
finds. Under ``predictionio_tpu_torch/`` it also knows torch:

* ``PIO307`` scopes the port's device-facing modules (``ops/``,
  ``parallel/``, ``workflow/device_state.py``) and counts torch's host
  crossings there besides the reference's: ``.cpu()``, ``.numpy()``,
  ``.to("cpu")`` / ``.to(device="cpu")`` and ``torch.cuda.synchronize()``
  (``.item()`` and ``.tolist()`` are the reference's own). The port's
  known crossings have their own allow-list entries below.
* ``PIO308`` counts ``torch.compile(...)`` (and ``@torch.compile`` on a
  nested def) and ``aoti_load_package(...)`` evaluated inside a function
  body on a request/fold path, with the reference's sanctioned shapes.
* ``PIO306`` has no torch counterpart: it keys on the static arguments
  of ``jax.jit``, and the port's serving code is eager — it compiles
  nothing per request, only through ``torch.compile`` and AOTInductor
  packages, whose shape guards no AST rule can see. The port's runtime
  half covers it: the jit witness's per-site compile counts against
  ``compile-budget-torch.json``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from predictionio_tpu_torch.analysis.callgraph import (
    CallGraph,
    FunctionInfo,
    ProgramContext,
)
from predictionio_tpu_torch.analysis.engine import FileContext, Finding, program_rule
from predictionio_tpu_torch.analysis.rules_jax import (
    _is_jit_expr,
    _static_param_names,
)

__all__ = ["reachable_from_roots", "request_roots"]

#: function/method NAMES that begin a request or fold path. Name-based
#: on purpose: the serving hand-offs are duck-typed (``algo
#: .predict_base`` through an untyped pair list), so the graph roots at
#: every in-package implementation of a serving hook instead of trying
#: to resolve the hand-off.
_REQUEST_ROOTS = frozenset(
    {
        "handle_query",
        "handle_query_cached",
        "handle_batch",
        "handle_batch_jsonlines",
        "dispatch",
        "predict",
        "predict_base",
        "batch_predict",
        "batch_predict_base",
        "batch_predict_json",
        "fold_now",
        "apply_online_update",
        "online_foldin",
    }
)

#: parameters never considered request-derived: model/engine state is
#: generation-bounded (a handful of distinct shapes per deploy), not
#: request-bounded
_NONREQUEST_PARAMS = frozenset({"self", "cls", "model"})

#: interprocedural fixpoint fuse (matches rules_program._MAX_CHAIN)
_MAX_PASSES = 8

#: host-transfer callables (dotted, import-resolved) and method names
_TRANSFER_CALLS = frozenset({"numpy.asarray", "numpy.array", "jax.device_get"})
_TRANSFER_METHODS = frozenset({"item", "tolist", "block_until_ready"})

#: the port's package: torch's additions below apply under it only, so
#: findings elsewhere stay the reference's
_PORT = "predictionio_tpu_torch/"

#: torch's host crossings, on top of the reference's, in the port's scope
#: (``.to`` counts only with a literal ``"cpu"`` device, see
#: :func:`_torch_transfer`)
_TORCH_TRANSFER_CALLS = frozenset({"torch.cuda.synchronize"})
_TORCH_TRANSFER_METHODS = frozenset({"cpu", "numpy"})

#: PIO307 scope: the device-facing modules where a numpy conversion IS
#: a device->host link crossing (everywhere else numpy is the host path)
_TRANSFER_SCOPE = (
    "predictionio_tpu/ops/",
    "predictionio_tpu/parallel/",
    "predictionio_tpu/workflow/device_state.py",
    "predictionio_tpu_torch/ops/",
    "predictionio_tpu_torch/parallel/",
    "predictionio_tpu_torch/workflow/device_state.py",
)

#: PIO307 allow-list — the known, documented boundary crossings. Path ->
#: None (whole file) or {function name -> justification}. Every entry
#: must carry a justification; docs/development.md lists them.
_TRANSFER_ALLOWED: dict = {
    # the pin/swap layer IS the host<->device boundary: staging pinned
    # tables, gathering for re-layout, and copy-on-write host swaps are
    # its contract (docs/serving.md)
    "predictionio_tpu/workflow/device_state.py": None,
    "predictionio_tpu/ops/ivf.py": {
        # bounded [1, k] result materialization at the response boundary
        # — the single documented transfer of the single-query path
        "query_topk": "bounded [1,k] result materialization; the "
        "response must reach host exactly once",
        # sentinel trim runs on host over an already-transferred row
        "trim_row": "operates on host rows the caller already "
        "materialized (one transfer per batch, upstream)",
    },
    "predictionio_tpu/ops/quant.py": {
        # dequantizing __getitem__/__array__ is QuantizedTable's
        # ndarray-compat contract for HOST-path callers
        "QuantizedTable": "ndarray-compat dequantize for host-path "
        "readers; device kernels read codes/scales directly",
        "quantize_table_host": "host-side quantizer by contract (build "
        "layout + fold-in delta re-quantize); its inputs are host rows",
        "dequantize": "dual host/device helper — the numpy branch runs "
        "only on host-backed tables",
        "run_topk": "int32 index staging in, results stay ON device; "
        "the one numpy read is the per-chunk counter",
        "topk_users": "host-facing wrapper: bounded [B, k] finalist "
        "materialization — the single documented crossing per batch",
    },
    "predictionio_tpu/parallel/sharding.py": {
        "topk_users": "host-facing wrapper: bounded [B, k] finalist "
        "materialization — the single documented crossing per batch",
    },
    # ------------------------------------------------------------ the port
    # the pin/swap layer IS the host<->device boundary, as in the
    # reference
    "predictionio_tpu_torch/workflow/device_state.py": None,
    "predictionio_tpu_torch/ops/ivf.py": {
        "query_topk": "bounded [1,k] result materialization; the "
        "response must reach host exactly once",
        "trim_row": "operates on host rows the caller already "
        "materialized (one transfer per batch, upstream)",
        "_full_probe": "the host-table branch only: .cpu() on query "
        "vectors a host-path caller handed in; tensor tables stay on "
        "the device through score_rows",
        "ivf_topk_users": "user ids to int64 on entry, and the row "
        "gather of a host (numpy) factor table; the device branch "
        "gathers on the device",
    },
    "predictionio_tpu_torch/ops/quant.py": {
        "QuantizedTable": "ndarray-compat dequantize for host-path "
        "readers; device kernels read codes/scales directly",
        "quantize_table_host": "host-side quantizer by contract (build "
        "layout + fold-in delta re-quantize); its inputs are host rows",
        "dequantize": "dual host/device helper — the numpy branch runs "
        "only on host-backed tables",
        "run_topk": "int32 index staging in, results stay ON device; "
        "the one numpy read is the per-chunk counter",
        "topk_users": "host-facing wrapper: bounded [B, k] finalist "
        "materialization — the single documented crossing per batch",
    },
    "predictionio_tpu_torch/ops/topk.py": {
        "top_k_host": "the host top-k by contract: its callers hand it "
        "host score arrays (the CPU serving branch)",
        "order_key": "dual host/device helper — the numpy branch runs "
        "only on host arrays; tensors stay on their device",
    },
    "predictionio_tpu_torch/parallel/sharding.py": {
        "topk_users": "host-facing wrapper: bounded [B, k] finalist "
        "materialization — the single documented crossing per batch",
        "set_rows": "fold-in rows arrive as host arrays; ids are split "
        "by owner shard on the host, rows go up once per shard",
        "relayout": "capacity growth of a pinned sharded table: one "
        "host round trip per doubling, on the fold path, never per "
        "request",
        "_indices": "request ids arrive as host lists and go up once",
    },
}


def _short(qname: str) -> str:
    return qname.removeprefix("predictionio_tpu.")


def _is_jitted(program: ProgramContext, fi: FunctionInfo) -> bool:
    """Is this function itself jit-decorated? Calls INSIDE a jitted
    body are traced inline — their statics are bounded by the OUTER
    jit's own static cardinality, which PIO306 already checks at the
    outer call site — so the compile rules never report inside one."""
    ctx = program.contexts.get(fi.rel_path)
    node = fi.node
    if ctx is None or not isinstance(
        node, (ast.FunctionDef, ast.AsyncFunctionDef)
    ):
        return False
    return any(_is_jit_expr(ctx, d) for d in node.decorator_list)


def request_roots(graph: CallGraph) -> list[str]:
    """Qnames of every request/fold entrypoint in the program."""
    return sorted(
        fq for fq, fi in graph.functions.items() if fi.name in _REQUEST_ROOTS
    )


def reachable_from_roots(
    graph: CallGraph,
) -> dict[str, tuple[str, ...]]:
    """Function qname -> shortest root..fn call chain, for every
    function reachable from a request/fold entrypoint. BFS so the chain
    rendered in diagnostics is the shortest witness."""
    chains: dict[str, tuple[str, ...]] = {}
    frontier: list[str] = []
    for root in request_roots(graph):
        if root not in chains:
            chains[root] = (root,)
            frontier.append(root)
    while frontier:
        nxt: list[str] = []
        for fq in frontier:
            fi = graph.functions.get(fq)
            if fi is None:
                continue
            base = chains[fq]
            for site in fi.calls:
                for callee in site.callees:
                    if callee not in chains and callee in graph.functions:
                        chains[callee] = base + (callee,)
                        nxt.append(callee)
        frontier = nxt
    return chains


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def _names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _expr_is_bucketed(node: ast.AST, bucketed: set[str]) -> bool:
    """Does this expression contain a cardinality-bounding bucket step?
    Recognized declaratively: a call to a function whose name contains
    ``bucket``, a ``.bit_length()`` hop, a left-shift (``1 << n``), or a
    name already proven bucketed."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fname = None
            if isinstance(sub.func, ast.Name):
                fname = sub.func.id
            elif isinstance(sub.func, ast.Attribute):
                fname = sub.func.attr
            if fname is not None and "bucket" in fname.lower():
                return True
            if isinstance(sub.func, ast.Attribute) and sub.func.attr == "bit_length":
                return True
        elif isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.LShift):
            return True
        elif isinstance(sub, ast.Name) and sub.id in bucketed:
            return True
    return False


#: array constructors whose first argument IS a shape: a tainted,
#: unbucketed extent here means the array's SHAPE tracks request
#: cardinality — and every jitted consumer retraces per distinct extent
_SHAPE_CONSTRUCTORS = frozenset({"zeros", "ones", "empty", "full"})


def _is_shape_tainted_expr(
    node: ast.AST, tainted: set[str], bucketed: set[str], shaped: set[str]
) -> bool:
    """Does this expression build (or carry) an array whose shape
    derives from an unbucketed request-cardinality value?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in shaped:
            return True
        if isinstance(sub, ast.Call):
            fname = None
            if isinstance(sub.func, ast.Name):
                fname = sub.func.id
            elif isinstance(sub.func, ast.Attribute):
                fname = sub.func.attr
            if fname in _SHAPE_CONSTRUCTORS and sub.args:
                shape_arg = sub.args[0]
                if _names_in(shape_arg) & tainted and not _expr_is_bucketed(
                    shape_arg, bucketed
                ):
                    return True
    return False


def _local_flow(
    fn: ast.AST, seeds: set[str]
) -> tuple[set[str], set[str], set[str]]:
    """``(tainted, bucketed, shape_tainted)`` name sets inside one
    function body: ``tainted`` carries request-cardinality data (seeded
    by the request-tainted parameters, propagated through simple
    assignments, for-loop bindings and container mutation); a name
    assigned from a bucketed expression moves to ``bucketed`` and stops
    carrying taint; ``shape_tainted`` names arrays whose SHAPE was built
    from an unbucketed tainted extent (``np.zeros((B, width))``)."""
    tainted = set(seeds)
    bucketed: set[str] = set()
    shaped: set[str] = set()
    for _ in range(4):
        grew = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                targets = node.targets
                value = node.value
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
                value = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
                value = node.value
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                # `for idx, query in queries:` binds loop targets from
                # the (possibly tainted) iterable
                targets = [node.target]
                value = node.iter
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("append", "extend", "add", "insert")
                and isinstance(node.func.value, ast.Name)
                and node.args
            ):
                # container mutation: `valid.append((slot, uidx, k))`
                # taints the container — the dominant way serving code
                # accumulates per-request work lists
                targets = [node.func.value]
                value = node.args[-1]
            else:
                continue
            is_b = _expr_is_bucketed(value, bucketed)
            is_t = bool(_names_in(value) & tainted)
            is_s = _is_shape_tainted_expr(value, tainted, bucketed, shaped)
            if not (is_b or is_t or is_s):
                continue
            dests = [bucketed] if (is_b and not is_s) else []
            if is_t and not is_b:
                dests.append(tainted)
            if is_s:
                dests.append(shaped)
            for t in targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                for e in elts:
                    if isinstance(e, ast.Subscript) and isinstance(
                        e.value, ast.Name
                    ):
                        e = e.value  # x[i] = tainted -> x carries taint
                    if not isinstance(e, ast.Name):
                        continue
                    for dest in dests:
                        if e.id not in dest:
                            dest.add(e.id)
                            grew = True
        if not grew:
            break
    return tainted, bucketed, shaped


def _calls_by_pos(fn: ast.AST) -> dict[tuple[int, int], ast.Call]:
    """Exact (line, col) -> ast.Call, to re-attach argument expressions
    to the call graph's resolved :class:`CallSite` records (same trick
    PIO208 uses — resolution happened in pass 2, the args did not come
    along)."""
    out: dict[tuple[int, int], ast.Call] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            out[(node.lineno, node.col_offset)] = node
    return out


def _map_args_to_params(
    call: ast.Call, callee: FunctionInfo
) -> Iterator[tuple[str, ast.AST]]:
    """``(param name, argument expression)`` pairs for a resolved call.
    Positional args map through ``FunctionInfo.params`` (which already
    excludes self/cls, matching how bound methods are called)."""
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            return  # *args splat: positions beyond here are unknowable
        if i < len(callee.params):
            yield callee.params[i], arg
    for kw in call.keywords:
        if kw.arg is not None and kw.arg in callee.params:
            yield kw.arg, kw.value


# ---------------------------------------------------------------------------
# PIO306 — unbounded retrace risk
# ---------------------------------------------------------------------------


def _jitted_defs(program: ProgramContext) -> dict[str, set[str]]:
    """Function qname -> declared static parameter names (possibly
    empty), for every jit-decorated function in the program. Empty
    statics still matter: the SHAPE half of PIO306 applies to every
    jitted callee."""
    from predictionio_tpu_torch.analysis.callgraph import module_name

    out: dict[str, set[str]] = {}
    for rel_path, ctx in program.contexts.items():
        mod = module_name(rel_path)

        def visit(node, prefix: str) -> None:
            for stmt in node.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if any(_is_jit_expr(ctx, d) for d in stmt.decorator_list):
                        out[f"{prefix}{stmt.name}"] = _static_param_names(
                            ctx, stmt
                        )
                elif isinstance(stmt, ast.ClassDef):
                    visit(stmt, f"{prefix}{stmt.name}.")

        visit(ctx.tree, f"{mod}.")
    return out


def _request_tainted_params(
    program: ProgramContext,
) -> tuple[dict[str, set[str]], dict[str, tuple[str, ...]]]:
    """Interprocedural request taint: which parameters of which
    functions carry request-cardinality values. Seeds are the request
    roots' own parameters (minus :data:`_NONREQUEST_PARAMS`); taint
    propagates through a call edge when the argument expression is
    locally tainted AND not bucketed — a pow2-bucket step bounds the
    cardinality and stops the flow. Returns ``(tainted params per fn,
    shortest taint chain per fn)``."""
    graph = program.graph
    tainted: dict[str, set[str]] = {}
    chains: dict[str, tuple[str, ...]] = {}
    for root in request_roots(graph):
        fi = graph.functions[root]
        seeds = set(fi.params) - _NONREQUEST_PARAMS
        if seeds:
            tainted[root] = seeds
            chains[root] = (root,)
    for _ in range(_MAX_PASSES):
        changed = False
        for fq in sorted(tainted):
            fi = graph.functions.get(fq)
            if fi is None or _is_jitted(program, fi):
                continue  # calls inside a jitted body are traced inline
            local, bucketed, _shaped = _local_flow(fi.node, tainted[fq])
            by_pos = _calls_by_pos(fi.node)
            for site in fi.calls:
                call = by_pos.get((site.line, site.col))
                if call is None:
                    continue
                for callee in site.callees:
                    cfi = graph.functions.get(callee)
                    if cfi is None:
                        continue
                    for pname, expr in _map_args_to_params(call, cfi):
                        if _expr_is_bucketed(expr, bucketed):
                            continue
                        if not (_names_in(expr) & local):
                            continue
                        cur = tainted.setdefault(callee, set())
                        if pname not in cur:
                            cur.add(pname)
                            changed = True
                            if callee not in chains:
                                chains[callee] = chains.get(fq, (fq,)) + (
                                    callee,
                                )
        if not changed:
            break
    return tainted, chains


@program_rule(
    "PIO306",
    "unbounded-retrace-risk",
    "a jitted function's static argument is fed from request-derived "
    "values with no pow2-bucket step — compile cardinality tracks "
    "request cardinality",
)
def check_unbounded_retrace(program: ProgramContext) -> Iterator[Finding]:
    graph = program.graph
    jitted = _jitted_defs(program)
    if not jitted:
        return
    tainted, chains = _request_tainted_params(program)
    for fq in sorted(tainted):
        fi = graph.functions.get(fq)
        if fi is None or _is_jitted(program, fi):
            continue  # inside a jitted body everything is traced inline
        ctx = program.contexts.get(fi.rel_path)
        if ctx is None:
            continue
        local, bucketed, shaped = _local_flow(fi.node, tainted[fq])
        by_pos = _calls_by_pos(fi.node)
        for site in fi.calls:
            call = by_pos.get((site.line, site.col))
            if call is None:
                continue
            for callee in site.callees:
                jit_statics = jitted.get(callee)
                if jit_statics is None:
                    continue
                cfi = graph.functions.get(callee)
                if cfi is None:
                    continue
                for pname, expr in _map_args_to_params(call, cfi):
                    if (
                        pname in jit_statics
                        and not _expr_is_bucketed(expr, bucketed)
                        and _names_in(expr) & local
                    ):
                        yield ctx.finding(
                            "PIO306",
                            site.line,
                            f"static arg '{pname}' of jitted "
                            f"{_short(callee)} is fed from "
                            f"request-derived values in {_short(fq)} "
                            "without a pow2-bucket step (statics key the "
                            "jit cache: compile count tracks request "
                            "cardinality — bucket like ops.ivf."
                            "query_topk / serving_util.chunked_topk)",
                            detail="via "
                            + " -> ".join(
                                _short(c) for c in chains.get(fq, (fq,))
                            ),
                        )
                    elif _is_shape_tainted_expr(
                        expr, local, bucketed, shaped
                    ):
                        yield ctx.finding(
                            "PIO306",
                            site.line,
                            f"arg '{pname}' of jitted {_short(callee)} "
                            f"has a request-derived SHAPE in {_short(fq)} "
                            "without a pow2-bucket step (every distinct "
                            "extent is a fresh trace+compile — pad to a "
                            "bucketed width like online.foldin._bucket)",
                            detail="via "
                            + " -> ".join(
                                _short(c) for c in chains.get(fq, (fq,))
                            ),
                        )


# ---------------------------------------------------------------------------
# PIO307 — host transfer on a serving path
# ---------------------------------------------------------------------------


def _torch_transfer(ctx: FileContext, call: ast.Call) -> str | None:
    """The port's host crossing this call makes, rendered, or None."""
    if ctx.dotted_name(call.func) in _TORCH_TRANSFER_CALLS:
        return f"{ctx.dotted_name(call.func)}()"
    if not isinstance(call.func, ast.Attribute):
        return None
    if call.func.attr in _TORCH_TRANSFER_METHODS:
        return f".{call.func.attr}()"
    if call.func.attr == "to":
        targets = [*call.args[:1], *(k.value for k in call.keywords if k.arg == "device")]
        if any(isinstance(t, ast.Constant) and t.value == "cpu" for t in targets):
            return '.to("cpu")'
    return None


def _transfer_allowed(rel_path: str, fi: FunctionInfo) -> bool:
    entry = _TRANSFER_ALLOWED.get(rel_path)
    if entry is None:
        return rel_path in _TRANSFER_ALLOWED  # None value = whole file
    return fi.name in entry or (fi.cls is not None and fi.cls in entry)


@program_rule(
    "PIO307",
    "host-transfer-on-serving-path",
    "a device-facing function reachable from a request/fold entrypoint "
    "transfers device data to host",
)
def check_serving_transfers(program: ProgramContext) -> Iterator[Finding]:
    graph = program.graph
    chains = reachable_from_roots(graph)
    for fq in sorted(chains):
        fi = graph.functions.get(fq)
        if fi is None or not fi.rel_path.startswith(_TRANSFER_SCOPE):
            continue
        if _transfer_allowed(fi.rel_path, fi):
            continue
        ctx = program.contexts.get(fi.rel_path)
        if ctx is None:
            continue
        # a jit-decorated function's own body is PIO301's scope — the
        # transfer there is a trace-time bug, not a per-call one
        if _is_jitted(program, fi):
            continue
        seen: set[int] = set()
        for sub in ast.walk(fi.node):
            if not isinstance(sub, ast.Call):
                continue
            what = None
            dotted = ctx.dotted_name(sub.func)
            if dotted in _TRANSFER_CALLS:
                what = f"{dotted}()"
            elif (
                isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _TRANSFER_METHODS
            ):
                what = f".{sub.func.attr}()"
            elif fi.rel_path.startswith(_PORT):
                what = _torch_transfer(ctx, sub)
            if what is None or sub.lineno in seen:
                continue
            seen.add(sub.lineno)
            yield ctx.finding(
                "PIO307",
                sub.lineno,
                f"{what} in {_short(fq)} transfers device data to host "
                "on a serving path (every call blocks dispatch on the "
                "link; keep the path device-resident or add a justified "
                "allow-list entry in rules_compile)",
                detail="via "
                + " -> ".join(_short(c) for c in chains[fq]),
            )


# ---------------------------------------------------------------------------
# PIO308 — jit constructed per call
# ---------------------------------------------------------------------------

_CACHE_DECORATORS = frozenset({"functools.lru_cache", "functools.cache"})

#: the port's compiled-program constructors (PIO308 under ``_PORT``):
#: each evaluation starts a fresh compile cache (``torch.compile``) or
#: loads and initialises a compiled package (``aoti_load_package``)
_TORCH_COMPILE_NAMES = frozenset({"torch.compile"})
_TORCH_LOAD_NAMES = frozenset({"torch._inductor.aoti_load_package"})


def _is_jit_construction(ctx: FileContext, node: ast.Call) -> bool:
    fn = ctx.dotted_name(node.func)
    if fn in ("jax.jit", "jax.pjit"):
        return True
    if fn in ("functools.partial", "partial") and node.args:
        inner = ctx.dotted_name(node.args[0])
        return inner in ("jax.jit", "jax.pjit")
    return False


def _torch_construction(ctx: FileContext, node: ast.AST) -> str | None:
    """The port's constructor this node evaluates (a call, or a nested
    def's decorator), rendered, or None."""
    if isinstance(node, ast.Call):
        fn = ctx.dotted_name(node.func)
        if fn in ("functools.partial", "partial") and node.args:
            fn = ctx.dotted_name(node.args[0])
        if fn in _TORCH_COMPILE_NAMES:
            return "torch.compile"
        if fn in _TORCH_LOAD_NAMES:
            return fn.rsplit(".", 1)[-1]
        return None
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        for d in node.decorator_list:
            target = d.func if isinstance(d, ast.Call) else d
            if ctx.dotted_name(target) in _TORCH_COMPILE_NAMES:
                return "torch.compile"
    return None


def _memoized_factory(ctx: FileContext, fi: FunctionInfo) -> bool:
    node = fi.node
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return False
    for dec in node.decorator_list:
        d = dec.func if isinstance(dec, ast.Call) else dec
        if ctx.dotted_name(d) in _CACHE_DECORATORS:
            return True
    return False


@program_rule(
    "PIO308",
    "jit-constructed-per-call",
    "jax.jit evaluated inside a function body on a request/fold path — "
    "each evaluation starts with an empty compile cache",
)
def check_jit_per_call(program: ProgramContext) -> Iterator[Finding]:
    graph = program.graph
    chains = reachable_from_roots(graph)
    for fq in sorted(chains):
        fi = graph.functions.get(fq)
        if fi is None or _is_jitted(program, fi):
            continue
        ctx = program.contexts.get(fi.rel_path)
        if ctx is None:
            continue
        if _memoized_factory(ctx, fi):
            continue  # lru_cache factory: one construction per key
        # the function's OWN decorators and argument defaults evaluate
        # at def time in the ENCLOSING scope (module import, class
        # body), not per call — only body constructions count. Nested
        # defs' decorators DO evaluate per call of this function and
        # stay in the walk.
        node = fi.node
        def_time: set[int] = set()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in (
                *node.decorator_list,
                *node.args.defaults,
                *node.args.kw_defaults,
            ):
                if d is None:
                    continue
                for sub in ast.walk(d):
                    def_time.add(id(sub))
        # names whose value lands in a keyed cache slot (`CACHE[k] = fn`)
        # — the sanctioned cached-per-sharding idiom
        slot_stored: set[str] = set()
        for sub in ast.walk(fi.node):
            if isinstance(sub, ast.Assign) and isinstance(
                sub.value, ast.Name
            ):
                if any(
                    isinstance(t, ast.Subscript) for t in sub.targets
                ):
                    slot_stored.add(sub.value.id)

        port = fi.rel_path.startswith(_PORT)

        def constructions(node, parent_assign):
            for child in ast.iter_child_nodes(node):
                if id(child) in def_time:
                    continue
                pa = parent_assign
                if isinstance(child, ast.Assign):
                    pa = child
                if isinstance(child, ast.Call) and _is_jit_construction(
                    ctx, child
                ):
                    yield child, pa, "jax.jit"
                elif isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ) and any(_is_jit_expr(ctx, d) for d in child.decorator_list):
                    # a NESTED jit-decorated def re-evaluates its
                    # decorator on every call of the enclosing function
                    yield child, None, "jax.jit"
                elif port and (what := _torch_construction(ctx, child)):
                    yield child, (pa if isinstance(child, ast.Call) else None), what
                yield from constructions(child, pa)

        for call, assign, what in constructions(fi.node, None):
            sanctioned = False
            if assign is not None and assign.value is call:
                for t in assign.targets:
                    if isinstance(t, ast.Subscript):
                        sanctioned = True  # CACHE[key] = jax.jit(...)
                    elif isinstance(t, ast.Name) and t.id in slot_stored:
                        sanctioned = True  # fn = jax.jit(...); CACHE[k] = fn
            if sanctioned:
                continue
            yield ctx.finding(
                "PIO308",
                call.lineno,
                f"{what} constructed inside {_short(fq)} on a "
                "request/fold path — every call builds a wrapper with an "
                "empty compile cache (trace+compile per call); construct "
                "at module scope, behind functools.lru_cache, or store "
                "into a keyed cache slot (device_state._sharded_set_rows "
                "is the idiom)",
                detail="via "
                + " -> ".join(_short(c) for c in chains[fq]),
            )
