"""PIO3xx — JAX hygiene rules, scoped to the device-facing packages.

Scope: ``predictionio_tpu/ops/`` and ``predictionio_tpu/parallel/``
only — the rest of the tree is host-side and its manifest entries keep
jax out entirely (PIO101/102).

The failure class here is silent performance loss, not crashes: a
``.item()`` or ``np.asarray`` inside a jitted function forces a device
sync (or a trace-time constant-fold) on every call, and a jit closing
over a mutable module global bakes stale state into the compiled
program — the bugs ALX (arxiv 2112.02194) reports dominating TPU
matrix-factorization tuning. DrJAX (arxiv 2403.07128) avoids them by
keeping every primitive traceable end to end; these rules make the same
property checkable here:

* ``PIO301`` host sync inside jit: ``.item()``, ``np.asarray``/
  ``np.array``, ``jax.device_get``, ``.block_until_ready()`` or
  ``float(param)``/``int(param)`` on a traced parameter, inside a
  ``@jax.jit``/``pjit``-decorated function or one of its local helpers.
  Scope additionally covers ``workflow/device_state.py`` and
  ``serving/`` — the jit-adjacent layers beside the kernels.
* ``PIO302`` jit closes over a mutable module global (list/dict/set):
  the traced value is frozen at first compile; later mutation silently
  diverges from the compiled program.
* ``PIO303`` unhashable static arg spec: ``static_argnums``/
  ``static_argnames`` given a list/set/dict literal — jit requires
  hashable statics; pass a tuple.
* ``PIO304`` raw ``shard_map`` outside ``ops/compat.py``: the shim
  there absorbs the API's home moves (``jax.experimental.shard_map`` ->
  ``jax.shard_map``) AND its replication-check rename (``check_rep`` ->
  ``check_vma``), so a direct import/attribute use in a kernel quietly
  re-breaks jax<0.6 hosts the moment it needs either knob.
* ``PIO305`` raw int8 quantization outside ``ops/quant.py``: ONE
  quantization rule lives in ONE module (the same containment contract
  PIO304 enforces for shard_map) — the rounding mode, the zero-row
  guard, and the re-quantize-on-scatter rule must agree everywhere, or
  the fold-in path writes rows the serving kernels decode differently.
  ``.astype(jnp.int8)``, ``dtype=...int8`` and bare ``np.int8``/
  ``jnp.int8`` references anywhere else in the scope are findings.
"""

from __future__ import annotations

import ast
from typing import Iterator

from predictionio_tpu_torch.analysis.engine import FileContext, Finding, rule

_SCOPE_PREFIXES = ("predictionio_tpu/ops/", "predictionio_tpu/parallel/")

#: PIO301 additionally covers the jit-adjacent serving layers: the
#: device_state pin/swap module builds and calls jitted programs behind
#: the lazy-jax boundary, and serving/ helpers sit next to the batcher
#: warm-up — a host sync inside a jitted function there is the same
#: silent dispatch stall it is in ops/ (serving/ is
#: jax-free by manifest, so the scope is future-proofing: the rule
#: fires the day someone adds a jitted helper there)
_PIO301_EXTRA_SCOPE = (
    "predictionio_tpu/workflow/device_state.py",
    "predictionio_tpu/serving/",
)

#: dotted callables that synchronize host and device
_HOST_SYNC_CALLS = frozenset(
    {
        "numpy.asarray",
        "numpy.array",
        "jax.device_get",
    }
)

_JIT_NAMES = frozenset({"jax.jit", "jax.pjit", "pjit", "jit"})


def _in_scope(ctx: FileContext) -> bool:
    return ctx.rel_path.startswith(_SCOPE_PREFIXES)


def _is_jit_expr(ctx: FileContext, node: ast.AST) -> bool:
    """Is this expression jax.jit / pjit (possibly via functools.partial
    or a direct call like ``jax.jit(...)``)?"""
    dotted = ctx.dotted_name(node)
    if dotted in _JIT_NAMES:
        return True
    if isinstance(node, ast.Call):
        fn = ctx.dotted_name(node.func)
        if fn in _JIT_NAMES:
            return True
        if fn in ("functools.partial", "partial") and node.args:
            return _is_jit_expr(ctx, node.args[0])
    return False


def _jitted_functions(ctx: FileContext) -> Iterator[ast.FunctionDef]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(_is_jit_expr(ctx, d) for d in node.decorator_list):
                yield node


def _param_names(fn: ast.FunctionDef) -> set[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


def _static_param_names(ctx: FileContext, fn: ast.FunctionDef) -> set[str]:
    """Parameters declared STATIC by the jit decorator — these are plain
    Python values, never tracers, so host conversions on them are fine
    (``int(k)`` on a ``static_argnames`` arg is the idiom for shape
    math, not a host sync)."""
    a = fn.args
    positional = [p.arg for p in a.posonlyargs + a.args]
    out: set[str] = set()
    for dec in fn.decorator_list:
        if not (isinstance(dec, ast.Call) and _is_jit_expr(ctx, dec)):
            continue
        for kw in dec.keywords:
            if kw.arg == "static_argnames" and isinstance(
                kw.value, (ast.Tuple, ast.List, ast.Set)
            ):
                out.update(
                    e.value
                    for e in kw.value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                )
            elif kw.arg == "static_argnames" and isinstance(
                kw.value, ast.Constant
            ) and isinstance(kw.value.value, str):
                out.add(kw.value.value)
            elif kw.arg == "static_argnums":
                nums = []
                if isinstance(kw.value, (ast.Tuple, ast.List)):
                    nums = [
                        e.value
                        for e in kw.value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, int)
                    ]
                elif isinstance(kw.value, ast.Constant) and isinstance(
                    kw.value.value, int
                ):
                    nums = [kw.value.value]
                out.update(
                    positional[n] for n in nums if 0 <= n < len(positional)
                )
    return out


@rule(
    "PIO301",
    "host-sync-in-jit",
    "host-synchronizing call inside a jit-decorated function",
)
def check_host_sync(ctx: FileContext) -> Iterator[Finding]:
    if not _in_scope(ctx) and not ctx.rel_path.startswith(
        _PIO301_EXTRA_SCOPE
    ):
        return
    for fn in _jitted_functions(ctx):
        params = _param_names(fn) - _static_param_names(ctx, fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            # numpy/device_get style calls
            dotted = ctx.dotted_name(node.func)
            if dotted in _HOST_SYNC_CALLS:
                yield ctx.finding(
                    "PIO301",
                    node,
                    f"{dotted}() inside jitted '{fn.name}' forces a "
                    "host sync / trace-time constant; use jnp instead",
                )
                continue
            # .item() / .block_until_ready() method calls
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "item",
                "block_until_ready",
            ):
                yield ctx.finding(
                    "PIO301",
                    node,
                    f".{node.func.attr}() inside jitted '{fn.name}' "
                    "blocks dispatch on a device round trip",
                )
                continue
            # float(x)/int(x)/bool(x) on a traced parameter
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in ("float", "int", "bool")
                and len(node.args) == 1
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id in params
            ):
                yield ctx.finding(
                    "PIO301",
                    node,
                    f"{node.func.id}({node.args[0].id}) on a parameter of "
                    f"jitted '{fn.name}' forces a concrete value "
                    "(TracerConversion / silent recompile)",
                )


def _mutable_module_globals(tree: ast.Module) -> dict[str, int]:
    """Module-level names bound to mutable literals (list/dict/set or
    their constructor calls) -> first assignment line."""
    out: dict[str, int] = {}
    for stmt in tree.body:
        targets: list[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
            value = stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
            value = stmt.value
        else:
            continue
        mutable = isinstance(value, (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)) or (
            isinstance(value, ast.Call)
            and isinstance(value.func, ast.Name)
            and value.func.id in ("list", "dict", "set", "bytearray", "defaultdict", "Counter", "deque")
        )
        if not mutable:
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                out.setdefault(t.id, stmt.lineno)
    return out


@rule(
    "PIO302",
    "jit-mutable-global",
    "jit-decorated function reads a mutable module global",
)
def check_mutable_closure(ctx: FileContext) -> Iterator[Finding]:
    if not _in_scope(ctx):
        return
    mutables = _mutable_module_globals(ctx.tree)
    if not mutables:
        return
    for fn in _jitted_functions(ctx):
        local = _param_names(fn)
        # names assigned anywhere in the function shadow the global
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                local.add(node.id)
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Name)
                and isinstance(node.ctx, ast.Load)
                and node.id in mutables
                and node.id not in local
            ):
                yield ctx.finding(
                    "PIO302",
                    node,
                    f"jitted '{fn.name}' closes over mutable module "
                    f"global '{node.id}': its value is frozen at trace "
                    "time and later mutation silently diverges",
                )
                break  # one report per function is enough to act on


@rule(
    "PIO303",
    "unhashable-static-args",
    "static_argnums/static_argnames given an unhashable literal",
)
def check_static_args(ctx: FileContext) -> Iterator[Finding]:
    if not _in_scope(ctx):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = ctx.dotted_name(node.func)
        is_jitcall = fn in _JIT_NAMES or (
            fn in ("functools.partial", "partial")
            and node.args
            and _is_jit_expr(ctx, node.args[0])
        )
        if not is_jitcall:
            continue
        for kw in node.keywords:
            if kw.arg in ("static_argnums", "static_argnames") and isinstance(
                kw.value, (ast.List, ast.Set, ast.Dict)
            ):
                yield ctx.finding(
                    "PIO303",
                    kw.value,
                    f"{kw.arg} must be hashable — use a tuple, not a "
                    f"{type(kw.value).__name__.lower()} literal "
                    "(jit raises at call time, or retraces per call)",
                )


#: the one module allowed to touch jax's shard_map API directly — the
#: version shim every sharded kernel must import from
_SHARD_MAP_SHIM = "predictionio_tpu/ops/compat.py"

_SHARD_MAP_ATTRS = frozenset(
    {"jax.shard_map", "jax.experimental.shard_map.shard_map"}
)


@rule(
    "PIO304",
    "raw-shard-map",
    "shard_map imported/used directly instead of the ops.compat shim",
)
def check_raw_shard_map(ctx: FileContext) -> Iterator[Finding]:
    if not _in_scope(ctx):
        return
    if ctx.rel_path.replace("\\", "/") == _SHARD_MAP_SHIM:
        return
    seen: set[int] = set()
    for node in ast.walk(ctx.tree):
        hit = None
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == "jax.experimental.shard_map" or (
                mod in ("jax", "jax.experimental")
                and any(a.name == "shard_map" for a in node.names)
            ):
                hit = f"from {mod} import shard_map"
        elif isinstance(node, ast.Import):
            if any(a.name == "jax.experimental.shard_map" for a in node.names):
                hit = "import jax.experimental.shard_map"
        elif isinstance(node, ast.Attribute):
            if ctx.dotted_name(node) in _SHARD_MAP_ATTRS:
                hit = ctx.dotted_name(node)
        if hit is not None and node.lineno not in seen:
            seen.add(node.lineno)
            yield ctx.finding(
                "PIO304",
                node,
                f"{hit}: sharded kernels must go through "
                "predictionio_tpu.ops.compat.shard_map — the shim keeps "
                "jax<0.6 hosts working (import home + check_rep/"
                "check_vma rename both live there)",
            )


#: the one module allowed to construct int8 quantized state — the
#: single rounding rule every code/scale pair in the repo shares
_QUANT_MODULE = "predictionio_tpu/ops/quant.py"

_INT8_DTYPE_ATTRS = frozenset({"numpy.int8", "jax.numpy.int8", "jax.int8"})


def _is_int8_expr(ctx: FileContext, node: ast.AST) -> bool:
    """Does this expression name the int8 dtype — ``jnp.int8``/
    ``np.int8`` (any alias) or the ``"int8"`` string literal?"""
    if isinstance(node, ast.Constant) and node.value == "int8":
        return True
    dotted = ctx.dotted_name(node)
    return dotted in _INT8_DTYPE_ATTRS


@rule(
    "PIO305",
    "raw-int8-quantization",
    "int8 quantization constructed outside ops/quant.py",
)
def check_raw_int8(ctx: FileContext) -> Iterator[Finding]:
    if not _in_scope(ctx) and not ctx.rel_path.startswith(
        "predictionio_tpu/workflow/"
    ):
        return
    if ctx.rel_path.replace("\\", "/") == _QUANT_MODULE:
        return
    msg = (
        "{what}: int8 quantized state must be constructed through "
        "predictionio_tpu.ops.quant (one rounding rule, one zero-row "
        "guard, one re-quantize-on-scatter contract — the fold-in and "
        "serving kernels must agree on all three)"
    )
    seen: set[int] = set()
    for node in ast.walk(ctx.tree):
        hit = None
        if isinstance(node, ast.Call):
            # x.astype(int8) / x.astype("int8") / x.view(...)-style casts
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "astype"
                and node.args
                and _is_int8_expr(ctx, node.args[0])
            ):
                hit = ".astype(int8)"
            else:
                # dtype=int8 keyword on any constructor (zeros, asarray,
                # empty, full, np.dtype, device_put-adjacent helpers)
                for kw in node.keywords:
                    if kw.arg == "dtype" and _is_int8_expr(ctx, kw.value):
                        hit = "dtype=int8"
                        break
        elif isinstance(node, ast.Attribute):
            if ctx.dotted_name(node) in _INT8_DTYPE_ATTRS:
                hit = ctx.dotted_name(node)
        if hit is not None and node.lineno not in seen:
            seen.add(node.lineno)
            yield ctx.finding("PIO305", node, msg.format(what=hit))
