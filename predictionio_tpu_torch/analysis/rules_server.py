"""PIO4xx — server hygiene rules.

A server that must hold p99 under load cannot afford a single untimed
socket: one hung dependency pins a handler thread forever, and the
convoy takes the listener down long before any error is logged. The
resilience layer (docs/operations.md) exists to bound exactly this, so
these rules police the rest of the tree:

* ``PIO401`` untimed network call: ``urllib.request.urlopen``,
  ``socket.create_connection`` or an ``http.client`` connection without
  an explicit ``timeout=`` — outside ``resilience/`` (whose wrappers are
  the sanctioned place for timeout policy).
* ``PIO402`` bare ``except:`` in server-side code: swallows
  ``KeyboardInterrupt``/``SystemExit`` and turns shutdown into a hang;
  HTTP handlers must catch ``Exception`` at the broadest.
* ``PIO403`` fsync-less atomic replace in ``data/storage/``: a function
  that opens a file for writing and then ``os.replace``\\ s it without
  any ``os.fsync`` publishes a rename whose *data* may still be in the
  page cache — after a crash the file exists but is empty or torn.
  Classes exposing an fsync toggle (an ``fsync`` constructor parameter
  or a ``self._fsync`` attribute) are exempt: the operator chose.
"""

from __future__ import annotations

import ast
from typing import Iterator

from predictionio_tpu_torch.analysis.engine import FileContext, Finding, rule

#: network entry points that accept a timeout= keyword
_TIMED_CALLS = frozenset(
    {
        "urllib.request.urlopen",
        "socket.create_connection",
        "http.client.HTTPConnection",
        "http.client.HTTPSConnection",
    }
)

_EXEMPT_PREFIXES = ("predictionio_tpu/resilience/", "predictionio_tpu/analysis/")


@rule(
    "PIO401",
    "untimed-network-call",
    "socket/urlopen call without an explicit timeout= keyword",
)
def check_untimed_sockets(ctx: FileContext) -> Iterator[Finding]:
    if ctx.rel_path.startswith(_EXEMPT_PREFIXES):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = ctx.dotted_name(node.func)
        if dotted not in _TIMED_CALLS:
            continue
        if not any(k.arg == "timeout" for k in node.keywords):
            yield ctx.finding(
                "PIO401",
                node,
                f"{dotted}() without timeout= — a hung peer pins this "
                "thread forever (resilience/ wrappers are the sanctioned "
                "timeout policy layer)",
            )


@rule(
    "PIO402",
    "bare-except",
    "bare `except:` in server-side code",
)
def check_bare_except(ctx: FileContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            yield ctx.finding(
                "PIO402",
                node,
                "bare `except:` swallows KeyboardInterrupt/SystemExit; "
                "catch Exception at the broadest",
            )


_STORAGE_PREFIX = "predictionio_tpu/data/storage/"


def _opens_for_write(ctx: FileContext, node: ast.Call) -> bool:
    if ctx.dotted_name(node.func) != "open":
        return False
    mode = None
    if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
        mode = node.args[1].value
    for kw in node.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    return isinstance(mode, str) and any(c in mode for c in "wax+")


def _class_has_fsync_toggle(cls: ast.ClassDef) -> bool:
    """An ``fsync`` constructor parameter or any ``self.*fsync*``
    attribute use marks the class as fsync-aware: its write path is a
    deliberate operator choice, not an oversight."""
    for node in ast.walk(cls):
        if isinstance(node, ast.Attribute) and "fsync" in node.attr.lower():
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return True
        if isinstance(node, ast.FunctionDef) and node.name == "__init__":
            args = node.args
            for a in (*args.posonlyargs, *args.args, *args.kwonlyargs):
                if "fsync" in a.arg.lower():
                    return True
    return False


@rule(
    "PIO403",
    "fsyncless-replace",
    "storage write published via os.replace without any os.fsync",
)
def check_fsyncless_replace(ctx: FileContext) -> Iterator[Finding]:
    if not ctx.rel_path.startswith(_STORAGE_PREFIX):
        return
    exempt: set[ast.FunctionDef] = set()
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        if not _class_has_fsync_toggle(cls):
            continue
        for fn in ast.walk(cls):
            if isinstance(fn, ast.FunctionDef):
                exempt.add(fn)
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, ast.FunctionDef) or fn in exempt:
            continue
        writes = False
        fsyncs = False
        replace_node: ast.Call | None = None
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            dotted = ctx.dotted_name(node.func)
            if dotted == "os.replace":
                replace_node = replace_node or node
            elif dotted == "os.fsync":
                fsyncs = True
            elif _opens_for_write(ctx, node):
                writes = True
        if writes and replace_node is not None and not fsyncs:
            yield ctx.finding(
                "PIO403",
                replace_node,
                "os.replace publishes a write that was never fsync'd — "
                "after a crash the renamed file can be empty or torn; "
                "fsync the data (and the directory entry) or expose an "
                "fsync toggle on the class",
            )
