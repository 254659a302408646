"""PIO1xx — layering rules driven by the declarative manifest.

* ``PIO101`` forbidden import: the file's package forbids this module
  prefix (jax in host-side packages, upper layers from lower ones).
* ``PIO102`` stdlib-only package imports a third-party / framework
  module.
* ``PIO103`` template sibling import: an engine template imports
  another template's package.

All three look at every import in the file — top-level AND
function-local (``ast.walk``) — exactly like the CI guards they
replaced.
"""

from __future__ import annotations

from typing import Iterator

from predictionio_tpu_torch.analysis.engine import FileContext, Finding, rule
from predictionio_tpu_torch.analysis.manifest import is_stdlib, rules_for


def _matches(module: str, prefix: str) -> bool:
    return module == prefix or module.startswith(prefix + ".")


@rule(
    "PIO101",
    "forbidden-import",
    "package imports a module its manifest entry forbids",
)
def check_forbidden_import(ctx: FileContext) -> Iterator[Finding]:
    pkg_rules = rules_for(ctx.rel_path, ctx.manifest)
    if not pkg_rules:
        return
    for node, module in ctx.iter_imports():
        if not module:
            continue
        for pr in pkg_rules:
            bad = next((p for p in pr.forbid if _matches(module, p)), None)
            if bad is not None:
                yield ctx.finding(
                    "PIO101",
                    node,
                    f"import of '{module}' is forbidden in {pr.package}/ "
                    f"({pr.reason})",
                )
                break


@rule(
    "PIO102",
    "non-stdlib-import",
    "stdlib-only package imports outside the standard library",
)
def check_stdlib_only(ctx: FileContext) -> Iterator[Finding]:
    pkg_rules = [r for r in rules_for(ctx.rel_path, ctx.manifest) if r.stdlib_only]
    if not pkg_rules:
        return
    pr = pkg_rules[0]  # most specific stdlib_only entry
    for node, module in ctx.iter_imports():
        if not module:
            continue
        if not is_stdlib(module, pr.allow):
            yield ctx.finding(
                "PIO102",
                node,
                f"non-stdlib import '{module}' in stdlib-only package "
                f"{pr.package}/ ({pr.reason})",
            )


@rule(
    "PIO103",
    "template-sibling-import",
    "engine template imports another template's package",
)
def check_sibling_isolation(ctx: FileContext) -> Iterator[Finding]:
    for pr in ctx.manifest:
        if not pr.sibling_isolation:
            continue
        prefix = pr.package + "/"
        if not ctx.rel_path.startswith(prefix):
            continue
        inside = ctx.rel_path[len(prefix):]
        if "/" not in inside:
            continue  # a shared helper module directly under the package
        own = inside.split("/")[0]
        pkg_dotted = pr.package.replace("/", ".")
        for node, module in ctx.iter_imports():
            if not module or not _matches(module, pkg_dotted):
                continue
            tail = module[len(pkg_dotted):].lstrip(".")
            if not tail:
                continue
            sibling = tail.split(".")[0]
            # the manifest's allow list names the shared helper modules
            # directly under the package; anything else under a different
            # first component is another template
            if sibling == own or sibling in pr.allow:
                continue
            yield ctx.finding(
                "PIO103",
                node,
                f"template '{own}' imports sibling template module "
                f"'{module}' ({pr.reason})",
            )
