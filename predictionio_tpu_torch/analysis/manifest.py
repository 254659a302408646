"""Declarative layering manifest — which package may import what.

The port's copy of ``predictionio_tpu/analysis/manifest.py``: the
reference's contracts stand as they are (so the port's linter gives the
reference's findings on the JAX package), and :data:`PORT_MANIFEST`
adds their counterparts for ``predictionio_tpu_torch/``, with ``torch``
where the reference forbids ``jax`` in a host-side package, plus the
port's own contract that nothing under it imports ``jax`` or the JAX
package. :data:`DEFAULT_MANIFEST` is both.

This replaces the hand-rolled import scans that used to live in
``tests/test_ci_guards.py`` (one bespoke ast walk per invariant) with
one table the ``PIO1xx`` rules read. The guards now assert two things:
the manifest still DECLARES each contract (so a contract cannot be
silently dropped) and the tree SATISFIES it (via the linter).

Contract kinds:

* ``forbid`` — absolute module prefixes the package must never import,
  at top level or function-locally (``jax`` in host-side packages, upper
  layers from lower ones);
* ``stdlib_only`` — only stdlib + ``allow``-listed prefixes may be
  imported (the resilience layer, and this analysis package itself: the
  linter must never import what it lints);
* ``sibling_isolation`` — direct subpackages must not import each other
  (engine templates stay copy-out-able); shared helper MODULES directly
  under the package (``templates/serving_util.py``) are fine.

Matching is by repo-relative path prefix; the most specific (longest)
``package`` entry wins for ``forbid``/``stdlib_only`` so a subpackage
can tighten its parent's contract.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

__all__ = [
    "DEFAULT_MANIFEST",
    "Manifest",
    "PORT_MANIFEST",
    "PackageRule",
    "REFERENCE_MANIFEST",
    "rules_for",
]


@dataclasses.dataclass(frozen=True)
class PackageRule:
    #: repo-relative posix directory prefix, e.g. "predictionio_tpu/serving"
    package: str
    #: absolute dotted module prefixes this package must never import
    forbid: tuple[str, ...] = ()
    #: only stdlib + ``allow`` prefixes may be imported
    stdlib_only: bool = False
    #: dotted prefixes exempt from ``stdlib_only``, or — under
    #: ``sibling_isolation`` — the shared helper modules directly under
    #: the package that siblings MAY import
    allow: tuple[str, ...] = ()
    #: direct subpackages must not import one another
    sibling_isolation: bool = False
    #: one-line rationale, surfaced in diagnostics
    reason: str = ""


Manifest = tuple[PackageRule, ...]


REFERENCE_MANIFEST: Manifest = (
    PackageRule(
        package="predictionio_tpu/serving",
        forbid=(
            "jax",
            "numpy",
            "predictionio_tpu.workflow",
            "predictionio_tpu.controller",
            "predictionio_tpu.ops",
        ),
        reason="the micro-batcher is host-side orchestration; device work "
        "stays behind QueryService.handle_batch and the workflow layer "
        "imports serving, never the reverse",
    ),
    PackageRule(
        package="predictionio_tpu/resilience",
        stdlib_only=True,
        allow=("predictionio_tpu.resilience",),
        reason="failure policy must wrap any transport (including the "
        "storage registry, which imports it) without cycles or "
        "accelerator coupling",
    ),
    PackageRule(
        package="predictionio_tpu/analysis",
        stdlib_only=True,
        allow=("predictionio_tpu.analysis", "predictionio_tpu.version"),
        reason="the linter parses source text and must never import what "
        "it lints — AST only keeps full-tree CI lint under 10 s with no "
        "jax initialization (version.py is a bare constant, stamped "
        "into the SARIF tool descriptor)",
    ),
    PackageRule(
        package="predictionio_tpu/analysis/jit_witness.py",
        stdlib_only=True,
        allow=("jax", "numpy", "predictionio_tpu.analysis"),
        reason="the runtime jit-witness must hook jax.monitoring and the "
        "numpy conversion boundary — jax/numpy are imported lazily at "
        "install() time only, so the analysis package stays importable "
        "with neither present (the stdlib-only subprocess probe covers "
        "it)",
    ),
    PackageRule(
        package="predictionio_tpu/workflow/aot.py",
        stdlib_only=True,
        allow=(
            "jax",
            "jaxlib",
            "numpy",
            "predictionio_tpu.workflow",
            "predictionio_tpu.analysis",
            "predictionio_tpu.fleet",
        ),
        reason="the AOT artifact schema (manifest.json, sha256 + shape "
        "fingerprints) is owned by the stdlib-only fleet registry so the "
        "router and `pio status` can verify readiness with nothing "
        "installed; this module adds only the jax halves (export + "
        "deserialize), importing jax/jaxlib/numpy lazily inside those "
        "functions — importing the module (or running the default, "
        "AOT-off deploy) never touches them",
    ),
    PackageRule(
        package="predictionio_tpu/fleet",
        stdlib_only=True,
        allow=(
            "predictionio_tpu.fleet",
            "predictionio_tpu.resilience",
            "predictionio_tpu.serving.cache",
            "predictionio_tpu.api.http",
            "predictionio_tpu.api.lifecycle",
            "predictionio_tpu.experiments.split",
        ),
        reason="the replica fleet (router, supervisor, registry) is host "
        "orchestration over HTTP: replicas are opaque processes behind "
        "URLs, so the layer must run with no jax/numpy/storage/workflow "
        "imports — only the equally stdlib-only resilience primitives, "
        "the HTTP transport, and serving.cache's key helpers",
    ),
    PackageRule(
        package="predictionio_tpu/api/lifecycle.py",
        stdlib_only=True,
        reason="graceful drain/shutdown must work on every server with no "
        "storage, numpy, or accelerator imports — flush hooks are "
        "injected by the caller, never imported",
    ),
    PackageRule(
        package="predictionio_tpu/data",
        forbid=(
            "predictionio_tpu.workflow",
            "predictionio_tpu.tools",
            "predictionio_tpu.templates",
            "predictionio_tpu.serving",
        ),
        reason="data/storage is the bottom layer: workflow and tools sit "
        "on top of it",
    ),
    PackageRule(
        package="predictionio_tpu/online",
        forbid=(
            "predictionio_tpu.templates",
            "predictionio_tpu.tools",
            "predictionio_tpu.api",
        ),
        reason="online fold-in sits on ops+data+workflow(+serving) and "
        "reaches algorithms only through duck-typed hooks — importing a "
        "template would couple the subsystem to one engine (templates "
        "import online.types, never the reverse); its background threads "
        "must declare daemon= explicitly (PIO204 covers the whole tree)",
    ),
    PackageRule(
        package="predictionio_tpu/parallel",
        forbid=(
            "predictionio_tpu.templates",
            "predictionio_tpu.tools",
            "predictionio_tpu.serving",
            "predictionio_tpu.api",
        ),
        reason="the distribution layer (meshes, collectives, sharded "
        "serving kernels) sits beside ops/ at the device level: jax is "
        "its whole point, but engine templates, CLI tools, and the "
        "jax-free serving/api packages all sit ABOVE it and import it "
        "lazily — never the reverse",
    ),
    PackageRule(
        package="predictionio_tpu/experiments",
        forbid=(
            "predictionio_tpu.templates",
            "predictionio_tpu.tools",
            "predictionio_tpu.api",
        ),
        reason="experimentation (exploration policies, vmapped sweeps) "
        "sits on ops+controller+workflow+data and reaches engines only "
        "through duck-typed folds/payloads — importing a template would "
        "couple the subsystem to one engine, and the CLI imports "
        "experiments lazily, never the reverse",
    ),
    PackageRule(
        package="predictionio_tpu/experiments/split.py",
        stdlib_only=True,
        reason="A/B traffic splitting runs inside the stdlib-only fleet "
        "router: assignment is pure hash arithmetic and must import "
        "nothing — not even the rest of the experiments package",
    ),
    PackageRule(
        package="predictionio_tpu/templates",
        sibling_isolation=True,
        allow=("serving_util", "columnar_util", "results"),
        reason="a template must stay copy-out-able as a standalone engine "
        "(`pio template get`); shared code belongs in a helper module "
        "directly under templates/",
    ),
)


#: the port's contracts. Path prefixes end at a directory or file name
#: (``rules_for`` appends ``/``), so an entry for ``predictionio_tpu/x``
#: above never reaches ``predictionio_tpu_torch/x``; dotted module
#: prefixes match whole components (``predictionio_tpu`` forbids
#: ``predictionio_tpu.ops`` and not ``predictionio_tpu_torch.ops``).
PORT_MANIFEST: Manifest = (
    PackageRule(
        package="predictionio_tpu_torch",
        forbid=("jax", "jaxlib", "predictionio_tpu"),
        reason="the port stands alone on torch: it imports neither jax "
        "nor the JAX package, and keeps its own copy of what it needs "
        "from it (only the tests import both)",
    ),
    PackageRule(
        package="predictionio_tpu_torch/serving",
        forbid=(
            "torch",
            "numpy",
            "predictionio_tpu_torch.workflow",
            "predictionio_tpu_torch.controller",
            "predictionio_tpu_torch.ops",
        ),
        reason="the micro-batcher is host-side orchestration; device work "
        "stays behind QueryService.handle_batch and the workflow layer "
        "imports serving, never the reverse",
    ),
    PackageRule(
        package="predictionio_tpu_torch/resilience",
        stdlib_only=True,
        allow=("predictionio_tpu_torch.resilience",),
        reason="failure policy must wrap any transport (including the "
        "storage registry, which imports it) without cycles or "
        "accelerator coupling",
    ),
    PackageRule(
        package="predictionio_tpu_torch/analysis",
        stdlib_only=True,
        allow=("predictionio_tpu_torch.analysis", "predictionio_tpu_torch.version"),
        reason="the linter parses source text and must never import what "
        "it lints — importing the analysis package loads neither torch "
        "nor jax (version.py is a bare constant, stamped into the SARIF "
        "tool descriptor)",
    ),
    PackageRule(
        package="predictionio_tpu_torch/analysis/jit_witness.py",
        stdlib_only=True,
        allow=("torch", "predictionio_tpu_torch.analysis"),
        reason="the runtime jit-witness wraps torch's compile entry points "
        "and the tensor methods that cross to the host — torch is "
        "imported at install() time only, so the analysis package stays "
        "importable without it",
    ),
    PackageRule(
        package="predictionio_tpu_torch/workflow/aot.py",
        stdlib_only=True,
        allow=(
            "torch",
            "numpy",
            "predictionio_tpu_torch.workflow",
            "predictionio_tpu_torch.analysis",
            "predictionio_tpu_torch.fleet",
        ),
        reason="the AOT artifact schema (manifest.json, sha256 + shape "
        "fingerprints) is owned by the stdlib-only fleet registry so the "
        "router and `pio status` can verify readiness with nothing "
        "installed; this module adds only the torch halves (export + "
        "load), importing torch inside those functions",
    ),
    PackageRule(
        package="predictionio_tpu_torch/fleet",
        stdlib_only=True,
        allow=(
            "predictionio_tpu_torch.fleet",
            "predictionio_tpu_torch.resilience",
            "predictionio_tpu_torch.serving.cache",
            "predictionio_tpu_torch.api.http",
            "predictionio_tpu_torch.api.lifecycle",
            "predictionio_tpu_torch.experiments.split",
        ),
        reason="the replica fleet (router, supervisor, registry) is host "
        "orchestration over HTTP: replicas are opaque processes behind "
        "URLs, so the layer runs with no torch/numpy/storage/workflow "
        "imports",
    ),
    PackageRule(
        package="predictionio_tpu_torch/api",
        forbid=("torch",),
        reason="the HTTP layer and the event server run on hosts without "
        "a card: `pio eventserver` imports no torch",
    ),
    PackageRule(
        package="predictionio_tpu_torch/api/lifecycle.py",
        stdlib_only=True,
        reason="graceful drain/shutdown must work on every server with no "
        "storage, numpy, or accelerator imports — flush hooks are "
        "injected by the caller, never imported",
    ),
    PackageRule(
        package="predictionio_tpu_torch/data",
        forbid=(
            "torch",
            "predictionio_tpu_torch.workflow",
            "predictionio_tpu_torch.tools",
            "predictionio_tpu_torch.templates",
            "predictionio_tpu_torch.serving",
        ),
        reason="data/storage is the bottom layer and host-side (the event "
        "server and the storage server import it without torch): "
        "workflow and tools sit on top of it",
    ),
    PackageRule(
        package="predictionio_tpu_torch/e2",
        forbid=("torch",),
        reason="the e2 helpers are host-side numpy, as in the reference",
    ),
    PackageRule(
        package="predictionio_tpu_torch/online",
        forbid=(
            "predictionio_tpu_torch.templates",
            "predictionio_tpu_torch.tools",
            "predictionio_tpu_torch.api",
        ),
        reason="online fold-in sits on ops+data+workflow(+serving) and "
        "reaches algorithms only through duck-typed hooks",
    ),
    PackageRule(
        package="predictionio_tpu_torch/parallel",
        forbid=(
            "predictionio_tpu_torch.templates",
            "predictionio_tpu_torch.tools",
            "predictionio_tpu_torch.serving",
            "predictionio_tpu_torch.api",
        ),
        reason="the distribution layer (meshes, collectives, sharded "
        "serving kernels) sits beside ops/ at the device level; "
        "templates, tools and the torch-free serving/api packages sit "
        "above it",
    ),
    PackageRule(
        package="predictionio_tpu_torch/experiments",
        forbid=(
            "predictionio_tpu_torch.templates",
            "predictionio_tpu_torch.tools",
            "predictionio_tpu_torch.api",
        ),
        reason="experimentation sits on ops+controller+workflow+data and "
        "reaches engines only through duck-typed folds/payloads",
    ),
    PackageRule(
        package="predictionio_tpu_torch/experiments/split.py",
        stdlib_only=True,
        reason="A/B traffic splitting runs inside the stdlib-only fleet "
        "router: assignment is pure hash arithmetic",
    ),
    PackageRule(
        package="predictionio_tpu_torch/templates",
        sibling_isolation=True,
        allow=("serving_util", "columnar_util", "results", "als_util", "classifier_util"),
        reason="a template must stay copy-out-able as a standalone engine "
        "(`pio template get`); shared code belongs in a helper module "
        "directly under templates/ (the port's two ALS templates share "
        "als_util, its two classifiers classifier_util)",
    ),
)

DEFAULT_MANIFEST: Manifest = REFERENCE_MANIFEST + PORT_MANIFEST


def rules_for(rel_path: str, manifest: Manifest) -> list[PackageRule]:
    """Manifest entries whose package prefix contains ``rel_path``,
    most specific first. A ``package`` may also name a single FILE
    (``predictionio_tpu/api/lifecycle.py``) to pin one module's contract
    without constraining its siblings."""
    rel = rel_path.replace("\\", "/")
    hits = [
        r for r in manifest if rel == r.package or rel.startswith(r.package + "/")
    ]
    hits.sort(key=lambda r: len(r.package), reverse=True)
    return hits


def find_rule(manifest: Manifest, package: str) -> PackageRule | None:
    for r in manifest:
        if r.package == package:
            return r
    return None


def is_stdlib(module: str, extra_allowed: Iterable[str] = ()) -> bool:
    import sys

    top = module.split(".")[0]
    if top in sys.stdlib_module_names:
        return True
    return any(
        module == p or module.startswith(p + ".") for p in extra_allowed
    )
