"""piolint and the runtime witnesses, for the port.

The port's copy of ``predictionio_tpu/analysis``: the same stdlib-only
AST analyzer (it lints the whole repository, both packages, with the
reference's rules and findings), plus the port's counterparts — the
manifest's contracts for ``predictionio_tpu_torch/`` and torch's host
crossings and compiled-program constructors in ``PIO307``/``PIO308``
(:mod:`~predictionio_tpu_torch.analysis.rules_compile`).

Rule families (docs/development.md):

* ``PIO1xx`` layering — declarative import manifest (:mod:`manifest`)
* ``PIO2xx`` concurrency — lock scope, blocking-under-lock, lock order
  (whole-program: ``PIO206``–``PIO211`` over the cross-module callgraph)
* ``PIO3xx`` compile hygiene — host syncs inside jit, mutable jit
  closures, retraces, host transfers and per-call compiles on serving
  paths
* ``PIO4xx`` server hygiene — untimed sockets, bare excepts in handlers
* ``PIO5xx`` crash consistency — the write→flush→fsync→rename protocol
  on every durable root (:mod:`rules_durability`)

The runtime half records what the port really does while a command
runs: :mod:`witness` and :mod:`lock_witness` (``pio tsan``, ``pio lint
--witness``: lock order, fsync and rename), and :mod:`jit_witness`
(``pio jitwitness``: compiles, device-to-host copies and compiled-program
constructions per call site, against ``compile-budget-torch.json``).

Importing this package imports neither torch nor jax: the analyzer
parses source text and never imports what it lints, and the witnesses
import torch only when installed.
"""

from __future__ import annotations

from predictionio_tpu_torch.analysis.engine import (
    Finding,
    LintResult,
    all_rules,
    lint_file,
    lint_sources,
    lint_tree,
    run_lint,
)
from predictionio_tpu_torch.analysis.manifest import DEFAULT_MANIFEST, PackageRule

# importing the rule modules registers their rules with the engine
from predictionio_tpu_torch.analysis import rules_layering  # noqa: F401  (registry)
from predictionio_tpu_torch.analysis import rules_concurrency  # noqa: F401
from predictionio_tpu_torch.analysis import rules_jax  # noqa: F401
from predictionio_tpu_torch.analysis import rules_server  # noqa: F401
from predictionio_tpu_torch.analysis import rules_program  # noqa: F401  (PIO206+)
from predictionio_tpu_torch.analysis import rules_compile  # noqa: F401  (PIO306+)
from predictionio_tpu_torch.analysis import rules_durability  # noqa: F401  (PIO501+)

__all__ = [
    "DEFAULT_MANIFEST",
    "Finding",
    "LintResult",
    "PackageRule",
    "all_rules",
    "lint_file",
    "lint_sources",
    "lint_tree",
    "run_lint",
]
