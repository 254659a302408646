"""Workflow context — what the runtime hands every DASE component.

Counterpart of ``predictionio_tpu/controller/context.py``. Everywhere the
reference threads a ``SparkContext`` through the DASE stack
(``readTraining(sc)``, ``trainBase(sc, pd)``), this framework threads a
:class:`WorkflowContext`. The JAX package's context carries the device
mesh a job runs under; the port's carries the one ``torch.device`` it
runs on. Components that don't care about devices simply ignore it.

The mesh (``mesh_context``, sharded training across cards) waits for the
port's distributed path; here a job runs on one device and one host.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from predictionio_tpu_torch.device import resolve_device

__all__ = ["WorkflowContext", "local_context"]


@dataclasses.dataclass(frozen=True)
class WorkflowContext:
    """Everything a DASE component may need from the runtime.

    Attributes:
      device: the ``torch.device`` training and serving run on, always
        resolved (:func:`~predictionio_tpu_torch.device.resolve_device`):
        the card by default, raising where there is none; the CPU only
        when asked for.
      host_index / num_hosts: this process's slot in a multi-host job;
        always 0 / 1 in the port so far.
      batch: free-form run label (parity: ``WorkflowParams.batch``).
      verbose: verbosity level (parity: ``WorkflowParams.verbose``).
      warm_model: the previous trained model of THIS algorithm for a warm
        retrain (``pio train --warm-start``), else ``None``.
    """

    device: torch.device = dataclasses.field(default_factory=resolve_device)
    host_index: int = 0
    num_hosts: int = 1
    batch: str = ""
    verbose: int = 0
    warm_model: Any = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "device", resolve_device(self.device))


def local_context(
    device: str | torch.device | None = None, batch: str = "", verbose: int = 0
) -> WorkflowContext:
    """A one-device context: ``device=None`` resolves to the card and
    raises where there is none; ``device="cpu"`` runs on the CPU."""
    return WorkflowContext(device=device, batch=batch, verbose=verbose)
