"""Workflow context — what the runtime hands every DASE component.

Counterpart of ``predictionio_tpu/controller/context.py``. Everywhere the
reference threads a ``SparkContext`` through the DASE stack
(``readTraining(sc)``, ``trainBase(sc, pd)``), this framework threads a
:class:`WorkflowContext`: the ``torch.device`` the job runs on, the
training mesh when there is one (:func:`mesh_context`), and this
process's slot in a multi-process job. Components that don't care about
devices simply ignore it.

The mesh (:class:`TrainingMesh`) is the local devices of one process,
arranged as ``(data, model)`` positions, the port's counterpart of the
JAX package's ``jax.sharding.Mesh``:

* one process is one host and owns its positions: the visible cards (or
  the CPU when asked for), or a ``parallel.sharding.local_devices(...)``
  block, as over one repeated device in the tests;
* the axis sizes given to :func:`mesh_context` are ONE process's; the
  data axis spans the processes in process-contiguous blocks, so the
  job's data axis is ``processes × data`` (``TrainingMesh.shape``);
* the model axis lives within one process's positions: a model axis
  larger than a process's positions raises and names the limit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch

from predictionio_tpu_torch.device import resolve_device

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "TrainingMesh",
    "WorkflowContext",
    "local_context",
    "mesh_context",
]

#: canonical mesh-axis names: ``data`` shards the batch / entity rows,
#: ``model`` shards factor and embedding tables
DATA_AXIS = "data"
MODEL_AXIS = "model"


def _process_group() -> tuple[int, int]:
    """``(rank, world size)`` of the process group, ``(0, 1)`` without one
    (read from ``torch.distributed``, so that a context imports nothing of
    ``parallel`` where there is no group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True)
class TrainingMesh:
    """One process's mesh positions: ``devices[d * model + m]`` is local
    position ``(d, m)`` (any ``torch.device``, repeats allowed).
    ``local_shape`` maps each axis name to this process's size;
    :attr:`shape` is the job's, with the data axis over every process."""

    devices: tuple
    local_shape: dict
    processes: int = 1
    process_index: int = 0

    @property
    def shape(self) -> dict:
        """The job's axis sizes (``jax.sharding.Mesh.shape``'s meaning)."""
        return {
            name: size * self.processes if name == DATA_AXIS else size
            for name, size in self.local_shape.items()
        }

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def local_size(self) -> int:
        return len(self.devices)

    def local(self, axis: str) -> int:
        """This process's size of ``axis`` (1 where the mesh lacks it)."""
        return int(self.local_shape.get(axis, 1))

    def row(self, d: int, model_axis: str = MODEL_AXIS) -> tuple:
        """The devices of data position ``d``: its model positions."""
        m = self.local(model_axis)
        return self.devices[d * m : (d + 1) * m]

    def describe(self) -> dict:
        """What an ``EngineInstance`` records as its ``mesh_conf``."""
        return {
            "devices": str(self.size),
            "axes": str(self.shape),
            "local_devices": str([str(d) for d in self.devices]),
        }


@dataclasses.dataclass(frozen=True)
class WorkflowContext:
    """Everything a DASE component may need from the runtime.

    Attributes:
      device: the ``torch.device`` training and serving run on, always
        resolved (:func:`~predictionio_tpu_torch.device.resolve_device`):
        the card by default, raising where there is none; the CPU only
        when asked for. Under a mesh, its first position.
      mesh: the :class:`TrainingMesh` training runs under, or None.
      host_index / num_hosts: this process's slot in a multi-process job,
        from the process group (0 / 1 without one): the sharded event
        reads and the single writer of instances and blobs follow it.
      batch: free-form run label (parity: ``WorkflowParams.batch``).
      verbose: verbosity level (parity: ``WorkflowParams.verbose``).
      warm_model: the previous trained model of THIS algorithm for a warm
        retrain (``pio train --warm-start``), else ``None``.
    """

    device: torch.device = dataclasses.field(default_factory=resolve_device)
    host_index: int = dataclasses.field(default_factory=lambda: _process_group()[0])
    num_hosts: int = dataclasses.field(default_factory=lambda: _process_group()[1])
    batch: str = ""
    verbose: int = 0
    warm_model: Any = None
    mesh: TrainingMesh | None = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def has_mesh(self) -> bool:
        """A mesh of more than one position (across the job): one position
        is the single-device path."""
        return self.mesh is not None and self.mesh.size > 1

    @property
    def num_devices(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    def mesh_conf(self) -> dict:
        """The ``EngineInstance.mesh_conf`` of a train under this context:
        the device, and the mesh and the process group when there are."""
        conf = {"device": str(self.device)}
        if self.has_mesh:
            conf.update(self.mesh.describe())
        if self.num_hosts > 1:
            from predictionio_tpu_torch.parallel import distributed

            conf.update(processes=str(self.num_hosts), backend=str(distributed.backend()))
        return conf


def local_context(
    device: str | torch.device | None = None, batch: str = "", verbose: int = 0
) -> WorkflowContext:
    """A one-device context: ``device=None`` resolves to the card and
    raises where there is none; ``device="cpu"`` runs on the CPU."""
    return WorkflowContext(device=device, batch=batch, verbose=verbose)


def _local_positions(device) -> tuple:
    """This process's devices: a ``local_devices`` block, else the card the
    process group gave this process, else the visible cards (the CPU when
    the caller asks for it)."""
    from predictionio_tpu_torch.parallel import distributed, sharding

    if sharding._LOCAL_DEVICES is not None:
        return sharding._LOCAL_DEVICES
    if distributed.is_multihost():
        own = distributed.local_device()
        if device is not None and resolve_device(device).type != own.type:
            raise ValueError(f"this process drives {own}, not {device}")
        return (own,)
    return sharding.visible_devices(device)


def mesh_context(
    axis_sizes: Sequence[int] | None = None,
    axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
    devices: Sequence | None = None,
    batch: str = "",
    verbose: int = 0,
    device: str | torch.device | None = None,
) -> WorkflowContext:
    """A context over this process's devices arranged as a mesh.

    ``axis_sizes=None`` puts every position on the ``data`` axis (a
    ``model`` axis of 1). ``devices`` names the positions (else
    :func:`_local_positions`; ``device`` says card or CPU for the
    visible ones). The sizes are this process's and must multiply to its
    positions; the data axis spans the processes."""
    devs = tuple(torch.device(d) for d in (devices if devices is not None else _local_positions(device)))
    if not devs:
        raise ValueError("mesh_context: no devices")
    names = tuple(axis_names)
    if axis_sizes is None:
        axis_sizes = [len(devs)] + [1] * (len(names) - 1)
    sizes = [int(s) for s in axis_sizes]
    if len(sizes) != len(names):
        raise ValueError(f"axis_sizes {sizes} does not match axis_names {names}")
    if len(set(names)) != len(names) or not set(names) <= {DATA_AXIS, MODEL_AXIS}:
        raise ValueError(f"mesh axes must be among {(DATA_AXIS, MODEL_AXIS)}, got {names}")
    if any(s < 1 for s in sizes):
        raise ValueError(f"mesh axis sizes must be positive, got {sizes}")
    local_shape = dict(zip(names, sizes))
    model = local_shape.get(MODEL_AXIS, 1)
    if model > len(devs):
        raise ValueError(
            f"the model axis ({model}) lives within one process's positions: "
            f"at most {len(devs)} here"
        )
    if math.prod(sizes) != len(devs):
        raise ValueError(
            f"mesh axes {local_shape} need {math.prod(sizes)} positions; this process has "
            f"{len(devs)} ({', '.join(str(d) for d in devs)})"
        )
    if DATA_AXIS not in local_shape:
        local_shape = {DATA_AXIS: 1, **local_shape}
    for d in devs:
        resolve_device(d)  # a card position where there is no card raises
    rank, world = _process_group()
    mesh = TrainingMesh(devices=devs, local_shape=local_shape, processes=world, process_index=rank)
    return WorkflowContext(device=devs[0], batch=batch, verbose=verbose, mesh=mesh)
