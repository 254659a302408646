"""Mid-training step checkpoints (resume-on-preemption).

Counterpart of ``predictionio_tpu/utils/checkpoint.py``, over
``torch.distributed.checkpoint`` in place of orbax. Parity-plus: the
reference has NO mid-training checkpointing (SURVEY.md section 6.4), only
final-model blobs.

* Numbered steps: step ``n`` is the directory ``<dir>/<n>``, written as a
  ``torch.distributed.checkpoint`` save into ``<dir>/.tmp-<n>`` and
  renamed into place once every file is written, so a half-written step
  is never :meth:`CheckpointManager.latest_step`.
* Keep-last-k: older steps are removed after each save.
* Works without a process group, and in one: every process calls
  :meth:`~CheckpointManager.save` and :meth:`~CheckpointManager.restore`
  (the save is collective there), and process 0 renames and prunes.
"""

from __future__ import annotations

import os
import shutil
import warnings

import torch

from predictionio_tpu_torch.parallel import distributed

__all__ = ["CheckpointManager"]

#: what ``torch.distributed.checkpoint`` warns without a process group,
#: where one process saving alone is this module's intent
_NO_GROUP_WARNING = "torch.distributed is disabled, unavailable or uninitialized"


class CheckpointManager:
    """Numbered steps of a ``{name: tensor}`` state in ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(1, int(max_to_keep))
        if distributed.process_index() == 0:
            os.makedirs(self.directory, exist_ok=True)
        distributed.barrier()

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> list:
        """The complete steps, ascending."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(
            int(n) for n in names
            if n.isdigit() and os.path.isfile(os.path.join(self.directory, n, ".metadata"))
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> None:
        """Write ``state`` (names to tensors; every process holds the same
        values) as step ``step``, in place of any earlier step ``step``."""
        import torch.distributed.checkpoint as dcp

        final = self._path(step)
        tmp = os.path.join(self.directory, f".tmp-{int(step)}")
        lead = distributed.process_index() == 0
        if lead and os.path.isdir(tmp):
            shutil.rmtree(tmp)  # a save cut short before
        distributed.barrier()
        host = {k: v.detach().cpu() for k, v in state.items()}
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=_NO_GROUP_WARNING)
            dcp.save(host, checkpoint_id=tmp)
        distributed.barrier()
        if lead:
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            for old in self.all_steps()[: -self.max_to_keep]:
                shutil.rmtree(self._path(old), ignore_errors=True)
        distributed.barrier()

    def _saved(self, step: int) -> dict:
        """Each saved tensor's ``(shape, dtype)`` at ``step``."""
        import torch.distributed.checkpoint as dcp

        meta = dcp.FileSystemReader(self._path(step)).read_metadata()
        return {
            k: (tuple(v.size), v.properties.dtype)
            for k, v in meta.state_dict_metadata.items() if hasattr(v, "size")
        }

    def restore(self, step: int | None = None, like: dict | None = None) -> dict:
        """Load ``step`` (default: the latest) as host tensors. ``like``
        maps each name to a tensor of the expected shape and dtype (else
        every saved tensor is loaded as saved); a saved shape that differs
        raises ``ValueError``."""
        import torch.distributed.checkpoint as dcp

        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"No checkpoint steps found in {self.directory}")
        saved = self._saved(step)
        if like is None:
            like = {k: torch.empty(shape, dtype=dtype) for k, (shape, dtype) in saved.items()}
        target = {}
        for name, t in like.items():
            if name not in saved:
                raise ValueError(f"checkpoint step {step} has no {name!r}")
            if tuple(t.shape) != saved[name][0]:
                raise ValueError(f"checkpoint step {step}: {name!r} is {saved[name][0]}, expected {tuple(t.shape)}")
            target[name] = torch.empty(tuple(t.shape), dtype=t.dtype)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=_NO_GROUP_WARNING)
            dcp.load(target, checkpoint_id=self._path(step))
        return target
