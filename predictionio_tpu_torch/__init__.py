"""predictionio_tpu_torch — the PyTorch/CUDA port of predictionio_tpu.

The same ML server, with its compute in PyTorch on an NVIDIA H100 and
every Pallas TPU kernel of the JAX package rewritten by hand for Hopper.
The JAX package (``predictionio_tpu``) stays the reference the port is
held against; this package imports neither it nor ``jax``, and keeps its
own copy of the little it needs from it. Module names mirror the JAX
package, so each module's counterpart is found at the same path.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :func:`predictionio_tpu_torch.device.resolve_device`).
"""

from predictionio_tpu_torch.version import __version__

__all__ = ["__version__"]
