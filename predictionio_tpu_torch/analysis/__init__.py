"""Runtime analysis of the port (counterpart of ``predictionio_tpu/analysis``).

* :mod:`~predictionio_tpu_torch.analysis.jit_witness` — the serve-time
  compile counter of ``pio deploy --aot`` and its zero-compile gate.

Stdlib only: importing it imports neither torch nor jax.
"""
