"""Distribution layer of the port: sharded factor serving over the local
devices of one process (:mod:`predictionio_tpu_torch.parallel.sharding`,
``pio deploy --shard-factors``).

Counterpart of ``predictionio_tpu/parallel/``. The multi-host pieces of
the JAX package (``distributed.py``, ``reader.py``, ``exchange.py``) wait
for ROADMAP queue 1 item 15. Nothing here is imported until a deploy asks
for sharded tables.
"""
