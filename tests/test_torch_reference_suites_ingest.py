"""The JAX package's event, aggregator and bulk-ingest suites rerun on the
port's copies, ``[torch]`` only (the ``[jax]`` side is the reference's
own files).

``tests/test_bulk_ingest.py`` (60 cases: the parse, the pipeline, the
columnar and remote ``ingest_chunk``, the bulk route, the compaction
scheduler, the pipelined import, the guards), ``tests/test_aggregator.py``
(11; ``BiMap`` is the port's ``data/bimap.py``, re-exported by its
``data/aggregator.py``) and ``tests/test_event.py`` (21) are loaded from
their own text with the package path renamed to the port's
(``torch_package_swap.port_copy``), so every assertion is the reference
test's, and the bulk route's lazy-import probe runs in a subprocess of
the port's modules.
"""

from torch_package_swap import (  # noqa: F401  (suite_*: the fixtures of these cases)
    jax_globals,
    port_copy,
    reference_suite,
    suite_package,
)

SUITES = ("test_bulk_ingest", "test_aggregator", "test_event")

#: cases of these suites that do not run on the port, with the reason
EXCLUDED: dict = {}

for _name in SUITES:
    reference_suite(globals(), _name, EXCLUDED.get(_name, {}))


def test_suites_run_on_the_ports_package():
    for name in SUITES:
        assert jax_globals(port_copy(name)) == [], name
    assert port_copy("test_aggregator").BiMap.__module__ == "predictionio_tpu_torch.data.bimap"
    assert port_copy("test_bulk_ingest").IngestPipeline.__module__ == "predictionio_tpu_torch.data.ingest"
