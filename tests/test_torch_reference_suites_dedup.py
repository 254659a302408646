"""The JAX package's dedup-ingest suite rerun on the port's copies,
``[torch]`` only (the ``[jax]`` side is the reference's own file).

``tests/test_dedup_ingest.py`` (17 cases: ``insert_dedup`` over the
memory, sqlite, remote and columnar drivers, the dedup across restarts
and compactions, the remote retry, the event server's dedup routes, the
recovery sweep) is loaded from its own text with the package path
renamed to the port's (``torch_package_swap.port_copy``); its drivers
come from the same rewrite of ``tests/test_storage_contract.py``, so
every assertion is the reference test's.
"""

from torch_package_swap import (  # noqa: F401  (suite_*: the fixtures of these cases)
    jax_globals,
    port_copy,
    reference_suite,
    suite_memory_storage_env,
    suite_package,
)

#: cases of this suite that do not run on the port, with the reason
EXCLUDED: dict = {}

reference_suite(globals(), "test_dedup_ingest", EXCLUDED)


def test_suite_runs_on_the_ports_package():
    assert jax_globals(port_copy("test_dedup_ingest")) == []
    assert jax_globals(port_copy("test_storage_contract")) == []
    assert port_copy("test_dedup_ingest").columnar.__name__ == "predictionio_tpu_torch.data.storage.columnar"
