"""The JAX package's controller, workflow, query-server and console suites
rerun on the port's copies, ``[torch]`` only (the ``[jax]`` side is the
reference's own files).

``tests/test_controller.py`` (34 cases), ``tests/test_workflow.py`` (8),
``tests/test_query_server.py`` (10) and ``tests/test_cli.py`` (19) are
loaded from their own text with the package path renamed to the port's
(``torch_package_swap.port_copy``; ``fake_dase`` becomes the same rewrite
of ``tests/fake_dase.py`` on the port's controller), so every assertion
is the reference test's. The port's entry points default to the card:
``local_context``, the query server's context and the console's device
verbs are bound to the CPU (``torch_package_swap.on_cpu``).
"""

from torch_package_swap import (  # noqa: F401  (suite_*: the fixtures of these cases)
    jax_globals,
    port_copy,
    reference_suite,
    suite_memory_storage_env,
    suite_package,
)

SUITES = ("test_controller", "test_workflow", "test_query_server", "test_cli")

#: cases of these suites that do not run on the port, with the reason
EXCLUDED: dict = {}

for _name in SUITES:
    reference_suite(globals(), _name, EXCLUDED.get(_name, {}))


def test_suites_run_on_the_ports_package():
    for name in SUITES:
        assert jax_globals(port_copy(name)) == [], name
    assert port_copy("test_query_server").QueryService.__module__ == "predictionio_tpu_torch.workflow.serving"
    assert port_copy("test_controller").MyParams.__mro__[1].__module__ == "predictionio_tpu_torch.controller.params"
