"""The JAX package's event-server, lifecycle, TLS and resilience suites
rerun on the port's copies, ``[torch]`` only (the ``[jax]`` side is the
reference's own files).

``tests/test_event_server.py`` (22 cases), ``tests/test_lifecycle_drain.py``
(7: the drain in process, then SIGTERM to a ``pio eventserver``
subprocess, here the port's console), ``tests/test_ssl_and_lifecycle.py``
(8: HTTPS on both servers, a trained Recommendation variant's lifecycle,
the storage server's bind guard) and ``tests/test_resilience.py`` (47:
deadlines, retries, the breaker, fault injection, the RPC error
taxonomy, health endpoints, the degraded reload, feedback isolation, the
storage outage drill) are loaded from their own text with the package
path renamed to the port's (``torch_package_swap.port_copy``), so every
assertion is the reference test's.
"""

from torch_package_swap import (  # noqa: F401  (suite_*: the fixtures of these cases)
    jax_globals,
    port_copy,
    reference_suite,
    suite_memory_storage_env,
    suite_package,
)

SUITES = ("test_event_server", "test_lifecycle_drain", "test_ssl_and_lifecycle", "test_resilience")

#: cases of these suites that do not run on the port, with the reason
EXCLUDED: dict = {}

for _name in SUITES:
    reference_suite(globals(), _name, EXCLUDED.get(_name, {}))


def test_suites_run_on_the_ports_package():
    for name in SUITES:
        assert jax_globals(port_copy(name)) == [], name
    assert port_copy("test_resilience").QueryService.__module__ == "predictionio_tpu_torch.workflow.serving"
