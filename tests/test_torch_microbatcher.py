"""The JAX package's micro-batcher cases (``tests/test_microbatcher.py``)
on both packages' classes.

Every case of the JAX file runs twice, ``[jax]`` and ``[torch]``
(``tests/torch_package_swap.py``): under ``[torch]`` its ``MicroBatcher``,
``BatcherConfig``, ``ServingStats``, ``QueryService``, ``start_background``
and workflow functions are the port's, on the CPU, and its engine is the
port's copy of ``fake_dase:engine0`` (``test_torch_dase:engine0``).
"""

import pytest

import predictionio_tpu_torch.workflow.serving as port_serving
import test_microbatcher as jax_cases
from predictionio_tpu_torch.api.http import start_background
from predictionio_tpu_torch.api.stats import ServingStats
from predictionio_tpu_torch.serving import AdmissionPolicy, BatcherConfig, MicroBatcher
from predictionio_tpu_torch.workflow import load_engine_variant, run_train
from test_microbatcher import trained  # noqa: F401  (the cases' fixture)
from torch_package_swap import PACKAGES, cpu_context, memory_storage, use_port


@pytest.fixture(params=PACKAGES, autouse=True)
def package(request, monkeypatch):
    if request.param == "torch":
        use_port(
            monkeypatch,
            jax_cases,
            {
                "ServingStats": ServingStats,
                "start_background": start_background,
                "local_context": cpu_context,
                "AdmissionPolicy": AdmissionPolicy,
                "BatcherConfig": BatcherConfig,
                "MicroBatcher": MicroBatcher,
                "load_engine_variant": load_engine_variant,
                "run_train": run_train,
                "QueryService": port_serving.QueryService,
                "VARIANT": dict(jax_cases.VARIANT, engineFactory="test_torch_dase:engine0"),
            },
            {"predictionio_tpu.workflow.serving": port_serving},
        )
    return request.param


@pytest.fixture()
def memory_storage_env(package):
    yield from memory_storage(package)


class TestConfig(jax_cases.TestConfig):
    pass


class TestBatcherCore(jax_cases.TestBatcherCore):
    pass


class TestQueryServiceIntegration(jax_cases.TestQueryServiceIntegration):
    pass


def test_serving_stats_percentiles_empty_and_filled():
    jax_cases.test_serving_stats_percentiles_empty_and_filled()


def test_cases_run_on_the_ports_classes(package):
    names = ("MicroBatcher", "BatcherConfig", "ServingStats", "QueryService", "start_background")
    prefix = "predictionio_tpu." if package == "jax" else "predictionio_tpu_torch."
    assert all(getattr(jax_cases, n).__module__.startswith(prefix) for n in names)
    assert jax_cases.VARIANT["engineFactory"] == ("fake_dase:engine0" if package == "jax" else "test_torch_dase:engine0")
