"""The JAX package's query-path cache cases (``tests/test_serving_cache.py``)
on both packages' classes.

Every case of the JAX file runs twice, ``[jax]`` and ``[torch]``
(``tests/torch_package_swap.py``): under ``[torch]`` the cache classes,
``QueryService``, ``device_state``, the workflow functions, the event and
storage classes are the port's, and the Recommendation engine trains and
serves through the port on the CPU. ``--pin-model`` on the CPU pins the
factors as CPU tensors (the port serves host numpy there otherwise).
"""

import pytest

import predictionio_tpu_torch.data.event as port_event
import predictionio_tpu_torch.data.storage.base as port_storage_base
import predictionio_tpu_torch.serving.cache as port_cache
import predictionio_tpu_torch.workflow as port_workflow
import predictionio_tpu_torch.workflow.device_state as port_device_state
import predictionio_tpu_torch.workflow.serving as port_serving
import test_serving_cache as jax_cases
from test_serving_cache import trained_variant  # noqa: F401  (the cases' fixture)
from torch_package_swap import PACKAGES, controller_module, memory_storage, use_port

#: the module globals of the JAX test file, from ``serving.cache``
CACHE_NAMES = (
    "CacheConfig", "CacheStats", "ResultCache", "Singleflight",
    "canonical_key", "extract_scope", "scopes_from_events",
)


@pytest.fixture(params=PACKAGES, autouse=True)
def package(request, monkeypatch):
    if request.param == "torch":
        use_port(
            monkeypatch,
            jax_cases,
            {name: getattr(port_cache, name) for name in CACHE_NAMES},
            {
                "predictionio_tpu.controller": controller_module(),
                "predictionio_tpu.data.event": port_event,
                "predictionio_tpu.data.storage.base": port_storage_base,
                "predictionio_tpu.workflow": port_workflow,
                "predictionio_tpu.workflow.serving": port_serving,
                "predictionio_tpu.workflow.device_state": port_device_state,
            },
        )
    return request.param


@pytest.fixture()
def memory_storage_env(package):
    yield from memory_storage(package)


class TestKeysAndConfig(jax_cases.TestKeysAndConfig):
    pass


class TestResultCache(jax_cases.TestResultCache):
    pass


class TestSingleflight(jax_cases.TestSingleflight):
    pass


class TestQueryServiceCache(jax_cases.TestQueryServiceCache):
    pass


class TestPinnedServing(jax_cases.TestPinnedServing):
    pass


def test_cases_run_on_the_ports_classes(package, trained_variant):  # noqa: F811
    from predictionio_tpu.workflow.serving import QueryService

    prefix = "predictionio_tpu." if package == "jax" else "predictionio_tpu_torch."
    assert all(getattr(jax_cases, n).__module__.startswith(prefix) for n in CACHE_NAMES)
    storage, variant = trained_variant
    assert QueryService.__module__.startswith(prefix) and storage.__module__.startswith(prefix)
    assert variant.build_engine().algorithms_class_map["als"].__module__.startswith(prefix)
