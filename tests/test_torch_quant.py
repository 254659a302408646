"""The JAX package's int8 serving cases (``tests/test_quant.py``) on both
packages' classes.

Every case of the subclassed JAX classes runs twice, ``[jax]`` and
``[torch]`` (``tests/torch_package_swap.py``): under ``[torch]`` the test
module's ``quant`` (its ``quantize_table`` bound to the CPU) and
``jnp.asarray`` (a CPU tensor) are the port's, and so are ``ops.ivf``
(``build_ivf`` on the CPU), the fold-in (``foldin_rows`` on the CPU),
``top_k_items_batch`` (taking the cases'
arrays as CPU tensors), ``device_state``, ``QueryService``,
the configs, the Two-Tower template (its algorithm on the CPU) and the
event and storage classes; the Recommendation engine trains and serves
through the port on the CPU.

The cases of the sharded tier (``test_sharded_matches_replicated_bitwise``,
``test_padding_rows_never_rank``,
``test_sharded_set_rows_routes_to_owner_shard``,
``test_sharded_quantized_index_matches_unsharded``,
``test_composes_with_shard_factors``,
``test_release_returns_dequantized_host_factors``) run on the port's
``parallel.sharding`` too, over the ``(cpu,)*8`` mesh its
``local_devices`` sets for each ``[torch]`` case (JAX's 8 host devices
under ``[jax]``). :func:`test_release_of_an_int8_service_returns_host_f32`
holds the release of an unsharded int8 service on both packages.
"""

import numpy as np
import pytest

import predictionio_tpu.ops as jax_ops_package
import predictionio_tpu.parallel as jax_parallel_package
import predictionio_tpu_torch.data.aggregator as port_aggregator
import predictionio_tpu_torch.data.event as port_event
import predictionio_tpu_torch.data.storage.base as port_storage_base
import predictionio_tpu_torch.online.foldin as port_foldin
import predictionio_tpu_torch.online.types as port_types
import predictionio_tpu_torch.ops.als as port_als
import predictionio_tpu_torch.ops.ivf as port_ivf
import predictionio_tpu_torch.ops.quant as port_quant
import predictionio_tpu_torch.serving as port_serving_package
import predictionio_tpu_torch.templates.twotower.engine as port_twotower
import predictionio_tpu_torch.workflow as port_workflow
import predictionio_tpu_torch.workflow.device_state as port_device_state
import predictionio_tpu_torch.workflow.serving as port_serving
import test_quant as jax_cases
from predictionio_tpu_torch.parallel import sharding as port_sharding
from test_quant import quant_variant  # noqa: F401  (the cases' fixture)
from torch_package_swap import (
    PACKAGES,
    controller_module,
    cpu_module,
    memory_storage,
    tensor_numpy,
    tensor_top_k_items_batch,
    use_port,
)


@pytest.fixture(params=PACKAGES, autouse=True)
def package(request, monkeypatch):
    if request.param != "torch":
        yield request.param
        return
    als = cpu_module("predictionio_tpu.ops.als", port_als)
    als.top_k_items_batch = tensor_top_k_items_batch
    use_port(
        monkeypatch,
        jax_cases,
        {
            "quant": cpu_module("predictionio_tpu.ops.quant", port_quant, quantize_table=port_quant.quantize_table),
            "jnp": tensor_numpy(),
        },
        {
            "predictionio_tpu.controller": controller_module(),
            "predictionio_tpu.data.aggregator": port_aggregator,
            "predictionio_tpu.data.event": port_event,
            "predictionio_tpu.data.storage.base": port_storage_base,
            "predictionio_tpu.online.foldin": cpu_module(
                "predictionio_tpu.online.foldin", port_foldin, foldin_rows=port_foldin.foldin_rows
            ),
            "predictionio_tpu.online.types": port_types,
            "predictionio_tpu.ops.als": als,
            "predictionio_tpu.parallel.sharding": port_sharding,
            "predictionio_tpu.serving": port_serving_package,
            "predictionio_tpu.templates.twotower.engine": cpu_module(
                "predictionio_tpu.templates.twotower.engine", port_twotower,
                TwoTowerAlgorithm=port_twotower.TwoTowerAlgorithm,
            ),
            "predictionio_tpu.workflow": port_workflow,
            "predictionio_tpu.workflow.serving": port_serving,
            "predictionio_tpu.workflow.device_state": port_device_state,
        },
    )
    # `from predictionio_tpu.ops import ivf` and `from predictionio_tpu.parallel
    # import sharding` read the packages' attributes
    ivf = cpu_module("predictionio_tpu.ops.ivf", port_ivf, build_ivf=port_ivf.build_ivf)
    monkeypatch.setattr(jax_ops_package, "ivf", ivf, raising=False)
    monkeypatch.setattr(jax_parallel_package, "sharding", port_sharding, raising=False)
    # the port's 8-way mesh, the counterpart of JAX's 8 host devices
    with port_sharding.local_devices(["cpu"] * 8):
        yield request.param


@pytest.fixture()
def memory_storage_env(package):
    yield from memory_storage(package)


class TestPrimitives(jax_cases.TestPrimitives):
    pass


class TestTwoStageTopK(jax_cases.TestTwoStageTopK):
    pass


class TestQuantizedTableFoldIn(jax_cases.TestQuantizedTableFoldIn):
    pass


class TestQuantizedIVF(jax_cases.TestQuantizedIVF):
    pass


class TestQueryServiceQuantized(jax_cases.TestQueryServiceQuantized):
    pass


class TestTwoTowerQuantized(jax_cases.TestTwoTowerQuantized):
    pass


def test_release_of_an_int8_service_returns_host_f32(quant_variant):  # noqa: F811
    """``test_release_returns_dequantized_host_factors``'s assertions on
    the unsharded int8 service: released tables are host f32 numpy, the
    ``QuantRuntime`` and the pin are gone."""
    from predictionio_tpu.serving import CacheConfig
    from predictionio_tpu.workflow import device_state
    from predictionio_tpu.workflow.serving import QueryService

    _, variant = quant_variant
    qs = QueryService(variant, cache=CacheConfig(quantize="int8"))
    pairs = qs._algo_model_pairs
    device_state.release_pairs(pairs)
    _, model = pairs[0]
    assert isinstance(model.user_factors, np.ndarray)
    assert model.user_factors.dtype == np.float32
    assert getattr(model, "_pio_quant", None) is None
    assert not getattr(model, "_pio_pinned", True)


def test_cases_run_on_the_ports_classes(package):
    from predictionio_tpu.ops import ivf
    from predictionio_tpu.ops.als import top_k_items_batch
    from predictionio_tpu.workflow import device_state
    from predictionio_tpu.workflow.serving import QueryService

    from predictionio_tpu.parallel import sharding

    prefix = "predictionio_tpu." if package == "jax" else "predictionio_tpu_torch."
    for obj in (QueryService, jax_cases.quant.QuantizedTable, ivf.AnnRuntime):
        assert obj.__module__.startswith(prefix)
    assert sharding.__name__.startswith(prefix) and sharding.serving_mesh().shape["model"] == 8
    assert device_state.__name__.startswith(prefix)
    if package == "torch":
        assert jax_cases.quant.quantize_table.keywords == {"device": "cpu"}
        assert top_k_items_batch is tensor_top_k_items_batch
