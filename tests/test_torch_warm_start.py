"""``pio train --warm-start`` in the port against the JAX package, on one
store.

* ``aligned_factor_init`` is bit-equal across packages, with the ALS
  draw and with the Two-Tower's signed-normal ``fresh`` draw.
* A port warm start from a JAX-written blob, and a JAX warm start from a
  port-written blob, each record ``warm_start_from`` in the lineage and
  each differ from a cold start of the same package on the same data.
* From one predecessor blob, one warm ALS sweep in each package gives
  factors within the ALS band of tests/test_als.py (rtol 5e-3, atol
  5e-4). Rank 10, so both packages solve with Cholesky (K % 8 != 0).
"""

import datetime as dt

import numpy as np
import pytest

from predictionio_tpu.controller import local_context as jax_local_context
from predictionio_tpu.data.aggregator import BiMap as JaxBiMap
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.templates.serving_util import aligned_factor_init as jax_aligned_factor_init
from predictionio_tpu.utils.serialization import loads_model as jax_loads_model
from predictionio_tpu.workflow import load_engine_variant as jax_load_variant
from predictionio_tpu.workflow import run_train as jax_run_train
from predictionio_tpu.workflow.core import WorkflowParams as JaxWorkflowParams
from predictionio_tpu_torch.controller.context import local_context
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.templates.serving_util import aligned_factor_init
from predictionio_tpu_torch.utils.serialization import loads_model
from predictionio_tpu_torch.workflow import load_engine_variant, run_train
from predictionio_tpu_torch.workflow.core import WorkflowParams

RTOL, ATOL = 5e-3, 5e-4
CPU = local_context("cpu")
T0 = dt.datetime(2022, 6, 1, tzinfo=dt.timezone.utc)


def _variant(iterations: int) -> dict:
    return {
        "id": "warm-eng",
        "version": "1",
        "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
        "datasource": {"params": {"appName": "warm-app"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 10, "numIterations": iterations, "lambda": 0.05, "seed": 3}}],
    }


def _insert(app_id: int, seed: int, n: int, users: int, items: int, offset: int = 0) -> None:
    rng = np.random.default_rng(seed)
    Storage.get_l_events().insert_batch(
        [
            Event(event="rate", entity_type="user", entity_id=f"u{u}", target_entity_type="item",
                  target_entity_id=f"i{i}", properties=DataMap({"rating": float((u + 2 * i) % 5 + 1)}),
                  event_time=T0 + dt.timedelta(seconds=offset + k))
            for k, (u, i) in enumerate(zip(rng.integers(0, users, n), rng.integers(0, items, n)))
        ],
        app_id,
    )


@pytest.fixture()
def store(tmp_path):
    """One sqlite + localfs store for both packages: 1,200 ratings of 50
    users on 80 items now, and ``grow()`` adds 400 more that bring 10 new
    users and 10 new items."""
    env = {"PIO_FS_BASEDIR": str(tmp_path / "base")}
    Storage.configure(env)
    JaxStorage.configure(env)
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="warm-app"))
        Storage.get_l_events().init(app_id)
        _insert(app_id, 1, 1200, 50, 80)
        yield lambda: _insert(app_id, 2, 400, 60, 90, offset=10_000)
    finally:
        Storage.configure(None)
        JaxStorage.configure(None)


def _als(instance_id: str, package: str):
    blob = Storage.get_model_data_models().get(instance_id).models
    (_, model), = (loads_model if package == "port" else jax_loads_model)(blob)
    return np.asarray(model.user_factors), np.asarray(model.item_factors)


@pytest.mark.parametrize("fresh", ["als", "twotower"])
def test_aligned_factor_init_is_bit_equal_across_packages(fresh):
    rng = np.random.default_rng(0)
    old = rng.standard_normal((30, 6)).astype(np.float32)
    old_keys = [f"k{j}" for j in rng.permutation(40)[:30]]
    new_keys = [f"k{j}" for j in rng.permutation(45)[:35]]
    draw = None if fresh == "als" else (lambda r, shape: r.standard_normal(shape) / np.sqrt(shape[1]))
    for rank in (6, 8, 4):
        got, n = aligned_factor_init(old, BiMap.string_index(old_keys), BiMap.string_index(new_keys), rank, 7, draw)
        want, m = jax_aligned_factor_init(
            old, JaxBiMap.string_index(old_keys), JaxBiMap.string_index(new_keys), rank, 7, draw
        )
        assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()
        assert n == m == len(set(old_keys) & set(new_keys))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_warm_start_from_the_other_packages_blob(store, first):
    """The predecessor is written by ``first``; the other package warm
    starts from it after new events arrive."""
    if first == "jax":
        prev = jax_run_train(jax_load_variant(_variant(3)), jax_local_context())
    else:
        prev = run_train(load_engine_variant(_variant(3)), CPU)
    store()
    if first == "jax":
        warm = run_train(load_engine_variant(_variant(1)), CPU, WorkflowParams(warm_start=True))
        cold = run_train(load_engine_variant(_variant(1)), CPU)
        package = "port"
    else:
        warm = jax_run_train(jax_load_variant(_variant(1)), jax_local_context(), JaxWorkflowParams(warm_start=True))
        cold = jax_run_train(jax_load_variant(_variant(1)), jax_local_context())
        package = "jax"
    assert warm.env["warm_start_from"] == prev.id
    assert "warm_start_from" not in cold.env
    (wu, wi), (cu, ci) = _als(warm.id, package), _als(cold.id, package)
    assert wu.shape == cu.shape == (60, 10) and wi.shape == ci.shape == (90, 10)
    assert not np.allclose(wu, cu, rtol=RTOL, atol=ATOL)


def test_one_warm_sweep_matches_the_jax_package(store):
    prev = run_train(load_engine_variant(_variant(3)), CPU)
    store()
    port = run_train(load_engine_variant(_variant(1)), CPU, WorkflowParams(warm_start=True))
    pu, pi = _als(port.id, "port")
    # the JAX package's warm start must find the same predecessor
    Storage.get_meta_data_engine_instances().delete(port.id)
    jax = jax_run_train(jax_load_variant(_variant(1)), jax_local_context(), JaxWorkflowParams(warm_start=True))
    assert port.env["warm_start_from"] == jax.env["warm_start_from"] == prev.id
    ju, ji = _als(jax.id, "jax")
    np.testing.assert_allclose(pu, ju, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pi, ji, rtol=RTOL, atol=ATOL)
