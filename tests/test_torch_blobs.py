"""One model-blob format for both packages, on the CPU.

The port writes the classes the two packages share (``ALSModel``,
``BiMap``, ``TwoTowerServingModel``, ``PersistentModelManifest``) under
the JAX package's paths, so:

* the JAX package's ``loads_model`` reads a port blob as its own classes,
  field for field;
* a JAX ``ALSAlgorithm.train`` warm-started from the model of a port blob
  really starts warm: its user factors differ from a cold start's, and
  equal those of a warm start from the same arrays in the JAX package's
  own ``ALSModel``;
* writing a blob imports nothing of the JAX package (a subprocess probe);
* the port reads its own blobs and the JAX package's as its own classes.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import local_context as jax_local_context
from predictionio_tpu.controller.persistent import PersistentModelManifest as JaxManifest
from predictionio_tpu.data.aggregator import BiMap as JaxBiMap
from predictionio_tpu.templates.recommendation import engine as jax_rec
from predictionio_tpu.templates.twotower import engine as jax_tt
from predictionio_tpu.utils.serialization import dumps_model as jax_dumps_model
from predictionio_tpu.utils.serialization import loads_model as jax_loads_model
from predictionio_tpu_torch.controller.persistent import PersistentModelManifest
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.templates.recommendation.engine import ALSModel
from predictionio_tpu_torch.templates.twotower.engine import TwoTowerServingModel
from predictionio_tpu_torch.utils.serialization import dumps_model, loads_model

ROOT = Path(__file__).resolve().parents[1]
USERS, ITEMS, RANK = 30, 40, 8


def _port_models() -> dict:
    rng = np.random.default_rng(0)
    users = BiMap.string_index(f"u{u}" for u in range(USERS))
    items = BiMap.string_index(f"i{i}" for i in range(ITEMS))
    return {
        # a tensor leaf, as a model may hold before the blob makes it numpy
        "als": ALSModel(torch.from_numpy(rng.random((USERS, RANK), dtype=np.float32)),
                        rng.random((ITEMS, RANK), dtype=np.float32), users, items),
        "twotower": TwoTowerServingModel(
            rng.normal(size=(USERS, RANK)).astype(np.float32), rng.normal(size=(ITEMS, RANK)).astype(np.float32),
            users, items, {"u1": {"i2", "i3"}}, ((0, 9.5), (1, 8.25))),
        "manifest": PersistentModelManifest("some.module:Model"),
    }


JAX_CLASSES = {"als": jax_rec.ALSModel, "twotower": jax_tt.TwoTowerServingModel, "manifest": JaxManifest}
PORT_CLASSES = {"als": ALSModel, "twotower": TwoTowerServingModel, "manifest": PersistentModelManifest}


def _fields(obj) -> dict:
    """Each field of a model as plain data (arrays as numpy, maps as dicts)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, (BiMap, JaxBiMap)):
            v = ("bimap", v.to_dict())
        elif isinstance(v, torch.Tensor):
            v = v.numpy()
        out[f.name] = v
    return out


def _assert_same_fields(got, want) -> None:
    a, b = _fields(got), _fields(want)
    assert a.keys() == b.keys()
    for name in a:
        if isinstance(b[name], np.ndarray):
            assert isinstance(a[name], np.ndarray), name
            np.testing.assert_array_equal(a[name], b[name])
        else:
            assert a[name] == b[name], name


@pytest.mark.parametrize("kind", sorted(JAX_CLASSES))
def test_port_blob_reads_as_the_jax_packages_classes(kind):
    model = _port_models()[kind]
    (tag, got), = jax_loads_model(dumps_model([("pickle", model)]))
    assert tag == "pickle" and type(got) is JAX_CLASSES[kind]
    for name in ("user_index", "item_index"):
        if hasattr(got, name):
            assert type(getattr(got, name)) is JaxBiMap
    _assert_same_fields(got, model)


@pytest.mark.parametrize("kind", sorted(PORT_CLASSES))
def test_port_reads_its_own_and_jax_blobs_as_its_classes(kind):
    model = _port_models()[kind]
    (_, own), = loads_model(dumps_model([("pickle", model)]))
    assert type(own) is PORT_CLASSES[kind]
    _assert_same_fields(own, model)
    (_, jax_model), = jax_loads_model(dumps_model([("pickle", model)]))
    (_, back), = loads_model(jax_dumps_model([("pickle", jax_model)]))
    assert type(back) is PORT_CLASSES[kind]
    _assert_same_fields(back, model)


def test_two_tower_model_has_the_jax_fields_and_pickles_with_defaults():
    names = [f.name for f in dataclasses.fields(TwoTowerServingModel)]
    assert names == [f.name for f in dataclasses.fields(jax_tt.TwoTowerServingModel)]
    bare = TwoTowerServingModel(np.zeros((1, 2)), np.zeros((1, 2)), BiMap({"u": 0}), BiMap({"i": 0}), {})
    (_, got), = loads_model(dumps_model([("pickle", bare)]))
    assert got.loss_history == ()


def _jax_training_data():
    rng = np.random.default_rng(1)
    rows = np.repeat(np.arange(USERS), 6)
    cols = rng.integers(0, ITEMS, rows.size)
    pairs = dict(zip(zip(rows.tolist(), cols.tolist()), rng.integers(1, 6, rows.size).astype(np.float32)))
    (r, c), v = np.array(list(pairs)).T, np.array(list(pairs.values()), np.float32)
    return jax_rec.TrainingData(
        rows=r, cols=c, vals=v,
        user_index=JaxBiMap.string_index(f"u{u}" for u in range(USERS)),
        item_index=JaxBiMap.string_index(f"i{i}" for i in range(ITEMS)),
    )


def test_jax_warm_start_from_a_port_blob_is_not_a_cold_start():
    model = _port_models()["als"]
    (_, warm), = jax_loads_model(dumps_model([("pickle", model)]))
    td = _jax_training_data()
    algo = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(rank=RANK, num_iterations=1, seed=3))
    ctx = jax_local_context()
    cold = algo.train(ctx, td)
    from_port = algo.train(dataclasses.replace(ctx, warm_model=warm), td)
    own = jax_rec.ALSModel(np.asarray(model.user_factors.numpy()), model.item_factors,
                           JaxBiMap(model.user_index.to_dict()), JaxBiMap(model.item_index.to_dict()))
    from_jax = algo.train(dataclasses.replace(ctx, warm_model=own), td)
    assert not np.array_equal(from_port.user_factors, cold.user_factors)
    np.testing.assert_array_equal(from_port.user_factors, from_jax.user_factors)
    np.testing.assert_array_equal(from_port.item_factors, from_jax.item_factors)


def test_dumps_model_imports_nothing_of_the_jax_package():
    probe = (
        "import sys\n"
        "import numpy as np\n"
        "from predictionio_tpu_torch.controller.persistent import PersistentModelManifest\n"
        "from predictionio_tpu_torch.data.bimap import BiMap\n"
        "from predictionio_tpu_torch.templates.recommendation.engine import ALSModel\n"
        "from predictionio_tpu_torch.templates.twotower.engine import TwoTowerServingModel\n"
        "from predictionio_tpu_torch.utils.serialization import dumps_model\n"
        "b = BiMap({'a': 0})\n"
        "blob = dumps_model([ALSModel(np.zeros((1, 2)), np.zeros((1, 2)), b, b),\n"
        "                    TwoTowerServingModel(np.zeros((1, 2)), np.zeros((1, 2)), b, b, {'a': {'a'}}),\n"
        "                    PersistentModelManifest('m:C')])\n"
        "assert b'predictionio_tpu.templates.twotower.engine' in blob\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'predictionio_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
