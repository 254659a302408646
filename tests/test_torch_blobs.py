"""One model-blob format for both packages, on the CPU.

The port writes the classes the two packages share (``ALSModel``,
``BiMap``, ``TwoTowerServingModel``, ``PersistentModelManifest``, and
for the four other templates ``SimilarProductModel``, ``ECommModel``,
the classifiers' ``NaiveBayesModel``/``LogRegModel`` and the fitted
``HashingTfIdf``) under the JAX package's paths, so:

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
from predictionio_tpu.ops import classify as jax_classify
from predictionio_tpu.ops import text as jax_text
from predictionio_tpu.templates.ecommerce import engine as jax_ec
from predictionio_tpu.templates.recommendation import engine as jax_rec
from predictionio_tpu.templates.similarproduct import engine as jax_sp
from predictionio_tpu.templates.twotower import engine as jax_tt
from predictionio_tpu.utils.serialization import dumps_model as jax_dumps_model
from predictionio_tpu.utils.serialization import loads_model as jax_loads_model
from predictionio_tpu_torch.controller.persistent import PersistentModelManifest
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.ops import classify as port_classify
from predictionio_tpu_torch.ops.text import HashingTfIdf, fit_tfidf
from predictionio_tpu_torch.templates.ecommerce.engine import ECommModel
from predictionio_tpu_torch.templates.recommendation.engine import ALSModel
from predictionio_tpu_torch.templates.similarproduct.engine import SimilarProductModel
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
        "similarproduct": SimilarProductModel(rng.random((ITEMS, RANK), dtype=np.float32), items,
                                              {"i1": ("a", "b"), "i2": ()}),
        "ecommerce": ECommModel(rng.random((USERS, RANK), dtype=np.float32), rng.random((ITEMS, RANK), dtype=np.float32),
                                users, items, {"i3": ("c",)}, rng.integers(0, 9, ITEMS).astype(np.float32)),
        # the classifiers' model dicts, as their train returns them
        "classification": {
            "lr": port_classify.LogRegModel(rng.random((3, 4), dtype=np.float32), rng.random(4, dtype=np.float32)),
            "mean": rng.random(3, dtype=np.float32), "std": rng.random(3, dtype=np.float32),
            "label_index": BiMap.string_index(["a", "b", "c", "d"]), "attributes": ("attr0", "attr1", "attr2"),
        },
        "textclassification": {
            # a tensor leaf, as the model holds once placed on its device
            "nb": port_classify.NaiveBayesModel(torch.from_numpy(rng.random(2, dtype=np.float32)),
                                                rng.random((2, 16), dtype=np.float32)),
            "label_index": BiMap.string_index(["x", "y"]),
            "featurizer": fit_tfidf(["a b", "b c c"], num_features=16, stopwords=("c",)),
        },
    }


JAX_CLASSES = {"als": jax_rec.ALSModel, "twotower": jax_tt.TwoTowerServingModel, "manifest": JaxManifest,
               "similarproduct": jax_sp.SimilarProductModel, "ecommerce": jax_ec.ECommModel,
               "classification": dict, "textclassification": dict}
PORT_CLASSES = {"als": ALSModel, "twotower": TwoTowerServingModel, "manifest": PersistentModelManifest,
                "similarproduct": SimilarProductModel, "ecommerce": ECommModel,
                "classification": dict, "textclassification": dict}
#: the classes inside a classifier's model dict, by key: the JAX
#: package's, then the port's
INNER = {"lr": (jax_classify.LogRegModel, port_classify.LogRegModel),
         "nb": (jax_classify.NaiveBayesModel, port_classify.NaiveBayesModel),
         "featurizer": (jax_text.HashingTfIdf, HashingTfIdf),
         "label_index": (JaxBiMap, BiMap)}


def _plain(v):
    """A model value as plain data: maps as dicts, arrays as numpy,
    NamedTuples as tuples of plain values."""
    if isinstance(v, (BiMap, JaxBiMap)):
        return ("bimap", v.to_dict())
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return tuple(_plain(t) for t in v)
    return v


def _fields(obj) -> dict:
    """Each field of a model (a dataclass, or a classifier's dict) as plain
    data (arrays as numpy, maps as dicts, NamedTuples as tuples)."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _assert_same_value(a, b, name) -> None:
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), name
        np.testing.assert_array_equal(a, b)
    elif isinstance(b, tuple) and any(isinstance(t, np.ndarray) for t in b):
        assert isinstance(a, tuple) and len(a) == len(b), name
        for x, y in zip(a, b):
            _assert_same_value(x, y, name)
    else:
        assert a == b, name


def _assert_same_fields(got, want) -> None:
    a, b = _fields(got), _fields(want)
    assert a.keys() == b.keys()
    for name in a:
        _assert_same_value(a[name], b[name], name)


def _assert_inner_classes(model, package: int) -> None:
    """A classifier dict's NamedTuples and BiMap are the package's own
    (0: the JAX package, 1: the port)."""
    if isinstance(model, dict):
        for key, value in model.items():
            if key in INNER:
                assert type(value) is INNER[key][package], key


@pytest.mark.parametrize("kind", sorted(JAX_CLASSES))
def test_port_blob_reads_as_the_jax_packages_classes(kind):
    model = _port_models()[kind]
    (tag, got), = jax_loads_model(dumps_model([("pickle", model)]))
    assert tag == "pickle" and type(got) is JAX_CLASSES[kind]
    for name in ("user_index", "item_index"):
        if hasattr(got, name):
            assert type(getattr(got, name)) is JaxBiMap
    _assert_inner_classes(got, 0)
    _assert_same_fields(got, model)


@pytest.mark.parametrize("kind", sorted(PORT_CLASSES))
def test_port_reads_its_own_and_jax_blobs_as_its_classes(kind):
    model = _port_models()[kind]
    (_, own), = loads_model(dumps_model([("pickle", model)]))
    assert type(own) is PORT_CLASSES[kind]
    _assert_inner_classes(own, 1)
    _assert_same_fields(own, model)
    (_, jax_model), = jax_loads_model(dumps_model([("pickle", model)]))
    (_, back), = loads_model(jax_dumps_model([("pickle", jax_model)]))
    assert type(back) is PORT_CLASSES[kind]
    _assert_inner_classes(back, 1)
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
        "from predictionio_tpu_torch.templates.similarproduct.engine import SimilarProductModel\n"
        "from predictionio_tpu_torch.templates.ecommerce.engine import ECommModel\n"
        "from predictionio_tpu_torch.ops.classify import LogRegModel, NaiveBayesModel\n"
        "from predictionio_tpu_torch.ops.text import fit_tfidf\n"
        "from predictionio_tpu_torch.utils.serialization import dumps_model\n"
        "b = BiMap({'a': 0})\n"
        "z = np.zeros((1, 2))\n"
        "blob = dumps_model([ALSModel(z, z, b, b),\n"
        "                    TwoTowerServingModel(z, z, b, b, {'a': {'a'}}),\n"
        "                    PersistentModelManifest('m:C'), SimilarProductModel(z, b, {}),\n"
        "                    ECommModel(z, z, b, b, {}, np.zeros(1)),\n"
        "                    {'nb': NaiveBayesModel(z, z), 'lr': LogRegModel(z, z), 'featurizer': fit_tfidf(['a'], 4)}])\n"
        "for path in ('twotower.engine', 'similarproduct.engine', 'ecommerce.engine'):\n"
        "    assert b'predictionio_tpu.templates.' + path.encode() in blob\n"
        "assert b'predictionio_tpu.ops.classify' in blob and b'predictionio_tpu.ops.text' in blob\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'predictionio_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
