"""The port's DASE spine on the CPU, held against the JAX package: the
controller (``Engine.train``, sanity checks, the ``stop_after_*`` flags,
timings), model blobs (``models_to_bytes``/``models_from_bytes``/
``prepare_deploy``, and blobs the JAX package wrote), ``run_train``'s
lineage on the memory and sqlite drivers, the ``engineFactory`` path
rewrite, one ``pio.db`` written by one package and read by the other,
and evaluation: ``Engine.eval``, ``MetricEvaluator`` (scores, ranking,
leaderboard, fold reuse) and ``run_evaluation``'s ``EvaluationInstance``.

The port's components below are a copy of ``tests/fake_dase.py`` on the
port's controller (the reference's ``Engine0`` pattern: integer-typed
TD/PD/Q/P), so each engine runs the same script in both packages and
their results must be equal.
"""

import dataclasses
import datetime as dt
import json
import pickle

import numpy as np
import pytest
import torch

import fake_dase as jax_fake
from predictionio_tpu.controller import AverageMetric as JaxAverageMetric
from predictionio_tpu.controller import EngineParamsGenerator as JaxEngineParamsGenerator
from predictionio_tpu.controller import Evaluation as JaxEvaluation
from predictionio_tpu.controller import MetricEvaluator as JaxMetricEvaluator
from predictionio_tpu.controller import OptionAverageMetric as JaxOptionAverageMetric
from predictionio_tpu.controller import ZeroMetric as JaxZeroMetric
from predictionio_tpu.controller import local_context as jax_local_context
from predictionio_tpu.data.aggregator import BiMap as JaxBiMap
from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage.base import App as JaxApp
from predictionio_tpu.templates.recommendation import engine_factory as jax_rec_factory
from predictionio_tpu.templates.recommendation.engine import ALSModel as JaxALSModel
from predictionio_tpu.utils.serialization import dumps_model as jax_dumps_model
from predictionio_tpu.workflow import load_engine_variant as jax_load_variant
from predictionio_tpu.workflow import run_train as jax_run_train
from predictionio_tpu.workflow.core import WorkflowParams as JaxWorkflowParams
from predictionio_tpu.workflow.core import _params_json as jax_params_json
from predictionio_tpu.workflow.core import run_evaluation as jax_run_evaluation
from predictionio_tpu_torch.controller import (
    AverageMetric,
    DataSource,
    Engine,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    FirstServing,
    LocalAlgorithm,
    MetricEvaluator,
    OptionAverageMetric,
    Params,
    PersistentModel,
    Preparator,
    SanityCheck,
    Serving,
    TorchAlgorithm,
    WorkflowContext,
    ZeroMetric,
    local_context,
    resolve_engine_factory,
)
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.templates.recommendation import engine_factory as rec_factory
from predictionio_tpu_torch.templates.recommendation.engine import ALSModel
from predictionio_tpu_torch.templates.twotower import engine_factory as tt_factory
from predictionio_tpu_torch.utils.serialization import dumps_model, loads_model
from predictionio_tpu_torch.workflow import WorkflowParams, load_engine_variant, run_evaluation, run_train
from predictionio_tpu_torch.workflow.core import params_json


# ------------------------------------------- a port copy of fake_dase.py
@dataclasses.dataclass(frozen=True)
class DSParams(Params):
    base: int = 10


@dataclasses.dataclass(frozen=True)
class AlgoParams(Params):
    mult: int = 2


@dataclasses.dataclass
class TD0(SanityCheck):
    value: int
    poisoned: bool = False

    def sanity_check(self) -> None:
        if self.poisoned:
            raise ValueError("poisoned training data")


#: which component ran, in order (cleared by each test that reads it)
CALLS: list = []


class DataSource0(DataSource):
    params_class = DSParams

    def read_training(self, ctx):
        CALLS.append("read")
        return TD0(self.params.base)

    def read_eval(self, ctx):
        # two folds; actual = query + base
        CALLS.append("read_eval")
        return [(TD0(self.params.base), {"fold": fold}, [(q, q + self.params.base) for q in range(3)])
                for fold in range(2)]


class Preparator0(Preparator):
    def prepare(self, ctx, td):
        CALLS.append("prepare")
        return td.value + 1  # PD = int


class Algo0(LocalAlgorithm):
    params_class = AlgoParams

    def train(self, ctx, pd):
        CALLS.append(f"train:{self.params.mult}")
        return pd * self.params.mult  # model = int

    def predict(self, model, query):
        return model + query


class ServingSum(Serving):
    def serve(self, query, predictions):
        return sum(predictions)


PERSISTED: dict = {}


class PersistentModel0(PersistentModel):
    def __init__(self, value: int):
        self.value = value

    def save(self, instance_id, params):
        PERSISTED[instance_id] = self.value
        return True

    @classmethod
    def load(cls, instance_id, params):
        return cls(PERSISTED[instance_id] + 100)


class PersistentAlgo0(LocalAlgorithm):
    params_class = AlgoParams

    def train(self, ctx, pd):
        return PersistentModel0(pd)

    def predict(self, model, query):
        return model.value + query


BUILDS: list = []


class TensorAlgo(TorchAlgorithm):
    """Trains a small table on its device, the context's."""

    params_class = AlgoParams

    def train(self, ctx, pd):
        return {"table": torch.full((2, 3), float(pd * self.params.mult), device=self.device)}

    def predict(self, model, query):
        return float(self.kernel("total", self.build_total)(model["table"])) + query

    @staticmethod
    def build_total():
        BUILDS.append("total")
        return torch.sum


def engine0() -> Engine:
    return Engine(
        datasource_class=DataSource0,
        preparator_class=Preparator0,
        algorithms_class_map={"a0": Algo0, "a1": Algo0},
        serving_class=ServingSum,
    )


def simple_params(mult_a0: int = 2, mult_a1: int = 3, base: int = 10) -> EngineParams:
    return EngineParams(
        datasource=DSParams(base=base),
        algorithms=(("a0", AlgoParams(mult=mult_a0)), ("a1", AlgoParams(mult=mult_a1))),
    )


def variant(factory: str) -> dict:
    return {
        "id": "fake-engine",
        "version": "0.1",
        "engineFactory": factory,
        "datasource": {"params": {"base": 10}},
        "algorithms": [{"name": "a0", "params": {"mult": 2}}, {"name": "a1", "params": {"mult": 3}}],
    }


CPU = local_context("cpu")


# ------------------------------------------------------- Engine.train
@pytest.mark.parametrize("mults", [(2, 3), (5, 1)])
def test_train_matches_jax_in_order_and_models(mults):
    CALLS.clear()
    models = engine0().train(CPU, simple_params(*mults))
    ref = jax_fake.engine0().train(jax_local_context(), jax_fake.simple_params(*mults))
    assert models == ref == [11 * mults[0], 11 * mults[1]]
    assert CALLS == ["read", "prepare", f"train:{mults[0]}", f"train:{mults[1]}"]


@pytest.mark.parametrize("flag,calls", [("stop_after_read", ["read"]), ("stop_after_prepare", ["read", "prepare"])])
def test_stop_after_flags_match_jax(flag, calls):
    CALLS.clear()
    timings, jax_timings = {}, {}
    assert engine0().train(CPU, simple_params(), timings=timings, **{flag: True}) == []
    assert jax_fake.engine0().train(
        jax_local_context(), jax_fake.simple_params(), timings=jax_timings, **{flag: True}
    ) == []
    assert CALLS == calls
    assert sorted(timings) == sorted(jax_timings) == sorted(calls)


def test_sanity_check_runs_and_is_skippable_like_jax():
    class PoisonDS(DataSource0):
        def read_training(self, ctx):
            return TD0(self.params.base, poisoned=True)

    class JaxPoisonDS(jax_fake.DataSource0):
        def read_training(self, ctx):
            return jax_fake.TD0(self.params.base, poisoned=True)

    eng, jax_eng = engine0(), jax_fake.engine0()
    eng.datasource_class, jax_eng.datasource_class = PoisonDS, JaxPoisonDS
    for e, ctx, ep in ((eng, CPU, simple_params()), (jax_eng, jax_local_context(), jax_fake.simple_params())):
        with pytest.raises(ValueError, match="poisoned"):
            e.train(ctx, ep, sanity_check=True)
        assert e.train(ctx, ep) == [22, 33]


def test_timings_keys_match_jax_with_a_repeated_algorithm():
    ep = EngineParams(datasource=DSParams(), algorithms=(("a0", AlgoParams(2)), ("a0", AlgoParams(3))))
    jax_ep = jax_fake.EngineParams(
        datasource=jax_fake.DSParams(), algorithms=(("a0", jax_fake.AlgoParams(2)), ("a0", jax_fake.AlgoParams(3)))
    )
    timings, jax_timings = {}, {}
    assert engine0().train(CPU, ep, timings=timings) == [22, 33]
    jax_fake.engine0().train(jax_local_context(), jax_ep, timings=jax_timings)
    assert sorted(timings) == sorted(jax_timings) == ["prepare", "read", "train:a0", "train:a0#1"]
    assert all(isinstance(v, float) and v >= 0 for v in timings.values())


def test_unknown_algorithm_and_params_errors():
    with pytest.raises(ValueError, match="Unknown algorithm"):
        engine0().train(CPU, EngineParams(algorithms=(("nope", AlgoParams()),)))
    with pytest.raises(ValueError, match="unknown algorithm"):
        engine0().params_from_json({"algorithms": [{"name": "zzz"}]})
    with pytest.raises(ValueError, match="unexpected key"):
        engine0().params_from_json({"datasource": {"base": 20}})
    assert engine0().params_from_json({}).algorithms == (("a0", AlgoParams()),)


def test_torch_algorithm_takes_the_context_device():
    BUILDS.clear()
    eng = Engine(DataSource0, Preparator0, {"t": TensorAlgo}, FirstServing)
    ep = EngineParams(datasource=DSParams(), algorithms=(("t", AlgoParams(2)),))
    (model,) = eng.train(CPU, ep)
    assert model["table"].device.type == "cpu"
    blob = eng.models_to_bytes("i-t", ep, [model])
    (_, stored), = loads_model(blob)
    assert isinstance(stored["table"], np.ndarray) and stored["table"].dtype == np.float32
    serving, [(algo, served)] = eng.prepare_deploy(CPU, ep, "i-t", blob)
    assert algo.device == torch.device("cpu") and isinstance(served["table"], torch.Tensor)
    assert serving.serve_base(1, [algo.predict_base(served, 1)]) == 6 * 22.0 + 1
    assert algo.predict_base(served, 2) == 6 * 22.0 + 2 and BUILDS == ["total"]  # built once
    if not torch.cuda.is_available():
        # the default context is the card: without one it raises, never
        # runs on the CPU quietly
        with pytest.raises(RuntimeError, match="cuda"):
            eng.train(WorkflowContext(), ep)
        with pytest.raises(RuntimeError, match="cuda"):
            local_context()


def test_context_device_is_resolved_and_matches_the_algorithm():
    assert CPU.device == torch.device("cpu")
    assert WorkflowContext(device="cpu").device == torch.device("cpu")
    assert dataclasses.replace(CPU, batch="b").device == torch.device("cpu")
    algo = TensorAlgo(AlgoParams(2), device="cpu")
    assert algo.train_base(CPU, 1)["table"].device.type == "cpu"
    algo.device = torch.device("cuda", 0)  # built for another device than the context's
    with pytest.raises(ValueError, match="the context is on cpu"):
        algo.train_base(CPU, 1)


# ---------------------------------------------------------- model blobs
def test_blob_round_trip_and_prepare_deploy():
    eng, ep = engine0(), simple_params()
    models = eng.train(CPU, ep)
    blob = eng.models_to_bytes("inst-1", ep, models)
    assert [m for _, m in eng.models_from_bytes(ep, "inst-1", blob)] == models
    serving, pairs = eng.prepare_deploy(CPU, ep, "inst-1", blob)
    assert [m for _, m in pairs] == models
    assert serving.serve_base(7, [a.predict_base(m, 7) for a, m in pairs]) == 55 + 14
    # the JAX package's blob of the same models reads back the same
    jax_eng, jax_ep = jax_fake.engine0(), jax_fake.simple_params()
    jax_blob = jax_eng.models_to_bytes("inst-1", jax_ep, jax_eng.train(jax_local_context(), jax_ep))
    assert [m for _, m in eng.models_from_bytes(ep, "inst-1", jax_blob)] == models
    with pytest.raises(ValueError, match="align 1:1"):
        eng.models_to_bytes("i", ep, [1])
    short = EngineParams(datasource=DSParams(), algorithms=(("a0", AlgoParams()),))
    with pytest.raises(ValueError, match="declare 1 algorithms"):
        eng.prepare_deploy(CPU, short, "inst-1", blob)


def test_persistent_model_path():
    PERSISTED.clear()
    eng = engine0()
    eng.algorithms_class_map = {"a0": PersistentAlgo0}
    eng.serving_class = FirstServing
    ep = EngineParams(datasource=DSParams(), algorithms=(("a0", AlgoParams()),))
    blob = eng.models_to_bytes("inst-2", ep, eng.train(CPU, ep))
    assert PERSISTED == {"inst-2": 11}
    _, [(_, model)] = eng.prepare_deploy(CPU, ep, "inst-2", blob)
    assert model.value == 111  # loaded, not pickled


def _jax_als_model(seed: int = 0) -> JaxALSModel:
    rng = np.random.default_rng(seed)
    return JaxALSModel(
        user_factors=rng.normal(size=(4, 3)).astype(np.float32),
        item_factors=rng.normal(size=(5, 3)).astype(np.float32),
        user_index=JaxBiMap.string_index(["u1", "u2", "u3", "u4"]),
        item_index=JaxBiMap.string_index([f"i{i}" for i in range(5)]),
    )


def test_jax_blob_reads_as_the_ports_classes():
    ref = _jax_als_model()
    (kind, model), = loads_model(jax_dumps_model([("pickle", ref)]))
    assert kind == "pickle" and type(model) is ALSModel
    assert type(model.user_index) is BiMap and type(model.item_index) is BiMap
    np.testing.assert_array_equal(model.user_factors, ref.user_factors)
    np.testing.assert_array_equal(model.item_factors, ref.item_factors)
    assert model.user_index.to_dict() == ref.user_index.to_dict()
    assert model.item_index.inverse(4) == "i4"
    # the port's own blob of the same model holds the same arrays and maps
    (_, again), = loads_model(dumps_model([("pickle", model)]))
    np.testing.assert_array_equal(again.item_factors, ref.item_factors)
    assert again.item_index.to_dict() == ref.item_index.to_dict()


@pytest.mark.parametrize("module,name", [
    ("predictionio_tpu.controller.params", "EmptyParams"),  # exists in the JAX package
    ("predictionio_tpu.no_such_module", "Anything"),  # would fail to import if tried
])
def test_loads_model_refuses_other_jax_classes_without_importing(module, name):
    # GLOBAL module name, STOP: the pickle of the class itself
    blob = b"PIOTPU1\x00c" + module.encode() + b"\n" + name.encode() + b"\n."
    with pytest.raises(pickle.UnpicklingError, match="no counterpart"):
        loads_model(blob)


def test_loads_model_rejects_a_bad_magic():
    with pytest.raises(ValueError, match="bad magic"):
        loads_model(b"nope")


# ------------------------------------------------------ factory paths
@pytest.mark.parametrize("path", [
    "predictionio_tpu.templates.recommendation:engine_factory",
    "predictionio_tpu.templates.recommendation.engine_factory",
    "predictionio_tpu_torch.templates.recommendation:engine_factory",
])
def test_jax_factory_path_resolves_to_the_port(path):
    factory = resolve_engine_factory(path)
    assert factory is rec_factory
    eng = factory()
    assert eng.algorithms_class_map["als"].__module__.startswith("predictionio_tpu_torch.")


def test_jax_two_tower_factory_path_resolves_to_the_port():
    factory = resolve_engine_factory("predictionio_tpu.templates.twotower:engine_factory")
    assert factory is tt_factory
    assert factory().algorithms_class_map["twotower"].__module__ == "predictionio_tpu_torch.templates.twotower.engine"


@pytest.mark.parametrize("path", [
    "predictionio_tpu.data.storage.remote:engine_factory",  # the port's module lacks the name
    "predictionio_tpu.templates.classification:no_such_factory",  # the port's module lacks the name
])
def test_factory_without_a_port_counterpart_fails_clearly(path):
    with pytest.raises(ImportError, match="no counterpart in the port"):
        resolve_engine_factory(path)


def test_params_json_matches_jax_for_the_same_engine_json():
    raw = {
        "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
        "datasource": {"params": {"appName": "MyApp"}},
        "algorithms": [{"name": "als", "params": {"rank": 32, "numIterations": 10, "lambda": 0.05}}],
    }
    ours = params_json(load_engine_variant(raw).engine_params(rec_factory()))
    ref = jax_params_json(jax_load_variant(raw).engine_params(jax_rec_factory()))
    assert ours == ref


# ------------------------------------------------------------- run_train
def _configure(driver: str, tmp_path) -> dict:
    if driver == "memory":
        env = {
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
            "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        }
    else:  # the zero-config default: sqlite + localfs under the base dir
        env = {"PIO_FS_BASEDIR": str(tmp_path / "base")}
    Storage.configure(env)
    JaxStorage.configure(env)
    return env


@pytest.fixture
def both_stores():
    yield
    Storage.configure(None)
    JaxStorage.configure(None)


class BoomAlgo(Algo0):
    def train(self, ctx, pd):
        raise KeyError("train exploded")


def boom_engine() -> Engine:
    return Engine(DataSource0, Preparator0, {"a0": BoomAlgo, "a1": BoomAlgo}, ServingSum)


@pytest.mark.parametrize("driver", ["memory", "sqlite"])
def test_run_train_completed_lineage_matches_jax(driver, tmp_path, both_stores):
    _configure(driver, tmp_path)
    inst = run_train(load_engine_variant(variant("test_torch_dase:engine0")), CPU, WorkflowParams(batch="b1"))
    ref = jax_run_train(jax_load_variant(variant("fake_dase:engine0")), jax_local_context(),
                        JaxWorkflowParams(batch="b1"))
    assert inst.status == ref.status == "COMPLETED"
    for field in ("batch", "engine_id", "engine_version", "engine_variant",
                  "datasource_params", "preparator_params", "algorithms_params", "serving_params"):
        assert getattr(inst, field) == getattr(ref, field), field
    assert sorted(json.loads(inst.env["phase_timings"])) == sorted(json.loads(ref.env["phase_timings"]))
    assert inst.mesh_conf == {"device": "cpu"}
    repo = Storage.get_meta_data_engine_instances()
    assert repo.get_latest_completed("fake-engine", "0.1", "fake-engine").id in (inst.id, ref.id)
    assert repo.get(inst.id).status == "COMPLETED"
    ep = simple_params()
    assert [m for _, m in engine0().models_from_bytes(ep, inst.id, Storage.get_model_data_models().get(inst.id).models)] == [22, 33]
    if driver == "sqlite":  # one store on disk: the JAX run's blob, read by the port
        jax_blob = Storage.get_model_data_models().get(ref.id).models
        assert [m for _, m in engine0().models_from_bytes(ep, ref.id, jax_blob)] == [22, 33]


@pytest.mark.parametrize("driver", ["memory", "sqlite"])
def test_run_train_failed_and_stopped_lineage(driver, tmp_path, both_stores, monkeypatch):
    _configure(driver, tmp_path)
    import sys

    monkeypatch.setattr(sys.modules[__name__], "engine0", boom_engine)
    with pytest.raises(KeyError, match="exploded"):
        run_train(load_engine_variant(variant("test_torch_dase:engine0")), CPU)
    monkeypatch.undo()
    stopped = run_train(load_engine_variant(variant("test_torch_dase:engine0")), CPU,
                        WorkflowParams(stop_after_prepare=True))
    statuses = sorted(i.status for i in Storage.get_meta_data_engine_instances().get_all())
    assert statuses == ["FAILED", "STOPPED"]
    assert stopped.status == "STOPPED" and Storage.get_model_data_models().get(stopped.id) is None
    assert Storage.get_meta_data_engine_instances().get_latest_completed("fake-engine", "0.1", "fake-engine") is None


# --------------------------------------------- one pio.db, both packages
T0 = dt.datetime(2021, 5, 1, tzinfo=dt.timezone.utc)


def _events(event_cls, map_cls, n: int):
    return [
        event_cls(event="rate", entity_type="user", entity_id=f"u{k % 3}", target_entity_type="item",
                  target_entity_id=f"i{k}", properties=map_cls({"rating": float(k % 5 + 1)}),
                  event_time=T0 + dt.timedelta(seconds=k))
        for k in range(n)
    ]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_one_sqlite_store_written_by_one_package_read_by_the_other(writer, tmp_path, both_stores):
    _configure("sqlite", tmp_path)
    w, r = (JaxStorage, Storage) if writer == "jax" else (Storage, JaxStorage)
    app_cls, ev, dm = (JaxApp, JaxEvent, JaxDataMap) if writer == "jax" else (App, Event, DataMap)
    app_id = w.get_meta_data_apps().insert(app_cls(id=0, name="shared", description="both"))
    w.get_l_events().init(app_id)
    ids = w.get_l_events().insert_batch(_events(ev, dm, 7), app_id)
    if writer == "jax":
        inst = jax_run_train(jax_load_variant(variant("fake_dase:engine0")), jax_local_context())
    else:
        inst = run_train(load_engine_variant(variant("test_torch_dase:engine0")), CPU)
    app = r.get_meta_data_apps().get_by_name("shared")
    assert (app.id, app.description) == (app_id, "both")
    got = list(r.get_l_events().find(app_id))
    assert sorted(e.event_id for e in got) == sorted(ids)
    assert sorted((e.entity_id, e.target_entity_id, e.properties.to_dict()["rating"]) for e in got) == sorted(
        (f"u{k % 3}", f"i{k}", float(k % 5 + 1)) for k in range(7)
    )
    cols = r.get_p_events().find_columns(app_id, entity_type="user", event_names=["rate"], prop="rating")
    assert len(cols) == 7 and sorted(cols.prop.tolist()) == sorted(float(k % 5 + 1) for k in range(7))
    read_inst = r.get_meta_data_engine_instances().get_latest_completed("fake-engine", "0.1", "fake-engine")
    assert read_inst.id == inst.id and read_inst.algorithms_params == inst.algorithms_params
    assert r.get_model_data_models().get(inst.id).models == w.get_model_data_models().get(inst.id).models


# ------------------------------------------------------------ evaluation
class MAE(AverageMetric):
    def header(self) -> str:
        return "MAE"

    def calculate_unit(self, q, p, a):
        return -abs(p - a)


class JaxMAE(JaxAverageMetric):
    header = MAE.header
    calculate_unit = MAE.calculate_unit


def _candidates(ep_cls, ds_cls, algo_cls, mults=(5, 1, 3), bases=(10, 10, 99)) -> list:
    return [ep_cls(datasource=ds_cls(base=b), algorithms=(("a0", algo_cls(mult=m)),)) for m, b in zip(mults, bases)]


def _first_serving_engines():
    eng, jax_eng = engine0(), jax_fake.engine0()
    eng.serving_class, jax_eng.serving_class = FirstServing, jax_fake.FirstServing
    return eng, jax_eng


@pytest.mark.parametrize("mults", [(2, 3), (5, 1)])
def test_engine_eval_matches_jax(mults):
    CALLS.clear()
    got = engine0().eval(CPU, simple_params(*mults))
    ref = jax_fake.engine0().eval(jax_local_context(), jax_fake.simple_params(*mults))
    assert got == ref
    assert [ei for ei, _ in got] == [{"fold": 0}, {"fold": 1}]
    # p = (11·m0 + q) + (11·m1 + q), actual = q + 10
    assert got[0][1] == [(q, 11 * sum(mults) + 2 * q, q + 10) for q in range(3)]
    assert CALLS == ["read_eval", "prepare", f"train:{mults[0]}", f"train:{mults[1]}",
                     "prepare", f"train:{mults[0]}", f"train:{mults[1]}"]


def test_engine_eval_supplements_once_like_jax():
    class SupplServing(Serving):
        def supplement(self, query):
            return {"q": query, "extra": 100}

        def serve(self, query, predictions):
            return predictions[0] + query["extra"]

    class DictAlgo(Algo0):
        def predict(self, model, query):
            return model + query["q"]

    class JaxSupplServing(jax_fake.Serving):
        supplement = SupplServing.supplement
        serve = SupplServing.serve

    class JaxDictAlgo(jax_fake.Algo0):
        predict = DictAlgo.predict

    eng, jax_eng = engine0(), jax_fake.engine0()
    eng.serving_class, eng.algorithms_class_map = SupplServing, {"a0": DictAlgo}
    jax_eng.serving_class, jax_eng.algorithms_class_map = JaxSupplServing, {"a0": JaxDictAlgo}
    got = eng.eval(CPU, EngineParams(datasource=DSParams(), algorithms=(("a0", AlgoParams()),)))
    ref = jax_eng.eval(jax_local_context(), jax_fake.EngineParams(
        datasource=jax_fake.DSParams(), algorithms=(("a0", jax_fake.AlgoParams()),)))
    assert got == ref
    assert got[0][1][1] == ({"q": 1, "extra": 100}, 22 + 1 + 100, 11)


@pytest.mark.parametrize("other", [False, True])
def test_metric_evaluator_matches_jax(other, tmp_path):
    eng, jax_eng = _first_serving_engines()
    out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    result = MetricEvaluator(MAE(), [ZeroMetric()] if other else [], output_path=str(out)).evaluate_base(
        CPU, eng, _candidates(EngineParams, DSParams, AlgoParams))
    ref = JaxMetricEvaluator(JaxMAE(), [JaxZeroMetric()] if other else [], output_path=str(jax_out)).evaluate_base(
        jax_local_context(), jax_eng, _candidates(jax_fake.EngineParams, jax_fake.DSParams, jax_fake.AlgoParams))
    assert [s.score for _, s in result.engine_params_scores] == [s.score for _, s in ref.engine_params_scores]
    assert [s.other_scores for _, s in result.engine_params_scores] == [
        s.other_scores for _, s in ref.engine_params_scores]
    assert (result.best_index, result.ranking, result.metric_header, result.other_metric_headers) == (
        ref.best_index, ref.ranking, ref.metric_header, ref.other_metric_headers)
    assert result.best_index == 1 and result.best_score.score == -1.0

    def no_seconds(doc: dict) -> dict:
        for entry in doc["engineParamsScores"]:
            entry.pop("seconds")
        return doc

    assert no_seconds(json.loads(out.read_text())) == no_seconds(json.loads(jax_out.read_text()))

    # the same text once each candidate's wall seconds are the other package's
    result = dataclasses.replace(result, engine_params_scores=tuple(
        (ep, dataclasses.replace(s, seconds=js.seconds))
        for (ep, s), (_, js) in zip(result.engine_params_scores, ref.engine_params_scores)))
    assert result.leaderboard() == ref.leaderboard()
    assert "<== BEST" in result.leaderboard().splitlines()[1]


def test_metric_evaluator_scores_the_same_triples_exactly():
    # the same (Q, P, A) triples through both packages' metric classes
    rng = np.random.default_rng(7)
    data = [({"fold": f}, [(int(q), float(p), float(a)) for q, p, a in rng.normal(size=(20, 3))]) for f in range(3)]

    class Opt(OptionAverageMetric):
        def calculate_unit(self, q, p, a):
            return None if q == 0 else p * a

    class JaxOpt(JaxOptionAverageMetric):
        calculate_unit = Opt.calculate_unit

    assert MAE().calculate(CPU, data) == JaxMAE().calculate(jax_local_context(), data)
    assert Opt().calculate(CPU, data) == JaxOpt().calculate(jax_local_context(), data)


def test_fold_reuse_reads_once_per_datasource_config():
    eng, _ = _first_serving_engines()
    CALLS.clear()
    result = MetricEvaluator(MAE()).evaluate_base(CPU, eng, _candidates(EngineParams, DSParams, AlgoParams))
    assert CALLS.count("read_eval") == 2  # bases 10, 10, 99
    assert len(result.engine_params_scores) == 3 and "s]" in result.leaderboard()


@pytest.mark.parametrize("driver", ["memory", "sqlite"])
def test_run_evaluation_instance_matches_jax(driver, tmp_path, both_stores):
    _configure(driver, tmp_path)
    eng, jax_eng = _first_serving_engines()
    inst, result = run_evaluation(
        Evaluation(engine=eng, metric=MAE()),
        EngineParamsGenerator(_candidates(EngineParams, DSParams, AlgoParams)),
        CPU, WorkflowParams(batch="b2"), evaluation_class="my.Evaluation")
    ref, jax_result = jax_run_evaluation(
        JaxEvaluation(engine=jax_eng, metric=JaxMAE()),
        JaxEngineParamsGenerator(_candidates(jax_fake.EngineParams, jax_fake.DSParams, jax_fake.AlgoParams)),
        jax_local_context(), JaxWorkflowParams(batch="b2"), evaluation_class="my.Evaluation")
    assert inst.status == ref.status == "EVALCOMPLETED"
    for field in ("evaluation_class", "engine_params_generator_class", "batch", "env", "evaluator_results_html"):
        assert getattr(inst, field) == getattr(ref, field), field
    stored = Storage.get_meta_data_evaluation_instances().get(inst.id)
    assert stored.status == "EVALCOMPLETED" and stored.evaluator_results == result.leaderboard()
    doc, jax_doc = json.loads(stored.evaluator_results_json), json.loads(ref.evaluator_results_json)
    for d in (doc, jax_doc):
        for entry in d["engineParamsScores"]:
            entry.pop("seconds")
    assert doc == jax_doc and doc["bestIdx"] == 1


def test_run_evaluation_failed_instance(tmp_path, both_stores):
    _configure("memory", tmp_path)

    class Boom(MAE):
        def calculate_unit(self, q, p, a):
            raise KeyError("metric exploded")

    eng, _ = _first_serving_engines()
    with pytest.raises(KeyError, match="exploded"):
        run_evaluation(Evaluation(engine=eng, metric=Boom()),
                       EngineParamsGenerator(_candidates(EngineParams, DSParams, AlgoParams)), CPU)
    (inst,) = Storage.get_meta_data_evaluation_instances().get_all()
    assert inst.status == "FAILED"
