"""The ML-100K quickstart through the port's DASE spine on the CPU, held
against the JAX package (``tests/test_ml100k_parity.py``'s pipeline).

The port writes the train split of ``synthesize_ml100k(42)`` (90 % of
100,000 ratings) as ``rate`` events into a temporary sqlite store once.
Then, on that one ``pio.db``:

* the port's ``RecommendationDataSource`` gives a ``TrainingData`` equal,
  array by array (bits and dtype) and ``BiMap`` by ``BiMap``, to the JAX
  package's;
* the port's ``run_train`` at the JAX test's engine.json (rank 10, 10
  iterations, lambda 0.1) meets that test's bars: test RMSE in
  [0.78, 0.88] and below the mean-only predictor's by more than 0.2;
* its factors agree with JAX ``train_als`` run from the same seeded draw
  on the same ``TrainingData`` within rtol 5e-3, atol 5e-4 (the ALS band
  of tests/test_als.py; rank 10 is not a multiple of 8, so both solve
  with Cholesky). ``jax.random``'s draw cannot be replayed in torch;
* a ``deploy --device cpu --port 0`` subprocess answers queries equal to
  the port's own ``predict`` on the same blob;
* a blob the JAX package trained into the same store, served by a second
  port ``deploy``, ranks like JAX ``ALSAlgorithm.predict``, except
  near-ties: two items whose float64 scores are within 1e-5 (relative);
* ``read_eval`` (evalK 2) gives the JAX package's folds: each fold's
  ``TrainingData`` bit for bit, the same queries and the same ``Actual``s;
* the port's ``pio eval`` of an ``Evaluation`` with ``PrecisionAtK(10)``
  scores within 1e-6 of the JAX package's ``run_evaluation`` of the same
  engine.json, whose ALS starts from the port's seeded draw (the
  ``jax.random`` draw cannot be replayed in torch); both record an
  EVALCOMPLETED ``EvaluationInstance``.
"""

import datetime as dt
import json
import os
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu.controller import Evaluation as JaxEvaluation
from predictionio_tpu.controller import EngineParamsGenerator as JaxEngineParamsGenerator
from predictionio_tpu.controller import local_context as jax_local_context
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.templates.recommendation import engine as jax_rec
from predictionio_tpu.templates.recommendation.engine import ALSAlgorithm as JaxALSAlgorithm
from predictionio_tpu.templates.recommendation.engine import DataSourceParams as JaxDataSourceParams
from predictionio_tpu.templates.recommendation.engine import Query as JaxQuery
from predictionio_tpu.templates.recommendation.engine import (
    RecommendationDataSource as JaxRecommendationDataSource,
)
from predictionio_tpu.utils.movielens import synthesize_ml100k as jax_ml100k
from predictionio_tpu.workflow import load_engine_variant as jax_load_variant
from predictionio_tpu.workflow import run_train as jax_run_train
from predictionio_tpu.workflow.core import run_evaluation as jax_run_evaluation
from predictionio_tpu_torch.controller import local_context
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.store import resolve_app
from predictionio_tpu_torch.ops.als import seed_factors
from predictionio_tpu_torch.templates.recommendation.engine import (
    DataSourceParams,
    Query,
    RecommendationDataSource,
)
from predictionio_tpu_torch.tools import commands, console
from predictionio_tpu_torch.utils.movielens import synthesize_ml100k
from predictionio_tpu_torch.workflow import load_engine_variant, run_train

ROOT = Path(__file__).resolve().parents[1]
APP = "ml100k"
RANK, ITERS, LAMBDA, SEED = 10, 10, 0.1, 1
RTOL, ATOL = 5e-3, 5e-4
NEAR_TIE = 1e-5
FACTORY = "predictionio_tpu.templates.recommendation:engine_factory"


def engine_json(engine_id: str) -> dict:
    return {
        "id": engine_id,
        "version": "1",
        "engineFactory": FACTORY,
        "datasource": {"params": {"appName": APP}},
        "algorithms": [{"name": "als", "params": {
            "rank": RANK, "numIterations": ITERS, "lambda": LAMBDA, "seed": SEED}}],
    }


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The train split as events in one sqlite store, both packages'
    registries pointed at it."""
    base = tmp_path_factory.mktemp("quickstart")
    env = {"PIO_FS_BASEDIR": str(base)}
    Storage.configure(env)
    JaxStorage.configure(env)
    u, i, r, _ = synthesize_ml100k(42)
    for got, ref in zip((u, i, r), jax_ml100k(42)):
        np.testing.assert_array_equal(got, ref)
    perm = np.random.default_rng(0).permutation(len(r))
    n_te = len(r) // 10
    tr, te = perm[n_te:], perm[:n_te]
    commands.app_new(APP, out=lambda line: None)
    app_id, _ = resolve_app(APP)
    t0 = dt.datetime(2020, 9, 13, tzinfo=dt.timezone.utc)
    events = [
        Event(event="rate", entity_type="user", entity_id=str(a), target_entity_type="item",
              target_entity_id=str(b), properties=DataMap({"rating": float(c)}), event_time=t0)
        for a, b, c in zip(u[tr].tolist(), i[tr].tolist(), r[tr].tolist())
    ]
    for lo in range(0, len(events), 10_000):
        Storage.get_l_events().insert_batch(events[lo : lo + 10_000], app_id)
    for name in ("port", "jax"):
        (base / f"{name}.json").write_text(json.dumps(engine_json(f"ml100k-{name}")))
    yield {"base": base, "env": env, "u": u, "i": i, "r": r, "tr": tr, "te": te}
    Storage.configure(None)
    JaxStorage.configure(None)


@pytest.fixture(scope="module")
def port_td(store):
    return RecommendationDataSource(DataSourceParams(app_name=APP)).read_training(local_context("cpu"))


@pytest.fixture(scope="module")
def trained(store):
    """The port's run_train, and the JAX package's, into the one store;
    then a port deploy subprocess for each instance."""
    inst = run_train(load_engine_variant(str(store["base"] / "port.json")), local_context("cpu"))
    jax_inst = jax_run_train(jax_load_variant(str(store["base"] / "jax.json")), jax_local_context())
    procs = {}
    env = dict(os.environ, **store["env"], PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    for name in ("port", "jax"):
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.tools.console", "deploy", "--engine-json",
             str(store["base"] / f"{name}.json"), "--ip", "127.0.0.1", "--port", "0", "--device", "cpu"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
    urls = {}
    try:
        for name, proc in procs.items():
            line = _first_line(proc, timeout_s=120)
            assert line.startswith("Bound port"), line
            urls[name] = f"http://127.0.0.1:{int(line.split()[-1])}"
        yield {"instance": inst, "jax_instance": jax_inst, "urls": urls}
    finally:
        for proc in procs.values():
            proc.terminate()
            proc.wait(timeout=30)


def _first_line(proc: subprocess.Popen, timeout_s: float) -> str:
    """The process's first line of output, or its stderr when it printed
    none within ``timeout_s`` seconds."""
    box: list = []
    reader = threading.Thread(target=lambda: box.append(proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(timeout_s)
    if not box or not box[0]:
        proc.kill()
        return "no line; stderr: " + proc.communicate(timeout=30)[1]
    return box[0]


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url + "/queries.json", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


def _dense(model, rank: int) -> tuple[np.ndarray, np.ndarray]:
    """Factors by the raw user/item id (0..942, 0..1681)."""
    uf = np.zeros((943, rank), np.float32)
    vf = np.zeros((1682, rank), np.float32)
    for key, row in model.user_index.to_dict().items():
        uf[int(key)] = np.asarray(model.user_factors)[row]
    for key, row in model.item_index.to_dict().items():
        vf[int(key)] = np.asarray(model.item_factors)[row]
    return uf, vf


def _rmse(uf, vf, u, i, r, idx) -> float:
    pred = np.einsum("nk,nk->n", uf[u[idx]], vf[i[idx]])
    return float(np.sqrt(np.mean((pred - r[idx]) ** 2)))


def _stored_model(instance_id: str):
    from predictionio_tpu_torch.templates.recommendation import engine_factory

    variant = load_engine_variant(engine_json("ml100k-port"))
    ep = variant.engine_params(engine_factory())
    blob = Storage.get_model_data_models().get(instance_id).models
    (_, model), = engine_factory().models_from_bytes(ep, instance_id, blob)
    return model, ep


def test_training_data_bit_equal_to_jax(store, port_td):
    ours = port_td
    ref = JaxRecommendationDataSource(JaxDataSourceParams(app_name=APP)).read_training(jax_local_context())
    for name in ("rows", "cols", "vals"):
        got, want = getattr(ours, name), getattr(ref, name)
        assert got.dtype == want.dtype and got.shape == want.shape == (store["tr"].size,), name
        np.testing.assert_array_equal(got, want)
    assert ours.user_index.to_dict() == ref.user_index.to_dict()
    assert ours.item_index.to_dict() == ref.item_index.to_dict()
    assert (len(ours.user_index), len(ours.item_index)) == (943, 1682)


def test_run_train_meets_the_jax_tests_rmse_bars(store, trained):
    inst = trained["instance"]
    assert inst.status == "COMPLETED" and inst.mesh_conf == {"device": "cpu"}
    assert sorted(json.loads(inst.env["phase_timings"])) == ["prepare", "read", "train:als"]
    model, _ = _stored_model(inst.id)
    uf, vf = _dense(model, RANK)
    u, i, r, tr, te = (store[k] for k in ("u", "i", "r", "tr", "te"))
    test_rmse = _rmse(uf, vf, u, i, r, te)
    mean_only = float(np.sqrt(np.mean((r[tr].mean() - r[te]) ** 2)))
    assert 0.78 <= test_rmse <= 0.88, test_rmse
    assert test_rmse < mean_only - 0.2, (test_rmse, mean_only)


def test_factors_match_jax_train_als_from_the_same_draw(port_td, trained):
    model, _ = _stored_model(trained["instance"].id)
    td = port_td
    assert model.user_index.to_dict() == td.user_index.to_dict()
    U, I = len(td.user_index), len(td.item_index)
    ref = jax_als.train_als(
        td.rows, td.cols, td.vals, U, I,
        jax_als.ALSConfig(rank=RANK, iterations=ITERS, reg=LAMBDA, solver="cholesky"),
        init_user=seed_factors(U, RANK, SEED, False),
        init_item=seed_factors(I, RANK, SEED + 1, False),
    )
    np.testing.assert_allclose(model.user_factors, np.asarray(ref.user), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(model.item_factors, np.asarray(ref.item), rtol=RTOL, atol=ATOL)


def test_deploy_answers_like_the_ports_predict(store, trained):
    from predictionio_tpu_torch.templates.recommendation import engine_factory

    model, ep = _stored_model(trained["instance"].id)
    _, [(algo, served)] = engine_factory().prepare_deploy(
        local_context("cpu"), ep, trained["instance"].id,
        Storage.get_model_data_models().get(trained["instance"].id).models)
    url = trained["urls"]["port"]
    for user in ("0", "1", "17", "400", "942"):
        want = algo.predict(served, Query(user=user, num=10)).to_json()
        assert _post(url, {"user": user, "num": 10}) == json.loads(json.dumps(want))
    assert _post(url, {"user": "nobody", "num": 4}) == {"itemScores": []}
    with urllib.request.urlopen(url + "/", timeout=30) as resp:
        status = json.loads(resp.read())
    assert status["engineInstanceId"] == trained["instance"].id and status["device"] == "cpu"
    assert status["engineFactory"] == FACTORY and status["engineId"] == "ml100k-port"
    assert status["queryCount"] == 6


def test_jax_trained_blob_served_by_the_port_ranks_like_jax(store, trained):
    from predictionio_tpu.templates.recommendation import engine_factory as jax_engine_factory

    jax_inst = trained["jax_instance"]
    assert jax_inst.status == "COMPLETED"
    jax_engine = jax_engine_factory()
    jax_ep = jax_load_variant(engine_json("ml100k-jax")).engine_params(jax_engine)
    blob = JaxStorage.get_model_data_models().get(jax_inst.id).models
    _, [(jax_algo, jax_model)] = jax_engine.prepare_deploy(jax_local_context(), jax_ep, jax_inst.id, blob)
    assert isinstance(jax_algo, JaxALSAlgorithm)
    U64 = np.asarray(jax_model.user_factors, np.float64)
    V64 = np.asarray(jax_model.item_factors, np.float64)
    url = trained["urls"]["jax"]
    bad = []
    for user in [str(x) for x in range(0, 943, 23)]:
        got = [s["item"] for s in _post(url, {"user": user, "num": 10})["itemScores"]]
        want = [s.item for s in jax_algo.predict(jax_model, JaxQuery(user=user, num=10)).item_scores]
        scores = V64 @ U64[jax_model.user_index[user]]
        idx = jax_model.item_index
        if len(got) != len(want) or any(
            g != w and abs(scores[idx[g]] - scores[idx[w]]) > NEAR_TIE * abs(scores[idx[w]])
            for g, w in zip(got, want)
        ):
            bad.append(user)
    assert not bad, f"{len(bad)} users rank differently from JAX predict: {bad[:5]}"
    with urllib.request.urlopen(url + "/", timeout=30) as resp:
        assert json.loads(resp.read())["engineInstanceId"] == jax_inst.id


# ------------------------------------------------------------------ eval
EVAL_MODULE = """
from predictionio_tpu_torch.controller import Evaluation
from predictionio_tpu_torch.templates.recommendation import PrecisionAtK, engine_factory
from predictionio_tpu_torch.workflow import load_engine_variant

ENGINE = engine_factory()
evaluation = Evaluation(engine=ENGINE, metric=PrecisionAtK(10))
evaluation.engine_params_list = [load_engine_variant({path!r}).engine_params(ENGINE)]
"""


class SeededJaxALS(JaxALSAlgorithm):
    """The JAX package's ALS, from the port's seeded draw."""

    def train(self, ctx, pd):
        p = self.params
        U, I = len(pd.user_index), len(pd.item_index)
        f = jax_als.train_als(
            pd.rows, pd.cols, pd.vals, U, I,
            jax_als.ALSConfig(rank=p.rank, iterations=p.num_iterations, reg=p.lambda_, solver="cholesky"),
            init_user=seed_factors(U, p.rank, p.seed, False), init_item=seed_factors(I, p.rank, p.seed + 1, False),
        )
        return jax_rec.ALSModel(np.asarray(f.user), np.asarray(f.item), pd.user_index, pd.item_index)


def _eval_json(store) -> str:
    path = store["base"] / "eval.json"
    body = engine_json("ml100k-eval")
    body["datasource"]["params"]["evalK"] = 2
    path.write_text(json.dumps(body))
    return str(path)


def test_read_eval_folds_equal_to_jax(store):
    ours = RecommendationDataSource(DataSourceParams(app_name=APP, eval_k=2)).read_eval(local_context("cpu"))
    ref = JaxRecommendationDataSource(JaxDataSourceParams(app_name=APP, eval_k=2)).read_eval(jax_local_context())
    assert len(ours) == len(ref) == 2
    for (td, ei, qa), (jtd, jei, jqa) in zip(ours, ref):
        for name in ("rows", "cols", "vals"):
            got, want = getattr(td, name), getattr(jtd, name)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert td.user_index.to_dict() == jtd.user_index.to_dict()
        assert td.item_index.to_dict() == jtd.item_index.to_dict()
        assert ei == jei
        assert [(q.user, q.num, a.items, a.seen) for q, a in qa] == [
            (q.user, q.num, a.items, a.seen) for q, a in jqa]
        assert len(qa) > 500


def test_pio_eval_precision_matches_jax(store, tmp_path, monkeypatch, capsys):
    path = _eval_json(store)
    (tmp_path / "rec_eval.py").write_text(EVAL_MODULE.format(path=path))
    monkeypatch.syspath_prepend(str(tmp_path))
    out = tmp_path / "best.json"
    assert console.main(["eval", "rec_eval:evaluation", "--device", "cpu", "--output-path", str(out)]) == 0
    assert "Precision@10" in capsys.readouterr().out
    score = json.loads(out.read_text())["bestScore"]["score"]
    (inst,) = [i for i in Storage.get_meta_data_evaluation_instances().get_all()
               if i.evaluation_class == "rec_eval:evaluation"]
    assert inst.status == "EVALCOMPLETED" and json.loads(inst.evaluator_results_json)["bestScore"]["score"] == score

    jax_engine = jax_rec.engine_factory()
    jax_engine.algorithms_class_map = {"als": SeededJaxALS}
    jax_ep = jax_load_variant(path).engine_params(jax_engine)
    jax_inst, jax_result = jax_run_evaluation(
        JaxEvaluation(engine=jax_engine, metric=jax_rec.PrecisionAtK(10)),
        JaxEngineParamsGenerator([jax_ep]), jax_local_context())
    assert jax_inst.status == "EVALCOMPLETED"
    assert abs(score - jax_result.best_score.score) <= 1e-6, (score, jax_result.best_score.score)
    assert 0.0 < score < 1.0
