"""The port's Recommendation slice on the CPU, end to end, against the JAX
package: ratings -> ``ALSAlgorithm.train`` -> ``predict`` -> HTTP
``POST /queries.json``, on the ML-100K structural replica.

* The engine trains at its default rank 10. K % 8 != 0, so both packages
  solve with Cholesky there (the Gauss-Jordan path is held against the
  JAX kernel in test_torch_solve.py and test_torch_als.py). The JAX side
  runs ``train_als`` from the port's seeded draw, since ``jax.random``'s
  draw cannot be replayed in torch. Factors agree at the ALS band, rtol
  5e-3, atol 5e-4 (tests/test_als.py). Each top-10 equals JAX
  ``top_k_items`` except where the two items' scores lie within the
  score difference that the two sets of factors show for that user.
* A JAX-trained model carried across by ``convert.py`` holds the same
  factors, so there each top-10 equals JAX's except near-ties: two items
  whose float64 scores are within 1e-5 of each other (relative).
* The HTTP body has the shape of the JAX package's ``_result_to_json``:
  the engine trains through ``run_train`` (a ``SimpleEngine`` whose
  DataSource hands over the ratings already made) into a temporary store,
  and a ``QueryService`` serves the stored instance.
"""

import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.controller.params import params_from_json as jax_params_from_json
from predictionio_tpu.data.aggregator import BiMap as JaxBiMap
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.templates.recommendation.engine import ALSAlgorithmParams as JaxALSParams
from predictionio_tpu.templates.results import ItemScore as JaxItemScore
from predictionio_tpu.templates.results import PredictedResult as JaxPredictedResult
from predictionio_tpu.utils.movielens import synthesize_ml100k as jax_ml100k
from predictionio_tpu.workflow.serving import _result_to_json as jax_result_to_json
from predictionio_tpu_torch.controller.context import local_context
from predictionio_tpu_torch.controller.params import params_from_json
from predictionio_tpu_torch.convert import als_model_from_numpy, als_model_to_numpy
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.ops.als import seed_factors
from predictionio_tpu_torch.templates.recommendation.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    Query,
    TrainingData,
)
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.utils.movielens import ml20m_shaped, synthesize_ml100k
from predictionio_tpu_torch.workflow import run_train
from predictionio_tpu_torch.workflow.serving import QueryServer, QueryService
from torch_arrays_engine import arrays_engine, arrays_variant

RTOL, ATOL = 5e-3, 5e-4
NEAR_TIE = 1e-5
TOP = 10
ENGINE_JSON = {"rank": 10, "numIterations": 3, "lambda": 0.01, "seed": 3}


@pytest.fixture(scope="module")
def slice_run():
    users, items, ratings, _ = synthesize_ml100k(42)
    for got, ref in zip((users, items, ratings), jax_ml100k(42)):
        np.testing.assert_array_equal(got, ref)
    td = TrainingData(
        rows=users, cols=items, vals=ratings,
        user_index=BiMap.string_index(f"u{u}" for u in range(users.max() + 1)),
        item_index=BiMap.string_index(f"i{i}" for i in range(items.max() + 1)),
    )
    params = ALSAlgorithmParams.from_json(ENGINE_JSON)
    algo = ALSAlgorithm(params, device="cpu")
    model = algo.train(local_context("cpu"), td)
    U, I = len(td.user_index), len(td.item_index)
    ref = jax_als.train_als(
        users, items, ratings, U, I,
        jax_als.ALSConfig(rank=params.rank, iterations=params.num_iterations, reg=params.lambda_, solver="cholesky"),
        init_user=seed_factors(U, params.rank, params.seed, False),
        init_item=seed_factors(I, params.rank, params.seed + 1, False),
    )
    trained = {"user": model.user_factors.copy(), "item": model.item_factors.copy()}
    model = algo.prepare_model_for_serving(model)
    return {
        "td": td, "algo": algo, "model": model, "trained": trained,
        "jax_user": np.asarray(ref.user), "jax_item": np.asarray(ref.item),
    }


#: (what, thread) the recording algorithm saw, in order
CALLS: list = []


class RecordingALS(ALSAlgorithm):
    """Records the thread of each warm-up and each served query."""

    def warm_up(self, model):
        CALLS.append(("warm", threading.get_ident()))
        super().warm_up(model)

    def predict_base(self, model, query):
        CALLS.append(("predict", threading.get_ident()))
        return super().predict_base(model, query)


@pytest.fixture(scope="module")
def served(slice_run, tmp_path_factory):
    """``slice_run``'s ratings trained through ``run_train`` into a
    temporary store; the stored instance loaded by a ``QueryService`` and
    by ``prepare_deploy`` (to compare with)."""
    Storage.configure({"PIO_FS_BASEDIR": str(tmp_path_factory.mktemp("rec_served"))})
    variant = arrays_variant("rec", slice_run["td"], RecordingALS, ENGINE_JSON)
    try:
        inst = run_train(variant, local_context("cpu"))
        service = QueryService(variant, local_context("cpu"))
        engine = arrays_engine()
        _, [(algo, model)] = engine.prepare_deploy(
            local_context("cpu"), variant.engine_params(engine), inst.id,
            Storage.get_model_data_models().get(inst.id).models)
        yield {"service": service, "variant": variant, "algo": algo, "model": model, "instance": inst}
    finally:
        Storage.configure(None)


def _jax_top(user_vec: np.ndarray, item_factors: np.ndarray) -> list:
    ids, _ = jax_als.top_k_items(jnp.asarray(user_vec), jnp.asarray(item_factors), TOP)
    return np.asarray(ids).tolist()


def _same_ranking(got: list, ref: list, scores: np.ndarray, band) -> bool:
    """Equal ids, except where the two items' reference scores differ by
    at most ``band(score)``."""
    if len(got) != len(ref):
        return False
    return all(g == r or abs(scores[g] - scores[r]) <= band(scores[r]) for g, r in zip(got, ref))


def _ids(result, item_index) -> list:
    return [item_index[s.item] for s in result.item_scores]


def test_params_parse_like_jax():
    ours = params_from_json(ALSAlgorithmParams, ENGINE_JSON)
    ref = jax_params_from_json(JaxALSParams, ENGINE_JSON)
    for field in ("rank", "num_iterations", "lambda_", "seed", "implicit_prefs", "alpha"):
        assert getattr(ours, field) == getattr(ref, field)
    assert ours.to_json()["numIterations"] == 3 and ours.to_json()["lambda"] == 0.01


def test_engine_train_matches_jax_train_als(slice_run):
    np.testing.assert_allclose(slice_run["trained"]["user"], slice_run["jax_user"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(slice_run["trained"]["item"], slice_run["jax_item"], rtol=RTOL, atol=ATOL)
    # on the CPU, which the caller asked for, the model serves from host
    # numpy, the JAX package's host branch
    model = slice_run["model"]
    assert isinstance(model.user_factors, np.ndarray) and isinstance(model.item_factors, np.ndarray)


def test_engine_predict_ranks_like_jax_top_k_items(slice_run):
    td, algo, model = slice_run["td"], slice_run["algo"], slice_run["model"]
    ju, jv = slice_run["jax_user"], slice_run["jax_item"]
    S_ref = ju.astype(np.float64) @ jv.T.astype(np.float64)
    tu = slice_run["trained"]["user"].astype(np.float64)
    tv = slice_run["trained"]["item"].astype(np.float64)
    bad = []
    for u in range(len(td.user_index)):
        got = _ids(algo.predict(model, Query(user=f"u{u}", num=TOP)), td.item_index)
        # the score gap the two sets of factors can explain for this user
        slack = 2.0 * float(np.abs(tv @ tu[u] - S_ref[u]).max())
        if not _same_ranking(got, _jax_top(ju[u], jv), S_ref[u], lambda s: slack):
            bad.append(u)
    assert not bad, f"{len(bad)} users rank differently from JAX top_k_items: {bad[:5]}"


def test_batch_predict_equals_predict(slice_run):
    td, algo, model = slice_run["td"], slice_run["algo"], slice_run["model"]
    queries = [(n, Query(user=f"u{u}", num=k)) for n, (u, k) in enumerate([(0, 10), (5, 3), (942, 20), (17, 1)])]
    queries.append((4, Query(user="nobody", num=5)))
    algo.BATCH_PREDICT_CHUNK = 2  # several chunks
    try:
        got = dict(algo.batch_predict(model, queries))
    finally:
        del algo.BATCH_PREDICT_CHUNK
    for n, q in queries:
        assert _ids(got[n], td.item_index) == _ids(algo.predict(model, q), td.item_index)
    assert got[4].item_scores == ()


def test_http_queries_match_predict_and_jax_wire_shape(slice_run, served):
    algo, model = served["algo"], served["model"]
    np.testing.assert_array_equal(model.user_factors, slice_run["trained"]["user"])
    with QueryServer(served["service"]) as server:

        def post(body) -> tuple:
            req = urllib.request.Request(
                server.url + "/queries.json", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"}, method="POST",
            )
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        for u in (0, 1, 400, 942):
            status, body = post({"user": f"u{u}", "num": TOP})
            assert status == 200
            result = algo.predict(model, Query(user=f"u{u}", num=TOP))
            jax_result = JaxPredictedResult(tuple(JaxItemScore(s.item, s.score) for s in result.item_scores))
            assert body == json.loads(json.dumps(jax_result_to_json(jax_result)))
            assert len(body["itemScores"]) == TOP
        assert post({"user": "nobody", "num": 4}) == (200, {"itemScores": []})
        assert post({"user": "u0", "bogus": 1})[0] == 400
        assert post([1, 2])[0] == 400
        # predict raises: the transport answers 500, as the JAX package's does
        assert post({"user": "u0", "num": "many"}) == (500, {"message": "Internal Server Error"})
        assert post({"user": "u1", "num": TOP})[0] == 200  # and the server goes on
        with urllib.request.urlopen(server.url + "/", timeout=30) as resp:
            status_body = json.loads(resp.read())
        assert status_body["status"] == "alive"
        assert status_body["engineInstanceId"] == served["instance"].id and status_body["device"] == "cpu"


def test_query_server_predicts_on_one_warmed_thread(served):
    # each request is read on a thread of its own, but every predict runs
    # on the service's one device thread, which the load's warm_up prepared
    CALLS.clear()
    service = QueryService(served["variant"], local_context("cpu"))
    with QueryServer(service) as server:
        for u in (0, 7, 42):
            req = urllib.request.Request(
                server.url + "/queries.json", data=json.dumps({"user": f"u{u}", "num": 3}).encode(),
                headers={"Content-Type": "application/json"}, method="POST",
            )
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert resp.status == 200
    assert [kind for kind, _ in CALLS] == ["warm", "predict", "predict", "predict"]
    threads = {ident for _, ident in CALLS}
    assert len(threads) == 1 and threading.get_ident() not in threads


def test_jax_trained_model_carried_across_ranks_like_jax(slice_run):
    td = slice_run["td"]
    ju, jv = slice_run["jax_user"], slice_run["jax_item"]
    # a JAX-package ALSModel: numpy factors + BiMaps; carried as to_dict()
    j_users = JaxBiMap(td.user_index.to_dict())
    j_items = JaxBiMap(td.item_index.to_dict())
    model = als_model_from_numpy(ju, jv, j_users.to_dict(), j_items.to_dict(), device="cpu")
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=10), device="cpu")
    S_ref = ju.astype(np.float64) @ jv.T.astype(np.float64)
    bad = []
    for u in range(len(td.user_index)):
        got = _ids(algo.predict(model, Query(user=f"u{u}", num=TOP)), td.item_index)
        if not _same_ranking(got, _jax_top(ju[u], jv), S_ref[u], lambda s: NEAR_TIE * abs(s)):
            bad.append(u)
    assert not bad, f"{len(bad)} users rank differently from JAX top_k_items: {bad[:5]}"
    # and back: the inverse gives the JAX package's arrays and maps
    uf, vf, ui, ii = als_model_to_numpy(model)
    np.testing.assert_array_equal(uf, ju)
    np.testing.assert_array_equal(vf, jv)
    assert ui == j_users.to_dict() and ii == j_items.to_dict()


def test_convert_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        als_model_from_numpy(np.zeros((3, 4)), np.zeros((5, 6)), {"a": 0, "b": 1, "c": 2}, {}, device="cpu")


@pytest.mark.parametrize("nnz", [29_000, 300_000])
def test_ml20m_shaped_is_the_bench_workload(nnz):
    # the chip run's training data: the JAX package bench's Zipf workload
    # at num_users = nnz/145, num_items = nnz/740 (bench.py), seed 5
    import bench

    rows, cols, vals, num_users, num_items = ml20m_shaped(nnz, seed=5)
    assert (num_users, num_items) == (max(1000, int(nnz / 145)), max(500, int(nnz / 740)))
    for got, ref in zip((rows, cols, vals), bench._make_workload(nnz, num_users, num_items, seed=5)):
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype
