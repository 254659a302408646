"""The four templates of the port against the JAX package's, on the same
seeded numpy inputs (CPU).

* Implicit ALS through both ALS templates' ``train``: the JAX side starts
  from the port's draw (``seed_factors``; ``jax.random`` cannot be
  replayed in torch) and solves with its Pallas kernel in interpret mode;
  the factors after each of 3 sweeps agree at rtol 5e-3, atol 5e-4, the
  per-sweep band of ``tests/test_torch_als.py`` (the data are view counts
  1-3, well scaled for the blocked Gauss-Jordan solve).
* One model in both packages' ``predict`` (the JAX model through
  ``convert``): ranked ids equal except near-ties (float64 scores within
  a relative 1e-5), scores within 1e-5, for the port's host path (numpy,
  the CPU) and its tensor path (the tables pinned as CPU tensors). The
  E-Commerce cold start ranks by integer popularity, where ties straddle
  the k-th place: there the reference's ``top_k_host`` keeps arbitrary
  members of the tie, so the port is held to the contract it misses —
  ``jax.lax.top_k``'s order, descending score then ascending index — in
  float64 numpy.
* Naive Bayes: log-posteriors within a relative 1e-5. Logistic
  regression after the reference's iteration count: weights, biases and
  probabilities within an absolute 1e-5 (measured here: at most 3e-7).
* The hashing TF-IDF: idf weights and matrices equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.controller import local_context as jax_local_context
from predictionio_tpu.data.aggregator import BiMap as JaxBiMap
from predictionio_tpu.ops import classify as jax_classify
from predictionio_tpu.ops import text as jax_text
from predictionio_tpu.templates.classification import engine as jax_cls
from predictionio_tpu.templates.ecommerce import engine as jax_ec
from predictionio_tpu.templates.similarproduct import engine as jax_sp
from predictionio_tpu.templates.textclassification import engine as jax_tx
from predictionio_tpu_torch import convert
from predictionio_tpu_torch.controller.context import local_context
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.ops import classify as port_classify
from predictionio_tpu_torch.ops import text as port_text
from predictionio_tpu_torch.ops.als import seed_factors
from predictionio_tpu_torch.templates.classification import engine as port_cls
from predictionio_tpu_torch.templates.ecommerce import engine as port_ec
from predictionio_tpu_torch.templates.similarproduct import engine as port_sp
from predictionio_tpu_torch.templates.textclassification import engine as port_tx

USERS, ITEMS, RANK, SWEEPS = 30, 24, 8, 3
RTOL, ATOL = 5e-3, 5e-4
NEAR_TIE = 1e-5
CATS = ("even", "odd")


def _views(seed: int = 0):
    """Distinct (user, item) pairs with view counts 1-3, users in two
    groups that view within their own half of the catalog."""
    rng = np.random.default_rng(seed)
    pairs = {}
    for u in range(USERS):
        for i in range(ITEMS):
            if i % 2 == u % 2 and rng.random() < 0.5:
                pairs[(u, i)] = float(rng.integers(1, 4))
    (rows, cols), vals = np.array(list(pairs)).T, np.array(list(pairs.values()), np.float32)
    return rows.astype(np.int64), cols.astype(np.int64), vals


def _categories():
    return {f"i{i}": (CATS[i % 2],) for i in range(ITEMS)}


def _training_data(module, bimap, seed: int = 0):
    rows, cols, vals = _views(seed)
    users = bimap.string_index(f"u{u}" for u in range(USERS))
    items = bimap.string_index(f"i{i}" for i in range(ITEMS))
    if module in (jax_ec, port_ec):
        popularity = np.zeros(ITEMS, np.float32)
        np.add.at(popularity, cols, vals)
        return module.TrainingData(rows, cols, vals, users, items, _categories(), popularity)
    return module.TrainingData(rows, cols, vals, users, items, _categories())


def _jax_from_port_draw(monkeypatch, module) -> None:
    """The JAX template's ``train_als`` from the port's draw, solving with
    the Pallas kernel in interpret mode (as the JAX package's CPU tests)."""
    real = module.train_als

    def train_als(rows, cols, vals, num_users, num_items, config, mesh=None):
        cfg = dataclasses.replace(config, solver="pallas_interpret")
        return real(
            rows, cols, vals, num_users, num_items, config=cfg,
            init_user=seed_factors(num_users, cfg.rank, cfg.seed, True),
            init_item=seed_factors(num_items, cfg.rank, cfg.seed + 1, True),
        )

    monkeypatch.setattr(module, "train_als", train_als)


TEMPLATES = {
    "similarproduct": (jax_sp, port_sp, "ALSAlgorithm", "ALSAlgorithmParams", ("item_factors",)),
    "ecommerce": (jax_ec, port_ec, "ECommAlgorithm", "ECommAlgorithmParams", ("user_factors", "item_factors")),
}


@pytest.mark.parametrize("template", sorted(TEMPLATES))
def test_implicit_als_factors_equal_jax_each_sweep(template, monkeypatch):
    jax_mod, port_mod, algo_name, params_name, tables = TEMPLATES[template]
    _jax_from_port_draw(monkeypatch, jax_mod)
    for sweeps in range(1, SWEEPS + 1):
        kw = dict(rank=RANK, num_iterations=sweeps, lambda_=0.01, alpha=1.0, seed=3)
        ref = getattr(jax_mod, algo_name)(getattr(jax_mod, params_name)(**kw)).train(
            jax_local_context(), _training_data(jax_mod, JaxBiMap))
        got = getattr(port_mod, algo_name)(getattr(port_mod, params_name)(**kw), device="cpu").train(
            local_context("cpu"), _training_data(port_mod, BiMap))
        for name in tables:
            a, b = getattr(got, name), np.asarray(getattr(ref, name))
            assert isinstance(a, np.ndarray) and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"{name}, sweep {sweeps}")
        if template == "ecommerce":
            np.testing.assert_array_equal(got.popularity, ref.popularity)


def _same_ranking(got, ref, scores64: np.ndarray, index) -> None:
    """Item ids equal except where the two differing items' float64 scores
    are within :data:`NEAR_TIE`; each score within 1e-5 of its float64."""
    assert len(got.item_scores) == len(ref.item_scores)
    for g, r in zip(got.item_scores, ref.item_scores):
        gi, ri = index[g.item], index[r.item]
        if gi != ri:
            assert abs(scores64[gi] - scores64[ri]) <= NEAR_TIE * max(abs(scores64[ri]), 1e-12), (g, r)
        assert abs(g.score - scores64[gi]) <= 1e-5 * max(1.0, abs(scores64[gi]))


def _sp_model(seed: int = 5):
    rng = np.random.default_rng(seed)
    item = rng.normal(size=(ITEMS, RANK)).astype(np.float32)
    item[3] = 0.0  # an unviewed ($set-only) item: a zero row
    norms = np.linalg.norm(item, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    return item / norms


SP_QUERIES = [
    dict(items=("i0",), num=5),
    dict(items=("i0", "i7", "i12"), num=4),
    dict(items=("i1",), num=6, categories=("odd",)),
    dict(items=("i1",), num=10, white_list=("i2", "i5", "i9", "zzz")),
    dict(items=("i2",), num=5, black_list=("i4", "i6", "i8")),
    dict(items=("i2",), num=100),
    dict(items=("i3",), num=5),
    dict(items=("zzz",), num=5),
    dict(items=("i0",), num=0),
]


@pytest.mark.parametrize("path", ["host", "tensor"])
def test_similarproduct_answers_equal_jax(path):
    unit = _sp_model()
    ref_model = jax_sp.SimilarProductModel(unit, JaxBiMap.string_index(f"i{i}" for i in range(ITEMS)),
                                           _categories())
    model = convert.similarproduct_model_from_numpy(unit, ref_model.item_index.to_dict(), ref_model.categories)
    back = convert.similarproduct_model_to_numpy(model)
    np.testing.assert_array_equal(back[0], unit)
    assert back[1:] == (ref_model.item_index.to_dict(), ref_model.categories)
    algo = port_sp.ALSAlgorithm(port_sp.ALSAlgorithmParams(), device="cpu")
    if path == "tensor":
        model, nbytes = algo.pin_model_for_serving(model)
        assert isinstance(model.item_factors, torch.Tensor) and nbytes == unit.nbytes
    ref_algo = jax_sp.ALSAlgorithm(jax_sp.ALSAlgorithmParams())
    unit64 = unit.astype(np.float64)
    for q in SP_QUERIES:
        ref = ref_algo.predict(ref_model, jax_sp.Query(**q))
        got = algo.predict(model, port_sp.Query(**q))
        rows = [model.item_index[i] for i in q["items"] if i in model.item_index]
        target = unit64[rows].sum(axis=0) if rows else np.zeros(RANK)
        scores64 = unit64 @ (target / max(np.linalg.norm(target), 1e-300))
        _same_ranking(got, ref, scores64, model.item_index)
    if path == "tensor":
        algo.release_pinned_model(model)
        assert isinstance(model.item_factors, np.ndarray)


def _ec_model(seed: int = 7):
    rng = np.random.default_rng(seed)
    users = rng.normal(size=(USERS, RANK)).astype(np.float32)
    items = rng.normal(size=(ITEMS, RANK)).astype(np.float32)
    # integer popularity with ties everywhere, the top tie straddling k
    popularity = np.asarray([5, 3, 9, 3, 3, 9, 1, 3] * (ITEMS // 8), np.float32)
    return users, items, popularity


EC_QUERIES = [
    dict(user="u0", num=5),
    dict(user="u3", num=4, categories=("even",)),
    dict(user="u4", num=8, white_list=("i1", "i2", "i3", "zzz")),
    dict(user="u5", num=6, black_list=("i0", "i9")),
    dict(user="u6", num=100),
]
EC_COLD = [
    dict(user="stranger", num=3),
    dict(user="stranger", num=5, categories=("odd",)),
    dict(user="stranger", num=4, black_list=("i2",)),
    dict(user="stranger", num=7, white_list=tuple(f"i{i}" for i in range(1, ITEMS, 2))),
]


@pytest.mark.parametrize("path", ["host", "tensor"])
def test_ecommerce_answers_equal_jax_and_cold_ties_keep_the_contract(path):
    users, items, popularity = _ec_model()
    user_index = {f"u{u}": u for u in range(USERS)}
    item_index = {f"i{i}": i for i in range(ITEMS)}
    ref_model = jax_ec.ECommModel(users, items, JaxBiMap(user_index), JaxBiMap(item_index), _categories(),
                                  popularity)
    model = convert.ecomm_model_from_numpy(users, items, user_index, item_index, _categories(), popularity)
    back = convert.ecomm_model_to_numpy(model)
    for part, want in zip(back, (users, items, user_index, item_index, _categories(), popularity)):
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(part, want)
        else:
            assert part == want
    algo = port_ec.ECommAlgorithm(port_ec.ECommAlgorithmParams(), device="cpu")
    if path == "tensor":
        model, _ = algo.pin_model_for_serving(model)
        assert isinstance(model.popularity, torch.Tensor)
    ref_algo = jax_ec.ECommAlgorithm(jax_ec.ECommAlgorithmParams())
    for q in EC_QUERIES:
        scores64 = items.astype(np.float64) @ users[user_index[q["user"]]].astype(np.float64)
        _same_ranking(algo.predict(model, port_ec.Query(**q)), ref_algo.predict(ref_model, jax_ec.Query(**q)),
                      scores64, model.item_index)
    pop64 = popularity.astype(np.float64)
    for q in EC_COLD:
        got = algo.predict(model, port_ec.Query(**q))
        allowed = port_ec.allowed_items(model, ITEMS, (), q.get("white_list"), q.get("black_list"),
                                        q.get("categories"))
        order = [i for i in np.lexsort((np.arange(ITEMS), -pop64)) if allowed[i]][: q["num"]]
        assert [s.item for s in got.item_scores] == [f"i{i}" for i in order], q
        assert [s.score for s in got.item_scores] == pop64[order].tolist()


def _class_data(n: int, f: int, c: int, seed: int):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n)
    x = rng.poisson(1.0, size=(n, f)).astype(np.float32)
    x[np.arange(n), y % f] += rng.poisson(5.0, size=n)
    return x, y


@pytest.mark.parametrize("n,f,c", [(90, 3, 3), (60, 64, 5)], ids=["attributes", "hashed"])
def test_naive_bayes_log_posteriors_equal_jax(n, f, c):
    x, y = _class_data(n, f, c, seed=f)
    ref = jax_classify.train_naive_bayes(x, y, c, smoothing=1.0)
    got = port_classify.train_naive_bayes(x, y, c, smoothing=1.0, device="cpu")
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    np.testing.assert_allclose(
        port_classify.nb_predict_log_proba(got, torch.from_numpy(x)).numpy(),
        np.asarray(jax_classify.nb_predict_log_proba(ref, jnp.asarray(x))), rtol=1e-5)
    with pytest.raises(ValueError, match="non-negative"):
        port_classify.train_naive_bayes(-x, y, c, device="cpu")


@pytest.mark.parametrize("n,f,c,iterations", [(90, 3, 3, 200), (60, 64, 5, 300)], ids=["attributes", "hashed"])
def test_logreg_weights_and_probabilities_equal_jax(n, f, c, iterations):
    x, y = _class_data(n, f, c, seed=10 + f)
    xs = (x - x.mean(axis=0)) / x.std(axis=0)
    ref = jax_classify.train_logreg(xs, y, c, iterations=iterations, lr=1.0, reg=1e-4)
    got = port_classify.train_logreg(xs, y, c, iterations=iterations, lr=1.0, reg=1e-4, device="cpu")
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        port_classify.logreg_predict_proba(got, torch.from_numpy(xs)).numpy(),
        np.asarray(jax_classify.logreg_predict_proba(ref, jnp.asarray(xs))), rtol=0, atol=1e-5)


TEXTS = ["the team won the game", "great match and score, the Final!", "gpu kernels are fast",
         "the api returns json", "don't debug the program", "", "goal goal goal 42"]


def test_tfidf_matrices_equal_jax():
    stop = ("the", "and")
    ref = jax_text.fit_tfidf(TEXTS, num_features=64, stopwords=stop)
    got = port_text.fit_tfidf(TEXTS, num_features=64, stopwords=stop)
    np.testing.assert_array_equal(got.idf, ref.idf)
    assert (got.num_features, got.stopwords) == (ref.num_features, ref.stopwords)
    queries = TEXTS + ["unseen words only", "The TEAM"]
    np.testing.assert_array_equal(got.transform(queries), ref.transform(queries))
    assert port_text.tokenize("Don't STOP", frozenset({"stop"})) == jax_text.tokenize("Don't STOP", frozenset({"stop"}))


def _jax_classifier(kind: str):
    """A JAX-trained classification or text model and its queries."""
    if kind.startswith("text"):
        featurizer = jax_text.fit_tfidf(TEXTS, num_features=64)
        x = featurizer.transform(TEXTS)
        y = np.arange(len(TEXTS)) % 3
        labels = JaxBiMap.string_index(["a", "b", "c"])
        queries = [{"text": t} for t in TEXTS + ["fast gpu api", "team score"]]
        extra = {"featurizer": featurizer}
    else:
        x, y = _class_data(60, 3, 3, seed=21)
        labels = JaxBiMap.string_index(["basic", "premium", "gold"])
        queries = [dict(zip(("attr0", "attr1", "attr2"), map(float, row))) for row in x[:12]]
        extra = {"attributes": ("attr0", "attr1", "attr2")}
    if kind.endswith("nb"):
        model = {"nb": jax_classify.train_naive_bayes(x, y, 3), "label_index": labels, **extra}
    else:
        mean, std = x.mean(axis=0), x.std(axis=0)
        std[std == 0] = 1.0
        xs = x if kind.startswith("text") else (x - mean) / std
        model = {"lr": jax_classify.train_logreg(xs, y, 3, iterations=200), "label_index": labels, **extra}
        if not kind.startswith("text"):
            model.update(mean=mean, std=std)
    return model, queries


CLASSIFIERS = {
    "nb": (jax_cls.NaiveBayesAlgorithm, jax_cls.NaiveBayesParams, port_cls.NaiveBayesAlgorithm,
           port_cls.NaiveBayesParams),
    "lr": (jax_cls.LRAlgorithm, jax_cls.LRParams, port_cls.LRAlgorithm, port_cls.LRParams),
    "text-nb": (jax_tx.NBTextAlgorithm, jax_tx.NBTextParams, port_tx.NBTextAlgorithm, port_tx.NBTextParams),
    "text-lr": (jax_tx.LRTextAlgorithm, jax_tx.LRTextParams, port_tx.LRTextAlgorithm, port_tx.LRTextParams),
}


@pytest.mark.parametrize("kind", sorted(CLASSIFIERS))
def test_classifier_answers_equal_jax(kind):
    """One JAX model in both packages' ``predict`` (and the port's
    ``batch_predict``, one product for every query): labels equal,
    confidences within 1e-5."""
    jax_algo, jax_params, port_algo, port_params = CLASSIFIERS[kind]
    model, queries = _jax_classifier(kind)
    ported = convert.classifier_model_from_numpy({k: np.asarray(v) if k in ("mean", "std") else v
                                                  for k, v in model.items()})
    assert type(ported[kind.split("-")[-1]]).__module__ == "predictionio_tpu_torch.ops.classify"
    algo = port_algo(port_params(), device="cpu")
    served = algo.prepare_model_for_serving(ported)
    assert isinstance(served[kind.split("-")[-1]][0], torch.Tensor)
    ref_algo = jax_algo(jax_params())
    field = "category" if kind.startswith("text") else "label"
    batch = dict(algo.batch_predict(served, list(enumerate(queries))))
    for n, q in enumerate(queries):
        ref = ref_algo.predict(model, q)
        for got in (algo.predict(served, q), algo.predict(ported, q), batch[n]):
            assert getattr(got, field) == getattr(ref, field)
            assert abs(got.confidence - ref.confidence) <= 1e-5
    back = convert.classifier_model_to_numpy(ported)
    again = convert.classifier_model_from_numpy(back)
    for key, value in ported.items():
        if isinstance(value, tuple) and hasattr(value, "_fields"):
            for a, b in zip(value, again[key]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
