"""The Two-Tower engine on the port's DASE spine, against the JAX package,
on the CPU, over one sqlite store.

Grouped ``view`` interactions (with repeated pairs, a ``buy``, and a
``rate`` that ``eventNames`` leaves out) go into the store through the
port's ``pio import``. Then:

* the port's ``TwoTowerDataSource.read_training`` equals the JAX one's bit
  for bit (``rows``, ``cols`` and their dtype, both ``BiMap``s, ``seen``),
  and ``read_eval`` gives the same folds (queries, actuals, each fold's
  ``TrainingData``);
* one engine.json naming ``predictionio_tpu.templates.twotower:engine_factory``
  trains on both packages (``run_train``) into the store. A JAX-trained
  instance served by the port's ``QueryService`` answers with the JAX
  ``QueryService``'s top-N, and a port-trained instance served by the JAX
  package the same way, for every user, except near-ties: two items whose
  float64 scores are within 1e-5 (relative);
* the port's ``Engine.eval`` with ``RecallAtK(10)`` scores above 1.5x
  the recall of a random ranking, and each of its units equals the JAX
  ``RecallAtK``'s on the same query, prediction and actual;
* held-out recall, the eval's measure, on toy planted-preference pairs
  (the recipe of ``planted_pairs``: each user draws the best of 8 random
  items under true rank-4 preferences): both packages train from the same
  initial towers with each epoch one batch of every pair (so the epoch
  permutation, drawn differently by the two, does not matter) and f32
  logit products (so XLA:CPU's dropped bf16 rounding does not either). The
  towers agree within atol 1e-4 (found 1.9e-6) and the recall@10 of one
  fold's held-out pairs by towers trained on the rest within 5 % of the
  JAX package's (found equal at 0.069), so a trainer that learns nothing,
  near a random ranking's 0.138, fails. Trained, both lie below the random
  ranking, while ranking the unseen items by their count in the fold lies
  above it: the fold holds out popular items. That fits the in-batch
  softmax, whose negatives come by popularity: it pushes down most the
  popular items a user has not interacted with. So the Two-Tower
  eval carries no bar against the random ranking; ``chip_smoke.py`` holds
  the card's eval to RecallAtK recomputed in float64 numpy instead.
"""

import json
import zlib

import numpy as np
import pytest

from predictionio_tpu.controller import local_context as jax_local_context
from predictionio_tpu.ops import twotower as jax_ops
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.templates.twotower import engine as jax_tt
from predictionio_tpu.workflow import load_engine_variant as jax_load_variant
from predictionio_tpu.workflow import run_train as jax_run_train
from predictionio_tpu.workflow.serving import QueryService as JaxQueryService
from predictionio_tpu_torch.controller import local_context
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.templates.twotower import (
    DataSourceParams,
    RecallAtK,
    TwoTowerDataSource,
    engine_factory,
)
from predictionio_tpu_torch.ops import twotower as torch_ops
from predictionio_tpu_torch.tools import commands
from predictionio_tpu_torch.utils.serialization import loads_model
from predictionio_tpu_torch.workflow import load_engine_variant, run_train
from predictionio_tpu_torch.workflow.serving import QueryService

APP = "tt"
USERS, ITEMS, GROUPS = 192, 96, 6
NEAR_TIE = 1e-5
CPU = local_context("cpu")


def engine_json(engine_id: str) -> dict:
    return {
        "id": engine_id, "version": "1",
        "engineFactory": "predictionio_tpu.templates.twotower:engine_factory",
        "datasource": {"params": {"appName": APP, "eventNames": ["view", "buy"], "evalK": 2}},
        "algorithms": [{"name": "twotower", "params": {
            "embeddingDim": 16, "batchSize": 64, "epochs": 10, "learningRate": 0.05, "seed": 4}}],
    }


def _lines() -> list:
    rng = np.random.default_rng(3)
    out = []
    for u in range(USERS):
        for i in range(ITEMS):
            if i % GROUPS == u % GROUPS and rng.random() < 0.6:
                for _ in range(1 + int(rng.random() < 0.2)):  # some pairs twice
                    out.append({"event": "view", "entityType": "user", "entityId": f"u{u}",
                                "targetEntityType": "item", "targetEntityId": f"i{i}",
                                "eventTime": f"2021-{6 + u // 24 // 28:02d}-{1 + u // 24 % 28:02d}T{u % 24:02d}:{i // 60:02d}:{i % 60:02d}.000Z"})
    out.append({"event": "buy", "entityType": "user", "entityId": "u1", "targetEntityType": "item",
                "targetEntityId": "i2", "eventTime": "2021-06-02T00:00:00.000Z"})
    out.append({"event": "rate", "entityType": "user", "entityId": "u1", "targetEntityType": "item",
                "targetEntityId": "i5", "properties": {"rating": 5}, "eventTime": "2021-06-02T00:00:00.000Z"})
    return out


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("tt_engine")
    env = {"PIO_FS_BASEDIR": str(base)}
    Storage.configure(env)
    JaxStorage.configure(env)
    (base / "events.json").write_text("".join(json.dumps(line) + "\n" for line in _lines()))
    commands.app_new(APP, out=lambda line: None)
    commands.import_events(APP, str(base / "events.json"), out=lambda line: None)
    yield base
    Storage.configure(None)
    JaxStorage.configure(None)


def _td_equal(got, want) -> None:
    for name in ("rows", "cols"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)
    assert got.user_index.to_dict() == want.user_index.to_dict()
    assert got.item_index.to_dict() == want.item_index.to_dict()
    assert got.seen == want.seen


def test_read_training_bit_equal_to_jax(store):
    names = ("view", "buy")
    got = TwoTowerDataSource(DataSourceParams(app_name=APP, event_names=names)).read_training(CPU)
    want = jax_tt.TwoTowerDataSource(jax_tt.DataSourceParams(app_name=APP, event_names=names)).read_training(
        jax_local_context())
    _td_equal(got, want)
    assert "i5" not in got.seen["u1"] and "i2" in got.seen["u1"]  # rate is not one of the names
    assert got.rows.size == len({(u, i) for u, s in got.seen.items() for i in s})


def test_read_eval_folds_equal_to_jax(store):
    # the default eventNames: the rate event too
    got = TwoTowerDataSource(DataSourceParams(app_name=APP, eval_k=3)).read_eval(CPU)
    want = jax_tt.TwoTowerDataSource(jax_tt.DataSourceParams(app_name=APP, eval_k=3)).read_eval(jax_local_context())
    assert len(got) == len(want) == 3
    for (td, ei, qa), (jtd, jei, jqa) in zip(got, want):
        _td_equal(td, jtd)
        assert ei == jei
        assert [(q.user, q.num, a) for q, a in qa] == [(q.user, q.num, a) for q, a in jqa]
        assert qa


@pytest.fixture(scope="module")
def trained(store):
    for name in ("port", "jax"):
        (store / f"{name}.json").write_text(json.dumps(engine_json(f"tt-{name}")))
    inst = run_train(load_engine_variant(str(store / "port.json")), CPU)
    jax_inst = jax_run_train(jax_load_variant(str(store / "jax.json")), jax_local_context())
    return {"port": inst, "jax": jax_inst}


@pytest.mark.parametrize("trainer", ["jax", "port"])
def test_instance_served_by_both_packages_ranks_alike(store, trained, trainer):
    inst = trained[trainer]
    assert inst.status == "COMPLETED"
    path = str(store / f"{trainer}.json")
    ours = QueryService(load_engine_variant(path), CPU, instance_id=inst.id)
    ref = JaxQueryService(jax_load_variant(path), jax_local_context(), instance_id=inst.id)
    (_, model), = loads_model(Storage.get_model_data_models().get(inst.id).models)
    users = np.asarray(model.user_vecs, np.float64)
    items = np.asarray(model.item_vecs, np.float64)
    bad = []
    for u in [f"u{n}" for n in range(USERS)] + ["nobody"]:
        status, got = ours.handle_query({"user": u, "num": 5})
        jax_status, want = ref.handle_query({"user": u, "num": 5})
        assert status == jax_status == 200
        got_ids = [s["item"] for s in got["itemScores"]]
        want_ids = [s["item"] for s in want["itemScores"]]
        if u == "nobody":
            assert got_ids == want_ids == []
            continue
        assert not set(got_ids) & model.seen[u]
        scores = items @ users[model.user_index[u]]
        idx = model.item_index
        if len(got_ids) != len(want_ids) or any(
            g != w and abs(scores[idx[g]] - scores[idx[w]]) > NEAR_TIE * abs(scores[idx[w]])
            for g, w in zip(got_ids, want_ids)
        ):
            bad.append((u, got_ids, want_ids))
    assert not bad, bad[:3]
    assert ours.status_json()["engineInstanceId"] == inst.id


def test_eval_recall_above_random_and_units_equal_jax(store):
    engine = engine_factory()
    params = load_engine_variant(engine_json("tt-eval")).engine_params(engine)
    folds = engine.read_eval_folds(CPU, params)
    eval_data = engine.eval(CPU, params, folds=folds)
    metric, jax_metric = RecallAtK(10), jax_tt.RecallAtK(10)
    units, random_units = [], []
    for (_, qpa), (td, _, _) in zip(eval_data, folds):
        for q, p, a in qpa:
            jax_p = jax_tt.PredictedResult(tuple(jax_tt.ItemScore(s.item, s.score) for s in p.item_scores))
            unit = metric.calculate_unit(q, p, a)
            assert unit == jax_metric.calculate_unit(q, jax_p, a)
            units.append(unit)
            # a random ranking of the unseen items puts each of them in
            # the top 10 with probability 10/candidates
            candidates = len(td.item_index) - len(td.seen[q.user])
            known = sum(1 for i in a if i in td.item_index)
            random_units.append(min(1.0, 10 / candidates) * known / len(a))
    score = metric.calculate(CPU, eval_data)
    assert score == pytest.approx(np.mean(units))
    # the toy catalog memorises more than it generalises: a margin, not 5x
    assert score > 1.5 * np.mean(random_units) > 0, (score, np.mean(random_units))


def _held_out_recall(user_vecs, item_vecs, td, held: dict) -> float:
    """Mean recall@10 of each user's held-out items, the user's training
    items excluded from the ranking (what RecallAtK reads in the eval)."""
    scores = np.asarray(user_vecs, np.float64) @ np.asarray(item_vecs, np.float64).T
    units = []
    for user, items in held.items():
        s = scores[td.user_index[user]].copy()
        s[[td.item_index[i] for i in td.seen[user]]] = -np.inf
        top = {td.item_index.inverse(int(j)) for j in np.argsort(-s, kind="stable")[:10]}
        units.append(len(top & set(items)) / len(items))
    return float(np.mean(units))


def _toy_planted_pairs(num_users=64, num_items=80, per_user=20, seed=11):
    """``planted_pairs``' recipe at a toy size: each user draws ``per_user``
    times the best of 8 random items under true rank-4 preferences."""
    rng = np.random.default_rng(seed)
    tu, tv = rng.normal(size=(num_users, 4)), rng.normal(size=(num_items, 4))
    users = np.repeat(np.arange(num_users), per_user)
    cand = rng.integers(0, num_items, (users.size, 8))
    best = np.einsum("nk,nck->nc", tu[users], tv[cand]).argmax(1)
    return users, cand[np.arange(users.size), best]


def test_held_out_recall_on_planted_pairs_tracks_jax():
    r, c = _toy_planted_pairs()
    pairs = sorted({(f"u{u}", f"i{i}") for u, i in zip(r.tolist(), c.tolist())})
    fold = {pr: zlib.crc32(f"{pr[0]}\x00{pr[1]}".encode()) % 2 for pr in pairs}
    td = TwoTowerDataSource._to_training_data([pr for pr in pairs if fold[pr] == 1])
    held: dict = {}
    for u, i in pairs:
        if fold[(u, i)] == 0 and u in td.user_index and i in td.item_index:
            held.setdefault(u, []).append(i)
    n_u, n_i, n = len(td.user_index), len(td.item_index), td.rows.size
    rng = np.random.default_rng(0)
    init_user = (rng.normal(size=(n_u, 16)) / 4).astype(np.float32)
    init_item = (rng.normal(size=(n_i, 16)) / 4).astype(np.float32)
    cfg = dict(dim=16, batch_size=-(-n // 8) * 8, epochs=40, learning_rate=0.05, temperature=0.1, seed=2,
               gemm_dtype="float32", fused_ce="off")
    ours = torch_ops.train_two_tower(td.rows, td.cols, n_u, n_i, torch_ops.TwoTowerConfig(**cfg),
                                     init_user=init_user, init_item=init_item, device="cpu")
    ref = jax_ops.train_two_tower(td.rows, td.cols, n_u, n_i, jax_ops.TwoTowerConfig(**cfg),
                                  init_user=init_user, init_item=init_item)
    np.testing.assert_allclose(ours.user_vecs, np.asarray(ref.user_vecs), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours.item_vecs, np.asarray(ref.item_vecs), rtol=0, atol=1e-4)
    got = _held_out_recall(ours.user_vecs, ours.item_vecs, td, held)
    want = _held_out_recall(ref.user_vecs, ref.item_vecs, td, held)
    assert want > 0 and abs(got - want) <= 0.05 * want, (got, want)
    random = float(np.mean([10 / (n_i - len(td.seen[u])) for u in held]))
    counts = np.bincount(td.cols, minlength=n_i).astype(np.float64)
    popular = _held_out_recall(np.ones((n_u, 1)), counts[:, None], td, held)
    assert max(got, want) < random < popular, (got, want, random, popular)
