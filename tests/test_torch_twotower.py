"""The port's Two-Tower slice on the CPU, against the JAX package:
``ops/twotower.py`` training, ``templates/twotower`` serving, the
planted-preference generator and the model carrier in ``convert.py``.

* Whole-slice training parity. With ``nnz == batch_size`` every epoch is
  one batch holding every pair, and the in-batch loss does not depend on
  the order of the pairs in it, so the epoch permutation (``jax.random``
  on one side, a torch generator on the other) need not be replayed. Both
  packages start from the same injected tables. The port's
  ``fused_ce="interpret"`` (the kernels' plain versions) is held against
  the JAX package's interpret-mode kernels, and the port's ``"off"`` path
  against the JAX XLA path: loss history rtol 1e-5, final tables atol
  2e-4 (found at most 6e-5 and 8e-5 on one host; 2.02e-4 on another, below).
  The ``"off"`` path with ``gemm_dtype="float32"`` is held to the same
  band (found 7.0e-6 and 1.7e-6). In bf16 the two packages cannot agree
  to the bit: from identical logits XLA:CPU's ``exp`` (off the correctly
  rounded f32 in 9.4 % of inputs, PyTorch's in 0.9 %) and its dot order
  move the operands' f32 gradients by last bits, and the bf16 rounding of
  those gradients then lands 3 of 4,096 entries one bf16 step apart in a
  single step; through adam that moved one table entry 2.02e-4 after
  three steps on one build host, with the pairs' order replayed or not.
  The JAX side runs in a subprocess with ``--xla_allow_excess_precision=false``:
  by default XLA:CPU drops the kernel's bf16 rounding of ``exp``, and adam's
  first steps move every element by about ``lr·sign(g)``, so elements whose
  gradient is near zero land ``2·lr`` apart (0.08 in the tables, found).
  With the flag XLA:CPU keeps the rounding that the TPU kernel makes.
* Adam steps against ``optax.adam`` on the same gradients: rtol 1e-6,
  atol 1e-6 (found 3.4e-7: optax takes the bias corrections ``1 - b**t`` in
  f32, the port in double; a step moves a parameter by up to 0.05).
* A JAX-trained model served through the port returns the same item ids in
  the same order as the JAX template, seen filter included, for every
  user (``predict`` and ``batch_predict``).
* The template trains through ``run_train`` (a ``SimpleEngine`` whose
  DataSource hands over the pairs already made) into a temporary store,
  and a ``QueryService`` serves the stored instance over HTTP.
"""

import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from predictionio_tpu.controller.params import params_from_json as jax_params_from_json
from predictionio_tpu.data.aggregator import BiMap as JaxBiMap
from predictionio_tpu.ops import twotower as jax_tt
from predictionio_tpu.templates.twotower import engine as jax_engine
from predictionio_tpu_torch.controller import local_context
from predictionio_tpu_torch.controller.params import params_from_json
from predictionio_tpu_torch.convert import twotower_model_from_numpy, twotower_model_to_numpy
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.ops import fused_ce as torch_fused_ce
from predictionio_tpu_torch.ops import twotower as torch_tt
from predictionio_tpu_torch.templates.twotower import (
    Query,
    RecallAtK,
    TrainingData,
    TwoTowerAlgorithm,
    TwoTowerParams,
)
from predictionio_tpu_torch.utils.serialization import loads_model
from predictionio_tpu_torch.utils.synthetic import distinct_pairs, planted_pairs
from predictionio_tpu_torch.workflow import run_train
from predictionio_tpu_torch.workflow.serving import QueryServer, QueryService
from torch_arrays_engine import arrays_engine, arrays_variant

ROOT = Path(__file__).resolve().parents[1]

#: the parity run: 256 pairs = one batch of 256 at D 16, three epochs
PARITY = dict(num_users=40, num_items=30, dim=16, batch=256, epochs=3)

_JAX_PARITY_SCRIPT = """
import sys
import numpy as np
from predictionio_tpu.ops import twotower as tt

z = np.load(sys.argv[1])
out = {}
for mode, fused, gemm in (("interpret", "interpret", "bfloat16"), ("off", "off", "bfloat16"),
                          ("float32", "off", "float32")):
    cfg = tt.TwoTowerConfig(dim=int(z["dim"]), batch_size=int(z["batch"]), epochs=int(z["epochs"]),
                            seed=0, fused_ce=fused, gemm_dtype=gemm, log_every=1)
    m = tt.train_two_tower(z["rows"], z["cols"], int(z["nu"]), int(z["ni"]), cfg,
                           init_user=z["init_user"], init_item=z["init_item"])
    out[mode + "_user"] = m.user_vecs
    out[mode + "_item"] = m.item_vecs
    out[mode + "_loss"] = np.array([l for _, l in m.loss_history])
np.savez(sys.argv[2], **out)
"""


def _parity_inputs():
    p = PARITY
    rng = np.random.default_rng(0)
    rows = rng.integers(0, p["num_users"], p["batch"])
    cols = rng.integers(0, p["num_items"], p["batch"])
    init_user = (rng.normal(size=(p["num_users"], p["dim"])) / 4).astype(np.float32)
    init_item = (rng.normal(size=(p["num_items"], p["dim"])) / 4).astype(np.float32)
    return rows, cols, init_user, init_item


@pytest.fixture(scope="module")
def jax_parity_run(tmp_path_factory):
    """The JAX package's training of the parity inputs, both loss paths,
    in a subprocess whose XLA keeps every bf16 rounding."""
    tmp = tmp_path_factory.mktemp("tt_parity")
    rows, cols, init_user, init_item = _parity_inputs()
    p = PARITY
    np.savez(
        tmp / "in.npz", rows=rows, cols=cols, init_user=init_user, init_item=init_item,
        nu=p["num_users"], ni=p["num_items"], dim=p["dim"], batch=p["batch"], epochs=p["epochs"],
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false").strip()
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    subprocess.run(
        [sys.executable, "-c", _JAX_PARITY_SCRIPT, str(tmp / "in.npz"), str(tmp / "out.npz")],
        check=True, env=env, timeout=300, capture_output=True,
    )
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("mode", ["interpret", "off", "float32"])
def test_training_matches_jax_on_one_batch(jax_parity_run, mode):
    rows, cols, init_user, init_item = _parity_inputs()
    p = PARITY
    fused = "interpret" if mode == "interpret" else "off"
    gemm = "float32" if mode == "float32" else "bfloat16"
    cfg = torch_tt.TwoTowerConfig(dim=p["dim"], batch_size=p["batch"], epochs=p["epochs"], seed=0,
                                  fused_ce=fused, gemm_dtype=gemm, log_every=1)
    assert torch_tt.uses_fused_ce(p["batch"], p["dim"], 10.0, gemm, fused) == (mode == "interpret")
    m = torch_tt.train_two_tower(rows, cols, p["num_users"], p["num_items"], cfg,
                                 init_user=init_user, init_item=init_item, device="cpu")
    losses = np.array([l for _, l in m.loss_history])
    assert [s for s, _ in m.loss_history] == list(range(p["epochs"]))
    np.testing.assert_allclose(losses, jax_parity_run[mode + "_loss"], rtol=1e-5)
    np.testing.assert_allclose(m.user_vecs, jax_parity_run[mode + "_user"], rtol=0, atol=2e-4)
    np.testing.assert_allclose(m.item_vecs, jax_parity_run[mode + "_item"], rtol=0, atol=2e-4)
    assert set(m.timings) == {"ingest_seconds", "train_seconds", "finalize_seconds"}


def test_adam_step_matches_optax():
    rng = np.random.default_rng(3)
    tables = [rng.normal(size=(12, 8)).astype(np.float32), rng.normal(size=(7, 8)).astype(np.float32)]
    grads = [[rng.normal(size=t.shape).astype(np.float32) * 10.0 ** -k for t in tables] for k in range(3)]
    tx = optax.adam(0.05)
    params = {"user": jnp.asarray(tables[0]), "item": jnp.asarray(tables[1])}
    opt = tx.init(params)
    ours = [torch.from_numpy(t.copy()) for t in tables]
    state = torch_tt.AdamState(ours)
    for g in grads:
        updates, opt = tx.update({"user": jnp.asarray(g[0]), "item": jnp.asarray(g[1])}, opt, params)
        params = optax.apply_updates(params, updates)
        torch_tt.adam_update(ours, [torch.from_numpy(x) for x in g], state, 0.05)
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(params["user"]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ours[1].numpy(), np.asarray(params["item"]), rtol=1e-6, atol=1e-6)
    assert state.count == 3


def _clustered(num_users=60, num_items=30, groups=3, seed=0):
    """tests/test_twotower.py's grouped interactions."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for u in range(num_users):
        for i in range(num_items):
            if i % groups == u % groups and rng.random() < 0.7:
                rows.append(u)
                cols.append(i)
    return np.array(rows), np.array(cols)


def test_learns_group_structure():
    rows, cols = _clustered()
    cfg = torch_tt.TwoTowerConfig(dim=16, batch_size=64, epochs=30, learning_rate=0.05, seed=1)
    m = torch_tt.train_two_tower(rows, cols, 60, 30, cfg, device="cpu")
    s = m.user_vecs @ m.item_vecs.T
    same = np.array([[i % 3 == u % 3 for i in range(30)] for u in range(60)])
    assert s[same].mean() > s[~same].mean() + 0.2, (s[same].mean(), s[~same].mean())
    assert m.loss_history[-1][1] < m.loss_history[0][1]
    np.testing.assert_allclose(np.linalg.norm(m.user_vecs, axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize(
    "rows,cols,match",
    [([], [], "at least one"), ([5], [0], "out of range"), ([0], [3], "out of range"),
     ([-1], [0], "out of range"), ([0, 1], [0], "equal-length")],
)
def test_validation_errors(rows, cols, match):
    with pytest.raises(ValueError, match=match):
        torch_tt.train_two_tower(np.array(rows, np.int64), np.array(cols, np.int64), 4, 3, device="cpu")
    with pytest.raises(ValueError, match=match):
        jax_tt.train_two_tower(np.array(rows, np.int64), np.array(cols, np.int64), 4, 3)


@pytest.mark.parametrize(
    "field,value,match",
    [("gemm_dtype", "float16", "gemm_dtype"), ("fused_ce", "on", "fused_ce"), ("dim", 16, "init_user")],
)
def test_config_errors(field, value, match):
    cfg = torch_tt.TwoTowerConfig(**{"dim": 8, field: value})
    with pytest.raises(ValueError, match=match):
        torch_tt.train_two_tower(np.array([0, 1]), np.array([0, 1]), 4, 3, cfg,
                                 init_user=np.zeros((4, 8), np.float32), device="cpu")


@pytest.mark.parametrize(
    "B,D,gemm,setting,fused",
    [(256, 16, "bfloat16", "auto", True), (256, 16, "bfloat16", "interpret", True),
     (256, 16, "bfloat16", "off", False), (256, 16, "float32", "auto", False),
     (64, 16, "bfloat16", "auto", False), (256, 12, "bfloat16", "auto", False)],
)
def test_loss_dispatch(B, D, gemm, setting, fused):
    assert torch_tt.uses_fused_ce(B, D, 10.0, gemm, setting) == fused
    rng = np.random.default_rng(B + D)
    ue = torch_tt.l2_normalize(torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)))
    ie = torch_tt.l2_normalize(torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)))
    got = torch_tt.inbatch_loss(ue, ie, 10.0, gemm, setting)
    if fused:
        want = torch_fused_ce.fused_inbatch_ce(ue, ie, 10.0, "interpret")
        assert float(got) == float(want)
    assert torch.isfinite(got)


def _jax_trained_model():
    rows, cols = _clustered(num_users=45, num_items=40, groups=3, seed=5)
    cfg = jax_tt.TwoTowerConfig(dim=16, batch_size=64, epochs=8, learning_rate=0.05, seed=1, fused_ce="off")
    m = jax_tt.train_two_tower(rows, cols, 45, 40, cfg)
    users = [f"u{u}" for u in range(45)]
    items = [f"i{i}" for i in range(40)]
    seen: dict = {}
    for r, c in zip(rows.tolist(), cols.tolist()):
        seen.setdefault(users[r], set()).add(items[c])
    return m, users, items, seen


def test_jax_trained_model_serves_identically_through_the_port():
    m, users, items, seen = _jax_trained_model()
    jax_model = jax_engine.TwoTowerServingModel(
        user_vecs=np.asarray(m.user_vecs), item_vecs=np.asarray(m.item_vecs),
        user_index=JaxBiMap.string_index(users), item_index=JaxBiMap.string_index(items), seen=seen,
    )
    jax_algo = jax_engine.TwoTowerAlgorithm(jax_engine.TwoTowerParams())
    jax_model = jax_algo.prepare_model_for_serving(jax_model)
    model = twotower_model_from_numpy(
        m.user_vecs, m.item_vecs, jax_model.user_index.to_dict(), jax_model.item_index.to_dict(),
        seen, device="cpu",
    )
    algo = TwoTowerAlgorithm(TwoTowerParams(), device="cpu")
    algo.prepare_model_for_serving(model)
    queries = [(n, u, num) for n, (u, num) in enumerate((u, num) for u in users + ["nobody"] for num in (3, 10))]
    bad = []
    for n, u, num in queries:
        got = [s.item for s in algo.predict(model, Query(user=u, num=num)).item_scores]
        want = [s.item for s in jax_algo.predict(jax_model, jax_engine.Query(user=u, num=num)).item_scores]
        assert not set(got) & seen.get(u, set())
        if got != want:
            bad.append((u, num, got, want))
    assert not bad, bad[:3]
    got_b = dict(algo.batch_predict(model, [(n, Query(user=u, num=num)) for n, u, num in queries]))
    want_b = dict(jax_algo.batch_predict(jax_model, [(n, jax_engine.Query(user=u, num=num)) for n, u, num in queries]))
    for n, _, _ in queries:
        assert [s.item for s in got_b[n].item_scores] == [s.item for s in want_b[n].item_scores], n
    assert got_b[len(queries) - 1].item_scores == ()


def test_convert_round_trip():
    m, users, items, seen = _jax_trained_model()
    model = twotower_model_from_numpy(
        m.user_vecs, m.item_vecs, {u: n for n, u in enumerate(users)}, {i: n for n, i in enumerate(items)},
        seen, device="cpu",
    )
    uv, iv, ui, ii, seen_back = twotower_model_to_numpy(model)
    np.testing.assert_array_equal(uv, m.user_vecs)
    np.testing.assert_array_equal(iv, m.item_vecs)
    assert ui["u3"] == 3 and ii["i7"] == 7 and seen_back == seen
    with pytest.raises(ValueError, match="differ in length"):
        twotower_model_from_numpy(m.user_vecs[:-1], m.item_vecs, ui, ii, seen, device="cpu")


def test_params_parse_like_jax():
    body = {"embeddingDim": 16, "batchSize": 128, "epochs": 2, "learningRate": 0.01,
            "gemmDtype": "float32", "fusedCe": "off", "serveOnDevice": True, "seed": 4}
    ours = params_from_json(TwoTowerParams, body)
    ref = jax_params_from_json(jax_engine.TwoTowerParams, body)
    assert {f: getattr(ours, f) for f in vars(ours)} == {f: getattr(ref, f) for f in vars(ref)}
    assert ours.to_json()["embeddingDim"] == 16 and Query(user="u").num == jax_engine.Query(user="u").num == 10


def test_template_trains_and_serves_over_http(tmp_path):
    rows, cols = _clustered(num_users=30, num_items=24, groups=2, seed=2)
    rows, cols = distinct_pairs(rows, cols, 24)
    td = TrainingData(
        rows=rows, cols=cols,
        user_index=BiMap.string_index(str(u) for u in range(30)),
        item_index=BiMap.string_index(str(i) for i in range(24)),
        seen={},
    )
    for r, c in zip(rows.tolist(), cols.tolist()):
        td.seen.setdefault(str(r), set()).add(str(c))
    variant = arrays_variant("tt", td, TwoTowerAlgorithm,
                             {"embeddingDim": 8, "batchSize": 128, "epochs": 20, "seed": 1})
    Storage.configure({"PIO_FS_BASEDIR": str(tmp_path)})
    try:
        inst = run_train(variant, local_context("cpu"))
        (_, stored), = loads_model(Storage.get_model_data_models().get(inst.id).models)
        assert stored.loss_history[-1][1] < stored.loss_history[0][1]
        service = QueryService(variant, local_context("cpu"))
        engine = arrays_engine()
        _, [(algo, model)] = engine.prepare_deploy(
            local_context("cpu"), variant.engine_params(engine), inst.id,
            Storage.get_model_data_models().get(inst.id).models)
        assert isinstance(model.item_vecs, np.ndarray)  # the CPU serves host numpy
        with QueryServer(service) as server:
            req = urllib.request.Request(
                server.url + "/queries.json", data=json.dumps({"user": "4"}).encode(),
                headers={"Content-Type": "application/json"}, method="POST",
            )
            with urllib.request.urlopen(req, timeout=30) as resp:
                payload = json.loads(resp.read())
    finally:
        Storage.configure(None)
    want = algo.predict(model, Query(user="4")).to_json()
    assert payload == json.loads(json.dumps(want))
    got = [s["item"] for s in payload["itemScores"]]
    # user 4 is in group 0 and has seen most of it: the unseen group-0
    # items come first
    unseen_same = [str(i) for i in range(0, 24, 2) if str(i) not in td.seen["4"]]
    assert len(got) == 10 and not set(got) & td.seen["4"]
    assert set(got[: len(unseen_same)]) == set(unseen_same)


def test_recall_at_k():
    from predictionio_tpu_torch.templates.results import ItemScore, PredictedResult

    metric = RecallAtK(k=2)
    pred = PredictedResult(tuple(ItemScore(item=i, score=1.0) for i in ("a", "b", "c")))
    assert metric.calculate_unit(None, pred, ("a", "c")) == 0.5
    assert metric.calculate_unit(None, pred, ()) is None
    assert metric.header() == "Recall@2"
    jax_metric = jax_engine.RecallAtK(k=2)
    jax_pred = jax_engine.PredictedResult(tuple(jax_engine.ItemScore(item=i, score=1.0) for i in ("a", "b", "c")))
    for actual in (("a", "c"), ("c",), ("b", "a"), ()):
        assert metric.calculate_unit(None, pred, actual) == jax_metric.calculate_unit(None, jax_pred, actual)


def _bench_generator(nnz):
    """bench.py::_bench_twotower's data, whole (not chunked)."""
    num_users, num_items = max(1000, nnz // 50), max(500, nnz // 100)
    rng = np.random.default_rng(11)
    tu = rng.normal(size=(num_users, 16)).astype(np.float32)
    tv = rng.normal(size=(num_items, 16)).astype(np.float32)
    users = rng.integers(0, num_users, nnz + nnz // 20)
    cand = rng.integers(0, num_items, (users.size, 32))
    scores = np.einsum("nk,nck->nc", tu[users], tv[cand])
    items = cand[np.arange(users.size), scores.argmax(1)]
    return users[:nnz], items[:nnz], users[nnz:], items[nnz:], num_users, num_items


def test_planted_pairs_match_the_bench_generator():
    nnz = 100_000  # 105,000 rows: two score chunks
    got = planted_pairs(nnz, seed=11)
    want = _bench_generator(nnz)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4:] == want[4:] == (2000, 1000)
    r, c = distinct_pairs(got[0], got[1], got[5])
    assert r.size == len(set(zip(got[0].tolist(), got[1].tolist())))
    assert np.all(np.diff(r * got[5] + c) > 0)
