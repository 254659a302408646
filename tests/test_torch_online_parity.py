"""The port's online learning against the JAX package's, on the same inputs.

At the size of ``tests/test_online.py``'s service cases (rank 8, 30
users x 60 items):

* ``foldin_rows`` on the same numpy inputs in both packages: explicit and
  implicit, with and without prior anchors, with rows wider than
  ``MAX_WIDTH`` and more rows than one ``B_CHUNK`` (rtol 1e-4, atol 1e-5);
  a ``lambda = 0`` fold whose padding systems are all zero (the port
  gives them the identity; its real rows equal the reference's); a real
  row whose system is not positive definite raises in the port where the
  JAX package returns NaN;
* ``sgd_step`` on the same rows (loss within 1e-5, rows within rtol 1e-5,
  atol 1e-6);
* one JAX-trained ``ALSModel`` blob deployed in both packages'
  ``QueryService`` with ``online=`` over one columnar store, the same
  events appended, one ``/online/fold.json`` in each: the swapped rows
  within rtol 1e-4, the answers' item ids equal bar near-ties, the same
  invalidated scopes and the same ``usersAdded``/``itemsAdded``; with
  ``--pin-model``, ``bytesPinned`` keeps its pin-time value after the
  cold-start growth in both packages;
* the port's row swaps leave a table taken earlier unchanged, re-quantize
  only the touched rows of an int8 table (where they refused it until
  the int8 tier was ported), fold into a sharded table as into a
  replicated one (where they refused the sharded tier until it was
  ported), and a released generation hands back its folded rows, not the
  pin-time ones.
"""

import datetime as dt

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import local_context as jax_local_context
from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage.base import App as JaxApp
from predictionio_tpu.online import OnlineConfig as JaxOnlineConfig
from predictionio_tpu.online.foldin import foldin_rows as jax_foldin_rows
from predictionio_tpu.online.foldin import gram_yty as jax_gram_yty
from predictionio_tpu.online.trainer import sgd_step as jax_sgd_step
from predictionio_tpu.serving import CacheConfig as JaxCacheConfig
from predictionio_tpu.workflow import load_engine_variant as jax_load_variant
from predictionio_tpu.workflow import run_train as jax_run_train
from predictionio_tpu.workflow import serving as jax_serving
from predictionio_tpu_torch.controller.context import local_context
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.online import OnlineConfig
from predictionio_tpu_torch.online.foldin import B_CHUNK, MAX_WIDTH, NotPositiveDefiniteError, foldin_rows, gram_yty
from predictionio_tpu_torch.online.trainer import sgd_step
from predictionio_tpu_torch.serving import CacheConfig
from predictionio_tpu_torch.workflow import device_state, load_engine_variant
from predictionio_tpu_torch.workflow import serving as port_serving

RANK, USERS, ITEMS = 8, 30, 60
FOLD_RTOL, FOLD_ATOL = 1e-4, 1e-5
VARIANT = {
    "id": "ol-parity",
    "version": "1",
    "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
    "datasource": {"params": {"appName": "ol-parity"}},
    "algorithms": [{"name": "als", "params": {"rank": RANK, "numIterations": 2, "lambda": 0.05, "seed": 5}}],
}
T0 = dt.datetime(2023, 1, 1, tzinfo=dt.timezone.utc)


def _entries(rng, n: int, width_of=None) -> list:
    out = []
    for j in range(n):
        m = width_of(j) if width_of else int(rng.integers(1, 12))
        out.append((rng.integers(0, ITEMS, m).tolist(), rng.uniform(1, 5, m).astype(np.float32).tolist()))
    return out


# ---------------------------------------------------------------- fold-in
@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
@pytest.mark.parametrize("anchored", [False, True], ids=["free", "anchored"])
def test_foldin_rows_equal_the_jax_package(implicit, anchored):
    rng = np.random.default_rng(11)
    Y = rng.standard_normal((ITEMS, RANK)).astype(np.float32)
    # one row wider than MAX_WIDTH (its most recent window is kept) and
    # more rows than one chunk
    entries = _entries(rng, B_CHUNK + 9, lambda j: MAX_WIDTH + 40 if j == 3 else int(rng.integers(1, 40)))
    priors = rng.standard_normal((len(entries), RANK)).astype(np.float32) if anchored else None
    weights = np.where(rng.random(len(entries)) < 0.5, 1.0, 0.0).astype(np.float32) if anchored else None
    kw = dict(reg=0.05, priors=priors, prior_weights=weights, implicit=implicit, alpha=1.5)
    want = jax_foldin_rows(Y, entries, yty=jax_gram_yty(Y) if implicit else None, **kw)
    got = foldin_rows(Y, entries, yty=gram_yty(Y) if implicit else None, device="cpu", **kw)
    assert got.shape == want.shape == (len(entries), RANK) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=FOLD_RTOL, atol=FOLD_ATOL)
    # the same on a tensor table: the gather runs where the table lives
    on_tensor = foldin_rows(torch.from_numpy(Y), entries, yty=gram_yty(torch.from_numpy(Y)) if implicit else None, **kw)
    np.testing.assert_allclose(on_tensor, want, rtol=FOLD_RTOL, atol=FOLD_ATOL)


def test_lambda_zero_padding_rows_do_not_raise():
    """A chunk of 5 real rows has 123 padding systems, all zero at
    ``lambda = 0``: the port gives them the identity, and its real rows
    (anchored, or with enough ratings) equal the reference's."""
    rng = np.random.default_rng(12)
    Y = rng.standard_normal((ITEMS, RANK)).astype(np.float32)
    entries = _entries(rng, 5, lambda j: 3 if j < 3 else 20)
    priors = rng.standard_normal((5, RANK)).astype(np.float32)
    weights = np.asarray([1.0, 1.0, 1.0, 0.0, 0.0], np.float32)  # cold rows have 20 ratings
    want = jax_foldin_rows(Y, entries, reg=0.0, priors=priors, prior_weights=weights)
    got = foldin_rows(Y, entries, reg=0.0, priors=priors, prior_weights=weights, device="cpu")
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=FOLD_RTOL, atol=FOLD_ATOL)


def test_a_real_row_that_is_not_positive_definite_raises():
    """``lambda = 0``, no anchor, 2 ratings at rank 8: the JAX package
    returns a NaN row (and would serve it); the port names the row."""
    Y = np.random.default_rng(13).standard_normal((ITEMS, RANK)).astype(np.float32)
    entries = [([1, 2, 3, 4, 5, 6, 7, 8, 9], [1.0] * 9), ([4, 5], [3.0, 4.0])]
    assert np.isnan(jax_foldin_rows(Y, entries, reg=0.0)[1]).all()
    with pytest.raises(NotPositiveDefiniteError, match=r"rows \[1\]"):
        foldin_rows(Y, entries, reg=0.0, device="cpu")


def test_foldin_rows_take_the_card_unless_asked(monkeypatch):
    """A numpy opposite table does not make the fold run on the CPU: with
    no device given it asks for the card, which is not here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Y = np.zeros((ITEMS, RANK), np.float32)
    with pytest.raises(RuntimeError, match="is_available"):
        foldin_rows(Y, [([1], [1.0])], reg=0.1)


# ---------------------------------------------------------- streaming SGD
@pytest.mark.parametrize("pairs", [([1, 2, 3, 4], [3, 4, 5, 6]), ([2, 2, 7], [1, 3, 3])], ids=["distinct", "repeats"])
def test_sgd_step_equals_the_jax_package(pairs):
    rng = np.random.default_rng(14)
    U = rng.standard_normal((USERS, 16)).astype(np.float32)
    V = rng.standard_normal((ITEMS, 16)).astype(np.float32)
    U /= np.linalg.norm(U, axis=1, keepdims=True)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    u_idx, i_idx = (np.asarray(p) for p in pairs)
    want = jax_sgd_step(U, V, u_idx, i_idx, 0.5, 0.1)
    for tables in ((U, V), (torch.from_numpy(U), torch.from_numpy(V))):
        got = sgd_step(*tables, u_idx, i_idx, 0.5, 0.1, device="cpu")
        for k in (0, 2):
            np.testing.assert_array_equal(got[k], want[k])
        for k in (1, 3):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)
        assert abs(got[4] - want[4]) <= 1e-5


# ------------------------------------------------------------- row swaps
class _Model:
    pass


def test_row_swaps_leave_an_earlier_table_unchanged():
    """``set_rows``/``append_rows`` are out of place: a table that a
    snapshot or an in-flight query holds keeps its rows."""
    rng = np.random.default_rng(15)
    for table in (rng.standard_normal((6, 4)).astype(np.float32), torch.randn(6, 4)):
        before = table.copy() if isinstance(table, np.ndarray) else table.clone()
        model = _Model()
        model.user_factors, model.user_index = table, BiMap.string_index(list("abcdef"))
        rows = rng.standard_normal((3, 4)).astype(np.float32)
        assert device_state.swap_side_rows(model, ["b", "z", "f"], rows, "user_factors", "user_index", True) == (2, 1)
        np.testing.assert_array_equal(np.asarray(table), np.asarray(before))
        got = np.asarray(model.user_factors)
        assert got.shape == (7, 4) and model.user_index["z"] == 6
        np.testing.assert_array_equal(got[[1, 5, 6]], rows[[0, 2, 1]])
        np.testing.assert_array_equal(got[[0, 2, 3, 4]], np.asarray(before)[[0, 2, 3, 4]])
        np.testing.assert_array_equal(device_state.get_rows(model.user_factors, [6, 1]), rows[[1, 0]])


def test_row_swaps_refuse_the_int8_and_sharded_tiers():
    """Both tiers are served now (they were refused until each was
    ported; the name is kept). A swap into an int8 table re-quantizes only
    the touched rows and leaves the old table as it was. A fold into a
    model sharded over the ``(cpu,)*8`` mesh gives the rows, tables and
    answers of the same fold into the replicated pinned model: a re-rate
    of a known user, a known item's update, a fresh user in a padding
    slot."""
    from predictionio_tpu_torch.ops import quant

    rng = np.random.default_rng(17)
    mat = rng.standard_normal((5, 4)).astype(np.float32)
    table = quant.quantize_table(mat, "cpu")
    codes_before = table.codes.clone()
    rows = rng.standard_normal((2, 4)).astype(np.float32)
    out = device_state.set_rows(table, [1, 3], rows)
    mat[[1, 3]] = rows
    want_codes, want_scales = quant.quantize_table_host(mat)
    np.testing.assert_array_equal(out.codes.numpy(), want_codes)
    np.testing.assert_array_equal(out.scales.numpy(), want_scales)
    assert torch.equal(table.codes, codes_before)
    from predictionio_tpu_torch.online.types import EventDelta
    from predictionio_tpu_torch.parallel import sharding
    from predictionio_tpu_torch.templates.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        ALSModel,
        Query,
    )

    uf = rng.standard_normal((30, 8)).astype(np.float32)
    vf = rng.standard_normal((61, 8)).astype(np.float32)
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=8, lambda_=0.05), device="cpu")
    deltas = [EventDelta("rate", "3", "7", 1, 5.0), EventDelta("rate", "3", "50", 2, 1.0),
              EventDelta("rate", "fresh", "7", 3, 4.0), EventDelta("rate", "fresh", "12", 4, 2.0)]
    folded = {}
    with sharding.local_devices(["cpu"] * 8):
        for shard in (False, True):
            model = ALSModel(uf.copy(), vf.copy(), BiMap.string_index([str(i) for i in range(30)]),
                             BiMap.string_index([str(i) for i in range(61)]))
            model, _ = algo.shard_model_for_serving(model) if shard else algo.pin_model_for_serving(model)
            upd = algo.online_foldin(model, deltas, {}, OnlineConfig(enabled=True))
            info = algo.apply_online_update(model, upd)
            assert (info["usersAdded"], info["usersUpdated"], info["itemsUpdated"]) == (1, 1, 2)
            answers = [[s.item for s in algo.predict(model, Query(user=u, num=10)).item_scores]
                       for u in ("3", "fresh", "0")]
            folded[shard] = (upd, model, answers)
    (upd_r, model_r, answers_r), (upd_s, model_s, answers_s) = folded[False], folded[True]
    assert upd_s.user_ids == upd_r.user_ids and upd_s.item_ids == upd_r.item_ids
    np.testing.assert_array_equal(upd_s.user_rows, upd_r.user_rows)
    np.testing.assert_array_equal(upd_s.item_rows, upd_r.item_rows)
    assert isinstance(model_s.user_factors, sharding.ShardedTable)
    assert model_s._pio_shards.rows == {"user": 31, "item": 61} and model_s.user_factors.shape[0] == 32
    np.testing.assert_array_equal(np.asarray(model_s.user_factors)[:31], model_r.user_factors.numpy())
    np.testing.assert_array_equal(np.asarray(model_s.item_factors)[:61], model_r.item_factors.numpy())
    assert answers_s == answers_r


# ------------------------------------------------------- the query service
def _events(make_event, make_map):
    """Re-rates by known users 0-19, a fresh user on known items, a fresh
    item rated by known users, and a buy (rated ``buyRating``)."""
    rng = np.random.default_rng(16)
    out = []
    for k, (u, i) in enumerate(zip(rng.integers(0, 20, 20), rng.integers(0, ITEMS, 20))):
        out.append(("rate", str(u), str(i), float(rng.integers(1, 6)), k))
    out += [("rate", "fresh-u", str(i), 5.0, 30 + i) for i in (1, 2, 3, 9, 11)]
    out += [("rate", str(u), "fresh-i", 4.0, 40 + u) for u in (3, 4)]
    out += [("buy", "7", "12", None, 50)]
    return [
        make_event(event=name, entity_type="user", entity_id=u, target_entity_type="item", target_entity_id=i,
                   properties=make_map({} if r is None else {"rating": r}),
                   event_time=T0 + dt.timedelta(seconds=t))
        for name, u, i, r, t in out
    ]


@pytest.fixture()
def store(tmp_path):
    """One sqlite + localfs base directory with a columnar event store for
    both packages, 600 ratings, one JAX-trained instance."""
    base = tmp_path / "base"
    env = {
        "PIO_FS_BASEDIR": str(base),
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "COL",
        "PIO_STORAGE_SOURCES_COL_TYPE": "columnar",
        "PIO_STORAGE_SOURCES_COL_PATH": str(base / "events"),
    }
    JaxStorage.configure(env)
    Storage.configure(env)
    try:
        app_id = JaxStorage.get_meta_data_apps().insert(JaxApp(id=0, name="ol-parity"))
        rng = np.random.default_rng(5)
        JaxStorage.get_l_events().insert_batch(
            [
                JaxEvent(event="rate", entity_type="user", entity_id=str(u), target_entity_type="item",
                         target_entity_id=str(i), properties=JaxDataMap({"rating": float((u + i) % 5 + 1)}))
                for u, i in zip(rng.integers(0, USERS, 600), rng.integers(0, ITEMS, 600))
            ],
            app_id,
        )
        jax_run_train(jax_load_variant(VARIANT), jax_local_context())
        yield {"app_id": app_id, "base": base}
    finally:
        Storage.configure(None)
        JaxStorage.configure(None)


def _recording(qs) -> dict:
    """Record what the service's online updates apply and invalidate."""
    seen = {"applied": [], "scopes": []}
    apply, note = qs.apply_online_update, qs.cache_note_write

    def apply_and_record(updates, generation=None):
        res = apply(updates, generation=generation)
        seen["applied"].append(res)
        return res

    def note_and_record(scopes=None, flush_all=False):
        seen["scopes"].append((sorted(scopes or ()), flush_all))
        return note(scopes, flush_all)

    qs.apply_online_update, qs.cache_note_write = apply_and_record, note_and_record
    return seen


def _items_equal_bar_near_ties(a: list, b: list, rtol: float = 1e-4) -> bool:
    if [s["item"] for s in a] == [s["item"] for s in b]:
        return True
    return len(a) == len(b) and all(
        x["item"] == y["item"] or abs(x["score"] - y["score"]) <= rtol * max(abs(x["score"]), 1e-6)
        for x, y in zip(a, b)
    )


@pytest.mark.parametrize("pin", [False, True], ids=["host", "pinned"])
def test_one_fold_swaps_the_same_rows_in_both_packages(store, tmp_path, pin):
    jax_qs = jax_serving.QueryService(
        jax_load_variant(VARIANT),
        cache=JaxCacheConfig(result_cache=True, pin_model=pin),
        online=JaxOnlineConfig(enabled=True, interval_s=600.0, state_dir=str(tmp_path / "jax-cursor")),
    )
    port_qs = port_serving.QueryService(
        load_engine_variant(VARIANT), local_context("cpu"),
        cache=CacheConfig(result_cache=True, pin_model=pin),
        online=OnlineConfig(enabled=True, interval_s=600.0, state_dir=str(tmp_path / "port-cursor")),
    )
    try:
        for qs in (jax_qs, port_qs):
            qs.online.stop()  # manual folds only: the daemon's cadence must not race the test
        records = [_recording(qs) for qs in (jax_qs, port_qs)]
        pinned_before = [qs.stats_json()["cache"]["bytesPinned"] for qs in (jax_qs, port_qs)]
        queried = ["3", "4", "7", "fresh-u", "0", "25", "28"]
        for qs in (jax_qs, port_qs):
            for u in queried:  # cached answers the fold must invalidate
                qs.dispatch("POST", "/queries.json", {}, {"user": u, "num": 10})
        JaxStorage.get_l_events().insert_batch(_events(JaxEvent, JaxDataMap), store["app_id"])
        folds = [qs.dispatch("POST", "/online/fold.json", {}, None) for qs in (jax_qs, port_qs)]
        assert [(f.status, f.body) for f in folds] == [(200, {"events": 28, "applied": True})] * 2
        (jax_rec, port_rec) = records
        assert len(jax_rec["applied"]) == len(port_rec["applied"]) == 1
        jax_info, port_info = jax_rec["applied"][0]["infos"], port_rec["applied"][0]["infos"]
        assert port_info == jax_info
        assert port_info[0]["usersAdded"] == 1 and port_info[0]["itemsAdded"] == 1
        assert port_rec["scopes"] == jax_rec["scopes"] and port_rec["scopes"][0][1] is False
        jax_model = jax_qs.snapshot_pairs()[0][0][1]
        port_model = port_qs.snapshot_pairs()[0][0][1]
        assert port_model.user_index.to_dict() == jax_model.user_index.to_dict()
        assert port_model.item_index.to_dict() == jax_model.item_index.to_dict()
        for attr in ("user_factors", "item_factors"):
            np.testing.assert_allclose(np.asarray(getattr(port_model, attr)), np.asarray(getattr(jax_model, attr)),
                                       rtol=FOLD_RTOL, atol=FOLD_ATOL)
        for u in queried:
            answers = [qs.dispatch("POST", "/queries.json", {}, {"user": u, "num": 10}).body["itemScores"]
                       for qs in (jax_qs, port_qs)]
            assert len(answers[0]) == 10 and _items_equal_bar_near_ties(*answers), (u, answers)
        jax_stats, port_stats = (qs.stats_json() for qs in (jax_qs, port_qs))
        assert port_stats["cache"]["invalidations"] == jax_stats["cache"]["invalidations"]
        untouched = [u for u in queried if u not in port_rec["scopes"][0][0]]
        assert untouched and port_stats["cache"]["hits"] == jax_stats["cache"]["hits"] == len(untouched)
        # the pinned-bytes ledger keeps its pin-time value after growth,
        # as in the JAX package (set on each load only)
        assert [port_stats["cache"]["bytesPinned"], jax_stats["cache"]["bytesPinned"]] == pinned_before
        assert pinned_before[0] == pinned_before[1] == ((USERS + ITEMS) * RANK * 4 if pin else 0)
        for key in ("folds", "eventsSeen", "eventsFolded", "updatesApplied"):
            assert port_stats["online"][key] == jax_stats["online"][key], key
        assert port_qs.status_json()["online"] is jax_qs.status_json()["online"] is True
    finally:
        jax_qs.close()
        port_qs.close()


def test_a_released_generation_hands_back_its_folded_rows(store, tmp_path):
    """After a fold the pin-time host arrays are stale: the release on
    ``/reload`` copies the folded tables back instead."""
    qs = port_serving.QueryService(
        load_engine_variant(VARIANT), local_context("cpu"),
        cache=CacheConfig(pin_model=True),
        online=OnlineConfig(enabled=True, interval_s=600.0, state_dir=str(tmp_path / "cursor")),
    )
    try:
        qs.online.stop()
        model = qs.snapshot_pairs()[0][0][1]
        pin_time = np.asarray(model._pio_host[0]).copy()
        JaxStorage.get_l_events().insert_batch(_events(JaxEvent, JaxDataMap), store["app_id"])
        assert qs.dispatch("POST", "/online/fold.json", {}, None).body["applied"] is True
        assert model._pio_host is None
        folded = model.user_factors.clone()
        qs.reload()
        assert isinstance(model.user_factors, np.ndarray) and not model._pio_pinned
        np.testing.assert_array_equal(model.user_factors, folded.numpy())
        assert model.user_factors.shape[0] == pin_time.shape[0] + 1
        assert not np.array_equal(model.user_factors[: pin_time.shape[0]], pin_time)
    finally:
        qs.close()
