"""``pio deploy --online`` over a partitioned event store: the port's runner
against the JAX package's, on the CPU.

One JAX-trained ``ALSModel`` (``tests/test_torch_online_parity.py``'s
size: rank 8, 30 users x 60 items) is served by both packages'
``QueryService(online=...)`` over one columnar store with ``PARTITIONS=3``,
each with its own cursor ``state_dir`` and its daemon stopped so the folds
run when the test asks:

* both runners start one follower a partition, with the same cursor file
  names (``<app>-p<k>-<crc>.cursor.json``) and ``partition`` in each
  watermark;
* one fold of the same events gives ``eventsSeen`` equal to the events
  stored and the same folded rows (rtol 1e-4, atol 1e-5, the parity
  test's band). Each partition's events rate items no other partition's
  events rate, so the rows do not depend on the order in which the
  partitions' folds apply;
* a fold made to fail for one partition rolls back that partition's poll
  advance and commits the others', in both packages; the next fold
  delivers the failed partition's events, and only those.

The JAX runner runs the partitions' hooks and row swaps concurrently, and
its ``apply_online_update`` swaps rows outside its lock: two partitions
that grow or move one table at once can lose one of the swaps (its index
keeps the fresh ids, its table not the rows). The port runs every swap on
its one device thread. So the JAX service here runs its partitions' hook
and apply calls one at a time, which gives the answer its concurrent
runner gives when no two swaps overlap.
"""

import datetime as dt
import os
import threading

import numpy as np
import pytest

from predictionio_tpu.controller import local_context as jax_local_context
from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage.base import App as JaxApp
from predictionio_tpu.data.storage.partitioned import partition_of as jax_partition_of
from predictionio_tpu.online import OnlineConfig as JaxOnlineConfig
from predictionio_tpu.workflow import load_engine_variant as jax_load_variant
from predictionio_tpu.workflow import run_train as jax_run_train
from predictionio_tpu.workflow import serving as jax_serving
from predictionio_tpu_torch.controller.context import local_context
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.storage.partitioned import partition_of
from predictionio_tpu_torch.online import OnlineConfig
from predictionio_tpu_torch.workflow import load_engine_variant
from predictionio_tpu_torch.workflow import serving as port_serving

P = 3
RANK, USERS, ITEMS = 8, 30, 60
FOLD_RTOL, FOLD_ATOL = 1e-4, 1e-5
VARIANT = {
    "id": "ol-parts",
    "version": "1",
    "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
    "datasource": {"params": {"appName": "ol-parts"}},
    "algorithms": [{"name": "als", "params": {"rank": RANK, "numIterations": 2, "lambda": 0.05, "seed": 5}}],
}
T0 = dt.datetime(2023, 1, 1, tzinfo=dt.timezone.utc)


@pytest.fixture()
def store(tmp_path):
    base = tmp_path / "base"
    env = {
        "PIO_FS_BASEDIR": str(base),
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "COL",
        "PIO_STORAGE_SOURCES_COL_TYPE": "columnar",
        "PIO_STORAGE_SOURCES_COL_PATH": str(base / "events"),
        "PIO_STORAGE_SOURCES_COL_PARTITIONS": str(P),
    }
    JaxStorage.configure(env)
    Storage.configure(env)
    try:
        app_id = JaxStorage.get_meta_data_apps().insert(JaxApp(id=0, name="ol-parts"))
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
        yield {"app_id": app_id}
    finally:
        Storage.configure(None)
        JaxStorage.configure(None)


def _services(tmp_path):
    jax_qs = jax_serving.QueryService(
        jax_load_variant(VARIANT),
        online=JaxOnlineConfig(enabled=True, interval_s=600.0, state_dir=str(tmp_path / "jax-cursor")),
    )
    port_qs = port_serving.QueryService(
        load_engine_variant(VARIANT), local_context("cpu"),
        online=OnlineConfig(enabled=True, interval_s=600.0, state_dir=str(tmp_path / "port-cursor")),
    )
    for qs in (jax_qs, port_qs):
        qs.online.stop()  # manual folds only
    lock = threading.Lock()
    algo = jax_qs.snapshot_pairs()[0][0][0]
    for owner, name in ((jax_qs, "apply_online_update"), (algo, "online_foldin")):
        def one_at_a_time(*args, real=getattr(owner, name), **kw):
            with lock:
                return real(*args, **kw)

        setattr(owner, name, one_at_a_time)
    return jax_qs, port_qs


def _events() -> list:
    """Re-rates by known users and two fresh users; the items of partition
    ``p``'s users are the items ``i`` with ``i % P == p``, so no item is
    rated from two partitions."""
    rng = np.random.default_rng(21)
    users = [str(u) for u in range(USERS)] + ["fresh-a", "fresh-b"]
    out = []
    for k, u in enumerate(rng.choice(users, 40)):
        p = partition_of("user", u, P)
        item = str(int(rng.integers(0, ITEMS // P)) * P + p)
        out.append(JaxEvent(event="rate", entity_type="user", entity_id=u, target_entity_type="item",
                            target_entity_id=item, properties=JaxDataMap({"rating": float(rng.integers(1, 6))}),
                            event_time=T0 + dt.timedelta(seconds=k)))
    assert {partition_of("user", e.entity_id, P) for e in out} == set(range(P))
    return out


def _rows(qs) -> tuple:
    model = qs.snapshot_pairs()[0][0][1]
    return (model.user_index.to_dict(), model.item_index.to_dict(),
            np.asarray(model.user_factors), np.asarray(model.item_factors))


def test_followers_and_one_fold_match_the_jax_runner(store, tmp_path):
    jax_qs, port_qs = _services(tmp_path)
    try:
        followers = [qs.online.followers for qs in (jax_qs, port_qs)]
        assert [[f.partition for f in fs] for fs in followers] == [list(range(P))] * 2
        names = [[os.path.basename(f._path) for f in fs] for fs in followers]
        assert names[0] == names[1] and all(n.startswith("ol-parts-p") for n in names[1])
        for u in ("0", "fresh-a", "17"):
            assert partition_of("user", u, P) == jax_partition_of("user", u, P)
        events = _events()
        JaxStorage.get_l_events().insert_batch(events, store["app_id"])
        folds = [qs.dispatch("POST", "/online/fold.json", {}, None) for qs in (jax_qs, port_qs)]
        assert [(f.status, f.body) for f in folds] == [(200, {"events": len(events), "applied": True})] * 2
        stats = [qs.stats_json()["online"] for qs in (jax_qs, port_qs)]
        for key in ("folds", "eventsSeen", "eventsFolded", "updatesApplied"):
            assert stats[1][key] == stats[0][key], key
        assert stats[1]["eventsSeen"] == len(events)
        assert [w["partition"] for w in stats[1]["watermarks"]] == list(range(P))
        assert [w["partition"] for w in stats[0]["watermarks"]] == list(range(P))
        (ju, ji, juf, jif), (pu, pi, puf, pif) = _rows(jax_qs), _rows(port_qs)
        assert pu == ju and pi == ji and "fresh-a" in pu
        np.testing.assert_allclose(puf, juf, rtol=FOLD_RTOL, atol=FOLD_ATOL)
        np.testing.assert_allclose(pif, jif, rtol=FOLD_RTOL, atol=FOLD_ATOL)
        # a second fold finds nothing new in any partition
        assert port_qs.online.fold_now() == jax_qs.online.fold_now() == {"events": 0, "applied": False}
    finally:
        jax_qs.close()
        port_qs.close()


def test_a_failed_partition_rolls_back_alone(store, tmp_path):
    jax_qs, port_qs = _services(tmp_path)
    victim = 1
    events = _events()
    n_victim = sum(partition_of("user", e.entity_id, P) == victim for e in events)
    try:
        JaxStorage.get_l_events().insert_batch(events, store["app_id"])
        results = {}
        for name, qs in (("jax", jax_qs), ("torch", port_qs)):
            algo = qs.snapshot_pairs()[0][0][0]
            real = algo.online_foldin

            def failing(model, deltas, *args, real=real, **kw):
                if any(partition_of("user", d.user, P) == victim for d in deltas):
                    raise RuntimeError("fold failed on purpose")
                return real(model, deltas, *args, **kw)

            algo.online_foldin = failing
            before = [dict(f._cursor) for f in qs.online.followers]
            with pytest.raises(RuntimeError, match="on purpose"):
                qs.online.fold_now()
            after = [dict(f._cursor) for f in qs.online.followers]
            seen = qs.stats_json()["online"]["eventsSeen"]
            algo.online_foldin = real
            again = qs.online.fold_now()
            results[name] = (before, after, seen, again, qs.stats_json()["online"]["eventsSeen"])
        for name, (before, after, seen, again, total) in results.items():
            assert after[victim] == before[victim], name  # rolled back
            assert all(after[p] != before[p] for p in range(P) if p != victim), name  # committed
            assert seen == len(events) - n_victim, name
            assert again == {"events": n_victim, "applied": True}, name
            assert total == len(events), name
        np.testing.assert_allclose(_rows(port_qs)[2], _rows(jax_qs)[2], rtol=FOLD_RTOL, atol=FOLD_ATOL)
    finally:
        jax_qs.close()
        port_qs.close()


def test_a_plain_store_keeps_one_follower_and_its_cursor_name(tmp_path):
    """``partition=None``: the single-stream cursor file name, unchanged."""
    from predictionio_tpu.online.follower import _state_path as jax_state_path
    from predictionio_tpu_torch.online.follower import _state_path

    assert _state_path("d", "app", None) == jax_state_path("d", "app", None)
    assert _state_path("d", "app", "ch", 2) == jax_state_path("d", "app", "ch", 2)
    assert _state_path("d", "app", None, 0) != _state_path("d", "app", None)
