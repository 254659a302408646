"""The incremental training cache of the port's Recommendation DataSource
against the JAX package's, on one columnar store, on the CPU.

Both packages read one columnar event store and one metadata database;
each keeps its training cache under its own ``PIO_FS_BASEDIR`` (the cache
lives at ``<base>/train_cache/<tag>.{npz,json}``). Through a cold read, a
delta of new segments and tail lines, a compaction (the cache goes
stale), a delete (the tombstones change) and an unchanged store, each
package's read must give TrainingData equal to the other's and to a full
read with ``incremental=False``, and must take the path the JAX package
takes (the DataSource's "Incremental re-index" log record says which).
Last, a cache written by one package is copied under the other's base
and read there, in both directions.
"""

import dataclasses
import datetime as dt
import logging
import shutil

import numpy as np
import pytest

from predictionio_tpu.controller import local_context as jax_local_context
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.templates.recommendation import engine as jax_rec
from predictionio_tpu_torch.controller.context import local_context
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.templates.recommendation import engine as port_rec

UTC = dt.timezone.utc
APP_NAME = "inc"
T0 = 1_600_000_000_000_000
USERS = np.asarray([f"u{i}" for i in range(60)])
ITEMS = np.asarray([f"i{i}" for i in range(40)])


def _env(tmp_path, pkg: str) -> dict:
    return {
        "PIO_FS_BASEDIR": str(tmp_path / f"base-{pkg}"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "META",
        "PIO_STORAGE_SOURCES_META_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_META_PATH": str(tmp_path / "meta" / "pio.db"),
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "COL",
        "PIO_STORAGE_SOURCES_COL_TYPE": "columnar",
        "PIO_STORAGE_SOURCES_COL_PATH": str(tmp_path / "events"),
        "PIO_STORAGE_SOURCES_COL_SEGMENT_ROWS": "200",
    }


@pytest.fixture
def store(tmp_path):
    Storage.configure(_env(tmp_path, "port"))
    JaxStorage.configure(_env(tmp_path, "jax"))
    app_id = Storage.get_meta_data_apps().insert(App(id=0, name=APP_NAME))
    Storage.get_l_events().init(app_id)
    yield tmp_path, app_id
    Storage.configure(None)
    JaxStorage.configure(None)


def _write(app_id: int, seed: int, n: int, users=USERS) -> None:
    """``n`` rate/buy events as one new segment, coarse times (ties)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2, n)
    Storage.get_p_events().write_columns(
        app_id,
        event=(codes.astype(np.int32), np.asarray(["buy", "rate"])),
        entity_type="user",
        entity_codes=rng.integers(0, users.size, n),
        entity_vocab=users,
        target_entity_type="item",
        target_codes=rng.integers(0, ITEMS.size, n),
        target_vocab=ITEMS,
        event_time_us=T0 + 10**6 * rng.integers(0, 40, n).astype(np.int64) + seed * 10**8,
        props={"rating": np.where(codes == 1, rng.integers(1, 11, n) / 2, np.nan)},
    )


def _tail(app_id: int, seed: int, n: int) -> list:
    """``n`` single events into the tail, some of new users and items."""
    rng = np.random.default_rng(seed)
    return [
        Storage.get_l_events().insert(Event(
            event="rate", entity_type="user", entity_id=f"t{rng.integers(0, 8)}" if k % 2 else str(USERS[k]),
            target_entity_type="item", target_entity_id=f"j{k % 5}" if k % 3 == 0 else str(ITEMS[k]),
            properties=DataMap({"rating": float(rng.integers(1, 11)) / 2}),
            event_time=dt.datetime(2022, 1, 1, tzinfo=UTC) + dt.timedelta(seconds=seed * 100 + k),
        ), app_id)
        for k in range(n)
    ]


def _read(pkg: str, caplog, incremental: bool = True) -> tuple:
    """One read by ``pkg``'s DataSource; returns the data and what the
    DataSource logged about the cache ("merged", "unchanged" or None)."""
    caplog.clear()
    if pkg == "jax":
        ds = jax_rec.RecommendationDataSource(jax_rec.DataSourceParams(app_name=APP_NAME, incremental=incremental))
        td = ds.read_training(jax_local_context())
    else:
        ds = port_rec.RecommendationDataSource(
            port_rec.DataSourceParams(app_name=APP_NAME, incremental=incremental))
        td = ds.read_training(local_context("cpu"))
    said = " ".join(r.getMessage() for r in caplog.records if r.name.endswith("recommendation.engine"))
    path = "merged" if "merged" in said else "unchanged" if "unchanged" in said else None
    assert "failed" not in said, said
    return td, path


def _assert_same(a, b) -> None:
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.cols, b.cols)
    np.testing.assert_array_equal(a.vals, b.vals)
    assert a.vals.dtype == b.vals.dtype == np.float32
    assert a.user_index.to_dict() == b.user_index.to_dict()
    assert a.item_index.to_dict() == b.item_index.to_dict()


def _check(caplog, want_path) -> tuple:
    """Both packages' reads equal each other and a full read."""
    full, _ = _read("port", caplog, incremental=False)
    jax_full, _ = _read("jax", caplog, incremental=False)
    port, port_path = _read("port", caplog)
    jax, jax_path = _read("jax", caplog)
    assert (port_path, jax_path) == (want_path, want_path)
    for td in (jax_full, port, jax):
        _assert_same(full, td)
    return full


def _cache(tmp_path, pkg: str):
    return tmp_path / f"base-{pkg}" / "train_cache"


@pytest.fixture(autouse=True)
def _info_logs(caplog):
    caplog.set_level(logging.INFO)


def test_cold_delta_compaction_delete_and_unchanged(store, caplog):
    tmp_path, app_id = store
    _write(app_id, 1, 700)
    _tail(app_id, 2, 9)
    cold = _check(caplog, None)
    assert sorted(p.suffix for p in _cache(tmp_path, "port").iterdir()) == [".json", ".npz"]

    # a delta: two new segments and more tail lines, new users and items
    _write(app_id, 3, 150)
    _write(app_id, 4, 120, np.asarray([f"n{i}" for i in range(15)]))
    _tail(app_id, 5, 7)
    delta = _check(caplog, "merged")
    assert len(delta.user_index) > len(cold.user_index)

    # nothing new: the cache is the data
    _check(caplog, "unchanged")

    # a compaction consumes the tail: every cache is stale
    assert Storage.get_l_events().compact(app_id) == 16
    _check(caplog, None)

    # a delete adds a tombstone: stale again
    victim = _tail(app_id, 6, 3)[1]
    _check(caplog, "merged")
    assert Storage.get_l_events().delete(victim, app_id)
    _check(caplog, None)


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_a_cache_written_by_one_package_serves_the_other(store, caplog, writer, reader):
    tmp_path, app_id = store
    _write(app_id, 1, 500)
    _tail(app_id, 2, 5)
    _read(writer, caplog)
    _write(app_id, 3, 90, np.asarray([f"n{i}" for i in range(10)]))
    _tail(app_id, 4, 6)
    shutil.rmtree(_cache(tmp_path, reader), ignore_errors=True)
    shutil.copytree(_cache(tmp_path, writer), _cache(tmp_path, reader))
    td, path = _read(reader, caplog)
    assert path == "merged"
    full, _ = _read(writer, caplog, incremental=False)
    _assert_same(full, td)
    # the cache the reader rewrote serves the writer in turn
    shutil.rmtree(_cache(tmp_path, writer))
    shutil.copytree(_cache(tmp_path, reader), _cache(tmp_path, writer))
    back, path = _read(writer, caplog)
    assert path == "unchanged"
    _assert_same(full, back)


def test_cache_files_have_the_jax_package_layout(store, caplog):
    tmp_path, app_id = store
    _write(app_id, 1, 300)
    _read("port", caplog)
    _read("jax", caplog)
    port_files = sorted(p.name for p in _cache(tmp_path, "port").iterdir())
    assert port_files == sorted(p.name for p in _cache(tmp_path, "jax").iterdir())
    (npz,) = [p for p in port_files if p.endswith(".npz")]
    with np.load(_cache(tmp_path, "port") / npz) as ours, np.load(_cache(tmp_path, "jax") / npz) as ref:
        assert sorted(ours.files) == sorted(ref.files)
        for key in ours.files:
            if key != "__payload_id__":
                assert ours[key].dtype == ref[key].dtype, key
                np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    port_ds = port_rec.RecommendationDataSource(port_rec.DataSourceParams(app_name=APP_NAME))
    jax_ds = jax_rec.RecommendationDataSource(jax_rec.DataSourceParams(app_name=APP_NAME))
    assert port_ds._cache_manifest() == jax_ds._cache_manifest()
    assert [p.rsplit("/", 1)[-1] for p in port_ds._cache_paths()] == [
        p.rsplit("/", 1)[-1] for p in jax_ds._cache_paths()]
    assert dataclasses.asdict(port_ds.params)["incremental"] is True
