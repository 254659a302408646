"""The port's columnar event store against the JAX package's, on the CPU.

Both packages keep one on-disk format: a store written by either is read
by the other with equal results. One package writes a stream through
every write path the driver has — ``write_columns``, ``ingest_chunk``
with explicit ids (a retransmitted chunk is absorbed), single inserts
into the JSON-lines tail, ``compact``, a delete (a tombstone) — and a
fresh client of each package then reads it: ``find_columns`` (every
array, with and without filters), ``find``, ``get``, ``scan_state`` and
``stream_stats`` must be equal. Startup recovery of the same damaged copy
(a torn tail line, an orphan ``.tmp``) and a background-compaction sweep
with the same config must give the same reports and the same surviving
events. Last, the storage-contract cases of
``tests/test_storage_contract.py`` run against the port's columnar
client.
"""

import dataclasses
import datetime as dt
import itertools
import json
import re
import shutil
import uuid

import numpy as np
import pytest

import test_storage_contract as contract
from predictionio_tpu.data import event as jax_event
from predictionio_tpu.data import ingest as jax_ingest
from predictionio_tpu.data.storage import columnar as jax_columnar
from predictionio_tpu.data.storage import compaction as jax_compaction
from predictionio_tpu.data.storage.base import StorageClientConfig as JaxConfig
from predictionio_tpu_torch.data import event as port_event
from predictionio_tpu_torch.data import ingest as port_ingest
from predictionio_tpu_torch.data.storage import StorageError
from predictionio_tpu_torch.data.storage import columnar as port_columnar
from predictionio_tpu_torch.data.storage import compaction as port_compaction
from predictionio_tpu_torch.data.storage.base import StorageClientConfig as PortConfig

UTC = dt.timezone.utc
APP = 3
CHANNEL = 2
T0 = 1_600_000_000_000_000

PACKAGES = {
    "jax": (jax_columnar, jax_event, jax_ingest, jax_compaction, JaxConfig),
    "port": (port_columnar, port_event, port_ingest, port_compaction, PortConfig),
}


def _client(pkg: str, path, segment_rows: int = 50):
    columnar, _, _, _, config = PACKAGES[pkg]
    return columnar.StorageClient(
        config("C", "columnar", {"path": str(path), "segment_rows": str(segment_rows)})
    )


def _bulk_lines(rng, start: int, n: int) -> list:
    """NDJSON lines with client event ids, some sharing a (user, item)."""
    out = []
    for k in range(start, start + n):
        obj = {"event": "rate" if k % 3 else "buy", "entityType": "user", "entityId": f"u{rng.integers(0, 30)}",
               "targetEntityType": "item", "targetEntityId": f"i{rng.integers(0, 20)}",
               "eventTime": f"2021-06-01T00:{k // 60 % 60:02d}:{k % 60:02d}.000Z", "eventId": f"b{k}"}
        if k % 3:
            obj["properties"] = {"rating": float(rng.integers(1, 11)) / 2}
        if k % 11 == 0:
            obj["properties"] = {**obj.get("properties", {}), "note": "text", "tags": ["a"]}
        out.append((json.dumps(obj) + "\n").encode())
    return out


def _populate(pkg: str, path, seed: int = 0) -> dict:
    """Every write path of the driver, through ``pkg``; returns the ids
    the reads are checked with."""
    columnar, event, ingest, _, _ = PACKAGES[pkg]
    rng = np.random.default_rng(seed)
    client = _client(pkg, path)
    le, pe = client.get_l_events(), client.get_p_events()
    n = 300
    pe.write_columns(
        APP,
        event="rate",
        entity_type="user",
        entity_codes=rng.integers(0, 40, n),
        entity_vocab=np.asarray([f"u{i}" for i in range(40)]),
        target_entity_type="item",
        target_codes=rng.integers(0, 25, n),
        target_vocab=np.asarray([f"i{i}" for i in range(25)]),
        event_time_us=T0 + rng.integers(0, 10**9, n).astype(np.int64),
        props={"rating": (rng.integers(1, 11, n) / 2).astype(np.float64)},
    )
    lines = _bulk_lines(rng, 0, 120)
    now_us = T0 + 5 * 10**9
    chunk = ingest.parse_chunk(lines, 0, now_us=now_us).chunk
    assert not any(dup for _, dup in le.ingest_chunk(chunk, APP))
    # a retransmit of the last 40 lines is absorbed whole
    again = ingest.parse_chunk(lines[80:], 80, now_us=now_us).chunk
    assert all(dup for _, dup in le.ingest_chunk(again, APP))
    tail_ids = [
        le.insert(event.Event(event="rate", entity_type="user", entity_id=f"u{k}", target_entity_type="item",
                              target_entity_id=f"i{k % 4}", properties=event.DataMap({"rating": 1.0 + k}),
                              event_time=dt.datetime(2021, 7, 1, 0, 0, k, tzinfo=UTC)), APP)
        for k in range(6)
    ]
    assert le.compact(APP) == 6
    late = [
        le.insert(event.Event(event="view", entity_type="user", entity_id=f"u{k}", target_entity_type="item",
                              target_entity_id="i1", properties=event.DataMap({"note": "x"}),
                              event_time=dt.datetime(2021, 7, 2, 0, 0, k, tzinfo=UTC)), APP)
        for k in range(4)
    ]
    le.insert(event.Event(event="rate", entity_type="user", entity_id="c1", target_entity_type="item",
                          target_entity_id="i9", properties=event.DataMap({"rating": 2.5}),
                          event_time=dt.datetime(2021, 7, 3, tzinfo=UTC)), APP, CHANNEL)
    assert le.delete(late[1], APP)  # a tail tombstone
    assert le.delete("b7", APP)  # a tombstone in an explicit-id segment
    client.close()
    return {"get": [tail_ids[0], tail_ids[5], late[0], late[1], "b3", "b7", "b100", "missing"]}


def _events(pkg: str, events) -> list:
    to_json = PACKAGES[pkg][1].event_to_json
    return [json.dumps(to_json(e), sort_keys=True, default=str) for e in events]


def _columns(cols) -> dict:
    return {f.name: getattr(cols, f.name) for f in dataclasses.fields(cols)}


def _read(pkg: str, path, ids: list) -> dict:
    """Everything a reader sees of the store, in comparable form."""
    client = _client(pkg, path)
    le, pe = client.get_l_events(), client.get_p_events()
    out = {
        "find": _events(pkg, le.find(APP)),
        "find_rate_u3": _events(pkg, le.find(APP, event_names=["rate"], entity_id="u3")),
        "find_channel": _events(pkg, le.find(APP, CHANNEL)),
        "pfind": _events(pkg, pe.find(APP)),
        "get": [None if e is None else _events(pkg, [e])[0] for e in (le.get(i, APP) for i in ids)],
        "columns": _columns(pe.find_columns(APP)),
        "columns_rated": _columns(pe.find_columns(APP, entity_type="user", event_names=["rate", "buy"],
                                                  prop="rating")),
        "scan_state": pe.scan_state(APP),
        "stream_stats": sorted(le.stream_stats(), key=lambda s: (s["app_id"], s["channel_id"] or 0)),
    }
    state = out["scan_state"]
    out["columns_delta"] = _columns(pe.find_columns(APP, prop="rating", segments=state["segments"][-1:],
                                                    tail_skip=1))
    client.close()
    return out


def _assert_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for key in a:
        if key.startswith("columns"):
            assert a[key].keys() == b[key].keys()
            for name in a[key]:
                x, y = a[key][name], b[key][name]
                assert (x is None) == (y is None), (key, name)
                if x is not None:
                    assert x.dtype == y.dtype, (key, name)
                    np.testing.assert_array_equal(x, y, err_msg=f"{key}.{name}")
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_written_by_one_package_reads_equal_in_both(tmp_path, writer):
    ids = _populate(writer, tmp_path / "store")["get"]
    jax_view = _read("jax", tmp_path / "store", ids)
    port_view = _read("port", tmp_path / "store", ids)
    _assert_equal(jax_view, port_view)
    # the reads saw every path: 300 + 120 bulk + 6 compacted + 4 tail,
    # less the two tombstones
    assert len(port_view["find"]) == 300 + 120 + 6 + 4 - 2
    assert port_view["scan_state"]["compactions"] == 1 and port_view["scan_state"]["tombstones"] == 2
    assert port_view["get"][-1] is None and port_view["get"][3] is None and port_view["get"][5] is None


def test_both_packages_write_the_same_store(tmp_path):
    """The same writes through each package leave stores that read the
    same, apart from the ids the store draws at random (tail inserts)."""
    _populate("jax", tmp_path / "a")
    _populate("port", tmp_path / "b")
    a, b = _read("port", tmp_path / "a", []), _read("port", tmp_path / "b", [])
    for view in (a, b):
        for key in ("find", "find_rate_u3", "find_channel", "pfind"):
            view[key] = sorted(
                json.dumps({k: v for k, v in json.loads(e).items() if k not in ("eventId", "creationTime")})
                for e in view[key]
            )
        view["scan_state"].pop("stream_id")
        view["scan_state"]["segments"] = len(view["scan_state"]["segments"])
    _assert_equal(a, b)


def _damage(path) -> None:
    (stream,) = [p for p in (path / "pio_events").glob("app_*/default")]
    with open(stream / "tail.jsonl", "ab") as f:
        f.write(b'{"event": "rate", "entityType": "us')  # torn: no newline, cut mid-object
    (stream / "seg-orphan.npz.tmp").write_bytes(b"\0" * 64)


def test_recovery_sweeps_the_same_damage_alike(tmp_path):
    ids = _populate("jax", tmp_path / "store")["get"]
    reports, views = {}, {}
    for pkg in PACKAGES:
        copy = tmp_path / f"copy-{pkg}"
        shutil.copytree(tmp_path / "store", copy)
        _damage(copy)
        client = _client(pkg, copy)
        report = client.recovery_report()
        client.close()
        # quarantined files keep their name plus a random suffix
        report["quarantined"] = sorted(re.sub(r"\.[0-9a-f]{8}", "", p.rsplit("/", 1)[-1])
                                       for p in report["quarantined"])
        report.pop("dedupWarmMs")
        reports[pkg] = report
        views[pkg] = _read(pkg, copy, ids)
    assert reports["jax"] == reports["port"]
    assert reports["port"]["tornTailLines"] == 1
    assert reports["port"]["quarantined"] == ["seg-orphan.npz.tmp", "tail.torn.jsonl"]
    _assert_equal(views["jax"], views["port"])
    assert len(views["port"]["find"]) == 300 + 120 + 6 + 4 - 2


def test_compaction_sweep_compacts_the_same_streams(tmp_path, monkeypatch):
    _populate("jax", tmp_path / "store")
    swept, views = {}, {}
    for pkg, (_, _, _, compaction, _) in PACKAGES.items():
        copy = tmp_path / f"copy-{pkg}"
        shutil.copytree(tmp_path / "store", copy)
        client = _client(pkg, copy)
        scheduler = compaction.CompactionScheduler(
            client.get_l_events(),
            compaction.CompactionConfig(tail_bytes_high=200, dead_tombstones_high=10**6, min_interval_s=0.0),
        )
        # a segment is named seg-<seq>-<random hex>, and a reopened store's
        # seq starts again at 1 in both packages, so the compaction's segment
        # shares its number with an older one and the random part decides
        # which of the two is read first: both packages draw the same names
        # here, so that their reads can be compared row for row
        suffixes = itertools.count(1)
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(suffixes) << 96))
        swept[pkg] = (scheduler.sweep_once(), scheduler.sweep_once())
        monkeypatch.undo()
        stats = scheduler.to_json()
        swept[pkg] += (stats["compactions"], stats["eventsMoved"], stats["errors"])
        client.close()
        views[pkg] = _read(pkg, copy, [])
        # a compaction's segment carries a random name suffix
        views[pkg]["scan_state"]["segments"] = [name[:10] for name in views[pkg]["scan_state"]["segments"]]
        views[pkg].pop("columns_delta")
    # the default stream's tail (3 live lines, one tombstoned) and the
    # channel's one line are over 200 bytes; a second sweep finds none
    assert swept["jax"] == swept["port"] == (2, 0, 2, 4, 0)
    _assert_equal(views["jax"], views["port"])
    assert views["port"]["scan_state"]["tail_lines"] == 0


def test_partitioned_layouts_are_refused(tmp_path):
    """The partitioned layout opens (it was refused until it was ported;
    the name is kept), and what the JAX package refuses the port refuses:
    a partitioned store opened as a single stream, or with another
    partition count."""
    client = port_columnar.StorageClient(PortConfig("C", "columnar", {"path": str(tmp_path), "partitions": "4"}))
    assert client.get_l_events().partition_count == 4
    client.close()
    with pytest.raises(StorageError, match="partitioned"):
        port_columnar.StorageClient(PortConfig("C", "columnar", {"path": str(tmp_path)}))
    with pytest.raises(StorageError, match="partition count mismatch"):
        port_columnar.StorageClient(PortConfig("C", "columnar", {"path": str(tmp_path), "partitions": "3"}))


# ------------------------------------------------------------ the contract
@pytest.fixture
def events_client(tmp_path, monkeypatch):
    """The port's columnar client, as the contract suite builds the JAX
    one (``segment_rows=4`` forces several segments), with the suite's
    events made of the port's classes."""
    monkeypatch.setattr(contract, "Event", port_event.Event)
    monkeypatch.setattr(contract, "DataMap", port_event.DataMap)
    c = port_columnar.StorageClient(
        PortConfig("C", "columnar", {"path": str(tmp_path / "cols"), "segment_rows": "4"})
    )
    yield c
    c.close()


class TestPortLEventsContract(contract.TestLEventsContract):
    pass


class TestPortPEventsContract(contract.TestPEventsContract):
    pass


@pytest.mark.parametrize(
    "case", ["test_empty_event_names_matches_nothing", "test_limit_zero_and_negative", "test_microsecond_roundtrip"]
)
def test_port_review_regressions(events_client, case):
    getattr(contract.TestReviewRegressions(), case)(events_client)
