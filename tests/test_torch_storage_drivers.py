"""The port's distributed storage drivers against the JAX package's, on the CPU.

* The reference's own cases run on the port's classes: every case of
  ``tests/test_partitioned_ingest.py`` (routing, the sealed count, one
  partition's failure, ``TestQuorumReplication``, follower cursors across
  compaction and restart, the ``partition=`` requirement), the classes of
  ``tests/test_remote_storage.py`` and its compact proxy cases, and the
  contract classes of ``tests/test_storage_contract.py`` through the
  ``remote`` driver. The contracts are the reference tests' own
  assertions; under the port the test modules' globals and the modules
  their cases import in their bodies are the port's.
* One on-disk format: a partitioned, replicated columnar store written by
  one package through ``write_columns``, ``ingest_chunk`` (with a
  retransmit) and single inserts reads equal in a fresh client of either
  package: ``find_columns`` (merged, and each ``partition=``), ``find``,
  ``scan_state``, ``stream_stats_partitioned``, ``replication_health``,
  and ``sweep_recovery`` of a torn copy.
* One wire format: each package's ``StorageClient`` against each
  package's ``StorageRpcService`` returns the same entities, paginated
  scans and model blobs as the JAX client against the JAX server.
* The slice: over a partitioned, replicated store and over ``TYPE=remote``
  the port's ``RecommendationDataSource`` gives the JAX package's
  ``TrainingData`` bit for bit, and the port's ``run_train`` factors agree
  with JAX ``train_als`` from the same seeded draw (rtol 5e-3, atol 5e-4,
  ``tests/test_torch_recommendation.py``'s band).
* ``LEventStore.find_by_entity(timeout=)`` against a stalled storage
  server raises within the deadline in both packages.
"""

import base64
import contextlib
import dataclasses
import datetime as dt
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import predictionio_tpu_torch.data.event as port_event
import predictionio_tpu_torch.data.ingest as port_ingest
import predictionio_tpu_torch.data.storage as port_storage
import predictionio_tpu_torch.data.storage.base as port_base
import predictionio_tpu_torch.workflow as port_workflow
import predictionio_tpu_torch.workflow.serving as port_serving
import test_partitioned_ingest as part_cases
import test_remote_storage as remote_cases
import test_storage_contract as contract
from predictionio_tpu.api import http as jax_http
from predictionio_tpu.controller import local_context as jax_local_context
from predictionio_tpu.data import event as jax_event
from predictionio_tpu.data import ingest as jax_ingest
from predictionio_tpu.data import store as jax_store
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage import columnar as jax_columnar
from predictionio_tpu.data.storage import localfs as jax_localfs
from predictionio_tpu.data.storage import remote as jax_remote
from predictionio_tpu.data.storage import sharedfs as jax_sharedfs
from predictionio_tpu.data.storage import sqlite as jax_sqlite
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.templates.recommendation.engine import DataSourceParams as JaxDataSourceParams
from predictionio_tpu.templates.recommendation.engine import (
    RecommendationDataSource as JaxRecommendationDataSource,
)
from predictionio_tpu.workflow import load_engine_variant as jax_load_variant
from predictionio_tpu.workflow import run_train as jax_run_train
from predictionio_tpu_torch.api import http as port_http
from predictionio_tpu_torch.data import store as port_store
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.storage import columnar as port_columnar
from predictionio_tpu_torch.data.storage import localfs as port_localfs
from predictionio_tpu_torch.data.storage import partitioned as port_partitioned
from predictionio_tpu_torch.data.storage import remote as port_remote
from predictionio_tpu_torch.data.storage import replication as port_replication
from predictionio_tpu_torch.data.storage import sharedfs as port_sharedfs
from predictionio_tpu_torch.data.storage import sqlite as port_sqlite
from predictionio_tpu_torch.ops.als import seed_factors
from predictionio_tpu_torch.templates.recommendation.engine import DataSourceParams, RecommendationDataSource
from torch_package_swap import controller_module, use_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UTC = dt.timezone.utc
APP = 3
T0 = 1_600_000_000_000_000
RTOL, ATOL = 5e-3, 5e-4

#: one package's modules, by the role the tests give them
PKG = {
    "jax": dict(event=jax_event, ingest=jax_ingest, base=jax_base, columnar=jax_columnar, remote=jax_remote,
                sqlite=jax_sqlite, localfs=jax_localfs, sharedfs=jax_sharedfs, http=jax_http, Storage=JaxStorage,
                store=jax_store),
    "torch": dict(event=port_event, ingest=port_ingest, base=port_base, columnar=port_columnar, remote=port_remote,
                  sqlite=port_sqlite, localfs=port_localfs, sharedfs=port_sharedfs, http=port_http,
                  Storage=Storage, store=port_store),
}


# ------------------------------------------- the reference's cases, ported
@pytest.fixture()
def port_partitioned_cases(monkeypatch):
    """``test_partitioned_ingest``'s globals bound to the port's objects."""
    for name, value in dict(
        Event=port_event.Event, DataMap=port_event.DataMap, IngestPipeline=port_ingest.IngestPipeline,
        StorageClientConfig=port_base.StorageClientConfig, StorageError=port_base.StorageError,
        StorageClient=port_columnar.StorageClient, MARKER_NAME=port_partitioned.MARKER_NAME,
        open_partitioned=port_partitioned.open_partitioned, partition_of=port_partitioned.partition_of,
        QuorumLostError=port_replication.QuorumLostError, ReplicatedEvents=port_replication.ReplicatedEvents,
    ).items():
        monkeypatch.setattr(part_cases, name, value)


PARTITIONED_CASES = sorted(
    name for name, obj in vars(part_cases).items()
    if name.startswith("test_") and callable(obj) and name != "test_partitioned_ingest_defaults_are_opt_in"
)


@pytest.mark.parametrize("case", PARTITIONED_CASES)
def test_partitioned_reference_case_on_the_port(port_partitioned_cases, tmp_path, case):
    fn = getattr(part_cases, case)
    fn(tmp_path) if fn.__code__.co_argcount else fn()


def test_partitioned_defaults_are_opt_in_on_the_port(port_partitioned_cases, tmp_path, monkeypatch):
    """The reference's opt-in case on the port: its layout half as it is,
    then its import probe with the port's module names."""
    real_run = subprocess.run

    def port_probe(args, **kw):
        args = [a.replace("predictionio_tpu.", "predictionio_tpu_torch.") for a in args]
        return real_run(args, **kw)

    monkeypatch.setattr(part_cases.subprocess, "run", port_probe)
    part_cases.test_partitioned_ingest_defaults_are_opt_in(tmp_path)


@pytest.mark.usefixtures("port_partitioned_cases")
class TestPortPartitionCountIsSealed(part_cases.TestPartitionCountIsSealed):
    pass


@pytest.mark.usefixtures("port_partitioned_cases")
class TestPortQuorumReplication(part_cases.TestQuorumReplication):
    pass


@pytest.fixture()
def port_remote_cases(monkeypatch):
    """``test_remote_storage``'s globals and body imports bound to the
    port's objects, its query server and ``local_context`` on the CPU."""
    use_port(
        monkeypatch,
        remote_cases,
        dict(start_background=port_http.start_background, Storage=Storage, remote=port_remote, sqlite=port_sqlite,
             App=port_base.App, Model=port_base.Model, StorageClientConfig=port_base.StorageClientConfig),
        {
            "predictionio_tpu.data.event": port_event,
            "predictionio_tpu.data.storage": port_storage,
            "predictionio_tpu.data.storage.base": port_base,
            "predictionio_tpu.controller": controller_module(),
            "predictionio_tpu.workflow": port_workflow,
            "predictionio_tpu.workflow.serving": port_serving,
        },
    )
    # ``from predictionio_tpu.data.storage import columnar`` reads the
    # package attribute, and the port's package must have both
    monkeypatch.setattr(port_storage, "columnar", port_columnar, raising=False)
    monkeypatch.setattr(port_storage, "sharedfs", port_sharedfs, raising=False)


@pytest.fixture()
def live_server(port_remote_cases, tmp_path):
    """The reference's fixture, on the port's server and sqlite."""
    backing = port_sqlite.StorageClient(port_base.StorageClientConfig("B", "sqlite", {"path": str(tmp_path / "b.db")}))
    with _rpc_server("torch", backing) as port:
        yield port
    backing.close()


@pytest.mark.usefixtures("port_remote_cases")
class TestPortRegistryIntegration(remote_cases.TestRegistryIntegration):
    pass


@pytest.mark.usefixtures("port_remote_cases")
class TestPortPaginatedScans(remote_cases.TestPaginatedScans):
    pass


@pytest.mark.usefixtures("port_remote_cases")
class TestPortMultiHostModelHandoff(remote_cases.TestMultiHostModelHandoff):
    pass


@pytest.mark.parametrize("case", ["test_compact_proxies_to_columnar_backing", "test_compact_on_tailless_backing_is_clean_error"])
def test_remote_compact_case_on_the_port(port_remote_cases, request, tmp_path, case):
    fn = getattr(remote_cases, case)
    fn(request.getfixturevalue("live_server")) if "live_server" in fn.__code__.co_varnames else fn(tmp_path)


def test_port_cases_bind_the_ports_classes(port_partitioned_cases, port_remote_cases):
    from predictionio_tpu.data.storage import sharedfs

    for obj in (part_cases.open_partitioned, part_cases.ReplicatedEvents, remote_cases.remote.StorageClient,
                remote_cases.start_background, sharedfs.StorageClient):
        assert obj.__module__.startswith("predictionio_tpu_torch."), obj


# ---------------------------------------------- the contract over the wire
WIRES = [("torch", "torch"), ("torch", "jax"), ("jax", "torch")]


@contextlib.contextmanager
def _rpc_server(pkg: str, backing):
    mods = PKG[pkg]
    server, _ = mods["http"].start_background(mods["remote"].StorageRpcService(client=backing).dispatch)
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()


def _remote_client(pkg: str, port: int, **props):
    mods = PKG[pkg]
    return mods["remote"].StorageClient(
        mods["base"].StorageClientConfig("R", "remote", {"hosts": "127.0.0.1", "ports": str(port), **props})
    )


@pytest.fixture(params=WIRES, ids=lambda w: f"client-{w[0]}-server-{w[1]}")
def wire(request, tmp_path, monkeypatch):
    """A ``remote`` client of one package against a storage server of
    the other (or the port's own), the server over its package's sqlite;
    the contract's entities are the client package's classes."""
    client_pkg, server_pkg = request.param
    mods = PKG[client_pkg]
    for name in ("Event", "DataMap"):
        monkeypatch.setattr(contract, name, getattr(mods["event"], name))
    for name in ("AccessKey", "App", "Channel", "EngineInstance", "Model", "StorageClientConfig"):
        monkeypatch.setattr(contract, name, getattr(mods["base"], name))
    for name in ("localfs", "sharedfs"):
        monkeypatch.setattr(contract, name, mods[name])
    smods = PKG[server_pkg]
    backing = smods["sqlite"].StorageClient(smods["base"].StorageClientConfig("B", "sqlite", {"path": str(tmp_path / "b.db")}))
    with _rpc_server(server_pkg, backing) as port:
        c = _remote_client(client_pkg, port)
        yield c
        c.close()
    backing.close()


@pytest.fixture()
def client(wire):
    return wire


@pytest.fixture()
def events_client(wire):
    return wire


class TestWireLEventsContract(contract.TestLEventsContract):
    pass


class TestWirePEventsContract(contract.TestPEventsContract):
    pass


class TestWireMetadataContract(contract.TestMetadataContract):
    pass


class TestWireReviewRegressions(contract.TestReviewRegressions):
    pass


@pytest.mark.usefixtures("wire")
class TestWireFsModels(contract.TestFsModels):
    """``localfs``/``sharedfs`` of the client package (the wire fixture
    binds them)."""


# ------------------------------------------------------ one wire format
def _wire_script(pkg: str, port: int) -> dict:
    """One script of calls through ``pkg``'s client; the results in
    comparable form (entities as their JSON dicts)."""
    mods = PKG[pkg]
    b, ev = mods["base"], mods["event"]
    c = _remote_client(pkg, port)
    out: dict = {}
    apps, keys, chans = c.get_apps(), c.get_access_keys(), c.get_channels()
    app_id = apps.insert(b.App(0, "wire", "the wire app"))
    keys.insert(b.AccessKey("k-1", app_id, ("rate",)))
    ch = chans.insert(b.Channel(0, "side", app_id))
    out["apps"] = [dataclasses.asdict(a) for a in apps.get_all()]
    out["keys"] = [dataclasses.asdict(k) for k in keys.get_by_appid(app_id)]
    out["channels"] = [dataclasses.asdict(x) for x in chans.get_by_appid(app_id)]
    t0 = dt.datetime(2024, 1, 1, tzinfo=UTC)
    inst = b.EngineInstance(
        id="inst-1", status="COMPLETED", start_time=t0, end_time=t0 + dt.timedelta(seconds=5), engine_id="e",
        engine_version="1", engine_variant="v", engine_factory="f", batch="", env={"a": "b"},
        datasource_params="{}", preparator_params="{}", algorithms_params="[]", serving_params="{}",
    )
    c.get_engine_instances().insert(inst)
    out["instance"] = dataclasses.asdict(c.get_engine_instances().get("inst-1"))
    out["latest"] = dataclasses.asdict(c.get_engine_instances().get_latest_completed("e", "1", "v"))
    blob = bytes(range(256)) * 37
    c.get_models().insert(b.Model("inst-1", blob))
    out["blob"] = base64.b64encode(c.get_models().get("inst-1").models).decode()
    le = c.get_l_events()
    le.init(app_id)
    le.init(app_id, ch)
    events = [
        ev.Event(event="rate" if k % 4 else "view", entity_type="user", entity_id=f"u{k % 9}",
                 target_entity_type="item", target_entity_id=f"i{k % 5}",
                 properties=ev.DataMap({"rating": float(k % 5 + 1), "tags": ["x", k]}),
                 event_time=t0 + dt.timedelta(seconds=k, microseconds=k), event_id=f"e{k}")
        for k in range(23)
    ]
    out["inserted"] = le.insert_batch_dedup(events, app_id)
    out["retransmit"] = le.insert_batch_dedup(events[:5], app_id)
    le.insert(ev.Event(event="buy", entity_type="user", entity_id="u1", event_id="side-1", event_time=t0), app_id, ch)
    def js(es) -> list:  # creationTime is the insert's wall clock
        return [json.dumps({k: v for k, v in ev.event_to_json(e).items() if k != "creationTime"}, sort_keys=True)
                for e in es]

    out["find"] = js(le.find(app_id))
    out["find_rev_rate"] = js(le.find(app_id, event_names=["rate"], reversed=True, limit=11))
    out["find_entity"] = js(le.find(app_id, entity_type="user", entity_id="u3"))
    out["find_channel"] = js(le.find(app_id, ch))
    out["get"] = js([le.get("e7", app_id)])
    out["shards"] = [js(c.get_p_events().find(app_id, shard_index=s, num_shards=2)) for s in range(2)]
    out["deleted"] = le.delete("e7", app_id)
    out["after_delete"] = len(list(le.find(app_id)))
    c.close()
    return out


@pytest.mark.parametrize("client_pkg,server_pkg", WIRES)
def test_one_wire_format(tmp_path, monkeypatch, client_pkg, server_pkg):
    """Equal entities, paginated scans (7 events a page) and blobs to the
    JAX client against the JAX server's."""
    monkeypatch.setenv("PIO_REMOTE_FIND_PAGE", "7")
    got = {}
    for cp, sp in (("jax", "jax"), (client_pkg, server_pkg)):
        smods = PKG[sp]
        backing = smods["sqlite"].StorageClient(
            smods["base"].StorageClientConfig("B", "sqlite", {"path": str(tmp_path / f"{cp}-{sp}.db")})
        )
        pages = []
        real = smods["remote"].StorageRpcService._find_page
        monkeypatch.setattr(smods["remote"].StorageRpcService, "_find_page",
                            staticmethod(lambda repo, kw, real=real: pages.append(1) or real(repo, kw)))
        with _rpc_server(sp, backing) as port:
            got[(cp, sp)] = _wire_script(cp, port)
        got[(cp, sp)]["pages"] = len(pages)
        monkeypatch.undo()
        monkeypatch.setenv("PIO_REMOTE_FIND_PAGE", "7")
        backing.close()
    want, have = got[("jax", "jax")], got[(client_pkg, server_pkg)]
    assert have.keys() == want.keys()
    for key in want:
        assert have[key] == want[key], key
    assert len(want["find"]) == 23 and want["pages"] > 6 and want["retransmit"] == [(f"e{k}", True) for k in range(5)]


# ------------------------------------------------------ one on-disk format
STORE_PROPS = {"partitions": "3", "replication": "2", "ack_quorum": "2", "segment_rows": "40"}


def _part_client(pkg: str, path):
    mods = PKG[pkg]
    return mods["columnar"].StorageClient(mods["base"].StorageClientConfig("C", "columnar", {"path": str(path), **STORE_PROPS}))


def _populate(pkg: str, path) -> list:
    """A partitioned, replicated store through ``write_columns``,
    ``ingest_chunk`` (and a retransmit, all duplicates) and single
    inserts; returns ids for ``get``."""
    mods = PKG[pkg]
    rng = np.random.default_rng(7)
    client = _part_client(pkg, path)
    le, pe = client.get_l_events(), client.get_p_events()
    n = 240
    assert pe.write_columns(
        APP, event="rate", entity_type="user", entity_codes=rng.integers(0, 40, n),
        entity_vocab=np.asarray([f"u{i}" for i in range(40)]), target_entity_type="item",
        target_codes=rng.integers(0, 25, n), target_vocab=np.asarray([f"i{i}" for i in range(25)]),
        event_time_us=T0 + rng.integers(0, 10**9, n).astype(np.int64),
        props={"rating": (rng.integers(1, 11, n) / 2).astype(np.float64)},
    ) == n
    lines = [
        (json.dumps({"event": "rate", "entityType": "user", "entityId": f"u{rng.integers(0, 50)}",
                     "targetEntityType": "item", "targetEntityId": f"i{rng.integers(0, 30)}",
                     "properties": {"rating": float(rng.integers(1, 6))},
                     "eventTime": f"2021-06-01T00:{k // 60:02d}:{k % 60:02d}.000Z", "eventId": f"b{k}"}) + "\n").encode()
        for k in range(90)
    ]
    chunk = mods["ingest"].parse_chunk(lines, 0, now_us=T0).chunk
    assert not any(dup for _, dup in le.ingest_chunk(chunk, APP))
    again = mods["ingest"].parse_chunk(lines, 0, now_us=T0).chunk
    assert all(dup for _, dup in le.ingest_chunk(again, APP))
    ev = mods["event"]
    ids = [
        le.insert(ev.Event(event="rate", entity_type="user", entity_id=f"s{k}", target_entity_type="item",
                           target_entity_id=f"i{k % 4}", properties=ev.DataMap({"rating": 1.0 + k}),
                           event_time=dt.datetime(2021, 7, 1, 0, 0, k, tzinfo=UTC)), APP)
        for k in range(8)
    ]
    _wait_in_sync(le)
    client.close()
    return ids + ["b3", "b88", "missing"]


def _wait_in_sync(le, timeout_s: float = 20.0) -> None:
    """Until every follower replica has caught up with its leader."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        health = le.replication_health()
        if all(h["lag"] and all(v["inSync"] for v in h["lag"].values()) for h in health):
            return
        time.sleep(0.05)
    raise AssertionError(f"replicas never caught up: {le.replication_health()}")


def _columns(cols) -> dict:
    return {f.name: getattr(cols, f.name) for f in dataclasses.fields(cols)}


def _read(pkg: str, path, ids: list) -> dict:
    mods = PKG[pkg]
    client = _part_client(pkg, path)
    le, pe = client.get_l_events(), client.get_p_events()
    js = lambda es: [json.dumps(mods["event"].event_to_json(e), sort_keys=True, default=str) for e in es]  # noqa: E731
    _wait_in_sync(le)
    out = {
        "find": js(le.find(APP)),
        "find_entity": js(le.find(APP, entity_type="user", entity_id="u3")),
        "pfind": js(pe.find(APP)),
        "get": [None if e is None else js([e])[0] for e in (le.get(i, APP) for i in ids)],
        "columns": _columns(pe.find_columns(APP)),
        "columns_rated": _columns(pe.find_columns(APP, entity_type="user", event_names=["rate"], prop="rating")),
        "scan_state": pe.scan_state(APP),
        "stream_stats": le.stream_stats(),
        "stream_stats_partitioned": le.stream_stats_partitioned(),
        "replication_health": le.replication_health(),
        "partition_count": le.partition_count,
    }
    for p in range(3):
        out[f"columns_p{p}"] = _columns(le.find_columns(APP, partition=p, prop="rating"))
        out[f"scan_state_p{p}"] = pe.scan_state(APP, partition=p)
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


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_one_partitioned_replicated_store_reads_equal_in_both(tmp_path, writer):
    ids = _populate(writer, tmp_path / "store")
    views = {pkg: _read(pkg, tmp_path / "store", ids) for pkg in PKG}
    _assert_equal(views["jax"], views["torch"])
    view = views["torch"]
    assert len(view["find"]) == 240 + 90 + 8 and view["partition_count"] == 3
    assert len(view["columns"]["event_code"]) == 338 and view["get"][-1] is None
    assert [h["partition"] for h in view["replication_health"]] == [0, 1, 2]
    assert all(h["quorumOk"] and h["ackQuorum"] == 2 for h in view["replication_health"])
    # each partition holds exactly its crc32-routed share of the users
    for p in range(3):
        cols = view[f"columns_p{p}"]
        users = cols["entity_vocab"][np.unique(cols["entity_code"])]
        assert len(users) and all(port_partitioned.partition_of("user", str(u), 3) == p for u in users)


def test_recovery_sweeps_a_torn_partitioned_copy_alike(tmp_path):
    ids = _populate("jax", tmp_path / "store")
    reports, views = {}, {}
    for pkg in PKG:
        copy = tmp_path / f"copy-{pkg}"
        shutil.copytree(tmp_path / "store", copy)
        for tail in sorted(copy.glob("pio_events/part_01/replica_*/app_*/default/tail.jsonl")):
            with open(tail, "ab") as f:
                f.write(b'{"event": "rate", "entityType": "us')  # torn: cut mid-object
        client = _part_client(pkg, copy)
        report = client.recovery_report()
        client.close()
        # a quarantined file keeps its name plus a random suffix
        report["quarantined"] = sorted(re.sub(r"\.[0-9a-f]{8}", "", p.rsplit("/", 1)[-1]) for p in report["quarantined"])
        report.pop("dedupWarmMs")
        reports[pkg] = report
        views[pkg] = _read(pkg, copy, ids)
    assert reports["jax"] == reports["torch"]
    assert reports["torch"]["tornTailLines"] == 2
    _assert_equal(views["jax"], views["torch"])


def test_store_refusals_match(tmp_path):
    """The sealed count and the single-stream refusal, in both packages."""
    _populate("torch", tmp_path / "store")
    for pkg, mods in PKG.items():
        config = mods["base"].StorageClientConfig
        for props in ({"partitions": "4", "replication": "2"}, {}):
            with pytest.raises(mods["base"].StorageError, match="pio export|partitions.json"):
                mods["columnar"].StorageClient(config("C", "columnar", {"path": str(tmp_path / "store"), **props}))


# ---------------------------------------------------- the slice as a whole
ENGINE = {
    "id": "drivers", "version": "1",
    "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
    "datasource": {"params": {"appName": "drivers"}},
    "algorithms": [{"name": "als", "params": {"rank": 10, "numIterations": 5, "lambda": 0.1, "seed": 1}}],
}


def _fill_app(storage, event_mod, base_mod) -> None:
    app_id = storage.get_meta_data_apps().insert(base_mod.App(0, "drivers"))
    rng = np.random.default_rng(3)
    le = storage.get_l_events()
    le.init(app_id)
    t0 = dt.datetime(2022, 3, 1, tzinfo=UTC)
    events = [
        event_mod.Event(event="rate", entity_type="user", entity_id=f"u{u}", target_entity_type="item",
                        target_entity_id=f"i{i}", properties=event_mod.DataMap({"rating": float((u * i) % 5 + 1)}),
                        event_time=t0 + dt.timedelta(seconds=k))
        for k, (u, i) in enumerate(zip(rng.integers(0, 60, 500), rng.integers(0, 40, 500)))
    ]
    le.insert_batch(events[:300], app_id)
    for e in events[300:]:
        le.insert(e, app_id)


@contextlib.contextmanager
def _both_storages(env: dict):
    Storage.configure(env)
    JaxStorage.configure(env)
    try:
        yield
    finally:
        Storage.configure(None)
        JaxStorage.configure(None)


def _train_and_compare() -> None:
    """TrainingData bit-equal between the packages; the port's trained
    factors against JAX ``train_als`` from the port's seeded draw."""
    from predictionio_tpu_torch.controller import local_context
    from predictionio_tpu_torch.templates.recommendation import engine_factory
    from predictionio_tpu_torch.workflow import load_engine_variant, run_train

    td = RecommendationDataSource(DataSourceParams(app_name="drivers")).read_training(local_context("cpu"))
    ref = JaxRecommendationDataSource(JaxDataSourceParams(app_name="drivers")).read_training(jax_local_context())
    for name in ("rows", "cols", "vals"):
        got, want = getattr(td, name), getattr(ref, name)
        assert got.dtype == want.dtype and got.shape == want.shape and got.size > 400, name
        np.testing.assert_array_equal(got, want)
    assert td.user_index.to_dict() == ref.user_index.to_dict()
    assert td.item_index.to_dict() == ref.item_index.to_dict()
    variant = load_engine_variant(ENGINE)
    inst = run_train(variant, local_context("cpu"))
    jax_inst = jax_run_train(jax_load_variant(ENGINE), jax_local_context())
    assert inst.status == jax_inst.status == "COMPLETED"
    ep = variant.engine_params(engine_factory())
    (_, model), = engine_factory().models_from_bytes(ep, inst.id, Storage.get_model_data_models().get(inst.id).models)
    U, I = len(td.user_index), len(td.item_index)
    want = jax_als.train_als(
        td.rows, td.cols, td.vals, U, I, jax_als.ALSConfig(rank=10, iterations=5, reg=0.1, solver="cholesky"),
        init_user=seed_factors(U, 10, 1, False), init_item=seed_factors(I, 10, 2, False),
    )
    np.testing.assert_allclose(model.user_factors, np.asarray(want.user), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(model.item_factors, np.asarray(want.item), rtol=RTOL, atol=ATOL)
    # the JAX package reads the port's blob through its own driver
    assert JaxStorage.get_model_data_models().get(inst.id).models == Storage.get_model_data_models().get(inst.id).models


def test_train_over_a_partitioned_replicated_store(tmp_path):
    env = {
        "PIO_FS_BASEDIR": str(tmp_path / "base"),
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "COL",
        "PIO_STORAGE_SOURCES_COL_TYPE": "columnar",
        "PIO_STORAGE_SOURCES_COL_PATH": str(tmp_path / "events"),
        **{f"PIO_STORAGE_SOURCES_COL_{k.upper()}": v for k, v in STORE_PROPS.items()},
        "PIO_STORAGE_SOURCES_COL_FSYNC": "true",
    }
    with _both_storages(env):
        _fill_app(Storage, port_event, port_base)
        assert Storage.get_l_events().partition_count == 3
        _train_and_compare()


def test_train_over_type_remote(tmp_path):
    """All three roles ``remote``: the port's ``StorageRpcService`` over
    its sqlite; the JAX client reads through the same server."""
    backing = port_sqlite.StorageClient(port_base.StorageClientConfig("B", "sqlite", {"path": str(tmp_path / "b.db")}))
    with _rpc_server("torch", backing) as port:
        env = {
            "PIO_FS_BASEDIR": str(tmp_path / "base"),
            **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "NET" for r in ("METADATA", "EVENTDATA", "MODELDATA")},
            "PIO_STORAGE_SOURCES_NET_TYPE": "remote",
            "PIO_STORAGE_SOURCES_NET_HOSTS": "127.0.0.1",
            "PIO_STORAGE_SOURCES_NET_PORTS": str(port),
        }
        with _both_storages(env):
            _fill_app(Storage, port_event, port_base)
            _train_and_compare()
    backing.close()
    assert not os.path.exists(tmp_path / "base" / "pio.db")  # every role went over the wire


# ------------------------------------------------ LEventStore's timeout
class _StalledServer:
    """Accepts a storage RPC and answers after ``delay_s``."""

    def __init__(self, delay_s: float):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length") or 0))
                time.sleep(delay_s)
                body = json.dumps({"result": []}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                with contextlib.suppress(BrokenPipeError, ConnectionResetError):  # the client gave up
                    self.wfile.write(body)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_find_by_entity_timeout_cuts_a_stalled_remote_scan(tmp_path, pkg):
    mods = PKG[pkg]
    stalled = _StalledServer(delay_s=3.0)
    storage = mods["Storage"]
    storage.configure({
        "PIO_FS_BASEDIR": str(tmp_path),
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NET",
        "PIO_STORAGE_SOURCES_NET_TYPE": "remote",
        "PIO_STORAGE_SOURCES_NET_HOSTS": "127.0.0.1",
        "PIO_STORAGE_SOURCES_NET_PORTS": str(stalled.server.server_address[1]),
        "PIO_STORAGE_SOURCES_NET_TIMEOUT": "30",
    })
    try:
        storage.get_meta_data_apps().insert(mods["base"].App(0, "stalled"))
        t0 = time.monotonic()
        with pytest.raises(mods["base"].StorageError):
            mods["store"].LEventStore.find_by_entity("stalled", "user", "u1", timeout=0.3)
        assert time.monotonic() - t0 < 2.0
    finally:
        storage.configure(None)
        stalled.close()


def test_find_by_entity_timeout_is_in_the_signature():
    import inspect

    for pkg in PKG.values():
        for name in ("find_by_entity", "find"):
            assert "timeout" in inspect.signature(getattr(pkg["store"].LEventStore, name)).parameters


def test_storageserver_verb_refuses_a_public_bind_without_a_secret(tmp_path):
    env = dict(os.environ, PIO_FS_BASEDIR=str(tmp_path), PYTHONPATH=REPO)
    env.pop("PIO_STORAGE_SERVER_SECRET", None)
    proc = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.console", "storageserver", "--ip", "0.0.0.0", "--port", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode != 0 and "refusing to bind" in proc.stderr
