"""The port's multi-process tier on the CPU: 2 and 4 processes started
through the ``PIO_COORDINATOR_*`` triplet (``parallel/distributed.py``,
gloo), each holding only its round-robin shard of the ratings.

* ALS on a mesh whose data axis spans the processes (two positions a
  process, ``local_devices(["cpu"] * 2)``): the bounded re-partition
  (``exchange_by_owner``), then the sweep with the solved rows
  all-gathered and the hot Gramians all-reduced; and without a mesh (the
  COO gathered whole). Both held to the JAX package's single-process
  factors from the same injected start at rtol 2e-4, atol 2e-5
  (tests/test_multihost_als.py's band). The JAX package's own
  multi-process tests cannot run here (its CPU backend has no
  multi-process collectives); its single-process train is the reference.
* Two-Tower on a ``(processes × 1, 2)`` mesh, every process on the
  job's pairs, held to the JAX single-device towers at rtol 1e-3, atol
  1e-4.
* The four ALS and Two-Tower DataSources reading their shard of one
  event set (each process's own in-memory store holds all of it): the
  same BiMaps on every process, the shards disjoint and complete, and
  the trained model the single-process port model's.

Every job gets a free port and a time limit, and runs beside the others
(one module fixture starts them); the workers import no JAX (their
references come from this process as files).
"""

import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops import twotower as jax_tt

ROOT = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT_S = 150


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Job:
    """``nproc`` processes of ``script`` with the triplet set on a free port,
    started at once; :meth:`result` waits for them (each job has its own
    time limit, counted from its start), so the jobs of this file run
    beside one another and beside the work of the main process."""

    def __init__(self, script: str, nproc: int, timeout: float = WORKER_TIMEOUT_S):
        port = free_port()
        self.deadline = time.monotonic() + timeout
        self.procs = [
            subprocess.Popen(
                [sys.executable, "-c", script],
                env={
                    **os.environ,
                    "PYTHONPATH": os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
                    "PIO_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                    "PIO_NUM_PROCESSES": str(nproc),
                    "PIO_PROCESS_ID": str(i),
                    "OMP_NUM_THREADS": "1",
                },
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for i in range(nproc)
        ]
        self.outs: list | None = None

    def result(self) -> list:
        """The processes' outputs; fails on any non-zero exit or timeout."""
        if self.outs is None:
            try:
                self.outs = [p.communicate(timeout=max(1.0, self.deadline - time.monotonic()))[0]
                             for p in self.procs]
            finally:
                self.kill()
        for i, (p, out) in enumerate(zip(self.procs, self.outs)):
            assert p.returncode == 0, f"process {i} ended with {p.returncode}:\n{out}"
        return self.outs

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


TRAIN_WORKER = """
import numpy as np, torch
torch.set_num_threads(1)
from predictionio_tpu_torch.parallel import distributed, sharding
from predictionio_tpu_torch.parallel.exchange import allgather_objects, exchange_traffic, reset_exchange_traffic
assert distributed.initialize_from_env(device="cpu") is True
assert distributed.backend() == "gloo"
P, me = distributed.process_count(), distributed.process_index()
from predictionio_tpu_torch.controller import mesh_context
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.ops.twotower import TwoTowerConfig, train_two_tower

data = np.load(%(data)r)
expect = np.load(%(expect)r)
sl = slice(me, None, P)  # round-robin shard: this process's ratings only
cfg = als.ALSConfig(rank=8, iterations=4, reg=0.5, seed=11, bucket_widths=(4, 8), chunk_entries=256,
                    hot_group_slots=4)
with sharding.local_devices(["cpu"] * 2):
    ctx = mesh_context()
assert ctx.has_mesh and ctx.mesh.shape == {"data": 2 * P, "model": 1} and ctx.num_hosts == P
conf = ctx.mesh_conf()
assert conf["processes"] == str(P) and conf["backend"] == "gloo", conf
calls = []
real = als.spd_solve
als.spd_solve = lambda A, b, method: calls.append(A.shape[0]) or real(A, b, method)
reset_exchange_traffic()
args = (data["rows"][sl], data["cols"][sl], data["vals"][sl], int(data["num_users"]), int(data["num_items"]), cfg)
f = als.train_als(*args, init_user=expect["init_user"], init_item=expect["init_item"], mesh=ctx.mesh)
np.testing.assert_allclose(f.user.numpy(), expect["user"], rtol=2e-4, atol=2e-5)
np.testing.assert_allclose(f.item.numpy(), expect["item"], rtol=2e-4, atol=2e-5)
plan = cfg.iterations * (als.planned_solves(data["rows"], int(data["num_users"]), cfg, data=2, processes=P)
                         + als.planned_solves(data["cols"], int(data["num_items"]), cfg, data=2, processes=P))
assert len(calls) == plan, (len(calls), plan)
traffic = exchange_traffic()
# the re-partition is point to point: on each side a process receives at
# most the ratings it owns (20 bytes each: two int64 ids, a float32)
owned = 20 * (np.count_nonzero(data["rows"] %% P == me) + np.count_nonzero(data["cols"] %% P == me))
assert 0 < traffic["p2p_received"] <= 1.1 * owned + 4096, (traffic, owned)
assert traffic["allgather_received"] == 0, traffic
# the mesh-less multi-process path: every process trains the whole COO
g = als.train_als(*args, init_user=expect["init_user"], init_item=expect["init_item"], device="cpu")
np.testing.assert_allclose(g.user.numpy(), expect["user"], rtol=2e-4, atol=2e-5)

# Two-Tower: every process holds the job's pairs
tt = np.load(%(tt)r)
with sharding.local_devices(["cpu"] * 2):
    tctx = mesh_context((1, 2))
m = train_two_tower(tt["rows"], tt["cols"], int(tt["num_users"]), int(tt["num_items"]),
                    TwoTowerConfig(dim=16, batch_size=128, epochs=4, learning_rate=0.05, seed=1,
                                   gemm_dtype="float32"),
                    init_user=tt["init_user"], init_item=tt["init_item"], mesh=tctx.mesh)
np.testing.assert_allclose(m.user_vecs, tt["user"], rtol=1e-3, atol=1e-4)
np.testing.assert_allclose(m.item_vecs, tt["item"], rtol=1e-3, atol=1e-4)
print("MULTIHOST-TRAIN-OK", me, len(calls), traffic["p2p_received"])
"""


def train_references(tmp: Path) -> dict:
    """The ratings, the pairs and the JAX package's single-process
    factors and towers, as files for the workers; the worker's script."""
    # rank-8 ratings and λ 0.5: normal equations well conditioned, so the
    # processes' other order of the Gramians' sums (and the port's
    # Gauss-Jordan against the JAX package's Cholesky) stays inside the
    # band; at tests/test_multihost_als.py's uniform ratings and λ 0.05 a
    # rank-8 solve alone moves these factors by 3e-3
    rng = np.random.default_rng(0)
    num_users, num_items, nnz = 50, 30, 900
    U = rng.normal(size=(num_users, 8)) / np.sqrt(8)
    V = rng.normal(size=(num_items, 8)) / np.sqrt(8)
    rows = rng.integers(0, num_users, nnz)
    cols = rng.integers(0, num_items, nnz)
    vals = (U[rows] * V[cols]).sum(1).astype(np.float32) + 3.0
    iu = np.abs(rng.normal(size=(num_users, 8))).astype(np.float32) / np.sqrt(8)
    ii = np.abs(rng.normal(size=(num_items, 8))).astype(np.float32) / np.sqrt(8)
    cfg = jax_als.ALSConfig(rank=8, iterations=4, reg=0.5, seed=11, bucket_widths=(4, 8), chunk_entries=256,
                            hot_group_slots=4)
    ref = jax_als.train_als(rows, cols, vals, num_users, num_items, cfg, init_user=iu, init_item=ii)
    np.savez(tmp / "data.npz", rows=rows, cols=cols, vals=vals, num_users=num_users, num_items=num_items)
    np.savez(tmp / "expect.npz", user=np.asarray(ref.user), item=np.asarray(ref.item), init_user=iu,
             init_item=ii)

    tt_rows, tt_cols = rng.integers(0, 60, 128), rng.integers(0, 30, 128)
    tu = (rng.normal(size=(60, 16)) / 4).astype(np.float32)
    ti = (rng.normal(size=(30, 16)) / 4).astype(np.float32)
    # one batch an epoch on the JAX side: the same batch whatever the
    # permutation, as each port process draws its own
    single = jax_tt.train_two_tower(
        tt_rows, tt_cols, 60, 30,
        jax_tt.TwoTowerConfig(dim=16, batch_size=128, epochs=4, learning_rate=0.05, seed=1, gemm_dtype="float32"),
        init_user=tu, init_item=ti,
    )
    np.savez(tmp / "tt.npz", rows=tt_rows, cols=tt_cols, num_users=60, num_items=30, init_user=tu, init_item=ti,
             user=single.user_vecs, item=single.item_vecs)
    return TRAIN_WORKER % {"data": str(tmp / "data.npz"), "expect": str(tmp / "expect.npz"), "tt": str(tmp / "tt.npz")}


@pytest.mark.parametrize("nproc", [2, 4])
def test_train_matches_jax_single_process(jobs, nproc):
    outs = jobs[f"train{nproc}"].result()
    for i, out in enumerate(outs):
        assert f"MULTIHOST-TRAIN-OK {i}" in out, out


TEMPLATE_WORKER = """
import pickle, numpy as np, torch
torch.set_num_threads(1)
from predictionio_tpu_torch.parallel import distributed, sharding
assert distributed.initialize_from_env(device="cpu") is True
P, me = distributed.process_count(), distributed.process_index()
from predictionio_tpu_torch.controller import mesh_context
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.parallel.exchange import allgather_objects, global_sum_array

Storage.configure({
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
})
app_id = Storage.get_meta_data_apps().insert(App(id=0, name="mh"))
le = Storage.get_l_events()
le.init(app_id)
events = pickle.load(open(%(events)r, "rb"))
for name, u, i, props in events:
    le.insert(Event(event=name, entity_type="user" if name != "$set" else "item", entity_id=u,
                    target_entity_type=None if i is None else "item", target_entity_id=i,
                    properties=DataMap(props)), app_id)
with sharding.local_devices(["cpu"]):
    ctx = mesh_context()
assert ctx.num_hosts == P and ctx.host_index == me
expect = pickle.load(open(%(expect)r, "rb"))

def same_everywhere(value):
    got = allgather_objects(value)
    assert all(g == got[0] for g in got), "processes disagree"
    return got[0]

from predictionio_tpu_torch.templates.recommendation import engine as rec
td = rec.RecommendationDataSource(rec.DataSourceParams(app_name="mh")).read_training(ctx)
assert same_everywhere((td.user_index.keys(), td.item_index.keys())) == expect["rec_keys"]
assert int(global_sum_array(np.array([td.rows.size]))[0]) == expect["rec_nnz"]
model = rec.ALSAlgorithm(rec.ALSAlgorithmParams(rank=8, num_iterations=4, lambda_=0.5, seed=11),
                         device="cpu").train(ctx, td)
np.testing.assert_allclose(model.user_factors, expect["rec_user"], rtol=2e-4, atol=2e-5)

from predictionio_tpu_torch.templates.similarproduct import engine as sp
td = sp.SimilarProductDataSource(sp.DataSourceParams(app_name="mh")).read_training(ctx)
assert same_everywhere((td.user_index.keys(), td.item_index.keys())) == expect["sp_keys"]
assert td.categories == expect["categories"]
mine = {(td.user_index.inverse(r), td.item_index.inverse(c)): v for r, c, v in zip(td.rows, td.cols, td.vals)}
assert sorted(kv for part in allgather_objects(sorted(mine.items())) for kv in part) == expect["sp_counts"]
model = sp.ALSAlgorithm(sp.ALSAlgorithmParams(rank=8, num_iterations=4, seed=3), device="cpu").train(ctx, td)
np.testing.assert_allclose(model.item_factors, expect["sp_item"], rtol=2e-4, atol=2e-5)

from predictionio_tpu_torch.templates.ecommerce import engine as ec
td = ec.ECommerceDataSource(ec.DataSourceParams(app_name="mh")).read_training(ctx)
assert same_everywhere((td.user_index.keys(), td.item_index.keys())) == expect["ec_keys"]
np.testing.assert_array_equal(td.popularity, expect["ec_popularity"])

from predictionio_tpu_torch.templates.twotower import engine as tt
td = tt.TwoTowerDataSource(tt.DataSourceParams(app_name="mh", event_names=("view", "buy"))).read_training(ctx)
assert (td.user_index.keys(), td.item_index.keys(), sorted(zip(td.rows.tolist(), td.cols.tolist()))) == expect["tt"]
print("MULTIHOST-TEMPLATES-OK", me)
"""


def _events(seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    events = []
    for u in range(30):
        for i in range(20):
            r = rng.random()
            if r < 0.3:
                events.append(("rate", f"u{u}", f"i{i}", {"rating": float(rng.integers(1, 6))}))
            elif r < 0.5:
                events.append(("view", f"u{u}", f"i{i}", {}))
            elif r < 0.55:
                events.append(("buy", f"u{u}", f"i{i}", {}))
    for i in range(22):  # two items only $set, never viewed
        events.append(("$set", f"i{i}", None, {"categories": [f"c{i % 3}"]}))
    return events


def sorted_layout(td):
    """``td`` with sorted BiMaps, its COO and popularity re-indexed."""
    from predictionio_tpu_torch.data.bimap import BiMap

    users = BiMap.string_index(sorted(td.user_index.keys()))
    items = BiMap.string_index(sorted(td.item_index.keys()))
    u_map = np.array([users[u] for u in td.user_index.keys()])
    i_map = np.array([items[i] for i in td.item_index.keys()])
    td.rows, td.cols = u_map[td.rows], i_map[td.cols]
    if hasattr(td, "popularity"):
        pop = np.zeros_like(td.popularity)
        pop[i_map] = td.popularity
        td.popularity = pop
    td.user_index, td.item_index = users, items
    return td


def template_expectation(tmp_path: Path) -> str:
    """The single-process reads and models of the four DataSources, as
    files for the workers; the worker's script."""
    from predictionio_tpu_torch.controller import local_context
    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.templates.ecommerce import engine as ec
    from predictionio_tpu_torch.templates.recommendation import engine as rec
    from predictionio_tpu_torch.templates.similarproduct import engine as sp
    from predictionio_tpu_torch.templates.twotower import engine as tt

    events = _events()
    Storage.configure({
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    })
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="mh"))
        le = Storage.get_l_events()
        le.init(app_id)
        for name, u, i, props in events:
            le.insert(Event(event=name, entity_type="user" if name != "$set" else "item", entity_id=u,
                            target_entity_type=None if i is None else "item", target_entity_id=i,
                            properties=DataMap(props)), app_id)
        ctx = local_context("cpu")
        # the single-process reference: the per-event read's triples in the
        # sorted BiMaps the processes agree on
        triples = sorted(rec.RecommendationDataSource(rec.DataSourceParams(app_name="mh"))._read_ratings_stream(ctx))
        users = rec.BiMap.string_index(sorted({u for u, _, _ in triples}))
        items = rec.BiMap.string_index(sorted({i for _, i, _ in triples}))
        td = rec.TrainingData(
            rows=np.array([users[u] for u, _, _ in triples]), cols=np.array([items[i] for _, i, _ in triples]),
            vals=np.array([r for _, _, r in triples], np.float32), user_index=users, item_index=items,
        )
        rec_model = rec.ALSAlgorithm(rec.ALSAlgorithmParams(rank=8, num_iterations=4, lambda_=0.5, seed=11),
                                     device="cpu").train(ctx, td)
        # one process appends the $set-only items to its item vocabulary,
        # several build theirs sorted (both packages): the reference is the
        # one-process read laid out in the sorted BiMaps
        sp_td = sorted_layout(sp.SimilarProductDataSource(sp.DataSourceParams(app_name="mh")).read_training(ctx))
        sp_model = sp.ALSAlgorithm(sp.ALSAlgorithmParams(rank=8, num_iterations=4, seed=3), device="cpu").train(
            ctx, sp_td)
        ec_td = sorted_layout(ec.ECommerceDataSource(ec.DataSourceParams(app_name="mh")).read_training(ctx))
        tt_td = tt.TwoTowerDataSource(tt.DataSourceParams(app_name="mh", event_names=("view", "buy"))
                                      ).read_training(ctx)
    finally:
        Storage.configure(None)
    expect = {
        "rec_keys": (td.user_index.keys(), td.item_index.keys()), "rec_nnz": int(td.rows.size),
        "rec_user": rec_model.user_factors,
        "sp_keys": (sp_td.user_index.keys(), sp_td.item_index.keys()), "categories": sp_td.categories,
        "sp_counts": sorted(
            ((sp_td.user_index.inverse(r), sp_td.item_index.inverse(c)), v)
            for r, c, v in zip(sp_td.rows, sp_td.cols, sp_td.vals)
        ),
        "sp_item": sp_model.item_factors,
        "ec_keys": (ec_td.user_index.keys(), ec_td.item_index.keys()), "ec_popularity": ec_td.popularity,
        "tt": (tt_td.user_index.keys(), tt_td.item_index.keys(),
               sorted(zip(tt_td.rows.tolist(), tt_td.cols.tolist()))),
    }
    (tmp_path / "events.pkl").write_bytes(pickle.dumps(events))
    (tmp_path / "expect.pkl").write_bytes(pickle.dumps(expect))
    return TEMPLATE_WORKER % {"events": str(tmp_path / "events.pkl"), "expect": str(tmp_path / "expect.pkl")}


def test_template_coherence(jobs):
    """Each process reads its shard of one event set through the four
    DataSources: the BiMaps agree on every process, the merged counts and
    the popularity are the single-process read's, and the ALS models are
    the single-process port's (the port's seeded draw on both sides)."""
    for i, out in enumerate(jobs["templates"].result()):
        assert f"MULTIHOST-TEMPLATES-OK {i}" in out, out


def cli_store(tmp_path: Path) -> tuple[str, str]:
    """One sqlite store under ``$PIO_FS_BASEDIR``: an app, its events,
    ``pio export --sharded 2`` and a single-process ``pio train``. Returns
    that instance's id and the script of one ``pio train --mesh data=1``
    process."""
    import json

    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.parallel.reader import shard_paths
    from predictionio_tpu_torch.tools import console

    rng = np.random.default_rng(4)
    lines = [
        {"event": "rate", "entityType": "user", "entityId": f"u{u}", "targetEntityType": "item",
         "targetEntityId": f"i{i}", "properties": {"rating": float(rng.integers(1, 6))}}
        for u in range(60) for i in range(40) if rng.random() < 0.3
    ]
    events = tmp_path / "events.json"
    events.write_text("".join(json.dumps(line) + "\n" for line in lines))
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps({
        "id": "mh", "version": "1", "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
        "datasource": {"params": {"appName": "mh"}},
        "algorithms": [{"name": "als", "params": {"rank": 8, "numIterations": 4, "lambda": 0.5, "seed": 3}}],
    }))
    Storage.configure(None)
    try:
        assert console.main(["app", "new", "mh"]) == 0
        assert console.main(["import", "--appname", "mh", "--input", str(events)]) == 0
        assert console.main(["export", "--appname", "mh", "--output", str(tmp_path / "shards"), "--sharded", "2"]) == 0
        assert len(shard_paths(str(tmp_path / "shards"))) == 2
        assert console.main(["train", "--engine-json", str(engine_json), "--device", "cpu"]) == 0
        (single,) = Storage.get_meta_data_engine_instances().get_all()
    finally:
        Storage.configure(None)
    script = (
        "import sys\n"
        "from predictionio_tpu_torch.tools import console\n"
        f"sys.exit(console.main(['train', '--engine-json', {str(engine_json)!r}, '--mesh', 'data=1', "
        "'--device', 'cpu']))\n"
    )
    return single.id, script


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every multi-process job of this file, each started as soon as the
    main process has made its inputs: the DataSources on 2 processes,
    ``pio train --mesh data=1`` on 2 over the store of :func:`cli_store`
    (``$PIO_FS_BASEDIR`` set for the module), and the ALS and Two-Tower
    trains on 2 and 4."""
    from predictionio_tpu_torch.data.storage import Storage

    started: dict = {}
    env = pytest.MonkeyPatch()
    try:
        # the longest job first
        started["templates"] = Job(template_expectation(tmp_path_factory.mktemp("mh_templates")), 2)
        cli_dir = tmp_path_factory.mktemp("mh_cli")
        env.setenv("PIO_FS_BASEDIR", str(cli_dir / "store"))
        started["cli_single"], script = cli_store(cli_dir)
        started["cli"] = Job(script, 2)
        script = train_references(tmp_path_factory.mktemp("mh"))
        for nproc in (2, 4):
            started[f"train{nproc}"] = Job(script, nproc)
        yield started
    finally:
        for job in started.values():
            if isinstance(job, Job):
                job.kill()
        env.undo()
        Storage.configure(None)


def test_pio_train_on_two_processes_writes_the_single_process_blob(jobs):
    """``pio export --sharded 2``, then ``pio train --mesh data=1`` in two
    processes through the triplet on one sqlite store: process 0 writes the
    one new instance (its ``mesh_conf`` naming 2 processes and gloo) and a
    blob whose factors are the single-process ``pio train``'s to the bit
    (on the CPU the processes' per-row arithmetic is one device's)."""
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.utils.serialization import loads_model

    jobs["cli"].result()
    Storage.configure(None)
    try:
        instances = [i for i in Storage.get_meta_data_engine_instances().get_all() if i.id != jobs["cli_single"]]
        assert len(instances) == 1 and instances[0].status == "COMPLETED"
        conf = instances[0].mesh_conf
        assert conf["processes"] == "2" and conf["backend"] == "gloo" and conf["axes"] == str({"data": 2})
        models = [
            loads_model(Storage.get_model_data_models().get(inst_id).models)[0][1]
            for inst_id in (jobs["cli_single"], instances[0].id)
        ]
    finally:
        Storage.configure(None)
    one, two = models
    assert one.user_index.keys() == two.user_index.keys() and one.item_index.keys() == two.item_index.keys()
    np.testing.assert_array_equal(one.user_factors, two.user_factors)
    np.testing.assert_array_equal(one.item_factors, two.item_factors)
