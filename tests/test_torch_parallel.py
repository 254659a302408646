"""The port's distribution layer on the CPU: parallel/reader.py,
parallel/distributed.py (the ``PIO_COORDINATOR_*`` start and the backend
rule) and parallel/exchange.py (the bounded all-to-all), the JAX
package's cases of tests/test_parallel.py and tests/test_multihost_als.py
on the port's modules. Multi-process cases start their processes with a
free port and a time limit, over gloo."""

import os
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from predictionio_tpu.parallel import reader as jax_reader
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.parallel import distributed, exchange, reader

ROOT = Path(__file__).resolve().parents[1]


def _events(n: int) -> list:
    return [Event(event="rate", entity_type="user", entity_id=f"u{i}", target_entity_type="item",
                  target_entity_id=f"i{i % 7}") for i in range(n)]


class TestEventShards:
    def test_write_read_round_trip(self, tmp_path):
        evs = _events(25)
        paths = reader.write_event_shards(evs, str(tmp_path), num_shards=4)
        assert len(paths) == 4
        got = sorted(e.entity_id for e in reader.read_event_shards(str(tmp_path)))
        assert got == sorted(e.entity_id for e in evs)
        # the JAX package reads the port's shards as its own
        assert sorted(e.entity_id for e in jax_reader.read_event_shards(str(tmp_path))) == got

    def test_host_assignment_partitions_exactly(self, tmp_path):
        reader.write_event_shards(_events(40), str(tmp_path), num_shards=8)
        seen = []
        for host in range(3):
            mine = [e.entity_id for e in reader.read_event_shards(str(tmp_path), host, 3)]
            assert mine
            seen += mine
        assert sorted(seen) == sorted(f"u{i}" for i in range(40))

    def test_incomplete_shard_set_detected(self, tmp_path):
        paths = reader.write_event_shards(_events(10), str(tmp_path), num_shards=3)
        os.remove(paths[1])
        with pytest.raises(ValueError, match="Incomplete"):
            list(reader.read_event_shards(str(tmp_path)))

    def test_empty_dir_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            reader.shard_paths(str(tmp_path))


class TestDistributedEnv:
    def test_noop_without_env(self, monkeypatch):
        monkeypatch.delenv("PIO_COORDINATOR_ADDRESS", raising=False)
        assert distributed.initialize_from_env(device="cpu") is False
        assert distributed.process_count() == 1 and distributed.process_index() == 0
        assert distributed.backend() is None and not distributed.is_multihost()

    def test_bad_triplet_raises(self, monkeypatch):
        monkeypatch.setenv("PIO_COORDINATOR_ADDRESS", "127.0.0.1:1")
        monkeypatch.setenv("PIO_NUM_PROCESSES", "2")
        monkeypatch.setenv("PIO_PROCESS_ID", "2")
        with pytest.raises(ValueError, match="not a rank"):
            distributed.initialize_from_env(device="cpu")

    def test_set_triplet_whose_init_fails_raises(self, monkeypatch):
        """No coordinator answers: the rendezvous fails and raises; it
        never carries on as a single process."""
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        monkeypatch.setenv("PIO_COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
        monkeypatch.setenv("PIO_NUM_PROCESSES", "2")
        monkeypatch.setenv("PIO_PROCESS_ID", "1")
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rendezvous"):
            distributed.initialize_from_env(device="cpu", timeout_s=1)
        assert time.monotonic() - t0 < 30
        assert distributed.process_count() == 1

    @pytest.mark.parametrize("published, require_nccl, want", [
        # one card each, on one host or two: NCCL
        ([{"host": "a", "type": "cuda", "index": None, "count": 2}] * 2, None, ("nccl", ["cuda:0", "cuda:1"])),
        ([{"host": "a", "type": "cuda", "index": None, "count": 1},
          {"host": "b", "type": "cuda", "index": None, "count": 1}], None, ("nccl", ["cuda:0", "cuda:0"])),
        # two processes on one card: gloo
        ([{"host": "a", "type": "cuda", "index": None, "count": 1}] * 2, None, ("gloo", ["cuda:0", "cuda:0"])),
        ([{"host": "a", "type": "cuda", "index": 0, "count": 4}] * 2, None, ("gloo", ["cuda:0", "cuda:0"])),
        # the CPU: gloo
        ([{"host": "a", "type": "cpu", "index": None, "count": 0}] * 2, None, ("gloo", ["cpu", "cpu"])),
        # NCCL required where every process has a card of its own
        ([{"host": "a", "type": "cuda", "index": None, "count": 2}] * 2, True, ("nccl", ["cuda:0", "cuda:1"])),
    ])
    def test_backend_rule(self, published, require_nccl, want):
        assert distributed.choose_backend(published, bool(require_nccl)) == want

    @pytest.mark.parametrize("published, why", [
        ([{"host": "a", "type": "cuda", "index": None, "count": 1}] * 2, "share cuda:0 on a"),
        ([{"host": "a", "type": "cpu", "index": None, "count": 0}], "on the CPU"),
    ])
    def test_nccl_request_on_a_shared_card_raises(self, published, why):
        with pytest.raises(ValueError, match=why):
            distributed.choose_backend(published, require_nccl=True)


class Job:
    """``nproc`` processes of ``script`` with the triplet set on a free port,
    started at once; :meth:`result` waits for them within ``timeout`` of
    their start, so the jobs of this file run beside one another."""

    def __init__(self, script: str, nproc: int, timeout: float = 120):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
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


EXCHANGE_WORKER = """
import numpy as np, torch
from predictionio_tpu_torch.parallel import distributed
assert distributed.initialize_from_env(device="cpu") is True
from predictionio_tpu_torch.parallel.exchange import (
    allgather_objects, exchange_by_owner, exchange_objects_by_owner, exchange_traffic, global_sum_array,
    global_vocab, merge_keyed, reset_exchange_traffic,
)
P, me = distributed.process_count(), distributed.process_index()
assert allgather_objects({"p": me}) == [{"p": p} for p in range(P)]
local = np.arange(5) + me * 5
got = exchange_by_owner([local, local * 10.0], local %% P)
assert (got[0] %% P == me).all(), got[0]
assert sorted(x for g in allgather_objects(got[0].tolist()) for x in g) == list(range(5 * P))
np.testing.assert_allclose(got[1], got[0] * 10.0)
assert global_vocab(["b%%d" %% me, "a"]) == ["a"] + ["b%%d" %% p for p in range(P)]
assert global_sum_array(np.array([me, 1])).tolist() == [sum(range(P)), P]
items = exchange_objects_by_owner([("k", me), ("j", me)], [0, P - 1])
assert sorted(items) == sorted([("k", p) for p in range(P)] * (me == 0) + [("j", p) for p in range(P)] * (me == P - 1))
m = merge_keyed({("u%%d" %% me, "i"): 1.0, ("shared", "i"): 2.0}, combine=lambda a, b: a + b)
assert sum(v for mm in allgather_objects(m) for v in mm.values()) == 3.0 * P
# the O(data) bound: this process's 400 kB goes to ONE peer, point to
# point; the collective fallback moves every process's data to all
import os
big = np.arange(100_000, dtype=np.float32) + me
for transport in ("p2p", "allgather"):
    os.environ["PIO_EXCHANGE_TRANSPORT"] = transport
    reset_exchange_traffic()
    got_big = exchange_by_owner([big], np.full(100_000, (me + 1) %% P, np.int64))
    assert got_big[0].shape == (100_000,) and float(got_big[0][0]) == float((me - 1) %% P)
    tr = exchange_traffic()
    if transport == "p2p":
        assert 390_000 < tr["p2p_sent"] < 450_000 and 390_000 < tr["p2p_received"] < 450_000, tr
        assert tr["allgather_received"] == 0, tr
    else:
        assert tr["p2p_sent"] == 0 and tr["allgather_received"] >= 400_000 * P, tr
# a step checkpoint written in the process group: one step, every process reads it
from predictionio_tpu_torch.utils.checkpoint import CheckpointManager
mgr = CheckpointManager(%(ckpt)r)
mgr.save(3, {"user": torch.arange(12.0).view(4, 3)})
distributed.barrier()
assert mgr.latest_step() == 3
assert torch.equal(mgr.restore()["user"], torch.arange(12.0).view(4, 3))
print("EXCHANGE-OK", me, tr)
"""


def test_exchange_primitives_and_counters(jobs):
    """Three processes: the primitives, the byte counters of both
    transports (``PIO_EXCHANGE_TRANSPORT`` is read at each call), and a
    step checkpoint saved and restored in the process group."""
    job, ckpt = jobs["exchange"]
    for i, out in enumerate(job.result()):
        assert f"EXCHANGE-OK {i}" in out, out
    assert sorted(os.listdir(ckpt)) == ["3"]


DEAD_PEER_WORKER = """
import sys, time
from predictionio_tpu_torch.parallel import distributed
assert distributed.initialize_from_env(device="cpu") is True
from predictionio_tpu_torch.parallel.exchange import allgather_objects, pairwise_exchange
P, me = distributed.process_count(), distributed.process_index()
if me == P - 1:
    # rendezvous with a dead address, then vanish: the peers must fail
    # cleanly, not hang
    allgather_objects(("127.0.0.1", 1, b"x" * 16))  # port 1: nothing listens
    print("DEADPEER-OK", me)
    sys.exit(0)
t0 = time.time()
try:
    pairwise_exchange([b"m%d" % p for p in range(P)], timeout=10.0)
except Exception as e:
    assert time.time() - t0 < 45, "a hang instead of a clean failure"
    print("DEADPEER-OK", me)
    sys.exit(0)
print("DEADPEER-FAIL no error raised", me)
sys.exit(1)
"""


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The multi-process jobs of this file, started together: the exchange
    on three processes, the dead peer on two."""
    ckpt = tmp_path_factory.mktemp("exchange") / "ck"
    started = {"dead_peer": Job(DEAD_PEER_WORKER, 2, timeout=90)}
    started["exchange"] = (Job(EXCHANGE_WORKER % {"ckpt": str(ckpt)}, 3), ckpt)
    try:
        yield started
    finally:
        started["dead_peer"].kill()
        started["exchange"][0].kill()


def test_dead_peer_fails_cleanly_not_hangs(jobs):
    outs = jobs["dead_peer"].result()
    assert all("DEADPEER-OK" in out for out in outs), outs


def test_rogue_connection_is_dropped_not_fatal(monkeypatch):
    """An untrusted connector reaching the exchange port mid-window is
    rejected by the token check and does not consume the accept budget:
    the real peers still complete (two threads acting as ranks 0/1)."""
    tl = threading.local()
    monkeypatch.setattr(exchange, "process_count", lambda: 2)
    monkeypatch.setattr(exchange, "process_index", lambda: tl.rank)
    store: dict = {}
    barrier = threading.Barrier(2)
    lock = threading.Lock()
    rogue_done = threading.Event()

    def fake_allgather(obj):
        with lock:
            store[tl.rank] = obj
        barrier.wait()
        out = [store[0], store[1]]
        rogue_done.wait(timeout=20)
        return out

    monkeypatch.setattr(exchange, "allgather_objects", fake_allgather)
    results: dict = {}
    errors: dict = {}

    def run(rank, payloads):
        tl.rank = rank
        try:
            results[rank] = exchange.pairwise_exchange(payloads, timeout=20.0)
        except Exception as e:
            errors[rank] = e

    t0 = threading.Thread(target=run, args=(0, [b"keep0", b"zero->one"]))
    t1 = threading.Thread(target=run, args=(1, [b"one->zero", b"keep1"]))
    t0.start()
    t1.start()
    for _ in range(200):
        with lock:
            if len(store) == 2:
                break
        time.sleep(0.05)
    _, port, _token = store[0]
    evil = b"evil pickle payload"
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(struct.pack("<iq16s", 1, len(evil), b"W" * 16) + evil)
    rogue_done.set()
    t0.join(timeout=30)
    t1.join(timeout=30)
    assert not errors, errors
    assert results[0] == [b"keep0", b"one->zero"]
    assert results[1] == [b"zero->one", b"keep1"]


def test_single_process_exchange_is_local():
    import numpy as np

    a = np.arange(6)
    got = exchange.exchange_by_owner([a], np.array([0, 1, 0, 0, 1, 0]))
    assert got[0].tolist() == [0, 2, 3, 5]
    assert exchange.merge_keyed({"k": 1}, combine=max) == {"k": 1}
    assert exchange.global_vocab(["b", "a", "b"]) == ["a", "b"]
    assert exchange.allgather_objects({"x": 1}) == [{"x": 1}]
    assert exchange.crc_owner("user-7", 4) == exchange.crc_owner("user-7", 4) < 4
