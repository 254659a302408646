"""The serving drills on the port, on the CPU (``--device cpu`` to the
drill's ``pio train`` and every ``pio deploy``), held to the verdicts the
JAX drills compute.

* ``run_chaos_serve``: 2 replicas, 4 clients, 2 s phases, one rolling
  reload, the throughput sweep at 2 replicas only, and the sharded point
  (each replica sees one device here, so ``--shard-factors`` falls back to
  ``--pin-model`` replication: ``factorShards`` 0 on each, and the report
  says so). Zero failed queries, every killed replica respawned, the
  fleet converged with zero cross-generation answers.
* ``run_chaos_fleet``: 4 clients, 2 s phases, the autoscale phase off.
  The host kill and the stale-while-down phase pass.

Every process a drill starts carries a mark in its environment; none of
them runs once the drill has returned. The JAX drills took 37 s and 49 s
on the machine these tests were written on at these sizes.
"""

import uuid

from predictionio_tpu_torch.resilience import chaos
from test_torch_chaos_ingest import MARK, Recorder, marked_processes


def test_chaos_serve_on_the_cpu(monkeypatch):
    value = uuid.uuid4().hex
    monkeypatch.setenv(MARK, value)
    recorder = Recorder(monkeypatch)
    report = chaos.run_chaos_serve(chaos.ServeChaosConfig(
        replicas=2, clients=4, phase_seconds=2.0, reloads=1, throughput_replicas=(2,), sharded_point=True,
        device="cpu",
    ))
    assert marked_processes(value) == []
    assert "error" not in report, report.get("error")
    assert report["device"] == "cpu"
    kill, rolling = report["kill"], report["rolling"]
    assert kill["failedQueries"] == 0 and kill["allRespawned"] and kill["killCount"] == 1
    assert kill["overall"]["requests"] > 0
    assert rolling["failedQueries"] == 0
    assert rolling["reloadsOk"] and rolling["converged"]
    assert rolling["crossGenerationViolations"] == 0
    point = report["shardedReplica"]
    assert point["failed"] == 0 and point["transportErrors"] == 0 and point["qps"] > 0
    assert point["factorShards"] == {"r0": 0, "r1": 0}
    assert "fell back to --pin-model" in point["note"]
    assert report["ok"] is True and all(report["verdicts"].values())
    argvs = [a for a in recorder.argvs if "-m" in a]
    assert all(a[a.index("-m") + 1] == "predictionio_tpu_torch.tools.console" for a in argvs)
    trains = [a for a in argvs if "train" in a]
    deploys = [a for a in argvs if "deploy" in a]
    assert trains and deploys
    for argv in trains + deploys:
        assert argv[argv.index("--device") + 1] == "cpu"


def test_chaos_fleet_on_the_cpu(monkeypatch):
    value = uuid.uuid4().hex
    monkeypatch.setenv(MARK, value)
    report = chaos.run_chaos_fleet(chaos.FleetChaosConfig(
        clients=4, phase_seconds=2.0, autoscale_phase=False, device="cpu",
    ))
    assert marked_processes(value) == []
    assert "error" not in report, report.get("error")
    host = report["hostKill"]
    assert host["ok"] and host["failedQueries"] == 0 and host["overall"]["requests"] > 0
    assert host["rejoinSeconds"] is not None
    stale = report["staleWhileDown"]
    assert stale["ok"] and stale["staleMarked"] and stale["uncachedStatus"] == 503
    assert "autoscale" not in report
    assert report["ok"] is True
