"""The kill-9 ingestion drill on the port (``predictionio_tpu_torch/resilience/chaos.py``).

* The three cases of ``tests/test_chaos_ingest.py`` at their sizes, the
  JAX test module's ``ChaosConfig``, ``ChaosError``, ``run_chaos_ingest``
  and ``run_chaos_partitioned`` rebound to the port's.
* One tiny ``ChaosConfig`` through both harnesses: the same report keys,
  and equal invariant fields (``ackedTotal``, ``ackedLost``,
  ``duplicates``, ``dedupViolations``, ``tornRequestsStored``, the
  drain's ``exitCode`` and ``raw500s``).
* Every process the port's harness starts is a ``-m
  predictionio_tpu_torch...`` module (the argv of each ``Popen`` is
  recorded), and none of them runs once the drill has returned (each
  carries a mark in its environment, looked for in ``/proc``).
"""

import os
import subprocess
import sys
import uuid
from pathlib import Path

import pytest

import predictionio_tpu.resilience.chaos as jax_chaos
import predictionio_tpu_torch.resilience.chaos as port_chaos
import test_chaos_ingest as jax_cases

MARK = "PIO_CHAOS_TEST_RUN"


def marked_processes(value: str) -> list:
    """Live (not zombie) processes whose environment holds ``MARK=value``."""
    needle = f"{MARK}={value}".encode()
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                state = fh.read().rsplit(")", 1)[1].split()[0]
            with open(f"/proc/{entry}/environ", "rb") as fh:
                env = fh.read().split(b"\0")
        except OSError:
            continue
        if state != "Z" and needle in env:
            found.append(int(entry))
    return found


class Recorder:
    """``subprocess.Popen`` that records each argv."""

    def __init__(self, monkeypatch):
        self.argvs: list = []
        real = subprocess.Popen
        recorder = self

        class Recording(real):
            def __init__(self, args, *a, **k):
                recorder.argvs.append(list(args))
                super().__init__(args, *a, **k)

        monkeypatch.setattr(subprocess, "Popen", Recording)

    def modules(self) -> list:
        return [argv[argv.index("-m") + 1] for argv in self.argvs if "-m" in argv]


@pytest.fixture()
def port_run(monkeypatch):
    """The JAX cases on the port's harness, its processes marked and
    their argv recorded; afterwards none of them may run."""
    for name in ("ChaosConfig", "ChaosError", "run_chaos_ingest", "run_chaos_partitioned"):
        monkeypatch.setattr(jax_cases, name, getattr(port_chaos, name))
    value = uuid.uuid4().hex
    monkeypatch.setenv(MARK, value)
    recorder = Recorder(monkeypatch)
    yield recorder
    assert marked_processes(value) == [], "a process the drill started outlived it"
    modules = recorder.modules()
    assert len(modules) == len(recorder.argvs)
    assert all(m.startswith("predictionio_tpu_torch.") for m in modules), sorted(set(modules))


def test_chaos_config_validation(port_run):
    jax_cases.test_chaos_config_validation()


def test_chaos_ingest_small_run_holds_invariants(port_run, tmp_path):
    jax_cases.test_chaos_ingest_small_run_holds_invariants(tmp_path)
    assert "predictionio_tpu_torch.tools.console" in port_run.modules()


def test_chaos_partitioned_small_run_holds_invariants(port_run, tmp_path):
    jax_cases.test_chaos_partitioned_small_run_holds_invariants(tmp_path)
    assert port_run.modules()


INVARIANTS = ("ackedTotal", "ackedLost", "duplicates", "dedupViolations", "tornRequestsStored")


def test_both_harnesses_give_the_same_report(tmp_path, monkeypatch):
    value = uuid.uuid4().hex
    monkeypatch.setenv(MARK, value)
    reports = {}
    for name, harness in (("jax", jax_chaos), ("torch", port_chaos)):
        cfg = harness.ChaosConfig(cycles=1, writers=2, events_per_writer=10, bulk_events=60, seed=5,
                                  base_dir=str(tmp_path / name), keep_dir=True)
        reports[name] = harness.run_chaos_ingest(cfg)
    jax_report, port_report = reports["jax"], reports["torch"]
    assert jax_report["ok"] is True and port_report["ok"] is True
    assert set(port_report) == set(jax_report)
    assert {k: port_report[k] for k in INVARIANTS} == {k: jax_report[k] for k in INVARIANTS}
    assert port_report["ackedTotal"] == 20
    for key in ("exitCode", "raw500s"):
        assert port_report["drain"][key] == jax_report["drain"][key]
    assert set(port_report["drain"]) == set(jax_report["drain"])
    assert marked_processes(value) == []


def test_port_harness_starts_only_port_modules():
    """What the recorder sees at run time, read from the source: every
    console the harness names is the port's."""
    text = Path(port_chaos.__file__).read_text()
    assert "predictionio_tpu.tools" not in text and "predictionio_tpu.templates" not in text
    assert port_chaos._console("version")[1:3] == ["-m", "predictionio_tpu_torch.tools.console"]
    assert port_chaos._console("version")[0] == sys.executable


def test_bulk_phase_scans_for_torn_files_after_the_last_compaction(tmp_path):
    """A compaction in flight stages ``*.pending`` files: the bulk phase's
    torn-file scan waits until the compaction count has settled and no
    staged file is left, and a file that never goes (a torn write the
    recovery sweep missed) is still there for the scan when it gives up."""
    import http.server
    import json as _json
    import threading
    import time

    class Stats(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = _json.dumps({"compaction": {"compactions": 3}}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Stats)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        port = server.server_address[1]
        staged = tmp_path / "events" / "app_1" / "seg-0001.npz.pending"
        staged.parent.mkdir(parents=True)
        staged.write_bytes(b"x")
        threading.Timer(1.0, staged.unlink).start()
        t0 = time.monotonic()
        port_chaos._await_compactions_settled(port, str(tmp_path), settle_s=0.3, timeout_s=10.0)
        assert 1.0 <= time.monotonic() - t0 < 5.0
        staged.write_bytes(b"x")
        t0 = time.monotonic()
        port_chaos._await_compactions_settled(port, str(tmp_path), settle_s=0.3, timeout_s=1.0)
        assert time.monotonic() - t0 >= 1.0
        assert port_chaos._unquarantined_torn_files(str(tmp_path)) == [str(staged)]
    finally:
        server.shutdown()
