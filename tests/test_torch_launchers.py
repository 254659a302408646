"""The port's launchers under ``bin/`` on the CPU.

``bin/pio-torch`` is the port's console (its version, ``status --device
cpu``, ``app new``); ``bin/pio-torch-daemon`` starts the port's event
server in a temporary store, one event is POSTed and read back, and
``bin/pio-stop-all`` (which reads pidfiles only and serves both
packages) stops it with no process left; ``bin/pio-torch-start-all``
starts the event server, the admin server and the dashboard, and
``bin/pio-stop-all`` stops all three; ``bin/pio-torch-shell`` puts the
port in scope and imports no jax.
"""

import json
import os
import re
import signal
import subprocess
import time
import urllib.request
from pathlib import Path

import pytest

import predictionio_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
BIN = ROOT / "bin"
SERVICES = ("eventserver", "adminserver", "dashboard")


@pytest.fixture()
def store(tmp_path):
    """A temporary ``PIO_FS_BASEDIR`` and run directory; whatever a case
    leaves running is killed by its pidfile afterwards."""
    env = dict(os.environ, PIO_FS_BASEDIR=str(tmp_path), PIO_RUN_DIR=str(tmp_path / "run"))
    yield tmp_path, env
    for pidfile in (tmp_path / "run").glob("*.pid"):
        try:
            os.kill(int(pidfile.read_text()), signal.SIGKILL)
        except (ProcessLookupError, ValueError):
            pass


def run(argv: list, env: dict, stdin: str | None = None) -> subprocess.CompletedProcess:
    proc = subprocess.run([str(a) for a in argv], env=env, input=stdin, capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


def bound_port(log: Path, timeout_s: float = 60.0) -> int:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        found = re.search(r"Bound port (\d+)", log.read_text() if log.exists() else "")
        if found:
            return int(found.group(1))
        time.sleep(0.1)
    raise AssertionError(f"no 'Bound port' in {log}: {log.read_text() if log.exists() else '(none)'}")


def alive(pid: int) -> bool:
    """The process runs (an exited one its parent has not reaped yet does not)."""
    try:
        return Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError):
        return False


def gone(pids: list, timeout_s: float = 20.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if not any(alive(p) for p in pids):
            return True
        time.sleep(0.1)
    return False


def http_json(url: str, body: dict | None = None) -> tuple[int, object]:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, json.loads(resp.read())


def test_pio_torch_is_the_ports_console(store):
    _, env = store
    assert run([BIN / "pio-torch", "version"], env).stdout.strip() == predictionio_tpu_torch.__version__
    assert "All systems go!" in run([BIN / "pio-torch", "status", "--device", "cpu"], env).stdout


def test_daemon_serves_the_ports_event_server_and_stop_all_stops_it(store):
    base, env = store
    key = re.search(r"Access Key: (\S+)", run([BIN / "pio-torch", "app", "new", "launch"], env).stdout).group(1)
    pidfile = base / "run" / "eventserver.pid"
    started = run([BIN / "pio-torch-daemon", pidfile, "eventserver", "--ip", "127.0.0.1", "--port", "0",
                   "--drain-deadline-s", "5"], env).stdout
    assert "Started 'pio-torch eventserver" in started
    pid = int(pidfile.read_text())
    url = f"http://127.0.0.1:{bound_port(base / 'logs' / 'pio-eventserver.log')}"
    event = {"event": "rate", "entityType": "user", "entityId": "u1", "targetEntityType": "item",
             "targetEntityId": "i1", "properties": {"rating": 4.5}, "eventTime": "2024-01-02T03:04:05.000+00:00"}
    status, created = http_json(f"{url}/events.json?accessKey={key}", event)
    assert status == 201 and created["eventId"]
    status, found = http_json(f"{url}/events.json?accessKey={key}&entityType=user&entityId=u1")
    assert status == 200 and [e["eventId"] for e in found] == [created["eventId"]]
    assert {k: found[0][k] for k in event} == event
    # the daemon refuses a second start on a live pidfile
    again = subprocess.run([str(BIN / "pio-torch-daemon"), str(pidfile), "eventserver"], env=env,
                           capture_output=True, text=True, timeout=60)
    assert again.returncode == 1 and "Already running" in again.stderr
    stopped = run([BIN / "pio-stop-all"], env).stdout
    assert f"Stopped eventserver (pid {pid})" in stopped
    assert gone([pid]) and not pidfile.exists()


def test_start_all_starts_the_ports_services_and_stop_all_stops_them(store):
    base, env = store
    env = dict(env, PIO_EVENTSERVER_PORT="0", PIO_ADMINSERVER_PORT="0", PIO_DASHBOARD_PORT="0")
    out = run([BIN / "pio-torch-start-all", "--ip", "127.0.0.1"], env).stdout
    assert "All services started" in out and out.count("Started 'pio-torch ") == 3
    pids = [int((base / "run" / f"{name}.pid").read_text()) for name in SERVICES]
    for name in SERVICES:
        port = bound_port(base / "logs" / f"pio-{name}.log")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10) as resp:
            assert resp.status == 200
    stopped = run([BIN / "pio-stop-all"], env).stdout
    assert all(f"Stopped {name} (pid {pid})" in stopped for name, pid in zip(SERVICES, pids))
    assert gone(pids) and not list((base / "run").glob("*.pid"))


def test_shell_puts_the_port_in_scope_without_jax(store):
    _, env = store
    out = run([BIN / "pio-torch-shell"], env, stdin="import sys; print('jax' in sys.modules)\n"
              "print(Storage.__class__.__module__, LEventStore.__module__, local_context.__module__)\n").stdout
    assert f"predictionio_tpu_torch {predictionio_tpu_torch.__version__}" in out
    assert "False" in out.split()
    assert ("predictionio_tpu_torch.data.storage.registry predictionio_tpu_torch.data.store "
            "predictionio_tpu_torch.controller.context") in out
