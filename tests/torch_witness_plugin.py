"""The port's runtime witnesses over a pytest session.

Load it with ``-p`` from the repository root::

    python -m pytest tests/test_torch_online.py -k torch \\
        -p tests.torch_witness_plugin --torch-lock-witness

``--torch-lock-witness`` installs the port's composed lock and fsync
witness (``predictionio_tpu_torch.analysis.lock_witness.LockFsyncWitness``)
before collection, so every lock the port's modules make during the run
is witnessed. At the session's end its ``lockwitness_report`` (the
witnessed lock orders, the static cycles classified CONFIRMED or
PLAUSIBLE, the static/dynamic crosscheck) goes to
``$PIO_TORCH_LOCK_WITNESS_REPORT`` as JSON, and a summary line is printed.
A witnessed inversion or a failed crosscheck turns a green run red (exit
status 3).

``--torch-jit-witness`` installs the port's compile and transfer witness
(``predictionio_tpu_torch.analysis.jit_witness``) the same way; its
``jitwitness_report`` goes to ``$PIO_TORCH_JIT_WITNESS_REPORT``. It
reports and does not gate: a test suite compiles and copies where it
likes.

The JAX package's ``--lock-witness`` and ``--jit-witness``
(``tests/conftest.py``) are left as they are. Both packages' lock
witnesses in one session is a usage error: they wrap the same
``threading.Lock``. Without an option the plugin changes nothing.
"""

from __future__ import annotations

import json
import os

import pytest

LOCK_OPTION = "--torch-lock-witness"
JIT_OPTION = "--torch-jit-witness"
LOCK_REPORT_ENV = "PIO_TORCH_LOCK_WITNESS_REPORT"
JIT_REPORT_ENV = "PIO_TORCH_JIT_WITNESS_REPORT"


def pytest_addoption(parser):
    group = parser.getgroup("torch-witness", "the PyTorch port's runtime witnesses")
    group.addoption(
        LOCK_OPTION, action="store_true", default=False,
        help="run the session under the port's lock and fsync witness "
        "(predictionio_tpu_torch.analysis.lock_witness); exit status 3 on a "
        f"witnessed lock-order inversion or a failed crosscheck. Report at ${LOCK_REPORT_ENV}.",
    )
    group.addoption(
        JIT_OPTION, action="store_true", default=False,
        help="run the session under the port's compile and transfer witness "
        f"(predictionio_tpu_torch.analysis.jit_witness); reports only. Report at ${JIT_REPORT_ENV}.",
    )


@pytest.hookimpl(tryfirst=True)
def pytest_configure(config):
    lock = config.getoption(LOCK_OPTION)
    if lock and config.getoption("--lock-witness", default=False):
        raise pytest.UsageError(
            f"{LOCK_OPTION} and --lock-witness wrap the same threading.Lock: pass one of them"
        )
    if lock:
        from predictionio_tpu_torch.analysis import lock_witness, witness

        w = lock_witness.LockFsyncWitness()
        w.install()
        witness._ACTIVE = w.locks  # witness.active()/report() see it
        config._torch_lock_witness = w
    if config.getoption(JIT_OPTION):
        import torch  # noqa: F401  (the witness wraps the torch it finds loaded)

        from predictionio_tpu_torch.analysis import jit_witness

        config._torch_jit_witness = jit_witness.install()


def pytest_sessionfinish(session, exitstatus):
    w = getattr(session.config, "_torch_lock_witness", None)
    if w is None:
        return
    from predictionio_tpu_torch.analysis import lock_witness

    payload = lock_witness.lockwitness_report(w.report())
    session.config._torch_lock_witness_payload = payload
    if exitstatus == 0 and not payload["ok"]:
        session.exitstatus = 3


def pytest_unconfigure(config):
    if getattr(config, "_torch_jit_witness", None) is not None:
        _finish_jit_witness(config._torch_jit_witness)
    w = getattr(config, "_torch_lock_witness", None)
    if w is not None:
        _finish_lock_witness(config, w)


def _finish_jit_witness(jw) -> None:
    from predictionio_tpu_torch.analysis import jit_witness

    jit_witness.uninstall()
    rep = jw.report()
    payload = jit_witness.jitwitness_report(rep)
    path = os.environ.get(JIT_REPORT_ENV)
    if path:
        jit_witness.write_report(path, payload)
    confirmed = [c for c in payload["staticCompileFindings"] if c["status"] == "CONFIRMED"]
    print(
        f"\ntorch-jit-witness: {len(rep['compiles'])} compile site(s) ({rep['totalCompiles']} compiles, "
        f"{rep['totalCompileMs']:.0f} ms), {len(rep['transfers'])} transfer site(s) "
        f"({rep['totalTransfers']} copies, {rep['totalTransferBytes']} bytes), "
        f"{rep['totalConstructions']} construction(s), {len(payload['staticCompileFindings'])} static "
        f"PIO306-308 finding(s) ({len(confirmed)} CONFIRMED), "
        f"{len(payload['budget']['violations'])} budget violation(s)"
    )


def _finish_lock_witness(config, w) -> None:
    from predictionio_tpu_torch.analysis import lock_witness, witness

    w.uninstall()
    witness._ACTIVE = None
    payload = getattr(config, "_torch_lock_witness_payload", None)
    if payload is None:  # sessionfinish never ran (a collection crash)
        payload = lock_witness.lockwitness_report(w.report())
    rep = payload["witness"]
    path = os.environ.get(LOCK_REPORT_ENV)
    if path:
        witness.write_report(path, payload)
    inv = rep.get("inversions", [])
    confirmed = [c for c in payload["staticLockCycles"] if c["status"] == "CONFIRMED"]
    cc = payload["crosscheck"]
    fs = rep.get("fsync", {})
    print(
        f"\ntorch-lock-witness: {len(rep.get('locks', {}))} lock site(s), "
        f"{len(rep.get('edges', []))} order edge(s), {len(inv)} inversion(s), "
        f"{len(payload['staticLockCycles'])} static cycle(s) ({len(confirmed)} CONFIRMED); "
        f"fsync: {fs.get('fsyncCalls', 0)} call(s), {len(fs.get('renames', []))} rename(s); "
        f"crosscheck: {len(cc['gaps'])} gap(s), {len(cc['unwaivedStaticCycles'])} unwaived cycle(s), "
        f"{len(cc['staleWaivers'])} stale waiver(s)"
    )
    if inv:
        print(json.dumps(inv, indent=2))
    if cc["gaps"] or cc["unwaivedStaticCycles"]:
        print(json.dumps({"gaps": cc["gaps"], "unwaivedStaticCycles": cc["unwaivedStaticCycles"]}, indent=2))
