"""CLI command implementations (transport- and argparse-free).

Counterpart of ``predictionio_tpu/tools/commands.py``, for the commands
the port's console has so far: ``app new``, ``app list``, ``import`` and
``status``. Parity: ``tools/console/App.scala``, ``Import.scala`` and the
status checks of ``Console.scala``. Each function returns data (and prints human output
via the ``out`` callback) so tests can drive them without capturing
stdout.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from predictionio_tpu_torch.data.ingest import IngestPipeline, PipelineError
from predictionio_tpu_torch.data.storage import Storage, StorageError
from predictionio_tpu_torch.data.storage.base import AccessKey, App
from predictionio_tpu_torch.data.store import resolve_app
from predictionio_tpu_torch.device import resolve_device

__all__ = ["app_new", "app_list", "import_events", "status_check"]

Out = Callable[[str], None]


def _print(line: str) -> None:
    print(line)


# ------------------------------------------------------------------- apps
def app_new(
    name: str, description: str | None = None, access_key: str = "", out: Out = _print
) -> tuple[App, AccessKey]:
    """``pio app new`` — create app, init its event stream, mint a key."""
    apps = Storage.get_meta_data_apps()
    if apps.get_by_name(name) is not None:
        raise StorageError(f"App '{name}' already exists.")
    app_id = apps.insert(App(id=0, name=name, description=description))
    Storage.get_l_events().init(app_id)
    key = Storage.get_meta_data_access_keys().insert(
        AccessKey(key=access_key, appid=app_id)
    )
    if key is None:
        # roll back the half-created app rather than leave it keyless
        Storage.get_l_events().remove(app_id)
        apps.delete(app_id)
        raise StorageError(f"Access key '{access_key}' already exists.")
    app = apps.get(app_id)
    out(f"Created a new app:")
    out(f"      Name: {name}")
    out(f"        ID: {app_id}")
    out(f"Access Key: {key}")
    return app, AccessKey(key=key, appid=app_id)


def app_list(out: Out = _print) -> list[App]:
    apps = sorted(Storage.get_meta_data_apps().get_all(), key=lambda a: a.name)
    keys = Storage.get_meta_data_access_keys()
    out(f"{'Name':<20} | {'ID':<4} | Access Key")
    for app in apps:
        app_keys = keys.get_by_appid(app.id)
        first = app_keys[0].key if app_keys else ""
        out(f"{app.name:<20} | {app.id:<4} | {first}")
    out(f"Finished listing {len(apps)} app(s).")
    return apps


# ----------------------------------------------------------------- import
def import_events(
    app_name: str,
    input_path: str,
    channel: str | None = None,
    out: Out = _print,
) -> int:
    """``pio import`` — JSON-lines file -> event store bulk write
    (parity: ``tools/imprt/FileToEvents.scala``).

    The file is read in byte blocks through the bulk-ingest pipeline's
    parse→validate→append stages: no per-line ``Event``, one columnar
    chunk append per 65536 lines, dedup on — lines carrying an
    ``eventId`` are idempotency keys, so re-running an interrupted import
    never double-stores. The first invalid line aborts with its 1-based
    ``file:line`` position. The JAX package's other input, a columnar
    export directory, needs the columnar driver, which the port does not
    have yet: a directory raises :class:`StorageError` saying so."""
    app_id, channel_id = resolve_app(app_name, channel)
    if os.path.isdir(input_path):
        raise StorageError(
            f"{input_path} is a directory: importing a columnar export needs the "
            "columnar event store, which the port does not have yet; import a "
            "JSON-lines file"
        )
    pipeline = IngestPipeline(Storage.get_l_events(), app_id, channel_id, chunk_rows=65536)

    def check(results) -> None:
        for res in results:
            if res.errors:
                first = res.errors[0]
                pipeline.close()
                raise StorageError(f"{input_path}:{first['line'] + 1}: {first['message']}")
            if res.storage_error is not None:
                pipeline.close()
                raise StorageError(res.storage_error)

    try:
        with open(input_path, "rb") as f:
            while True:
                block = f.read(1 << 20)
                if not block:
                    break
                pipeline.feed(block)
                check(pipeline.poll())
        check(pipeline.finish())
    except PipelineError as e:
        raise StorageError(f"import pipeline failed: {e}") from e
    n = pipeline.stored + pipeline.duplicates
    dup_note = f" ({pipeline.duplicates} duplicate eventIds absorbed)" if pipeline.duplicates else ""
    out(f"Imported {n} events to app {app_name}.{dup_note}")
    return n


# ----------------------------------------------------------------- status
def status_check(device: str | None = None, out: Out = _print) -> dict:
    """``pio status`` — verify storage connectivity per repository role
    and the device that train and deploy would run on (parity: the
    storage checks in ``Console.scala``)."""
    results: dict = {}
    checks = [
        ("metadata", lambda: Storage.get_meta_data_apps().get_all()),
        ("eventdata", lambda: Storage.get_l_events()),
        ("modeldata", lambda: Storage.get_model_data_models()),
    ]
    ok = True
    for role, check in checks:
        try:
            check()
            results[role] = "OK"
        except Exception as e:  # surface the root cause, keep checking
            results[role] = f"FAILED: {e}"
            ok = False
    try:
        dev = resolve_device(device)
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
        results["device"] = f"{dev} ({name})"
    except Exception as e:
        results["device"] = f"FAILED: {e}"
        ok = False
    for role, status in results.items():
        out(f"  {role:<10} {status}")
    out("(sanity check) All systems go!" if ok else "Storage check FAILED")
    results["ok"] = ok
    return results
