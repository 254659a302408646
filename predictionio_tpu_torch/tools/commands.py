"""CLI command implementations (transport- and argparse-free).

Counterpart of ``predictionio_tpu/tools/commands.py``, for the commands
the port's console has so far: the ``app`` and ``accesskey`` verbs,
``import``, ``export``, ``undeploy`` (with the deploy's stop token; a fleet
router's stops the whole fleet), ``status`` (with its fleet section: the
endpoint registry, each fleet's replicas and experiment) and ``template
list|get``. Parity: ``tools/console/App.scala``, ``AccessKey.scala``,
``Export.scala``, ``Import.scala`` and the undeploy and status checks of
``Console.scala``. Each function returns data (and prints human
output via the ``out`` callback) so tests can drive them without
capturing stdout. Only ``status_check`` imports torch, so the data verbs
and the event server start without it.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterable

from predictionio_tpu_torch.data.event import event_to_json
from predictionio_tpu_torch.data.ingest import IngestPipeline, PipelineError
from predictionio_tpu_torch.data.storage import Storage, StorageError
from predictionio_tpu_torch.data.storage.base import AccessKey, App, Channel
from predictionio_tpu_torch.data.store import resolve_app

__all__ = [
    "app_new",
    "app_list",
    "app_show",
    "app_delete",
    "app_data_delete",
    "app_compact",
    "channel_new",
    "channel_delete",
    "accesskey_new",
    "accesskey_list",
    "accesskey_delete",
    "import_events",
    "export_events",
    "write_stop_token",
    "read_stop_token",
    "undeploy",
    "status_check",
    "fleet_status",
    "BUILTIN_TEMPLATES",
    "template_list",
    "template_get",
]

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


def app_show(name: str, out: Out = _print) -> dict:
    app = Storage.get_meta_data_apps().get_by_name(name)
    if app is None:
        raise StorageError(f"App '{name}' does not exist.")
    keys = Storage.get_meta_data_access_keys().get_by_appid(app.id)
    channels = Storage.get_meta_data_channels().get_by_appid(app.id)
    out(f"    App Name: {app.name}")
    out(f"      App ID: {app.id}")
    out(f" Description: {app.description or ''}")
    for k in keys:
        events = ",".join(k.events) if k.events else "(all)"
        out(f"  Access Key: {k.key} | {events}")
    for ch in channels:
        out(f"     Channel: {ch.name} (id {ch.id})")
    return {"app": app, "access_keys": keys, "channels": channels}


def app_delete(name: str, out: Out = _print) -> None:
    """``pio app delete`` — drop the app, its keys, channels, events."""
    from predictionio_tpu_torch.api.service import invalidate_access_key_caches

    app = Storage.get_meta_data_apps().get_by_name(name)
    if app is None:
        raise StorageError(f"App '{name}' does not exist.")
    le = Storage.get_l_events()
    for ch in Storage.get_meta_data_channels().get_by_appid(app.id):
        le.remove(app.id, ch.id)
        Storage.get_meta_data_channels().delete(ch.id)
    le.remove(app.id)
    deleted_keys = []
    for k in Storage.get_meta_data_access_keys().get_by_appid(app.id):
        Storage.get_meta_data_access_keys().delete(k.key)
        deleted_keys.append(k.key)
    Storage.get_meta_data_apps().delete(app.id)
    # revoke in any event server sharing this process; out-of-process
    # servers converge within the key-cache TTL (docs/eventserver.md)
    invalidate_access_key_caches(deleted_keys)
    out(f"Deleted app {name}.")


def _resolve_app_channel(name: str, channel: str | None):
    """(app, channel_id) for commands addressing one app's stream."""
    app = Storage.get_meta_data_apps().get_by_name(name)
    if app is None:
        raise StorageError(f"App '{name}' does not exist.")
    channel_id = None
    if channel is not None:
        matches = [
            c for c in Storage.get_meta_data_channels().get_by_appid(app.id)
            if c.name == channel
        ]
        if not matches:
            raise StorageError(f"Channel '{channel}' does not exist.")
        channel_id = matches[0].id
    return app, channel_id


def app_data_delete(name: str, channel: str | None = None, out: Out = _print) -> None:
    """``pio app data-delete`` — wipe events, keep the app."""
    app, channel_id = _resolve_app_channel(name, channel)
    le = Storage.get_l_events()
    le.remove(app.id, channel_id)
    le.init(app.id, channel_id)
    out(f"Deleted data of app {name}" + (f" channel {channel}." if channel else "."))


def app_compact(name: str, channel: str | None = None, out: Out = _print) -> int:
    """``pio app compact`` — seal the columnar event tail into segments
    (the HBase major-compaction role). Event ids survive. No-op error on
    backends without a tail/segment layout."""
    app, channel_id = _resolve_app_channel(name, channel)
    le = Storage.get_l_events()
    if not hasattr(le, "compact"):
        raise StorageError(
            "The configured EVENTDATA backend has no tail to compact "
            "(compaction applies to the columnar driver)."
        )
    moved = le.compact(app.id, channel_id)
    out(f"Compacted {moved} tail events of app {name} into segments.")
    return moved


# --------------------------------------------------------------- channels
def channel_new(app_name: str, channel_name: str, out: Out = _print) -> Channel:
    app = Storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise StorageError(f"App '{app_name}' does not exist.")
    if not Channel.is_valid_name(channel_name):
        raise StorageError(f"Channel name {Channel.NAME_CONSTRAINT}.")
    existing = Storage.get_meta_data_channels().get_by_appid(app.id)
    if any(c.name == channel_name for c in existing):
        raise StorageError(f"Channel '{channel_name}' already exists.")
    ch_id = Storage.get_meta_data_channels().insert(
        Channel(id=0, name=channel_name, appid=app.id)
    )
    Storage.get_l_events().init(app.id, ch_id)
    out(f"Created channel {channel_name} (id {ch_id}) for app {app_name}.")
    return Channel(id=ch_id, name=channel_name, appid=app.id)


def channel_delete(app_name: str, channel_name: str, out: Out = _print) -> None:
    app = Storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise StorageError(f"App '{app_name}' does not exist.")
    matches = [
        c for c in Storage.get_meta_data_channels().get_by_appid(app.id)
        if c.name == channel_name
    ]
    if not matches:
        raise StorageError(f"Channel '{channel_name}' does not exist.")
    Storage.get_l_events().remove(app.id, matches[0].id)
    Storage.get_meta_data_channels().delete(matches[0].id)
    out(f"Deleted channel {channel_name} of app {app_name}.")


# ------------------------------------------------------------ access keys
def accesskey_new(
    app_name: str, events: Iterable[str] = (), key: str = "", out: Out = _print
) -> str:
    app = Storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise StorageError(f"App '{app_name}' does not exist.")
    new_key = Storage.get_meta_data_access_keys().insert(
        AccessKey(key=key, appid=app.id, events=tuple(events))
    )
    if new_key is None:
        raise StorageError(f"Access key '{key}' already exists.")
    out(f"Created new access key: {new_key}")
    return new_key


def accesskey_list(app_name: str | None = None, out: Out = _print) -> list[AccessKey]:
    repo = Storage.get_meta_data_access_keys()
    if app_name is None:
        keys = repo.get_all()
    else:
        app = Storage.get_meta_data_apps().get_by_name(app_name)
        if app is None:
            raise StorageError(f"App '{app_name}' does not exist.")
        keys = repo.get_by_appid(app.id)
    for k in keys:
        events = ",".join(k.events) if k.events else "(all)"
        out(f"{k.key} | app {k.appid} | {events}")
    out(f"Finished listing {len(keys)} access key(s).")
    return keys


def accesskey_delete(key: str, out: Out = _print) -> None:
    from predictionio_tpu_torch.api.service import invalidate_access_key_caches

    if not Storage.get_meta_data_access_keys().delete(key):
        raise StorageError(f"Access key '{key}' does not exist.")
    invalidate_access_key_caches([key])
    out(f"Deleted access key {key}.")


# ---------------------------------------------------------- import/export
def import_events(
    app_name: str,
    input_path: str,
    channel: str | None = None,
    out: Out = _print,
) -> int:
    """``pio import`` — JSON-lines file (or a columnar export directory,
    auto-detected) -> event store bulk write
    (parity: ``tools/imprt/FileToEvents.scala``).

    A file is read in byte blocks through the bulk-ingest pipeline's
    parse→validate→append stages: no per-line ``Event``, one columnar
    chunk append per 65536 lines, dedup on — lines carrying an
    ``eventId`` are idempotency keys, so re-running an interrupted import
    never double-stores. The first invalid line aborts with its 1-based
    ``file:line`` position. A directory must be a ``pio export --format
    columnar`` export (of either package): its events stream back through
    the object path, with ids assigned by the destination store."""
    app_id, channel_id = resolve_app(app_name, channel)
    if os.path.isdir(input_path):
        return _import_columnar_export(app_name, input_path, app_id, channel_id, out)
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


def _import_columnar_export(
    app_name: str, input_path: str, app_id: int, channel_id: int | None, out: Out
) -> int:
    # a `pio export --format columnar` directory: stream its events
    # back through the portable object path (ids re-assigned by the
    # destination store). Anything else directory-shaped (e.g. a
    # --sharded JSONL export) must error, not silently import 0
    # events — and must not be mutated by instantiating a driver on
    # top of it.
    if not os.path.isdir(os.path.join(input_path, "export_events")):
        raise StorageError(
            f"{input_path} is a directory but not a columnar export "
            "(no export_events/ inside). For sharded JSONL exports, "
            "import each shard file individually."
        )
    src = _columnar_file_client(input_path).get_p_events()
    counter = {"n": 0}

    def gen():
        for event in src.find(0):
            counter["n"] += 1
            yield event.with_event_id(None) if event.event_id else event

    Storage.get_p_events().write(gen(), app_id, channel_id)
    out(f"Imported {counter['n']} events to app {app_name}.")
    return counter["n"]


def _columnar_file_client(path: str):
    """A throwaway columnar driver rooted at ``path`` — the on-disk
    columnar interchange format IS the columnar store layout (the role
    `--format parquet` plays for the reference's EventsToFile)."""
    from predictionio_tpu_torch.data.storage import columnar
    from predictionio_tpu_torch.data.storage.base import StorageClientConfig

    return columnar.StorageClient(
        StorageClientConfig("FILE", "columnar", {"path": path, "prefix": "export"})
    )


def export_events(
    app_name: str,
    output_path: str,
    channel: str | None = None,
    num_shards: int = 0,
    format: str = "json",
    out: Out = _print,
) -> int:
    """``pio export`` — event store -> JSON-lines file, a directory of
    round-robin shard files (``num_shards > 0``, for multi-host training
    reads: :mod:`predictionio_tpu_torch.parallel.reader`), or a columnar
    segment directory (``format="columnar"`` — the reference's ``--format
    parquet`` analog: dictionary-encoded, read back at array speed)
    (parity: ``tools/export/EventsToFile.scala``)."""
    app_id, channel_id = resolve_app(app_name, channel)
    events = Storage.get_p_events().find(app_id, channel_id)
    if format == "columnar":
        if num_shards > 0:
            raise ValueError(
                "--sharded applies to the JSON format only; a columnar "
                "export is already a segment directory"
            )
        if os.path.isdir(os.path.join(output_path, "export_events")):
            # appending segments to a previous export would duplicate
            # every event on re-import (JSON exports overwrite; refuse
            # rather than silently differ)
            raise StorageError(
                f"{output_path} already holds a columnar export; remove it "
                "or export to a fresh directory"
            )
        n = 0

        def counted():
            nonlocal n
            for e in events:
                n += 1
                yield e

        _columnar_file_client(output_path).get_p_events().write(counted(), 0)
        out(f"Exported {n} events to columnar segments in {output_path}.")
        return n
    if format != "json":
        raise ValueError(f"unknown export format {format!r} (json|columnar)")
    if num_shards > 0:
        from predictionio_tpu_torch.parallel.reader import write_event_shards

        paths = write_event_shards(events, output_path, num_shards=num_shards)
        out(f"Exported {len(paths)} shards to {output_path}.")
        return len(paths)
    n = 0
    with open(output_path, "w") as f:
        for event in events:
            f.write(json.dumps(event_to_json(event), default=str) + "\n")
            n += 1
    out(f"Exported {n} events to {output_path}.")
    return n


# --------------------------------------------------------------- undeploy
def _stop_token_path(port: int) -> str:
    return os.path.join(Storage.base_dir(), "deployments", f"{port}.token")


def write_stop_token(port: int) -> str:
    """Generate the per-deployment stop token and persist it (0600) where
    ``pio undeploy`` on the same host finds it. Gates ``GET /stop`` so a
    reachable port is not a remote shutdown primitive."""
    import secrets

    token = secrets.token_urlsafe(16)
    path = _stop_token_path(port)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        f.write(token)
    return token


def read_stop_token(port: int) -> str | None:
    try:
        with open(_stop_token_path(port)) as f:
            return f.read().strip() or None
    except FileNotFoundError:
        return None


def undeploy(
    ip: str = "127.0.0.1",
    port: int = 8000,
    https: bool = False,
    insecure: bool = False,
    token: str | None = None,
    out: Out = _print,
) -> None:
    """``pio undeploy`` — ask a deployed query server to shut down via its
    ``GET /stop`` route (parity: Console's undeploy hitting CreateServer's
    stop endpoint). ``insecure`` skips TLS verification (self-signed
    deployments). ``token`` defaults to the basedir token file written by
    ``pio deploy`` for this port."""
    import ssl as _ssl
    import urllib.error
    import urllib.parse
    import urllib.request

    if token is None and (ip.startswith("127.") or ip in ("localhost", "::1")):
        # the basedir token file is only meaningful for THIS host's
        # deployments — falling back for a remote ip would transmit the
        # local deployment's secret to an unrelated server
        token = read_stop_token(port)
    scheme = "https" if https else "http"
    url = f"{scheme}://{ip}:{port}/stop"
    # token travels in a header — query strings are routinely recorded by
    # access logs and intermediary proxies. It is ALSO still
    # sent as ?token= for one transition: servers deployed by an older
    # version read only the query param, and undeploy must be able to
    # stop them.
    if token:
        url += "?token=" + urllib.parse.quote(token, safe="")
    req = urllib.request.Request(url)
    if token:
        req.add_header("X-PIO-Stop-Token", token)
    ctx = None
    if https:
        ctx = _ssl.create_default_context()
        if insecure:
            ctx.check_hostname = False
            ctx.verify_mode = _ssl.CERT_NONE
    try:
        with urllib.request.urlopen(req, timeout=10, context=ctx) as resp:
            resp.read()
    except urllib.error.HTTPError as e:
        # the server is UP but refused — report its actual answer, not a
        # bogus "unreachable" (501 = deployment without a stop hook)
        hint = (
            " (remote deployments require --token)" if e.code == 403 else ""
        )
        raise RuntimeError(
            f"Deployment at {ip}:{port} refused to stop: "
            f"HTTP {e.code} {e.reason}{hint}"
        ) from e
    except urllib.error.URLError as e:
        raise RuntimeError(
            f"Could not reach a deployment at {url}: {e.reason}"
        ) from e
    out(f"Undeployed engine server at {ip}:{port}.")


# ----------------------------------------------------------------- status
def status_check(device: str | None = None, out: Out = _print) -> dict:
    """``pio status`` — verify storage connectivity per repository role
    and the device that train and deploy would run on (parity: the
    storage checks in ``Console.scala``)."""
    import torch

    from predictionio_tpu_torch.device import resolve_device

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
    fleets = fleet_status(out)
    try:
        aot_rows = aot_artifact_status(out, device)
    except Exception as e:  # a torn registry must not fail the storage check
        aot_rows = None
        results["aotArtifacts"] = f"FAILED: {e}"
    out("(sanity check) All systems go!" if ok else "Storage check FAILED")
    results["ok"] = ok
    if fleets:
        results["fleets"] = fleets
    if aot_rows is not None:
        results["aotArtifacts"] = aot_rows
    return results


def aot_artifact_status(out: Out = _print, device: str | None = None) -> list[dict] | None:
    """Per-generation AOT artifact readiness for ``pio status``: will ``pio
    deploy --aot`` boot tier 1 on ``device`` of this host? Read-only over
    the fleet model registry and the artifact directories it stamps:

    * ``present``: the manifest and every program verify (SHA-256) and the
      recorded fingerprint matches this host's torch, CUDA, backend and
      device;
    * ``fingerprint-stale``: the programs verify but were compiled for
      another environment (a boot falls back loudly to the eager path);
    * ``missing``: stamped, but the directory is gone or torn;
    * ``corrupt``: the manifest is there, but a program's size or digest
      does not match it.

    Generations published without ``pio train --aot`` show ``None``,
    printed ``(jit)`` as the JAX console prints it (the port serves them
    eagerly). Returns ``None``, and prints nothing, when no generation
    carries an artifact stamp."""
    from predictionio_tpu_torch.fleet.registry import ModelRegistry, read_aot_manifest, verify_aot_artifacts

    registry = ModelRegistry(os.path.join(Storage.base_dir(), "fleet"))
    records = []
    cur = registry.current()
    if cur is not None:
        records.append(cur)
    records.extend(registry.history())  # history[0] repeats current
    if not any(r.artifacts for r in records):
        return None
    # only a stamped registry pays the fingerprint read (torch)
    from predictionio_tpu_torch.workflow.aot import current_fingerprint, fingerprint_mismatches

    live = current_fingerprint(device)
    rows: list[dict] = []
    seen: set[int] = set()
    for rec in records:
        if rec.generation in seen:
            continue
        seen.add(rec.generation)
        row: dict = {"generation": rec.generation, "engineInstanceId": rec.engine_instance_id, "artifacts": None}
        if rec.artifacts:
            adir = rec.artifacts.get("dir", "")
            verdict = verify_aot_artifacts(adir) if adir else {"ok": False, "fingerprint": None, "problems": []}
            if not verdict["ok"]:
                torn = not adir or read_aot_manifest(adir) is None
                row["artifacts"] = "missing" if torn else "corrupt"
                row["problems"] = verdict.get("problems", [])
            else:
                mismatches = fingerprint_mismatches(verdict.get("fingerprint") or {}, live)
                if mismatches:
                    row["artifacts"] = "fingerprint-stale"
                    row["mismatches"] = mismatches
                else:
                    row["artifacts"] = "present"
            row["dir"] = adir
        rows.append(row)
    for row in rows:
        out(f"  aot        gen {row['generation']} {row['engineInstanceId']}: {row['artifacts'] or '(jit)'}")
    return rows


def fleet_status(out: Out = _print) -> list[dict]:
    """Aggregate every active replica fleet on this host (``pio deploy
    --replicas``): the cross-host endpoint registry is the
    primary view (per-host replica rows with lease age, generation and
    readiness, ring membership, stale-lease and torn-entry warnings);
    the supervisor's per-host state files are the degraded fallback —
    they still list PIDs and liveness when the registry dir is absent
    (pre-elastic fleets) or unreadable."""
    import glob
    import urllib.request

    pattern = os.path.join(Storage.base_dir(), "deployments", "fleet-*.json")
    paths = sorted(glob.glob(pattern))
    registry_dir = os.path.join(Storage.base_dir(), "fleet", "endpoints")
    if not paths and not os.path.isdir(registry_dir):
        return []  # nothing fleet-ish on this host: never import the package
    from predictionio_tpu_torch.fleet.supervisor import read_fleet_state

    fleets: list[dict] = []
    states = [s for s in (read_fleet_state(p) for p in paths) if s]
    # a fleet on a custom --endpoint-registry DIR reports its directory
    # on the router's /fleet/endpoints.json — ask each router so status
    # aggregates THAT registry, not just the default location
    registry_dirs: list[str] = []
    for state in states:
        reported = _router_registry_dir(state.get("routerPort"))
        if reported and reported not in registry_dirs:
            registry_dirs.append(reported)
    if os.path.isdir(registry_dir) and registry_dir not in registry_dirs:
        registry_dirs.append(registry_dir)
    for directory in registry_dirs:
        registry_view = _endpoint_registry_status(directory, out)
        if registry_view is not None:
            fleets.append({"endpointRegistry": registry_view})
    for state in states:
        replicas = []
        for rep in state.get("replicas", []):
            entry = {
                "id": rep.get("id"),
                "port": rep.get("port") or None,
                "ready": False,
                "generation": None,
                "alive": rep.get("alive"),
            }
            if not entry["port"]:
                # elastic replica: bound port 0 and self-reported through
                # the registry — the registry view above is authoritative;
                # this row only carries supervisor liveness
                entry["ready"] = None
                replicas.append(entry)
                continue
            try:
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{rep.get('port')}/readyz", timeout=2
                ) as resp:
                    report = json.loads(resp.read())
            except Exception:
                report = None
            if report is not None:
                entry["ready"] = bool(report.get("ready"))
                entry["generation"] = report.get("generation")
            replicas.append(entry)
        generations = {
            r["generation"] for r in replicas if r["generation"] is not None
        }
        fleet = {
            "routerPort": state.get("routerPort"),
            "replicas": replicas,
            "generationConverged": len(generations) == 1,
        }
        experiment = _fleet_experiment(state.get("routerPort"))
        if experiment is not None:
            fleet["experiment"] = experiment
        fleets.append(fleet)
        probed = [r for r in replicas if r["ready"] is not None]
        if probed:
            ready_part = (
                f"{sum(1 for r in probed if r['ready'])}/{len(probed)} "
                f"replicas ready, generations "
                f"{sorted(generations) if generations else '[]'}"
                f"{' (converged)' if fleet['generationConverged'] else ''}"
            )
        else:
            ready_part = (
                f"{len(replicas)} replica(s), readiness via the endpoint "
                "registry above"
            )
        out(
            f"  fleet      router :{fleet['routerPort']} — {ready_part}"
        )
        if experiment is not None:
            arms = ", ".join(
                f"{v['name']}:{v['weight']:g} "
                f"({v['routed']} routed, {v['rewardCount']} rewards)"
                for v in experiment.get("variants", [])
            )
            promoted = experiment.get("promoted")
            out(
                "  experiment "
                + (arms or "(no variants)")
                + (
                    f" — PROMOTED {promoted['variant']} at {promoted['at']}"
                    if promoted
                    else ""
                )
            )
    return fleets


def _router_registry_dir(router_port: int | None) -> str | None:
    """The registry directory a live router actually serves from
    (``GET /fleet/endpoints.json``) — how status finds a custom
    ``--endpoint-registry DIR``. ``None`` when the router is down or
    pre-elastic (404)."""
    import urllib.request

    if not router_port:
        return None
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{router_port}/fleet/endpoints.json", timeout=2
        ) as resp:
            doc = json.loads(resp.read())
        return doc.get("registry", {}).get("directory") or None
    except Exception:
        return None


def _endpoint_registry_status(directory: str, out: Out = _print) -> dict | None:
    """Aggregate the cross-host endpoint registry for ``pio status``
    : per-host replica rows (lease age, generation, readiness
    probed at the self-reported address), ring membership, stale-lease
    warnings for expired-but-unevicted entries, and loud torn-entry
    problems. ``None`` when the registry dir is absent — callers fall
    back to the per-host supervisor state files."""
    import urllib.request

    if not os.path.isdir(directory):
        return None
    from predictionio_tpu_torch.fleet.registry import EndpointRegistry

    # read-only aggregation: snapshot, never evict — eviction is the
    # routers' job (claimed exactly once); status just reports
    live, expired, problems = EndpointRegistry(directory).snapshot()
    hosts: dict[str, list[dict]] = {}
    for entry in live:
        row = {
            "id": entry.replica_id,
            "host": entry.host,
            "port": entry.port,
            "leaseAgeS": round(entry.lease_age_s(), 3),
            "generation": entry.generation,
            "ready": False,
        }
        try:
            with urllib.request.urlopen(
                f"http://{entry.host}:{entry.port}/readyz", timeout=2
            ) as resp:
                report = json.loads(resp.read())
            row["ready"] = bool(report.get("ready"))
            row["generation"] = report.get("generation", entry.generation)
        except Exception:
            pass
        hosts.setdefault(entry.host, []).append(row)
    for rows in hosts.values():
        rows.sort(key=lambda r: r["id"])
    view = {
        "directory": directory,
        "ring": sorted(e.replica_id for e in live),
        "hosts": hosts,
        "staleLeases": sorted(e.replica_id for e in expired),
        "problems": problems,
    }
    out(
        f"  endpoints  {len(live)} live replica(s) across "
        f"{len(hosts)} host(s) in {directory}"
    )
    for host in sorted(hosts):
        rows = hosts[host]
        out(
            f"    {host}: "
            + ", ".join(
                f"{r['id']}:{r['port']} gen={r['generation']} "
                f"lease={r['leaseAgeS']:.1f}s"
                f"{' ready' if r['ready'] else ' NOT-READY'}"
                for r in rows
            )
        )
    if view["ring"]:
        out(f"    ring members: {view['ring']}")
    if view["staleLeases"]:
        out(
            f"    WARNING: stale leases (expired, not yet evicted): "
            f"{view['staleLeases']}"
        )
    for problem in problems:
        out(
            f"    WARNING: torn registry entry {problem['file']}: "
            f"{problem['error']}"
        )
    return view


def _fleet_experiment(router_port) -> dict | None:
    """One fleet's active experiment (``pio status``): the
    router's live ``/experiments.json`` (variants, weights, sample
    counts, promotion stamp), falling back to the registry file's
    promotion record when the router is down. None = no experiment."""
    import urllib.request

    if router_port:
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{router_port}/experiments.json", timeout=2
            ) as resp:
                if resp.status == 200:
                    return json.loads(resp.read())
        except Exception:
            pass
    # router unreachable (or answered non-200): the promotion stamp in
    # the fleet registry is still on disk
    registry_path = os.path.join(
        Storage.base_dir(), "fleet", "model-registry.json"
    )
    try:
        with open(registry_path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    meta = ((doc.get("current") or {}).get("meta")) or {}
    if meta.get("source") != "experiment_promotion":
        return None
    return {
        "variants": [],
        "promoted": {
            "variant": meta.get("variant"),
            "at": (doc.get("current") or {}).get("publishedAt"),
        },
    }


# ---------------------------------------------------------------- templates
#: built-in engine templates: name -> (engineFactory, description, default
#: engine.json algorithm block) — the JAX package's table, engineFactory
#: strings and algorithm blocks unchanged (the port resolves each factory
#: to its own module of the same path); two descriptions name the port's
#: kernels instead of the Pallas solve and sharded embeddings. The reference-era `pio template get` downloaded scaffolds from a
#: gallery; templates here ship in-package, so `get` writes a
#: ready-to-train engine.json instead.
BUILTIN_TEMPLATES = {
    "recommendation": (
        "predictionio_tpu.templates.recommendation:engine_factory",
        "Personalized top-N via ALS (explicit + implicit), CUDA Gauss-Jordan SPD solve",
        [{"name": "als", "params": {"rank": 32, "numIterations": 10, "lambda": 0.05}}],
    ),
    "classification": (
        "predictionio_tpu.templates.classification:engine_factory",
        "Attribute -> label classification (NaiveBayes / LogisticRegression)",
        [{"name": "naive", "params": {"lambda": 1.0}}],
    ),
    "similarproduct": (
        "predictionio_tpu.templates.similarproduct:engine_factory",
        "Items similar to a basket of items (implicit ALS, cosine)",
        [{"name": "als", "params": {"rank": 32, "numIterations": 10, "lambda": 0.01}}],
    ),
    "ecommerce": (
        "predictionio_tpu.templates.ecommerce:engine_factory",
        "E-commerce recommendations with serving-time business rules",
        [{"name": "ecomm", "params": {"rank": 32, "numIterations": 10, "lambda": 0.01}}],
    ),
    "textclassification": (
        "predictionio_tpu.templates.textclassification:engine_factory",
        "Text -> label via hashing TF-IDF + NB/LR",
        [{"name": "nb", "params": {"lambda": 1.0}}],
    ),
    "twotower": (
        "predictionio_tpu.templates.twotower:engine_factory",
        "Two-tower retrieval: in-batch sampled softmax, fused CUDA CE kernels",
        [
            {
                "name": "twotower",
                "params": {"embeddingDim": 64, "batchSize": 512, "epochs": 5},
            }
        ],
    ),
}


def template_list(out: Out = _print) -> dict:
    """``pio template list`` — built-in engine templates."""
    out(f"{'NAME':<20} ENGINE FACTORY")
    for name, (factory, desc, _) in BUILTIN_TEMPLATES.items():
        out(f"{name:<20} {factory}")
        out(f"{'':<20}   {desc}")
    return BUILTIN_TEMPLATES


def template_get(
    name: str, directory: str, app_name: str = "MyApp", out: Out = _print
) -> str:
    """``pio template get`` — scaffold a ready-to-train engine directory
    (engine.json + README) for a built-in template."""
    if name not in BUILTIN_TEMPLATES:
        raise ValueError(
            f"Unknown template '{name}'. Available: {', '.join(BUILTIN_TEMPLATES)}"
        )
    factory, desc, algorithms = BUILTIN_TEMPLATES[name]
    os.makedirs(directory, exist_ok=True)
    engine_path = os.path.join(directory, "engine.json")
    if os.path.exists(engine_path):
        raise ValueError(f"{engine_path} already exists; refusing to overwrite")
    variant = {
        "id": name,
        "version": "1",
        "engineFactory": factory,
        "datasource": {"params": {"appName": app_name}},
        "algorithms": algorithms,
    }
    with open(engine_path, "w") as f:
        json.dump(variant, f, indent=2)
        f.write("\n")
    readme = os.path.join(directory, "README.md")
    if not os.path.exists(readme):
        with open(readme, "w") as f:
            f.write(
                f"# {name} engine\n\n{desc}\n\n"
                "```bash\n"
                f"pio app new {app_name}\n"
                f"pio import --appname {app_name} --input events.json\n"
                "pio train --engine-json engine.json\n"
                "pio deploy --port 8000\n"
                "```\n"
            )
    out(f"Template '{name}' scaffolded in {directory}/ (edit appName in engine.json).")
    return engine_path
