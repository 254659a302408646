"""The port's ``pio`` console — an argparse front-end over the command layer.

Counterpart of ``predictionio_tpu/tools/console.py`` (parity:
``tools/console/Console.scala``), for the commands of the quickstart:

    pio version | status [--device D]
    pio app new NAME | list | show NAME | delete NAME
            | data-delete NAME [--channel C] | compact NAME [--channel C]
            | channel-new NAME CHANNEL | channel-delete NAME CHANNEL
    pio accesskey new APP [EVENT ...] | list [APP] | delete KEY
    pio import --appname APP --input FILE|DIR [--channel C]
    pio export --appname APP --output PATH [--channel C]
               [--format json|columnar]
    pio eventserver [--ip IP] [--port N] [--stats]
               [--compact-interval-s S] [--compact-tail-mb MB]
               [--compact-dead-tombstones N] [--compact-min-interval-s S]
               [--cert PEM --key PEM] [--drain-deadline-s S]
    pio train  --engine-json FILE [--batch B] [--skip-sanity-check]
               [--stop-after-read] [--stop-after-prepare] [--device D]
    pio deploy --engine-json FILE [--ip IP] [--port N]
               [--engine-instance-id ID] [--device D]
    pio eval   EVALUATION [PARAMS_GENERATOR] [--batch B]
               [--output-path FILE] [--device D]

Where the JAX console takes ``--mesh``, ``train``, ``deploy`` and
``eval`` take ``--device``: ``cuda`` (the default, the card; it fails
where there is none) or ``cpu``. ``deploy --port 0`` and ``eventserver
--port 0`` bind a free port and print ``Bound port N``; SIGTERM or SIGINT
stops the deploy, and the event server drains first when given
``--drain-deadline-s``. The data verbs and ``eventserver`` import no
torch. ``eval`` takes
import paths (``module:attr``) of an ``Evaluation`` and, optionally, an
``EngineParamsGenerator`` (else the evaluation's own
``engine_params_list``), prints the leaderboard and writes the result's
JSON to ``--output-path``. Run as ``python -m
predictionio_tpu_torch.tools.console``.

Waiting: ``export --sharded``, ``undeploy``, ``eval --grid`` and ``eval
--promote-to``, ``train --warm-start`` and the deploy's serving options.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading

from predictionio_tpu_torch import __version__
from predictionio_tpu_torch.tools import commands

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pio", description="predictionio_tpu_torch — the ML server on PyTorch and CUDA"
    )
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("version", help="print version")
    status = sub.add_parser("status", help="check storage + device connectivity")
    status.add_argument("--device", default="cuda")

    app = sub.add_parser("app", help="manage apps")
    app_sub = app.add_subparsers(dest="app_command", required=True)
    ap_new = app_sub.add_parser("new")
    ap_new.add_argument("name")
    ap_new.add_argument("--description")
    ap_new.add_argument("--access-key", default="")
    app_sub.add_parser("list")
    for cmd in ("show", "delete", "data-delete", "compact"):
        sp = app_sub.add_parser(cmd)
        sp.add_argument("name")
        if cmd in ("data-delete", "compact"):
            sp.add_argument("--channel")
    ch_new = app_sub.add_parser("channel-new")
    ch_new.add_argument("name")
    ch_new.add_argument("channel")
    ch_del = app_sub.add_parser("channel-delete")
    ch_del.add_argument("name")
    ch_del.add_argument("channel")

    ak = sub.add_parser("accesskey", help="manage access keys")
    ak_sub = ak.add_subparsers(dest="accesskey_command", required=True)
    ak_new = ak_sub.add_parser("new")
    ak_new.add_argument("app_name")
    ak_new.add_argument("events", nargs="*")
    ak_list = ak_sub.add_parser("list")
    ak_list.add_argument("app_name", nargs="?")
    ak_del = ak_sub.add_parser("delete")
    ak_del.add_argument("key")

    imp = sub.add_parser("import", help="bulk-load JSON-lines events")
    imp.add_argument("--appname", required=True)
    imp.add_argument("--input", required=True)
    imp.add_argument("--channel")
    exp = sub.add_parser("export", help="dump events to JSON-lines")
    exp.add_argument("--appname", required=True)
    exp.add_argument("--output", required=True)
    exp.add_argument("--channel")
    exp.add_argument(
        "--sharded",
        type=int,
        default=0,
        metavar="N",
        help="N round-robin shard files for multi-host reads (waits for the "
        "port's parallel reader; refused)",
    )
    exp.add_argument(
        "--format",
        choices=("json", "columnar"),
        default="json",
        help="json = JSON-lines; columnar = dictionary-encoded segment "
        "directory, re-importable and readable at array speed (the "
        "reference's --format parquet role)",
    )

    train = sub.add_parser("train", help="run the training workflow")
    train.add_argument("--engine-json", default="engine.json")
    train.add_argument("--batch", default="")
    train.add_argument("--skip-sanity-check", action="store_true")
    train.add_argument("--stop-after-read", action="store_true")
    train.add_argument("--stop-after-prepare", action="store_true")
    train.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")

    deploy = sub.add_parser("deploy", help="serve the latest trained instance")
    deploy.add_argument("--engine-json", default="engine.json")
    deploy.add_argument("--ip", default="0.0.0.0")
    deploy.add_argument("--port", type=int, default=8000)
    deploy.add_argument("--engine-instance-id")
    deploy.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")

    ev = sub.add_parser("eval", help="run an evaluation sweep")
    ev.add_argument("evaluation", help="import path of the Evaluation object")
    ev.add_argument(
        "params_generator",
        nargs="?",
        help="import path of the EngineParamsGenerator (optional if the "
        "Evaluation supplies engine_params_list)",
    )
    ev.add_argument("--batch", default="")
    ev.add_argument("--output-path", default="best.json")
    ev.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")

    es = sub.add_parser("eventserver", help="start the event server")
    es.add_argument("--ip", default="0.0.0.0")
    es.add_argument("--port", type=int, default=7070)
    es.add_argument("--stats", action="store_true")
    # background compaction: 0 (the default) starts no scheduler thread
    es.add_argument(
        "--compact-interval-s", type=float, default=0.0, metavar="S",
        help="sweep the columnar event store every S seconds and compact "
        "streams past the watermarks below (0 = no background "
        "compaction; requires the columnar EVENTDATA backend)",
    )
    es.add_argument(
        "--compact-tail-mb", type=float, default=32.0, metavar="MB",
        help="tail-size watermark: compact a stream whose live JSONL "
        "tail exceeds MB mebibytes (default 32)",
    )
    es.add_argument(
        "--compact-dead-tombstones", type=int, default=10000, metavar="N",
        help="dead-bytes watermark: compact a stream with >= N "
        "tombstoned tail events (default 10000)",
    )
    es.add_argument(
        "--compact-min-interval-s", type=float, default=30.0, metavar="S",
        help="rate limit: never compact the same stream twice within S "
        "seconds (default 30)",
    )
    es.add_argument("--cert", default=None, help="PEM certificate for https (default: $PIO_SSL_CERT)")
    es.add_argument("--key", default=None, help="PEM private key for https (default: $PIO_SSL_KEY)")
    es.add_argument(
        "--drain-deadline-s", type=float, default=0.0, metavar="S",
        help="graceful drain on SIGTERM/SIGINT: stop accepting (503 + "
        "Retry-After, /readyz flips unready), finish in-flight requests "
        "within S seconds, flush storage, exit 0; a second signal "
        "force-quits. 0 (default) keeps immediate exit",
    )
    return p


def _deploy(args: argparse.Namespace) -> None:
    from predictionio_tpu_torch.controller.context import local_context
    from predictionio_tpu_torch.workflow.engine_json import load_engine_variant
    from predictionio_tpu_torch.workflow.serving import QueryServer, QueryService

    variant = load_engine_variant(args.engine_json)
    service = QueryService(
        variant, local_context(args.device), instance_id=args.engine_instance_id
    )
    stop = threading.Event()
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda s, f: stop.set())
        signal.signal(signal.SIGINT, lambda s, f: stop.set())
    with QueryServer(service, args.ip, args.port) as server:
        if args.port == 0:
            print(f"Bound port {server.port}", flush=True)
        print(
            f"Engine is deployed and running. Listening on {args.ip}:{server.port}",
            flush=True,
        )
        while not stop.wait(0.5):
            pass
    print("Engine server stopped.", flush=True)


def _ssl_from_args(args: argparse.Namespace):
    """TLS context from --cert/--key, falling back to the PIO_SSL_CERT /
    PIO_SSL_KEY env vars; None = plain http. A half-specified pair is an
    error: starting plain HTTP when the operator passed --cert would leak
    traffic they meant to encrypt."""
    from predictionio_tpu_torch.api.http import make_ssl_context, ssl_context_from_env

    cert = getattr(args, "cert", None)
    key = getattr(args, "key", None)
    if bool(cert) != bool(key):
        raise ValueError("--cert and --key must be given together")
    if cert and key:
        return make_ssl_context(cert, key)
    return ssl_context_from_env()


def _lifecycle_from_args(args: argparse.Namespace):
    """Opt-in :class:`~predictionio_tpu_torch.api.lifecycle.DrainManager`
    from ``--drain-deadline-s``; 0 (the default) returns None and signals
    keep their immediate exit. When enabled, SIGTERM/SIGINT handlers are
    installed here (console main runs on the main thread) and the
    process-wide storage flush is the final drain hook."""
    deadline = getattr(args, "drain_deadline_s", 0.0)
    if not deadline or deadline <= 0:
        return None
    from predictionio_tpu_torch import resilience
    from predictionio_tpu_torch.api.lifecycle import DrainManager
    from predictionio_tpu_torch.data.storage import Storage

    lifecycle = DrainManager(deadline)
    lifecycle.install_signals()
    lifecycle.add_drain_hook(Storage.close)
    resilience.register_stats("lifecycle", lifecycle)
    return lifecycle


def _eventserver(args: argparse.Namespace) -> None:
    from predictionio_tpu_torch.api import EventService
    from predictionio_tpu_torch.api.http import serve

    service = EventService(stats=args.stats)
    if args.compact_interval_s and args.compact_interval_s > 0:
        from predictionio_tpu_torch.data.storage import Storage
        from predictionio_tpu_torch.data.storage.compaction import (
            CompactionConfig,
            CompactionScheduler,
        )

        le = Storage.get_l_events()
        if not (hasattr(le, "stream_stats") and hasattr(le, "compact")):
            raise SystemExit(
                "--compact-interval-s needs an EVENTDATA backend "
                "with a tail to compact (TYPE=columnar)"
            )
        service.compaction_scheduler = CompactionScheduler(
            le,
            CompactionConfig(
                interval_s=args.compact_interval_s,
                tail_bytes_high=int(args.compact_tail_mb * 1024 * 1024),
                dead_tombstones_high=args.compact_dead_tombstones,
                min_interval_s=args.compact_min_interval_s,
            ),
        )
        service.compaction_scheduler.start()
        print(
            f"Background compaction: every {args.compact_interval_s:g}s, tail >= "
            f"{args.compact_tail_mb:g} MiB or >= "
            f"{args.compact_dead_tombstones} dead tombstones"
        )

    def ready(server) -> None:
        if args.port == 0:
            print(f"Bound port {server.server_address[1]}", flush=True)

    print(f"Event Server is listening on {args.ip}:{args.port}", flush=True)
    serve(
        service.dispatch, args.ip, args.port,
        ssl_context=_ssl_from_args(args),
        ready_callback=ready,
        lifecycle=_lifecycle_from_args(args),
    )


def _eval(args: argparse.Namespace) -> None:
    from predictionio_tpu_torch.controller.context import local_context
    from predictionio_tpu_torch.controller.evaluation import EngineParamsGenerator
    from predictionio_tpu_torch.utils.reflection import resolve_attr
    from predictionio_tpu_torch.workflow.core import WorkflowParams, run_evaluation

    evaluation = resolve_attr(args.evaluation)
    if callable(evaluation) and not hasattr(evaluation, "engine"):
        evaluation = evaluation()
    if args.params_generator:
        generator = resolve_attr(args.params_generator)
        if callable(generator) and not hasattr(generator, "engine_params_list"):
            generator = generator()
    else:
        generator = EngineParamsGenerator(getattr(evaluation, "engine_params_list", ()))
    _, result = run_evaluation(
        evaluation,
        generator,
        local_context(args.device),
        WorkflowParams(batch=args.batch),
        evaluation_class=args.evaluation,
        generator_class=args.params_generator or "",
    )
    print(result.leaderboard())
    with open(args.output_path, "w") as f:
        json.dump(result.to_json(), f, indent=2, default=str)
    print(f"Best params written to {args.output_path}")


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cmd = args.command
    try:
        if cmd == "version":
            print(__version__)
        elif cmd == "status":
            return 0 if commands.status_check(args.device)["ok"] else 1
        elif cmd == "app":
            ac = args.app_command
            if ac == "new":
                commands.app_new(args.name, args.description, args.access_key)
            elif ac == "list":
                commands.app_list()
            elif ac == "show":
                commands.app_show(args.name)
            elif ac == "delete":
                commands.app_delete(args.name)
            elif ac == "data-delete":
                commands.app_data_delete(args.name, args.channel)
            elif ac == "compact":
                commands.app_compact(args.name, args.channel)
            elif ac == "channel-new":
                commands.channel_new(args.name, args.channel)
            elif ac == "channel-delete":
                commands.channel_delete(args.name, args.channel)
        elif cmd == "accesskey":
            akc = args.accesskey_command
            if akc == "new":
                commands.accesskey_new(args.app_name, args.events)
            elif akc == "list":
                commands.accesskey_list(args.app_name)
            elif akc == "delete":
                commands.accesskey_delete(args.key)
        elif cmd == "import":
            commands.import_events(args.appname, args.input, args.channel)
        elif cmd == "export":
            commands.export_events(
                args.appname, args.output, args.channel,
                num_shards=args.sharded, format=args.format,
            )
        elif cmd == "eventserver":
            _eventserver(args)
        elif cmd == "train":
            from predictionio_tpu_torch.controller.context import local_context
            from predictionio_tpu_torch.workflow.core import WorkflowParams, run_train
            from predictionio_tpu_torch.workflow.engine_json import load_engine_variant

            instance = run_train(
                load_engine_variant(args.engine_json),
                local_context(args.device),
                WorkflowParams(
                    batch=args.batch,
                    skip_sanity_check=args.skip_sanity_check,
                    stop_after_read=args.stop_after_read,
                    stop_after_prepare=args.stop_after_prepare,
                ),
            )
            print(f"Training completed. Engine instance: {instance.id}")
        elif cmd == "deploy":
            _deploy(args)
        elif cmd == "eval":
            _eval(args)
        return 0
    except Exception as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
