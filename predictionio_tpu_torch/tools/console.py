"""The port's ``pio`` console — an argparse front-end over the command layer.

Counterpart of ``predictionio_tpu/tools/console.py`` (parity:
``tools/console/Console.scala``), for the commands of the quickstart:

    pio version | status [--device D]
    pio app new NAME | app list
    pio import --appname APP --input FILE [--channel C]
    pio train  --engine-json FILE [--batch B] [--skip-sanity-check]
               [--stop-after-read] [--stop-after-prepare] [--device D]
    pio deploy --engine-json FILE [--ip IP] [--port N]
               [--engine-instance-id ID] [--device D]
    pio eval   EVALUATION [PARAMS_GENERATOR] [--batch B]
               [--output-path FILE] [--device D]

Where the JAX console takes ``--mesh``, ``train``, ``deploy`` and
``eval`` take ``--device``: ``cuda`` (the default, the card; it fails
where there is none) or ``cpu``. ``deploy --port 0`` binds a free port
and prints ``Bound port N``; SIGTERM or SIGINT stops it. ``eval`` takes
import paths (``module:attr``) of an ``Evaluation`` and, optionally, an
``EngineParamsGenerator`` (else the evaluation's own
``engine_params_list``), prints the leaderboard and writes the result's
JSON to ``--output-path``. Run as ``python -m
predictionio_tpu_torch.tools.console``.

Waiting: ``export``, ``eventserver``, ``undeploy``, ``import`` of a
columnar export directory, ``eval --grid`` and ``eval --promote-to``,
``train --warm-start`` and the deploy's serving options.
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

    imp = sub.add_parser("import", help="bulk-load JSON-lines events")
    imp.add_argument("--appname", required=True)
    imp.add_argument("--input", required=True)
    imp.add_argument("--channel")

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
            if args.app_command == "new":
                commands.app_new(args.name, args.description, args.access_key)
            else:
                commands.app_list()
        elif cmd == "import":
            commands.import_events(args.appname, args.input, args.channel)
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
