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
    pio storageserver [--ip IP] [--port N] [--secret S]
               [--cert PEM --key PEM] [--drain-deadline-s S]
    pio train  --engine-json FILE [--batch B] [--skip-sanity-check]
               [--stop-after-read] [--stop-after-prepare] [--warm-start]
               [--device D] [--mesh auto|none|data=N,model=M] [--aot]
    pio deploy --engine-json FILE [--ip IP] [--port N]
               [--engine-instance-id ID] [--device D]
               [--batching ...] [--result-cache ...] [--coalesce]
               [--pin-model] [--feedback ...] [--retry-* --breaker-*]
               [--online [--online-interval-s S] [--online-batch N]
                [--online-algos NAMES] [--online-prior-weight W]
                [--online-from-start]]
               [--explore epsilon|thompson [--explore-epsilon E]
                [--explore-seed N] [--explore-reward-event NAME]]
               [--replicas N [--variants NAME:W,...] [--autoscale LO:HI]
                [--endpoint-registry DIR] [--probe-interval-s S] ...]
               [--router-only] [--cert PEM --key PEM] [--drain-deadline-s S]
    pio undeploy [--ip IP] [--port N] [--https] [--insecure] [--token T]
    pio batchpredict --engine-json FILE --input FILE --output FILE
               [--engine-instance-id ID] [--device D]
    pio eval   EVALUATION [PARAMS_GENERATOR] [--batch B]
               [--output-path FILE] [--device D] [--grid] [--promote-to URL]
    pio template list | get NAME DIRECTORY [--appname APP]
    pio dashboard [--ip IP] [--port N]  |  pio adminserver [--ip IP] [--port N]
               [--cert PEM --key PEM] [--drain-deadline-s S]
    pio chaos-ingest [--cycles N] [--writers N] [--events N]
               [--backend sqlite|columnar] [--bulk-events N] [--partitions P
                [--replication R] [--ack-quorum Q]] [--seed S] [--keep]
    pio chaos-serve [--replicas N] [--clients N] [--kills N] [--seconds S]
               [--reloads N] [--events N] [--aot] [--sharded-point]
               [--device D] [--seed S] [--keep]
    pio chaos-fleet [--replicas-per-host N] [--clients N] [--seconds S]
               [--events N] [--lease-ttl-s S] [--skip-autoscale]
               [--device D] [--seed S] [--keep]
    pio build | run CMD [ARG ...] | upgrade

``train``, ``deploy``, ``batchpredict`` and ``eval`` take ``--device``
as well: ``cuda`` (the default, the card; it fails where there is none)
or ``cpu``. ``deploy --port 0``, ``eventserver --port 0`` and
``storageserver --port 0`` bind a free port and print ``Bound port
N``; SIGTERM or SIGINT stops each (after a drain when given
``--drain-deadline-s``), and so does ``pio undeploy`` for a deploy, with
the stop token the deploy wrote under the base directory. ``deploy``
takes the JAX console's flags: those of the serving tiers the port has
(micro-batching, result cache, singleflight, pinned tables, sharded
tables ``--shard-factors``, int8 tables ``--quantize int8``, IVF
retrieval ``--ann*``, feedback, online
learning, exploration ``--explore*``, storage resilience, TLS, drain,
AOT serving ``--aot``, and the replica fleet: ``--replicas N`` spawns N
port deploys behind a stdlib router on ``--port``, ``--variants`` splits
its traffic into A/B variants, ``--router-only`` serves a second router
on the same endpoint registry, ``--autoscale`` grows and shrinks the
fleet). ``train --aot`` compiles the trained instance's serving programs
with AOTInductor into ``<basedir>/fleet/aot/<instance>/`` and stamps the
set into the fleet model registry; ``deploy --aot`` boots by loading
them (``workflow/aot.py``). ``--compilation-cache-dir DIR`` (train and
deploy) puts Inductor's and Triton's caches under ``DIR`` (then
``$PIO_COMPILATION_CACHE_DIR``, then ``<basedir>/torch_cache``; ``0``
turns them off). A fleet's router process imports no
torch; each replica is ``python -m predictionio_tpu_torch.tools.console
deploy`` with the fleet's other flags, ``--device`` among them. The data
verbs, ``eventserver`` and ``storageserver`` import no torch. ``eval`` takes import paths
(``module:attr``) of an ``Evaluation`` and, optionally, an
``EngineParamsGenerator`` (else the evaluation's own
``engine_params_list``), prints the leaderboard and writes the result's
JSON to ``--output-path``; ``--grid`` scores a lambda/alpha/seed grid of
ALS candidates as one batched program a fold on ``--device``, and
``--promote-to URL`` then promotes the winner on a fleet router deployed
with one variant a candidate. Run as ``python -m
predictionio_tpu_torch.tools.console``.

``train --mesh`` (default ``auto``: every local position on the data
axis; ``none``; ``data=N,model=M``) trains on a mesh of this process's
devices. With ``PIO_COORDINATOR_ADDRESS``, ``PIO_NUM_PROCESSES`` and
``PIO_PROCESS_ID`` set, ``train`` first joins the ``torch.distributed``
process group (``parallel/distributed.py``); every process runs the same
command on its shard of the events, the data axis spans the processes,
and process 0 writes the instance and the blob. ``export --sharded N``
writes N round-robin shard files (``parallel/reader.py``).

``dashboard`` (port 9000) lists the completed evaluations, ``adminserver``
(port 7071) is the REST mirror of the app verbs; both take ``--port 0``
as the servers above do and import no torch. ``chaos-ingest``,
``chaos-serve`` and ``chaos-fleet`` are the operator's drills
(``resilience/chaos.py``): each starts real port processes, SIGKILLs them
under load, prints a JSON report and exits 1 unless its ``ok`` is true.
The serving drills train and deploy on ``--device``. ``run`` executes a
command with ``PIO_FS_BASEDIR`` resolved and the repository root on
``PYTHONPATH``; ``build`` and ``upgrade`` only print, as the JAX
console's do.

``lint`` runs the port's piolint over the repository (both packages;
``--format text|json|sarif``, the baseline flags, ``--witness REPORT``
to cross-check a ``tsan`` report against the port's static lock graph);
``tsan -- CMD`` and ``jitwitness -- CMD`` run CMD in this process under
the lock witness or the compile and transfer witness
(``predictionio_tpu_torch/analysis``) and print its JSON report. Exit
codes as the JAX console's: 0 clean, 1 findings or a failed check or
command, 2 an internal error of the linter.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

from predictionio_tpu_torch import __version__
from predictionio_tpu_torch.tools import commands

__all__ = ["main", "build_parser"]


#: deploy flags of serving tiers the port does not have yet: they parse
#: (so a JAX package's deploy command line reads) and are then refused,
#: naming what each waits for (ROADMAP queue 1); none is left
_WAITING_DEPLOY_FLAGS: dict = {}


def _int_at_least(floor: int):
    """argparse ``type=``: an int with a lower bound, so a bad value
    fails at parse time with the usual ``usage:`` error."""

    def parse(text: str) -> int:
        try:
            value = int(text)
        except ValueError:
            raise argparse.ArgumentTypeError(f"invalid int value: {text!r}") from None
        if value < floor:
            raise argparse.ArgumentTypeError(f"must be >= {floor}")
        return value

    return parse


def _add_deploy_flags(deploy: argparse.ArgumentParser) -> None:
    """The JAX console's deploy flags: those the port serves, then those
    of later tiers (:data:`_WAITING_DEPLOY_FLAGS`)."""
    deploy.add_argument("--engine-json", default="engine.json")
    deploy.add_argument("--ip", default="0.0.0.0")
    deploy.add_argument("--port", type=int, default=8000)
    deploy.add_argument("--engine-instance-id")
    deploy.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")
    # feedback loop: each answered query posts a `predict` event
    deploy.add_argument("--feedback", action="store_true")
    deploy.add_argument("--event-server-ip", default="127.0.0.1")
    deploy.add_argument("--event-server-port", type=int, default=7070)
    deploy.add_argument("--accesskey", default="")
    deploy.add_argument("--feedback-timeout", type=float, default=5.0, metavar="S",
                        help="socket timeout of a feedback post (worker thread)")
    deploy.add_argument("--feedback-block-ms", type=float, default=0.0,
                        help="block the query thread up to this long for a feedback "
                        "queue slot before dropping (default 0: drop at once)")
    deploy.add_argument("--no-feedback-blocking", action="store_true",
                        help="never block the query path for feedback (the default)")
    deploy.add_argument("--feedback-breaker-threshold", type=int, default=0, metavar="N",
                        help="failed feedback posts that open the feedback breaker (0 = off)")
    deploy.add_argument("--feedback-breaker-reset-s", type=float, default=5.0,
                        help="seconds an open feedback breaker waits before probing")
    # cross-request micro-batching
    deploy.add_argument("--batching", action="store_true",
                        help="coalesce concurrent /queries.json requests into batched "
                        "score products")
    deploy.add_argument("--max-batch-size", type=int, default=32)
    deploy.add_argument("--max-batch-delay-ms", type=float, default=2.0,
                        help="longest wait for batchmates past the oldest queued request")
    deploy.add_argument("--batch-queue", type=int, default=256,
                        help="bounded admission queue size")
    deploy.add_argument("--admission-policy", choices=("reject", "block"), default="reject",
                        help="full queue: reject = 429 + Retry-After, block = wait up to "
                        "--admission-timeout-ms, then 503")
    deploy.add_argument("--admission-timeout-ms", type=float, default=1000.0)
    deploy.add_argument("--batch-buckets", default="",
                        help="comma-separated batch sizes to pad to (default: powers of "
                        "two up to --max-batch-size)")
    deploy.add_argument("--batch-warmup-query", default=None, metavar="JSON",
                        help="sample query body run through every bucket at startup")
    # query-path caching & coalescing
    deploy.add_argument("--result-cache", action="store_true",
                        help="serve repeated identical queries from an LRU with TTL and "
                        "event-driven invalidation")
    deploy.add_argument("--result-cache-entries", type=int, default=4096)
    deploy.add_argument("--result-cache-ttl-s", type=float, default=30.0)
    deploy.add_argument("--result-cache-max-mb", type=float, default=64.0)
    deploy.add_argument("--cache-scope-field", default="user", metavar="FIELD",
                        help="query field naming the invalidation scope; 'none' disables")
    deploy.add_argument("--coalesce", action="store_true",
                        help="collapse identical in-flight queries into one computation")
    deploy.add_argument("--pin-model", action="store_true",
                        help="pin the factor tables on the deploy's device (always on "
                        "the card; on the CPU, tensors in place of numpy)")
    # storage resilience
    deploy.add_argument("--retry-reads", type=int, default=0, metavar="N")
    deploy.add_argument("--retry-writes", action="store_true")
    deploy.add_argument("--breaker-threshold", type=int, default=0, metavar="N")
    deploy.add_argument("--breaker-reset-s", type=float, default=5.0)
    deploy.add_argument("--rpc-deadline-s", type=float, default=0.0)
    # online learning (predictionio_tpu_torch.online): tail the columnar
    # event store and fold fresh events into the live model
    deploy.add_argument("--online", action="store_true",
                        help="tail the event store and fold fresh events into the live model "
                        "(ALS fold-in, streaming two-tower SGD; columnar event store required)")
    deploy.add_argument("--online-interval-s", type=float, default=1.0, metavar="S",
                        help="seconds between watermark polls of the event tail")
    deploy.add_argument("--online-batch", type=int, default=4096, metavar="N",
                        help="most events folded per batch")
    deploy.add_argument("--online-algos", default="", metavar="NAMES",
                        help="comma-separated algorithm-class allowlist (default: every algorithm "
                        "with the online hooks)")
    deploy.add_argument("--online-prior-weight", type=float, default=1.0, metavar="W",
                        help="anchor strength toward each entity's trained row in the fold-in "
                        "re-solve; 0 = pure fold-in")
    deploy.add_argument("--online-from-start", action="store_true",
                        help="fold events already in the store at deploy time too")
    deploy.add_argument("--cert", default=None, help="PEM certificate for https (default: $PIO_SSL_CERT)")
    deploy.add_argument("--key", default=None, help="PEM private key for https (default: $PIO_SSL_KEY)")
    deploy.add_argument("--drain-deadline-s", type=float, default=0.0, metavar="S",
                        help="graceful drain on SIGTERM/SIGINT within S seconds (0: "
                        "stop at once)")
    # int8 tables (ops/quant.py) and IVF retrieval (ops/ivf.py)
    deploy.add_argument("--quantize", choices=("int8",), default=None, metavar="DTYPE",
                        help="serve the factor tables (and --ann's IVF slabs) as int8 codes "
                        "and per-row scales, through a two-stage top-k (int8 coarse scan, "
                        "f32 rescore)")
    deploy.add_argument("--ann", action="store_true",
                        help="serve top-K through an IVF index built at each (re)load: "
                        "score nprobe cluster slabs a query instead of the catalog")
    deploy.add_argument("--ann-nlist", type=int, default=0, metavar="N",
                        help="k-means cluster count for --ann (0: ~sqrt(catalog items))")
    deploy.add_argument("--ann-nprobe", type=int, default=8, metavar="N",
                        help="clusters scored a query for --ann; nprobe >= nlist is exact "
                        "retrieval, to the bit")
    deploy.add_argument("--ann-seed", type=int, default=0,
                        help="k-means seed for --ann (a build is deterministic per seed)")
    deploy.add_argument("--ann-kmeans-iters", type=int, default=8, metavar="N",
                        help="Lloyd iterations after k-means++ seeding")
    # exploration (predictionio_tpu_torch.experiments): off by default,
    # and then the package is never imported
    deploy.add_argument("--explore", choices=("epsilon", "thompson"), default=None, metavar="POLICY",
                        help="re-rank each answer's top-K through a bandit policy (epsilon-greedy or "
                        "Thompson sampling over per-item posteriors); rewards fold back through "
                        "--online's follower or POST /experiments/reward.json")
    deploy.add_argument("--explore-epsilon", type=float, default=0.1, metavar="E",
                        help="epsilon policy: probability a query serves an explored head")
    deploy.add_argument("--explore-seed", type=int, default=0,
                        help="seed of the policy's per-query generators")
    deploy.add_argument("--explore-reward-event", default="reward", metavar="NAME",
                        help="event name counted as bandit reward")
    # the replica fleet (predictionio_tpu_torch.fleet): off by default,
    # and then the package is never imported
    deploy.add_argument("--replicas", type=_int_at_least(1), default=0, metavar="N",
                        help="serve through N replica deploys behind a router on --port: "
                        "consistent hash of the cache scope, health gating, failover, "
                        "rolling /reload")
    deploy.add_argument("--replica-id", default=None, metavar="ID",
                        help="fleet-internal: this process is replica ID (set by the supervisor)")
    deploy.add_argument("--variants", default="", metavar="NAME[:W],...",
                        help="router: split /queries.json into weighted A/B variants, sticky by "
                        "cache scope; POST /experiments/promote.json picks the winner")
    deploy.add_argument("--probe-interval-s", type=float, default=0.25, metavar="S",
                        help="router: seconds between /readyz probes of each replica")
    deploy.add_argument("--failover-retries", type=_int_at_least(0), default=1, metavar="N",
                        help="router: re-dispatches of one idempotent request to a peer")
    deploy.add_argument("--hedge-ms", type=float, default=0.0, metavar="MS",
                        help="router: hedge a query to a second replica after max(MS, p95); 0 = off")
    deploy.add_argument("--fleet-breaker-threshold", type=_int_at_least(1), default=2, metavar="N",
                        help="router: consecutive transport failures that open a replica's breaker")
    deploy.add_argument("--fleet-breaker-reset-s", type=float, default=1.0, metavar="S",
                        help="router: seconds an open replica breaker waits before probing")
    deploy.add_argument("--endpoint-registry", default=None, metavar="DIR",
                        help="fleet: shared endpoint-registry directory replicas announce into "
                        "(default <basedir>/fleet/endpoints)")
    deploy.add_argument("--router-only", action="store_true",
                        help="fleet: serve a router without spawning replicas (HA pair on one "
                        "--endpoint-registry)")
    deploy.add_argument("--autoscale", default="", metavar="MIN:MAX",
                        help="fleet: scale the replicas between MIN and MAX on the watermarks below")
    deploy.add_argument("--scale-up-qps", type=float, default=50.0, metavar="Q")
    deploy.add_argument("--scale-up-p99-ms", type=float, default=250.0, metavar="MS")
    deploy.add_argument("--scale-down-qps", type=float, default=5.0, metavar="Q")
    deploy.add_argument("--scale-cooldown-s", type=float, default=10.0, metavar="S")
    deploy.add_argument("--stale-cache-ttl-s", type=float, default=0.0, metavar="S",
                        help="router: serve a scope's last good answer (X-PIO-Stale) up to S "
                        "seconds when no replica can; 0 = off")
    deploy.add_argument("--lease-ttl-s", type=float, default=5.0, metavar="S",
                        help="endpoint registry: seconds a replica's lease lives between heartbeats")
    deploy.add_argument("--announce-dir", default=None, metavar="DIR",
                        help="replica: announce the bound address into this endpoint registry")
    deploy.add_argument("--announce-host", default="127.0.0.1", metavar="HOST",
                        help="replica: the address other hosts reach this replica at")
    deploy.add_argument("--shard-factors", action="store_true",
                        help="pin each factor table row-sharded over the local devices (one part a card); "
                        "answers equal the replicated tables'; one card pins replicated, with a warning")
    deploy.add_argument("--aot", action="store_true",
                        help="boot by loading the instance's `pio train --aot` programs (implies "
                        "--pin-model); a missing, foreign or corrupt set falls back loudly to the "
                        "eager path with the same answers; /stats.json grows an 'aot' block")
    _add_cache_flag(deploy)


def _add_cache_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--compilation-cache-dir", default=None, metavar="DIR",
                        help="persistent Inductor and Triton caches under DIR (default: "
                        "$PIO_COMPILATION_CACHE_DIR or <basedir>/torch_cache; '0' turns them off)")


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
        help="write N round-robin shard files (events-0000i-of-0000N.jsonl) "
        "into --output, for multi-host reads",
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
    train.add_argument(
        "--warm-start", action="store_true",
        help="seed algorithms from the latest COMPLETED instance's model "
        "(retrains converge in fewer sweeps)",
    )
    train.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")
    train.add_argument(
        "--mesh",
        default="auto",
        help="'auto' (every local position on the data axis), 'none' (one device), or "
        "'data=N,model=M' axis sizes of this process's positions; under PIO_COORDINATOR_* "
        "the data axis spans the processes",
    )
    train.add_argument("--aot", action="store_true",
                       help="after training, compile the instance's serving programs per pow2 k "
                       "bucket (torch.export + AOTInductor) into <basedir>/fleet/aot/<instance>/ "
                       "and stamp them into the fleet model registry, for `pio deploy --aot`")
    _add_cache_flag(train)

    _add_deploy_flags(sub.add_parser("deploy", help="serve the latest trained instance"))

    und = sub.add_parser("undeploy", help="stop a deployed engine server via GET /stop")
    und.add_argument("--ip", default="127.0.0.1")
    und.add_argument("--port", type=int, default=8000)
    und.add_argument("--https", action="store_true")
    und.add_argument(
        "--insecure", action="store_true",
        help="skip TLS certificate verification (self-signed deployments)",
    )
    und.add_argument(
        "--token", default=None,
        help="deployment stop token (default: read from the base directory's "
        "token file written by `pio deploy` for this port)",
    )

    bp = sub.add_parser("batchpredict", help="bulk predictions from a query file")
    bp.add_argument("--engine-json", default="engine.json")
    bp.add_argument("--input", required=True, help="JSON-lines query file")
    bp.add_argument("--output", required=True, help="JSON-lines results file")
    bp.add_argument("--engine-instance-id")
    bp.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")

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
    ev.add_argument("--grid", action="store_true",
                    help="train and score every candidate as one batched program a fold when the "
                    "generator sweeps lambda/alpha/seed of one ALS algorithm; any other sweep "
                    "takes the sequential evaluator, with the same output")
    ev.add_argument("--promote-to", default=None, metavar="URL",
                    help="after the sweep, POST the winning candidate's variant to "
                    "URL/experiments/promote.json of a fleet router deployed with --variants, "
                    "one variant a candidate, in the same order")

    tpl = sub.add_parser("template", help="built-in engine templates")
    tpl_sub = tpl.add_subparsers(dest="template_command", required=True)
    tpl_sub.add_parser("list")
    tpl_get = tpl_sub.add_parser("get")
    tpl_get.add_argument("name")
    tpl_get.add_argument("directory")
    tpl_get.add_argument("--appname", default="MyApp")

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
    _add_ssl_and_lifecycle_flags(es)

    ss = sub.add_parser(
        "storageserver",
        help="expose this host's storage backend over the network "
        "(server side of the TYPE=remote driver)",
    )
    ss.add_argument(
        "--ip", default="127.0.0.1",
        help="bind address; binding beyond loopback requires --secret "
        "(the server grants read/write on apps, keys, events and models)",
    )
    ss.add_argument("--port", type=int, default=7072)
    ss.add_argument(
        "--secret", default=None,
        help="shared secret clients must present (default: $PIO_STORAGE_SERVER_SECRET)",
    )
    _add_ssl_and_lifecycle_flags(ss)

    db = sub.add_parser("dashboard", help="start the evaluation dashboard")
    db.add_argument("--ip", default="127.0.0.1")
    db.add_argument("--port", type=int, default=9000)
    _add_ssl_and_lifecycle_flags(db)
    adm = sub.add_parser("adminserver", help="start the admin REST server")
    adm.add_argument("--ip", default="127.0.0.1")
    adm.add_argument("--port", type=int, default=7071)
    _add_ssl_and_lifecycle_flags(adm)

    _add_chaos_parsers(sub)

    sub.add_parser("build", help="no-op (Python engines need no compilation; kept for parity)")
    # the subprocess inherits the resolved PIO_* environment, so an ad-hoc
    # script sees the storage the CLI does (Console.scala's `pio run`)
    run_p = sub.add_parser("run", help="run a command with the framework environment injected")
    run_p.add_argument(
        "run_args", nargs=argparse.REMAINDER,
        help="command and arguments (e.g. `pio run python myscript.py`)",
    )
    _add_analysis_parsers(sub)
    sub.add_parser("upgrade", help="print upgrade guidance (pip-managed; no in-place upgrader)")
    return p


def _add_analysis_parsers(sub) -> None:
    """``lint``, ``tsan`` and ``jitwitness``, with the JAX console's flags
    (``predictionio_tpu_torch/analysis``)."""
    lint = sub.add_parser(
        "lint",
        help="run piolint — AST layering/concurrency/compile-hygiene analysis "
        "over the source tree (exits 1 on any non-baselined finding)",
    )
    lint.add_argument("--root", default=None, help="tree to lint (default: this checkout's repo root)")
    lint.add_argument(
        "--format", choices=("text", "json", "sarif"), default="text",
        help="text = file:line diagnostics; json = machine-readable summary + findings; "
        "sarif = SARIF 2.1.0 (new findings level=error, baselined level=note)",
    )
    lint.add_argument("--baseline", default=None, metavar="FILE",
                      help="baseline file (default: <root>/piolint-baseline.json)")
    lint.add_argument("--update-baseline", action="store_true",
                      help="rewrite the baseline to the current findings (keeps existing justifications)")
    lint.add_argument(
        "--prune-baseline", action="store_true",
        help="drop baseline entries no current finding matches AND entries of the port's "
        "compile-budget-torch.json whose entrypoint no longer exists, accepting nothing new",
    )
    lint.add_argument(
        "--witness", default=None, metavar="REPORT",
        help="cross-check a recorded lock-witness report (pio tsan JSON output) against the "
        "port's static lock graph, both directions: a witnessed acquisition order missing "
        "from the static digraph (analyzer gap) or a static cycle that neither manifested nor "
        "carries a lock-witness-waivers.json entry fails the lint",
    )
    tsan = sub.add_parser(
        "tsan",
        help="run a pio command under the lock-witness sanitizer: the lock acquisition-order "
        "digraph, hold times, sleeps under a lock, fsync and rename order; witnessed "
        "inversions fail the run, and every static PIO207 cycle is CONFIRMED or PLAUSIBLE",
    )
    tsan.add_argument("--report", default=None, metavar="FILE", help="also write the JSON report to FILE")
    tsan.add_argument("--long-hold-ms", type=float, default=50.0,
                      help="hold time above which an acquisition counts as a long hold (default 50)")
    tsan.add_argument("tsan_args", nargs=argparse.REMAINDER,
                      help="command to run under the witness, e.g. `pio tsan -- train ...`")
    jitw = sub.add_parser(
        "jitwitness",
        help="run a pio command under the jit-witness sanitizer: compiles per call site "
        "(nvcc, AOTInductor loads, Inductor, Dynamo) with seconds, device-to-host copies "
        "with bytes, per-call torch.compile/aoti_load_package constructions; classifies "
        "every static PIO306-308 finding and checks compile-budget-torch.json",
    )
    jitw.add_argument("--report", default=None, metavar="FILE", help="also write the JSON report to FILE")
    jitw.add_argument("--ledger", default=None, metavar="FILE",
                      help="compile-budget ledger (default: <repo>/compile-budget-torch.json)")
    jitw.add_argument("jitwitness_args", nargs=argparse.REMAINDER,
                      help="command to run under the witness, e.g. `pio jitwitness -- batchpredict ...`")


def _add_chaos_parsers(sub) -> None:
    """``chaos-ingest``, ``chaos-serve`` and ``chaos-fleet``: the JAX
    console's flags and defaults; the serving drills add ``--device``."""
    ch = sub.add_parser(
        "chaos-ingest",
        help="crash-safety drill: SIGKILL a real event-server subprocess "
        "under concurrent retrying writers and verify exactly-once "
        "ingestion, clean recovery, and graceful drain",
    )
    ch.add_argument("--cycles", type=int, default=3, help="SIGKILL/restart cycles")
    ch.add_argument("--writers", type=int, default=4, help="concurrent writer threads")
    ch.add_argument("--events", type=int, default=120, help="events per writer across the whole run")
    ch.add_argument(
        "--backend", choices=("sqlite", "columnar"), default="sqlite",
        help="EVENTDATA backend under test (columnar runs with FSYNC=true)",
    )
    ch.add_argument("--seed", type=int, default=0, help="kill-schedule RNG seed")
    ch.add_argument(
        "--bulk-events", type=int, default=1000,
        help="events streamed through POST /events/bulk.json in the "
        "bulk-writer phase (SIGKILL lands mid-stream; 0 disables)",
    )
    ch.add_argument(
        "--drain-deadline-s", type=float, default=5.0,
        help="drain deadline for the final SIGTERM-under-load phase",
    )
    ch.add_argument(
        "--partitions", type=_int_at_least(1), default=1,
        help=">1 adds the kill-one-partition drill: a columnar store "
        "with PARTITIONS=P, one partition's appender chaos-killed "
        "mid-bulk-stream plus a whole-server SIGKILL mid-retry — zero "
        "acked loss, zero duplicates, surviving partitions never stall, "
        "the killed partition catches up",
    )
    ch.add_argument(
        "--replication", type=int, default=0,
        help="with --partitions: replicas per partition (0 off, else "
        ">= 2); the drill also kills one non-leader replica and asserts "
        "loud quorum-loss degradation plus replica catch-up",
    )
    ch.add_argument(
        "--ack-quorum", type=int, default=0,
        help="fsync-durable copies required per ack (default: majority of --replication)",
    )
    ch.add_argument("--keep", action="store_true", help="keep the scratch storage directory for inspection")

    cs = sub.add_parser(
        "chaos-serve",
        help="serving-fleet drill: train a tiny model, deploy "
        "`--replicas N` behind the router, SIGKILL replicas under >= 16 "
        "concurrent query clients and rolling-/reload the fleet — "
        "verifying ZERO failed queries, zero cross-generation results, "
        "and p99 recovery within one breaker reset",
    )
    cs.add_argument("--replicas", type=_int_at_least(1), default=2,
                    help="fleet size for the kill/rolling phases (default 2)")
    cs.add_argument("--clients", type=_int_at_least(1), default=16, help="concurrent query clients (default 16)")
    cs.add_argument("--kills", type=_int_at_least(1), default=1,
                    help="replica SIGKILLs during the kill phase (default 1)")
    cs.add_argument("--seconds", type=float, default=6.0, help="kill-phase duration in seconds (default 6)")
    cs.add_argument("--reloads", type=_int_at_least(0), default=1,
                    help="rolling /reload rotations under load (default 1)")
    cs.add_argument("--events", type=int, default=400, help="synthetic training events (default 400)")
    cs.add_argument("--seed", type=int, default=0, help="workload RNG seed")
    cs.add_argument(
        "--aot", action="store_true",
        help="run the drill AOT-on: `pio train --aot` exports the "
        "generation's programs, replicas deploy with --aot, and the "
        "rolling-reload phase additionally asserts ZERO serve-time "
        "compiles across the full rotation",
    )
    cs.add_argument(
        "--sharded-point", action="store_true",
        help="also measure one fleet whose replicas serve with "
        "--shard-factors over this machine's cards (on one card each "
        "replica falls back to --pin-model replication)",
    )
    cs.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu', for the drill's train and deploys")
    cs.add_argument("--keep", action="store_true", help="keep the scratch storage directory for inspection")

    cf = sub.add_parser(
        "chaos-fleet",
        help="cross-host elastic-fleet drill: two 'hosts' (separate "
        "basedirs) share one endpoint registry behind an HA router "
        "pair; SIGKILL an entire host's fleet under concurrent "
        "never-retrying clients (zero failed queries, the survivor "
        "absorbs, the dead host rejoins via the registry), drive the "
        "autoscaler through a watermark scale-up and a drain-aware "
        "scale-down (zero in-flight loss), and prove the "
        "stale-while-down cache serves marked answers only when every "
        "replica is dead",
    )
    cf.add_argument("--replicas-per-host", type=_int_at_least(1), default=1,
                    help="replica fleet size on each 'host' (default 1)")
    cf.add_argument("--clients", type=_int_at_least(1), default=16, help="concurrent query clients (default 16)")
    cf.add_argument("--seconds", type=float, default=6.0, help="host-kill phase duration in seconds (default 6)")
    cf.add_argument("--events", type=int, default=400, help="synthetic training events (default 400)")
    cf.add_argument("--lease-ttl-s", type=float, default=1.0,
                    help="endpoint-registry lease TTL under test (default 1.0)")
    cf.add_argument("--seed", type=int, default=0, help="workload RNG seed")
    cf.add_argument("--skip-autoscale", action="store_true",
                    help="skip the autoscaler phase (host-kill + stale only)")
    cf.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu', for the drill's train and deploys")
    cf.add_argument("--keep", action="store_true", help="keep the scratch storage directories for inspection")


def _add_ssl_and_lifecycle_flags(sp: argparse.ArgumentParser) -> None:
    sp.add_argument("--cert", default=None, help="PEM certificate for https (default: $PIO_SSL_CERT)")
    sp.add_argument("--key", default=None, help="PEM private key for https (default: $PIO_SSL_KEY)")
    sp.add_argument(
        "--drain-deadline-s", type=float, default=0.0, metavar="S",
        help="graceful drain on SIGTERM/SIGINT: stop accepting (503 + "
        "Retry-After, /readyz flips unready), finish in-flight requests "
        "within S seconds, flush storage, exit 0; a second signal "
        "force-quits. 0 (default) keeps immediate exit",
    )


def _refuse_waiting_flags(args: argparse.Namespace) -> None:
    """A deploy flag of a later tier, given a value other than its
    default, raises ``ValueError`` naming what it waits for."""
    deploy = argparse.ArgumentParser(add_help=False)
    _add_deploy_flags(deploy)
    for name, waits_for in _WAITING_DEPLOY_FLAGS.items():
        if getattr(args, name) != deploy.get_default(name):
            flag = "--" + name.replace("_", "-")
            raise ValueError(f"deploy {flag} is not in the port yet; it waits for {waits_for} (ROADMAP.md)")


def _setup_compilation_cache(explicit: str | None = None) -> None:
    """Persistent Inductor and Triton caches for ``train`` and ``deploy``:
    ``TORCHINDUCTOR_CACHE_DIR`` and ``TRITON_CACHE_DIR`` under one
    directory. Precedence (the JAX console's): the
    ``--compilation-cache-dir`` flag (``explicit``), then
    ``PIO_COMPILATION_CACHE_DIR``, then ``<basedir>/torch_cache``, where
    caches an operator already set win; ``0`` turns them off.
    ``PIO_COMPILATION_CACHE_DIR`` is left naming what was configured.
    The variables reach the replicas a fleet spawns. Under ``--aot`` a
    configured cache makes a failed load report tier 2
    (``workflow/aot.py``)."""
    if explicit is None:
        explicit = os.environ.get("PIO_COMPILATION_CACHE_DIR")
    if explicit == "0":
        os.environ["PIO_COMPILATION_CACHE_DIR"] = "0"
        return
    if explicit:
        cache_dir = os.path.expanduser(explicit)
        os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache_dir, "inductor")
        os.environ["TRITON_CACHE_DIR"] = os.path.join(cache_dir, "triton")
    else:
        from predictionio_tpu_torch.data.storage import Storage

        cache_dir = os.path.join(Storage.base_dir(), "torch_cache")
        os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", os.path.join(cache_dir, "inductor"))
        os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache_dir, "triton"))
    # what this process configured, for workflow/aot.py's fallback tier
    os.environ["PIO_COMPILATION_CACHE_DIR"] = cache_dir


def _aot_root() -> str:
    from predictionio_tpu_torch.data.storage import Storage

    return os.path.join(Storage.base_dir(), "fleet", "aot")


def _parse_mesh(spec: str, device: str):
    """``pio train --mesh``: the training context. ``none`` is one device;
    ``auto`` every local position on the data axis; ``data=N,model=M``
    this process's axis sizes. Under a process group the process's device
    is the one the group gave it."""
    from predictionio_tpu_torch.controller.context import local_context, mesh_context
    from predictionio_tpu_torch.parallel import distributed

    dev = distributed.local_device() or device
    if spec == "none":
        return local_context(dev)
    if spec == "auto":
        return mesh_context(device=dev)
    sizes = {}
    for part in spec.split(","):
        axis, _, n = part.partition("=")
        if not n.strip().isdigit():
            raise ValueError(f"--mesh {spec!r}: expected 'auto', 'none' or 'data=N,model=M'")
        sizes[axis.strip()] = int(n)
    return mesh_context(axis_sizes=list(sizes.values()), axis_names=list(sizes), device=dev)


def _train(args) -> None:
    """``pio train``: the process group first when ``PIO_COORDINATOR_*`` is
    set (every process runs the same command; process 0 writes), then the
    workflow on ``--mesh``."""
    from predictionio_tpu_torch.parallel import distributed
    from predictionio_tpu_torch.workflow.core import WorkflowParams, run_train
    from predictionio_tpu_torch.workflow.engine_json import load_engine_variant

    started = not distributed.is_multihost() and distributed.initialize_from_env(device=args.device)
    try:
        _setup_compilation_cache(args.compilation_cache_dir)
        variant = load_engine_variant(args.engine_json)
        ctx = _parse_mesh(args.mesh, args.device)
        instance = run_train(
            variant,
            ctx,
            WorkflowParams(
                batch=args.batch,
                skip_sanity_check=args.skip_sanity_check,
                stop_after_read=args.stop_after_read,
                stop_after_prepare=args.stop_after_prepare,
                warm_start=args.warm_start,
            ),
        )
        if args.aot and ctx.host_index == 0:
            _train_aot_export(variant, ctx, instance)
        print(f"Training completed. Engine instance: {instance.id}")
    finally:
        if started:
            distributed.shutdown()


def _train_aot_export(variant, ctx, instance) -> None:
    """``pio train --aot``: rehydrate the trained instance as ``pio
    deploy`` will (``prepare_deploy`` over the stored blob), pin it on the
    train's device, compile its serving programs (``workflow/aot.py``) and
    stamp the set into the fleet model registry beside the generation. A
    failed export warns and never fails the train: deploy falls back
    loudly to the eager path."""
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.fleet.registry import ModelRegistry
    from predictionio_tpu_torch.workflow import aot, device_state

    blob = Storage.get_model_data_models().get(instance.id)
    if blob is None:
        print("WARNING: --aot: no model blob stored for this instance; nothing to export", file=sys.stderr)
        return
    root = _aot_root()
    pairs: list = []
    try:
        engine = variant.build_engine()
        _, pairs = engine.prepare_deploy(ctx, engine.params_from_json(variant.raw), instance.id, blob.models)
        pairs, _ = device_state.pin_pairs(pairs)
        manifest = aot.export_instance(pairs, instance.id, root)
    except Exception as e:  # noqa: BLE001 - the artifacts are an optimisation; the train stands
        print(f"WARNING: --aot: export failed ({type(e).__name__}: {e}); `pio deploy --aot` will "
              f"fall back to the eager path", file=sys.stderr)
        return
    finally:
        device_state.release_pairs(pairs)
    if manifest is None:
        print("WARNING: --aot: no algorithm exported a serving program (an algorithm without the "
              "aot_export_for_serving hook contributes nothing); `pio deploy --aot` will fall back "
              "to the eager path", file=sys.stderr)
        return
    entries = manifest.get("entries", [])
    total = sum(int(e.get("bytes", 0)) for e in entries)
    record = ModelRegistry(os.path.join(Storage.base_dir(), "fleet")).publish(
        instance.id,
        meta={"publisher": "train --aot"},
        artifacts={
            "dir": aot.artifact_dir(root, instance.id),
            "programs": len(entries),
            "bytes": total,
            "fingerprint": manifest.get("fingerprint", {}),
        },
    )
    print(f"AOT export: {len(entries)} programs ({total} bytes) in {manifest.get('exportSeconds')} s "
          f"for instance {instance.id} (fleet generation {record.generation})")


def _deploy(args: argparse.Namespace) -> int:
    _refuse_waiting_flags(args)
    _setup_compilation_cache(args.compilation_cache_dir)
    if args.replicas > 0 or args.router_only:
        # the fleet: a router process and replica subprocesses (or a bare
        # HA router); a fleet-less deploy never imports the fleet package
        return _deploy_fleet(args)
    from predictionio_tpu_torch import resilience
    from predictionio_tpu_torch.api.http import serve
    from predictionio_tpu_torch.controller.context import local_context
    from predictionio_tpu_torch.serving import AnnConfig, BatcherConfig, CacheConfig
    from predictionio_tpu_torch.workflow.engine_json import load_engine_variant
    from predictionio_tpu_torch.workflow.serving import FeedbackConfig, QueryService

    # before any storage client exists
    resilience.set_rpc_defaults(
        retries=args.retry_reads,
        retry_writes=args.retry_writes,
        breaker_threshold=args.breaker_threshold,
        breaker_reset_s=args.breaker_reset_s,
        deadline_s=args.rpc_deadline_s,
    )
    feedback = None
    if args.feedback:
        feedback = FeedbackConfig(
            event_server_url=f"http://{args.event_server_ip}:{args.event_server_port}",
            access_key=args.accesskey,
            timeout_s=args.feedback_timeout,
            block_ms=0.0 if args.no_feedback_blocking else args.feedback_block_ms,
            breaker_threshold=args.feedback_breaker_threshold,
            breaker_reset_s=args.feedback_breaker_reset_s,
        )
    batching = None
    if args.batching:
        batching = BatcherConfig(
            max_batch_size=args.max_batch_size,
            max_batch_delay_ms=args.max_batch_delay_ms,
            max_queue=args.batch_queue,
            admission=args.admission_policy,
            block_timeout_ms=args.admission_timeout_ms,
            buckets=tuple(int(x) for x in args.batch_buckets.split(",") if x.strip()),
            warmup_body=json.loads(args.batch_warmup_query) if args.batch_warmup_query else None,
        )
    cache = None
    if args.result_cache or args.coalesce or args.pin_model or args.shard_factors or args.quantize:
        cache = CacheConfig(
            result_cache=args.result_cache,
            result_cache_entries=args.result_cache_entries,
            result_cache_ttl_s=args.result_cache_ttl_s,
            result_cache_max_bytes=int(args.result_cache_max_mb * 1024 * 1024),
            coalesce=args.coalesce,
            pin_model=args.pin_model,
            shard_factors=args.shard_factors,
            quantize=args.quantize,
            scope_field=None if args.cache_scope_field.lower() in ("none", "") else args.cache_scope_field,
        )
    ann = None
    if args.ann:
        ann = AnnConfig(
            enabled=True,
            nlist=args.ann_nlist,
            nprobe=args.ann_nprobe,
            seed=args.ann_seed,
            kmeans_iters=args.ann_kmeans_iters,
        )
    aot = None
    if args.aot:
        # without --aot nothing of workflow.aot is imported
        from predictionio_tpu_torch.workflow.aot import AotConfig

        aot = AotConfig(enabled=True, root=_aot_root())
    service = QueryService(
        load_engine_variant(args.engine_json),
        local_context(args.device),
        feedback=feedback,
        instance_id=args.engine_instance_id,
        batching=batching,
        cache=cache,
        ann=ann,
        online=_online_from_args(args),
        explore=_explore_from_args(args),
        replica_id=args.replica_id,
        aot=aot,
    )
    lifecycle = _lifecycle_from_args(args)

    def wire_stop(server) -> None:
        # GET /stop answers first, then the server shuts down on a helper
        # thread (shutdown() from a handler would deadlock). The token is
        # written after a successful bind, keyed by the bound port.
        bound_port = server.server_address[1]
        service.stop_token = commands.write_stop_token(bound_port)
        service.stop_server = lambda: threading.Thread(target=server.shutdown, daemon=True).start()
        if lifecycle is None and threading.current_thread() is threading.main_thread():
            # without a drain deadline SIGTERM/SIGINT stop at once, exit 0
            signal.signal(signal.SIGTERM, lambda s, f: service.stop_server())
            signal.signal(signal.SIGINT, lambda s, f: service.stop_server())
        if args.port == 0:
            print(f"Bound port {bound_port}", flush=True)
        print(f"Engine is deployed and running. Listening on {args.ip}:{bound_port}", flush=True)
        if args.announce_dir:
            _start_announcer(args, service, server)

    try:
        serve(
            service.dispatch, args.ip, args.port,
            ssl_context=_ssl_from_args(args), ready_callback=wire_stop, lifecycle=lifecycle,
        )
    finally:
        service.close()
    print("Engine server stopped.", flush=True)
    return 0


def _explore_from_args(args: argparse.Namespace):
    """The ``ExploreConfig`` of ``--explore*``, as the JAX console builds
    it; None without ``--explore`` (nothing of the experiments package is
    imported then)."""
    if not args.explore:
        return None
    from predictionio_tpu_torch.experiments.explore import ExploreConfig

    return ExploreConfig(
        policy=args.explore,
        epsilon=args.explore_epsilon,
        seed=args.explore_seed,
        reward_event=args.explore_reward_event,
    )


#: deploy flags that stay with the router: never passed to a replica
_ROUTER_FLAGS = frozenset({
    "command",
    "replicas", "replica_id", "probe_interval_s", "failover_retries", "hedge_ms",
    "fleet_breaker_threshold", "fleet_breaker_reset_s", "variants", "endpoint_registry",
    "router_only", "autoscale", "scale_up_qps", "scale_up_p99_ms", "scale_down_qps",
    "scale_cooldown_s", "stale_cache_ttl_s",
    # rebound below, or ended at the router (TLS)
    "ip", "port", "cert", "key", "announce_dir", "announce_host", "lease_ttl_s",
})


def _replica_argv(args: argparse.Namespace, replica_id: str, announce_dir: str) -> list[str]:
    """One replica's ``deploy`` argv from the parsed fleet args: every
    non-default deploy flag is carried over (``--device`` among them, so
    a ``--device cpu`` fleet stays on the CPU), the router's flags, the
    public bind and TLS are not. A replica listens in plain HTTP on the
    loopback, binds port 0 and announces its bound address through the
    endpoint registry (``--announce-dir``), so no port is picked before
    the bind."""
    defaults = build_parser().parse_args(["deploy"])
    argv = ["-m", "predictionio_tpu_torch.tools.console", "deploy"]
    for name, value in sorted(vars(args).items()):
        if name in _ROUTER_FLAGS or value == getattr(defaults, name, None):
            continue
        if value is None or value is False:
            continue
        flag = "--" + name.replace("_", "-")
        if value is True:
            argv.append(flag)
        else:
            argv.extend([flag, str(value)])
    argv.extend([
        "--ip", "127.0.0.1", "--port", "0",
        "--replica-id", replica_id,
        "--announce-dir", announce_dir,
        "--announce-host", args.announce_host,
        "--lease-ttl-s", str(args.lease_ttl_s),
    ])
    return argv


def _deploy_fleet(args: argparse.Namespace) -> int:
    """``pio deploy --replicas N`` (and ``--router-only``): spawn the
    replica subprocesses under the self-healing supervisor and serve the
    fleet router on the public port. Replicas bind port 0 and join the
    ring by announcing their bound address through the endpoint registry
    — the router starts with an empty ring and reconciles membership from
    the registry every probe interval. SIGTERM/SIGINT, ``GET /stop``
    (token-gated) and ``pio undeploy`` stop the whole fleet: replicas
    never outlive their router. The router process imports no torch."""
    import atexit

    from predictionio_tpu_torch.api.http import serve
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.fleet import (
        EndpointRegistry,
        FleetSupervisor,
        ModelRegistry,
        ReplicaSpec,
        RouterConfig,
        RouterService,
        fleet_state_path,
    )

    if args.router_only and args.autoscale:
        raise SystemExit("--router-only serves no supervisor to scale; run --autoscale on the fleet "
                         "that owns the replicas")
    base_dir = Storage.base_dir()
    endpoints_dir = args.endpoint_registry or os.path.join(base_dir, "fleet", "endpoints")
    endpoint_registry = EndpointRegistry(endpoints_dir, lease_ttl_s=args.lease_ttl_s)
    # with an explicit shared registry, many supervisors feed one ring:
    # each replica id carries a host-unique token, so ids minted per host
    # (r0, scale1, ...) never overwrite each other's entries
    if args.endpoint_registry:
        import socket

        host_token = f"{socket.gethostname().split('.')[0]}-{os.getpid()}"

        def _rid(base: str) -> str:
            return f"{base}@{host_token}"
    else:
        def _rid(base: str) -> str:
            return base

    specs: list = []
    if not args.router_only:
        for i in range(args.replicas):
            rid = _rid(f"r{i}")
            specs.append(ReplicaSpec(rid, 0, tuple(_replica_argv(args, rid, endpoints_dir))))
    config = RouterConfig(
        probe_interval_s=args.probe_interval_s,
        failover_retries=args.failover_retries,
        hedge_ms=args.hedge_ms,
        breaker_threshold=args.fleet_breaker_threshold,
        breaker_reset_s=args.fleet_breaker_reset_s,
        scope_field=None if args.cache_scope_field.lower() in ("none", "") else args.cache_scope_field,
        stale_cache_ttl_s=args.stale_cache_ttl_s,
    )
    registry = ModelRegistry(os.path.join(base_dir, "fleet"))
    split = None
    if args.variants:
        # without --variants nothing of the experiments package is imported
        from predictionio_tpu_torch.experiments.split import SplitConfig, TrafficSplit

        split = TrafficSplit(SplitConfig.parse(args.variants))
        print("A/B experiment: " + ", ".join(f"{v.name}:{v.weight:g}" for v in split.config.variants)
              + f" (sticky by {config.scope_field or 'whole-body hash'})", flush=True)
    scale_cfg = None
    if args.autoscale:
        from predictionio_tpu_torch.fleet.autoscaler import Autoscaler, AutoscalerConfig

        lo, _, hi = args.autoscale.partition(":")
        try:
            scale_cfg = AutoscalerConfig(
                min_replicas=int(lo),
                max_replicas=int(hi or lo),
                scale_up_qps=args.scale_up_qps,
                scale_up_p99_ms=args.scale_up_p99_ms,
                scale_down_qps=args.scale_down_qps,
                cooldown_s=args.scale_cooldown_s,
            )
        except ValueError as e:
            raise SystemExit(f"--autoscale: {e}") from None
    router = RouterService([], config, registry=registry, split=split, endpoint_registry=endpoint_registry)
    router.start()
    # the supervisor (and the autoscaler) start once the router is bound:
    # the fleet state file is keyed by the bound port, as the stop token is
    started: dict = {}
    stopped = threading.Event()

    def shutdown_fleet() -> None:
        if stopped.is_set():
            return
        stopped.set()
        if "autoscaler" in started:
            started["autoscaler"].stop()
        router.close()
        if "supervisor" in started:
            started["supervisor"].stop()

    atexit.register(shutdown_fleet)

    def wire_stop(server) -> None:
        bound_port = server.server_address[1]
        router.stop_token = commands.write_stop_token(bound_port)
        if args.port == 0:  # before any replica prints its own
            print(f"Bound port {bound_port}", flush=True)
        if not args.router_only:
            supervisor = started["supervisor"] = FleetSupervisor(
                specs, fleet_state_path(base_dir, bound_port), bound_port
            )
            supervisor.start()
            if scale_cfg is not None:
                started["autoscaler"] = Autoscaler(
                    router,
                    supervisor,
                    lambda rid: ReplicaSpec(_rid(rid), 0, tuple(_replica_argv(args, _rid(rid), endpoints_dir))),
                    scale_cfg,
                )
                started["autoscaler"].start()

        def stop_all() -> None:
            def run() -> None:
                shutdown_fleet()
                server.shutdown()

            threading.Thread(target=run, daemon=True).start()

        router.stop_server = stop_all
        # the first signal stops the fleet (each replica gets SIGTERM,
        # drains per its own --drain-deadline-s, withdraws its registry
        # entry and exits); the router's listener follows
        signal.signal(signal.SIGTERM, lambda s, f: stop_all())
        signal.signal(signal.SIGINT, lambda s, f: stop_all())
        role = "HA router" if args.router_only else "router"
        print(f"Fleet is deployed: {role} on {args.ip}:{bound_port}, {len(specs)} replica(s) self-reporting "
              f"via {endpoints_dir}" + (f", autoscale {args.autoscale}" if scale_cfg is not None else ""),
              flush=True)

    serve(router.dispatch, args.ip, args.port, ssl_context=_ssl_from_args(args), ready_callback=wire_stop)
    shutdown_fleet()
    return 0


def _start_announcer(args: argparse.Namespace, service, server) -> None:
    """A replica's self-report: publish the address this server actually
    bound (``--port 0``: the port is read off the live socket) into the
    endpoint registry, heartbeat the lease, and withdraw on drain or exit
    so a clean retirement leaves no entry to expire."""
    import atexit

    from predictionio_tpu_torch.fleet.registry import EndpointRegistry

    host, port = args.announce_host, server.server_address[1]
    rid = args.replica_id or f"pid{os.getpid()}"
    registry = EndpointRegistry(args.announce_dir, lease_ttl_s=args.lease_ttl_s)
    stop = threading.Event()

    def generation() -> int:
        try:
            return int(getattr(service, "model_generation", 0) or 0)
        except (TypeError, ValueError):
            return 0

    registry.announce(rid, host, port, generation=generation())
    print(f"Announced replica {rid} at {host}:{port} in {args.announce_dir} (lease {args.lease_ttl_s:g}s)",
          flush=True)

    def heartbeat() -> None:
        interval = max(0.05, args.lease_ttl_s / 3.0)
        while not stop.wait(interval):
            try:
                registry.heartbeat(rid, host, port, generation=generation())
            except OSError:
                pass  # a shared-filesystem hiccup: the next beat renews the lease

    threading.Thread(target=heartbeat, name="endpoint-heartbeat", daemon=True).start()

    def withdraw() -> None:
        stop.set()
        try:
            registry.withdraw(rid)
        except OSError:
            pass

    # a drain withdraws first (routers reconcile this replica out before
    # the listener closes); atexit covers exits without a drain
    service.on_close.append(withdraw)
    atexit.register(withdraw)


def _promote_winner(router_url: str, result) -> dict:
    """``pio eval --grid --promote-to URL``: map the sweep's winning
    candidate index onto the router's variant order (``GET
    /experiments.json`` lists them in ``--variants`` order, one variant a
    candidate) and POST the promotion, which rolls the fleet. Any mismatch
    is a ``SystemExit``: a mis-mapped promotion would roll the wrong
    model fleet-wide."""
    import urllib.error
    import urllib.request

    url = router_url.rstrip("/")
    try:
        with urllib.request.urlopen(url + "/experiments.json", timeout=10) as r:
            experiments = json.load(r)
    except (urllib.error.URLError, json.JSONDecodeError, OSError) as e:
        raise SystemExit(f"--promote-to: cannot read {url}/experiments.json: {e}") from None
    variants = [v.get("name") for v in experiments.get("variants", [])]
    candidates = len(result.engine_params_scores)
    if len(variants) != candidates:
        raise SystemExit(
            f"--promote-to: the router serves {len(variants)} variant(s) {variants} but the sweep scored "
            f"{candidates} candidate(s) — refusing to guess the mapping; deploy --variants with one "
            "variant per sweep candidate, in the same order"
        )
    winner = variants[result.best_index]
    req = urllib.request.Request(
        url + "/experiments/promote.json",
        data=json.dumps({"variant": winner}).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        # the promotion rolls every replica through /reload: budget it
        # like a rolling reload, not like a GET
        with urllib.request.urlopen(req, timeout=600) as r:
            payload = json.load(r)
            status = r.status
    except urllib.error.HTTPError as e:
        raise SystemExit(f"--promote-to: promotion of {winner!r} failed ({e.code}): {e.read()[:300]!r}") from None
    except (urllib.error.URLError, json.JSONDecodeError, OSError) as e:
        raise SystemExit(f"--promote-to: promotion of {winner!r} failed: {e}") from None
    return {"promotedVariant": winner, "bestIndex": result.best_index, "status": status, "router": payload}


def _online_from_args(args: argparse.Namespace):
    """The ``OnlineConfig`` of ``--online*``, as the JAX console builds
    it; None without ``--online`` (nothing of the online package is
    imported then)."""
    if not args.online:
        return None
    from predictionio_tpu_torch.online import OnlineConfig

    return OnlineConfig(
        enabled=True,
        interval_s=args.online_interval_s,
        batch_size=args.online_batch,
        algorithms=tuple(t.strip() for t in args.online_algos.split(",") if t.strip()),
        prior_weight=args.online_prior_weight,
        from_start=args.online_from_start,
    )


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


def _storageserver(args: argparse.Namespace) -> None:
    from predictionio_tpu_torch.api.http import serve
    from predictionio_tpu_torch.data.storage.remote import StorageRpcService

    secret = args.secret or os.environ.get("PIO_STORAGE_SERVER_SECRET")
    loopback = args.ip.startswith("127.") or args.ip in ("localhost", "::1")
    if not loopback and not secret:
        raise SystemExit(
            "storageserver grants unauthenticated read/write of apps, "
            "access keys, events and model blobs; refusing to bind "
            f"non-loopback address {args.ip!r} without --secret / "
            "$PIO_STORAGE_SERVER_SECRET"
        )

    def ready(server) -> None:
        if args.port == 0:
            print(f"Bound port {server.server_address[1]}", flush=True)

    print(f"Storage server is listening on {args.ip}:{args.port}", flush=True)
    serve(
        StorageRpcService(secret=secret).dispatch, args.ip, args.port,
        ssl_context=_ssl_from_args(args),
        ready_callback=ready,
        lifecycle=_lifecycle_from_args(args),
    )


def _serve_admin(args: argparse.Namespace, name: str, service) -> None:
    """``dashboard`` and ``adminserver``: ``service`` over HTTP on
    ``--ip``/``--port`` (``--port 0`` prints ``Bound port N``)."""
    from predictionio_tpu_torch.api.http import serve

    def ready(server) -> None:
        if args.port == 0:
            print(f"Bound port {server.server_address[1]}", flush=True)

    print(f"{name} is listening on {args.ip}:{args.port}", flush=True)
    serve(
        service.dispatch, args.ip, args.port,
        ssl_context=_ssl_from_args(args),
        ready_callback=ready,
        lifecycle=_lifecycle_from_args(args),
    )


def _run(args: argparse.Namespace) -> int:
    """``pio run CMD ...``: CMD with ``PIO_FS_BASEDIR`` resolved and the
    repository root on ``PYTHONPATH``."""
    import subprocess

    from predictionio_tpu_torch.data.storage import Storage

    cmdline = list(args.run_args)
    if cmdline and cmdline[0] == "--":
        cmdline = cmdline[1:]
    if not cmdline:
        print("ERROR: pio run needs a command to execute", file=sys.stderr)
        return 1
    env = dict(os.environ)
    env.setdefault("PIO_FS_BASEDIR", Storage.base_dir())
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = (repo_root + os.pathsep + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
    return subprocess.run(cmdline, env=env).returncode


def _lint(args: argparse.Namespace) -> int:
    """``pio lint``. Exit code contract (the JAX console's): 0 clean, 1
    findings (or a failed witness crosscheck), 2 internal error."""
    try:
        from predictionio_tpu_torch.analysis import jit_witness, lock_witness, run_lint

        res = run_lint(
            root=args.root,
            baseline_path=args.baseline,
            update_baseline=args.update_baseline,
            prune_stale=args.prune_baseline,
        )
        pruned_ledger = 0
        if args.prune_baseline:
            pruned_ledger = jit_witness.prune_ledger(jit_witness.default_ledger_path(res.root), res.root)
        xcheck = None
        if args.witness:
            with open(args.witness, encoding="utf-8") as fh:
                doc = json.load(fh)
            # a pio tsan payload ({"witness": {...}}) or a raw witness report
            wrep = doc.get("witness", doc) if isinstance(doc, dict) else {}
            xcheck = lock_witness.crosscheck(wrep, root=res.root)
        ok = res.ok and (xcheck is None or xcheck["ok"])
        if args.format == "json":
            payload = res.to_json()
            payload["prunedCompileBudgetEntries"] = pruned_ledger
            if xcheck is not None:
                payload["witnessCrosscheck"] = xcheck
                payload["ok"] = ok
            print(json.dumps(payload, indent=2))
        elif args.format == "sarif":
            print(json.dumps(res.to_sarif(), indent=2))
        else:
            for f in res.new_findings:
                print(f.render())
            summary = (
                f"piolint: {res.files_scanned} files, {len(res.new_findings)} new finding(s), "
                f"{len(res.baselined)} baselined, {res.suppressed_count} suppressed"
            )
            if res.pruned_baseline:
                summary += f", {res.pruned_baseline} stale baseline entr{'y' if res.pruned_baseline == 1 else 'ies'} pruned"
            if pruned_ledger:
                summary += f", {pruned_ledger} stale compile-budget entr{'y' if pruned_ledger == 1 else 'ies'} pruned"
            if res.stale_baseline:
                summary += (
                    f", {res.stale_baseline} stale baseline entr{'y' if res.stale_baseline == 1 else 'ies'} "
                    "(fixed findings — prune with --prune-baseline)"
                )
            print(summary)
            if xcheck is not None:
                print(
                    f"lock-witness crosscheck: {xcheck['dynamicEdges']} dynamic edge(s) vs "
                    f"{xcheck['staticEdges']} static, {len(xcheck['gaps'])} analyzer gap(s), "
                    f"{len(xcheck['unwaivedStaticCycles'])} unwaived static cycle(s), "
                    f"{len(xcheck['staleWaivers'])} stale waiver(s)"
                )
                for g in xcheck["gaps"]:
                    print(f"  GAP: witnessed {g['from']} -> {g['to']} (x{g['count']}) has no static "
                          f"edge {g['staticFrom']} -> {g['staticTo']}")
                for c in xcheck["unwaivedStaticCycles"]:
                    print("  UNWAIVED CYCLE: " + " -> ".join(c["cycle"])
                          + f" ({c['witnessedEdges']}/{c['totalEdges']} edges witnessed; add a "
                          "lock-witness-waivers.json entry or exercise it)")
        return 0 if ok else 1
    except Exception as e:  # noqa: BLE001 — exit-code contract
        print(f"piolint: internal error: {e}", file=sys.stderr)
        return 2


def _nested(argv: list, verb: str) -> list | None:
    """The command a witness verb runs: its arguments after ``--`` (and a
    leading ``pio``), or None (with a message) when there is none."""
    cmdline = list(argv)
    if cmdline and cmdline[0] == "--":
        cmdline = cmdline[1:]
    if cmdline and cmdline[0] == "pio":
        cmdline = cmdline[1:]
    if not cmdline:
        print(f"ERROR: pio {verb} needs a command to execute, e.g. `pio {verb} -- train ...`", file=sys.stderr)
        return None
    return cmdline


def _run_nested(cmdline: list, timing: dict) -> int:
    """``main(cmdline)`` in this process, its seconds into
    ``timing["commandSeconds"]``; a nested command that leaves by
    ``SystemExit`` (argparse errors, server refusals) is folded into its
    exit code, so the witness report survives."""
    t0 = time.perf_counter()
    try:
        return main(cmdline)
    except SystemExit as e:
        if e.code is None:
            return 0
        return e.code if isinstance(e.code, int) else 1
    finally:
        timing["commandSeconds"] = time.perf_counter() - t0


def _tsan(args: argparse.Namespace) -> int:
    """``pio tsan -- CMD``: CMD in this process under the lock and fsync
    witness; a witnessed inversion or a failed CMD exits 1."""
    from predictionio_tpu_torch.analysis import lock_witness, witness

    cmdline = _nested(args.tsan_args, "tsan")
    if cmdline is None:
        return 1
    timing: dict = {}
    child_rc, payload = lock_witness.run_with_lock_witness(
        lambda: _run_nested(cmdline, timing), long_hold_ms=args.long_hold_ms, waivers=lock_witness.load_waivers()
    )
    payload.update(command=cmdline, exitCode=child_rc, **timing)
    if args.report:
        witness.write_report(args.report, payload)
    print(json.dumps(payload, indent=2, sort_keys=True))
    return 0 if (payload["ok"] and not child_rc) else 1


def _jitwitness(args: argparse.Namespace) -> int:
    """``pio jitwitness -- CMD``: CMD in this process under the jit
    witness; a compile-budget violation or a failed CMD exits 1
    (unbudgeted compiles are reported, not fatal)."""
    import torch  # noqa: F401 — the witness wraps the torch this process loaded

    from predictionio_tpu_torch.analysis import jit_witness

    cmdline = _nested(args.jitwitness_args, "jitwitness")
    if cmdline is None:
        return 1
    timing: dict = {}
    child_rc, rep = jit_witness.run_with_jit_witness(lambda: _run_nested(cmdline, timing))
    payload = jit_witness.jitwitness_report(rep, ledger_path=args.ledger)
    payload.update(command=cmdline, exitCode=child_rc, **timing)
    if args.report:
        jit_witness.write_report(args.report, payload)
    print(json.dumps(payload, indent=2, sort_keys=True))
    return 0 if (payload["ok"] and not child_rc) else 1


def _chaos(args: argparse.Namespace) -> int:
    """The three drills (``resilience/chaos.py``): print the report,
    exit 1 unless it is ``ok``."""
    from predictionio_tpu_torch.resilience import chaos

    if args.command == "chaos-ingest":
        report = chaos.run_chaos_ingest(chaos.ChaosConfig(
            cycles=args.cycles, writers=args.writers, events_per_writer=args.events, backend=args.backend,
            seed=args.seed, bulk_events=args.bulk_events, drain_deadline_s=args.drain_deadline_s,
            partitions=args.partitions, replication=args.replication, ack_quorum=args.ack_quorum,
            keep_dir=args.keep,
        ))
    elif args.command == "chaos-serve":
        report = chaos.run_chaos_serve(chaos.ServeChaosConfig(
            replicas=args.replicas, clients=args.clients, kills=args.kills, phase_seconds=args.seconds,
            reloads=args.reloads, train_events=args.events, seed=args.seed, sharded_point=args.sharded_point,
            aot=args.aot, device=args.device, keep_dir=args.keep,
        ))
    else:
        report = chaos.run_chaos_fleet(chaos.FleetChaosConfig(
            replicas_per_host=args.replicas_per_host, clients=args.clients, phase_seconds=args.seconds,
            train_events=args.events, lease_ttl_s=args.lease_ttl_s, seed=args.seed,
            autoscale_phase=not args.skip_autoscale, device=args.device, keep_dir=args.keep,
        ))
    print(json.dumps(report, indent=2), flush=True)
    return 0 if report["ok"] else 1


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
    run = run_evaluation
    if args.grid:
        # without --grid nothing of the experiments package is imported
        from predictionio_tpu_torch.experiments.sweep import run_grid_evaluation as run
    _, result = run(
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
    if args.promote_to:
        print(json.dumps(_promote_winner(args.promote_to, result), indent=2, default=str))


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
        elif cmd == "storageserver":
            _storageserver(args)
        elif cmd == "train":
            _train(args)
        elif cmd == "deploy":
            return _deploy(args)
        elif cmd == "undeploy":
            commands.undeploy(args.ip, args.port, args.https, args.insecure, token=args.token)
        elif cmd == "batchpredict":
            from predictionio_tpu_torch.tools.batchpredict import run_batch_predict

            n = run_batch_predict(
                args.engine_json, args.input, args.output, args.engine_instance_id, args.device
            )
            print(f"Wrote {n} predictions to {args.output}")
        elif cmd == "eval":
            _eval(args)
        elif cmd == "template":
            if args.template_command == "list":
                commands.template_list()
            elif args.template_command == "get":
                commands.template_get(args.name, args.directory, args.appname)
        elif cmd == "dashboard":
            from predictionio_tpu_torch.tools.dashboard import DashboardService

            _serve_admin(args, "Dashboard", DashboardService())
        elif cmd == "adminserver":
            from predictionio_tpu_torch.tools.adminserver import AdminService

            _serve_admin(args, "Admin server", AdminService())
        elif cmd in ("chaos-ingest", "chaos-serve", "chaos-fleet"):
            return _chaos(args)
        elif cmd == "build":
            print("Nothing to build: Python engines are imported directly. "
                  "(kept for command-line parity with the reference)")
        elif cmd == "run":
            return _run(args)
        elif cmd == "lint":
            return _lint(args)
        elif cmd == "tsan":
            return _tsan(args)
        elif cmd == "jitwitness":
            return _jitwitness(args)
        elif cmd == "upgrade":
            print("predictionio_tpu_torch is a Python package: upgrade with your package manager "
                  "(e.g. `pip install -U predictionio_tpu_torch`). Storage formats are forward-compatible "
                  "within a major version; no in-place upgrader is needed.")
        return 0
    except Exception as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
