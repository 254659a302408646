"""Multi-process initialization over ``torch.distributed``.

Counterpart of ``predictionio_tpu/parallel/distributed.py`` (parity: the
reference's Spark driver/executor topology). A multi-host job runs the
SAME ``pio train`` on every host with three variables set; process 0
plays the coordinator (the Spark-driver role):

    PIO_COORDINATOR_ADDRESS=10.0.0.1:8476
    PIO_NUM_PROCESSES=4
    PIO_PROCESS_ID=<0..3>

One process is one host: it owns its local devices as mesh positions
(``controller.context.mesh_context``), and the event reader gives it its
input shard (``shard_index=process_index(), num_shards=process_count()``).

:func:`initialize_from_env` makes the ``tcp://`` rendezvous store on the
coordinator's address, publishes there where this process runs (its host
name and the card it drives), and then starts the process group on that
store, with the backend chosen by rule from what every process published:

* ``nccl`` when every process drives a card of its own;
* ``gloo`` otherwise (a process on the CPU, or several processes sharing
  one card). Gloo's collectives here take host tensors, so
  :func:`all_reduce_` and :func:`all_gather_tensor` stage card tensors
  through the host.

The rule decides once, and there is no knob to override it; nothing
switches backends after a failure. :func:`choose_backend` with
``require_nccl`` raises where a card is shared or a process is on the CPU
(NCCL refuses two ranks on one device), and a set triplet whose
initialization fails raises: nothing carries on as a single process.
"""

from __future__ import annotations

import atexit
import datetime as _dt
import json
import logging
import os
import socket

import torch
import torch.distributed as dist

__all__ = [
    "BACKENDS",
    "initialize_from_env",
    "is_multihost",
    "process_count",
    "process_index",
    "backend",
    "local_device",
    "choose_backend",
    "all_reduce_",
    "all_gather_tensor",
    "barrier",
    "shutdown",
]

logger = logging.getLogger(__name__)

#: the backends the rule chooses from
BACKENDS = ("nccl", "gloo")

#: seconds the rendezvous and every collective wait for a peer
DEFAULT_TIMEOUT_S = 300.0

#: what :func:`initialize_from_env` set up: the backend and this
#: process's device (both None until then)
_STATE: dict = {"backend": None, "device": None}


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """The processes of the job (1 without a process group)."""
    return dist.get_world_size() if _initialized() else 1


def is_multihost() -> bool:
    return process_count() > 1


def backend() -> str | None:
    """The backend the process group runs, or None without one."""
    return _STATE["backend"] if _initialized() else None


def local_device() -> torch.device | None:
    """The device :func:`initialize_from_env` gave this process (its own
    card, a shared one, or the CPU), or None before it ran."""
    return _STATE["device"] if _initialized() else None


def _device_of(info: dict, local_rank: int) -> str:
    """The device a published process drives: the CPU, the card it named,
    or the card of its local rank (round robin when the host has fewer
    cards than processes)."""
    if info["type"] == "cpu":
        return "cpu"
    if info["index"] is not None:
        return f"cuda:{info['index']}"
    return f"cuda:{local_rank % max(1, info['count'])}"


def choose_backend(published: list, require_nccl: bool = False) -> tuple[str, list]:
    """The rule, from every process's published ``{"host", "type",
    "index", "count"}`` in rank order: ``(backend, devices)``, where
    ``devices[r]`` is the device rank ``r`` drives. NCCL when every rank
    drives a card no other rank on its host drives; gloo otherwise. With
    ``require_nccl``, a layout the rule gives gloo raises."""
    devices = []
    seen_on_host: dict = {}
    for info in published:
        local_rank = seen_on_host.get(info["host"], 0)
        seen_on_host[info["host"]] = local_rank + 1
        devices.append(_device_of(info, local_rank))
    cards = [(info["host"], d) for info, d in zip(published, devices) if d != "cpu"]
    own_cards = len(cards) == len(devices) and len(set(cards)) == len(cards)
    rule = "nccl" if own_cards else "gloo"
    if require_nccl and rule != "nccl":
        shared = sorted({c for c in cards if cards.count(c) > 1})
        why = (
            f"ranks share {', '.join(f'{d} on {h}' for h, d in shared)}"
            if shared else "a rank runs on the CPU"
        )
        raise ValueError(
            f"NCCL needs a card of its own for every process, but {why}; "
            "gloo is the backend for shared cards and the CPU"
        )
    return rule, devices


def _parse_triplet() -> tuple[str, int, int, int]:
    coordinator = os.environ["PIO_COORDINATOR_ADDRESS"]
    try:
        num = int(os.environ.get("PIO_NUM_PROCESSES", "1"))
        me = int(os.environ.get("PIO_PROCESS_ID", "0"))
        host, _, port = coordinator.rpartition(":")
        port_n = int(port)
    except ValueError as exc:
        raise ValueError(
            f"PIO_COORDINATOR_ADDRESS={coordinator!r}, PIO_NUM_PROCESSES and "
            f"PIO_PROCESS_ID must be host:port and integers ({exc})"
        ) from exc
    if not host:
        raise ValueError(f"PIO_COORDINATOR_ADDRESS={coordinator!r} has no host")
    if num < 1 or not 0 <= me < num:
        raise ValueError(f"PIO_PROCESS_ID={me} is not a rank of PIO_NUM_PROCESSES={num}")
    return host, port_n, num, me


def initialize_from_env(device: str | torch.device | None = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the process group if the ``PIO_COORDINATOR_*`` triplet is
    set. Idempotent; returns True when running multi-process, False when
    the triplet is absent (nothing is started then).

    ``device`` is what this process drives: ``"cpu"``, a card
    (``"cuda:1"``), or ``None``/``"cuda"`` for the card of its local rank.
    The rule (module docstring) picks the backend. Any failure of a set
    triplet raises."""
    if not os.environ.get("PIO_COORDINATOR_ADDRESS"):
        return False
    if _initialized():
        return True
    host, port, num, me = _parse_triplet()
    timeout = _dt.timedelta(seconds=float(timeout_s))
    want = torch.device("cuda" if device is None else device)
    if want.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "PIO_COORDINATOR_* is set and this process would drive a card, but "
            "torch.cuda.is_available() is false; pass device='cpu' to run on the CPU"
        )
    try:
        # the store a tcp:// init makes, made first so that the rule can
        # read what every process publishes before the group starts
        store = dist.TCPStore(host, port, num, me == 0, timeout=timeout)
        store.set(f"pio/process/{me}", json.dumps({
            "host": socket.gethostname(), "type": want.type,
            "index": want.index if want.type == "cuda" else None,
            "count": torch.cuda.device_count() if want.type == "cuda" else 0,
        }))
        keys = [f"pio/process/{r}" for r in range(num)]
        store.wait(keys)
        published = [json.loads(store.get(k)) for k in keys]
    except Exception as exc:
        raise RuntimeError(
            f"PIO_COORDINATOR_ADDRESS={host}:{port}: the rendezvous of process "
            f"{me}/{num} failed ({type(exc).__name__}: {exc})"
        ) from exc
    chosen, devices = choose_backend(published)
    dev = torch.device(devices[me])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    logger.info(
        "Initializing torch.distributed: coordinator=%s:%d process=%d/%d backend=%s device=%s",
        host, port, me, num, chosen, dev,
    )
    try:
        kw = {"device_id": dev} if chosen == "nccl" else {}
        dist.init_process_group(chosen, store=store, rank=me, world_size=num, timeout=timeout, **kw)
    except Exception as exc:
        raise RuntimeError(
            f"torch.distributed {chosen} group of process {me}/{num} failed to start "
            f"({type(exc).__name__}: {exc})"
        ) from exc
    _STATE["backend"] = chosen
    _STATE["device"] = dev
    # a group still alive when the interpreter ends aborts the process
    # ("terminate called without an active exception") after its work
    atexit.register(shutdown)
    return True


def shutdown() -> None:
    """Stop the process group (a no-op without one)."""
    if _initialized():
        dist.destroy_process_group()
    _STATE["backend"] = None
    _STATE["device"] = None


def _staged(t: torch.Tensor) -> bool:
    """Whether a collective on ``t`` goes through a host copy: gloo takes
    host tensors here."""
    return backend() == "gloo" and t.device.type != "cpu"


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the processes, in place (a no-op in one process)."""
    if process_count() == 1:
        return t
    if _staged(t):
        host = t.detach().cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def all_gather_tensor(t: torch.Tensor) -> list:
    """Every process's ``t`` (one shape everywhere), in process order, on
    ``t``'s device."""
    if process_count() == 1:
        return [t]
    src = t.detach().contiguous()
    if _staged(src):
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(out, src)
    return [o.to(t.device) for o in out]


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()
