"""Streaming mini-batch trainer — the two-tower half of online learning.

Counterpart of ``predictionio_tpu/online/trainer.py``. Matrix
factorization rows admit a closed-form fold-in
(:mod:`~predictionio_tpu_torch.online.foldin`); embedding towers do not,
so their online path is the streaming analog of training: small SGD
steps on the fresh (user, item) pairs with in-batch sampled softmax —
the objective ``ops.twotower`` trains with — touching ONLY the rows the
batch names. A :class:`StreamingTrainer` runs on its own daemon thread,
consuming the runner's pair batches from a bounded queue (a burst drops
the oldest batches rather than stalling the follower), and pushes each
step's rows through the same ``apply_online_update`` hot swap as the
fold-in side.

:func:`sgd_step` gathers the touched rows where the tables live, takes
the gradient of the masked symmetric in-batch CE with
``torch.autograd.grad`` on ``device`` (plain autograd, as the JAX
package's ``jax.value_and_grad``; its fused-CE kernel is not on this
path in either package), and reads the rows and gradients back; the
per-id gradient accumulation, the SGD update and the re-normalisation
run on the host, as in the JAX package. ``run(fn, *args)`` runs the
step's torch calls (the runner passes the query server's
``run_on_device``). Cold-start rows are drawn from a numpy generator
seeded with the spec's ``seed``, the JAX package's draw.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Callable

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.online.types import OnlineUpdate

__all__ = ["StreamingTrainer", "sgd_step", "inbatch_ce_grad"]

logger = logging.getLogger(__name__)

#: padded mini-batch bucket floor
_MIN_BUCKET = 8


def _bucket(n: int) -> int:
    return max(_MIN_BUCKET, 1 << (max(1, n) - 1).bit_length())


def _direct(fn: Callable, *args: Any) -> Any:
    return fn(*args)


def inbatch_ce_grad(
    ue: torch.Tensor, ie: torch.Tensor, mask: torch.Tensor, inv_temp: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked symmetric in-batch softmax-CE over gathered rows ``[B, D]``;
    returns ``(loss, grad_ue, grad_ie)``. Padding rows (mask 0) contribute
    no loss and leave every negative set. The JAX package's
    ``_grad_kernel``."""
    ue = ue.detach().requires_grad_(True)
    ie = ie.detach().requires_grad_(True)
    with torch.enable_grad():
        un = ue / (torch.linalg.norm(ue, dim=-1, keepdim=True) + 1e-8)
        inn = ie / (torch.linalg.norm(ie, dim=-1, keepdim=True) + 1e-8)
        real = mask > 0
        n_real = torch.clamp(mask.sum(), min=1.0)
        B = ue.shape[0]
        # padding columns leave every negative set; the diagonal stays
        # allowed so a padding ROW's own label is finite (its loss is
        # then dropped — a -inf diagonal would make it +inf and poison
        # the mean with inf*0)
        allow = real[None, :] | torch.eye(B, dtype=torch.bool, device=ue.device)

        def ce(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
            logits = (a @ b.T) * inv_temp
            logits = logits.masked_fill(~allow, float("-inf"))
            return -torch.log_softmax(logits, dim=1).diagonal()

        per = torch.where(real, 0.5 * (ce(un, inn) + ce(inn, un)), torch.zeros_like(mask))
        loss = per.sum() / n_real
        gu, gi = torch.autograd.grad(loss, (ue, ie))
    return loss.detach(), gu, gi


def _gather(table, idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """Rows ``idx`` of a numpy, tensor, int8 or sharded table, gathered
    where the table lives (an int8 table dequantizes only those rows, a
    sharded one takes each from its owner shard) and placed on ``device``
    as float32."""
    if isinstance(table, np.ndarray):
        return torch.from_numpy(np.asarray(table[idx], np.float32)).to(device)
    if isinstance(table, torch.Tensor):
        rows = table.index_select(0, torch.from_numpy(idx).to(table.device))
    else:
        rows = table[idx]
    return rows.to(device=device, dtype=torch.float32)


def _step_on_device(user_vecs, item_vecs, up, ip, mask, inv_temp, device):
    ue = _gather(user_vecs, up, device)
    ie = _gather(item_vecs, ip, device)
    loss, gu, gi = inbatch_ce_grad(ue, ie, torch.from_numpy(mask).to(device), inv_temp)
    return (ue.cpu().numpy(), ie.cpu().numpy(), gu.cpu().numpy(), gi.cpu().numpy(), float(loss))


def sgd_step(
    user_vecs,
    item_vecs,
    u_idx: np.ndarray,
    i_idx: np.ndarray,
    lr: float,
    temperature: float,
    *,
    device: str | torch.device | None = None,
    run: Callable | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """One streaming step over pairs ``(u_idx[j], i_idx[j])``.

    Gathers the touched rows, takes the masked-CE gradient on ``device``
    (by default a tensor table's own device, and the card for numpy
    tables), accumulates per-id gradients on the host (one id may appear
    in several pairs), applies SGD and re-normalizes. Returns ``(unique
    user rows idx, updated rows, unique item rows idx, updated rows,
    loss)``."""
    if device is None and not isinstance(user_vecs, np.ndarray):
        device = user_vecs.device
    device = resolve_device(device)
    run = run or _direct
    B = len(u_idx)
    Bp = _bucket(B)
    up = np.zeros(Bp, np.int64)
    ip = np.zeros(Bp, np.int64)
    up[:B] = u_idx
    ip[:B] = i_idx
    mask = np.zeros(Bp, np.float32)
    mask[:B] = 1.0
    ue, ie, gu, gi, loss = run(
        _step_on_device, user_vecs, item_vecs, up, ip, mask, 1.0 / max(temperature, 1e-6), device
    )
    gu = gu[:B]
    gi = gi[:B]

    def fold(idx: np.ndarray, rows: np.ndarray, grad: np.ndarray):
        uniq, inv = np.unique(idx, return_inverse=True)
        acc = np.zeros((uniq.size, rows.shape[1]), np.float32)
        np.add.at(acc, inv, grad)
        first = np.zeros(uniq.size, np.int64)
        first[inv[::-1]] = np.arange(idx.size - 1, -1, -1)
        new = rows[first] - lr * acc
        new /= np.linalg.norm(new, axis=1, keepdims=True) + 1e-8
        return uniq, new

    uu, new_u = fold(up[:B], ue[:B], gu)
    ui, new_i = fold(ip[:B], ie[:B], gi)
    return uu, new_u, ui, new_i, loss


class StreamingTrainer:
    """Background daemon consuming delta pair batches for ONE deployed
    two-tower pair. The runner enqueues ``(pairs, newest_us)`` work
    items; the thread turns each into one or more SGD steps and hands the
    updated rows to ``apply`` (the runner's hot-swap bridge into
    ``QueryService.apply_online_update``)."""

    def __init__(
        self,
        model,
        apply,
        batch_size: int = 256,
        lr: float = 0.05,
        temperature: float = 0.1,
        seed: int = 0,
        queue_size: int = 64,
        *,
        device: str | torch.device | None = None,
        run: Callable | None = None,
    ):
        self._model = model
        self._apply = apply
        self._batch = max(1, int(batch_size))
        self._lr = float(lr)
        self._temp = float(temperature)
        self._device = device
        self._run = run
        self._rng = np.random.default_rng(seed)
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._lock = threading.Lock()
        self.steps = 0
        self.pairs_trained = 0
        self.dropped_batches = 0
        self.last_loss: float | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run_loop, daemon=True, name="pio-online-trainer")
        self._thread.start()

    # --------------------------------------------------------------- intake
    def submit(self, pairs: list[tuple[str, str]], newest_us: int = 0) -> None:
        """Enqueue fresh (user id, item id) pairs; drops the OLDEST
        queued batch on overflow so a burst degrades to sampling recent
        data instead of stalling the follower thread. ``newest_us`` (the
        batch's newest event time) rides along so the runner can measure
        event->serving-visible freshness when the async apply lands."""
        if not pairs:
            return
        while True:
            try:
                self._queue.put_nowait((pairs, newest_us))
                return
            except queue.Full:
                try:
                    self._queue.get_nowait()
                    with self._lock:
                        self.dropped_batches += 1
                except queue.Empty:
                    continue

    def stop(self) -> None:
        self._stop.set()
        self._queue.put(None)  # wake the consumer
        self._thread.join(timeout=5.0)

    # ----------------------------------------------------------------- loop
    def _cold_rows(self, n: int, dim: int) -> np.ndarray:
        rows = self._rng.standard_normal((n, dim)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True) + 1e-8
        return rows

    def _run_loop(self) -> None:
        while not self._stop.is_set():
            item = self._queue.get()
            if item is None or self._stop.is_set():
                break
            try:
                self._train_one(*item)
            except Exception:
                logger.exception("streaming trainer step failed; continuing")

    def _train_one(self, pairs: list[tuple[str, str]], newest_us: int = 0) -> None:
        model = self._model
        dim = int(model.item_vecs.shape[1]) if len(model.item_index) else 0
        # cold-start injection first: unseen entities get a normalized
        # random row so the SGD step (and serving) can address them
        new_users = sorted({u for u, _ in pairs if model.user_index.get(u) is None})
        new_items = sorted({i for _, i in pairs if model.item_index.get(i) is None})
        if new_users or new_items:
            res = self._apply(
                OnlineUpdate(
                    user_ids=new_users,
                    user_rows=self._cold_rows(len(new_users), dim),
                    item_ids=new_items,
                    item_rows=self._cold_rows(len(new_items), dim),
                    seen_pairs=(),
                    info={"coldStart": True, "newestUs": newest_us},
                )
            ) or {}
            if not res.get("applied"):
                # a concurrent /reload superseded the generation this
                # trainer was bound to: the cold rows were NOT injected,
                # and the runner's rebind is about to replace this
                # trainer — abandon the work item
                return
        for lo in range(0, len(pairs), self._batch):
            chunk = pairs[lo : lo + self._batch]
            u_idx = np.asarray([model.user_index[u] for u, _ in chunk], np.int64)
            i_idx = np.asarray([model.item_index[i] for _, i in chunk], np.int64)
            uu, new_u, ui, new_i, loss = sgd_step(
                model.user_vecs, model.item_vecs, u_idx, i_idx, self._lr, self._temp,
                device=self._device, run=self._run,
            )
            inv_u = model.user_index.inverse
            inv_i = model.item_index.inverse
            res = self._apply(
                OnlineUpdate(
                    user_ids=[inv_u(int(r)) for r in uu],
                    user_rows=new_u,
                    item_ids=[inv_i(int(r)) for r in ui],
                    item_rows=new_i,
                    seen_pairs=chunk,
                    info={"loss": round(loss, 5), "newestUs": newest_us},
                )
            ) or {}
            with self._lock:
                self.steps += 1
                self.pairs_trained += len(chunk)
                self.last_loss = loss
            if not res.get("applied") and res.get("reason"):
                # superseded mid-item: later chunks would be dropped too
                return

    def stats_json(self) -> dict:
        with self._lock:
            return {
                "steps": self.steps,
                "pairsTrained": self.pairs_trained,
                "droppedBatches": self.dropped_batches,
                "lastLoss": self.last_loss,
                "queued": self._queue.qsize(),
            }
