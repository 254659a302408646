"""Shared types of the online-learning subsystem (no torch, no jax).

A copy of ``predictionio_tpu/online/types.py``: the same config, delta
and update types, and the same latest-wins rule. Engine templates
implement the online hooks against these types without importing the
heavy halves of the package (``foldin``/``trainer`` import torch); this
module is numpy and the standard library, and with ``--online`` off
nothing under ``predictionio_tpu_torch.online`` is imported at all.

The hook protocol (duck-typed: ``online/`` never imports templates):

* ``algo.online_foldin(model, deltas, ds_params, config, run=None) ->
  OnlineUpdate | None`` — new factor rows for the entities an event
  batch touched, against the FIXED opposite-side factors (the classic
  MLlib-era fold-in). Read-only. ``run(fn, *args)`` runs the fold's
  torch calls (the runner passes the query server's
  ``run_on_device``); the host work stays on the caller's thread.
* ``algo.apply_online_update(model, update) -> dict`` — swap the touched
  rows into the live model (and inject cold-start rows). The query
  server runs it on its device thread after the generation check; it
  must be fast (row scatters, no solves).
* ``algo.online_trainer_spec(model) -> dict | None`` — opt into the
  streaming mini-batch trainer (two-tower) instead of fold-in; returns
  the hyperparameters ``online.trainer`` needs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

__all__ = ["OnlineConfig", "EventDelta", "OnlineUpdate"]


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """Knobs of ``pio deploy --online`` (docs/operations.md has the
    runbook). Strictly opt-in: ``enabled`` False (the default) starts no
    follower thread and leaves serving byte-identical — CI-guarded like
    batching, caching, ANN, and resilience."""

    #: tail the event store and fold fresh events into the live model
    enabled: bool = False
    #: seconds between watermark polls of the columnar tail
    interval_s: float = 1.0
    #: most events folded per batch; a burst larger than this folds over
    #: several consecutive batches (bounds per-fold solve latency)
    batch_size: int = 4096
    #: comma-derived template/algorithm allowlist; empty = every deployed
    #: algorithm that implements the online hooks participates
    algorithms: tuple[str, ...] = ()
    #: strength of the anchor to the entity's pre-fold row in the ALS
    #: re-solve (``mu`` in ``min ||r - Y x||^2 + lambda n ||x||^2 +
    #: mu ||x - x_old||^2``). 0 = pure fold-in from online-observed
    #: ratings only; higher keeps rows closer to the trained optimum
    #: while their online history is still thin.
    prior_weight: float = 1.0
    #: most entities the per-entity online rating accumulator retains
    #: (LRU per side) — bounds follower memory on unbounded id spaces
    max_entities: int = 100_000
    #: mini-batch size of the streaming two-tower trainer
    trainer_batch: int = 256
    #: learning rate of the streaming two-tower trainer
    trainer_lr: float = 0.05
    #: fold events already in the store at deploy time too (default:
    #: start at the watermark's end — history is the trained model's job)
    from_start: bool = False
    #: override for the watermark file ("" = <basedir>/online/)
    state_dir: str = ""

    def __post_init__(self) -> None:
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.prior_weight < 0:
            raise ValueError("prior_weight must be >= 0")


@dataclasses.dataclass(frozen=True)
class EventDelta:
    """One followed event, reduced to what fold-in consumes."""

    event: str
    user: str
    item: str | None
    t_us: int
    #: numeric ``rating`` property when present (NaN = absent)
    rating: float = float("nan")


@dataclasses.dataclass
class OnlineUpdate:
    """New factor rows for one (algorithm, model) pair, computed by
    ``online_foldin`` (or the streaming trainer) and applied by
    ``apply_online_update`` under the serving lock.

    ``user_ids``/``item_ids`` may name entities absent from the model's
    index — those are cold-start injections: ``apply_online_update``
    extends the id maps and appends their rows. ``seen_pairs`` (two-tower
    only) grows the serving-time seen-item filter coherently with the
    folded events."""

    user_ids: Sequence[str] = ()
    user_rows: Any = None  # np.ndarray [len(user_ids), K]
    item_ids: Sequence[str] = ()
    item_rows: Any = None  # np.ndarray [len(item_ids), K]
    seen_pairs: Sequence[tuple[str, str]] = ()
    #: additional invalidation scopes beyond ``user_ids`` — e.g. the
    #: raters of a touched ITEM, whose own row did not move but whose
    #: ranked results just changed
    extra_scopes: Sequence[str] = ()
    #: loss/diagnostic info for /stats.json (free-form per algorithm)
    info: dict = dataclasses.field(default_factory=dict)

    @property
    def empty(self) -> bool:
        return not self.user_ids and not self.item_ids

    def touched_scopes(self) -> list[str]:
        """Per-scope cache invalidation targets: the users whose ranked
        results this update changes directly (their own row moved, a
        pair they appear in was folded, or an item they rated moved)."""
        scopes = {str(u) for u in self.user_ids}
        scopes.update(str(u) for u, _ in self.seen_pairs)
        scopes.update(str(s) for s in self.extra_scopes)
        return sorted(scopes)


def latest_wins(
    deltas: Sequence[EventDelta],
) -> dict[tuple[str, str], tuple[int, float]]:
    """Collapse a delta batch to one rating per (user, item): latest
    event wins, equal timestamps break toward the higher rating — the
    SAME rule the training read uses, so a fold followed by a retrain
    converges to the same data."""
    out: dict[tuple[str, str], tuple[int, float]] = {}
    for d in deltas:
        if d.item is None or not np.isfinite(d.rating):
            continue
        key = (d.user, d.item)
        cand = (d.t_us, float(d.rating))
        prev = out.get(key)
        if prev is None or cand >= prev:
            out[key] = cand
    return out
