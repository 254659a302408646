"""Exploration policies over served top-K scores.

Counterpart of ``predictionio_tpu/experiments/explore.py``. ``pio deploy
--explore epsilon|thompson`` re-ranks each query's ``itemScores``
payload before it leaves the serving path:

* **epsilon-greedy** — with probability ``epsilon`` the served head item
  is a uniform draw from the candidate list instead of the greedy best;
  the rest of the list keeps its score order.
* **thompson** — every candidate's score is perturbed by Gaussian noise
  whose width is that item's posterior uncertainty, and the list is
  served in sampled order. The width starts at
  ``score_spread * prior_scale`` and shrinks as ``1/sqrt(1 + pulls)``
  with observed impressions, fed by the reward stream (the online
  follower hands reward events to :meth:`Explorer.note_reward_events`,
  or ``POST /experiments/reward.json`` does when online learning is
  off).

Both policies are torch ops on an explicit device — the query
service's, the card unless the deploy says ``--device cpu`` — over
pow2-bucketed candidate arrays (floor 8, cap 512), called from the
service's device thread: a re-rank is a few small launches and one copy
back. Randomness: each call gets its own ``torch.Generator`` on that
device, seeded by a fixed 64-bit mix of ``(seed, counter)``, the counter
taken under the lock — so the same seed and the same query order give
the same served orders. ``jax.random.fold_in`` cannot be replayed in
torch, so the two packages agree by contract and by distribution, not by
bits.

Regret accounting: every explored query adds ``best_score -
served_score`` (model-score regret) to a per-policy counter surfaced on
``/stats.json``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device

__all__ = ["ExploreConfig", "Explorer"]

logger = logging.getLogger(__name__)

POLICIES = ("epsilon", "thompson")
_MIN_BUCKET = 8
#: beyond this many candidates only the top slice participates in
#: exploration — the tail of a 10k-item response is never served first
#: anyway
_MAX_BUCKET = 512
_MASK64 = (1 << 64) - 1


def _bucket(n: int) -> int:
    return min(_MAX_BUCKET, max(_MIN_BUCKET, 1 << (max(1, n) - 1).bit_length()))


def _call_seed(seed: int, counter: int) -> int:
    """The generator seed of one call: splitmix64's finalizer over the
    seed and the call counter (a fixed mix, so a run replays exactly)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(counter) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _generator(device: torch.device, seed: int, counter: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(_call_seed(seed, counter))
    return gen


@dataclasses.dataclass(frozen=True)
class ExploreConfig:
    """``--explore`` flags. Disabled (empty policy) by default — a
    policy-less deploy never imports this module."""

    policy: str = ""
    epsilon: float = 0.1
    seed: int = 0
    #: event name the follower treats as reward signal
    reward_event: str = "reward"
    #: Thompson prior width as a fraction of the response's score spread
    prior_scale: float = 0.25

    def __post_init__(self):
        if self.policy and self.policy not in POLICIES:
            raise ValueError(f"--explore must be one of {POLICIES}, got {self.policy!r}")
        if not 0.0 <= self.epsilon <= 1.0:
            raise ValueError(f"--explore-epsilon must be in [0,1], got {self.epsilon}")

    @property
    def enabled(self) -> bool:
        return self.policy in POLICIES


def _thompson_rank(scores: torch.Tensor, widths: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Descending order of posterior samples; -inf padding sorts last
    (stable, as ``jnp.argsort``)."""
    noise = torch.randn(scores.shape, generator=gen, device=scores.device, dtype=scores.dtype)
    sampled = torch.where(torch.isfinite(scores), scores + widths * noise, float("-inf"))
    return torch.argsort(-sampled, stable=True)


def _epsilon_rank(scores: torch.Tensor, gen: torch.Generator, eps: float, n_valid: int) -> torch.Tensor:
    """Greedy order with the (possibly random) head moved to the front,
    and the explore flag as one more element (one copy back for both).

    Input scores arrive descending (serving order); explore picks a
    uniform index over the first ``n_valid`` real entries.
    """
    device = scores.device
    explore = torch.rand((), generator=gen, device=device) < eps
    valid = torch.isfinite(scores)
    best = torch.argmax(torch.where(valid, scores, float("-inf")))
    rnd = torch.randint(0, max(int(n_valid), 1), (), generator=gen, device=device)
    chosen = torch.where(explore, rnd, best)
    idx = torch.arange(scores.shape[0], device=device)
    order = torch.argsort(torch.where(idx == chosen, -1, idx), stable=True)
    return torch.cat([order, explore.to(order.dtype).view(1)])


class _ItemStat:
    __slots__ = ("pulls", "rewards", "reward_sum")

    def __init__(self):
        self.pulls = 0
        self.rewards = 0
        self.reward_sum = 0.0


class Explorer:
    """Per-service exploration state: one seeded stream of per-call
    generators, per-item pull and reward counts (the posterior), policy
    counters for /stats.json. ``device``: where the policies run (None:
    the card)."""

    #: bound on distinct tracked items (catalogs are bounded in practice;
    #: this is a safety valve, evicting nothing once hit — a never-seen
    #: item just keeps its prior width)
    MAX_TRACKED_ITEMS = 200_000

    def __init__(self, config: ExploreConfig, device: str | torch.device | None = None):
        if not config.enabled:
            raise ValueError("Explorer needs an enabled ExploreConfig")
        self.config = config
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._counter = 0
        self._items: dict[str, _ItemStat] = {}
        self.queries = 0
        self.explored = 0
        self.regret_sum = 0.0
        self.reward_events = 0
        self.reward_matched = 0
        self.reward_value_sum = 0.0
        self.last_error: str | None = None

    # -------------------------------------------------------------- serving
    def rerank(self, item_scores: list) -> list:
        """Re-order a response's ``itemScores`` under the policy.

        Robust by contract: any failure logs once, counts into
        ``last_error``, and returns the list unchanged — exploration
        must never fail a query.
        """
        try:
            return self._rerank(item_scores)
        except Exception as e:  # pragma: no cover - defensive
            with self._lock:
                self.last_error = f"{type(e).__name__}: {e}"
            logger.warning("explore rerank failed; serving greedy: %s", e)
            return item_scores

    def _rerank(self, item_scores: list) -> list:
        n = len(item_scores)
        with self._lock:
            self.queries += 1
            if n < 2:
                return item_scores
            counter = self._counter
            self._counter += 1
            head = item_scores[: min(n, _MAX_BUCKET)]
            raw = np.array([float(e.get("score", 0.0)) for e in head], dtype=np.float32)
            bucket = _bucket(len(head))
            scores = np.full(bucket, -np.inf, dtype=np.float32)
            scores[: len(head)] = raw
            if self.config.policy == "thompson":
                finite = raw[np.isfinite(raw)]
                spread = float(finite.max() - finite.min()) if finite.size else 0.0
                if spread <= 0.0:
                    spread = 1.0
                widths = np.zeros(bucket, dtype=np.float32)
                for i, e in enumerate(head):
                    st = self._items.get(str(e.get("item")))
                    pulls = st.pulls if st is not None else 0
                    widths[i] = spread * self.config.prior_scale / (1.0 + pulls) ** 0.5
        gen = _generator(self.device, self.config.seed, counter)
        scores_t = torch.from_numpy(scores).to(self.device)
        if self.config.policy == "thompson":
            widths_t = torch.from_numpy(widths).to(self.device)
            order = _thompson_rank(scores_t, widths_t, gen).cpu().numpy()
            explored_flag = None
        else:
            out = _epsilon_rank(scores_t, gen, self.config.epsilon, len(head)).cpu().numpy()
            order, explored_flag = out[:-1], bool(out[-1])
        keep = [int(i) for i in order if i < len(head)]
        out_list = [head[i] for i in keep] + item_scores[len(head):]
        with self._lock:
            chosen = keep[0]
            best = float(raw.max()) if len(head) else 0.0
            served = float(raw[chosen])
            if explored_flag is None:
                explored_flag = chosen != int(raw.argmax())
            if explored_flag:
                self.explored += 1
                self.regret_sum += max(0.0, best - served)
            item = str(head[chosen].get("item"))
            st = self._items.get(item)
            if st is None and len(self._items) < self.MAX_TRACKED_ITEMS:
                st = self._items[item] = _ItemStat()
            if st is not None:
                st.pulls += 1
        return out_list

    # -------------------------------------------------------------- rewards
    def note_reward_events(self, events) -> int:
        """Fold reward events (storage ``Event`` objects or JSON dicts)
        into the posterior. Returns how many events matched the
        configured reward event name. Called from the online follower
        cycle or the replica's ``POST /experiments/reward.json``.
        """
        matched = 0
        for e in events or ():
            if isinstance(e, dict):
                name = e.get("event")
                item = e.get("targetEntityId") or e.get("item")
                props = e.get("properties") or {}
                value = props.get("value", props.get("rating"))
            else:
                name = getattr(e, "event", None)
                item = getattr(e, "target_entity_id", None)
                props = getattr(e, "properties", None)
                value = None
                if props is not None:
                    value = props.opt("value")
                    if value is None:
                        value = props.opt("rating")
            if name != self.config.reward_event:
                continue
            matched += 1
            try:
                val = float(value) if value is not None else 1.0
            except (TypeError, ValueError):
                val = 1.0
            with self._lock:
                self.reward_events += 1
                self.reward_value_sum += val
                st = self._items.get(str(item)) if item is not None else None
                if st is None and item is not None and len(self._items) < self.MAX_TRACKED_ITEMS:
                    st = self._items[str(item)] = _ItemStat()
                if st is not None:
                    self.reward_matched += 1
                    st.rewards += 1
                    st.reward_sum += val
        return matched

    # ---------------------------------------------------------------- stats
    def stats_json(self) -> dict:
        with self._lock:
            return {
                "policy": self.config.policy,
                "epsilon": self.config.epsilon,
                "seed": self.config.seed,
                "queries": self.queries,
                "explored": self.explored,
                "regret": round(self.regret_sum, 6),
                "regretPerQuery": (round(self.regret_sum / self.queries, 6) if self.queries else 0.0),
                "rewards": {
                    "events": self.reward_events,
                    "matched": self.reward_matched,
                    "valueSum": round(self.reward_value_sum, 6),
                    "event": self.config.reward_event,
                },
                "itemsTracked": len(self._items),
                "lastError": self.last_error,
            }
