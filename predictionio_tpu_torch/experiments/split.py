"""A/B traffic splitting for the replica fleet router.

Counterpart of ``predictionio_tpu/experiments/split.py``, a copy: the
same key gets the same variant in both packages.

Design constraints, in order:

* **Deterministic stickiness.** A variant assignment is a pure function
  of ``(salt, variant names, weights, affinity key)`` — no assignment
  table, no state file. The same cache scope maps to the same variant
  after a router restart, a replica SIGKILL, a fleet membership change,
  or a second router pointed at the same experiment, by construction.
  (Consistent-hash rings re-shuffle keys when members change; an
  experiment must not, so the split hashes into a weight interval, not
  onto a member ring.)
* **No cross-variant cache hits.** Variant names are validated against
  ``[A-Za-z0-9._-]{1,64}`` — the ``|`` and ``:`` separators used by the
  router's key-generation map and the replica cache namespaces cannot
  occur in a name, so ``f"{variant}|{key}"`` tags are collision-free
  for ANY adversarial scope string (the scope lives inside ``key``,
  after the first separator).
* **Stdlib-only.** The router is stdlib-only; this
  module is declared stdlib-only with no allow-list at all.

Assignment maps a 64-bit keyed blake2b digest of the affinity key onto
exact integer cumulative-weight thresholds over ``2**64`` — float
rounding never moves a boundary, so two processes computing the same
split always agree.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
from bisect import bisect_right
from collections import deque
from hashlib import blake2b

__all__ = ["Variant", "SplitConfig", "TrafficSplit"]

_NAME_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")
#: weights are scaled to integers at this resolution before threshold
#: arithmetic — exact, platform-independent boundaries
_WEIGHT_SCALE = 1_000_000
_SPAN = 1 << 64


@dataclasses.dataclass(frozen=True)
class Variant:
    """One arm of the experiment: a name and a relative traffic weight."""

    name: str
    weight: float = 1.0

    def __post_init__(self):
        if not _NAME_RE.match(self.name or ""):
            raise ValueError(
                f"variant name {self.name!r} must match [A-Za-z0-9._-]{{1,64}} "
                "(separator characters would break cache-key namespacing)"
            )
        if self.weight < 0 or self.weight != self.weight:
            raise ValueError(f"variant {self.name!r} weight must be >= 0")


@dataclasses.dataclass(frozen=True)
class SplitConfig:
    """Immutable experiment description (variants + hash salt)."""

    variants: tuple = ()
    salt: str = "pio-exp"

    def __post_init__(self):
        names = [v.name for v in self.variants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate variant names: {names}")
        if self.variants and not any(v.weight > 0 for v in self.variants):
            raise ValueError("at least one variant needs weight > 0")

    @property
    def enabled(self) -> bool:
        return len(self.variants) >= 2

    @staticmethod
    def parse(spec: str, salt: str = "pio-exp") -> "SplitConfig":
        """``"control:2,treatment:1"`` (or bare names, weight 1) -> config.

        The CLI surface for ``pio deploy --variants``; at least two
        variants are required (one variant is not an experiment).
        """
        variants = []
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            name, _, w = part.partition(":")
            try:
                weight = float(w) if w else 1.0
            except ValueError:
                raise ValueError(
                    f"--variants weight {w!r} for {name!r} is not a number"
                ) from None
            variants.append(Variant(name=name.strip(), weight=weight))
        if len(variants) < 2:
            raise ValueError(
                f"--variants needs at least two name[:weight] entries, got {spec!r}"
            )
        return SplitConfig(variants=tuple(variants), salt=salt)

    def thresholds(self) -> list[tuple[int, str]]:
        """Cumulative integer thresholds over ``2**64``, one per variant
        (zero-weight variants get an empty interval and are never
        assigned). Exact integer arithmetic — deterministic everywhere."""
        scaled = [max(0, round(v.weight * _WEIGHT_SCALE)) for v in self.variants]
        total = sum(scaled)
        if total <= 0:
            return []
        out, acc = [], 0
        for v, s in zip(self.variants, scaled):
            acc += s
            out.append(((_SPAN * acc) // total, v.name))
        return out


class _VariantStats:
    """Per-variant counters: routed/errors, latency percentiles from a
    bounded reservoir, reward aggregates."""

    __slots__ = ("routed", "errors", "rewards", "reward_sum", "latencies")

    def __init__(self):
        self.routed = 0
        self.errors = 0
        self.rewards = 0
        self.reward_sum = 0.0
        self.latencies = deque(maxlen=512)

    def percentile_ms(self, q: float):
        snap = sorted(self.latencies)
        if not snap:
            return None
        idx = min(len(snap) - 1, int(q * (len(snap) - 1) + 0.5))
        return round(snap[idx] * 1000.0, 3)


class TrafficSplit:
    """Live experiment state for one router: assignment + counters +
    promotion. Everything except the counters is derivable from the
    (immutable) config, which is the whole stickiness story."""

    def __init__(self, config: SplitConfig):
        if not config.variants:
            raise ValueError("TrafficSplit needs at least one variant")
        self._lock = threading.Lock()
        self._config = config
        self._bounds, self._names = self._compile(config)
        self._stats = {v.name: _VariantStats() for v in config.variants}
        self.promoted: dict | None = None

    @staticmethod
    def _compile(config: SplitConfig):
        pairs = config.thresholds()
        return [b for b, _ in pairs], [n for _, n in pairs]

    @property
    def config(self) -> SplitConfig:
        with self._lock:
            return self._config

    def variant_names(self) -> list[str]:
        return [v.name for v in self.config.variants]

    # ------------------------------------------------------------ assignment
    def assign(self, key: str | None) -> str:
        """Affinity key -> variant name. ``None`` (an uncacheable body —
        no scope, not canonicalizable) pins to the first variant so an
        anonymous probe stream stays internally consistent."""
        with self._lock:
            bounds, names = self._bounds, self._names
            salt = self._config.salt
            first = self._config.variants[0].name
        if not bounds:
            return first
        if key is None:
            return names[0]
        h = int.from_bytes(
            blake2b(
                key.encode("utf-8", "surrogatepass"),
                digest_size=8,
                key=salt.encode("utf-8")[:64],
            ).digest(),
            "big",
        )
        idx = bisect_right(bounds, h)
        return names[min(idx, len(names) - 1)]

    # -------------------------------------------------------------- counters
    def note_routed(self, variant: str, seconds: float, ok: bool = True) -> None:
        with self._lock:
            st = self._stats.get(variant)
            if st is None:
                return
            st.routed += 1
            if not ok:
                st.errors += 1
            st.latencies.append(max(0.0, float(seconds)))

    def note_reward(self, variant: str, value: float = 1.0) -> None:
        with self._lock:
            st = self._stats.get(variant)
            if st is None:
                return
            st.rewards += 1
            try:
                st.reward_sum += float(value)
            except (TypeError, ValueError):
                st.reward_sum += 1.0

    # ------------------------------------------------------------- promotion
    def promote(self, winner: str) -> dict:
        """Collapse the split onto ``winner`` (weight 1, everything else
        0). Counters survive so the post-promotion stats still show the
        experiment's full history; the final pre-promotion weights are
        recorded in the promotion stamp."""
        with self._lock:
            cfg = self._config
            if winner not in {v.name for v in cfg.variants}:
                raise ValueError(
                    f"unknown variant {winner!r}; have {[v.name for v in cfg.variants]}"
                )
            before = {v.name: v.weight for v in cfg.variants}
            new_cfg = dataclasses.replace(
                cfg,
                variants=tuple(
                    dataclasses.replace(v, weight=1.0 if v.name == winner else 0.0)
                    for v in cfg.variants
                ),
            )
            self._config = new_cfg
            self._bounds, self._names = self._compile(new_cfg)
            self.promoted = {
                "variant": winner,
                "at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                "weightsBefore": before,
            }
            return dict(self.promoted)

    # ----------------------------------------------------------------- stats
    def stats_json(self) -> dict:
        with self._lock:
            cfg = self._config
            out = {
                "salt": cfg.salt,
                "promoted": dict(self.promoted) if self.promoted else None,
                "variants": [],
            }
            for v in cfg.variants:
                st = self._stats[v.name]
                out["variants"].append(
                    {
                        "name": v.name,
                        "weight": v.weight,
                        "routed": st.routed,
                        "errors": st.errors,
                        "p50Ms": st.percentile_ms(0.50),
                        "p99Ms": st.percentile_ms(0.99),
                        "rewardCount": st.rewards,
                        "rewardSum": round(st.reward_sum, 6),
                        "rewardMean": (
                            round(st.reward_sum / st.rewards, 6)
                            if st.rewards
                            else None
                        ),
                    }
                )
            return out
