"""Small learners (parity: ``e2/src/main/scala/.../e2/engine/``).

* :class:`CategoricalNaiveBayes` — NB over string-valued categorical
  features (``CategoricalNaiveBayes.scala``).
* :class:`MarkovChain` — first-order transition model over an item
  universe (``MarkovChain.scala``).
* :class:`BinaryVectorizer` — (feature, value) one-hot encoder
  (``BinaryVectorizer.scala``).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Iterable, Mapping, Sequence

import numpy as np

__all__ = ["CategoricalNaiveBayes", "MarkovChain", "BinaryVectorizer"]


class CategoricalNaiveBayes:
    """NB where each feature is a categorical string. Laplace-smoothed;
    unseen feature values fall back to the smoothing mass."""

    def __init__(self, smoothing: float = 1.0):
        self.smoothing = smoothing
        self._priors: dict[str, float] = {}
        self._likelihood: dict[str, list[dict[str, float]]] = {}
        self._label_counts: dict[str, int] = {}
        self._value_counts: list[int] = []

    def fit(
        self, data: Iterable[tuple[str, Sequence[str]]]
    ) -> "CategoricalNaiveBayes":
        """``data``: iterable of (label, [feature_value per position])."""
        rows = list(data)
        if not rows:
            raise ValueError("No training rows")
        n_features = len(rows[0][1])
        label_counts: Counter = Counter()
        per_label_feature: dict[str, list[Counter]] = defaultdict(
            lambda: [Counter() for _ in range(n_features)]
        )
        values_per_pos = [set() for _ in range(n_features)]
        for label, feats in rows:
            if len(feats) != n_features:
                raise ValueError("Inconsistent feature arity")
            label_counts[label] += 1
            for i, v in enumerate(feats):
                per_label_feature[label][i][v] += 1
                values_per_pos[i].add(v)
        total = sum(label_counts.values())
        self._value_counts = [len(s) for s in values_per_pos]
        self._label_counts = dict(label_counts)
        self._priors = {
            l: math.log(c / total) for l, c in label_counts.items()
        }
        self._likelihood = {}
        for label, counters in per_label_feature.items():
            n_label = label_counts[label]
            per_pos = []
            for i, counter in enumerate(counters):
                denom = n_label + self.smoothing * self._value_counts[i]
                per_pos.append(
                    {
                        v: math.log((c + self.smoothing) / denom)
                        for v, c in counter.items()
                    }
                )
            self._likelihood[label] = per_pos
        return self

    def log_score(self, label: str, feats: Sequence[str]) -> float | None:
        if label not in self._priors:
            return None
        score = self._priors[label]
        per_pos = self._likelihood[label]
        n_label = self._label_counts[label]
        for i, v in enumerate(feats):
            if v in per_pos[i]:
                score += per_pos[i][v]
            elif self.smoothing > 0:
                # unseen value: the pure-smoothing mass
                score += math.log(
                    self.smoothing
                    / (n_label + self.smoothing * self._value_counts[i])
                )
            else:
                return None  # parity: unsmoothed NB cannot score unseen
        return score

    def predict(self, feats: Sequence[str]) -> str:
        best, best_score = None, -math.inf
        for label in self._priors:
            s = self.log_score(label, feats)
            if s is not None and s > best_score:
                best, best_score = label, s
        if best is None:
            raise ValueError("No scorable label")
        return best


class MarkovChain:
    """First-order Markov transition model (parity: ``MarkovChain.scala``):
    fit on (from, to) transitions, query top-k next states."""

    def __init__(self, top_k: int = 10):
        self.top_k = top_k
        self._transitions: dict[str, list[tuple[str, float]]] = {}

    def fit(self, transitions: Iterable[tuple[str, str]]) -> "MarkovChain":
        counts: dict[str, Counter] = defaultdict(Counter)
        for src, dst in transitions:
            counts[src][dst] += 1
        self._transitions = {}
        for src, counter in counts.items():
            total = sum(counter.values())
            ranked = counter.most_common(self.top_k)
            self._transitions[src] = [(dst, c / total) for dst, c in ranked]
        return self

    def next_states(self, src: str) -> list[tuple[str, float]]:
        return list(self._transitions.get(src, []))


class BinaryVectorizer:
    """One-hot encoder over (field, value) pairs
    (parity: ``BinaryVectorizer.scala``)."""

    def __init__(self):
        self._index: dict[tuple[str, str], int] = {}

    @classmethod
    def fit(cls, rows: Iterable[Mapping[str, str]]) -> "BinaryVectorizer":
        v = cls()
        for row in rows:
            for field, value in sorted(row.items()):
                key = (field, str(value))
                if key not in v._index:
                    v._index[key] = len(v._index)
        return v

    @property
    def num_features(self) -> int:
        return len(self._index)

    def transform(self, row: Mapping[str, str]) -> np.ndarray:
        out = np.zeros(len(self._index), dtype=np.float32)
        for field, value in row.items():
            idx = self._index.get((field, str(value)))
            if idx is not None:
                out[idx] = 1.0
        return out
