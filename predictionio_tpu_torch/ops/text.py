"""Text featurization: hashing vectorizer + TF-IDF.

A copy of ``predictionio_tpu/ops/text.py``, unchanged in numpy (the
port imports nothing of the JAX package, even where a module of it is
jax-free). Replaces the Spark MLlib ``HashingTF``/``IDF`` pair used by
the reference's Text-Classification template. The hashing trick keeps
the feature space a fixed width and vocabulary-free; IDF weights are a
single host pass. Tokenization is lowercase word-splitting
with an optional stopword set, matching the template's preparator.
"""

from __future__ import annotations

import re
import zlib
from typing import Iterable, NamedTuple, Sequence

import numpy as np

__all__ = ["tokenize", "HashingTfIdf", "fit_tfidf"]

_TOKEN_RE = re.compile(r"[a-z0-9']+")


def tokenize(text: str, stopwords: frozenset = frozenset()) -> list[str]:
    return [t for t in _TOKEN_RE.findall(text.lower()) if t not in stopwords]


def _bucket(token: str, num_features: int) -> int:
    return zlib.crc32(token.encode()) % num_features


class HashingTfIdf(NamedTuple):
    """Fitted featurizer state: idf weights + config."""

    idf: np.ndarray  # [F]
    num_features: int
    stopwords: frozenset

    def transform(self, texts: Sequence[str]) -> np.ndarray:
        """texts -> [N, F] tf-idf matrix (dense; F is the hash dim)."""
        out = np.zeros((len(texts), self.num_features), dtype=np.float32)
        for i, text in enumerate(texts):
            for tok in tokenize(text, self.stopwords):
                out[i, _bucket(tok, self.num_features)] += 1.0
        return out * self.idf


def fit_tfidf(
    texts: Iterable[str],
    num_features: int = 4096,
    stopwords: Iterable[str] = (),
) -> HashingTfIdf:
    """Fit IDF over a corpus (parity: ``IDF.fit``): smoothed
    ``log((N+1)/(df+1)) + 1``."""
    stop = frozenset(stopwords)
    df = np.zeros(num_features, dtype=np.float64)
    n_docs = 0
    for text in texts:
        n_docs += 1
        seen = {_bucket(t, num_features) for t in tokenize(text, stop)}
        for b in seen:
            df[b] += 1.0
    idf = np.log((n_docs + 1.0) / (df + 1.0)) + 1.0
    return HashingTfIdf(idf=idf.astype(np.float32), num_features=num_features, stopwords=stop)
