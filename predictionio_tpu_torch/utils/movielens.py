"""MovieLens datasets: the ML-100K file, and shaped replicas made from a seed.

* :func:`load_ml100k` — parses a real ``u.data`` (tab-separated ``user
  item rating timestamp``) that the user names; :func:`ml100k_dataset`
  reads the file ``ML100K_PATH`` names, else the replica below (the JAX
  package's loader, ``predictionio_tpu/utils/movielens.py``).
* :func:`synthesize_ml100k` — the JAX package's deterministic ML-100K
  structural replica (``predictionio_tpu/utils/movielens.py``): 943 users,
  1682 items, 100,000 ratings with the real rating histogram, >= 20
  ratings per user, long-tailed item popularity, planted low-rank
  preferences. Same seed, same arrays.
* :func:`ml20m_shaped` — the ML-20M-shaped Zipf workload of the JAX
  package's bench (``bench.py`` ``_make_workload`` at
  ``num_users = nnz/145``, ``num_items = nnz/740``): 137,931 users x
  27,027 items at the default 20M ratings.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "ML100K_USERS",
    "ML100K_ITEMS",
    "ML100K_RATINGS",
    "ML100K_HISTOGRAM",
    "load_ml100k",
    "synthesize_ml100k",
    "ml100k_dataset",
    "ml20m_shaped",
]

ML100K_USERS = 943
ML100K_ITEMS = 1682
ML100K_RATINGS = 100_000
#: the real dataset's rating-value counts for 1..5 stars
ML100K_HISTOGRAM = (6_110, 11_370, 27_145, 34_174, 21_201)


def load_ml100k(path: str):
    """Parse a real ``u.data``: returns (users, items, ratings,
    timestamps) as numpy arrays with 0-based user/item indices."""
    data = np.loadtxt(path, dtype=np.int64)
    if data.shape[1] != 4:
        raise ValueError(f"{path} is not a MovieLens u.data file")
    return (
        data[:, 0] - 1,
        data[:, 1] - 1,
        data[:, 2].astype(np.float32),
        data[:, 3],
    )


def synthesize_ml100k(seed: int = 42):
    """Deterministic ML-100K structural replica. Returns (users, items,
    ratings, timestamps)."""
    rng = np.random.default_rng(seed)
    U, I, N = ML100K_USERS, ML100K_ITEMS, ML100K_RATINGS

    # per-user activity: >= 20 each, the remainder long-tailed
    base = np.full(U, 20, np.int64)
    extra = rng.dirichlet(np.full(U, 0.3)) * (N - base.sum())
    counts = base + np.floor(extra).astype(np.int64)
    short = N - counts.sum()
    counts[rng.choice(U, int(short), replace=False)] += 1
    users = np.repeat(np.arange(U), counts)

    # item popularity: zipf-ish over a shuffled catalog; each user rates
    # distinct items
    pop = 1.0 / np.arange(1, I + 1) ** 0.9
    pop = rng.permutation(pop / pop.sum())
    items = np.empty(N, np.int64)
    lo = 0
    for c in counts:
        items[lo: lo + c] = rng.choice(I, size=int(c), p=pop, replace=False)
        lo += int(c)

    # planted preferences + biases -> quantized 1..5
    rank = 8
    uf = rng.normal(size=(U, rank)).astype(np.float64) / np.sqrt(rank)
    vf = rng.normal(size=(I, rank)).astype(np.float64) / np.sqrt(rank)
    u_bias = rng.normal(scale=0.35, size=U)
    i_bias = rng.normal(scale=0.35, size=I)
    raw = (
        np.einsum("nk,nk->n", uf[users], vf[items])
        + u_bias[users]
        + i_bias[items]
        + rng.normal(scale=0.45, size=N)
    )
    # cutoffs at the real histogram's quantiles
    order = np.argsort(raw, kind="stable")
    ratings = np.empty(N, np.float32)
    edges = np.cumsum(ML100K_HISTOGRAM)
    lo = 0
    for star, hi in enumerate(edges, start=1):
        ratings[order[lo:hi]] = float(star)
        lo = hi
    timestamps = 874_724_710 + rng.integers(0, 190 * 86_400, N)
    return users, items, ratings, timestamps.astype(np.int64)


def ml100k_dataset():
    """The parity dataset: the real file when ``ML100K_PATH`` names one,
    the deterministic replica otherwise. Returns (users, items, ratings,
    timestamps, source_label)."""
    path = os.environ.get("ML100K_PATH")
    if path and os.path.exists(path):
        u, i, r, t = load_ml100k(path)
        return u, i, r, t, "movielens-100k (real)"
    u, i, r, t = synthesize_ml100k()
    return u, i, r, t, "ml-100k structural replica (deterministic)"


def ml20m_shaped(nnz: int = 20_000_000, seed: int = 5):
    """Zipf-skewed synthetic ratings at the ML-20M shape. Returns
    ``(rows, cols, vals, num_users, num_items)``; ratings are 0.5..5.0 in
    half stars, items drawn by a power law, users uniformly."""
    num_users = max(1000, int(nnz / 145))
    num_items = max(500, int(nnz / 740))
    rng = np.random.default_rng(seed)
    item_p = 1.0 / np.arange(1, num_items + 1) ** 0.8
    item_p /= item_p.sum()
    rows = rng.integers(0, num_users, size=nnz).astype(np.int64)
    cols = rng.choice(num_items, size=nnz, p=item_p).astype(np.int64)
    vals = rng.integers(1, 11, size=nnz).astype(np.float32) / 2.0
    return rows, cols, vals, num_users, num_items
