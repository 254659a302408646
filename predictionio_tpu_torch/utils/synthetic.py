"""Planted-preference implicit interactions: the JAX package bench's
Two-Tower workload (``bench.py::_bench_twotower``).

Users and items carry hidden rank-16 preference vectors; each interaction
is a random user choosing the best of 32 random candidate items under
them, so the pairs are skewed and learnable. The same numpy seed gives the
same arrays as the bench. The candidate scores are taken in row chunks
(whole, the ``[n, 32, 16]`` gather alone is ~2 GB at 1M pairs); every
row's score is the same sum either way.
"""

from __future__ import annotations

import numpy as np

__all__ = ["planted_pairs", "distinct_pairs"]

#: rows of candidate scores computed at once
_CHUNK = 1 << 16


def planted_pairs(nnz: int, seed: int = 11):
    """``nnz`` training pairs plus ``nnz // 20`` held-out pairs.

    Returns ``(r_train, c_train, r_test, c_test, num_users, num_items)``
    with ``num_users = max(1000, nnz // 50)`` and ``num_items = max(500,
    nnz // 100)``; pairs may repeat."""
    num_users = max(1000, nnz // 50)
    num_items = max(500, nnz // 100)
    rank_true = 16
    rng = np.random.default_rng(seed)
    tu = rng.normal(size=(num_users, rank_true)).astype(np.float32)
    tv = rng.normal(size=(num_items, rank_true)).astype(np.float32)
    users = rng.integers(0, num_users, nnz + nnz // 20)
    cand = rng.integers(0, num_items, (users.size, 32))
    items = np.empty(users.size, dtype=cand.dtype)
    for lo in range(0, users.size, _CHUNK):
        u, c = users[lo : lo + _CHUNK], cand[lo : lo + _CHUNK]
        scores = np.einsum("nk,nck->nc", tu[u], tv[c])
        items[lo : lo + _CHUNK] = c[np.arange(u.size), scores.argmax(1)]
    return users[:nnz], items[:nnz], users[nnz:], items[nnz:], num_users, num_items


def distinct_pairs(rows: np.ndarray, cols: np.ndarray, num_items: int) -> tuple[np.ndarray, np.ndarray]:
    """The distinct (row, col) pairs sorted by row, then col: the pair set
    the Two-Tower DataSource trains on (in-batch softmax has no per-pair
    weight, so repeats are dropped)."""
    key = np.unique(np.asarray(rows, np.int64) * num_items + np.asarray(cols, np.int64))
    return key // num_items, key % num_items
