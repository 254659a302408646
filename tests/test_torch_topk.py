"""The port's top-K (predictionio_tpu_torch/ops/topk.py) against the JAX
package's (predictionio_tpu/ops/topk.py) under the one tie rule —
descending score, ties to the lower index — on scores with many exact
ties. Ids must be equal bit for bit.

The contract is ``jax.lax.top_k``'s, which the reference's own
``tests/test_ivf.py`` holds ``top_k_host`` to. The reference's
``top_k_host`` misses it where a tie straddles the k-th place (its
``argpartition`` keeps arbitrary members of the tie), so the port's
``top_k_host`` is held to ``jax.lax.top_k``, not to it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import topk as jax_topk
from predictionio_tpu_torch.ops import topk as torch_topk


def _tied_scores(shape, seed: int) -> np.ndarray:
    # few distinct values, so most positions tie with many others
    rng = np.random.default_rng(seed)
    return rng.integers(-3, 4, size=shape).astype(np.float32) / 4.0


@pytest.mark.parametrize("shape,k", [((50,), 7), ((6, 40), 5), ((3, 200), 32), ((4, 9), 9)])
def test_top_k_scores_ids_equal_jax(shape, k):
    s = _tied_scores(shape, seed=k)
    idx_j, val_j = jax_topk.top_k_scores(jnp.asarray(s), k)
    idx_t, val_t = torch_topk.top_k_scores(torch.from_numpy(s), k)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))


@pytest.mark.parametrize("shape,k", [((50,), 7), ((6, 40), 5), ((3, 200), 32), ((2, 5), 0)])
def test_top_k_host_ids_equal_jax(shape, k):
    s = _tied_scores(shape, seed=100 + k)
    idx_t, val_t = torch_topk.top_k_host(s, k)
    if k == 0:
        assert idx_t.shape == shape[:-1] + (0,) and val_t.shape == idx_t.shape
        return
    val_j, idx_j = jax.lax.top_k(jnp.asarray(s), k)
    np.testing.assert_array_equal(idx_t, np.asarray(idx_j))
    np.testing.assert_array_equal(val_t, np.asarray(val_j))


@pytest.mark.parametrize("scores,k,want", [
    ([1.0, 0.5, 0.5, 0.5, 0.5, 0.5], 3, [0, 1, 2]),
    ([0.0] * 40, 10, list(range(10))),
], ids=["tie-at-kth", "zero-row"])
def test_top_k_host_keeps_the_lowest_indices_of_a_straddling_tie(scores, k, want):
    s = np.asarray(scores, np.float32)
    assert torch_topk.top_k_host(s, k)[0].tolist() == want
    assert torch_topk.top_k_host(np.stack([s, s]), k)[0].tolist() == [want, want]
    assert np.asarray(jax.lax.top_k(jnp.asarray(s), k)[1]).tolist() == want


@pytest.mark.parametrize("seed", range(4))
def test_tied_sweep_equals_lax_top_k(seed):
    """Rows of integers 0-3, widths 5-200, random k: both ``top_k_host``
    (2-D and row by row) and ``top_k_scores`` give ``jax.lax.top_k``'s
    ids and values."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        width = int(rng.integers(5, 201))
        k = int(rng.integers(1, width + 1))
        s = rng.integers(0, 4, size=(3, width)).astype(np.float32)
        val_j, idx_j = (np.asarray(a) for a in jax.lax.top_k(jnp.asarray(s), k))
        idx_h, val_h = torch_topk.top_k_host(s, k)
        idx_t, val_t = torch_topk.top_k_scores(torch.from_numpy(s), k)
        for idx, val in ((idx_h, val_h), (idx_t.numpy(), val_t.numpy())):
            np.testing.assert_array_equal(idx, idx_j)
            np.testing.assert_array_equal(val, val_j)
        for row in range(3):
            np.testing.assert_array_equal(torch_topk.top_k_host(s[row], k)[0], idx_j[row])


SIGNED_ZEROS = [-0.0, 0.0, np.nan, -0.0, 0.0, 1.0, -np.inf, np.nan, -1.0]


@pytest.mark.parametrize("k", [2, 5, 9])
def test_signed_zeros_and_nans_order_as_lax_top_k(k):
    """``0.0`` ranks above ``-0.0``, and NaN first by ascending index, in
    both ``top_k_scores`` and ``top_k_host``: ``[2 7 5 1 4 0 3 8 6]``."""
    s = np.asarray(SIGNED_ZEROS, np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(s), k)[1])
    assert want.tolist() == [2, 7, 5, 1, 4, 0, 3, 8, 6][:k]
    idx_t, val_t = torch_topk.top_k_scores(torch.from_numpy(s), k)
    idx_h, val_h = torch_topk.top_k_host(s, k)
    np.testing.assert_array_equal(idx_t.numpy(), want)
    np.testing.assert_array_equal(idx_h, want)
    # the values keep their bits: the signs of the zeros too
    np.testing.assert_array_equal(np.signbit(val_t.numpy()), np.signbit(s[want]))
    np.testing.assert_array_equal(np.signbit(val_h), np.signbit(s[want]))


def test_sort_merge_keeps_one_key_for_the_two_zeros():
    """The reference's ``lax.sort`` on ``(-score, id)`` ties ``-0.0`` with
    ``0.0``: its merges keep that, and rank them by id."""
    s = torch.tensor([[-0.0, 0.0, 1.0, -0.0]])
    ids = torch.tensor([[3, 7, 9, 1]])
    got, _ = torch_topk.sort_merge_topk(s, ids, 4)
    want, _ = jax_topk.sort_merge_topk(jnp.asarray(s.numpy()), jnp.asarray(ids.numpy()), 4)
    assert got.tolist() == np.asarray(want).tolist() == [[9, 1, 3, 7]]


def test_tie_order_is_ascending_index():
    s = torch.tensor([1.0, 2.0, 2.0, 1.0, 2.0, float("-inf")])
    idx, val = torch_topk.top_k_scores(s, 4)
    assert idx.tolist() == [1, 2, 4, 0]
    assert val.tolist() == [2.0, 2.0, 2.0, 1.0]


@pytest.mark.parametrize("k,n", [(1, 100), (10, 100), (16, 100), (17, 100), (40, 30), (0, 50)])
def test_bucket_k_equals_jax(k, n):
    assert torch_topk.bucket_k(k, n) == jax_topk.bucket_k(k, n)
