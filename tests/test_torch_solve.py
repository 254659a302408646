"""The port's batched SPD solves (predictionio_tpu_torch/ops/solve.py)
against the JAX package's (predictionio_tpu/ops/solve.py).

Inputs are numpy from a seed, handed to both packages. The JAX side runs
its Pallas kernel as its own CPU tests do (``method="pallas_interpret"``).
Tolerance rtol 5e-4, atol 5e-5: the band of the JAX package's own
interpret-vs-Cholesky check (tests/test_als.py), since both are float32
solves of the same well-conditioned systems by different elimination
orders. Above K = 64 the port's plain version is its own blocked form
(``gj_solve_wide_reference``: the pivot rows become ``Di R``), held to the
JAX kernel at the same band on these well-scaled systems, and to a float64
solve at 1e-4 on ALS Gramians of much-rated items (found 8.5e-6 and
2.4e-5; the JAX kernel's form 4.0e-3 and 4.9e-3 there, the library
Cholesky 5.7e-6 and 8.9e-6). The CUDA kernel itself runs only on the card:
tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import solve as jax_solve
from predictionio_tpu_torch.ops import solve as torch_solve

RTOL, ATOL = 5e-4, 5e-5


def _spd(B: int, K: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, K, K)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1) + 5 * np.eye(K, dtype=np.float32)
    b = rng.normal(size=(B, K)).astype(np.float32)
    return A, b


@pytest.mark.parametrize(
    "B,K",
    [(40, 8), (37, 16), (35, 64),
     # the widths of the blocked kernel (one block a system to K = 128, a
     # cluster of two above), small and odd B: the plain version is its
     # arithmetic
     (2, 72), (5, 72), (4, 128), (3, 128), (2, 136), (7, 136), (2, 256), (3, 256)],
)
def test_gj_reference_matches_pallas_interpret(B, K):
    # B is not a multiple of the JAX kernel's block of rows (32 at K = 64,
    # 8 at K = 128, 3 at K = 256), so the JAX side pads with identity
    # systems and the port pads nothing. The port's side is the plain
    # version of the kernel of this width: gj_solve_reference to K = 64,
    # gj_solve_wide_reference above
    A, b = _spd(B, K, seed=K)
    x_jax = np.asarray(jax_solve.spd_solve(jnp.asarray(A), jnp.asarray(b), method="pallas_interpret"))
    plain = torch_solve.gj_solve_reference if K <= torch_solve.WARP_MAX_K else torch_solve.gj_solve_wide_reference
    x_ref = plain(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x_ref, x_jax, rtol=RTOL, atol=ATOL)
    # on a CPU tensor the dispatch and the kernel wrapper take the plain
    # version, bit for bit, and launch nothing
    before = torch_solve.gj_solve_cuda.launches
    x_auto = torch_solve.spd_solve(torch.from_numpy(A), torch.from_numpy(b))
    assert torch.equal(x_auto, torch.from_numpy(x_ref))
    assert torch_solve.gj_solve_cuda.launches == before


@pytest.mark.parametrize("K,path", [(64, "gj"), (72, "gj"), (256, "gj"), (264, "cholesky"), (130, "cholesky")])
def test_spd_solve_dispatch(K, path):
    # both packages: K a multiple of 8 up to 256 to Gauss-Jordan (on a
    # CPU tensor the plain version, bit for bit), any other K to Cholesky
    A, b = _spd(3, K, seed=K + 1)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    before = torch_solve.gj_solve_cuda.launches
    x = torch_solve.spd_solve(At, bt)
    assert torch_solve.gj_solve_cuda.launches == before
    want = torch_solve.gj_solve_plain(At, bt) if path == "gj" else torch_solve.cholesky_solve(At, bt)
    assert torch.equal(x, want)
    assert (K % torch_solve.PIVOT_BLOCK == 0 and K <= torch_solve.MAX_GJ_K) == (path == "gj")
    assert torch_solve.MAX_GJ_K == jax_solve._MAX_PALLAS_K and torch_solve.PIVOT_BLOCK == jax_solve._PIVOT_BLOCK


def _als_gramians(K: int, counts: list, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """ALS-WR normal equations of items with ``counts`` ratings from users
    with rank-K factors: Σ u uᵀ + 0.01·n·I and Σ r u, in float64."""
    rng = np.random.default_rng(seed)
    A, b = np.empty((len(counts), K, K)), np.empty((len(counts), K))
    for i, n in enumerate(counts):
        U = rng.normal(size=(n, K)) / np.sqrt(K) + 0.2
        r = rng.integers(1, 11, n) / 2.0
        A[i] = U.T @ U + 0.01 * n * np.eye(K)
        b[i] = U.T @ r
    return A, b


@pytest.mark.parametrize("K", [72, 128])
def test_wide_reference_keeps_its_digits_where_pivots_are_large(K):
    # the Gramians of much-rated items: the kernel's arithmetic above K = 64
    # (pivot rows Di R) stays at float32's accuracy against a float64
    # solve, as the library Cholesky does; the JAX kernel's pivot rows,
    # R - (D Di - Di) R, cancel there (found up to 1e-2 on ALS Gramians)
    A, b = _als_gramians(K, [20000, 9000, 300, 40], seed=K)
    x64 = np.linalg.solve(A, b[..., None])[..., 0]
    At, bt = torch.from_numpy(A.astype(np.float32)), torch.from_numpy(b.astype(np.float32))
    for solve in (torch_solve.gj_solve_wide_reference, torch_solve.cholesky_solve):
        x = solve(At, bt).double().numpy()
        err = np.abs(x - x64).max(axis=1) / np.abs(x64).max(axis=1)
        assert err.max() < 1e-4, (solve.__name__, err)


@pytest.mark.parametrize("K", [10, 264])
def test_off_grid_k_takes_cholesky(K):
    # K % 8 != 0 and K > 256 leave the Gauss-Jordan path in both packages
    A, b = _spd(9, K, seed=K)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    x = torch_solve.spd_solve(At, bt)
    assert torch.equal(x, torch_solve.cholesky_solve(At, bt))
    x_jax = np.asarray(jax_solve.spd_solve(jnp.asarray(A), jnp.asarray(b), method="pallas_interpret"))
    np.testing.assert_allclose(x.numpy(), x_jax, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("K", [8, 24])
def test_cholesky_matches_jax_cholesky(K):
    A, b = _spd(17, K, seed=100 + K)
    x = torch_solve.cholesky_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    x_jax = np.asarray(jax_solve.cholesky_solve(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x, x_jax, rtol=RTOL, atol=ATOL)


def test_plain_method_and_batch_dims():
    # "plain" takes the mirror on any device; leading dims are flattened
    A, b = _spd(12, 16, seed=3)
    At = torch.from_numpy(A).reshape(3, 4, 16, 16)
    bt = torch.from_numpy(b).reshape(3, 4, 16)
    x = torch_solve.spd_solve(At, bt, method="plain")
    assert x.shape == (3, 4, 16)
    expect = torch_solve.cholesky_solve(torch.from_numpy(A), torch.from_numpy(b))
    torch.testing.assert_close(x.reshape(12, 16), expect, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="method"):
        torch_solve.spd_solve(At, bt, method="pallas")

