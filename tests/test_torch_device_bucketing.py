"""The port's device bucketing and the rest of its ``ALSConfig``
(predictionio_tpu_torch/ops/als.py: ``build_buckets_device``,
``bucketing``, ``solver``, ``precision``, ``rank_pad_multiple``) against
its host bucketing and the JAX package's (predictionio_tpu/ops/als.py).

The device path runs here on CPU tensors (``device="cpu"``,
``bucketing="device"``), the torch code the card runs. Its buckets must
equal the host path's array by array, dtype and bits, and a train on
each path must give the same factor bits; they must also equal the JAX
package's ``build_buckets_device`` arrays. The cases of the JAX
package's ``TestDeviceBucketing`` (tests/test_als.py) run on the port's
functions. Factors held against JAX ``train_als`` start both packages
from the same injected factors and meet rtol 5e-3, atol 5e-4, the band of
the JAX package's cross-solver ALS check (``TestPallasSolver``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.ops import als as torch_als

RTOL, ATOL = 5e-3, 5e-4
CPU = torch.device("cpu")

# several normal widths and chunks, and hot rows in several groups
NUM_USERS, NUM_ITEMS, NNZ = 48, 32, 600
LAYOUT = dict(widths=(4, 8, 16), chunk_entries=1 << 7, hot_group_slots=4)


def _ratings(seed: int = 0):
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, NUM_ITEMS + 1) ** 0.8
    rows = rng.integers(0, NUM_USERS, NNZ)
    cols = rng.choice(NUM_ITEMS, NNZ, p=pop / pop.sum())
    vals = rng.integers(1, 11, NNZ).astype(np.float32) / 2.0
    return rows, cols, vals


def synthetic_ratings(num_users=60, num_items=40, rank=4, density=0.3, seed=0):
    """tests/test_als.py's ratings."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(num_users, rank)) / np.sqrt(rank)
    V = rng.normal(size=(num_items, rank)) / np.sqrt(rank)
    full = U @ V.T + 3.0
    mask = rng.random((num_users, num_items)) < density
    rows, cols = np.nonzero(mask)
    return rows, cols, full[rows, cols].astype(np.float32)


def _sides(rows, cols, vals, num_users=NUM_USERS, num_items=NUM_ITEMS):
    return {"user": (rows, cols, vals, num_users, num_items), "item": (cols, rows, vals, num_items, num_users)}


def _assert_same_buckets(got, want) -> None:
    """Every array of ``got`` equal to ``want``'s, dtype and bits."""
    assert (got.num_rows, got.num_cols, got.nnz, got.padded_nnz) == (
        want.num_rows, want.num_cols, want.nnz, want.padded_nnz
    )
    assert (len(got.normal), len(got.hot), len(got.hot_rows)) == (len(want.normal), len(want.hot), len(want.hot_rows))
    for g_ch, w_ch in zip(got.normal + got.hot, want.normal + want.hot):
        for g, w in zip(g_ch, w_ch):
            assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
    for g, w in zip(got.hot_rows, want.hot_rows):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _host(*args, **kw):
    b = torch_als.build_buckets(*args, **kw)
    return torch_als.to_device_buckets(b, CPU), torch_als.rated_row_mask(b)


@pytest.mark.parametrize("side", ["user", "item"])
def test_device_buckets_equal_host_buckets(side):
    args = _sides(*_ratings())[side]
    want, want_rated = _host(*args, **LAYOUT)
    got, rated = torch_als.build_buckets_device(*args, **LAYOUT, device=CPU)
    assert len(want.normal) >= 2 and len(want.hot) >= 1  # the layout this test is about
    _assert_same_buckets(got, want)
    np.testing.assert_array_equal(rated, want_rated)
    assert got.normal[0].row_id.dtype == torch.int64 and got.normal[0].idx.dtype == torch.int32


@pytest.mark.parametrize("side", ["user", "item"])
def test_device_buckets_equal_jax_device_buckets(side):
    args = _sides(*_ratings())[side]
    got, rated = torch_als.build_buckets_device(*args, **LAYOUT, device=CPU)
    ref, ref_rated = jax_als.build_buckets_device(*args, **LAYOUT)
    assert (got.nnz, got.padded_nnz) == (ref.nnz, ref.padded_nnz)
    assert (len(got.normal), len(got.hot)) == (len(ref.normal), len(ref.hot))
    for g_ch, r_ch in zip(got.normal + got.hot, ref.normal + ref.hot):
        for g, r in zip(g_ch, r_ch):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for g, r in zip(got.hot_rows, ref.hot_rows):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(rated, ref_rated)


def test_matches_host_bucketing_coverage():
    """TestDeviceBucketing.test_matches_host_bucketing_coverage, to the bit."""
    rows, cols, vals = synthetic_ratings(density=0.5)
    want, want_rated = _host(rows, cols, vals, 60, 40, widths=(4, 8))
    got, rated = torch_als.build_buckets_device(rows, cols, vals, 60, 40, widths=(4, 8), device=CPU)
    _assert_same_buckets(got, want)
    np.testing.assert_array_equal(rated, want_rated)


def test_device_bucketing_with_hot_groups():
    """TestDeviceBucketing.test_device_bucketing_with_hot_groups: 7 hot
    rows in groups of 3."""
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(7), 12).astype(np.int64)
    cols = rng.integers(0, 30, rows.size).astype(np.int64)
    vals = rng.uniform(1, 5, rows.size).astype(np.float32)
    want, _ = _host(rows, cols, vals, 7, 30, widths=(8,), hot_group_slots=3)
    got, _ = torch_als.build_buckets_device(rows, cols, vals, 7, 30, widths=(8,), hot_group_slots=3, device=CPU)
    assert len(got.hot) == 3 and [int(h.shape[0]) - 1 for h in got.hot_rows] == [3, 3, 1]
    _assert_same_buckets(got, want)


def test_tensor_input_equals_numpy_input():
    rows, cols, vals = _ratings()
    want, want_rated = torch_als.build_buckets_device(rows, cols, vals, NUM_USERS, NUM_ITEMS, **LAYOUT, device=CPU)
    for dtype in (torch.int32, torch.int64):
        tensors = (torch.from_numpy(rows).to(dtype), torch.from_numpy(cols).to(dtype), torch.from_numpy(vals))
        got, rated = torch_als.build_buckets_device(*tensors, NUM_USERS, NUM_ITEMS, **LAYOUT)
        _assert_same_buckets(got, want)
        np.testing.assert_array_equal(rated, want_rated)


def test_device_arrays_validated_on_device():
    """TestDeviceBucketing.test_device_arrays_validated_on_device: negative
    and too-large tensor indices raise before anything indexes with them."""
    vals = torch.tensor([1.0, 2.0])
    with pytest.raises(ValueError, match="row index out of range"):
        torch_als.build_buckets_device(torch.tensor([0, -1]), torch.tensor([0, 1]), vals, 4, 3)
    with pytest.raises(ValueError, match="row index out of range"):
        torch_als.build_buckets_device(torch.tensor([0, 4]), torch.tensor([0, 1]), vals, 4, 3)
    with pytest.raises(ValueError, match="column index out of range"):
        torch_als.build_buckets_device(torch.tensor([0, 1]), torch.tensor([0, 7]), vals, 4, 3)
    with pytest.raises(ValueError, match="column index out of range"):
        torch_als.build_buckets_device(torch.tensor([0, 1]), torch.tensor([-2, 1]), vals, 4, 3)
    with pytest.raises(ValueError, match="equal length"):
        torch_als.build_buckets_device(torch.tensor([0, 1]), torch.tensor([0]), vals, 4, 3)


def test_numpy_indices_validated_before_the_int32_cast():
    # 2**32 would wrap to row 0 in int32
    with pytest.raises(ValueError, match="row index out of range"):
        torch_als.build_buckets_device(np.array([0, 2**32]), np.array([0, 1]), np.ones(2, np.float32), 4, 3,
                                       device=CPU)
    with pytest.raises(ValueError, match="column index out of range"):
        torch_als.train_als(np.array([0, 1]), np.array([0, 2**32 + 1]), np.ones(2, np.float32), 4, 3,
                            torch_als.ALSConfig(bucketing="device"), device=CPU)


@pytest.mark.parametrize("as_tensors", [False, True], ids=["numpy", "tensors"])
def test_empty_ratings_fall_back(as_tensors):
    """TestDeviceBucketing.test_empty_ratings_fall_back."""
    coo = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32))
    if as_tensors:
        coo = tuple(torch.from_numpy(a) for a in coo)
    b, rated = torch_als.build_buckets_device(*coo, 4, 3, device=CPU)
    assert b.nnz == 0 and b.padded_nnz == 0 and not rated.any() and rated.shape == (4,)
    assert b.normal == b.hot == b.hot_rows == ()


def test_int32_overflow_takes_the_host_path(monkeypatch):
    """More ratings or rows than int32 indexes go to the host path, the
    reference's rule (here with the limit lowered)."""
    rows, cols, vals = _ratings()
    calls = []
    real = torch_als.build_buckets
    monkeypatch.setattr(torch_als, "build_buckets", lambda *a, **k: calls.append(a[3]) or real(*a, **k))
    want, _ = _host(rows, cols, vals, NUM_USERS, NUM_ITEMS, **LAYOUT)
    for limit in (NNZ, NUM_USERS):
        monkeypatch.setattr(torch_als, "_INT32_LIMIT", limit)
        got, _ = torch_als.build_buckets_device(rows, cols, vals, NUM_USERS, NUM_ITEMS, **LAYOUT, device=CPU)
        _assert_same_buckets(got, want)
    assert len(calls) == 3  # _host's own call and one for each limit


@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
def test_train_on_each_bucketing_path_gives_the_same_bits(implicit):
    """TestDeviceBucketing.test_train_with_device_bucketing_matches_host,
    to the bit: the two paths hand the sweep equal arrays."""
    rows, cols, vals = _ratings()
    cfg = torch_als.ALSConfig(rank=16, iterations=3, seed=5, implicit=implicit, alpha=2.0, bucket_widths=(4, 8, 16),
                              chunk_entries=1 << 7, hot_group_slots=4)
    host = torch_als.train_als(rows, cols, vals, NUM_USERS, NUM_ITEMS, dataclasses.replace(cfg, bucketing="host"),
                               device=CPU)
    dev = torch_als.train_als(rows, cols, vals, NUM_USERS, NUM_ITEMS, dataclasses.replace(cfg, bucketing="device"),
                              device=CPU)
    assert torch.equal(host.user, dev.user) and torch.equal(host.item, dev.item)


def test_auto_buckets_on_the_host_on_the_cpu_and_device_forces_it(monkeypatch):
    """"auto" keeps the host path off the card (the JAX package on its CPU
    backend); "device" takes build_buckets_device for both sides; a mesh
    keeps host buckets whatever the setting."""
    from predictionio_tpu_torch.controller.context import mesh_context
    from predictionio_tpu_torch.parallel import sharding

    rows, cols, vals = synthetic_ratings()
    calls = []
    real = torch_als.build_buckets_device
    monkeypatch.setattr(torch_als, "build_buckets_device", lambda *a, **k: calls.append(a[3]) or real(*a, **k))
    cfg = torch_als.ALSConfig(rank=8, iterations=1)
    torch_als.train_als(rows, cols, vals, 60, 40, cfg, device=CPU)
    assert calls == []
    torch_als.train_als(rows, cols, vals, 60, 40, dataclasses.replace(cfg, bucketing="device"), device=CPU)
    assert calls == [60, 40]
    with sharding.local_devices([CPU] * 2):
        mesh = mesh_context((2, 1)).mesh
    torch_als.train_als(rows, cols, vals, 60, 40, dataclasses.replace(cfg, bucketing="device"), mesh=mesh)
    assert calls == [60, 40]


# ---------------------------------------------------------------------------
# The three other knobs, against JAX train_als
# ---------------------------------------------------------------------------


def _train(module, rows, cols, vals, config: dict):
    if module is torch_als:
        return torch_als.train_als(rows, cols, vals, 60, 40, torch_als.ALSConfig(**config), device=CPU)
    return jax_als.train_als(rows, cols, vals, 60, 40, jax_als.ALSConfig(**config))


@pytest.mark.parametrize("module", [jax_als, torch_als], ids=["jax", "port"])
@pytest.mark.parametrize("knob, bad", [("precision", "bf16"), ("solver", "qr"), ("bucketing", "gpu")])
def test_invalid_knob_rejected(module, knob, bad):
    """test_invalid_precision_rejected, TestPallasSolver.test_invalid_solver_rejected
    and TestDeviceBucketing.test_invalid_bucketing_rejected, on both packages."""
    rows, cols, vals = synthetic_ratings()
    with pytest.raises(ValueError, match=f"ALSConfig.{knob} must be"):
        _train(module, rows, cols, vals, {knob: bad})


def test_train_with_pallas_interpret_matches_cholesky():
    """TestPallasSolver.test_train_with_pallas_interpret_matches_cholesky
    with the port's solvers: the plain Gauss-Jordan mirror against
    Cholesky."""
    rows, cols, vals = synthetic_ratings()
    ref = _train(torch_als, rows, cols, vals, dict(rank=8, iterations=3, solver="cholesky"))
    got = _train(torch_als, rows, cols, vals, dict(rank=8, iterations=3, solver="pallas_interpret"))
    torch.testing.assert_close(got.user, ref.user, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got.item, ref.item, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("solver, method", [
    ("auto", "auto"), ("cholesky", "cholesky"), ("pallas_interpret", "plain"),
])
def test_solver_reaches_spd_solve(monkeypatch, solver, method):
    rows, cols, vals = synthetic_ratings()
    methods = set()
    real = torch_als.spd_solve
    monkeypatch.setattr(torch_als, "spd_solve", lambda A, b, method: methods.add(method) or real(A, b, method))
    _train(torch_als, rows, cols, vals, dict(rank=8, iterations=1, solver=solver))
    assert methods == {method}


def test_pallas_solver_raises_on_the_cpu():
    # the kernel never quietly becomes its plain mirror
    rows, cols, vals = synthetic_ratings()
    with pytest.raises(ValueError, match="launches the CUDA kernel"):
        _train(torch_als, rows, cols, vals, dict(rank=8, iterations=1, solver="pallas"))


@pytest.mark.parametrize("knobs", [
    dict(rank=10, rank_pad_multiple=8),
    dict(rank=8, precision="high"),
    dict(rank=8, precision="default"),
    dict(rank=8, solver="cholesky"),
], ids=["rank_pad_multiple", "precision_high", "precision_default", "cholesky"])
def test_knobs_match_jax(knobs):
    """Each knob's train against JAX ``train_als`` with the same knob, from
    the same injected factors at the padded width (rank 10 with
    ``rank_pad_multiple=8`` trains at K = 16 in both)."""
    rows, cols, vals = synthetic_ratings()
    k = 16 if knobs.get("rank_pad_multiple") else knobs["rank"]
    rng = np.random.default_rng(3)
    iu = np.abs(rng.normal(size=(60, k))).astype(np.float32) / np.sqrt(k)
    ii = np.abs(rng.normal(size=(40, k))).astype(np.float32) / np.sqrt(k)
    cfg = dict(iterations=3, reg=0.1, **knobs)
    got = torch_als.train_als(rows, cols, vals, 60, 40, torch_als.ALSConfig(**cfg), init_user=iu, init_item=ii,
                              device=CPU)
    ref = jax_als.train_als(rows, cols, vals, 60, 40, jax_als.ALSConfig(**cfg), init_user=iu, init_item=ii)
    assert got.user.shape == np.asarray(ref.user).shape == (60, k)
    np.testing.assert_allclose(got.user.numpy(), np.asarray(ref.user), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.item.numpy(), np.asarray(ref.item), rtol=RTOL, atol=ATOL)


def test_rank_pad_multiple_takes_the_gauss_jordan_path(monkeypatch):
    rows, cols, vals = synthetic_ratings()
    widths = []
    real = torch_als.spd_solve
    monkeypatch.setattr(torch_als, "spd_solve", lambda A, b, method: widths.append(A.shape[-1]) or real(A, b, method))
    got = _train(torch_als, rows, cols, vals, dict(rank=10, iterations=1, rank_pad_multiple=8))
    assert set(widths) == {16} and got.user.shape == (60, 16)
    cfg = torch_als.ALSConfig(rank=10, rank_pad_multiple=8)
    assert torch_als.planned_solves(rows, 60, cfg) + torch_als.planned_solves(cols, 40, cfg) == len(widths)


@pytest.mark.parametrize("precision, mapped", [("highest", "highest"), ("high", "high"), ("default", "medium")])
@pytest.mark.parametrize("prior", ["highest", "high", "medium"])
def test_precision_is_restored(precision, mapped, prior):
    """The sweep's matmul settings come back as they were, whether the
    block returns or raises, from every prior setting."""
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(prior)
        before = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
        with torch_als._matmul_precision(precision, cuda=True):
            assert torch.get_float32_matmul_precision() == mapped
            assert torch.backends.cuda.matmul.allow_tf32 is (mapped != "highest")
        assert (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32) == before
        with pytest.raises(RuntimeError, match="boom"):
            with torch_als._matmul_precision(precision, cuda=True):
                raise RuntimeError("boom")
        assert (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32) == before
        rows, cols, vals = synthetic_ratings()
        _train(torch_als, rows, cols, vals, dict(rank=8, iterations=1, precision=precision))
        assert (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32) == before
    finally:
        torch.set_float32_matmul_precision(saved)

