"""The port's graft entry points (``__graft_entry_torch__.py``) against the
reference's (``__graft_entry__.py``).

``entry(device="cpu")`` draws the reference's arrays and gives the
reference ``entry()``'s top-10 ids exactly and its values within rtol
1e-5. ``dryrun_multichip(2|4, device="cpu")`` trains on ``(1, 2)`` and
``(2, 2)`` meshes of CPU positions with the reference's shapes and
settings, and its explicit ALS sweep's train RMSE is within 1e-5
(relative) of one CPU device's train on the same ratings. ``entry()``
with no device raises where there is no card.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as reference
import __graft_entry_torch__ as port
from predictionio_tpu_torch.ops.als import ALSConfig, train_als

RMSE_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the mesh's positions take turns on the CPU,
    and with a thread a core in every test worker the trains here slowed
    twenty-fold beside the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rmse(factors, rows, cols, vals) -> float:
    u = factors.user.detach().cpu().numpy().astype(np.float64)
    v = factors.item.detach().cpu().numpy().astype(np.float64)
    err = np.einsum("ij,ij->i", u[rows], v[cols]) - vals
    return float(np.sqrt(np.mean(err * err)))


def test_entry_matches_the_reference_on_its_arrays():
    ref_forward, ref_args = reference.entry()
    forward, args = port.entry(device="cpu")
    for got, want in zip(args, ref_args):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert all(a.device.type == "cpu" for a in args)
    ref_ids, ref_values = (np.asarray(x) for x in ref_forward(*ref_args))
    ids, values = forward(*args)
    assert ids.shape == (64, 10) and values.shape == (64, 10)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    np.testing.assert_allclose(values.numpy(), ref_values, rtol=1e-5)


def test_entry_without_a_device_raises_where_there_is_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port.entry()
    with pytest.raises(RuntimeError, match="is_available"):
        port.dryrun_multichip(2)


def test_dryrun_ratings_are_the_references_draws():
    rows, cols, vals, num_users, num_items = port.dryrun_ratings()
    rng = np.random.default_rng(0)
    assert np.array_equal(rows, rng.integers(0, 2048, size=100_000))
    w = 1.0 / np.arange(1, 1025) ** 0.8
    assert np.array_equal(cols, rng.choice(1024, size=100_000, p=w / w.sum()))
    assert np.array_equal(vals, rng.uniform(1, 5, size=100_000).astype(np.float32))
    assert (num_users, num_items) == (2048, 1024)


@pytest.fixture(scope="module")
def single_device_rmse():
    rows, cols, vals, num_users, num_items = port.dryrun_ratings()
    factors = train_als(rows, cols, vals, num_users, num_items, ALSConfig(**port.DRYRUN_ALS), device="cpu")
    return rmse(factors, rows, cols, vals)


@pytest.mark.parametrize("n, mesh", [(2, {"data": 1, "model": 2}), (4, {"data": 2, "model": 2})])
def test_dryrun_multichip_on_cpu_positions(n, mesh, single_device_rmse, capsys):
    got = port.dryrun_multichip(n, device="cpu")
    assert got["mesh"] == mesh
    assert f"dryrun_multichip OK on {n} positions of cpu" in capsys.readouterr().out
    for factors in got["als"].values():
        assert tuple(factors.user.shape) == (2048, 16) and tuple(factors.item.shape) == (1024, 16)
        assert torch.isfinite(factors.user).all() and torch.isfinite(factors.item).all()
    assert got["two_tower"].item_vecs.shape == (1024, 16) and np.isfinite(got["two_tower"].item_vecs).all()
    rows, cols, vals, _, _ = port.dryrun_ratings()
    assert rmse(got["als"]["explicit"], rows, cols, vals) == pytest.approx(single_device_rmse, rel=RMSE_RTOL)
