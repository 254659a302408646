"""The port's training mesh (ops/als.py and ops/twotower.py with
``mesh=``, controller/context.py's ``mesh_context``, utils/checkpoint.py)
against the JAX package's.

The JAX side runs on its 8 host devices (tests/conftest.py), the port on
``sharding.local_devices(["cpu"] * 8)``. Both start from the same
injected factors (``jax.random``'s draw cannot be replayed in torch).
ALS factors are held at rtol 1e-4, atol 1e-5 on the four mesh shapes the
JAX package's own tests use (tests/test_als.py, tests/test_sharded.py),
on their data (rank 4, so both packages solve by Cholesky; rank 8, so the
port's Gauss-Jordan path runs on every mesh position, against the
single-device port run). Two-Tower towers at rtol 1e-3, atol 1e-4
(tests/test_twotower.py's band) on the four shapes against the JAX
package's towers, one batch an epoch, so the JAX and the port
permutations give the same batches.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.controller.context import mesh_context as jax_mesh_context
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops import twotower as jax_tt
from predictionio_tpu_torch.controller import mesh_context
from predictionio_tpu_torch.ops import als as torch_als
from predictionio_tpu_torch.ops import twotower as torch_tt
from predictionio_tpu_torch.parallel import sharding
from predictionio_tpu_torch.utils.checkpoint import CheckpointManager

MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]
RTOL, ATOL = 1e-4, 1e-5


def synthetic_ratings(num_users=60, num_items=40, rank=4, density=0.3, seed=0):
    """tests/test_als.py's synthetic_ratings."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(num_users, rank)) / np.sqrt(rank)
    V = rng.normal(size=(num_items, rank)) / np.sqrt(rank)
    full = U @ V.T + 3.0
    mask = rng.random((num_users, num_items)) < density
    rows, cols = np.nonzero(mask)
    return rows, cols, full[rows, cols].astype(np.float32)


def inits(num_users, num_items, rank, seed=1):
    rng = np.random.default_rng(seed)
    iu = np.abs(rng.normal(size=(num_users, rank))).astype(np.float32) / np.sqrt(rank)
    ii = np.abs(rng.normal(size=(num_items, rank))).astype(np.float32) / np.sqrt(rank)
    return iu, ii


def port_mesh(shape):
    with sharding.local_devices(["cpu"] * 8):
        return mesh_context(shape).mesh


@pytest.fixture(scope="module")
def ratings():
    return synthetic_ratings()


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_als_mesh_matches_jax_mesh(ratings, shape):
    rows, cols, vals = ratings
    iu, ii = inits(60, 40, 4)
    jcfg = jax_als.ALSConfig(rank=4, iterations=4, seed=5)
    ref = jax_als.train_als(rows, cols, vals, 60, 40, jcfg, mesh=jax_mesh_context(axis_sizes=shape).mesh,
                            init_user=iu, init_item=ii)
    got = torch_als.train_als(rows, cols, vals, 60, 40, torch_als.ALSConfig(rank=4, iterations=4, seed=5),
                              init_user=iu, init_item=ii, mesh=port_mesh(shape))
    np.testing.assert_allclose(got.user.numpy(), np.asarray(ref.user), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.item.numpy(), np.asarray(ref.item), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_als_mesh_runs_the_solve_kernel_path_on_every_position(shape, monkeypatch):
    """Rank 8 on rank-8 data: every position's batch goes to the
    Gauss-Jordan path (its plain version on the CPU), as many batches as
    the mesh plan says, and the factors are the single-device port's.
    λ 1.0 keeps the normal equations well conditioned: at λ 0.1 a
    Cholesky solve alone moves these factors by 7e-4, so the mesh's other
    order of the Gramians' sums would be held to noise."""
    rows, cols, vals = synthetic_ratings(rank=8)
    iu, ii = inits(60, 40, 8)
    cfg = torch_als.ALSConfig(rank=8, iterations=4, seed=5, reg=1.0)
    single = torch_als.train_als(rows, cols, vals, 60, 40, cfg, init_user=iu, init_item=ii, device="cpu")
    calls = []
    real = torch_als.spd_solve
    monkeypatch.setattr(torch_als, "spd_solve", lambda A, b, method: calls.append(A.shape) or real(A, b, method))
    got = torch_als.train_als(rows, cols, vals, 60, 40, cfg, init_user=iu, init_item=ii, mesh=port_mesh(shape))
    np.testing.assert_allclose(got.user.numpy(), single.user.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.item.numpy(), single.item.numpy(), rtol=RTOL, atol=ATOL)
    plan = cfg.iterations * (torch_als.planned_solves(rows, 60, cfg, data=shape[0])
                             + torch_als.planned_solves(cols, 40, cfg, data=shape[0]))
    assert len(calls) == plan and all(s[-1] == 8 for s in calls)


def test_one_position_mesh_is_the_single_device_path(ratings):
    rows, cols, vals = ratings
    cfg = torch_als.ALSConfig(rank=8, iterations=2, seed=5)
    single = torch_als.train_als(rows, cols, vals, 60, 40, cfg, device="cpu")
    with sharding.local_devices(["cpu"]):
        ctx = mesh_context()
    assert not ctx.has_mesh and ctx.mesh.size == 1
    got = torch_als.train_als(rows, cols, vals, 60, 40, cfg, mesh=ctx.mesh)
    np.testing.assert_array_equal(got.user.numpy(), single.user.numpy())
    assert torch_als.planned_solves(rows, 60, cfg, data=1) == torch_als.planned_solves(rows, 60, cfg)


def test_each_position_holds_only_its_part_of_the_tables(ratings):
    rows, cols, vals = ratings
    seen = {}

    def on_sweep(step, user, item):
        seen[step] = (sharding.per_device_bytes(user), sharding.per_device_bytes(item), len(user.shards))

    torch_als.train_als(rows, cols, vals, 60, 40, torch_als.ALSConfig(rank=8, iterations=2),
                        mesh=port_mesh((2, 4)), on_sweep=on_sweep)
    assert seen[1] == (sharding.sharded_table_bytes(61, 8, 4), sharding.sharded_table_bytes(41, 8, 4), 4)


def test_model_axis_beyond_one_process_raises():
    with sharding.local_devices(["cpu"] * 4), pytest.raises(ValueError, match="at most 4"):
        mesh_context((1, 8))
    with sharding.local_devices(["cpu"] * 8), pytest.raises(ValueError, match="need 4 positions"):
        mesh_context((2, 2))


# ---------------------------------------------------------------------------
# Step checkpoints (tests/test_checkpoint_and_profiling.py's cases)
# ---------------------------------------------------------------------------


def synthetic(seed=0):
    """tests/test_checkpoint_and_profiling.py's data."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(40, 4))
    V = rng.normal(size=(30, 4))
    full = U @ V.T / 2 + 3
    mask = rng.random((40, 30)) < 0.4
    rows, cols = np.nonzero(mask)
    return rows, cols, full[rows, cols].astype(np.float32)


@pytest.mark.parametrize("rank", [4, 8])
def test_resume_matches_uninterrupted(tmp_path, rank):
    rows, cols, vals = synthetic()
    base = torch_als.train_als(rows, cols, vals, 40, 30, torch_als.ALSConfig(rank=rank, iterations=6, seed=1),
                               device="cpu")
    ckpt = str(tmp_path / "ck")
    cfg = dict(rank=rank, seed=1, checkpoint_dir=ckpt, checkpoint_interval=2)
    torch_als.train_als(rows, cols, vals, 40, 30, torch_als.ALSConfig(iterations=4, **cfg), device="cpu")
    assert CheckpointManager(ckpt).all_steps() == [2, 4]
    sweeps = []
    resumed = torch_als.train_als(rows, cols, vals, 40, 30, torch_als.ALSConfig(iterations=6, **cfg),
                                  device="cpu", on_sweep=lambda step, u, v: sweeps.append(step))
    assert sweeps == [4, 5]
    np.testing.assert_allclose(base.user.numpy(), resumed.user.numpy(), rtol=1e-5, atol=1e-6)


def test_checkpoint_restores_across_mesh_shapes(tmp_path):
    """A run checkpointed on (4, 2) resumes on (2, 4) and on no mesh: the
    step is held at the canonical (rows + 1, K) shape."""
    rows, cols, vals = synthetic()
    ckpt = str(tmp_path / "ck_mesh")
    cfg = torch_als.ALSConfig(rank=4, iterations=4, seed=1, checkpoint_dir=ckpt, checkpoint_interval=2)
    torch_als.train_als(rows, cols, vals, 40, 30, cfg, mesh=port_mesh((4, 2)))
    on_b = torch_als.train_als(rows, cols, vals, 40, 30, cfg, mesh=port_mesh((2, 4)))
    single = torch_als.train_als(rows, cols, vals, 40, 30, cfg, device="cpu")
    np.testing.assert_array_equal(on_b.user.numpy(), single.user.numpy())
    # resumed to 6 sweeps on (2, 4) against an uninterrupted 6 on (4, 2)
    six = dict(rank=4, iterations=6, seed=1)
    resumed = torch_als.train_als(rows, cols, vals, 40, 30,
                                  torch_als.ALSConfig(checkpoint_dir=ckpt, checkpoint_interval=2, **six),
                                  mesh=port_mesh((2, 4)))
    whole = torch_als.train_als(rows, cols, vals, 40, 30, torch_als.ALSConfig(**six), mesh=port_mesh((4, 2)))
    np.testing.assert_allclose(resumed.user.numpy(), whole.user.numpy(), rtol=RTOL, atol=ATOL)


def test_checkpoint_steps_recorded_and_half_written_steps_ignored(tmp_path):
    rows, cols, vals = synthetic()
    ckpt = tmp_path / "ck2"
    torch_als.train_als(rows, cols, vals, 40, 30,
                        torch_als.ALSConfig(rank=4, iterations=5, checkpoint_dir=str(ckpt), checkpoint_interval=2),
                        device="cpu")
    m = CheckpointManager(str(ckpt))
    assert m.latest_step() == 5 and m.all_steps() == [2, 4, 5]
    state = m.restore()
    assert state["user"].shape == (41, 4)  # includes the sentinel row
    (ckpt / "9").mkdir()  # a step directory without its metadata
    (ckpt / ".tmp-7").mkdir()  # a save cut short
    assert m.latest_step() == 5
    with pytest.raises(ValueError, match="expected"):
        m.restore(like={"user": torch.empty(40, 4)})


# ---------------------------------------------------------------------------
# Two-Tower
# ---------------------------------------------------------------------------


def test_sharded_lookup_values_and_gradient_layout():
    mesh = sharding.ServingMesh([torch.device("cpu")] * 4)
    rng = np.random.default_rng(3)
    table = rng.normal(size=(10, 6)).astype(np.float32)
    st = sharding.shard_table(table, mesh)  # 4 shards of 3 rows, 2 padding
    for s in st.shards:
        s.requires_grad_(True)
    ids = torch.tensor([0, 9, 4, 4, 7])
    out = torch_tt.sharded_embedding_lookup(st, ids)
    np.testing.assert_array_equal(out.detach().numpy(), table[ids.numpy()])
    weights = torch.arange(30, dtype=torch.float32).view(5, 6)
    grads = torch.autograd.grad((out * weights).sum(), st.shards)
    assert [tuple(g.shape) for g in grads] == [(3, 6)] * 4  # every shard's gradient is its own rows
    dense = torch.zeros(12, 6).index_add_(0, ids, weights)
    np.testing.assert_array_equal(torch.cat(grads).numpy(), dense.numpy())
    plain = torch.from_numpy(table).requires_grad_(True)
    assert torch_tt.sharded_embedding_lookup(plain, ids).shape == (5, 6)


TT_KW = dict(dim=16, batch_size=128, epochs=3, learning_rate=0.05, seed=1, gemm_dtype="float32")


@pytest.fixture(scope="module")
def two_tower_case():
    """The pairs, the initial towers and the JAX package's towers, shared
    by the mesh shapes: its single-device train, which its own mesh
    trains equal (tests/test_twotower.py; 3e-7 apart on these inputs),
    each of those taking 2.5 s of XLA compiles here."""
    rng = np.random.default_rng(5)
    num_users, num_items, n = 60, 30, 128
    rows = rng.integers(0, num_users, n)
    cols = rng.integers(0, num_items, n)
    iu = (rng.normal(size=(num_users, 16)) / 4).astype(np.float32)
    ii = (rng.normal(size=(num_items, 16)) / 4).astype(np.float32)
    ref = jax_tt.train_two_tower(rows, cols, num_users, num_items, jax_tt.TwoTowerConfig(**TT_KW),
                                 init_user=iu, init_item=ii)
    return (rows, cols, num_users, num_items, iu, ii), ref


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_two_tower_mesh_matches_jax(two_tower_case, shape):
    (rows, cols, num_users, num_items, iu, ii), ref = two_tower_case
    got = torch_tt.train_two_tower(rows, cols, num_users, num_items, torch_tt.TwoTowerConfig(**TT_KW),
                                   init_user=iu, init_item=ii, mesh=port_mesh(shape))
    np.testing.assert_allclose(got.user_vecs, ref.user_vecs, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.item_vecs, ref.item_vecs, rtol=1e-3, atol=1e-4)
    assert [s for s, _ in got.loss_history] == [s for s, _ in ref.loss_history]
    np.testing.assert_allclose([v for _, v in got.loss_history], [v for _, v in ref.loss_history], rtol=1e-4)


def test_two_tower_mesh_takes_the_unfused_loss(monkeypatch):
    """On the mesh the fused CE is off whatever the config says (the
    reference's mesh path stays XLA); bf16 logit products as on one device."""
    def boom(*a, **k):
        raise AssertionError("the fused loss ran on the mesh")

    monkeypatch.setattr(torch_tt, "fused_inbatch_ce", boom)
    rng = np.random.default_rng(2)
    rows, cols = rng.integers(0, 40, 64), rng.integers(0, 20, 64)
    cfg = torch_tt.TwoTowerConfig(dim=16, batch_size=32, epochs=2, seed=3, gemm_dtype="bfloat16",
                                  fused_ce="interpret")
    single = torch_tt.train_two_tower(rows, cols, 40, 20, torch_tt.TwoTowerConfig(
        **{**cfg.__dict__, "fused_ce": "off"}), device="cpu")
    got = torch_tt.train_two_tower(rows, cols, 40, 20, cfg, mesh=port_mesh((2, 4)))
    np.testing.assert_allclose([v for _, v in got.loss_history], [v for _, v in single.loss_history], rtol=1e-3)
