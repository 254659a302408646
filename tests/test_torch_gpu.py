"""Tests of the port that need an NVIDIA card (``gpu`` marker), and the
device rule they rest on. This file imports neither ``jax`` nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Whether there is a card is decided inside the ``cuda_device`` fixture,
never at import, so every test is collected the same way everywhere; on
a machine without CUDA the card tests skip.

Tolerances: the CUDA kernels (one warp per system for K <= 64, one block
per system above) against the plain Gauss-Jordan mirror at
rtol 5e-4, atol 5e-5 (the JAX package's interpret-vs-Cholesky band,
tests/test_als.py); ALS on the card against ALS on the CPU at rtol 5e-3,
atol 5e-4 (its cross-solver ALS band), since the kernel and the mirror
eliminate in different orders and ``index_add_`` on CUDA sums in no
fixed order.

The fused-CE kernels against their plain versions on the same card: row
sums at most 2e-3 relative and 5e-5 on average, gradient passes atol
5e-3·max|ref|. The kernel sums each logit's dot product on the tensor
cores, cuBLAS in f32 in another order; a logit that lies on a bf16 rounding boundary
then rounds to the other neighbour, which moves its exponential by up to
exp(2^-4) - 1 = 6.5 % where |logit| < 16, and at D <= 32 one exponential can
carry a good part of its row's sum (found: 1.1e-3 at [256,16], 2.3e-7 at
[8192,64]); the loss and
gradients of ``fused_inbatch_ce`` against the plain versions at the JAX
package's on-TPU bar (loss 5e-3·max(1,|ref|), gradients rtol 5e-2, atol
5e-3·max|ref|, tests/test_pallas_tpu.py). Two-Tower training on the card
against the CPU: loss history rtol 1e-3, and 99 % of the table entries
within 1e-3 — adam's first steps move an entry by about ``lr·sign(g)``,
so an entry whose gradient is near zero may land up to ``2·lr`` away.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops import als as torch_als
from predictionio_tpu_torch.ops import fused_ce as torch_fused_ce
from predictionio_tpu_torch.ops import solve as torch_solve
from predictionio_tpu_torch.ops import twotower as torch_tt
from predictionio_tpu_torch.templates import twotower as tt_engine
from predictionio_tpu_torch.templates.recommendation.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    Query,
    TrainingData,
)

SOLVE_RTOL, SOLVE_ATOL = 5e-4, 5e-5
ALS_RTOL, ALS_ATOL = 5e-3, 5e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda", 0)


def _spd(B: int, K: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, K, K)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1) + 5 * np.eye(K, dtype=np.float32)
    b = rng.normal(size=(B, K)).astype(np.float32)
    return A, b


def _ratings(num_users=48, num_items=32, nnz=600, seed=0):
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, num_items + 1) ** 0.8
    rows = rng.integers(0, num_users, nnz)
    cols = rng.choice(num_items, nnz, p=pop / pop.sum())
    vals = rng.integers(1, 11, nnz).astype(np.float32) / 2.0
    return rows, cols, vals


def test_resolve_device_gives_the_cpu_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_asking_for_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device(device)
    with pytest.raises(RuntimeError):
        ALSAlgorithm(ALSAlgorithmParams())


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,K",
    [
        # the one-warp-per-system kernel at every width; B = 1, B below a
        # block's 4 warps, and B = 2049, a ragged last round of the grid
        (5, 8), (257, 16), (100, 24), (1, 32), (3, 40), (50, 48), (40, 56),
        (1000, 64), (1, 64), (3, 64), (2049, 64),
        # the one-block-per-system kernel: its first width, shared memory
        # to K = 128, device scratch above
        (130, 72), (300, 128), (33, 136), (20, 256),
    ],
)
def test_kernel_matches_plain_on_card(cuda_device, B, K):
    A, b = _spd(B, K, seed=K)
    At, bt = torch.from_numpy(A).to(cuda_device), torch.from_numpy(b).to(cuda_device)
    before = torch_solve.gj_solve_cuda.launches
    x = torch_solve.gj_solve_cuda(At, bt)
    torch.cuda.synchronize()
    assert torch_solve.gj_solve_cuda.launches == before + 1
    torch.testing.assert_close(x, torch_solve.gj_solve_reference(At, bt), rtol=SOLVE_RTOL, atol=SOLVE_ATOL)
    torch.testing.assert_close(x, torch_solve.cholesky_solve(At, bt), rtol=SOLVE_RTOL, atol=SOLVE_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [64, 128])
def test_kernel_is_deterministic_on_card(cuda_device, K):
    A, b = _spd(2049, K, seed=3 * K)
    At, bt = torch.from_numpy(A).to(cuda_device), torch.from_numpy(b).to(cuda_device)
    first = torch_solve.gj_solve_cuda(At, bt)
    second = torch_solve.gj_solve_cuda(At, bt)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [64, 128])
def test_kernel_runs_on_the_current_stream(cuda_device, K):
    A, b = _spd(700, K, seed=K + 1)
    At, bt = torch.from_numpy(A).to(cuda_device), torch.from_numpy(b).to(cuda_device)
    want = torch_solve.gj_solve_cuda(At, bt)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = torch_solve.gj_solve_cuda(At, bt)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_takes_views_at_any_offset(cuda_device):
    """The warp kernel copies 16-byte chunks; views that start 4 bytes
    into their storage give the same bits as aligned tensors."""
    B, K = 37, 64
    A, b = _spd(B, K, seed=11)
    At, bt = torch.from_numpy(A).to(cuda_device), torch.from_numpy(b).to(cuda_device)
    A_off = torch.empty(B * K * K + 1, device=cuda_device)[1:].view(B, K, K).copy_(At)
    b_off = torch.empty(B * K + 1, device=cuda_device)[1:].view(B, K).copy_(bt)
    assert A_off.data_ptr() % 16 and b_off.data_ptr() % 16
    got = torch_solve.gj_solve_cuda(A_off, b_off)
    torch.cuda.synchronize()
    assert torch.equal(got, torch_solve.gj_solve_cuda(At, bt))


@pytest.mark.gpu
def test_kernel_plan_on_card(cuda_device):
    warp = torch_solve.gj_solve_plan(32768, 64, cuda_device)
    assert warp["kernel"] == "warp" and warp["threads_per_block"] == 128
    assert warp["smem_per_block"] == 4 * 4 * (64 * 68 + 64 + 2 * 68)
    assert warp["blocks_per_sm"] >= 1 and warp["warps_per_sm"] == 4 * warp["blocks_per_sm"]
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert warp["grid"] == min(warp["blocks_per_sm"] * sms, 32768 // 4)
    assert torch_solve.gj_solve_plan(3, 64, cuda_device)["grid"] == 1
    block = torch_solve.gj_solve_plan(50, 72, cuda_device)
    assert block["kernel"] == "block" and block["threads_per_block"] == 256 and block["grid"] == 50
    assert block["smem_per_block"] == 4 * 72 * 73
    assert torch_solve.gj_solve_plan(50, 256, cuda_device)["smem_per_block"] == 0


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    A, b = _spd(4, 16, seed=1)
    At, bt = torch.from_numpy(A).to(cuda_device), torch.from_numpy(b).to(cuda_device)
    with pytest.raises(ValueError):
        torch_solve.gj_solve_cuda(At[:, :, :-1].contiguous(), bt)
    with pytest.raises(TypeError):
        torch_solve.gj_solve_cuda(At.double(), bt.double())
    with pytest.raises(ValueError, match="contiguous"):
        torch_solve.gj_solve_cuda(At.transpose(1, 2), bt)
    with pytest.raises(ValueError, match="one CUDA device"):
        torch_solve.gj_solve_cuda(At, bt.cpu())
    A10, b10 = _spd(4, 10, seed=2)
    with pytest.raises(ValueError, match="multiple of 8"):
        torch_solve.gj_solve_cuda(torch.from_numpy(A10).to(cuda_device), torch.from_numpy(b10).to(cuda_device))
    before = torch_solve.gj_solve_cuda.launches
    empty = torch_solve.gj_solve_cuda(At[:0], bt[:0])
    assert empty.shape == (0, 16) and torch_solve.gj_solve_cuda.launches == before


@pytest.mark.gpu
def test_spd_solve_dispatch_on_card(cuda_device):
    for K, launches in ((64, 1), (10, 0), (264, 0)):
        A, b = _spd(6, K, seed=K)
        At, bt = torch.from_numpy(A).to(cuda_device), torch.from_numpy(b).to(cuda_device)
        before = torch_solve.gj_solve_cuda.launches
        x = torch_solve.spd_solve(At, bt)
        torch.cuda.synchronize()
        assert torch_solve.gj_solve_cuda.launches == before + launches, K
        torch.testing.assert_close(x, torch_solve.cholesky_solve(At, bt), rtol=SOLVE_RTOL, atol=SOLVE_ATOL)
    before = torch_solve.gj_solve_cuda.launches
    torch_solve.spd_solve(At[:, :64, :64].contiguous(), bt[:, :64].contiguous(), method="plain")
    assert torch_solve.gj_solve_cuda.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
def test_train_als_on_card_matches_cpu(cuda_device, implicit):
    rows, cols, vals = _ratings()
    cfg = torch_als.ALSConfig(
        rank=16, iterations=3, reg=0.1, implicit=implicit, alpha=2.0,
        bucket_widths=(4, 8, 16), chunk_entries=1 << 7, hot_group_slots=4,
    )
    expected = cfg.iterations * (
        torch_als.planned_solves(rows, 48, cfg) + torch_als.planned_solves(cols, 32, cfg)
    )
    before = torch_solve.gj_solve_cuda.launches
    on_card = torch_als.train_als(rows, cols, vals, 48, 32, cfg, device=cuda_device)
    torch.cuda.synchronize()
    assert torch_solve.gj_solve_cuda.launches - before == expected
    on_cpu = torch_als.train_als(rows, cols, vals, 48, 32, cfg, device="cpu")
    torch.testing.assert_close(on_card.user.cpu(), on_cpu.user, rtol=ALS_RTOL, atol=ALS_ATOL)
    torch.testing.assert_close(on_card.item.cpu(), on_cpu.item, rtol=ALS_RTOL, atol=ALS_ATOL)


@pytest.mark.gpu
def test_engine_serves_from_the_card(cuda_device):
    rows, cols, vals = _ratings()
    td = TrainingData(
        rows=rows, cols=cols, vals=vals,
        user_index=BiMap.string_index(str(u) for u in range(48)),
        item_index=BiMap.string_index(str(i) for i in range(32)),
    )
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=16, num_iterations=3, lambda_=0.1), device=cuda_device)
    model = algo.prepare_model_for_serving(algo.train(td))
    assert model.item_factors.device.type == "cuda"
    U = model.user_factors.double().cpu().numpy()
    V = model.item_factors.double().cpu().numpy()
    for u in range(0, 48, 7):
        got = [td.item_index[s.item] for s in algo.predict(model, Query(user=str(u), num=5)).item_scores]
        scores = V @ U[u]
        ref = np.lexsort((np.arange(32), -scores))[:5]
        for g, r in zip(got, ref):
            assert g == r or abs(scores[g] - scores[r]) <= 1e-5 * abs(scores[r])
    batch = dict(algo.batch_predict(model, [(0, Query(user="3", num=5)), (1, Query(user="x", num=5))]))
    # a GEMM against predict's GEMV: ids equal, scores to the last bits
    single = algo.predict(model, Query(user="3", num=5))
    assert [s.item for s in batch[0].item_scores] == [s.item for s in single.item_scores]
    assert batch[1].item_scores == ()


def _unit_towers(B: int, D: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(seed)
    ue = rng.normal(size=(B, D)).astype(np.float32)
    ie = rng.normal(size=(B, D)).astype(np.float32)
    ue /= np.linalg.norm(ue, axis=1, keepdims=True)
    ie /= np.linalg.norm(ie, axis=1, keepdims=True)
    return torch.from_numpy(ue).to(device), torch.from_numpy(ie).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("B,D", [(1024, 32), (256, 16), (384, 200), (128, 8), (256, 24)])
def test_fused_ce_kernels_match_plain_on_card(cuda_device, B, D):
    ue, ie = _unit_towers(B, D, seed=B + D, device=cuda_device)
    f0, b0 = torch_fused_ce.fused_ce_fwd_cuda.launches, torch_fused_ce.fused_ce_bwd_cuda.launches
    rs, cs = torch_fused_ce.fused_ce_fwd_cuda(ue, ie, 10.0)
    grads = torch_fused_ce.fused_ce_bwd_cuda(ue, ie, rs, cs, 10.0)
    torch.cuda.synchronize()
    assert torch_fused_ce.fused_ce_fwd_cuda.launches == f0 + 1
    assert torch_fused_ce.fused_ce_bwd_cuda.launches == b0 + 2
    for got, want in zip((rs, cs), torch_fused_ce.fused_ce_fwd_reference(ue, ie, 10.0)):
        rel = (got - want).abs() / want.abs()
        assert float(rel.max()) <= 2e-3 and float(rel.mean()) <= 5e-5, (float(rel.max()), float(rel.mean()))
    for got, want in zip(grads, torch_fused_ce.fused_ce_bwd_reference(ue, ie, rs, cs, 10.0)):
        torch.testing.assert_close(got, want, rtol=0, atol=5e-3 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("B,D", [(1024, 32), (384, 200), (8192, 64)])
def test_fused_ce_kernels_are_deterministic_on_card(cuda_device, B, D):
    """No atomics and a fixed order of every sum: two calls of each kernel
    on the same input agree to the bit (the column-slab sums included)."""
    ue, ie = _unit_towers(B, D, seed=3 * B + D, device=cuda_device)
    first = torch_fused_ce.fused_ce_fwd_cuda(ue, ie, 10.0)
    second = torch_fused_ce.fused_ce_fwd_cuda(ue, ie, 10.0)
    rs, cs = first
    grads = [torch_fused_ce.fused_ce_bwd_cuda(ue, ie, rs, cs, 10.0) for _ in range(2)]
    torch.cuda.synchronize()
    for x, y in (*zip(first, second), *zip(*grads)):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_fused_inbatch_ce_on_card_matches_plain(cuda_device):
    ue, ie = _unit_towers(1024, 32, seed=7, device=cuda_device)
    out = {}
    for mode in ("auto", "interpret"):
        u, i = ue.clone().requires_grad_(True), ie.clone().requires_grad_(True)
        f0, b0 = torch_fused_ce.fused_ce_fwd_cuda.launches, torch_fused_ce.fused_ce_bwd_cuda.launches
        loss = torch_fused_ce.fused_inbatch_ce(u, i, 10.0, mode)
        grads = torch.autograd.grad(loss, (u, i))
        torch.cuda.synchronize()
        launched = (torch_fused_ce.fused_ce_fwd_cuda.launches - f0, torch_fused_ce.fused_ce_bwd_cuda.launches - b0)
        assert launched == ((1, 2) if mode == "auto" else (0, 0))
        out[mode] = (float(loss), grads)
    (loss, grads), (ref, ref_grads) = out["auto"], out["interpret"]
    assert abs(loss - ref) < 5e-3 * max(1.0, abs(ref))
    for g, w in zip(grads, ref_grads):
        torch.testing.assert_close(g, w, rtol=5e-2, atol=5e-3 * float(w.abs().max()))


@pytest.mark.gpu
def test_fused_ce_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    ue, ie = _unit_towers(256, 16, seed=1, device=cuda_device)
    rs = torch.ones(256, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 128"):
        torch_fused_ce.fused_ce_fwd_cuda(ue[:200].contiguous(), ie[:200].contiguous(), 10.0)
    with pytest.raises(ValueError, match="multiple of 8"):
        torch_fused_ce.fused_ce_fwd_cuda(ue[:, :12].contiguous(), ie[:, :12].contiguous(), 10.0)
    with pytest.raises(ValueError, match="up to 256"):
        wide = torch.zeros((128, 264), device=cuda_device)
        torch_fused_ce.fused_ce_fwd_cuda(wide, wide, 10.0)
    with pytest.raises(ValueError, match="inv_temp"):
        torch_fused_ce.fused_ce_fwd_cuda(ue, ie, 100.0)
    with pytest.raises(TypeError):
        torch_fused_ce.fused_ce_fwd_cuda(ue.double(), ie.double(), 10.0)
    with pytest.raises(TypeError):
        torch_fused_ce.fused_ce_bwd_cuda(ue, ie, rs.half(), rs, 10.0)
    with pytest.raises(ValueError, match="contiguous"):
        torch_fused_ce.fused_ce_fwd_cuda(ue.T.contiguous().T, ie, 10.0)
    with pytest.raises(ValueError, match="row sums"):
        torch_fused_ce.fused_ce_bwd_cuda(ue, ie, rs[:128], rs, 10.0)
    with pytest.raises(ValueError, match="one CUDA device"):
        torch_fused_ce.fused_ce_fwd_cuda(ue, ie.cpu(), 10.0)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(256 * 16 + 1, device=cuda_device)
        torch_fused_ce.fused_ce_fwd_cuda(flat[1:].view(256, 16), ie, 10.0)


@pytest.mark.gpu
def test_train_two_tower_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, 40, 256), rng.integers(0, 30, 256)
    init_user = (rng.normal(size=(40, 16)) / 4).astype(np.float32)
    init_item = (rng.normal(size=(30, 16)) / 4).astype(np.float32)
    # one batch per epoch: the loss does not depend on the permutation
    cfg = torch_tt.TwoTowerConfig(dim=16, batch_size=256, epochs=3, seed=0, log_every=1)
    f0, b0 = torch_fused_ce.fused_ce_fwd_cuda.launches, torch_fused_ce.fused_ce_bwd_cuda.launches
    on_card = torch_tt.train_two_tower(rows, cols, 40, 30, cfg, init_user, init_item, device=cuda_device)
    assert torch_fused_ce.fused_ce_fwd_cuda.launches - f0 == 3
    assert torch_fused_ce.fused_ce_bwd_cuda.launches - b0 == 2 * 3
    on_cpu = torch_tt.train_two_tower(rows, cols, 40, 30, cfg, init_user, init_item, device="cpu")
    np.testing.assert_allclose(
        [l for _, l in on_card.loss_history], [l for _, l in on_cpu.loss_history], rtol=1e-3
    )
    for got, want in ((on_card.user_vecs, on_cpu.user_vecs), (on_card.item_vecs, on_cpu.item_vecs)):
        assert np.mean(np.abs(got - want) > 1e-3) < 0.01
        assert np.abs(got - want).max() <= 2 * cfg.learning_rate * cfg.epochs


@pytest.mark.gpu
def test_twotower_engine_serves_from_the_card(cuda_device):
    rng = np.random.default_rng(4)
    rows, cols = rng.integers(0, 50, 600), rng.integers(0, 40, 600)
    key = np.unique(rows * 40 + cols)
    rows, cols = key // 40, key % 40
    seen: dict = {}
    for r, c in zip(rows.tolist(), cols.tolist()):
        seen.setdefault(str(r), set()).add(str(c))
    td = tt_engine.TrainingData(
        rows=rows, cols=cols, user_index=BiMap.string_index(str(u) for u in range(50)),
        item_index=BiMap.string_index(str(i) for i in range(40)), seen=seen,
    )
    algo = tt_engine.TwoTowerAlgorithm(tt_engine.TwoTowerParams(embedding_dim=16, batch_size=128, epochs=3),
                                       device=cuda_device)
    model = algo.prepare_model_for_serving(algo.train(td))
    assert model.item_vecs.device.type == "cuda"
    U = model.user_vecs.double().cpu().numpy()
    V = model.item_vecs.double().cpu().numpy()
    for u in range(0, 50, 7):
        got = [td.item_index[s.item] for s in algo.predict(model, tt_engine.Query(user=str(u), num=5)).item_scores]
        scores = V @ U[u]
        order = [i for i in np.lexsort((np.arange(40), -scores)) if str(i) not in seen.get(str(u), ())][:5]
        for g, r in zip(got, order):
            assert g == r or abs(scores[g] - scores[r]) <= 1e-5 * abs(scores[r])
    batch = dict(algo.batch_predict(model, [(0, tt_engine.Query(user="3", num=5))]))
    single = algo.predict(model, tt_engine.Query(user="3", num=5))
    assert [s.item for s in batch[0].item_scores] == [s.item for s in single.item_scores]
