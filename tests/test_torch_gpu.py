"""Tests of the port that need an NVIDIA card (``gpu`` marker), and the
device rule they rest on. This file imports neither ``jax`` nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Whether there is a card is decided inside the ``cuda_device`` fixture,
never at import, so every test is collected the same way everywhere; on
a machine without CUDA the card tests skip.

Tolerances: the CUDA kernels (one warp per system for K <= 64, the
blocked kernel with one block a system to K = 128 and a cluster of two
above) against the plain Gauss-Jordan mirror at
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
[8192,64]); the wide kernels (D > 256: chunks of D, D-slices of the
backward) at the same bar; the loss and
gradients of ``fused_inbatch_ce`` against the plain versions at the JAX
package's on-TPU bar (loss 5e-3·max(1,|ref|), gradients rtol 5e-2, atol
5e-3·max|ref|, tests/test_pallas_tpu.py). An online fold on pinned tables
against the same fold on the CPU: rtol 1e-4, atol 1e-5 (the fold-in parity
band of tests/test_torch_online_parity.py). Two-Tower training on the card
against the CPU: loss history rtol 1e-3, and 99 % of the table entries
within 1e-3 — adam's first steps move an entry by about ``lr·sign(g)``,
so an entry whose gradient is near zero may land up to ``2·lr`` away.
The IVF and int8 tiers: the card's and the host's quantizers bit-equal
(exact ``.5`` quotients included), the int8 coarse scan's sums equal to
int64 numpy, the full probe (``nprobe >= nlist``) bit-equal to the exact
top-k, the build bit-equal between two runs of one seed, and three
``/reload``s with ``--ann --quantize int8`` within 1 MiB of allocated
memory. Sharded serving over an 8-way mesh on the one card: the exact
and int8 top-k bit-equal to the replicated ones, the IVF probe's ids the
unsharded probe's, its full probe bit-equal to the exact top-k.
Similar-Product, E-Commerce and the classifiers pinned on the
card answer as their CPU branch does (ids except near-ties of relative 1e-5, scores
and confidences within 1e-5). The batched grid of ``pio eval --grid`` on the
card scores as on the CPU from the same starting factors, within one hit
(1/(k·users)), and the explorer keeps its contract on the card: greedy at
epsilon 0, the same items under Thompson, one seed one sequence. The
AOTInductor serving programs of ``pio train --aot`` answer with the eager
pinned path's ids and score bits.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.controller.context import local_context
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
        # the blocked kernel: its first width, one block a system to
        # K = 128, a cluster of two to K = 224 and of four above; B = 1,
        # and B odd where a cluster holds a system (the grid is 2B or 4B
        # blocks)
        (130, 72), (300, 128), (33, 136), (20, 256),
        (1, 72), (1, 128), (1, 136), (1, 256), (7, 200), (3, 256), (67, 248), (5, 232), (9, 224),
    ],
)
def test_kernel_matches_plain_on_card(cuda_device, B, K):
    A, b = _spd(B, K, seed=K)
    At, bt = torch.from_numpy(A).to(cuda_device), torch.from_numpy(b).to(cuda_device)
    before = torch_solve.gj_solve_cuda.launches
    x = torch_solve.gj_solve_cuda(At, bt)
    torch.cuda.synchronize()
    assert torch_solve.gj_solve_cuda.launches == before + 1
    torch.testing.assert_close(x, torch_solve.gj_solve_plain(At, bt), rtol=SOLVE_RTOL, atol=SOLVE_ATOL)
    torch.testing.assert_close(x, torch_solve.cholesky_solve(At, bt), rtol=SOLVE_RTOL, atol=SOLVE_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [64, 72, 128, 136, 256])
def test_kernel_keeps_its_digits_where_pivots_are_large(cuda_device, K):
    """ALS-WR normal equations of much-rated items (pivots in the
    thousands): the kernel within 1e-4 (relative) of a float64 solve, as
    the library Cholesky is."""
    rng = np.random.default_rng(K)
    counts = [20000, 9000, 300, 40, 3]
    A, b = np.empty((len(counts), K, K)), np.empty((len(counts), K))
    for i, n in enumerate(counts):
        U = rng.normal(size=(n, K)) / np.sqrt(K) + 0.2
        A[i] = U.T @ U + 0.01 * n * np.eye(K)
        b[i] = U.T @ (rng.integers(1, 11, n) / 2.0)
    x64 = np.linalg.solve(A, b[..., None])[..., 0]
    At = torch.from_numpy(A.astype(np.float32)).to(cuda_device)
    bt = torch.from_numpy(b.astype(np.float32)).to(cuda_device)
    x = torch_solve.gj_solve_cuda(At, bt).double().cpu().numpy()
    err = np.abs(x - x64).max(axis=1) / np.abs(x64).max(axis=1)
    assert err.max() < 1e-4, err


@pytest.mark.gpu
@pytest.mark.parametrize("K", [64, 128, 136, 256])
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
@pytest.mark.parametrize("K", [64, 128, 256])
def test_kernel_takes_views_at_any_offset(cuda_device, K):
    """The warp kernel copies 16-byte chunks, the blocked kernel reads
    floats; views that start 4 bytes into their storage give the same
    bits as aligned tensors."""
    B = 37
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
    assert warp["kernel"] == "gj_solve_warp_kernel" and warp["threads_per_block"] == 128
    assert warp["cluster"] == 1 and 0 < warp["registers"] <= 255
    assert warp["smem_per_block"] == 4 * 4 * (64 * 68 + 64 + 2 * 68)
    assert warp["blocks_per_sm"] >= 1 and warp["warps_per_sm"] == 4 * warp["blocks_per_sm"]
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert warp["grid"] == min(warp["blocks_per_sm"] * sms, 32768 // 4)
    assert torch_solve.gj_solve_plan(3, 64, cuda_device)["grid"] == 1
    # the blocked kernel: 16 column groups by K/8 row tiles, one block a
    # system to K = 128; then 32 column groups by the row tiles of one
    # block of a cluster of two (four above K = 224), one cluster a system
    for K, threads, cluster in ((72, 144, 1), (128, 256, 1), (136, 288, 2), (224, 448, 2), (232, 256, 4),
                                (256, 256, 4)):
        tile = torch_solve.gj_solve_plan(50, K, cuda_device)
        assert tile["kernel"] == "gj_solve_tile_kernel", K
        assert (tile["threads_per_block"], tile["cluster"], tile["grid"]) == (threads, cluster, 50 * cluster), K
        assert 0 < tile["smem_per_block"] <= 48 * 1024 and tile["blocks_per_sm"] >= 1, tile
        assert tile["warps_per_sm"] == tile["blocks_per_sm"] * -(-threads // 32), tile
        assert 0 < tile["registers"] <= 65536 // threads, tile
    assert torch_solve.gj_solve_plan(1, 256, cuda_device)["grid"] == 4


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
    for K, launches in ((64, 1), (72, 1), (256, 1), (10, 0), (130, 0), (264, 0)):
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
def test_device_bucketing_on_card_equals_host(cuda_device):
    """``build_buckets_device`` on the card gives the host path's arrays
    to the bit; a ``precision="high"`` train leaves the matmul settings
    as it found them."""
    rows, cols, vals = _ratings()
    kw = dict(widths=(4, 8, 16), chunk_entries=1 << 7, hot_group_slots=4)
    for args in ((rows, cols, vals, 48, 32), (cols, rows, vals, 32, 48)):
        host_b = torch_als.build_buckets(*args, **kw)
        host = torch_als.to_device_buckets(host_b, cuda_device)
        got, rated = torch_als.build_buckets_device(*args, **kw, device=cuda_device)
        assert (got.nnz, got.padded_nnz, len(got.hot)) == (host.nnz, host.padded_nnz, len(host.hot))
        for g_ch, h_ch in zip(got.normal + got.hot + (got.hot_rows,), host.normal + host.hot + (host.hot_rows,)):
            assert all(g.dtype == h.dtype and torch.equal(g, h) for g, h in zip(g_ch, h_ch))
        np.testing.assert_array_equal(rated, torch_als.rated_row_mask(host_b))
    before = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    torch_als.train_als(rows, cols, vals, 48, 32, torch_als.ALSConfig(rank=16, iterations=1, precision="high"),
                        device=cuda_device)
    assert (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32) == before


@pytest.mark.gpu
def test_engine_serves_from_the_card(cuda_device):
    rows, cols, vals = _ratings()
    td = TrainingData(
        rows=rows, cols=cols, vals=vals,
        user_index=BiMap.string_index(str(u) for u in range(48)),
        item_index=BiMap.string_index(str(i) for i in range(32)),
    )
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=16, num_iterations=3, lambda_=0.1), device=cuda_device)
    model = algo.prepare_model_for_serving(algo.train(local_context(cuda_device), td))
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


@pytest.mark.gpu
def test_run_train_on_the_card_through_the_spine(cuda_device):
    # events in the memory store -> run_train on the card -> the stored
    # blob -> prepare_deploy on the card and on the CPU
    import datetime as dt

    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.templates.recommendation.engine import (
        DataSourceParams,
        RecommendationDataSource,
    )
    from predictionio_tpu_torch.utils.serialization import loads_model
    from predictionio_tpu_torch.workflow import load_engine_variant, run_train

    rows, cols, vals = _ratings(num_users=300, num_items=160, nnz=4000, seed=4)
    Storage.configure({
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    })
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="card"))
        t0 = dt.datetime(2021, 1, 1, tzinfo=dt.timezone.utc)
        Storage.get_l_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=str(u), target_entity_type="item",
                  target_entity_id=str(i), properties=DataMap({"rating": float(v)}),
                  event_time=t0 + dt.timedelta(seconds=k))
            for k, (u, i, v) in enumerate(zip(rows.tolist(), cols.tolist(), vals.tolist()))
        ], app_id)
        variant = load_engine_variant({
            "id": "card", "version": "1",
            "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
            "datasource": {"params": {"appName": "card"}},
            "algorithms": [{"name": "als", "params": {"rank": 16, "numIterations": 3, "lambda": 0.1}}],
        })
        td = RecommendationDataSource(DataSourceParams(app_name="card")).read_training(local_context("cpu"))
        cfg = torch_als.ALSConfig(rank=16)
        expected = 3 * (torch_als.planned_solves(td.rows, len(td.user_index), cfg)
                        + torch_als.planned_solves(td.cols, len(td.item_index), cfg))
        before = torch_solve.gj_solve_cuda.launches
        inst = run_train(variant, local_context(cuda_device))
        assert inst.status == "COMPLETED" and inst.mesh_conf == {"device": "cuda:0"}
        assert torch_solve.gj_solve_cuda.launches - before == expected > 0
        blob = Storage.get_model_data_models().get(inst.id).models
        (_, stored), = loads_model(blob)
        assert isinstance(stored.user_factors, np.ndarray) and stored.user_factors.dtype == np.float32
        assert stored.user_factors.shape == (len(td.user_index), 16)
        engine = variant.build_engine()
        ep = variant.engine_params(engine)
        _, [(algo, model)] = engine.prepare_deploy(local_context(cuda_device), ep, inst.id, blob)
        _, [(cpu_algo, cpu_model)] = engine.prepare_deploy(local_context("cpu"), ep, inst.id, blob)
    finally:
        Storage.configure(None)
    # the CPU, asked for, serves from host numpy (the JAX package's host branch)
    assert model.user_factors.device.type == "cuda" and isinstance(cpu_model.user_factors, np.ndarray)
    with pytest.raises(ValueError, match="context is on cuda:0"):
        cpu_algo.train_base(local_context(cuda_device), td)  # no training on a device the algorithm is not on
    V = stored.item_factors.astype(np.float64)
    for user in list(td.user_index.keys())[::17]:
        got = [td.item_index[s.item] for s in algo.predict(model, Query(user=user, num=10)).item_scores]
        want = [td.item_index[s.item] for s in cpu_algo.predict(cpu_model, Query(user=user, num=10)).item_scores]
        scores = V @ stored.user_factors[td.user_index[user]].astype(np.float64)
        assert len(got) == len(want) == 10
        for g, w in zip(got, want):
            assert g == w or abs(scores[g] - scores[w]) <= 1e-5 * abs(scores[w])


@pytest.mark.gpu
def test_incremental_retrain_on_the_card_launches_the_plan(cuda_device, tmp_path, caplog):
    # ratings in a columnar store -> run_train on the card -> a delta of a
    # new segment and tail lines -> run_train again: the second read is
    # incremental, equals a full read, and each train launches its plan
    import datetime as dt
    import logging

    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.templates.recommendation.engine import (
        DataSourceParams,
        RecommendationDataSource,
    )
    from predictionio_tpu_torch.workflow import load_engine_variant, run_train

    Storage.configure({
        "PIO_FS_BASEDIR": str(tmp_path),
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "COL",
        "PIO_STORAGE_SOURCES_COL_TYPE": "columnar",
        "PIO_STORAGE_SOURCES_COL_PATH": str(tmp_path / "events"),
    })
    cfg = torch_als.ALSConfig(rank=16)

    def plan() -> tuple:
        td = RecommendationDataSource(DataSourceParams(app_name="inc", incremental=False)).read_training(
            local_context("cpu"))
        return td, 3 * (torch_als.planned_solves(td.rows, len(td.user_index), cfg)
                        + torch_als.planned_solves(td.cols, len(td.item_index), cfg))

    def write(seed: int, nnz: int, users: int) -> None:
        rows, cols, vals = _ratings(num_users=users, num_items=160, nnz=nnz, seed=seed)
        Storage.get_p_events().write_columns(
            app_id, event="rate", entity_type="user", entity_codes=rows,
            entity_vocab=np.asarray([f"u{i}" for i in range(users)]), target_entity_type="item",
            target_codes=cols, target_vocab=np.asarray([f"i{i}" for i in range(160)]),
            event_time_us=1_600_000_000_000_000 + seed * 10**9 + np.arange(nnz, dtype=np.int64),
            props={"rating": vals.astype(np.float64)},
        )

    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="inc"))
        write(4, 4000, 300)
        variant = load_engine_variant({
            "id": "inc", "version": "1",
            "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
            "datasource": {"params": {"appName": "inc"}},
            "algorithms": [{"name": "als", "params": {"rank": 16, "numIterations": 3, "lambda": 0.1}}],
        })
        launches = []
        for step in range(2):
            if step == 1:
                write(5, 600, 340)
                Storage.get_l_events().insert_batch([
                    Event(event="rate", entity_type="user", entity_id=f"new{k}", target_entity_type="item",
                          target_entity_id=f"i{k}", properties=DataMap({"rating": 4.0}),
                          event_time=dt.datetime(2022, 1, 1, tzinfo=dt.timezone.utc))
                    for k in range(5)
                ], app_id)
            before = torch_solve.gj_solve_cuda.launches
            caplog.clear()
            with caplog.at_level(logging.INFO):
                inst = run_train(variant, local_context(cuda_device))
            assert inst.status == "COMPLETED"
            launches.append((torch_solve.gj_solve_cuda.launches - before, plan()[1]))
            merged = [r for r in caplog.records if "Incremental re-index: merged" in r.getMessage()]
            assert bool(merged) == (step == 1)
        td_full, _ = plan()
        td_inc = RecommendationDataSource(DataSourceParams(app_name="inc")).read_training(local_context("cpu"))
    finally:
        Storage.configure(None)
    assert all(got == want > 0 for got, want in launches), launches
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(td_inc, name), getattr(td_full, name))
    assert td_inc.user_index.to_dict() == td_full.user_index.to_dict()
    assert "new4" in td_full.user_index


def _unit_towers(B: int, D: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(seed)
    ue = rng.normal(size=(B, D)).astype(np.float32)
    ie = rng.normal(size=(B, D)).astype(np.float32)
    ue /= np.linalg.norm(ue, axis=1, keepdims=True)
    ie /= np.linalg.norm(ie, axis=1, keepdims=True)
    return torch.from_numpy(ue).to(device), torch.from_numpy(ie).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("B,D", [(1024, 32), (256, 16), (384, 200), (128, 8), (256, 24), (256, 512), (128, 264),
                                 (384, 392), (256, 1032)])
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
@pytest.mark.parametrize("B,D", [(1024, 32), (384, 200), (8192, 64), (1024, 520)])
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
    model = algo.prepare_model_for_serving(algo.train(local_context(cuda_device), td))
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


@pytest.mark.gpu
def test_two_tower_run_train_on_the_card_launches_the_plan(cuda_device):
    # view events in the memory store -> the Two-Tower engine's run_train
    # on the card -> the fused-CE launches against the step plan of the
    # pairs the DataSource reads -> the stored blob
    import datetime as dt

    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.utils.serialization import loads_model
    from predictionio_tpu_torch.workflow import load_engine_variant, run_train

    rng = np.random.default_rng(6)
    rows, cols = rng.integers(0, 120, 3000), rng.integers(0, 90, 3000)
    Storage.configure({
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    })
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="tt-card"))
        t0 = dt.datetime(2021, 1, 1, tzinfo=dt.timezone.utc)
        Storage.get_l_events().insert_batch([
            Event(event="view", entity_type="user", entity_id=f"u{u}", target_entity_type="item",
                  target_entity_id=f"i{i}", event_time=t0 + dt.timedelta(seconds=k))
            for k, (u, i) in enumerate(zip(rows.tolist(), cols.tolist()))
        ], app_id)
        variant = load_engine_variant({
            "id": "tt-card", "version": "1",
            "engineFactory": "predictionio_tpu.templates.twotower:engine_factory",
            "datasource": {"params": {"appName": "tt-card"}},
            "algorithms": [{"name": "twotower", "params": {"embeddingDim": 16, "batchSize": 256, "epochs": 3}}],
        })
        td = tt_engine.TwoTowerDataSource(tt_engine.DataSourceParams(app_name="tt-card")).read_training(
            local_context("cpu"))
        steps = 3 * -(-td.rows.size // 256)
        f0, b0 = torch_fused_ce.fused_ce_fwd_cuda.launches, torch_fused_ce.fused_ce_bwd_cuda.launches
        inst = run_train(variant, local_context(cuda_device))
        assert inst.status == "COMPLETED" and inst.mesh_conf == {"device": "cuda:0"}
        assert torch_fused_ce.fused_ce_fwd_cuda.launches - f0 == steps > 0
        assert torch_fused_ce.fused_ce_bwd_cuda.launches - b0 == 2 * steps
        (_, stored), = loads_model(Storage.get_model_data_models().get(inst.id).models)
    finally:
        Storage.configure(None)
    assert type(stored) is tt_engine.TwoTowerServingModel
    assert stored.user_vecs.shape == (len(td.user_index), 16) and np.isfinite(stored.user_vecs).all()
    assert stored.loss_history[-1][1] < stored.loss_history[0][1]


@pytest.mark.gpu
def test_query_service_on_the_card_pins_batches_and_reloads_flat(cuda_device):
    # a QueryService on the card: tables pinned (bytesPinned), TF32 off on
    # the serving thread, every bucket warmed (bucketMisses 0), batched
    # answers equal per-request ones under the near-tie rule (relative
    # 1e-5 on float64 scores), and five reloads leave
    # torch.cuda.memory_allocated within 1 MiB of its value after the first
    import datetime as dt
    import threading

    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.serving import BatcherConfig, CacheConfig
    from predictionio_tpu_torch.utils.serialization import loads_model
    from predictionio_tpu_torch.workflow import load_engine_variant, run_train
    from predictionio_tpu_torch.workflow.serving import QueryService

    rows, cols, vals = _ratings(num_users=400, num_items=300, nnz=8000, seed=8)
    Storage.configure({
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    })
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="serve"))
        t0 = dt.datetime(2021, 1, 1, tzinfo=dt.timezone.utc)
        Storage.get_l_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=str(u), target_entity_type="item",
                  target_entity_id=str(i), properties=DataMap({"rating": float(v)}),
                  event_time=t0 + dt.timedelta(seconds=k))
            for k, (u, i, v) in enumerate(zip(rows.tolist(), cols.tolist(), vals.tolist()))
        ], app_id)
        variant = load_engine_variant({
            "id": "serve", "version": "1",
            "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
            "datasource": {"params": {"appName": "serve"}},
            "algorithms": [{"name": "als", "params": {"rank": 64, "numIterations": 3, "lambda": 0.1}}],
        })
        inst = run_train(variant, local_context(cuda_device))
        (_, stored), = loads_model(Storage.get_model_data_models().get(inst.id).models)
        users = list(stored.user_index.keys())
        qs = QueryService(
            variant, local_context(cuda_device), cache=CacheConfig(pin_model=True),
            batching=BatcherConfig(max_batch_size=8, max_batch_delay_ms=2.0,
                                   warmup_body={"user": users[0], "num": 10}),
        )
        try:
            _, model = qs._algo_model_pairs[0]
            assert model.item_factors.device.type == "cuda"
            assert qs.stats_json()["cache"]["bytesPinned"] == (stored.user_factors.nbytes + stored.item_factors.nbytes)
            assert qs.run_on_device(lambda: torch.backends.cuda.matmul.allow_tf32) is False
            bodies = [{"user": u, "num": 10} for u in users[::3]]
            batched: dict = {}

            def client(part):
                for b in part:
                    batched[b["user"]] = qs.batcher.submit(b)

            threads = [threading.Thread(target=client, args=(bodies[k::8],)) for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            stats = qs.batcher.stats.to_json()
            assert stats["bucketMisses"] == 0 and stats["meanBatchSize"] > 1.0
            U = stored.user_factors.astype(np.float64)
            V = stored.item_factors.astype(np.float64)
            for b in bodies:
                status, got = batched[b["user"]]
                single_status, single = qs.handle_query(b)
                assert status == single_status == 200
                scores = V @ U[stored.user_index[b["user"]]]
                ref = np.lexsort((np.arange(V.shape[0]), -scores))[:10]
                for answer in (got, single):
                    ids = [stored.item_index[s["item"]] for s in answer["itemScores"]]
                    assert len(ids) == 10
                    for g, r in zip(ids, ref):
                        assert g == r or abs(scores[g] - scores[r]) <= 1e-5 * abs(scores[r])
            torch.cuda.synchronize()
            after_first = torch.cuda.memory_allocated(cuda_device)
            for _ in range(5):
                qs.reload()
            torch.cuda.synchronize()
            assert qs.model_generation == 6
            assert abs(torch.cuda.memory_allocated(cuda_device) - after_first) <= 1 << 20
        finally:
            qs.close()
    finally:
        Storage.configure(None)


@pytest.fixture
def online_card(cuda_device, tmp_path):
    """A QueryService on the card over a columnar store, with online
    learning whose daemon is stopped (folds are made by hand): the
    service, the app id and the function that appends rate events."""
    import datetime as dt

    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.online import OnlineConfig
    from predictionio_tpu_torch.serving import CacheConfig
    from predictionio_tpu_torch.workflow import load_engine_variant, run_train
    from predictionio_tpu_torch.workflow.serving import QueryService

    Storage.configure({
        "PIO_FS_BASEDIR": str(tmp_path),
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "COL",
        "PIO_STORAGE_SOURCES_COL_TYPE": "columnar",
        "PIO_STORAGE_SOURCES_COL_PATH": str(tmp_path / "events"),
    })
    t0 = dt.datetime(2021, 1, 1, tzinfo=dt.timezone.utc)
    seq = [0]

    def rate(triples) -> None:
        events = []
        for u, i, v in triples:
            seq[0] += 1
            events.append(Event(event="rate", entity_type="user", entity_id=str(u), target_entity_type="item",
                                target_entity_id=str(i), properties=DataMap({"rating": float(v)}),
                                event_time=t0 + dt.timedelta(seconds=seq[0])))
        Storage.get_l_events().insert_batch(events, app_id)

    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="online"))
        rows, cols, vals = _ratings(num_users=400, num_items=300, nnz=8000, seed=9)
        rate(zip(rows.tolist(), cols.tolist(), vals.tolist()))
        variant = load_engine_variant({
            "id": "online", "version": "1",
            "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
            "datasource": {"params": {"appName": "online"}},
            "algorithms": [{"name": "als", "params": {"rank": 64, "numIterations": 3, "lambda": 0.1}}],
        })
        run_train(variant, local_context(cuda_device))
        qs = QueryService(variant, local_context(cuda_device), cache=CacheConfig(pin_model=True),
                          online=OnlineConfig(enabled=True, interval_s=600.0))
        try:
            qs.online.stop()
            yield qs, rate
        finally:
            qs.close()
    finally:
        Storage.configure(None)


@pytest.mark.gpu
def test_online_fold_on_pinned_tables_matches_cpu(online_card):
    # the template's fold on the pinned tables (gather, solves on the
    # card through the service's device thread) against the same fold of
    # a host copy of the model by an algorithm on the CPU
    import copy

    from predictionio_tpu_torch.online.types import EventDelta

    qs, _ = online_card
    (algo, model), = qs.snapshot_pairs()[0]
    assert model.item_factors.device.type == "cuda"
    host = copy.copy(model)
    host.user_factors = model.user_factors.cpu().numpy()
    host.item_factors = model.item_factors.cpu().numpy()
    host._pio_online = None
    rng = np.random.default_rng(10)
    deltas = [EventDelta("rate", str(u), str(i), k, float(v)) for k, (u, i, v) in enumerate(zip(
        rng.integers(0, 420, 300).tolist(), rng.integers(0, 310, 300).tolist(), rng.integers(1, 6, 300).tolist()))]
    card = algo.online_foldin(model, deltas, qs.online.ds_params, qs.online_config, run=qs.run_on_device)
    cpu = ALSAlgorithm(algo.params, "cpu").online_foldin(host, deltas, qs.online.ds_params, qs.online_config)
    assert card.user_ids == cpu.user_ids and card.item_ids == cpu.item_ids and len(card.user_ids) > 128
    np.testing.assert_allclose(card.user_rows, cpu.user_rows, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(card.item_rows, cpu.item_rows, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_online_row_swaps_leave_a_snapshot_unchanged(online_card):
    # set_rows and append_rows build new tables: the tensors a snapshot
    # took before the fold keep every row
    qs, rate = online_card
    (_, model), = qs.snapshot_pairs()[0]
    users, items = model.user_factors, model.item_factors
    before = (users.clone(), items.clone())
    rate([(3, 5, 5.0), (3, 7, 1.0), ("fresh", 5, 4.0), (4, "fresh-item", 5.0)])
    assert qs.dispatch("POST", "/online/fold.json", {}, None).body == {"events": 4, "applied": True}
    assert torch.equal(users, before[0]) and torch.equal(items, before[1])
    assert model.user_factors is not users and model.user_factors.shape[0] == users.shape[0] + 1
    assert model.item_factors.shape[0] == items.shape[0] + 1 and model.item_factors.device.type == "cuda"
    assert not torch.equal(model.user_factors[model.user_index["3"]], users[model.user_index["3"]])


@pytest.mark.gpu
def test_reload_after_online_folds_releases_the_folded_generation(online_card, cuda_device):
    # a /reload after folds (rows moved, rows appended) frees the folded
    # tables: memory_allocated returns within 1 MiB of its value after
    # the first load, and the released model holds the folded rows
    qs, rate = online_card
    torch.cuda.synchronize()
    first = torch.cuda.memory_allocated(cuda_device)
    (_, model), = qs.snapshot_pairs()[0]
    for k in range(3):
        rate([(k, 9, 5.0), (f"new-{k}", 4, 3.0), (f"new-{k}", 8, 5.0), (k + 1, f"item-{k}", 4.0)])
        assert qs.dispatch("POST", "/online/fold.json", {}, None).body["applied"] is True
    folded = model.user_factors.cpu().numpy()
    assert qs.dispatch("POST", "/reload", {}, None).status == 200
    torch.cuda.synchronize()
    assert qs.model_generation == 2
    assert abs(torch.cuda.memory_allocated(cuda_device) - first) <= 1 << 20
    assert isinstance(model.user_factors, np.ndarray)
    np.testing.assert_array_equal(model.user_factors, folded)


# ------------------------------------------------ IVF and int8 retrieval
def _unit_rows(n: int, dim: int, seed: int, centers: int = 24) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, dim)).astype(np.float32)
    x = c[rng.integers(0, centers, n)] + 0.15 * rng.standard_normal((n, dim)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.gpu
def test_card_and_host_quantizers_are_bit_equal(cuda_device):
    # the card's division is IEEE (no fast math): quotients that land on
    # exactly .5 round half to even on both sides
    from predictionio_tpu_torch.ops import quant

    rng = np.random.default_rng(60)
    halves = np.asarray([[127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 63.5, -126.5]], np.float32)
    for mat in [rng.standard_normal((4096, 64)).astype(np.float32) * np.float32(10.0 ** e) for e in (-3, 0, 3)] + [
        halves, np.tile(halves, (300, 8)) * np.float32(0.125), np.zeros((3, 64), np.float32),
    ]:
        host_codes, host_scales = quant.quantize_table_host(mat)
        codes, scales = quant.quantize_rows(torch.as_tensor(mat, device=cuda_device))
        np.testing.assert_array_equal(codes.cpu().numpy(), host_codes)
        np.testing.assert_array_equal(scales.cpu().numpy(), host_scales)


@pytest.mark.gpu
def test_int8_coarse_scan_sums_are_exact_on_card(cuda_device):
    from predictionio_tpu_torch.ops import quant

    rng = np.random.default_rng(61)
    for rank in (64, quant.MAX_EXACT_RANK):
        a = rng.integers(-127, 128, (300, rank)).astype(np.int8)
        b = rng.integers(-127, 128, (5000, rank)).astype(np.int8)
        b[:4] = 127  # the largest sums
        a[:4] = 127
        got = quant.int8_matmul(torch.as_tensor(a, device=cuda_device), torch.as_tensor(b, device=cuda_device))
        want = a.astype(np.int64) @ b.astype(np.int64).T
        np.testing.assert_array_equal(got.cpu().numpy().astype(np.int64), want)


@pytest.mark.gpu
@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_full_probe_is_exact_to_the_bit_on_card(cuda_device, quantize):
    from predictionio_tpu_torch.ops import ivf, quant
    from predictionio_tpu_torch.ops.topk import top_k_scores

    x = _unit_rows(20_000, 64, seed=62)
    q = torch.as_tensor(_unit_rows(1000, 64, seed=63), device=cuda_device)
    index, _ = ivf.build_ivf(x, nlist=0, seed=0, iters=4, quantize=quantize, device=cuda_device)
    uidx = torch.arange(1000, device=cuda_device)
    if quantize:
        items = index.items
        want = top_k_scores(torch_als.score_rows(q, items), 128)  # the exact path's scoring
        assert isinstance(items, quant.QuantizedTable)
    else:
        want = torch_als.top_k_items_batch(uidx, q, index.items, 128)
    for nprobe in (index.nlist, index.nlist + 5):
        got = ivf.ivf_topk_users(uidx, q, index, 128, nprobe)
        assert torch.equal(got[0].long(), want[0].long()) and torch.equal(got[1], want[1])
        got = ivf.ivf_topk_batch(q, index, 128, nprobe)
        assert torch.equal(got[0].long(), want[0].long()) and torch.equal(got[1], want[1])


@pytest.fixture
def card_mesh(cuda_device):
    """An 8-way serving mesh over the one card (``(cuda:0,)*8``), the
    port's counterpart of the JAX package's 8 forced host devices."""
    from predictionio_tpu_torch.parallel import sharding

    with sharding.local_devices([cuda_device] * 8):
        yield sharding.serving_mesh()


def _sharded_inputs(cuda_device):
    rng = np.random.default_rng(66)
    uf = rng.standard_normal((3000, 64)).astype(np.float32)
    vf = rng.standard_normal((20_003, 64)).astype(np.float32)
    vf[1] = vf[0]  # an exact tie inside one shard
    vf[19_000] = vf[0]  # and across shards
    uf[0] = vf[0]
    return uf, vf, torch.arange(512, device=cuda_device)


@pytest.mark.gpu
def test_sharded_exact_is_the_replicated_answer_on_card(cuda_device, card_mesh):
    """Ids and scores to the bit at 20,003 items over 8 shards of one
    card, for a 512-query chunk, one query (a per-request deploy's) and
    three: each shard scores through ``score_rows``, whose products are
    blocks of one shape whatever the table's rows."""
    from predictionio_tpu_torch.parallel import sharding

    uf, vf, idx = _sharded_inputs(cuda_device)
    ut, it = sharding.shard_table(uf, card_mesh), sharding.shard_table(vf, card_mesh)
    assert {t.device for t in it.shards} == {cuda_device} and it.shape == (20_008, 64)
    for rows in (idx, idx[:1], idx[:3]):
        for k in (1, 16, 128):
            ids, scores = sharding.sharded_topk_users(rows, ut, it, k, 20_003)
            want = torch_als.top_k_items_batch(rows, torch.as_tensor(uf, device=cuda_device),
                                               torch.as_tensor(vf, device=cuda_device), k)
            assert torch.equal(ids, want[0]) and torch.equal(scores, want[1]), (len(rows), k)
        assert ids[0, :3].tolist() == [0, 1, 19_000]


@pytest.mark.gpu
def test_sharded_int8_is_the_replicated_answer_on_card(cuda_device, card_mesh):
    from predictionio_tpu_torch.ops import quant
    from predictionio_tpu_torch.parallel import sharding

    uf, vf, idx = _sharded_inputs(cuda_device)
    info = sharding.ShardInfo(card_mesh, {"user": 3000, "item": 20_003})
    rt = quant.QuantRuntime("int8", {}, 0)
    us, is_ = sharding.shard_quantized_table(uf, card_mesh), sharding.shard_quantized_table(vf, card_mesh)
    ur, ir = quant.quantize_table(uf, cuda_device), quant.quantize_table(vf, cuda_device)
    for k in (16, 128):
        ids, scores = quant.run_topk(rt, us, is_, idx.cpu().numpy(), k, shards=info)
        want = quant.run_topk(rt, ur, ir, idx.cpu().numpy(), k)
        assert torch.equal(ids.long(), want[0].long()) and torch.equal(scores, want[1]), k


@pytest.mark.gpu
def test_sharded_ivf_is_the_unsharded_answer_on_card(cuda_device, card_mesh):
    """At nprobe 8 the unsharded probe's ids; at the full probe the exact
    answer, ids and scores to the bit."""
    from predictionio_tpu_torch.ops import ivf
    from predictionio_tpu_torch.parallel import sharding

    uf, vf, idx = _sharded_inputs(cuda_device)
    q = torch.as_tensor(uf[:512], device=cuda_device)
    index, info = ivf.build_ivf(vf, nlist=0, seed=0, iters=4, device=cuda_device)
    rt = ivf.AnnRuntime(index, 8, info)
    assert ivf.shard_runtime(rt, card_mesh)["shards"] == 8
    got, _ = sharding.sharded_ivf_topk(q, rt.index, 16, 8)
    want, _ = ivf.ivf_topk_batch(q, index, 16, 8)
    assert torch.equal(got.long(), want.long())
    got = sharding.sharded_ivf_topk(q, rt.index, 16, index.nlist)
    want = torch_als.top_k_items_batch(idx, q, torch.as_tensor(vf, device=cuda_device), 16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_ivf_build_is_deterministic_per_seed_on_card(cuda_device):
    from predictionio_tpu_torch.ops import ivf

    x = _unit_rows(30_000, 64, seed=64)
    a, _ = ivf.build_ivf(x, nlist=0, seed=5, iters=8, device=cuda_device)
    b, _ = ivf.build_ivf(x, nlist=0, seed=5, iters=8, device=cuda_device)
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a.slab_ids, b.slab_ids) and torch.equal(a.slabs, b.slabs)


@pytest.mark.gpu
def test_reloads_with_ann_and_int8_leave_card_memory_flat(cuda_device):
    # --ann --quantize int8 on the card: bytesPinned is the codes and
    # scales, the full probe answers as the exact int8-free service does
    # for the same batch, and three reloads leave memory_allocated flat
    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.serving import AnnConfig, CacheConfig
    from predictionio_tpu_torch.workflow import load_engine_variant, run_train
    from predictionio_tpu_torch.workflow.serving import QueryService

    rows, cols, vals = _ratings(num_users=400, num_items=300, nnz=8000, seed=9)
    Storage.configure({
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    })
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="ann"))
        Storage.get_l_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=str(u), target_entity_type="item",
                  target_entity_id=str(i), properties=DataMap({"rating": float(v)}))
            for u, i, v in zip(rows.tolist(), cols.tolist(), vals.tolist())
        ], app_id)
        variant = load_engine_variant({
            "id": "ann", "version": "1",
            "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
            "datasource": {"params": {"appName": "ann"}},
            "algorithms": [{"name": "als", "params": {"rank": 64, "numIterations": 3, "lambda": 0.1}}],
        })
        run_train(variant, local_context(cuda_device))
        exact = QueryService(variant, local_context(cuda_device))
        full = QueryService(variant, local_context(cuda_device), ann=AnnConfig(enabled=True, nlist=16, nprobe=16))
        qs = QueryService(variant, local_context(cuda_device), cache=CacheConfig(quantize="int8"),
                          ann=AnnConfig(enabled=True, nlist=16, nprobe=4))
        try:
            bodies = [{"user": str(u), "num": 10} for u in range(0, 400, 3)]
            assert full.handle_batch(bodies) == exact.handle_batch(bodies)
            n_users, n_items = (len(qs._algo_model_pairs[0][1].user_index), len(qs._algo_model_pairs[0][1].item_index))
            assert qs.stats_json()["cache"]["bytesPinned"] == (n_users + n_items) * (64 + 4)
            assert all(status == 200 for status, _ in qs.handle_batch(bodies))
            torch.cuda.synchronize()
            after_first = torch.cuda.memory_allocated(cuda_device)
            for _ in range(3):
                qs.reload()
            torch.cuda.synchronize()
            assert qs.model_generation == 4 and qs.stats_json()["ann"]["models"][0]["quantized"] is True
            assert abs(torch.cuda.memory_allocated(cuda_device) - after_first) <= 1 << 20
        finally:
            for s in (exact, full, qs):
                s.close()
    finally:
        Storage.configure(None)


@pytest.mark.gpu
def test_templates_serve_on_card_as_on_the_cpu(cuda_device):
    """SimilarProduct and ECommerce pinned on the card (one GEMV, the mask,
    ``top_k_scores``) answer as their CPU numpy branch does for one
    model: ids equal except near-ties (relative 1e-5), scores within 1e-5;
    a cold ECommerce user's tied popularity comes in ascending order on
    both. The classifiers' card answers equal the CPU's (labels,
    confidences within 1e-5), and none of it launches a kernel."""
    from predictionio_tpu_torch.ops import classify
    from predictionio_tpu_torch.templates.classification import engine as cls
    from predictionio_tpu_torch.templates.ecommerce import engine as ec
    from predictionio_tpu_torch.templates.similarproduct import engine as sp

    rng = np.random.default_rng(3)
    n_users, n_items, rank = 50, 400, 32
    users = rng.normal(size=(n_users, rank)).astype(np.float32)
    items = rng.normal(size=(n_items, rank)).astype(np.float32)
    unit = items / np.linalg.norm(items, axis=1, keepdims=True)
    user_index = BiMap.string_index(f"u{u}" for u in range(n_users))
    item_index = BiMap.string_index(f"i{i}" for i in range(n_items))
    categories = {f"i{i}": (f"c{i % 4}",) for i in range(n_items)}
    popularity = rng.integers(0, 5, n_items).astype(np.float32)
    launches = torch_solve.gj_solve_cuda.launches

    def same(got, want):
        assert len(got.item_scores) == len(want.item_scores)
        for g, w in zip(got.item_scores, want.item_scores):
            # a differing item at a place is a near-tie of the two
            assert abs(g.score - w.score) <= 1e-5 * max(1.0, abs(w.score))

    for module, algo_class, params, make, queries in (
        (sp, sp.ALSAlgorithm, sp.ALSAlgorithmParams(),
         lambda: sp.SimilarProductModel(unit.copy(), item_index, categories),
         [sp.Query(items=("i1",), num=10), sp.Query(items=("i1", "i7", "i9"), num=10, categories=("c2",)),
          sp.Query(items=("i3",), num=10, white_list=tuple(f"i{i}" for i in range(0, 60, 3))),
          sp.Query(items=("i3",), num=10, black_list=("i4", "i5"))]),
        (ec, ec.ECommAlgorithm, ec.ECommAlgorithmParams(),
         lambda: ec.ECommModel(users.copy(), items.copy(), user_index, item_index, categories, popularity.copy()),
         [ec.Query(user="u2", num=10), ec.Query(user="u3", num=10, categories=("c1",)),
          ec.Query(user="cold", num=10), ec.Query(user="cold", num=25, black_list=("i0",))]),
    ):
        card = algo_class(params, device=cuda_device)
        host = algo_class(params, device="cpu")
        on_card = card.prepare_model_for_serving(make())
        on_host = host.prepare_model_for_serving(make())
        assert isinstance(on_card.item_factors, torch.Tensor) and on_card.item_factors.is_cuda
        for q in queries:
            same(card.predict(on_card, q), host.predict(on_host, q))
        card.release_pinned_model(on_card)
        assert isinstance(on_card.item_factors, np.ndarray)
    cold = ec.ECommAlgorithm(ec.ECommAlgorithmParams(), device=cuda_device)
    model = cold.prepare_model_for_serving(
        ec.ECommModel(users, items, user_index, item_index, categories, popularity))
    got = [s.item for s in cold.predict(model, ec.Query(user="cold", num=60)).item_scores]
    order = np.lexsort((np.arange(n_items), -popularity.astype(np.float64)))[:60]
    assert got == [f"i{i}" for i in order]

    x = rng.poisson(2.0, size=(300, 3)).astype(np.float32)
    y = rng.integers(0, 3, 300)
    labels = BiMap.string_index(["a", "b", "c"])
    mean, std = x.mean(axis=0), x.std(axis=0)
    for algo_class, model in (
        (cls.NaiveBayesAlgorithm, {"nb": classify.to_numpy(classify.train_naive_bayes(x, y, 3, device=cuda_device))}),
        (cls.LRAlgorithm, {"lr": classify.to_numpy(classify.train_logreg((x - mean) / std, y, 3, device=cuda_device)),
                           "mean": mean, "std": std}),
    ):
        model.update(label_index=labels, attributes=("attr0", "attr1", "attr2"))
        card = algo_class(algo_class.params_class(), device=cuda_device)
        host = algo_class(algo_class.params_class(), device="cpu")
        on_card, on_host = card.prepare_model_for_serving(dict(model)), host.prepare_model_for_serving(dict(model))
        queries = [dict(zip(("attr0", "attr1", "attr2"), map(float, row))) for row in x[:40]]
        for q in queries:
            a, b = card.predict(on_card, q), host.predict(on_host, q)
            assert a.label == b.label and abs(a.confidence - b.confidence) <= 1e-5
    assert torch_solve.gj_solve_cuda.launches == launches


@pytest.mark.gpu
@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
def test_grid_scores_on_card_as_on_the_cpu(cuda_device, implicit):
    from predictionio_tpu_torch.experiments.sweep import grid_train_eval, initial_factors

    rng = np.random.default_rng(9)
    n, k = 32, 4
    blocks = (np.arange(n)[:, None] % 2) == (np.arange(n)[None, :] % 2)
    observed = rng.random((n, n)) < np.where(blocks, 0.6, 0.3)
    R = np.where(observed, np.where(blocks, 5.0, 1.0), 0.0).astype(np.float32)
    M = observed.astype(np.float32)
    T = (blocks & ~observed).astype(np.float32)
    arrays = (R, M, T, M.copy(), np.ones(n, np.float32), np.ones(n, np.float32))
    regs, alphas, seeds = np.float32([0.01, 0.1, 1.0, 10.0]), np.float32([1.0, 2.0, 1.0, 0.5]), np.int64([0, 1, 2, 0])
    init = initial_factors(seeds.tolist(), n, n, 6)
    statics = dict(rank=6, iterations=5, implicit=implicit, k=k, init=init)
    cpu = grid_train_eval(*arrays, regs, alphas, seeds, device="cpu", **statics).numpy()
    card = grid_train_eval(*arrays, regs, alphas, seeds, device=cuda_device, **statics).cpu().numpy()
    assert card.shape == (4,) and np.isfinite(card).all()
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1.0 / (k * n) + 1e-7)


@pytest.mark.gpu
def test_explorer_keeps_its_contract_on_card(cuda_device):
    from predictionio_tpu_torch.experiments.explore import ExploreConfig, Explorer, _ItemStat

    items = [{"item": f"i{j}", "score": 10.0 - j} for j in range(12)]
    greedy = Explorer(ExploreConfig(policy="epsilon", epsilon=0.0), cuda_device)
    assert all([e["item"] for e in greedy.rerank(items)] == [e["item"] for e in items] for _ in range(10))
    runs = []
    for _ in range(2):
        ex = Explorer(ExploreConfig(policy="thompson", seed=4), cuda_device)
        runs.append([[e["item"] for e in ex.rerank(items)] for _ in range(20)])
        assert all(sorted(r) == sorted(e["item"] for e in items) for r in runs[-1])
    assert runs[0] == runs[1]
    narrow = Explorer(ExploreConfig(policy="thompson", seed=5), cuda_device)
    for e in items:
        narrow._items[e["item"]] = _ItemStat()
        narrow._items[e["item"]].pulls = 10**8
    assert [e["item"] for e in narrow.rerank(items)] == [e["item"] for e in items]
    assert narrow.stats_json()["lastError"] is None and greedy.stats_json()["explored"] == 0


@pytest.mark.gpu
def test_aot_programs_are_the_eager_pinned_path_on_card(cuda_device, tmp_path):
    """The AOTInductor programs of ``pio train --aot`` against the eager
    pinned path on ``cuda:0``: ``predict_scores`` and the bucket's top-k
    for single queries, the batch program at 1, 8, 13 and 512 queries
    (ids padded to the product's multiple of 8), ids and score bits equal."""
    import types

    from predictionio_tpu_torch.ops.topk import top_k_scores
    from predictionio_tpu_torch.templates.serving_util import aot_predict, aot_serving_programs, chunked_topk
    from predictionio_tpu_torch.workflow import aot

    rng = np.random.default_rng(14)
    users = torch.as_tensor(rng.standard_normal((3000, 64)).astype(np.float32), device=cuda_device)
    items = torch.as_tensor(rng.standard_normal((9000, 64)).astype(np.float32), device=cuda_device)
    model = types.SimpleNamespace(user_factors=users, item_factors=items)
    programs = aot_serving_programs(model, "user_factors", "item_factors", [16], 512, cuda_device)
    algo = types.SimpleNamespace(aot_export_for_serving=lambda m, b: programs)
    manifest = aot.export_instance([(algo, model)], "card", str(tmp_path))
    assert manifest["fingerprint"]["backend"] == "cuda" and len(manifest["entries"]) == 3
    runtime, report = aot.load_runtime("card", str(tmp_path), device=cuda_device)
    assert runtime is not None, report

    def bits(t):
        return t.contiguous().view(torch.int32)

    for u in range(0, 3000, 97):
        want = top_k_scores(torch_als.predict_scores(users[u], items), 10)
        got = aot_predict(runtime, users[u], items, 10, 9000)
        assert torch.equal(got[0], want[0][:10]) and torch.equal(bits(got[1]), bits(want[1][:10]))
    for n in (1, 8, 13, 512):
        valid = [(j, int(u), 16) for j, u in enumerate(rng.integers(0, 3000, n))]
        eager = list(chunked_topk(users, items, valid, chunk=512))
        tier1 = list(chunked_topk(users, items, valid, chunk=512, aot=runtime))
        assert [i for _, i, _ in tier1] == [i for _, i, _ in eager]
        assert [np.asarray(s, np.float32).view(np.int32).tolist() for _, _, s in tier1] == [
            np.asarray(s, np.float32).view(np.int32).tolist() for _, _, s in eager
        ]
    stats = runtime.stats()
    assert stats["disabled"] == 0 and stats["misses"] == 0 and stats["hits"] > 60
