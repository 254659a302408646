"""Sharded factor serving (``pio deploy --shard-factors``) on both
packages.

The JAX package's ``tests/test_sharded.py`` classes ``TestShardTable``,
``TestShardedTopK``, ``TestServingHooks`` and ``TestQueryServiceSharded``
run twice, ``[jax]`` and ``[torch]`` (``tests/torch_package_swap.py``):
under ``[torch]`` the test module's ``sharding``, ``jnp.asarray`` (a CPU
tensor), ``top_k_items_batch`` (on CPU tensors), ``BiMap``, the
Recommendation template's classes (``ALSAlgorithm`` on the CPU) and
``jax.devices()`` (the mesh's devices) are the port's, and so are
``ops.ivf`` (``build_ivf`` on the CPU), ``AnnConfig``, the Two-Tower
template, ``QueryService``, the workflow and the event and storage
classes. The port's mesh is ``(cpu,)*8``, set by its own
:func:`~predictionio_tpu_torch.parallel.sharding.local_devices` for each
case — the counterpart of the 8 host devices ``tests/conftest.py`` gives
JAX. ``TestTrainingParity1x8`` (the training mesh) is held by
``tests/test_torch_mesh_train.py``, whose ALS and Two-Tower cases run the
``(1, 8)`` mesh among the others against the JAX package's.

Then the same seeded factors through the JAX package's sharded kernels
(its 8 CPU devices) and the port's, and the port's own contracts: the
scoring routine's bits, ties across shard boundaries, signed zeros,
all-negative scores, the owner-shard row swap, growth past the padding.
"""

import functools
import logging
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import predictionio_tpu.ops as jax_ops_package
import predictionio_tpu.parallel as jax_parallel_package
import predictionio_tpu_torch.data.aggregator as port_aggregator
import predictionio_tpu_torch.data.event as port_event
import predictionio_tpu_torch.data.storage.base as port_storage_base
import predictionio_tpu_torch.ops.ivf as port_ivf
import predictionio_tpu_torch.serving as port_serving_package
import predictionio_tpu_torch.serving.ann as port_serving_ann
import predictionio_tpu_torch.templates.recommendation.engine as port_recommendation
import predictionio_tpu_torch.templates.twotower.engine as port_twotower
import predictionio_tpu_torch.workflow as port_workflow
import predictionio_tpu_torch.workflow.device_state as port_device_state
import predictionio_tpu_torch.workflow.serving as port_serving
import test_sharded as jax_cases
from predictionio_tpu.ops import ivf as jax_ivf
from predictionio_tpu.parallel import sharding as jax_sharding
from predictionio_tpu_torch import convert
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import quant as port_quant
from predictionio_tpu_torch.ops.topk import top_k_scores
from predictionio_tpu_torch.parallel import sharding
from test_sharded import trained_variant  # noqa: F401  (the cases' fixture)
from torch_package_swap import (
    PACKAGES,
    controller_module,
    cpu_module,
    memory_storage,
    tensor_numpy,
    tensor_top_k_items_batch,
    use_port,
)

CPU = torch.device("cpu")
S = 8


def _jax_stand_in() -> types.ModuleType:
    """``jax`` for a case run on the port: ``devices()`` is the mesh's."""
    module = types.ModuleType("jax")
    module.devices = lambda: list(sharding.visible_devices(CPU))
    return module


@pytest.fixture(params=PACKAGES, autouse=True)
def package(request, monkeypatch):
    if request.param == "jax":
        yield request.param
        return
    use_port(
        monkeypatch,
        jax_cases,
        {
            "sharding": sharding,
            "jnp": tensor_numpy(),
            "jax": _jax_stand_in(),
            "top_k_items_batch": tensor_top_k_items_batch,
            "BiMap": port_aggregator.BiMap,
            "ALSAlgorithm": functools.partial(port_recommendation.ALSAlgorithm, device="cpu"),
            "ALSAlgorithmParams": port_recommendation.ALSAlgorithmParams,
            "ALSModel": port_recommendation.ALSModel,
            "Query": port_recommendation.Query,
        },
        {
            "predictionio_tpu.controller": controller_module(),
            "predictionio_tpu.data.aggregator": port_aggregator,
            "predictionio_tpu.data.event": port_event,
            "predictionio_tpu.data.storage.base": port_storage_base,
            "predictionio_tpu.parallel.sharding": sharding,
            "predictionio_tpu.serving": port_serving_package,
            "predictionio_tpu.serving.ann": port_serving_ann,
            "predictionio_tpu.templates.twotower.engine": cpu_module(
                "predictionio_tpu.templates.twotower.engine", port_twotower,
                TwoTowerAlgorithm=port_twotower.TwoTowerAlgorithm,
            ),
            "predictionio_tpu.workflow": port_workflow,
            "predictionio_tpu.workflow.serving": port_serving,
            "predictionio_tpu.workflow.device_state": port_device_state,
        },
    )
    # `from predictionio_tpu.ops import ivf` and `from predictionio_tpu.parallel
    # import sharding` read the packages' attributes before sys.modules
    monkeypatch.setattr(
        jax_ops_package, "ivf", cpu_module("predictionio_tpu.ops.ivf", port_ivf, build_ivf=port_ivf.build_ivf),
        raising=False,
    )
    monkeypatch.setattr(jax_parallel_package, "sharding", sharding, raising=False)
    with sharding.local_devices([CPU] * S):
        yield request.param


@pytest.fixture()
def memory_storage_env(package):
    yield from memory_storage(package)


class TestShardTable(jax_cases.TestShardTable):
    pass


class TestShardedTopK(jax_cases.TestShardedTopK):
    pass


class TestServingHooks(jax_cases.TestServingHooks):
    pass


class TestQueryServiceSharded(jax_cases.TestQueryServiceSharded):
    pass


def test_cases_run_on_the_ports_classes(package):
    from predictionio_tpu.ops import ivf
    from predictionio_tpu.parallel import sharding as bound
    from predictionio_tpu.workflow.serving import QueryService

    prefix = "predictionio_tpu." if package == "jax" else "predictionio_tpu_torch."
    for obj in (QueryService, jax_cases.ALSAlgorithm, ivf.AnnRuntime, jax_cases.BiMap):
        assert getattr(obj, "func", obj).__module__.startswith(prefix)
    assert bound.__name__.startswith(prefix) and jax_cases.sharding is bound
    if package == "torch":
        assert bound.serving_mesh() == (CPU,) * S
        assert sys.modules["predictionio_tpu.parallel.sharding"] is sharding


# ---------------------------------------------------------------------------
# The same factors through both packages' sharded kernels
# ---------------------------------------------------------------------------


def _factors(users: int, items: int, rank: int, seed: int):
    rng = np.random.default_rng(seed)
    uf = rng.standard_normal((users, rank)).astype(np.float32)
    vf = rng.standard_normal((items, rank)).astype(np.float32)
    return uf, vf


class TestAcrossPackages:
    """The same seeded factors through both packages' sharded kernels."""

    @pytest.fixture(autouse=True)
    def package(self):
        """Not parametrised: each case names the package of every call."""
        return None

    @pytest.fixture()
    def meshes(self):
        """The JAX package's 8-way host mesh and the port's ``(cpu,)*8``."""
        jmesh = jax_sharding.serving_mesh()
        assert jmesh is not None and jmesh.shape["model"] == S
        with sharding.local_devices([CPU] * S):
            yield jmesh, sharding.serving_mesh()



    @pytest.mark.parametrize(
        "case", ["random", "ties_across_shards", "all_negative"],
    )
    def test_sharded_exact_matches_jax(self, meshes, case):
        """Ids equal, scores within rtol 1e-6 (``tests/test_sharded.py``'s
        bar against the replicated kernel), at k 1, 7 and 16, over 130 items
        padded to 136 — with tied rows 3, 77 and 120 on three shards, and
        with every score negative (the padding rows must not rank)."""
        jmesh, mesh = meshes
        uf, vf = _factors(70, 130, 8, seed=21)
        if case == "ties_across_shards":
            vf[3] = vf[77] = vf[120]
            uf[:4] = vf[120]
        elif case == "all_negative":
            uf[:] = np.abs(uf)
            vf[:] = -np.abs(vf)
        idx = np.random.default_rng(0).integers(0, 70, 48).astype(np.int32)
        idx[:4] = np.arange(4)
        ju, ji = jax_sharding.shard_table(uf, jmesh), jax_sharding.shard_table(vf, jmesh)
        tu, ti = sharding.shard_table(uf, mesh), sharding.shard_table(vf, mesh)
        for k in (1, 7, 16):
            want_ids, want = jax_sharding.sharded_topk_users(jnp.asarray(idx), ju, ji, k, 130, jmesh)
            ids, got = sharding.sharded_topk_users(idx, tu, ti, k, 130, mesh)
            np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
            assert ids.numpy().max() < 130
        if case == "ties_across_shards":
            row = ids.numpy()[0].tolist()
            assert row[row.index(3) : row.index(3) + 3] == [3, 77, 120]
        if case == "all_negative":
            assert got.numpy().max() < 0

    def test_sharded_int8_matches_jax(self, meshes):
        """The two packages' sharded int8 tables hold the same codes and
        scales (``ops/quant``'s one rounding rule), and their sharded
        two-stage kernels rank the same ids; the rescored scores within rtol
        1e-6 (each package sums the rescore's products in its own order)."""
        jmesh, mesh = meshes
        uf, vf = _factors(200, 1000, 24, seed=22)
        vf[10:18] = vf[10]  # eight tied rows across two shards
        jq_u = jax_sharding.shard_quantized_table(uf, jmesh)
        jq_i = jax_sharding.shard_quantized_table(vf, jmesh)
        tq_u = sharding.shard_quantized_table(uf, mesh)
        tq_i = sharding.shard_quantized_table(vf, mesh)
        for j, t in ((jq_u, tq_u), (jq_i, tq_i)):
            np.testing.assert_array_equal(np.asarray(t.codes), np.asarray(j.codes))
            np.testing.assert_array_equal(np.asarray(t.scales), np.asarray(j.scales))
        idx = np.arange(48, dtype=np.int32)
        idx[0] = 10
        k, kp = 16, port_quant.overfetch(16, 1000)
        want_ids, want = jax_sharding.sharded_quantized_topk_users(
            jnp.asarray(idx), jq_u.codes, jq_u.scales, jq_i.codes, jq_i.scales, k, kp, 1000, jmesh
        )
        ids, got = sharding.sharded_quantized_topk_users(idx, tq_u.codes, tq_u.scales, tq_i.codes, tq_i.scales, k, kp,
                                                         1000, mesh)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)

    @pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
    def test_sharded_ivf_matches_jax(self, meshes, quantized):
        """One JAX-built index, through ``convert``, sharded by each package:
        the same ids at nprobe 4 of 13 clusters."""
        jmesh, mesh = meshes
        rng = np.random.default_rng(23)
        centers = rng.standard_normal((16, 16)).astype(np.float32)
        items = (centers[rng.integers(0, 16, 1500)] + 0.3 * rng.standard_normal((1500, 16))).astype(np.float32)
        q = rng.standard_normal((32, 16)).astype(np.float32)
        jidx, jinfo = jax_ivf.build_ivf(items, nlist=13, seed=0, iters=3, quantize=quantized)
        jrt = jax_ivf.AnnRuntime(jidx, 4, jinfo)
        jax_ivf.shard_runtime(jrt, jmesh)
        table = port_quant.quantize_table(items, CPU) if quantized else torch.as_tensor(items)
        tidx = convert.ivf_index_from_numpy(**convert.ivf_index_to_numpy(jidx), items=table, device="cpu")
        trt = port_ivf.AnnRuntime(tidx, 4, dict(jinfo))
        delta = port_ivf.shard_runtime(trt, mesh)
        assert delta["shards"] == S and trt.host_index.device == CPU
        want, _ = jax_sharding.sharded_ivf_topk(jnp.asarray(q), jrt.index, 10, 4, jmesh)
        got, _ = sharding.sharded_ivf_topk(q, trt.index, 10, 4, mesh)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # and the port's own unsharded probe of the same index
        plain, _ = port_ivf.ivf_topk_batch(torch.as_tensor(q), tidx, 10, 4)
        np.testing.assert_array_equal(got.numpy(), plain.numpy())


# ---------------------------------------------------------------------------
# The port's own contracts
# ---------------------------------------------------------------------------


class TestPortContracts:
    """The port's own sharded-serving contracts."""

    @pytest.fixture(autouse=True)
    def package(self):
        """Not parametrised: each case names the package of every call."""
        return None

    @pytest.fixture()
    def mesh(self):
        with sharding.local_devices([CPU] * S):
            yield sharding.serving_mesh()

    @pytest.mark.parametrize("rows", [5, 16, 17, 40, 61])
    def test_score_rows_bits_do_not_depend_on_the_table_rows(self, monkeypatch, rows):
        """``score_rows`` scores every table in blocks of one shape (a
        batched product, the short last block padded), so a row scored in
        the whole table and in any slice of it (a shard) has the same bits —
        here with 16-row blocks, at one query and at 9."""
        monkeypatch.setattr(port_als, "SCORE_BLOCK", 16)
        rng = np.random.default_rng(rows)
        table = torch.as_tensor(rng.standard_normal((rows, 24)).astype(np.float32))
        for m in (1, 9):
            q = torch.as_tensor(rng.standard_normal((m, 24)).astype(np.float32))
            full = port_als.score_rows(q, table)
            np.testing.assert_allclose(full.numpy(), (q @ table.T).numpy(), rtol=1e-5, atol=1e-5)
            for lo, hi in ((0, 3), (rows // 3, rows), (1, rows - 1)):
                if hi > lo:
                    part = port_als.score_rows(q, table[lo:hi])
                    assert torch.equal(part, full[:, lo:hi]), (lo, hi)
        codes, scales = port_quant.quantize_rows(table)
        qt = port_quant.QuantizedTable(codes, scales)
        full = port_als.score_rows(q, qt)
        part = port_als.score_rows(q, port_quant.QuantizedTable(codes[1:], scales[1:]))
        assert torch.equal(part, full[:, 1:])
        np.testing.assert_allclose(full.numpy(), (q @ port_quant.dequantize(codes, scales).T).numpy(), rtol=1e-5, atol=1e-5)

    def test_score_rows_pads_a_tables_last_block_once(self, monkeypatch):
        """The zero-padded last block is kept while its table lives (one pad
        a table, not one a query) and made anew once the table is written
        in place."""
        monkeypatch.setattr(port_als, "SCORE_BLOCK", 16)
        rng = np.random.default_rng(4)
        table = torch.as_tensor(rng.standard_normal((21, 8)).astype(np.float32))
        q = torch.as_tensor(rng.standard_normal((3, 8)).astype(np.float32))
        first = port_als.score_rows(q, table)
        tail = port_als._TAILS.get(table)[2]
        assert torch.equal(port_als.score_rows(q, table), first)
        assert port_als._TAILS.get(table)[2] is tail
        table[20] = 1.0
        again = port_als.score_rows(q, table)
        assert port_als._TAILS.get(table)[2] is not tail
        np.testing.assert_allclose(again[:, 20].numpy(), q.sum(1).numpy(), rtol=1e-5)
        assert torch.equal(again[:, :20], first[:, :20])

    def test_signed_zero_scores_rank_as_the_replicated_top_k(self, mesh):
        """``0.0`` above ``-0.0`` (``jax.lax.top_k``'s order), across shards:
        the sharded merge keys on the bits, as ``top_k_scores`` does — for a
        row of signed zeros split over 8 parts, and through the kernel."""
        row = torch.tensor([[0.0, -0.0, -1.0, 0.0, -0.0, 2.0] * 8])
        parts = [top_k_scores(row[:, lo : lo + 6], 6) for lo in range(0, 48, 6)]
        ids, vals = sharding.sort_merge_topk(
            torch.cat([v for _, v in parts], 1), torch.cat([i + 6 * s for s, (i, _) in enumerate(parts)], 1), 48,
            total_order=True,
        )
        want_ids, want = top_k_scores(row, 48)
        assert torch.equal(ids, want_ids) and torch.equal(vals.view(torch.int32), want.view(torch.int32))
        rng = np.random.default_rng(9)
        items = rng.standard_normal((40, 2)).astype(np.float32)
        items[::3] = 0.0
        items[1::3] = -0.0
        users = np.asarray([[0.0, 0.0], [-0.0, 0.0], [1.0, -1.0]], np.float32)
        tu, ti = sharding.shard_table(users, mesh), sharding.shard_table(items, mesh)
        ids, got = sharding.sharded_topk_users([0, 1, 2], tu, ti, 40, 40)
        want_ids, want = top_k_scores(port_als.score_rows(torch.as_tensor(users), torch.as_tensor(items)), 40)
        assert torch.equal(ids, want_ids) and torch.equal(got.view(torch.int32), want.view(torch.int32))

    @pytest.mark.parametrize("items", [101, 3000])
    def test_sharded_int8_is_bit_equal_to_replicated(self, mesh, items):
        """The port's sharded two-stage kernel against its replicated one:
        ids and rescored scores to the bit, with the rescore at the
        replicated width even where a shard over-fetches fewer rows
        (101 items: 13 rows a shard, ``kp`` 80), and ties across shards."""
        uf, vf = _factors(300, items, 24, seed=items)
        vf[5:13] = vf[5]
        uf[0] = vf[5]
        info = sharding.ShardInfo(mesh, {"user": 300, "item": items})
        uq, iq = port_quant.quantize_table(uf, CPU), port_quant.quantize_table(vf, CPU)
        us, is_ = sharding.shard_quantized_table(uf, mesh), sharding.shard_quantized_table(vf, mesh)
        rt = port_quant.QuantRuntime("int8", {}, 0)
        for k in (1, 10, 64):
            want_ids, want = port_quant.topk_users(rt, uq, iq, np.arange(64), k)
            ids, got = port_quant.topk_users(rt, us, is_, np.arange(64), k, shards=info)
            np.testing.assert_array_equal(ids, want_ids)
            assert np.array_equal(got.view(np.int32), want.view(np.int32))

    def test_gather_and_set_rows_touch_only_owner_shards(self, mesh):
        mat = np.arange(37 * 3, dtype=np.float32).reshape(37, 3)
        table = sharding.shard_table(mat, mesh)
        assert table.shape == (40, 3) and table.rows_per_shard == 5
        np.testing.assert_array_equal(sharding.gather_rows([36, 0, 5, 19], table).numpy(), mat[[36, 0, 5, 19]])
        new = np.full((2, 3), -1.0, np.float32)
        out = sharding.set_rows(table, [6, 38], new)  # shard 1, and a padding slot of shard 7
        changed = [s for s in range(S) if out.shards[s] is not table.shards[s]]
        assert changed == [1, 7]
        host = np.asarray(out)
        np.testing.assert_array_equal(host[[6, 38]], new)
        np.testing.assert_array_equal(np.delete(host, [6, 38], axis=0), np.delete(np.asarray(table), [6, 38], axis=0))
        np.testing.assert_array_equal(np.asarray(table)[:37], mat)  # the old table is intact
        with pytest.raises(IndexError):
            sharding.set_rows(table, [40], new[:1])

    @pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
    def test_cold_starts_fill_padding_then_relayout(self, mesh, quantized):
        """``swap_side_rows`` on a sharded model: a fresh user lands in a
        padding slot (no re-layout, the other shards shared), a burst past
        the padding lays the table out anew with ``GROW_STEP`` headroom, and
        the logical count advances with each."""
        from predictionio_tpu_torch.data.aggregator import BiMap

        rng = np.random.default_rng(5)
        mat = rng.standard_normal((61, 4)).astype(np.float32)
        place = sharding.shard_quantized_table if quantized else sharding.shard_table
        model = types.SimpleNamespace(
            user_factors=place(mat, mesh), user_index=BiMap.string_index([f"u{i}" for i in range(61)]),
            _pio_shards=sharding.ShardInfo(mesh, {"user": 61, "item": 0}),
        )
        before = model.user_factors
        row = rng.standard_normal((1, 4)).astype(np.float32)
        assert port_device_state.swap_side_rows(model, ["fresh"], row, "user_factors", "user_index", True) == (0, 1)
        assert model._pio_shards.rows["user"] == 62 and model.user_index["fresh"] == 61
        codes = (lambda t: t.codes) if quantized else (lambda t: t)
        assert codes(model.user_factors).shape[0] == 64  # still the padded layout
        assert sum(a is not b for a, b in zip(codes(model.user_factors).shards, codes(before).shards)) == 1
        burst = rng.standard_normal((5, 4)).astype(np.float32)
        names = [f"b{i}" for i in range(5)]
        port_device_state.swap_side_rows(model, names, burst, "user_factors", "user_index", True)
        assert model._pio_shards.rows["user"] == 67
        assert codes(model.user_factors).shape[0] == sharding.padded_rows(67 + sharding.GROW_STEP, S)
        got = port_device_state.get_rows(model.user_factors, np.arange(67))
        want = np.concatenate([mat, row, burst])
        if quantized:
            want = port_quant.dequantize(*port_quant.quantize_table_host(want))
        np.testing.assert_array_equal(got, want)

    def test_one_device_pins_replicated_with_the_warning(self, caplog):
        """With one device visible there is no mesh: the shard hook logs the
        JAX package's warning and pins replicated (``factorShards`` 0)."""
        uf, vf = _factors(12, 20, 4, seed=3)
        algo = port_recommendation.ALSAlgorithm(port_recommendation.ALSAlgorithmParams(), device="cpu")
        model = port_recommendation.ALSModel(
            uf, vf, port_aggregator.BiMap.string_index([f"u{i}" for i in range(12)]),
            port_aggregator.BiMap.string_index([f"i{i}" for i in range(20)]),
        )
        assert sharding.serving_mesh(device="cpu") is None
        with caplog.at_level(logging.WARNING):
            model, nbytes = algo.shard_model_for_serving(model)
        assert "only one device is visible; falling back to --pin-model replication" in caplog.text
        assert getattr(model, "_pio_shards", None) is None and isinstance(model.user_factors, torch.Tensor)
        assert nbytes == uf.nbytes + vf.nbytes
        assert port_device_state.shard_count([(algo, model)]) == 0

    def test_local_devices_is_scoped(self):
        assert sharding.serving_mesh(device="cpu") is None
        with sharding.local_devices(["cpu", "cpu"]) as devs:
            assert devs == (CPU, CPU) and sharding.serving_mesh(device="cpu") == (CPU, CPU)
            with sharding.local_devices(["cpu"] * 3):
                assert len(sharding.serving_mesh()) == 3 and sharding.serving_mesh(shards=2).shape == {"model": 2}
            assert len(sharding.serving_mesh()) == 2
        assert sharding.serving_mesh(device="cpu") is None
