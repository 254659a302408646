"""The port's IVF and int8 retrieval against the JAX package's, on the same
inputs (numpy in, made from a seed).

* The quantizers: ``quantize_table_host`` and ``quantize_rows`` of both
  packages bit-equal, rows with exact ``.5`` quotients included.
* The merges: ``top_k_permuted`` (both ``big_ids`` values) and
  ``sort_merge_topk`` bit-equal on adversarial ties (repeated scores,
  ``-0.0`` beside ``0.0``, ``-inf``).
* One JAX-built index (f32 and int8 slabs) fed to both packages
  (``convert.ivf_index_from_numpy``): ``ivf_topk_batch`` at partial
  probes gives the same ids and scores within 1e-6 relative (near-tie
  rule: where the ids differ, the scores at that rank tie within 1e-6);
  ``quantized_topk_batch`` on one int8 table (``convert``'s int8 table
  converter) likewise; ``update_ivf`` on
  the same deltas (in place, moved, new items past the capacity step)
  gives bit-equal slabs, slab ids and scales.
* The build: ``jax.random`` cannot be replayed, so the port's k-means++
  draw differs; given the JAX build the port's initial centroids, both
  packages' Lloyd, final assignment, balancing and layout agree (slab ids
  equal, slabs equal, centroids within 1e-5).
* One fold through both packages' ``QueryService`` under ``--ann
  --quantize int8`` (``tests/test_torch_online_parity.py``'s store and
  events): the solved rows within rtol 1e-4, atol 1e-5; each package's
  touched int8 rows are ``quantize_table_host`` of its own solved rows,
  every other row's codes and scales bit-equal between the packages; the
  same infos and index counters.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from predictionio_tpu.ops import ivf as jax_ivf
from predictionio_tpu.ops import quant as jax_quant
from predictionio_tpu.ops import topk as jax_topk
from predictionio_tpu.online import OnlineConfig as JaxOnlineConfig
from predictionio_tpu.serving import AnnConfig as JaxAnnConfig
from predictionio_tpu.serving import CacheConfig as JaxCacheConfig
from predictionio_tpu.workflow import load_engine_variant as jax_load_variant
from predictionio_tpu.workflow import serving as jax_serving
from predictionio_tpu_torch import convert
from predictionio_tpu_torch.controller.context import local_context
from predictionio_tpu_torch.online import OnlineConfig
from predictionio_tpu_torch.ops import ivf, quant, topk
from predictionio_tpu_torch.serving import AnnConfig, CacheConfig
from predictionio_tpu_torch.workflow import load_engine_variant
from predictionio_tpu_torch.workflow import serving as port_serving
from test_ivf import clustered_factors
from test_torch_online_parity import FOLD_ATOL, FOLD_RTOL, VARIANT, _events, store  # noqa: F401

from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import Storage as JaxStorage

RTOL = 1e-6


def _near_tie_equal(ids_a, s_a, ids_b, s_b, rtol=RTOL) -> None:
    """Equal ids, or, where they differ, scores at that rank within
    ``rtol``; scores everywhere within ``rtol``."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    s_a, s_b = np.asarray(s_a, np.float64), np.asarray(s_b, np.float64)
    assert ids_a.shape == ids_b.shape
    finite = np.isfinite(s_a)
    assert np.array_equal(finite, np.isfinite(s_b))
    np.testing.assert_allclose(s_a[finite], s_b[finite], rtol=rtol, atol=rtol)
    differ = ids_a != ids_b
    assert np.all(np.abs(s_a[differ] - s_b[differ]) <= rtol * np.maximum(np.abs(s_a[differ]), 1.0))


# --------------------------------------------------------------- quantizers
def test_quantizers_are_bit_equal_across_packages():
    rng = np.random.default_rng(40)
    mats = [rng.standard_normal((257, 24)).astype(np.float32) * np.float32(10.0 ** e) for e in (-3, 0, 3)]
    # exact .5 quotients: amax 127 gives scale 1, so x.5 rounds half to even
    halves = np.asarray([[127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 63.5, -126.5]], np.float32)
    zero = np.zeros((2, 8), np.float32)
    for mat in mats + [halves, zero]:
        want = jax_quant.quantize_table_host(mat)
        traced = jax_quant.quantize_rows(jnp.asarray(mat))
        for got in (quant.quantize_table_host(mat), quant.quantize_rows(torch.as_tensor(mat))):
            for g, w, t in zip(got, want, traced):
                np.testing.assert_array_equal(np.asarray(g), w)
                np.testing.assert_array_equal(np.asarray(g), np.asarray(t))
    assert quant.quantize_table_host(halves)[0].tolist() == [[127, 0, 2, 2, -2, 0, 64, -126]]


# ------------------------------------------------------------------ merges
@pytest.mark.parametrize("big_ids", [False, True])
def test_merges_are_bit_equal_on_adversarial_ties(big_ids):
    rng = np.random.default_rng(41)
    for n, k in ((37, 5), (37, 36), (150, 1), (150, 64)) * 3:
        s = rng.choice([-np.inf, -1.5, -0.0, 0.0, 0.25, 0.25, 1.0], size=(4, n)).astype(np.float32)
        ids = np.stack([rng.permutation(n) for _ in range(4)]).astype(np.int32)
        wi, ws = jax_topk.top_k_permuted(jnp.asarray(s), jnp.asarray(ids), k, big_ids=big_ids)
        gi, gs = topk.top_k_permuted(torch.as_tensor(s), torch.as_tensor(ids), k, big_ids=big_ids)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        wi, ws = jax_topk.sort_merge_topk(jnp.asarray(s), jnp.asarray(ids), k)
        gi, gs = topk.sort_merge_topk(torch.as_tensor(s), torch.as_tensor(ids), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


# ------------------------------------------------------------ one index
def _port_index(jax_index):
    return convert.ivf_index_from_numpy(**convert.ivf_index_to_numpy(jax_index), device="cpu")


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_one_index_probes_alike_in_both_packages(quantize):
    x = clustered_factors(3000, dim=16, n_centers=40, seed=42)
    q = clustered_factors(96, dim=16, n_centers=40, seed=43)
    jax_index, _ = jax_ivf.build_ivf(x, nlist=24, seed=0, iters=4, quantize=quantize)
    port_index = _port_index(jax_index)
    assert port_index.slabs.dtype == (torch.int8 if quantize else torch.float32)
    for nprobe in (1, 4, 12, 23):
        wi, ws = jax_ivf.ivf_topk_batch(jnp.asarray(q), jax_index, 32, nprobe)
        gi, gs = ivf.ivf_topk_batch(torch.as_tensor(q), port_index, 32, nprobe)
        _near_tie_equal(gi.numpy(), gs.numpy(), np.asarray(wi), np.asarray(ws))


def test_one_int8_table_two_stage_topk_alike():
    rng = np.random.default_rng(44)
    items = rng.standard_normal((2000, 24)).astype(np.float32)
    items[10:18] = items[10]  # ties: equal rows quantize equally
    q = rng.standard_normal((64, 24)).astype(np.float32)
    codes, scales = quant.quantize_table_host(items)
    for k, kp, num_items in ((16, 80, 2000), (10, 74, 1990)):
        wi, ws = jax_quant.quantized_topk_batch(
            jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales), k, kp, jnp.asarray(num_items, jnp.int32)
        )
        table = convert.quantized_table_from_numpy(codes, scales, device="cpu")
        gi, gs = quant.quantized_topk_batch(torch.as_tensor(q), table.codes, table.scales, k, kp, num_items)
        _near_tie_equal(gi.numpy(), gs.numpy(), np.asarray(wi), np.asarray(ws))


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_update_ivf_writes_the_same_slabs(quantize):
    x = clustered_factors(1500, dim=16, n_centers=20, seed=45)
    jax_index, _ = jax_ivf.build_ivf(x, nlist=12, seed=0, iters=3, quantize=quantize)
    port_index = _port_index(jax_index)
    rng = np.random.default_rng(46)
    jax_state = port_state = None
    # in place / moved rows, then new items past the capacity step, then
    # enough new items in one region to spill and widen the slabs
    deltas = [
        (np.asarray([0, 17, 1499, 700]), 1500),
        (np.arange(1500, 1530), 1530),
        (np.arange(1530, 1530 + 3 * jax_index.slab_width), 1530 + 3 * jax_index.slab_width),
    ]
    for step, (ids, total) in enumerate(deltas):
        if step == 2:
            vecs = np.tile(np.asarray(jax_index.centroids)[0], (ids.size, 1)).astype(np.float32)
        else:
            vecs = clustered_factors(ids.size, dim=16, n_centers=20, seed=47 + step)
        vecs += 0.01 * rng.standard_normal(vecs.shape).astype(np.float32)
        jax_index, jax_state, jax_info = jax_ivf.update_ivf(jax_index, ids, vecs, total, jax_state)
        port_index, port_state, port_info = ivf.update_ivf(port_index, ids, vecs, total, port_state)
        assert port_info == jax_info
        want, got = convert.ivf_index_to_numpy(jax_index), convert.ivf_index_to_numpy(port_index)
        for key in ("slabs", "slab_ids", "slab_scales", "num_items", "nlist", "slab_width"):
            if want[key] is None:
                assert got[key] is None
            else:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_lloyd_and_layout_from_the_same_initial_centroids(monkeypatch):
    x = clustered_factors(2500, dim=16, n_centers=30, seed=48)
    nlist = 20
    init = ivf.seed_centroids(torch.as_tensor(x), nlist, seed=3).numpy()
    # the JAX build seeds with the port's centroids; everything after is its own
    monkeypatch.setattr(jax_ivf, "_kmeans_pp", lambda key, sample, n: jnp.asarray(init))
    for balance in (1.3, 0.0):
        jax_index, jax_info = jax_ivf.build_ivf(x, nlist=nlist, seed=3, iters=5, balance=balance)
        port_index, port_info = ivf.build_ivf(x, nlist=nlist, seed=3, iters=5, balance=balance, device="cpu")
        np.testing.assert_allclose(port_index.centroids.numpy(), np.asarray(jax_index.centroids), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(port_index.slab_ids.numpy(), np.asarray(jax_index.slab_ids))
        np.testing.assert_array_equal(port_index.slabs.numpy(), np.asarray(jax_index.slabs))
        for key in ("nlist", "slabWidth", "fill", "emptyClusters", "bytesIndex"):
            assert port_info[key] == jax_info[key], key


def test_the_port_build_is_deterministic_per_seed():
    x = clustered_factors(1200, dim=16, seed=49)
    a, _ = ivf.build_ivf(x, nlist=10, seed=7, iters=3, device="cpu")
    b, _ = ivf.build_ivf(x, nlist=10, seed=7, iters=3, device="cpu")
    c, _ = ivf.build_ivf(x, nlist=10, seed=8, iters=3, device="cpu")
    assert torch.equal(a.centroids, b.centroids) and torch.equal(a.slab_ids, b.slab_ids)
    assert not torch.equal(a.centroids, c.centroids)


# ----------------------------------------------------- one fold, both servers
def _recording_updates(qs) -> list:
    seen: list = []
    apply = qs.apply_online_update

    def record(updates, generation=None):
        seen.append((list(updates), apply(updates, generation=generation)))
        return seen[-1][1]

    qs.apply_online_update = record
    return seen


def test_one_fold_under_ann_and_int8_swaps_the_same_rows(store, tmp_path):  # noqa: F811
    jax_qs = jax_serving.QueryService(
        jax_load_variant(VARIANT),
        cache=JaxCacheConfig(quantize="int8"),
        ann=JaxAnnConfig(enabled=True, nlist=6, nprobe=6, kmeans_iters=3),
        online=JaxOnlineConfig(enabled=True, interval_s=600.0, state_dir=str(tmp_path / "jax-cursor")),
    )
    port_qs = port_serving.QueryService(
        load_engine_variant(VARIANT), local_context("cpu"),
        cache=CacheConfig(quantize="int8"),
        ann=AnnConfig(enabled=True, nlist=6, nprobe=6, kmeans_iters=3),
        online=OnlineConfig(enabled=True, interval_s=600.0, state_dir=str(tmp_path / "port-cursor")),
    )
    try:
        services = (jax_qs, port_qs)
        for qs in services:
            qs.online.stop()
        models = [qs.snapshot_pairs()[0][0][1] for qs in services]
        before = [
            {a: tuple(np.asarray(getattr(getattr(m, a), p).cpu() if isinstance(getattr(getattr(m, a), p), torch.Tensor)
                                 else getattr(getattr(m, a), p)).copy() for p in ("codes", "scales"))
             for a in ("user_factors", "item_factors")}
            for m in models
        ]
        for a in ("user_factors", "item_factors"):  # one trained blob, one quantizer
            for j in (0, 1):
                np.testing.assert_array_equal(before[0][a][j], before[1][a][j])
        records = [_recording_updates(qs) for qs in services]
        JaxStorage.get_l_events().insert_batch(_events(JaxEvent, JaxDataMap), store["app_id"])
        folds = [qs.dispatch("POST", "/online/fold.json", {}, None) for qs in services]
        assert [(f.status, f.body) for f in folds] == [(200, {"events": 28, "applied": True})] * 2
        (jax_upd,), (port_upd,) = (rec[0][0] for rec in records)
        jax_res, port_res = (rec[0][1] for rec in records)
        strip = [{k: v for k, v in info.items() if k != "ann"} for info in (jax_res["infos"][0], port_res["infos"][0])]
        assert strip[0] == strip[1] and strip[1]["usersAdded"] == 1 and strip[1]["itemsAdded"] == 1
        for side in ("user", "item"):
            assert getattr(port_upd[1], f"{side}_ids") == getattr(jax_upd[1], f"{side}_ids")
            np.testing.assert_allclose(getattr(port_upd[1], f"{side}_rows"), getattr(jax_upd[1], f"{side}_rows"),
                                       rtol=FOLD_RTOL, atol=FOLD_ATOL)
        models = [qs.snapshot_pairs()[0][0][1] for qs in services]
        for side, attr in (("user", "user_factors"), ("item", "item_factors")):
            per_pkg = []
            for model, (_, upd), old in zip(models, (jax_upd, port_upd), before):
                table = getattr(model, attr)
                codes, scales = convert.quantized_table_to_numpy(table)
                rows = [getattr(model, f"{side}_index")[e] for e in getattr(upd, f"{side}_ids")]
                want_c, want_s = quant.quantize_table_host(getattr(upd, f"{side}_rows"))
                np.testing.assert_array_equal(codes[rows], want_c)
                np.testing.assert_array_equal(scales[rows], want_s)
                untouched = np.setdiff1d(np.arange(len(old[attr][1])), rows)
                np.testing.assert_array_equal(codes[untouched], old[attr][0][untouched])
                per_pkg.append((codes, scales, rows))
            assert per_pkg[0][2] == per_pkg[1][2]
        ann = [qs.stats_json()["ann"]["models"][0] for qs in services]
        for key in ("incrementalUpdates", "itemsFolded", "quantized", "nlist"):
            assert ann[0][key] == ann[1][key], key
        assert ann[1]["itemsFolded"] > 0
    finally:
        jax_qs.close()
        port_qs.close()
