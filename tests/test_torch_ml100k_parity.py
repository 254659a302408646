"""MovieLens-100K quickstart parity (BASELINE.md configs[0]) on the port:
``tests/test_ml100k_parity.py``'s classes run on
``predictionio_tpu_torch``, on the CPU.

The documented quickstart end to end: the train split as events into the
port's columnar store, the port's ``run_train`` through its
Recommendation template (rank 10, 10 iterations, lambda 0.1), the model
re-hydrated from the Models repo. The held-out RMSE must be inside the
JAX test's band on the replica (0.78-0.88), more than 0.2 below the
mean-only predictor's, and within 3 % of an independent numpy ALS
(``bench.py``'s ``_cpu_als_sweep``) — once with ``ALSConfig.bucketing``
at "auto" (the host path on the CPU) and once forced to "device" (the
torch sort and fills the card runs, here on CPU tensors).

``load_ml100k`` must parse a ``u.data`` exactly as the JAX package's
loader does. ``ML100K_PATH=/path/to/u.data`` runs the parity test against
the real file; without it the tests use the deterministic replica.
"""

import functools

import numpy as np
import pytest

from predictionio_tpu.utils import movielens as jax_movielens
from predictionio_tpu_torch.ops import als as torch_als
from predictionio_tpu_torch.utils.movielens import (
    ML100K_HISTOGRAM,
    load_ml100k,
    ml100k_dataset,
    synthesize_ml100k,
)

RANK, ITERS, LAMBDA = 10, 10, 0.1


@pytest.fixture(scope="module")
def split():
    u, i, r, t, source = ml100k_dataset()
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(r))
    n_te = len(r) // 10
    return u, i, r, perm[n_te:], perm[:n_te], source


@pytest.fixture(scope="module")
def reference_rmse(split):
    """The independent same-algorithm reference: the tuned numpy ALS over
    the port's host buckets."""
    import bench as bench_mod

    u, i, r, tr, te, _ = split
    ub = torch_als.build_buckets(u[tr], i[tr], r[tr], 943, 1682)
    ib = torch_als.build_buckets(i[tr], u[tr], r[tr], 1682, 943)
    rng = np.random.default_rng(1)
    cu = np.abs(rng.normal(size=(944, RANK))).astype(np.float32) / np.sqrt(RANK)
    cv = np.abs(rng.normal(size=(1683, RANK))).astype(np.float32) / np.sqrt(RANK)
    for _ in range(ITERS):
        cu, cv = bench_mod._cpu_als_sweep(ub, ib, cu, cv, RANK, reg=LAMBDA)
    return _rmse(cu[:943], cv[:1682], u, i, r, te)


def _rmse(uf, vf, u, i, r, idx):
    pred = np.einsum("nk,nk->n", uf[u[idx]], vf[i[idx]])
    return float(np.sqrt(np.mean((pred - r[idx]) ** 2)))


class TestReplicaShape:
    def test_exact_ml100k_marginals(self):
        u, i, r, t = synthesize_ml100k()
        assert len(r) == 100_000
        assert u.max() + 1 == 943 and i.max() + 1 == 1682
        assert tuple(np.bincount(r.astype(int))[1:]) == ML100K_HISTOGRAM
        assert np.bincount(u).min() >= 20  # the real dataset's floor
        # deterministic: a second draw is identical
        u2, i2, r2, t2 = synthesize_ml100k()
        assert (u == u2).all() and (r == r2).all()


class TestQuickstartParity:
    @pytest.mark.parametrize("bucketing", ["auto", "device"])
    def test_pipeline_rmse_band_and_reference_parity(self, split, reference_rmse, tmp_path, monkeypatch,
                                                      bucketing):
        from predictionio_tpu_torch.controller import local_context
        from predictionio_tpu_torch.data.storage import Storage
        from predictionio_tpu_torch.data.storage.base import App
        from predictionio_tpu_torch.templates.recommendation import engine as rec_engine
        from predictionio_tpu_torch.workflow import load_engine_variant, run_train

        # the template builds its ALSConfig; bucketing reaches it through it
        monkeypatch.setattr(rec_engine, "ALSConfig", functools.partial(torch_als.ALSConfig, bucketing=bucketing))
        device_calls = []
        real = torch_als.build_buckets_device
        monkeypatch.setattr(torch_als, "build_buckets_device",
                            lambda *a, **k: device_calls.append(a[3:5]) or real(*a, **k))
        u, i, r, tr, te, source = split
        Storage.configure(
            {
                "PIO_FS_BASEDIR": str(tmp_path / "base"),
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
                "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "COL",
                "PIO_STORAGE_SOURCES_COL_TYPE": "columnar",
                "PIO_STORAGE_SOURCES_COL_PATH": str(tmp_path / "ml"),
            }
        )
        try:
            app_id = Storage.get_meta_data_apps().insert(App(id=0, name="ml100k"))
            Storage.get_p_events().write_columns(
                app_id,
                event="rate",
                entity_type="user",
                entity_codes=u[tr],
                entity_vocab=np.asarray([str(x) for x in range(943)]),
                target_entity_type="item",
                target_codes=i[tr],
                target_vocab=np.asarray([str(x) for x in range(1682)]),
                event_time_us=np.full(tr.size, 1_600_000_000_000_000, np.int64),
                props={"rating": r[tr].astype(np.float64)},
            )
            variant = load_engine_variant(
                {
                    "id": "ml100k-quickstart",
                    "version": "1",
                    "engineFactory": "predictionio_tpu.templates.recommendation:engine_factory",
                    "datasource": {"params": {"appName": "ml100k"}},
                    "algorithms": [
                        {
                            "name": "als",
                            "params": {"rank": RANK, "numIterations": ITERS, "lambda": LAMBDA, "seed": 1},
                        }
                    ],
                }
            )
            instance = run_train(variant, local_context("cpu"))
            assert instance.status == "COMPLETED"
            # re-hydrate the model exactly as deploy would
            engine = variant.build_engine()
            ep = variant.engine_params(engine)
            blob = Storage.get_model_data_models().get(instance.id)
            (_name, model), = engine.models_from_bytes(ep, instance.id, blob.models)
            uf = np.zeros((943, RANK), np.float32)
            vf = np.zeros((1682, RANK), np.float32)
            for key, row in model.user_index.to_dict().items():
                uf[int(key)] = model.user_factors[row]
            for key, row in model.item_index.to_dict().items():
                vf[int(key)] = model.item_factors[row]
        finally:
            Storage.configure(None)
        # "auto" buckets on the host on the CPU; "device" takes the device path for both sides
        users, items = len(model.user_index), len(model.item_index)
        assert device_calls == ([] if bucketing == "auto" else [(users, items), (items, users)])

        test_rmse = _rmse(uf, vf, u, i, r, te)
        mean_only = float(np.sqrt(np.mean((r[tr].mean() - r[te]) ** 2)))
        # the JAX test's band on the deterministic replica; on the real
        # file the mean-only guard alone
        if "replica" in source:
            assert 0.78 <= test_rmse <= 0.88, test_rmse
        assert test_rmse < mean_only - 0.2
        # same algorithm, independent implementation: agree within 3%
        assert abs(test_rmse - reference_rmse) / reference_rmse < 0.03, (test_rmse, reference_rmse)


def test_load_ml100k_parses_as_the_jax_loader(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    n = 50
    rows = np.stack([rng.integers(1, 944, n), rng.integers(1, 1683, n), rng.integers(1, 6, n),
                     874_724_710 + rng.integers(0, 10**6, n)], axis=1)
    path = tmp_path / "u.data"
    path.write_text("".join("\t".join(str(v) for v in row) + "\n" for row in rows.tolist()))
    got = load_ml100k(str(path))
    want = jax_movielens.load_ml100k(str(path))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], rows[:, 0] - 1)
    monkeypatch.setenv("ML100K_PATH", str(path))
    *arrays, source = ml100k_dataset()
    assert source == "movielens-100k (real)"
    for g, w in zip(arrays, got):
        np.testing.assert_array_equal(g, w)
    (tmp_path / "bad").write_text("1\t2\t3\n4\t5\t6\n")
    with pytest.raises(ValueError, match="not a MovieLens"):
        load_ml100k(str(tmp_path / "bad"))
