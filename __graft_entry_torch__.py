"""Entry points of the PyTorch port: a single-card forward step and
a training dry run on a mesh.

``entry()`` returns the flagship serving step (ALS recommendation
scoring) and its example args, on the card unless the caller asks for
the CPU.

``dryrun_multichip(n)`` runs the training path on an ``n``-position mesh
(:class:`~predictionio_tpu_torch.controller.context.TrainingMesh`): one
ALS sweep, explicit and implicit, with the factor tables split over the
``model`` axis and hot rows split into segments, then one Two-Tower
epoch. Torch fixes no device count at start-up, so the mesh is built in
this process; by default every position is the one card.

    python -c 'import __graft_entry_torch__ as g; g.dryrun_multichip(8)'
"""

from __future__ import annotations

import numpy as np
import torch

from predictionio_tpu_torch.controller.context import mesh_context
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.als import ALSConfig, score_rows, train_als
from predictionio_tpu_torch.ops.topk import top_k_scores
from predictionio_tpu_torch.ops.twotower import TwoTowerConfig, train_two_tower

__all__ = ["DRYRUN_ALS", "DRYRUN_SHAPE", "dryrun_multichip", "dryrun_ratings", "entry"]

#: the dry run's ratings: users, items, ratings, the Zipf exponent of the
#: items' popularity, the seed
DRYRUN_SHAPE = (2048, 1024, 100_000, 0.8, 0)

#: the dry run's ALS settings: capped bucket widths and small chunks so
#: that hot rows split into segments and group on every position
DRYRUN_ALS = dict(rank=16, iterations=1, reg=0.1, alpha=10.0, bucket_widths=(8, 16, 32),
                  chunk_entries=1 << 13, hot_group_slots=128)


def entry(device: str | torch.device | None = None):
    """The forward step and its example args, on ``device`` (default: the
    card; raises where there is none).

    The flagship serving computation: score a batch of users against the
    whole catalog and take the top-k, as the Recommendation template's
    ``predict`` does on the card: the product through the port's one
    scoring function (``ops/als.py::score_rows``) and the top-k under
    ``jax.lax.top_k``'s tie rule (``ops/topk.py::top_k_scores``)."""
    dev = resolve_device(device)
    num_users, num_items, rank, k = 512, 2048, 64, 10

    def forward(user_factors, item_factors, user_ids):
        vecs = user_factors[user_ids]  # [B, K]
        scores = score_rows(vecs, item_factors)  # [B, I]
        indices, values = top_k_scores(scores, k)
        return indices, values

    rng = np.random.default_rng(0)
    example_args = (
        torch.as_tensor(rng.normal(size=(num_users, rank)), dtype=torch.float32, device=dev),
        torch.as_tensor(rng.normal(size=(num_items, rank)), dtype=torch.float32, device=dev),
        torch.as_tensor(rng.integers(0, num_users, size=64), dtype=torch.int64, device=dev),
    )
    return forward, example_args


def dryrun_ratings() -> tuple:
    """The dry run's COO ratings ``(rows, cols, vals, num_users,
    num_items)``: uniform users, Zipf(0.8) items, ratings uniform in [1, 5)."""
    num_users, num_items, nnz, zipf, seed = DRYRUN_SHAPE
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, num_users, size=nnz)
    weights = 1.0 / np.arange(1, num_items + 1) ** zipf
    cols = rng.choice(num_items, size=nnz, p=weights / weights.sum())
    vals = rng.uniform(1, 5, size=nnz).astype(np.float32)
    return rows, cols, vals, num_users, num_items


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None) -> dict:
    """Train on an ``n_devices``-position mesh of ``device`` (default: the
    card; every position the same device) and check the results.

    The mesh is ``(n/2, 2)`` over (``data``, ``model``), or ``(n, 1)`` for
    an odd ``n``: the ``data`` axis splits the bucket rows, the ``model``
    axis the factor tables. One ALS sweep runs per objective (explicit,
    implicit), then one Two-Tower epoch at dim 16 on the first 10,000
    pairs. Asserts the shapes and that every factor is finite, prints one
    ``dryrun_multichip OK`` line and returns the mesh shape, the ALS
    factors by objective and the Two-Tower model."""
    dev = resolve_device(device)
    model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = mesh_context((n_devices // model, model), devices=[dev] * n_devices).mesh
    rows, cols, vals, num_users, num_items = dryrun_ratings()
    rank = DRYRUN_ALS["rank"]

    als = {}
    for implicit in (False, True):
        factors = train_als(rows, cols, vals, num_users, num_items,
                            ALSConfig(implicit=implicit, **DRYRUN_ALS), mesh=mesh)
        user = factors.user.detach().cpu().numpy()
        assert user.shape == (num_users, rank), user.shape
        assert factors.item.shape == (num_items, rank), tuple(factors.item.shape)
        assert np.isfinite(user).all(), "non-finite factors from the mesh's sweep"
        als["implicit" if implicit else "explicit"] = factors

    tt = train_two_tower(rows[:10_000], cols[:10_000], num_users, num_items,
                         TwoTowerConfig(dim=16, batch_size=256, epochs=1), mesh=mesh)
    assert tt.user_vecs.shape == (num_users, 16), tt.user_vecs.shape
    assert np.isfinite(tt.user_vecs).all(), "non-finite tower vectors"
    print(f"dryrun_multichip OK on {n_devices} positions of {dev}: mesh {dict(mesh.shape)}")
    return {"mesh": dict(mesh.shape), "als": als, "two_tower": tt}
