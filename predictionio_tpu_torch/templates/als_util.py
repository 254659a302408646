"""Shared code of the two implicit-ALS templates (Similar-Product and
E-Commerce): item categories, the multi-process pair counts and their
COO, and the implicit ALS call. A helper module directly under
``templates/``, so each template stays copy-out-able on its own.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from predictionio_tpu_torch.controller import TorchAlgorithm, WorkflowContext
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.store import PEventStore
from predictionio_tpu_torch.ops.als import ALSConfig, train_als

__all__ = ["implicit_als", "keyed_coo", "read_categories", "sharded_pair_counts"]


def read_categories(app_name: str, entity_type: str) -> dict[str, tuple]:
    """Each item's current ``$set`` ``categories`` (both ALS templates)."""
    return {
        item_id: tuple(str(c) for c in pm.opt("categories", list, []))
        for item_id, pm in PEventStore.aggregate_properties(app_name=app_name, entity_type=entity_type).items()
    }


def sharded_pair_counts(ctx: WorkflowContext, app_name: str, weights: dict) -> dict:
    """Multi-process read of both ALS templates: this process's shard of
    the events, each (user, item) pair's weighted count, summed across
    the processes by user (every pair then lives on one process)."""
    import operator

    from predictionio_tpu_torch.parallel.exchange import merge_keyed

    counts: dict[tuple[str, str], float] = {}
    for e in PEventStore.find(
        app_name=app_name, event_names=list(weights), shard_index=ctx.host_index, num_shards=ctx.num_hosts,
    ):
        if e.target_entity_id is None:
            continue
        key = (e.entity_id, e.target_entity_id)
        counts[key] = counts.get(key, 0.0) + weights[e.event]
    return merge_keyed(counts, combine=operator.add)


def keyed_coo(counts: dict, categories: dict) -> tuple:
    """``(rows, cols, vals, user_index, item_index)`` of this process's
    merged counts, in the job's BiMaps: every process builds the same ones
    from the sorted vocabularies (items: counted and ``$set``-only)."""
    from predictionio_tpu_torch.parallel.exchange import global_vocab

    user_index = BiMap.string_index(global_vocab(u for u, _ in counts))
    item_index = BiMap.string_index(global_vocab(list(i for _, i in counts) + list(categories)))
    n = len(counts)
    rows = np.fromiter((user_index[u] for u, _ in counts), np.int64, n)
    cols = np.fromiter((item_index[i] for _, i in counts), np.int64, n)
    vals = np.fromiter(counts.values(), np.float32, n)
    return rows, cols, vals, user_index, item_index


def implicit_als(algo: TorchAlgorithm, pd, p, mesh=None) -> Any:
    """Implicit ALS of the two ALS templates on ``algo.device``, or on
    ``mesh`` (the JAX package's ``ALSConfig``; ``algo.on_sweep`` goes to
    :func:`train_als`)."""
    return train_als(
        pd.rows, pd.cols, pd.vals,
        num_users=len(pd.user_index), num_items=len(pd.item_index),
        config=ALSConfig(
            rank=p.rank, iterations=p.num_iterations, reg=p.lambda_,
            implicit=True, alpha=p.alpha, seed=0 if p.seed is None else p.seed,
        ),
        device=algo.device,
        on_sweep=algo.on_sweep,
        mesh=mesh,
    )
