"""Batched eval sweeps: ``pio eval --grid``.

Counterpart of ``predictionio_tpu/experiments/sweep.py``.
``MetricEvaluator`` trains one candidate at a time — C candidates pay C
full train sequences even when every candidate shares the data and the
array shapes. When the grid is *batch-compatible* (one shared
datasource/preparator/serving config, one algorithm whose candidates
differ only along the scalar axes ``lambda`` / ``alpha`` / ``seed``),
this module trains ALL candidates as one batched torch program on the
context's device: a dense per-fold ALS (normal-equation half-sweeps,
explicit and implicit) with the ranking metric computed in the same
program, so one call per fold scores the whole grid. The candidate axis
is an explicit leading dimension ``[C, ...]`` of every tensor (the JAX
package ``vmap``s it).

The solve is ``torch.linalg.solve`` (batched LU, as the reference's
``jnp.linalg.solve``), not the ``gj_solve`` kernel: a grid may hold
λ = 0, and then padded rows give singular systems, which Gauss-Jordan
without pivoting cannot take. The Gramian ``Σ_i M[u,i] f_i f_iᵀ`` is one
GEMM, ``M @ (F ⊗ F).reshape(I, K*K)``, never a ``[C, U, I, K]``
intermediate. Top-k takes ``ops.topk.top_k_scores`` (the
``jax.lax.top_k`` order, ties to the lowest index), so hit counts match
the reference where blocked ``-inf`` entries tie.

Fold matrices are padded to pow2 user/item buckets. Grids that are not
batch-compatible (different ranks, several algorithms, different
datasources), or whose padded fold would pass the dense-cell budget,
fall back to the sequential ``MetricEvaluator`` with a logged reason —
``pio eval --grid`` never fails where ``pio eval`` would succeed.

The in-program metric is precision@k with train-seen masking, matching
the recommendation template's ``PrecisionAtK`` unit semantics (held-out
positives hit / k served unseen items, averaged over eval users,
fold-weighted by eval-user count). Candidates are RANKED by this score;
the sequential path remains the reference for absolute metric values.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import time
import uuid

import numpy as np
import torch

from predictionio_tpu_torch.controller.evaluation import (
    MetricEvaluator,
    MetricEvaluatorResult,
    MetricScores,
)
from predictionio_tpu_torch.controller.params import params_to_json
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.topk import top_k_scores

__all__ = ["grid_axes", "GridAxes", "fold_arrays", "grid_train", "grid_train_eval", "initial_factors",
           "run_grid_evaluation"]

logger = logging.getLogger(__name__)

_MIN_BUCKET = 8
#: dense-cell ceiling per fold across the whole candidate axis
#: (C * U_pad * I_pad); past this the batched dense solve loses to the
#: sequential sparse path anyway, so fall back instead of running out of
#: memory
MAX_GRID_CELLS = 64_000_000
#: scalar axes a batch-compatible grid may vary (JSON key names, i.e.
#: post-alias: ``lambda`` is the ALS regularizer's wire name)
SWEEP_AXES = ("lambda", "lambda_", "alpha", "seed")


def _pow2(n: int) -> int:
    return max(_MIN_BUCKET, 1 << (max(1, n) - 1).bit_length())


# ------------------------------------------------------------ compatibility
@dataclasses.dataclass(frozen=True)
class GridAxes:
    """The scalar axes of a batch-compatible grid + its static config."""

    regs: tuple
    alphas: tuple
    seeds: tuple
    rank: int
    iterations: int
    implicit: bool

    @property
    def candidates(self) -> int:
        return len(self.regs)


def grid_axes(engine_params_list) -> GridAxes | None:
    """``None`` unless every candidate shares datasource/preparator/
    serving params and a single same-named algorithm whose params differ
    only along ``SWEEP_AXES`` — the precondition for one batched train."""
    eps = list(engine_params_list)
    if not eps:
        return None

    def _stable(params) -> str:
        return json.dumps(params_to_json(params), sort_keys=True, default=str)

    shared0 = (_stable(eps[0].datasource), _stable(eps[0].preparator), _stable(eps[0].serving))
    name0 = static0 = None
    regs, alphas, seeds = [], [], []
    for ep in eps:
        if (_stable(ep.datasource), _stable(ep.preparator), _stable(ep.serving)) != shared0:
            return None
        if len(ep.algorithms) != 1:
            return None
        name, p = ep.algorithms[0]
        if name0 is None:
            name0 = name
        elif name != name0:
            return None
        rank = getattr(p, "rank", None)
        iters = getattr(p, "num_iterations", None)
        implicit = getattr(p, "implicit_prefs", None)
        if not isinstance(rank, int) or not isinstance(iters, int):
            return None
        pj = params_to_json(p)
        static = {k: v for k, v in pj.items() if k not in SWEEP_AXES}
        if static0 is None:
            static0 = static
        elif static != static0:
            return None
        regs.append(float(getattr(p, "lambda_", 0.0) or 0.0))
        alphas.append(float(getattr(p, "alpha", 1.0) or 1.0))
        seeds.append(int(getattr(p, "seed", 0) or 0))
    return GridAxes(
        regs=tuple(regs),
        alphas=tuple(alphas),
        seeds=tuple(seeds),
        rank=int(rank),
        iterations=int(iters),
        implicit=bool(implicit),
    )


# ----------------------------------------------------------------- program
def initial_factors(seeds, n_users: int, n_items: int, rank: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``([C, U, K], [C, I, K])`` f32 starting factors on the CPU, ``0.1 ×
    N(0, 1)`` from ``torch.Generator(seed)`` of each candidate: users
    first, then items, so candidates with equal seeds start equal."""
    xs, ys = [], []
    for seed in seeds:
        gen = torch.Generator().manual_seed(int(seed))
        xs.append(0.1 * torch.randn(n_users, rank, generator=gen))
        ys.append(0.1 * torch.randn(n_items, rank, generator=gen))
    return torch.stack(xs), torch.stack(ys)


def _outer_rows(F: torch.Tensor) -> torch.Tensor:
    """``[C, N, K] -> [C, N, K*K]``: each row's outer product, flattened,
    so a masked Gramian over rows is one GEMM."""
    C, N, K = F.shape
    return (F[:, :, :, None] * F[:, :, None, :]).reshape(C, N, K * K)


def _solve_side(Rm, Mm, F, regs, alphas, eye, implicit: bool) -> torch.Tensor:
    """One half-sweep for every candidate: ``Rm``/``Mm`` ``[N, P]`` (the
    side being solved by its opposite), ``F`` ``[C, P, K]`` the opposite
    factors; returns ``[C, N, K]``."""
    C, _, K = F.shape
    N = Rm.shape[0]
    if implicit:
        # Hu-Koren-Volinsky: confidence c = 1 + alpha*r on observed
        # cells, preference p = 1 observed / 0 elsewhere
        G = (
            (F.transpose(1, 2) @ F)[:, None]
            + alphas[:, None, None, None] * ((Rm * Mm) @ _outer_rows(F)).reshape(C, N, K, K)
            + regs[:, None, None, None] * eye
        )
        B = ((1.0 + alphas[:, None, None] * Rm) * Mm) @ F
    else:
        G = (Mm @ _outer_rows(F)).reshape(C, N, K, K) + regs[:, None, None, None] * eye
        B = (Rm * Mm) @ F
    # solve_ex: no error check (no host sync); a singular system (λ = 0
    # on a padded row) gives non-finite rows, as LU does in the reference
    return torch.linalg.solve_ex(G, B[..., None])[0][..., 0]


def grid_train(R: torch.Tensor, M: torch.Tensor, regs: torch.Tensor, alphas: torch.Tensor,
               X: torch.Tensor, Y: torch.Tensor, *, iterations: int, implicit: bool) -> tuple:
    """``iterations`` ALS sweeps of every candidate at once from ``X [C,
    U, K]``, ``Y [C, I, K]``, all tensors on one device in one dtype;
    returns the final ``(X, Y)``."""
    eye = torch.eye(X.shape[-1], device=X.device, dtype=X.dtype)
    Rt, Mt = R.T.contiguous(), M.T.contiguous()
    for _ in range(int(iterations)):
        X = _solve_side(R, M, Y, regs, alphas, eye, implicit)
        Y = _solve_side(Rt, Mt, X, regs, alphas, eye, implicit)
    return X, Y


def grid_train_eval(
    R, M, T, seen, user_w, item_valid, regs, alphas, seeds,
    *, rank: int, iterations: int, implicit: bool, k: int, device=None, init=None,
) -> torch.Tensor:
    """Train C dense-ALS candidates on one fold and score precision@k,
    all in one batched program on ``device`` (None: the card).

    Arrays (numpy or tensors): ``R``/``M``/``T``/``seen`` are ``[U_pad,
    I_pad]`` (ratings, observed mask, held-out positives, train-seen
    mask), ``user_w`` is the ``[U_pad]`` eval-user weight,
    ``item_valid`` masks padding columns, and ``regs``/``alphas``/
    ``seeds`` are the ``[C]`` candidate axes. The program runs in
    ``R``'s floating dtype. ``init``: ``(X0 [C, U, K], Y0 [C, I, K])``
    starting factors (default :func:`initial_factors` of ``seeds``).
    Returns the ``[C]`` fold scores.
    """
    dev = resolve_device(device)
    R = torch.as_tensor(R, device=dev)
    dtype = R.dtype if R.is_floating_point() else torch.float32

    def on(a):
        return torch.as_tensor(a, device=dev).to(dtype)

    R, M, T, seen, user_w, item_valid = on(R), on(M), on(T), on(seen), on(user_w), on(item_valid)
    if init is None:
        init = initial_factors(np.asarray(seeds).tolist(), R.shape[0], R.shape[1], rank)
    X, Y = grid_train(R, M, on(regs), on(alphas), on(init[0]), on(init[1]), iterations=iterations,
                      implicit=implicit)
    scores = X @ Y.transpose(1, 2)
    # PrecisionAtK semantics: train-seen items are skipped (not
    # penalized), padding columns can never be served
    blocked = (seen > 0) | (item_valid < 0.5)[None, :]
    scores = torch.where(blocked, float("-inf"), scores)
    top_idx, _ = top_k_scores(scores, k)
    hits = torch.gather(T.expand(scores.shape[0], -1, -1), 2, top_idx).sum(dim=2)
    prec = hits / float(k)
    return (user_w * prec).sum(dim=1) / torch.clamp(user_w.sum(), min=1.0)


def fold_arrays(td, qa_pairs, k: int):
    """One eval fold -> padded dense arrays for :func:`grid_train_eval`.

    Duck-typed over the recommendation template's shapes (``td`` COO +
    BiMaps, ``qa_pairs`` of ``(Query, Actual)``) without importing
    templates/. Returns ``(arrays, n_eval_users, k_eff)`` — ``None``
    arrays when the fold has no usable eval users.
    """
    n_users = len(td.user_index)
    n_items = len(td.item_index)
    if not n_users or not n_items:
        return None, 0, 0
    U, I = _pow2(n_users), _pow2(n_items)
    R = np.zeros((U, I), np.float32)
    M = np.zeros((U, I), np.float32)
    rows = np.asarray(td.rows, np.int64)
    cols = np.asarray(td.cols, np.int64)
    R[rows, cols] = np.asarray(td.vals, np.float32)
    M[rows, cols] = 1.0
    T = np.zeros((U, I), np.float32)
    seen = np.zeros((U, I), np.float32)
    user_w = np.zeros((U,), np.float32)
    for q, a in qa_pairs:
        uid = td.user_index.get(getattr(q, "user", None))
        if uid is None:
            continue
        user_w[uid] = 1.0
        for it in getattr(a, "items", ()) or ():
            iid = td.item_index.get(it)
            if iid is not None:
                T[uid, iid] = 1.0
        for it in getattr(a, "seen", ()) or ():
            iid = td.item_index.get(it)
            if iid is not None:
                seen[uid, iid] = 1.0
    n_eval = int(user_w.sum())
    if not n_eval:
        return None, 0, 0
    item_valid = np.zeros((I,), np.float32)
    item_valid[:n_items] = 1.0
    k_eff = max(1, min(int(k), n_items))
    arrays = dict(R=R, M=M, T=T, seen=seen, user_w=user_w, item_valid=item_valid)
    return arrays, n_eval, k_eff


# ------------------------------------------------------------------- runner
def run_grid_evaluation(
    evaluation,
    generator,
    ctx,
    workflow_params=None,
    evaluation_class: str = "",
    generator_class: str = "",
):
    """``pio eval --grid``: ``run_evaluation`` parity (same
    ``EvaluationInstance`` lifecycle, same ``(instance, result)`` return)
    with the candidate loop replaced by one batched program per fold on
    ``ctx.device`` when the grid allows it."""
    import datetime as _dt

    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.data.storage.base import EvaluationInstance
    from predictionio_tpu_torch.workflow.core import WorkflowParams

    if workflow_params is None:
        workflow_params = WorkflowParams()

    def _now():
        return _dt.datetime.now(_dt.timezone.utc)

    eps_list = list(generator.engine_params_list)
    axes = grid_axes(eps_list)
    instances = Storage.get_meta_data_evaluation_instances()
    instance = EvaluationInstance(
        id=uuid.uuid4().hex,
        status="EVALUATING",
        start_time=_now(),
        end_time=_now(),
        evaluation_class=evaluation_class or type(evaluation).__name__,
        engine_params_generator_class=generator_class or type(generator).__name__,
        batch=workflow_params.batch,
    )
    instances.insert(instance)
    try:
        result = None
        if axes is not None:
            result = _batched_sweep(evaluation, eps_list, axes, ctx)
        if result is None:
            logger.info(
                "--grid: candidates are not batch-compatible (or the fold "
                "passes the dense budget); sequential MetricEvaluator"
            )
            evaluator = MetricEvaluator(metric=evaluation.metric, other_metrics=tuple(evaluation.other_metrics))
            result = evaluator.evaluate_base(ctx, evaluation.engine, eps_list)
        instance = dataclasses.replace(
            instance,
            status="EVALCOMPLETED",
            end_time=_now(),
            evaluator_results=result.leaderboard(),
            evaluator_results_json=json.dumps(result.to_json(), default=str),
        )
        instances.update(instance)
        return instance, result
    except Exception:
        instances.update(dataclasses.replace(instance, status="FAILED", end_time=_now()))
        raise


def _batched_sweep(evaluation, eps_list, axes: GridAxes, ctx):
    """Score the whole grid via :func:`grid_train_eval`; ``None`` when a
    fold passes the dense-cell budget (the caller falls back)."""
    engine = evaluation.engine
    metric = evaluation.metric
    k = int(getattr(metric, "k", 10) or 10)
    folds = engine.read_eval_folds(ctx, eps_list[0])
    C = axes.candidates
    prepared = []
    for td, _info, qa in folds:
        arrays, n_eval, k_eff = fold_arrays(td, qa, k)
        if arrays is None:
            continue
        if C * arrays["R"].size > MAX_GRID_CELLS:
            logger.info(
                "--grid: fold of %s cells x %d candidates exceeds the dense budget (%d)",
                arrays["R"].size, C, MAX_GRID_CELLS,
            )
            return None
        prepared.append((arrays, n_eval, k_eff))
    if not prepared:
        return None
    t0 = time.perf_counter()
    num = np.zeros(C, np.float64)
    den = 0.0
    for arrays, n_eval, k_eff in prepared:
        scores = grid_train_eval(
            arrays["R"], arrays["M"], arrays["T"], arrays["seen"], arrays["user_w"], arrays["item_valid"],
            np.float32(axes.regs), np.float32(axes.alphas), np.int64(axes.seeds),
            rank=axes.rank, iterations=axes.iterations, implicit=axes.implicit, k=k_eff, device=ctx.device,
        )
        num += scores.cpu().numpy().astype(np.float64) * n_eval
        den += n_eval
    elapsed = time.perf_counter() - t0
    avg = num / max(den, 1.0)

    def better(i: int, j: int) -> bool:
        a, b = float(avg[i]), float(avg[j])
        a_nan, b_nan = a != a, b != b
        if a_nan or b_nan:
            return b_nan and not a_nan
        return metric.compare(a, b) > 0

    order = sorted(
        range(C),
        key=functools.cmp_to_key(lambda i, j: -1 if better(i, j) else (1 if better(j, i) else 0)),
    )
    best = order[0]
    per_cand = round(elapsed / C, 3)
    scored = tuple((ep, MetricScores(float(avg[i]), (), per_cand)) for i, ep in enumerate(eps_list))
    logger.info(
        "--grid: %d candidates x %d folds in one batched program per fold (%.2fs total); "
        "best candidate[%d] score=%.6f",
        C, len(prepared), elapsed, best, float(avg[best]),
    )
    return MetricEvaluatorResult(
        best_score=scored[best][1],
        best_engine_params=eps_list[best],
        best_index=best,
        metric_header=metric.header(),
        other_metric_headers=(),
        engine_params_scores=scored,
        ranking=tuple(order),
    )
