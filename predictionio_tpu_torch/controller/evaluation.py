"""Evaluation bindings: Evaluation, EngineParamsGenerator, MetricEvaluator.

Counterpart of ``predictionio_tpu/controller/evaluation.py``, line for
line. Parity: ``core/controller/Evaluation.scala``,
``core/controller/EngineParamsGenerator.scala``,
``core/controller/MetricEvaluator.scala`` — an ``Evaluation`` binds an
engine to a metric (plus optional secondary metrics); an
``EngineParamsGenerator`` supplies the candidate ``EngineParams`` list; the
``MetricEvaluator`` runs every candidate through ``Engine.eval``, ranks
them, and reports a leaderboard with the best params.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Sequence

from predictionio_tpu_torch.controller.context import WorkflowContext
from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.controller.metrics import Metric
from predictionio_tpu_torch.controller.params import params_to_json

__all__ = [
    "Evaluation",
    "EngineParamsGenerator",
    "MetricScores",
    "MetricEvaluatorResult",
    "MetricEvaluator",
]


class Evaluation:
    """Binds an engine and metric(s) (parity: ``Evaluation.scala``).

    Subclass and set ``engine``/``metric`` (class attributes or in
    ``__init__``), the way reference evaluations assign
    ``engineMetric = (engine, metric)``.
    """

    engine: Engine
    metric: Metric
    other_metrics: Sequence[Metric] = ()

    def __init__(
        self,
        engine: Engine | None = None,
        metric: Metric | None = None,
        other_metrics: Sequence[Metric] | None = None,
    ):
        if engine is not None:
            self.engine = engine
        if metric is not None:
            self.metric = metric
        if other_metrics is not None:
            self.other_metrics = tuple(other_metrics)


class EngineParamsGenerator:
    """Supplies candidate engine params for a sweep
    (parity: ``EngineParamsGenerator.scala``). Subclass and set
    ``engine_params_list``."""

    engine_params_list: Sequence[EngineParams] = ()

    def __init__(self, engine_params_list: Sequence[EngineParams] | None = None):
        if engine_params_list is not None:
            self.engine_params_list = tuple(engine_params_list)


@dataclasses.dataclass(frozen=True)
class MetricScores:
    """Primary + secondary scores of one candidate
    (parity: ``MetricScores`` in ``MetricEvaluator.scala``), plus the
    candidate's wall-clock (train + predict + metric), which the
    reference never reported but grid-sweep operators need."""

    score: float
    other_scores: tuple = ()
    seconds: float = 0.0


@dataclasses.dataclass(frozen=True)
class MetricEvaluatorResult:
    """Outcome of a sweep (parity: ``MetricEvaluatorResult``)."""

    best_score: MetricScores
    best_engine_params: EngineParams
    best_index: int
    metric_header: str
    other_metric_headers: tuple
    engine_params_scores: tuple  # tuple[tuple[EngineParams, MetricScores], ...]
    #: candidate indices, best first, ordered by the metric's ``compare``
    #: (NaN scores last) — precomputed so the leaderboard honors inverted
    #: metric orderings without carrying the Metric object around.
    ranking: tuple = ()

    def to_json(self) -> dict:
        def ep_json(ep: EngineParams) -> dict:
            return {
                "datasource": {"params": params_to_json(ep.datasource)},
                "preparator": {"params": params_to_json(ep.preparator)},
                "algorithms": [
                    {"name": name, "params": params_to_json(p)} for name, p in ep.algorithms
                ],
                "serving": {"params": params_to_json(ep.serving)},
            }

        return {
            "bestScore": {"score": self.best_score.score, "otherScores": list(self.best_score.other_scores)},
            "bestEngineParams": ep_json(self.best_engine_params),
            "bestIdx": self.best_index,
            "ranking": list(self.ranking),
            "metricHeader": self.metric_header,
            "otherMetricHeaders": list(self.other_metric_headers),
            "engineParamsScores": [
                {
                    "engineParams": ep_json(ep),
                    "score": s.score,
                    "otherScores": list(s.other_scores),
                    "seconds": s.seconds,
                }
                for ep, s in self.engine_params_scores
            ],
        }

    def leaderboard(self) -> str:
        """Human-readable ranked table (parity: the printed leaderboard)."""
        lines = [f"Metric: {self.metric_header}"]
        order = self.ranking or tuple(range(len(self.engine_params_scores)))
        for rank, idx in enumerate(order, start=1):
            ep, s = self.engine_params_scores[idx]
            marker = " <== BEST" if idx == self.best_index else ""
            algos = ", ".join(name for name, _ in ep.algorithms)
            lines.append(
                f"  #{rank}  score={s.score:.6f}  [{s.seconds:.1f}s]  "
                f"candidate[{idx}] ({algos}){marker}"
            )
        return "\n".join(lines)


class MetricEvaluator:
    """Runs candidates through ``Engine.eval`` and ranks them
    (parity: ``MetricEvaluator.evaluateBase``)."""

    def __init__(self, metric: Metric, other_metrics: Sequence[Metric] = (), output_path: str | None = None):
        self.metric = metric
        self.other_metrics = tuple(other_metrics)
        self.output_path = output_path

    def evaluate_base(
        self,
        ctx: WorkflowContext,
        engine: Engine,
        engine_params_list: Sequence[EngineParams],
    ) -> MetricEvaluatorResult:
        if not engine_params_list:
            raise ValueError("MetricEvaluator needs at least one EngineParams candidate")
        scored: list[tuple[EngineParams, MetricScores]] = []
        # candidates sharing datasource params share the SAME folds: the
        # event read + split runs once per distinct datasource config
        # instead of once per candidate
        fold_cache: dict[str, list] = {}
        for ep in engine_params_list:
            key = json.dumps(
                params_to_json(ep.datasource), sort_keys=True, default=str
            )
            folds = fold_cache.get(key)
            if folds is None:
                folds = fold_cache[key] = engine.read_eval_folds(ctx, ep)
            # time AFTER the fold fetch: the shared read must not be
            # charged to whichever candidate happened to come first
            t0 = time.perf_counter()
            eval_data = engine.eval(ctx, ep, folds=folds)
            score = self.metric.calculate_base(ctx, eval_data)
            others = tuple(m.calculate_base(ctx, eval_data) for m in self.other_metrics)
            scored.append(
                (ep, MetricScores(score, others, round(time.perf_counter() - t0, 3)))
            )

        def better(i: int, j: int) -> bool:
            """True if candidate i beats candidate j; NaN never beats, and is
            always beaten by, a real score."""
            a, b = scored[i][1].score, scored[j][1].score
            a_nan, b_nan = a != a, b != b
            if a_nan or b_nan:
                return b_nan and not a_nan
            return self.metric.compare(a, b) > 0

        ranking = sorted(
            range(len(scored)),
            key=functools.cmp_to_key(
                lambda i, j: -1 if better(i, j) else (1 if better(j, i) else 0)
            ),
        )
        best_index = ranking[0]
        result = MetricEvaluatorResult(
            best_score=scored[best_index][1],
            best_engine_params=scored[best_index][0],
            best_index=best_index,
            metric_header=self.metric.header(),
            other_metric_headers=tuple(m.header() for m in self.other_metrics),
            engine_params_scores=tuple(scored),
            ranking=tuple(ranking),
        )
        if self.output_path:
            with open(self.output_path, "w") as f:
                json.dump(result.to_json(), f, indent=2, default=str)
        return result
