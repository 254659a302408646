"""Metric hierarchy for evaluation.

Counterpart of ``predictionio_tpu/controller/metrics.py``, line for line.
Parity: ``core/src/main/scala/org/apache/predictionio/controller/Metric.scala``
— ``Metric[EI,Q,P,A,R]`` with ``AverageMetric``, ``OptionAverageMetric``,
``StdevMetric``, ``SumMetric``, ``ZeroMetric``.

A metric consumes the engine's eval output
``[(EI, [(Q, P, A), ...]), ...]`` (one entry per fold) and reduces it to a
float score. Subclasses implement per-datapoint ``calculate_unit``; the
fold-weighted reduction matches the reference (units pooled across folds,
not averaged per fold).
"""

from __future__ import annotations

import math
from typing import Any, Iterable, Sequence

from predictionio_tpu_torch.controller.context import WorkflowContext

__all__ = [
    "Metric",
    "AverageMetric",
    "OptionAverageMetric",
    "StdevMetric",
    "SumMetric",
    "ZeroMetric",
]

EvalDataSet = Sequence  # Sequence[tuple[EI, list[tuple[Q, P, A]]]]


class Metric:
    """Base metric (parity: ``abstract class Metric``). Higher is better;
    override ``compare`` for inverted orderings."""

    def header(self) -> str:
        return type(self).__name__

    def calculate(self, ctx: WorkflowContext, eval_data: EvalDataSet) -> float:
        raise NotImplementedError

    def compare(self, a: float, b: float) -> int:
        """> 0 if ``a`` is better than ``b`` (parity: the implicit Ordering)."""
        return (a > b) - (a < b)

    # Base SPI name used by the evaluation workflow.
    def calculate_base(self, ctx: WorkflowContext, eval_data: EvalDataSet) -> float:
        return self.calculate(ctx, eval_data)


class _UnitMetric(Metric):
    #: Whether ``calculate_unit`` may return None (skipped datapoints).
    #: Only OptionAverageMetric opts in; elsewhere a None is a bug in the
    #: user's unit function and must fail loudly.
    allow_none_units = False

    def _units(self, eval_data: EvalDataSet) -> Iterable[float | None]:
        for _ei, qpa in eval_data:
            for q, p, a in qpa:
                unit = self.calculate_unit(q, p, a)
                if unit is None and not self.allow_none_units:
                    raise ValueError(
                        f"{type(self).__name__}.calculate_unit returned None "
                        f"for query {q!r}; use OptionAverageMetric for "
                        "optional units"
                    )
                yield unit

    def calculate_unit(self, query: Any, predicted: Any, actual: Any) -> float | None:
        raise NotImplementedError


class AverageMetric(_UnitMetric):
    """Mean of per-datapoint scores pooled over all folds
    (parity: ``AverageMetric``)."""

    def calculate(self, ctx: WorkflowContext, eval_data: EvalDataSet) -> float:
        units = list(self._units(eval_data))
        if not units:
            return float("nan")
        return float(sum(units)) / len(units)


class OptionAverageMetric(_UnitMetric):
    """Mean over datapoints whose unit is not None
    (parity: ``OptionAverageMetric``)."""

    allow_none_units = True

    def calculate(self, ctx: WorkflowContext, eval_data: EvalDataSet) -> float:
        units = [u for u in self._units(eval_data) if u is not None]
        if not units:
            return float("nan")
        return float(sum(units)) / len(units)


class StdevMetric(_UnitMetric):
    """Population standard deviation of units (parity: ``StdevMetric``)."""

    def calculate(self, ctx: WorkflowContext, eval_data: EvalDataSet) -> float:
        units = list(self._units(eval_data))
        if not units:
            return float("nan")
        mean = sum(units) / len(units)
        return math.sqrt(sum((u - mean) ** 2 for u in units) / len(units))


class SumMetric(_UnitMetric):
    """Sum of units (parity: ``SumMetric``)."""

    def calculate(self, ctx: WorkflowContext, eval_data: EvalDataSet) -> float:
        return float(sum(self._units(eval_data)))


class ZeroMetric(Metric):
    """Always 0 — placeholder metric (parity: ``ZeroMetric``)."""

    def calculate(self, ctx: WorkflowContext, eval_data: EvalDataSet) -> float:
        return 0.0
