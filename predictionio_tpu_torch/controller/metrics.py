"""Metric family for evaluation: the port's copy of
``predictionio_tpu/controller/metrics.py`` (reference
controller/Metric.scala): the Metric base (:36-58 — header, calculate over
an eval data set, ordering-based compare), AverageMetric (:96),
OptionAverageMetric (:121), StdevMetric (:148), OptionStdevMetric (:173),
SumMetric (:202), ZeroMetric (:231), and the QPAMetric trait (:251).
Scores are host math over the (Q, P, A) triples the engine's eval
produced; ``None`` points are left out by the Option metrics, and a
``None`` result compares below every score.
"""

from __future__ import annotations

import math
from typing import Any, Generic, List, Sequence, Tuple, TypeVar

EI = TypeVar("EI")
Q = TypeVar("Q")
P = TypeVar("P")
A = TypeVar("A")
R = TypeVar("R")

EvalDataSet = Sequence[Tuple[EI, Sequence[Tuple[Q, P, A]]]]


class Metric(Generic[EI, Q, P, A, R]):
    """Base metric. ``compare`` uses natural ordering by default; override
    ``is_larger_better`` (or ``compare``) for inverted metrics."""

    is_larger_better: bool = True

    @property
    def header(self) -> str:
        return type(self).__name__

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> R:
        raise NotImplementedError

    def compare(self, r0: R, r1: R) -> int:
        key0, key1 = self._key(r0), self._key(r1)
        if key0 == key1:
            return 0
        better = key0 > key1 if self.is_larger_better else key0 < key1
        return 1 if better else -1

    @staticmethod
    def _key(r):
        return (-math.inf if r is None else r)

    def __str__(self) -> str:
        return self.header


class QPAMetric(Metric[EI, Q, P, A, R]):
    """Marker for metrics defined point-wise over (Q, P, A) triples
    (reference QPAMetric trait, Metric.scala:251)."""

    def calculate_point(self, query: Q, predicted: P, actual: A) -> Any:
        raise NotImplementedError


def _all_points(eval_data_set: EvalDataSet):
    for _, qpa in eval_data_set:
        for q, p, a in qpa:
            yield q, p, a


class AverageMetric(QPAMetric[EI, Q, P, A, float]):
    """Mean of per-point scores across all folds (reference :96-120)."""

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        scores = [
            float(self.calculate_point(q, p, a))
            for q, p, a in _all_points(eval_data_set)
        ]
        return sum(scores) / len(scores) if scores else float("nan")


class OptionAverageMetric(QPAMetric[EI, Q, P, A, float]):
    """Mean of per-point scores, None excluded (reference :121-147)."""

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        scores = [
            float(s)
            for q, p, a in _all_points(eval_data_set)
            if (s := self.calculate_point(q, p, a)) is not None
        ]
        return sum(scores) / len(scores) if scores else float("nan")


def _stdev(scores: List[float]) -> float:
    # population stdev, matching Spark StatCounter.stdev
    if not scores:
        return float("nan")
    mean = sum(scores) / len(scores)
    return math.sqrt(sum((s - mean) ** 2 for s in scores) / len(scores))


class StdevMetric(QPAMetric[EI, Q, P, A, float]):
    """Population stdev of per-point scores (reference :148-172)."""

    is_larger_better = False

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        return _stdev(
            [float(self.calculate_point(q, p, a)) for q, p, a in _all_points(eval_data_set)]
        )


class OptionStdevMetric(QPAMetric[EI, Q, P, A, float]):
    """Population stdev, None excluded (reference :173-201)."""

    is_larger_better = False

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        return _stdev(
            [
                float(s)
                for q, p, a in _all_points(eval_data_set)
                if (s := self.calculate_point(q, p, a)) is not None
            ]
        )


class SumMetric(QPAMetric[EI, Q, P, A, float]):
    """Sum of per-point scores (reference :202-230)."""

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        return float(
            sum(float(self.calculate_point(q, p, a)) for q, p, a in _all_points(eval_data_set))
        )


class ZeroMetric(Metric[EI, Q, P, A, float]):
    """Always returns 0 — placeholder metric (reference :231-249)."""

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        return 0.0
