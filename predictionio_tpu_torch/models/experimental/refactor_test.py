"""The DASE-plumbing smoke engine ("vanilla" engine + custom evaluator):
the counterpart of ``predictionio_tpu/models/experimental/refactor_test.py``,
host code, copied.

Reference mapping (examples/experimental/scala-refactor-test/): a
minimal engine whose every stage is trivially checkable, used to
exercise the controller plumbing itself:

- DataSource.readTraining -> the numbers 0..99; readEval -> 3 identical
  folds each with 20 queries Query(i) and empty actuals
  (DataSource.scala:29-49).
- Preparator passes TrainingData through (Preparator.scala).
- Algorithm: model = sum(events) * params.mult; predict(q) = mc + q
  (Algorithm.scala:20-35).
- Serving: first algorithm's result (Serving.scala).
- VanillaEvaluator (Evaluator.scala:7-21): evaluateUnit = q - p,
  evaluateSet = sum of units, evaluateAll = "VanillaEvaluator(n, sum)"
  — a custom Evaluator over the low-level evaluate path, NOT the
  MetricEvaluator sugar.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from predictionio_tpu_torch.controller import EngineFactory, FirstServing, Params
from predictionio_tpu_torch.controller.base import (
    BaseAlgorithm,
    BaseDataSource,
    BasePreparator,
)
from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.controller.evaluation import (
    BaseEvaluator,
    BaseEvaluatorResult,
)


@dataclasses.dataclass(frozen=True)
class Query:
    q: int


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    p: int


@dataclasses.dataclass(frozen=True)
class ActualResult:
    pass


@dataclasses.dataclass
class TrainingData:
    events: List[int]


class DataSource(BaseDataSource):
    """Reference DataSource.scala:29-49."""

    def read_training(self, ctx) -> TrainingData:
        return TrainingData(events=list(range(100)))

    def read_eval(self, ctx):
        return [
            (
                self.read_training(ctx),
                None,
                [(Query(i), ActualResult()) for i in range(20)],
            )
            for _ in range(3)
        ]


class Preparator(BasePreparator):
    """Reference Preparator.scala — identity."""

    def prepare(self, device, td: TrainingData) -> TrainingData:
        return td


@dataclasses.dataclass(frozen=True)
class AlgorithmParams(Params):
    mult: int = 1


@dataclasses.dataclass
class Model:
    mc: int


class Algorithm(BaseAlgorithm):
    """Reference Algorithm.scala:20-35."""

    params_class = AlgorithmParams
    query_class = Query

    def train(self, device, data: TrainingData) -> Model:
        return Model(mc=sum(data.events) * self.params.mult)

    def predict(self, model: Model, query: Query) -> PredictedResult:
        return PredictedResult(p=model.mc + query.q)


@dataclasses.dataclass
class VanillaEvaluatorResult(BaseEvaluatorResult):
    """evaluateAll's one-liner (Evaluator.scala:17-20)."""

    n_sets: int = 0
    total: int = 0

    def to_one_liner(self) -> str:
        return f"VanillaEvaluator({self.n_sets}, {self.total})"

    def to_json(self) -> str:
        import json

        return json.dumps({"sets": self.n_sets, "sum": self.total})


class VanillaEvaluator(BaseEvaluator):
    """Reference VanillaEvaluator (Evaluator.scala:7-21) over the
    low-level evaluate_base path: unit = q - p, set = sum(units),
    all = (set count, grand total)."""

    @staticmethod
    def evaluate_unit(q: Query, p: PredictedResult, a: ActualResult) -> int:
        return q.q - p.p

    @staticmethod
    def evaluate_set(eval_info, units: Sequence[int]) -> int:
        return sum(units)

    def evaluate_base(
        self,
        ctx,
        evaluation,
        engine_eval_data_set,
        workflow_params,
    ) -> VanillaEvaluatorResult:
        set_scores: List[int] = []
        for _engine_params, eval_sets in engine_eval_data_set:
            for eval_info, qpas in eval_sets:
                units = [
                    self.evaluate_unit(q, p, a) for q, p, a in qpas
                ]
                set_scores.append(self.evaluate_set(eval_info, units))
        return VanillaEvaluatorResult(
            n_sets=len(set_scores), total=sum(set_scores)
        )


def refactor_test_engine() -> Engine:
    return Engine(
        data_source_classes=DataSource,
        preparator_classes=Preparator,
        algorithm_classes={"": Algorithm},
        serving_classes=FirstServing,
    )


def default_engine_params(mult: int = 1) -> EngineParams:
    return EngineParams(
        data_source_params=("", Params()),
        preparator_params=("", Params()),
        algorithm_params_list=(("", AlgorithmParams(mult=mult)),),
        serving_params=("", Params()),
    )


class VanillaEngineFactory(EngineFactory):
    def apply(self) -> Engine:
        return refactor_test_engine()
