"""Evaluation for the recommendation engine, Precision@K over a rank x reg
grid: the port's copy of
``predictionio_tpu/models/recommendation/evaluation.py`` (the template's
evaluation pattern: PrecisionAtK as an OptionAverageMetric over held-out
positives, an Evaluation binding engine and metric, and an
EngineParamsGenerator holding the grid). Run with
``workflow.core_workflow.run_evaluation(RecommendationEvaluation(),
ParamsGrid().engine_params_list, ctx=WorkflowContext(device,
event_columns={"default": columns}))``.
"""

from __future__ import annotations

from typing import Optional

from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.controller.evaluation import (
    EngineParamsGenerator,
    Evaluation,
)
from predictionio_tpu_torch.controller.metrics import OptionAverageMetric
from predictionio_tpu_torch.models.recommendation.engine import (
    ActualResult,
    ALSAlgorithmParams,
    DataSourceParams,
    PredictedResult,
    Query,
    recommendation_engine,
)


class PrecisionAtK(OptionAverageMetric):
    """|top-K ∩ relevant| / min(K, |relevant|); None when a query has no
    held-out positives (excluded from the average)."""

    def __init__(self, k: int = 10):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = k

    @property
    def header(self) -> str:
        return f"Precision@{self.k}"

    def calculate_point(
        self, q: Query, p: PredictedResult, a: ActualResult
    ) -> Optional[float]:
        positives = set(a.items)
        if not positives:
            return None
        predicted = [s.item for s in p.item_scores[: self.k]]
        tp = sum(1 for item in predicted if item in positives)
        return tp / min(self.k, len(positives))


def _engine_params(
    rank: int, reg: float, app_name: str = "default", eval_k: int = 3
) -> EngineParams:
    return EngineParams(
        data_source_params=(
            "",
            DataSourceParams(app_name=app_name, eval_k=eval_k),
        ),
        algorithm_params_list=(
            ("als", ALSAlgorithmParams(rank=rank, lambda_=reg)),
        ),
    )


class RecommendationEvaluation(Evaluation):
    """Engine + Precision@10 (the template's Evaluation object). The app
    under evaluation comes from the DataSourceParams in each EngineParams
    of the grid (ParamsGrid(app_name=...))."""

    def __init__(self, k: int = 10):
        super().__init__()
        self.set_engine_metric(recommendation_engine(), PrecisionAtK(k=k))


class ParamsGrid(EngineParamsGenerator):
    """rank x reg tuning grid (the template's EngineParamsGenerator)."""

    def __init__(self, app_name: str = "default"):
        super().__init__(
            [
                _engine_params(rank, reg, app_name)
                for rank in (8, 16)
                for reg in (0.01, 0.1)
            ]
        )
