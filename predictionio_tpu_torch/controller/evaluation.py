"""Evaluation, BaseEvaluator, MetricEvaluator, EngineParamsGenerator: the
port's copy of ``predictionio_tpu/controller/evaluation.py`` (reference
controller/Evaluation.scala:34-122, core/BaseEvaluator.scala:37-72,
controller/MetricEvaluator.scala — grid scoring :215-260, best-params pick
:243-248, one-liner/HTML/JSON rendering :72-107, best-variant engine.json
output :188-210 — and controller/EngineParamsGenerator.scala:26-43).

Scoring is a host loop over the grid's variants, as in the reference's
copy; the device work is done by then (``Engine.batch_eval``).
"""

from __future__ import annotations

import dataclasses
import html as _html
import json
from typing import Any, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.controller.metrics import Metric


class BaseEvaluatorResult:
    """Result contract (reference BaseEvaluator.scala:54-72)."""

    no_save: bool = False

    def to_one_liner(self) -> str:
        return ""

    def to_html(self) -> str:
        return ""

    def to_json(self) -> str:
        return ""


class BaseEvaluator:
    """Evaluates engine outputs over a params grid
    (reference core/BaseEvaluator.scala:37)."""

    def evaluate_base(
        self,
        ctx,
        evaluation: "Evaluation",
        engine_eval_data_set: Sequence[Tuple[EngineParams, Any]],
        workflow_params,
    ) -> BaseEvaluatorResult:
        raise NotImplementedError


@dataclasses.dataclass
class MetricScores:
    score: Any
    other_scores: List[Any]


@dataclasses.dataclass
class MetricEvaluatorResult(BaseEvaluatorResult):
    """reference MetricEvaluatorResult (MetricEvaluator.scala:62-107)."""

    best_score: MetricScores = None
    best_engine_params: EngineParams = None
    best_idx: int = 0
    metric_header: str = ""
    other_metric_headers: List[str] = dataclasses.field(default_factory=list)
    engine_params_scores: List[Tuple[EngineParams, MetricScores]] = dataclasses.field(
        default_factory=list
    )

    def to_one_liner(self) -> str:
        return f"[{self.metric_header}] {self.best_score.score}"

    def to_json(self) -> str:
        return json.dumps(
            {
                "metricHeader": self.metric_header,
                "otherMetricHeaders": self.other_metric_headers,
                "bestIdx": self.best_idx,
                "bestScore": self.best_score.score,
                "bestOtherScores": self.best_score.other_scores,
                "bestEngineParams": self.best_engine_params.to_json(),
                "engineParamsScores": [
                    {
                        "engineParams": ep.to_json(),
                        "score": ms.score,
                        "otherScores": ms.other_scores,
                    }
                    for ep, ms in self.engine_params_scores
                ],
            },
            default=str,
        )

    def to_html(self) -> str:
        rows = "".join(
            "<tr><td>{}</td><td>{}</td><td><pre>{}</pre></td></tr>".format(
                _html.escape(str(ms.score)),
                _html.escape(str(ms.other_scores)),
                _html.escape(json.dumps(ep.to_json(), indent=2, default=str)),
            )
            for ep, ms in self.engine_params_scores
        )
        return (
            "<h2>Metric: {}</h2><p>Best score: {}</p>"
            "<table border=1><tr><th>{}</th><th>{}</th><th>Engine Params</th></tr>"
            "{}</table>".format(
                _html.escape(self.metric_header),
                _html.escape(str(self.best_score.score)),
                _html.escape(self.metric_header),
                _html.escape(str(self.other_metric_headers)),
                rows,
            )
        )


class MetricEvaluator(BaseEvaluator):
    """Default evaluator: score each EngineParams with a primary metric
    (+ optional others), pick the best (reference MetricEvaluator.scala)."""

    def __init__(
        self,
        metric: Metric,
        other_metrics: Sequence[Metric] = (),
        output_path: Optional[str] = None,
    ):
        self.metric = metric
        self.other_metrics = list(other_metrics)
        self.output_path = output_path

    def evaluate_base(
        self,
        ctx,
        evaluation: "Evaluation",
        engine_eval_data_set: Sequence[Tuple[EngineParams, Any]],
        workflow_params,
    ) -> MetricEvaluatorResult:
        if not engine_eval_data_set:
            raise ValueError("no engine params to evaluate")
        scores: List[Tuple[EngineParams, MetricScores]] = []
        for ep, eval_data_set in engine_eval_data_set:
            primary = self.metric.calculate(ctx, eval_data_set)
            others = [m.calculate(ctx, eval_data_set) for m in self.other_metrics]
            scores.append((ep, MetricScores(primary, others)))
        best_idx = 0
        for i in range(1, len(scores)):
            if self.metric.compare(scores[i][1].score, scores[best_idx][1].score) > 0:
                best_idx = i
        best_ep, best_ms = scores[best_idx]
        result = MetricEvaluatorResult(
            best_score=best_ms,
            best_engine_params=best_ep,
            best_idx=best_idx,
            metric_header=self.metric.header,
            other_metric_headers=[m.header for m in self.other_metrics],
            engine_params_scores=scores,
        )
        if self.output_path:
            # best-variant engine.json (reference saveEngineJson :188-210)
            with open(self.output_path, "w") as f:
                json.dump(best_ep.to_json(), f, indent=2, default=str)
        return result


class Evaluation:
    """Set-once (engine, evaluator) pair with metric sugar
    (reference controller/Evaluation.scala:34-122)."""

    def __init__(self):
        self._engine: Optional[Engine] = None
        self._evaluator: Optional[BaseEvaluator] = None

    @property
    def engine(self) -> Engine:
        if self._engine is None:
            raise ValueError("Evaluation's engine is not set")
        return self._engine

    @property
    def evaluator(self) -> BaseEvaluator:
        if self._evaluator is None:
            raise ValueError("Evaluation's evaluator is not set")
        return self._evaluator

    def _set_once(self, engine: Engine, evaluator: BaseEvaluator) -> None:
        if self._engine is not None or self._evaluator is not None:
            raise ValueError("Evaluation can only be set once")
        self._engine = engine
        self._evaluator = evaluator

    # sugar (reference engineEvaluator= / engineMetric= / engineMetrics=)

    def set_engine_evaluator(self, engine: Engine, evaluator: BaseEvaluator):
        self._set_once(engine, evaluator)
        return self

    def set_engine_metric(
        self, engine: Engine, metric: Metric, output_path: Optional[str] = None
    ):
        self._set_once(engine, MetricEvaluator(metric, (), output_path))
        return self

    def set_engine_metrics(
        self,
        engine: Engine,
        metric: Metric,
        other_metrics: Sequence[Metric] = (),
        output_path: Optional[str] = None,
    ):
        self._set_once(engine, MetricEvaluator(metric, other_metrics, output_path))
        return self


class EngineParamsGenerator:
    """Holds the params grid for tuning runs
    (reference controller/EngineParamsGenerator.scala:26-43)."""

    def __init__(self, engine_params_list: Optional[Sequence[EngineParams]] = None):
        self._list: Optional[List[EngineParams]] = (
            list(engine_params_list) if engine_params_list is not None else None
        )

    @property
    def engine_params_list(self) -> List[EngineParams]:
        if self._list is None:
            raise ValueError("EngineParamsGenerator's engineParamsList is not set")
        return self._list

    @engine_params_list.setter
    def engine_params_list(self, value: Sequence[EngineParams]) -> None:
        if self._list is not None:
            raise ValueError("engineParamsList can only be set once")
        self._list = list(value)
