"""MovieLens filtering example, a blacklist-file serving filter: the
counterpart of ``predictionio_tpu/models/experimental/movielens_filtering.py``.

Reference mapping (examples/experimental/scala-local-movielens-filtering/):
the recommendation engine with its Serving component swapped for
``TempFilter`` (TempFilter.scala:26-38), a filter that re-reads a
blacklist file ON EVERY QUERY (so ops can edit the file without
redeploying, per that example's README) and drops the disabled item ids
from the first algorithm's prediction; TempFilterEngine
(TempFilterEngine.scala:9-19) assembles it. The base engine is the port's
recommendation template (its ``DataSource`` reads the event columns the
workflow context supplies, ALS trains through K1 and K2 and serves
through K3); the filter drops ItemScores whose item id appears in the
file, preserving order. The filter is host code.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

from predictionio_tpu_torch.controller import EngineFactory, Params
from predictionio_tpu_torch.controller.base import BaseServing
from predictionio_tpu_torch.controller.engine import Engine
from predictionio_tpu_torch.models.recommendation.engine import (  # noqa: F401
    ALSAlgorithm,
    ALSAlgorithmParams,
    DataSource,
    DataSourceParams,
    PredictedResult,
    Preparator,
    Query,
)


@dataclasses.dataclass(frozen=True)
class TempFilterParams(Params):
    """Reference TempFilterParams (TempFilter.scala:24)."""

    filepath: str = ""


class TempFilter(BaseServing):
    """Drops blacklisted item ids from the head prediction
    (TempFilter.scala:26-38). The file is read per query by design."""

    params_class = TempFilterParams

    def serve(self, query: Query, predictions: Sequence[PredictedResult]) -> PredictedResult:
        disabled = set()
        if self.params.filepath and os.path.exists(self.params.filepath):
            with open(self.params.filepath) as f:
                disabled = {line.strip() for line in f if line.strip()}
        prediction = predictions[0]
        return dataclasses.replace(
            prediction,
            item_scores=tuple(
                s for s in prediction.item_scores if s.item not in disabled
            ),
        )


def filtering_engine() -> Engine:
    """Reference TempFilterEngine (TempFilterEngine.scala:9-19), with the
    recommendation template standing in for the retired itemrec engine."""
    return Engine(
        data_source_classes=DataSource,
        preparator_classes=Preparator,
        algorithm_classes={"als": ALSAlgorithm},
        serving_classes=TempFilter,
    )


class FilteringEngineFactory(EngineFactory):
    def apply(self) -> Engine:
        return filtering_engine()
