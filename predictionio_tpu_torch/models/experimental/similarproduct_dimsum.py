"""Standalone DIMSUM similar-product engine: the counterpart of
``predictionio_tpu/models/experimental/similarproduct_dimsum.py``
(reference examples/experimental/scala-parallel-similarproduct-dimsum/).

The reference project is the Similar Product template with its ALS
algorithm swapped for MLlib's DIMSUM column similarity
(DIMSUMAlgorithm.scala: ``RowMatrix.columnSimilarities(threshold)``). The
algorithm lives in the Similar Product family
(``models/similarproduct/engine.py DIMSUMAlgorithm``: exact cosines from
the co-view counts, K19 on the device); this module assembles it as the
standalone engine the reference ships: DIMSUM as the only algorithm
(Engine.scala: ``Map("dimsum" -> classOf[DIMSUMAlgorithm])``) and
first-serving (Serving.scala). The port's ``Engine`` carries no data
source (the event store comes with ROADMAP item 3); training data is
built directly as a ``TrainingData``.
"""

from __future__ import annotations

from predictionio_tpu_torch.controller import Engine, EngineFactory, FirstServing
from predictionio_tpu_torch.models.similarproduct.engine import (  # noqa: F401
    DIMSUMAlgorithm,
    DIMSUMAlgorithmParams,
    DIMSUMModel,
    Item,
    ItemScore,
    PredictedResult,
    Preparator,
    Query,
    TrainingData,
    ViewEvent,
)


def dimsum_engine() -> Engine:
    return Engine(
        algorithm_classes={"dimsum": DIMSUMAlgorithm},
        serving_classes=FirstServing,
    )


class DIMSUMEngineFactory(EngineFactory):
    def apply(self) -> Engine:
        return dimsum_engine()
