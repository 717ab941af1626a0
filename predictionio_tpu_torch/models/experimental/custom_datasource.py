"""Recommendation with a custom (file-backed) DataSource: the counterpart of
``predictionio_tpu/models/experimental/custom_datasource.py``.

Reference mapping (examples/experimental/
scala-parallel-recommendation-custom-datasource/): the recommendation
template with DataSource.readTraining swapped to parse ``user::item::rate``
lines from a file instead of reading the event store
(DataSource.scala:15-47: ``sc.textFile(dsp.filepath)`` + split("::")).
The point of the example is that a DataSource is just another pluggable
component: the port's recommendation template (its Preparator, its
``ALSAlgorithm`` training through K1 and K2 and serving through K3, first
serving) is used unchanged on the template's ``TrainingData``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from predictionio_tpu_torch.controller import EngineFactory, FirstServing, Params
from predictionio_tpu_torch.controller.base import BaseDataSource
from predictionio_tpu_torch.controller.engine import Engine
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.recommendation.engine import (  # noqa: F401
    ALSAlgorithm,
    ALSAlgorithmParams,
    PredictedResult,
    Preparator,
    Query,
    TrainingData,
)


@dataclasses.dataclass(frozen=True)
class FileDataSourceParams(Params):
    """Reference DataSourceParams(filepath) (DataSource.scala:15)."""

    filepath: str = ""
    delimiter: str = "::"


class FileDataSource(BaseDataSource):
    """Parses ``user::item::rate`` lines into the template's dense-indexed
    TrainingData (DataSource.scala:24-32); ids are indexed in sorted
    order."""

    params_class = FileDataSourceParams

    def read_training(self, ctx) -> TrainingData:
        users, items, rates = [], [], []
        sep = self.params.delimiter
        with open(self.params.filepath) as f:
            for line_no, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                parts = line.split(sep)
                if len(parts) != 3:
                    raise ValueError(
                        f"{self.params.filepath}:{line_no}: expected "
                        f"user{sep}item{sep}rate, got {line!r}"
                    )
                users.append(parts[0])
                items.append(parts[1])
                rates.append(float(parts[2]))
        user_index = BiMap.string_int(users)
        item_index = BiMap.string_int(items)
        return TrainingData(
            user_idx=np.asarray([user_index[u] for u in users], np.int32),
            item_idx=np.asarray([item_index[i] for i in items], np.int32),
            ratings=np.asarray(rates, np.float32),
            user_index=user_index,
            item_index=item_index,
        )


def custom_datasource_engine() -> Engine:
    return Engine(
        data_source_classes=FileDataSource,
        preparator_classes=Preparator,
        algorithm_classes={"als": ALSAlgorithm},
        serving_classes=FirstServing,
    )


class CustomDataSourceEngineFactory(EngineFactory):
    def apply(self) -> Engine:
        return custom_datasource_engine()
