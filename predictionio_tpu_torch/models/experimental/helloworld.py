"""HelloWorld example engine — average temperature per weekday: the
counterpart of ``predictionio_tpu/models/experimental/helloworld.py``.

Reference mapping (examples/experimental/scala-local-helloworld/
HelloWorld.scala, java-local-helloworld, java-parallel-helloworld —
all three are the same engine in different dialects): a DataSource
reading `day,temperature` CSV lines (HelloWorld.scala readTraining),
an algorithm averaging the temperature per day (train :49-60), and a
predict returning the day's average (:63-66), assembled as a
SimpleEngine (MyEngineFactory :70-77). The tutorial engine every
walkthrough starts from; host code only (``train`` takes the
``torch.device`` and runs nothing there).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from predictionio_tpu_torch.controller import (
    BaseAlgorithm,
    BaseDataSource,
    EngineFactory,
    Params,
    SimpleEngine,
)


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    filepath: str = ""


@dataclasses.dataclass(frozen=True)
class Query:
    day: str = ""


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    temperature: float = 0.0


@dataclasses.dataclass
class TrainingData:
    temperatures: List[Tuple[str, float]]


@dataclasses.dataclass
class Model:
    temperatures: Dict[str, float]

    def __str__(self) -> str:  # reference MyModel.toString
        return str(self.temperatures)


class DataSource(BaseDataSource):
    """Reads `day,temperature` lines (HelloWorld.scala readTraining)."""

    params_class = DataSourceParams

    def read_training(self, ctx) -> TrainingData:
        rows: List[Tuple[str, float]] = []
        with open(self.params.filepath) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                day, temp = line.split(",")
                rows.append((day, float(temp)))
        return TrainingData(temperatures=rows)


class Algorithm(BaseAlgorithm):
    """Average per day (HelloWorld.scala train :49-60)."""

    query_class = Query

    def train(self, device: torch.device, pd: TrainingData) -> Model:
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for day, temp in pd.temperatures:
            sums[day] = sums.get(day, 0.0) + temp
            counts[day] = counts.get(day, 0) + 1
        return Model({d: sums[d] / counts[d] for d in sums})

    def predict(self, model: Model, query: Query) -> PredictedResult:
        return PredictedResult(temperature=model.temperatures[query.day])


def helloworld_engine() -> SimpleEngine:
    """SimpleEngine = one DataSource + one Algorithm (MyEngineFactory)."""
    return SimpleEngine(DataSource, Algorithm)


class HelloWorldEngineFactory(EngineFactory):
    def apply(self) -> SimpleEngine:
        return helloworld_engine()
