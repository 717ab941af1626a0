"""Local linear-regression engine: the counterpart of
``predictionio_tpu/models/experimental/regression.py``.

Reference mapping (examples/experimental/scala-local-regression/Run.scala):
- DataSource reads "y x1 x2 ..." lines from a file (filepath param), and
  hands out k-fold eval sets
- Preparator drops every n-th point (the reference's (n, k) holdout)
- Algorithm: OLS (breeze LinearRegression there; the minimum-norm
  least-squares solve of ``ops/lstsq.py``, K22, here)
- Serving: first prediction
- Metric: mean squared error

The dataset is small and host-resident; the solve runs on the device the
algorithm is given (``train`` takes a ``torch.device``). Predictions are
host numpy, as in the JAX package. A trained model is the coefficient
vector; ``utils/serialize.save_model`` writes it as engine
``"regression"`` and ``tools.cli deploy`` serves it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    BaseAlgorithm,
    BaseDataSource,
    BasePreparator,
    EngineFactory,
    FirstServing,
    Params,
)
from predictionio_tpu_torch.controller.engine import Engine
from predictionio_tpu_torch.controller.metrics import AverageMetric
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.lstsq import lstsq, require_converged


@dataclasses.dataclass(frozen=True)
class Query:
    features: Tuple[float, ...]

    def __post_init__(self):
        object.__setattr__(self, "features", tuple(float(f) for f in self.features))


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    prediction: float


@dataclasses.dataclass
class TrainingData:
    x: np.ndarray  # [n, F]
    y: np.ndarray  # [n]


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    filepath: str = ""
    eval_k: Optional[int] = None
    seed: int = 9527


class DataSource(BaseDataSource):
    """Reads "y x1 x2 ..." lines (reference LocalDataSource)."""

    params_class = DataSourceParams

    def _read(self) -> TrainingData:
        xs: List[List[float]] = []
        ys: List[float] = []
        with open(self.params.filepath) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                ys.append(float(parts[0]))
                xs.append([float(v) for v in parts[1:]])
        return TrainingData(x=np.asarray(xs, np.float32), y=np.asarray(ys, np.float32))

    def read_training(self, ctx) -> TrainingData:
        return self._read()

    def read_eval(self, ctx):
        if not self.params.eval_k:
            return []
        td = self._read()
        k = self.params.eval_k
        out = []
        for fold in range(k):
            sel = np.arange(len(td.y)) % k == fold
            out.append((
                TrainingData(x=td.x[~sel], y=td.y[~sel]),
                fold,
                [(Query(tuple(x)), float(y)) for x, y in zip(td.x[sel], td.y[sel])],
            ))
        return out


@dataclasses.dataclass(frozen=True)
class PreparatorParams(Params):
    n: int = 0  # drop every point with index % n == k (0 disables)
    k: int = 0


class Preparator(BasePreparator):
    """Reference LocalPreparator: holds out every n-th point."""

    params_class = PreparatorParams

    def prepare(self, device: torch.device, td: TrainingData) -> TrainingData:
        p = self.params
        if not p.n:
            return td
        keep = np.arange(len(td.y)) % p.n != p.k
        return TrainingData(x=td.x[keep], y=td.y[keep])


class OLSAlgorithm(BaseAlgorithm):
    """Ordinary least squares by one K22 launch on the device (reference
    LocalAlgorithm's breeze LinearRegression.regress)."""

    query_class = Query

    def train(self, device: torch.device, td: TrainingData) -> np.ndarray:
        if len(td.y) == 0:
            raise ValueError("cannot regress on an empty dataset")
        dev = resolve_device(device)
        x = torch.from_numpy(np.ascontiguousarray(td.x, np.float32)).to(dev)
        y = torch.from_numpy(np.ascontiguousarray(td.y, np.float32)).to(dev)
        return require_converged(lstsq(x, y)).x.cpu().numpy()

    def predict(self, model: np.ndarray, query: Query) -> PredictedResult:
        return PredictedResult(prediction=float(np.dot(model, np.asarray(query.features))))

    def batch_predict(self, model, queries) -> List[Tuple[int, PredictedResult]]:
        X = np.asarray([q.features for _, q in queries], np.float32)
        # each row's products summed in one fixed order, so a served answer
        # does not depend on the batch it came in (a BLAS matrix-vector
        # product may round a row differently at another batch size)
        preds = (X * model[None, :]).sum(axis=1)
        return [(i, PredictedResult(prediction=float(p))) for (i, _), p in zip(queries, preds)]


class MeanSquareError(AverageMetric):
    def calculate_point(self, q: Query, p: PredictedResult, a: float) -> float:
        return (p.prediction - a) ** 2

    is_larger_better = False


def regression_engine() -> Engine:
    return Engine(
        data_source_classes=DataSource,
        preparator_classes=Preparator,
        algorithm_classes={"ols": OLSAlgorithm},
        serving_classes=FirstServing,
    )


class RegressionEngineFactory(EngineFactory):
    def apply(self) -> Engine:
        return regression_engine()
