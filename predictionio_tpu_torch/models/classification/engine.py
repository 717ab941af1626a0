"""Classification engine: naive Bayes and logistic regression over $set
user properties, the counterpart of
``predictionio_tpu/models/classification/engine.py``.

Reference mapping (examples/scala-parallel-classification/add-algorithm/
src/main/scala/):
- Query(features)/PredictedResult(label)      <- Engine.scala
- DataSource: aggregated properties of "user" entities requiring
  plan/attr0/attr1/attr2 -> labeled points     <- DataSource.scala:31-65
- NaiveBayesAlgorithm (MLlib NaiveBayes.train -> ops/naive_bayes.py:
  K15a to train, K15b to predict)               <- NaiveBayesAlgorithm.scala:24-44
- LogisticRegressionAlgorithm, the engine's second algorithm (softmax
  regression by full-batch gradient descent -> ops/softmax_regression.py,
  K18); its predictions are host numpy, as the JAX package's are
                                               <- RandomForestAlgorithm.scala
- Serving: first prediction                    <- Serving.scala

Where the reference reads ``PEventStore.aggregate_properties``, the
``DataSource`` reads ``WorkflowContext.aggregate_properties``: the port has
no event store yet (ROADMAP.md queue 1 item 3), so the caller supplies the
aggregated maps. ``train`` takes the ``torch.device`` it runs on;
``NaiveBayesAlgorithm`` (``MESH_TRAINING``) also takes a ``Mesh``, whose
rows it shards (K15s, as the reference trains on the workflow's mesh), and
serves on one device, as the reference does.
``nb_model_from_numpy`` and ``lr_model_from_numpy`` carry a model's arrays
across (a JAX-trained one included).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    BaseAlgorithm,
    BaseDataSource,
    BasePreparator,
    EngineFactory,
    FirstServing,
    Params,
    SanityCheck,
)
from predictionio_tpu_torch.controller.engine import Engine
from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.e2 import split_data
from predictionio_tpu_torch.ops.naive_bayes import (
    NaiveBayesModelArrays,
    placed,
    predict_naive_bayes,
    train_naive_bayes,
)
from predictionio_tpu_torch.ops.softmax_regression import softmax_regression
from predictionio_tpu_torch.parallel.mesh import Mesh, split_target

logger = logging.getLogger(__name__)

ATTRS = ("attr0", "attr1", "attr2")


@dataclasses.dataclass(frozen=True)
class Query:
    features: Tuple[float, ...]

    def __post_init__(self):
        object.__setattr__(
            self, "features", tuple(float(f) for f in self.features)
        )


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    label: float


@dataclasses.dataclass(frozen=True)
class ActualResult:
    label: float


@dataclasses.dataclass
class LabeledPoint:
    label: float
    features: np.ndarray


@dataclasses.dataclass
class TrainingData(SanityCheck):
    labels: np.ndarray  # [n]
    features: np.ndarray  # [n, F]

    def sanity_check(self) -> None:
        if len(self.labels) == 0:
            raise ValueError(
                "no labeled points — are user $set events with "
                f"plan/{'/'.join(ATTRS)} present?"
            )


@dataclasses.dataclass
class PreparedData:
    td: TrainingData


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "default"
    channel_name: Optional[str] = None
    eval_k: Optional[int] = None


class DataSource(BaseDataSource):
    """Aggregated user properties as labeled points (reference
    DataSource.scala:31-65: required plan + attr0..attr2), from the
    context's ``aggregate_properties``."""

    params_class = DataSourceParams

    def _read_points(self, ctx) -> TrainingData:
        props = ctx.aggregate_properties(
            self.params.app_name,
            entity_type="user",
            channel_name=self.params.channel_name,
            required=["plan", *ATTRS],
        )
        labels = np.asarray(
            [float(p.get("plan")) for p in props.values()], np.float32
        )
        features = np.asarray(
            [[float(p.get(a)) for a in ATTRS] for p in props.values()],
            np.float32,
        ).reshape(len(labels), len(ATTRS))
        logger.info("DataSource: %d labeled points", len(labels))
        return TrainingData(labels=labels, features=features)

    def read_training(self, ctx) -> TrainingData:
        return self._read_points(ctx)

    def read_eval(self, ctx):
        if not self.params.eval_k:
            return []
        td = self._read_points(ctx)
        points = [
            LabeledPoint(float(l), f) for l, f in zip(td.labels, td.features)
        ]
        return split_data(
            self.params.eval_k,
            points,
            None,
            training_data_creator=lambda pts: TrainingData(
                labels=np.asarray([p.label for p in pts], np.float32),
                features=(
                    np.stack([p.features for p in pts])
                    if pts
                    else np.zeros((0, len(ATTRS)), np.float32)
                ),
            ),
            query_creator=lambda p: Query(features=tuple(p.features)),
            actual_creator=lambda p: ActualResult(label=p.label),
        )


class Preparator(BasePreparator):
    def prepare(self, device: torch.device, td: TrainingData) -> PreparedData:
        return PreparedData(td=td)


@dataclasses.dataclass(frozen=True)
class NaiveBayesAlgorithmParams(Params):
    lambda_: float = 1.0


class NaiveBayesAlgorithm(BaseAlgorithm):
    """Multinomial NB (reference NaiveBayesAlgorithm.scala:24-44): K15a to
    train (K15s over the rows of a mesh), one K15b launch per predicted
    batch under pi and theta placed once on the serving device."""

    params_class = NaiveBayesAlgorithmParams
    query_class = Query
    MESH_TRAINING = True

    def train(self, device: Union[torch.device, Mesh], pd: PreparedData) -> NaiveBayesModelArrays:
        """On a device, or on a ``Mesh`` of several shards, whose first
        device the model then predicts on."""
        mesh, device = split_target(device)
        return train_naive_bayes(
            pd.td.features, pd.td.labels, lam=self.params.lambda_, mesh=mesh, device=device
        )

    def prepare_serving(self, device: torch.device, model: NaiveBayesModelArrays):
        """The model on ``device``, its pi and theta placed there once."""
        model = dataclasses.replace(model, device=device)
        placed(model, resolve_device(device))
        return model

    def predict(self, model: NaiveBayesModelArrays, query: Query) -> PredictedResult:
        [(_, p)] = self.batch_predict(model, [(0, query)])
        return p

    def batch_predict(self, model, queries) -> List[Tuple[int, PredictedResult]]:
        X = np.asarray([q.features for _, q in queries], np.float32)
        labels = predict_naive_bayes(model, X)
        return [
            (i, PredictedResult(label=float(l)))
            for (i, _), l in zip(queries, labels)
        ]


def nb_model_from_numpy(
    pi: np.ndarray, theta: np.ndarray, labels: np.ndarray, device: DeviceLike = None
) -> NaiveBayesModelArrays:
    """A naive Bayes model from a trained model's arrays (``pi`` [C],
    ``theta`` [C, F], the class ``labels`` [C]), predicting on ``device``
    (CUDA unless the CPU is asked for)."""
    pi = np.asarray(pi, np.float32)
    theta = np.asarray(theta, np.float32)
    labels = np.asarray(labels)
    if pi.ndim != 1 or theta.shape[:1] != pi.shape or labels.shape != pi.shape or theta.ndim != 2:
        raise ValueError(
            f"pi [C], theta [C, F] and labels [C] disagree: {pi.shape}, "
            f"{theta.shape}, {labels.shape}"
        )
    return NaiveBayesModelArrays(pi=pi, theta=theta, labels=labels,
                                 device=resolve_device(device))


@dataclasses.dataclass(frozen=True)
class LogisticRegressionAlgorithmParams(Params):
    learning_rate: float = 0.1
    iterations: int = 200
    l2: float = 0.0
    seed: int = 0


@dataclasses.dataclass
class LogisticRegressionModel:
    weights: np.ndarray  # [C, F]
    bias: np.ndarray  # [C]
    labels: np.ndarray  # [C]


class LogisticRegressionAlgorithm(BaseAlgorithm):
    """Softmax regression trained by full-batch gradient descent on the
    device (K18: every step enqueued at once) — the engine's second
    algorithm, playing the reference add-algorithm slot
    (RandomForestAlgorithm.scala). Predictions are host numpy, as in the
    JAX package (``X·Wᵀ + b``, then ``argmax``)."""

    params_class = LogisticRegressionAlgorithmParams
    query_class = Query

    def train(self, device: torch.device, pd: PreparedData) -> LogisticRegressionModel:
        td = pd.td
        classes, y = np.unique(td.labels, return_inverse=True)
        dev = resolve_device(device)
        p = self.params
        W, b = softmax_regression(
            torch.tensor(np.asarray(td.features, np.float32), device=dev),
            torch.tensor(y.astype(np.int32).reshape(-1), device=dev),
            len(classes), p.learning_rate, p.l2, p.iterations,
        )
        return LogisticRegressionModel(
            weights=W.cpu().numpy(), bias=b.cpu().numpy(), labels=classes
        )

    def predict(self, model: LogisticRegressionModel, query: Query) -> PredictedResult:
        [(_, p)] = self.batch_predict(model, [(0, query)])
        return p

    def batch_predict(self, model, queries) -> List[Tuple[int, PredictedResult]]:
        X = np.asarray([q.features for _, q in queries], np.float32)
        scores = X @ model.weights.T + model.bias
        best = scores.argmax(axis=1)
        return [
            (i, PredictedResult(label=float(model.labels[b])))
            for (i, _), b in zip(queries, best)
        ]


def lr_model_from_numpy(
    weights: np.ndarray, bias: np.ndarray, labels: Sequence[float]
) -> LogisticRegressionModel:
    """A logistic regression model from a trained model's arrays
    (``weights`` [C, F], ``bias`` [C], the class ``labels`` [C])."""
    weights = np.asarray(weights, np.float32)
    bias = np.asarray(bias, np.float32)
    labels = np.asarray(labels)
    if weights.ndim != 2 or bias.shape != weights.shape[:1] or labels.shape != bias.shape:
        raise ValueError(
            f"weights [C, F], bias [C] and labels [C] disagree: {weights.shape}, "
            f"{bias.shape}, {labels.shape}"
        )
    return LogisticRegressionModel(weights=weights, bias=bias, labels=labels)


class Serving(FirstServing):
    pass


def classification_engine() -> Engine:
    """Reference ClassificationEngine factory (Engine.scala: the naive +
    second-algorithm map)."""
    return Engine(
        data_source_classes=DataSource,
        preparator_classes=Preparator,
        algorithm_classes={
            "naive": NaiveBayesAlgorithm,
            "logisticregression": LogisticRegressionAlgorithm,
        },
        serving_classes=Serving,
    )


class ClassificationEngineFactory(EngineFactory):
    def apply(self) -> Engine:
        return classification_engine()
