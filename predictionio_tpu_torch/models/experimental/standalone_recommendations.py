"""The 0.8-era standalone workflow-API recommendation engine: the
counterpart of ``predictionio_tpu/models/experimental/standalone_recommendations.py``.

Reference mapping (examples/experimental/scala-recommendations/
src/main/scala/Run.scala): an engine assembled and run DIRECTLY through
the Workflow APIs, no console and no template scaffold:

- ``FileDataSource(filepath)`` parses ``user::item::rate`` lines
  (Run.scala:29-49), emitting both the training ratings and the
  (user, item) -> rating feature/target pairs for evaluation.
- ``IdentityPreparator`` (the ratings pass through untouched).
- ``ALSAlgorithm`` trains explicit ALS through ``ops/als.train_als`` (K1,
  K2) on the device it is given, or row-sharded over the workflow's mesh
  (K6s, the reference's :143), and predicts through ``predict_ratings``
  (K7); its ``PMatrixFactorizationModel`` is a persistent model that saves
  its factor arrays itself when ``params.persist_model`` is set, and is
  kept as it is otherwise (Run.scala:57-82). The port saves them as an
  ``.npz`` (``controller/persistent_model.py``), never a pickle.
- ``FirstServing``, and the bare ``[user, item]`` JSON query
  (Run.scala:117 Tuple2IntSerializer).
- ``run_standalone`` is ``Run.main`` (Run.scala:120-160): it builds the
  engine params and drives ``Engine.train`` directly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    EngineFactory,
    FirstServing,
    IdentityPreparator,
    Params,
)
from predictionio_tpu_torch.controller.base import BaseAlgorithm, BaseDataSource
from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.controller.persistent_model import (
    LocalFileSystemPersistentModel,
)
from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops.als import (
    ALSConfig,
    ALSModelArrays,
    predict_ratings,
    train_als,
)
from predictionio_tpu_torch.parallel.mesh import Mesh, split_target
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.workflow_params import WorkflowParams


@dataclasses.dataclass(frozen=True)
class FileDataSourceParams(Params):
    """Reference DataSourceParams(filepath) (Run.scala:29)."""

    filepath: str = ""


@dataclasses.dataclass
class RatingsData:
    """Integer-id COO ratings (the reference's RDD[Rating] of int ids;
    this example predates string entity ids)."""

    user_idx: np.ndarray  # [n] int32
    item_idx: np.ndarray  # [n] int32
    ratings: np.ndarray  # [n] float32


class FileDataSource(BaseDataSource):
    """``user::item::rate`` lines -> integer-id ratings (Run.scala:35-49).
    read_eval returns each (user, item) pair as a query with its rating
    as the actual (the featureTargets RDD)."""

    params_class = FileDataSourceParams

    def _read(self) -> RatingsData:
        users, items, rates = [], [], []
        with open(self.params.filepath) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                u, i, r = line.split("::")
                users.append(int(u))
                items.append(int(i))
                rates.append(float(r))
        return RatingsData(
            user_idx=np.asarray(users, np.int32),
            item_idx=np.asarray(items, np.int32),
            ratings=np.asarray(rates, np.float32),
        )

    def read_training(self, ctx) -> RatingsData:
        return self._read()

    def read_eval(self, ctx):
        data = self._read()
        queries = [
            ((int(u), int(i)), float(r))
            for u, i, r in zip(data.user_idx, data.item_idx, data.ratings)
        ]
        return [(data, None, queries)]


@dataclasses.dataclass(frozen=True)
class AlgorithmParams(Params):
    """Reference AlgorithmParams (Run.scala:51-55)."""

    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    persist_model: bool = False


@dataclasses.dataclass
class PMatrixFactorizationModel(LocalFileSystemPersistentModel):
    """Reference PMatrixFactorizationModel (Run.scala:57-82): saves its
    factor arrays itself when ``params.persist_model`` is set; otherwise
    ``save`` returns False and the model is kept as it is. ``_device`` (where
    ``predict`` runs K7) is serving state: it is not saved, and a loaded
    model predicts on the device ``prepare_serving`` binds."""

    rank: int = 0
    user_features: Optional[np.ndarray] = None
    product_features: Optional[np.ndarray] = None
    _device: Optional[torch.device] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def save(self, id: str, params: AlgorithmParams, device: torch.device) -> bool:
        if not params.persist_model:
            return False  # kept as it is (Run.scala:63-69)
        return super().save(id, params, device)


class ALSAlgorithm(BaseAlgorithm):
    """Reference ALSAlgorithm (Run.scala:84-117): explicit ALS over the
    integer ids (rows 0..max id); queries are bare (user, item) int pairs
    and the prediction is the scalar rating."""

    params_class = AlgorithmParams
    MESH_TRAINING = True

    def train(
        self, device: Union[DeviceLike, Mesh], data: RatingsData
    ) -> PMatrixFactorizationModel:
        """Train on ``device`` (CUDA unless the CPU is asked for), or on a
        ``Mesh`` (a mesh of one shard is its device), through
        ``train_als``; the model predicts on ``device`` (a mesh's first
        device)."""
        mesh, device = split_target(device)
        n_users = int(data.user_idx.max()) + 1 if len(data.user_idx) else 0
        n_items = int(data.item_idx.max()) + 1 if len(data.item_idx) else 0
        arrays = train_als(
            data.user_idx,
            data.item_idx,
            data.ratings,
            n_users=n_users,
            n_items=n_items,
            config=ALSConfig(
                rank=self.params.rank,
                iterations=self.params.num_iterations,
                reg=self.params.lambda_,
            ),
            device=device,
            mesh=mesh,
        )
        return PMatrixFactorizationModel(
            rank=self.params.rank,
            user_features=arrays.user_factors,
            product_features=arrays.item_factors,
            _device=resolve_device(device) if mesh is None else mesh.devices[0],
        )

    def prepare_serving(
        self, device: torch.device, model: PMatrixFactorizationModel
    ) -> PMatrixFactorizationModel:
        model._device = device
        return model

    def predict(
        self, model: PMatrixFactorizationModel, query: Tuple[int, int]
    ) -> float:
        u, i = query
        return float(
            predict_ratings(
                ALSModelArrays(model.user_features, model.product_features),
                np.asarray([u]),
                np.asarray([i]),
                device=model._device,
            )[0]
        )

    # the reference's Tuple2IntSerializer (Run.scala:117, 163-173):
    # queries travel as a bare [user, item] JSON array
    def query_from_json(self, json_obj) -> Tuple[int, int]:
        u, i = json_obj
        return int(u), int(i)

    def result_to_json(self, result: float):
        return result


def standalone_recommendations_engine() -> Engine:
    return Engine(
        data_source_classes=FileDataSource,
        preparator_classes=IdentityPreparator,
        algorithm_classes={"als": ALSAlgorithm},
        serving_classes=FirstServing,
    )


class StandaloneRecommendationsEngineFactory(EngineFactory):
    def apply(self) -> Engine:
        return standalone_recommendations_engine()


def standalone_engine_params(
    filepath: str,
    rank: int = 6,
    num_iterations: int = 5,
    lambda_: float = 0.01,
    persist_model: bool = False,
) -> EngineParams:
    """The engine params ``Run.main`` builds (Run.scala:120-160)."""
    return EngineParams(
        data_source_params=("", FileDataSourceParams(filepath=filepath)),
        preparator_params=("", Params()),
        algorithm_params_list=(
            (
                "als",
                AlgorithmParams(
                    rank=rank,
                    num_iterations=num_iterations,
                    lambda_=lambda_,
                    persist_model=persist_model,
                ),
            ),
        ),
        serving_params=("", Params()),
    )


def run_standalone(
    filepath: str,
    rank: int = 6,
    num_iterations: int = 5,
    lambda_: float = 0.01,
    persist_model: bool = False,
    device: DeviceLike = None,
) -> List:
    """The example's ``Run.main`` (Run.scala:120-160): build the engine
    params and train through ``Engine.train`` on ``device`` (CUDA unless
    the CPU is asked for). Returns the trained models."""
    engine = standalone_recommendations_engine()
    params = standalone_engine_params(
        filepath, rank, num_iterations, lambda_, persist_model
    )
    return engine.train(WorkflowContext(device), params, WorkflowParams())
