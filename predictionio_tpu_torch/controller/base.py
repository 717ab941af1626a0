"""Controller bases, the subset of ``predictionio_tpu/controller/base.py``
the ported slices use: the data check, the data source, the preparator,
the algorithm and the serving bases (reference
controller/SanityCheck.scala:30, core/BaseDataSource.scala:31-52,
core/BasePreparator.scala:32-42, controller/IdentityPreparator.scala:30-92,
core/BaseAlgorithm.scala:55-123, core/BaseServing.scala:28-51,
controller/LFirstServing.scala:24-39).

Where the reference hands a workflow context to ``prepare``, ``train``,
``train_grid`` and ``prepare_serving``, the port hands the
``torch.device`` they run on; a data source gets the context
(``workflow/context.py``), which carries the device and the event columns
it reads.

``PAlgorithm`` declares a model that is not persisted (``sharded_model``):
``Engine.make_serializable_models`` keeps None for it and
``Engine.prepare_deploy`` re-trains it. The reference's P/P2L/L names are
aliases of the bases, as in the JAX package (reference
controller/PAlgorithm.scala:44, LServing.scala, LAverageServing.scala).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Generic, List, Optional, Sequence, Tuple, TypeVar, Union

import torch

from predictionio_tpu_torch.parallel.mesh import Mesh
from predictionio_tpu_torch.controller.params import (
    EmptyParams,
    Params,
    params_from_json,
)

TD = TypeVar("TD")  # training data
EI = TypeVar("EI")  # evaluation info
PD = TypeVar("PD")  # prepared data
M = TypeVar("M")  # model
Q = TypeVar("Q")  # query
P = TypeVar("P")  # predicted result
A = TypeVar("A")  # actual result


def doer(cls, params: Optional[Params] = None):
    """Instantiate a controller class with its params (reference Doer.apply,
    core/AbstractDoer.scala:33-66). An EmptyParams slot upgrades to the
    class's declared params defaults."""
    params = params if params is not None else EmptyParams()
    if isinstance(params, EmptyParams) and getattr(cls, "params_class", None):
        params = cls.params_class()
    return cls(params)


class Controller:
    """Common base: ``self.params`` is always set; a declared
    ``params_class`` supplies the default (all-defaults) instance."""

    params_class: Optional[type] = None

    def __init__(self, params: Optional[Params] = None):
        if params is not None:
            self.params = params
        elif type(self).params_class is not None:
            self.params = type(self).params_class()
        else:
            self.params = EmptyParams()


class SanityCheck(abc.ABC):
    """Data-validation hook (reference controller/SanityCheck.scala:30):
    training data, prepared data and models implement ``sanity_check``."""

    @abc.abstractmethod
    def sanity_check(self) -> None: ...


class BaseDataSource(Controller, Generic[TD, EI, Q, A]):
    """Reads training and evaluation data (reference
    core/BaseDataSource.scala:31-52)."""

    def read_training(self, ctx) -> TD:
        raise NotImplementedError

    def read_eval(self, ctx) -> List[Tuple[TD, EI, List[Tuple[Q, A]]]]:
        """Evaluation folds: (training data, eval info, (query, actual)
        pairs). Default: none (reference PDataSource readEval)."""
        return []


class BasePreparator(Controller, Generic[TD, PD]):
    """Transforms training data into prepared data
    (reference core/BasePreparator.scala:32-42)."""

    def prepare(self, device: torch.device, training_data: TD) -> PD:
        raise NotImplementedError


class IdentityPreparator(BasePreparator[TD, TD]):
    """Pass-through preparator (reference
    controller/IdentityPreparator.scala:30-92)."""

    def prepare(self, device: torch.device, training_data: TD) -> TD:
        return training_data


class BaseAlgorithm(Controller, Generic[M, Q, P]):
    """Trains a model and predicts from it (reference
    core/BaseAlgorithm.scala).

    ``sharded_model=True`` declares a model that lives sharded over the
    devices it trained on (the reference's ``PAlgorithm`` role): unless it
    is a ``PersistentModel``, it is persisted as None and re-trained at
    deploy."""

    sharded_model: bool = False

    # param fields that may differ between variants trained together by
    # ``train_grid``; empty: no grid path, the evaluation trains each
    # variant on its own
    GRID_AXES: Tuple[str, ...] = ()

    # whether ``train`` and ``train_grid`` take a ``Mesh`` (and shard the
    # training over it); otherwise ``Engine`` hands them the context's
    # device, the mesh's first device when only a mesh was given
    MESH_TRAINING: bool = False

    def train(self, device: Union[torch.device, Mesh], prepared_data) -> M:
        raise NotImplementedError

    @classmethod
    def train_grid(
        cls, device: torch.device, prepared_data, algos: Sequence["BaseAlgorithm"]
    ) -> Optional[List[M]]:
        """Train several variants of this algorithm, whose params differ
        only in ``GRID_AXES`` fields, together on ``device``: one model per
        entry of ``algos``, in order, or None when these variants cannot
        train together (the evaluation then trains each with ``train``).
        Default: None."""
        return None

    def predict(self, model: M, query: Q) -> P:
        raise NotImplementedError

    def batch_predict(
        self, model: M, queries: Sequence[Tuple[int, Q]]
    ) -> List[Tuple[int, P]]:
        """Predict for indexed queries; override with a batched device
        predict (reference P2LAlgorithm.batchPredict default)."""
        return [(i, self.predict(model, q)) for i, q in queries]

    # whether ``prepare_serving`` takes a ``Mesh`` (and serves over it);
    # otherwise ``Engine.prepare_deploy`` hands it the mesh's first device
    MESH_SERVING: bool = False

    def prepare_serving(self, device: Union[torch.device, Mesh], model: M) -> M:
        """Deploy-time hook: bind the model's serving state to ``device``,
        or, where ``MESH_SERVING``, to a ``Mesh``. Default: model
        unchanged."""
        return model

    def warm(self, model: M) -> None:
        """Deploy-time warm-up before the server takes traffic. Default:
        nothing."""

    def serving_precision(self, model: M) -> Optional[str]:
        """The residency precision this algorithm serves ``model`` with
        ("float32", "bf16", "int8"), or None where it has no such notion
        or no serving state yet. Default: None."""
        return None

    def release_serving(self, model: M) -> None:
        """Free the device-resident serving state a model holds. A query
        racing past the release must still be servable. Default:
        nothing."""

    def query_from_json(self, json_obj: Any) -> Q:
        """Build a query from a JSON payload: the declared ``query_class``
        dataclass, or the raw value when none is declared."""
        qcls = getattr(self, "query_class", None)
        if qcls is not None:
            return params_from_json(json_obj, qcls)
        return json_obj

    def result_to_json(self, result: P) -> Any:
        """Serialize a predicted result: dataclasses field-wise, anything
        else as it is."""
        if dataclasses.is_dataclass(result) and not isinstance(result, type):
            return dataclasses.asdict(result)
        return result


class BaseServing(Controller, Generic[Q, P]):
    """Combines per-algorithm predictions into the served result
    (reference core/BaseServing.scala:28-51)."""

    def supplement(self, query: Q) -> Q:
        return query

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        raise NotImplementedError


class FirstServing(BaseServing[Q, P]):
    """Serves the first algorithm's prediction
    (reference controller/LFirstServing.scala:24-39)."""

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        return predictions[0]


class LServing(BaseServing[Q, P]):
    """The reference's name for a serving base (LServing.scala:31-52)."""


class AverageServing(BaseServing[Q, float]):
    """Averages numeric predictions (reference
    controller/LAverageServing.scala:24-41)."""

    def serve(self, query: Q, predictions: Sequence[float]) -> float:
        return sum(predictions) / len(predictions)


# the reference's names: the P/P2L/L split collapses in one process that
# drives every device
PDataSource = BaseDataSource
LDataSource = BaseDataSource
PPreparator = BasePreparator
LPreparator = BasePreparator
P2LAlgorithm = BaseAlgorithm
LAlgorithm = BaseAlgorithm


class PAlgorithm(BaseAlgorithm[M, Q, P]):
    """An algorithm whose model stays sharded over its devices (reference
    controller/PAlgorithm.scala:44): persisted as None, re-trained on
    deploy."""

    sharded_model = True
