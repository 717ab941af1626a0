"""The subset of the DASE controller API the ported slices use (the
counterpart of ``predictionio_tpu/controller``): params from JSON, the
data check, the data source, preparator, algorithm and serving bases, an
engine that builds them, trains, evaluates a params grid and prepares a
deploy (and ``SimpleEngine``, its one-algorithm form), models that
persist themselves (``PersistentModel``), ``PAlgorithm`` (a model re-trained
on deploy) and the reference's P/P2L/L aliases.
The metrics and the evaluator are in ``metrics`` and ``evaluation``;
engine instances come with the event store."""

from predictionio_tpu_torch.controller.base import (
    AverageServing,
    BaseAlgorithm,
    BaseDataSource,
    BasePreparator,
    BaseServing,
    FirstServing,
    IdentityPreparator,
    LAlgorithm,
    LDataSource,
    LPreparator,
    LServing,
    P2LAlgorithm,
    PAlgorithm,
    PDataSource,
    PPreparator,
    SanityCheck,
)
from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineFactory,
    EngineParams,
    SimpleEngine,
    SimpleEngineParams,
)
from predictionio_tpu_torch.controller.persistent_model import (
    LocalFileSystemPersistentModel,
    PersistentModel,
    PersistentModelManifest,
    load_persistent_model,
)
from predictionio_tpu_torch.controller.params import (
    EmptyParams,
    Params,
    ParamsError,
    params_from_json,
    params_to_json,
)

__all__ = [
    "AverageServing",
    "BaseAlgorithm",
    "BaseDataSource",
    "BasePreparator",
    "BaseServing",
    "EmptyParams",
    "Engine",
    "EngineFactory",
    "EngineParams",
    "FirstServing",
    "IdentityPreparator",
    "LAlgorithm",
    "LDataSource",
    "LPreparator",
    "LServing",
    "LocalFileSystemPersistentModel",
    "P2LAlgorithm",
    "PAlgorithm",
    "PDataSource",
    "PPreparator",
    "Params",
    "ParamsError",
    "PersistentModel",
    "PersistentModelManifest",
    "SanityCheck",
    "SimpleEngine",
    "SimpleEngineParams",
    "load_persistent_model",
    "params_from_json",
    "params_to_json",
]
