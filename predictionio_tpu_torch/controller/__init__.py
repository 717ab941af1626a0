"""The subset of the DASE controller API the ported slices use (the
counterpart of ``predictionio_tpu/controller``): params from JSON, the
data check, the preparator, algorithm and serving bases, and an engine
that builds them and prepares a deploy. Evaluation and the train workflow
come with later slices."""

from predictionio_tpu_torch.controller.base import (
    BaseAlgorithm,
    BasePreparator,
    BaseServing,
    FirstServing,
    SanityCheck,
)
from predictionio_tpu_torch.controller.engine import Engine, EngineFactory, EngineParams
from predictionio_tpu_torch.controller.params import (
    EmptyParams,
    Params,
    ParamsError,
    params_from_json,
    params_to_json,
)

__all__ = [
    "BaseAlgorithm",
    "BasePreparator",
    "BaseServing",
    "EmptyParams",
    "Engine",
    "EngineFactory",
    "EngineParams",
    "FirstServing",
    "Params",
    "ParamsError",
    "SanityCheck",
    "params_from_json",
    "params_to_json",
]
