"""The deploy-side subset of the DASE controller API (the counterpart of
``predictionio_tpu/controller``): params from JSON, the algorithm and
serving bases, and an engine that builds them and prepares a deploy.
Training and evaluation come with the training slice."""

from predictionio_tpu_torch.controller.base import (
    BaseAlgorithm,
    BaseServing,
    FirstServing,
)
from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.controller.params import (
    EmptyParams,
    Params,
    ParamsError,
    params_from_json,
    params_to_json,
)

__all__ = [
    "BaseAlgorithm",
    "BaseServing",
    "EmptyParams",
    "Engine",
    "EngineParams",
    "FirstServing",
    "Params",
    "ParamsError",
    "params_from_json",
    "params_to_json",
]
