"""Engine: the deploy-side subset of ``predictionio_tpu/controller/engine.py``
(reference controller/Engine.scala:80 and prepareDeploy :196-265).

It builds an engine's algorithms and serving from ``EngineParams`` and
prepares loaded models for serving on one device; ``EngineFactory`` is the
user object that returns an engine. The train and eval workflows come with
a later slice; an algorithm trains on its own (``BaseAlgorithm.train``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch

from predictionio_tpu_torch.controller.base import FirstServing, doer
from predictionio_tpu_torch.controller.params import EmptyParams, Params


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Named (name, params) per algorithm plus the serving slot
    (reference controller/EngineParams.scala:32)."""

    algorithm_params_list: Tuple[Tuple[str, Params], ...] = ()
    serving_params: Tuple[str, Params] = ("", EmptyParams())

    def __post_init__(self):
        object.__setattr__(
            self, "algorithm_params_list", tuple(self.algorithm_params_list)
        )


def _as_class_map(classes) -> Dict[str, type]:
    """A single class becomes the default-name map."""
    if isinstance(classes, Mapping):
        return dict(classes)
    return {"": classes}


class Engine:
    """Algorithm and serving class maps (reference Engine.scala:80)."""

    def __init__(self, algorithm_classes, serving_classes=FirstServing):
        self.algorithm_class_map = _as_class_map(algorithm_classes)
        self.serving_class_map = _as_class_map(serving_classes)

    @staticmethod
    def _lookup(class_map: Dict[str, type], name: str, slot: str) -> type:
        if name not in class_map:
            if name == "" and len(class_map) == 1:
                return next(iter(class_map.values()))
            raise KeyError(
                f"{slot} class with name {name!r} is not defined; "
                f"available: {sorted(class_map)}"
            )
        return class_map[name]

    def make_components(self, engine_params: EngineParams):
        """(algorithms, serving) instantiated from ``engine_params``."""
        algorithms = [
            doer(self._lookup(self.algorithm_class_map, name, "Algorithm"), p)
            for name, p in engine_params.algorithm_params_list
        ]
        if not algorithms:
            raise ValueError("EngineParams defines no algorithms")
        serv_name, serv_params = engine_params.serving_params
        serving = doer(
            self._lookup(self.serving_class_map, serv_name, "Serving"),
            serv_params,
        )
        return algorithms, serving

    def prepare_deploy(
        self,
        device: torch.device,
        engine_params: EngineParams,
        models: Sequence[Any],
    ) -> List[Any]:
        """Bind each loaded model's serving state to ``device`` (reference
        prepareDeploy; the port deploys persisted models only)."""
        algorithms, _ = self.make_components(engine_params)
        if len(models) != len(algorithms):
            raise ValueError(
                f"{len(models)} models for {len(algorithms)} algorithms"
            )
        return [
            algo.prepare_serving(device, m)
            for algo, m in zip(algorithms, models)
        ]


class EngineFactory:
    """User object returning an Engine (reference
    controller/EngineFactory.scala:24-37).

    Subclass and implement ``apply()``; optionally override
    ``engine_params(key)`` for params-by-key lookup.
    """

    def apply(self) -> Engine:
        raise NotImplementedError

    def engine_params(self, key: str) -> EngineParams:
        raise KeyError(f"engine params key {key!r} is not defined")
