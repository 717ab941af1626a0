"""Engine: the counterpart of ``predictionio_tpu/controller/engine.py``
(reference controller/Engine.scala:80, eval :311 -> :726-816,
prepareDeploy :196-265; controller/EngineParams.scala:32).

An engine holds a class map per DASE slot (data source, preparator,
algorithms, serving) and builds the components from ``EngineParams``.
``train`` reads the data source, prepares and trains every algorithm on
the context's device, or on its mesh where the algorithm trains on one
(``training_target``; reference train :154 -> :621-708, with the data
checks and the stop-after-read/prepare interruptions :662-686).
``eval`` reads a data source's folds and, per fold, prepares, trains and
serves the held-out queries (``serve_fold``); ``batch_eval`` does that for
every variant of a params grid on a thread pool.
``make_serializable_models`` turns trained models into what is kept: a
``PersistentModel`` saves itself and leaves a manifest
(``controller/persistent_model.py``), a ``sharded_model`` algorithm's other
models are kept as None; ``prepare_deploy`` loads manifests back,
re-trains the None models from a ``WorkflowContext`` and prepares every
model for serving on one device or a ``Mesh``.
``EngineFactory`` is the user object that returns an engine. Engine
instances, their stored params and engine.json parsing come with the
event store (ROADMAP.md queue 1 item 3). ``SimpleEngine`` (one data
source, one algorithm, the identity preparator and first serving) and
``SimpleEngineParams`` are the reference's sugar for the small templates.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from predictionio_tpu_torch.controller.base import (
    FirstServing,
    IdentityPreparator,
    SanityCheck,
    doer,
)
from predictionio_tpu_torch.controller.params import EmptyParams, Params, params_to_json
from predictionio_tpu_torch.controller.persistent_model import (
    PersistentModel,
    PersistentModelManifest,
    load_persistent_model,
)
from predictionio_tpu_torch.parallel.mesh import Mesh

logger = logging.getLogger(__name__)


def training_target(ctx, algo) -> Union[torch.device, Mesh]:
    """What ``algo`` trains on: the workflow's mesh (``ctx.mesh``) for an
    algorithm that trains on one (``MESH_TRAINING``), where it has several
    shards, else ``ctx.device`` (one shard's mesh is the device, as the
    reference's templates collapse a one-device mesh)."""
    if algo.MESH_TRAINING and ctx.mesh.size > 1:
        return ctx.mesh
    return ctx.device


class StopAfterReadInterruption(Exception):
    """The stop-after-read debug stop (reference WorkflowUtils.scala:410)."""


class StopAfterPrepareInterruption(Exception):
    """The stop-after-prepare debug stop (reference WorkflowUtils.scala:412)."""


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Named (name, params) per DASE slot plus the ordered algorithm list
    (reference controller/EngineParams.scala:32)."""

    data_source_params: Tuple[str, Params] = ("", EmptyParams())
    preparator_params: Tuple[str, Params] = ("", EmptyParams())
    algorithm_params_list: Tuple[Tuple[str, Params], ...] = ()
    serving_params: Tuple[str, Params] = ("", EmptyParams())

    def __post_init__(self):
        object.__setattr__(
            self, "algorithm_params_list", tuple(self.algorithm_params_list)
        )

    def to_json(self) -> Dict[str, Any]:
        return {
            "datasource": {
                "name": self.data_source_params[0],
                "params": params_to_json(self.data_source_params[1]),
            },
            "preparator": {
                "name": self.preparator_params[0],
                "params": params_to_json(self.preparator_params[1]),
            },
            "algorithms": [
                {"name": n, "params": params_to_json(p)}
                for n, p in self.algorithm_params_list
            ],
            "serving": {
                "name": self.serving_params[0],
                "params": params_to_json(self.serving_params[1]),
            },
        }


def _run_grid(items: Sequence[Any], fn, workflow_params) -> List[Any]:
    """Map ``fn`` over the grid's items, in order, on a thread pool of
    ``workflow_params.eval_parallelism`` workers (the reference's `.par`
    over param sets, MetricEvaluator.scala:221-230); serially for one."""
    items = list(items)
    workers = min(int(getattr(workflow_params, "eval_parallelism", 1) or 1), len(items))
    if workers <= 1:
        return [fn(x) for x in items]
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, items))


def _as_class_map(classes) -> Dict[str, type]:
    """A single class becomes the default-name map; None an empty one."""
    if classes is None:
        return {}
    if isinstance(classes, Mapping):
        return dict(classes)
    return {"": classes}


class Engine:
    """The four class maps (reference Engine.scala:80). An engine without
    a data source (the Similar Product engines, whose data source reads
    the event store) deploys but does not evaluate."""

    def __init__(
        self,
        data_source_classes=None,
        preparator_classes=None,
        algorithm_classes=None,
        serving_classes=None,
    ):
        self.data_source_class_map = _as_class_map(data_source_classes)
        self.preparator_class_map = _as_class_map(
            preparator_classes if preparator_classes is not None else IdentityPreparator
        )
        self.algorithm_class_map = _as_class_map(algorithm_classes)
        self.serving_class_map = _as_class_map(
            serving_classes if serving_classes is not None else FirstServing
        )

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
        """(data_source, preparator, algorithms, serving) instantiated from
        ``engine_params``; the data source is None on an engine that has
        none."""
        ds_name, ds_params = engine_params.data_source_params
        prep_name, prep_params = engine_params.preparator_params
        data_source = (
            doer(self._lookup(self.data_source_class_map, ds_name, "DataSource"), ds_params)
            if self.data_source_class_map else None
        )
        preparator = doer(
            self._lookup(self.preparator_class_map, prep_name, "Preparator"), prep_params
        )
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
        return data_source, preparator, algorithms, serving

    # --- training (reference object Engine.train :621-708) ---

    def train(self, ctx, engine_params: EngineParams, workflow_params) -> List[Any]:
        """Read the data source with ``ctx``, prepare, and train every
        algorithm on its ``training_target``: one model per algorithm, in
        order."""
        self._require_data_source()
        data_source, preparator, algorithms, _ = self.make_components(engine_params)
        return self._train_pipeline(ctx, data_source, preparator, algorithms, workflow_params)

    @staticmethod
    def _sanity(obj: Any, label: str, workflow_params) -> None:
        if workflow_params.skip_sanity_check:
            return
        if isinstance(obj, SanityCheck):
            logger.info("%s: performing data sanity check", label)
            obj.sanity_check()

    def _train_pipeline(
        self, ctx, data_source, preparator, algorithms, workflow_params
    ) -> List[Any]:
        td = data_source.read_training(ctx)
        self._sanity(td, "TrainingData", workflow_params)
        if workflow_params.stop_after_read:
            raise StopAfterReadInterruption()
        pd = preparator.prepare(ctx.device, td)
        self._sanity(pd, "PreparedData", workflow_params)
        if workflow_params.stop_after_prepare:
            raise StopAfterPrepareInterruption()
        models = []
        for i, algo in enumerate(algorithms):
            model = algo.train(training_target(ctx, algo), pd)
            self._sanity(model, f"Model of algorithm[{i}]", workflow_params)
            models.append(model)
        return models

    # --- evaluation (reference object Engine.eval :726-816) ---

    @staticmethod
    def serve_fold(algorithms, models, serving, qa_pairs) -> List[Tuple[Any, Any, Any]]:
        """Supplement the queries, batch-predict per algorithm, regroup
        per query and serve (reference :786-810). Shared by ``eval`` and
        the FastEval workflow."""
        queries = [(qx, serving.supplement(q)) for qx, (q, _) in enumerate(qa_pairs)]
        per_query: Dict[int, List[Any]] = {qx: [] for qx, _ in queries}
        for algo, model in zip(algorithms, models):
            for qx, p in algo.batch_predict(model, queries):
                per_query[qx].append(p)
        return [
            (q, serving.serve(q, per_query[qx]), a)
            for qx, (q, a) in enumerate(qa_pairs)
        ]

    def _require_data_source(self) -> None:
        if not self.data_source_class_map:
            raise NotImplementedError(
                "this engine has no ported DataSource: its data source reads "
                "the event store (PEventStore), which is not ported yet "
                "(ROADMAP.md queue 1 item 3)"
            )

    def eval(
        self, ctx, engine_params: EngineParams, workflow_params
    ) -> List[Tuple[Any, List[Tuple[Any, Any, Any]]]]:
        """Per fold of the data source's ``read_eval(ctx)``: prepare,
        train every algorithm on its ``training_target`` and serve the
        fold's queries. Returns [(eval_info, [(query, predicted, actual)])]."""
        self._require_data_source()
        data_source, preparator, algorithms, serving = self.make_components(
            engine_params
        )
        out = []
        for td, eval_info, qa_pairs in data_source.read_eval(ctx):
            pd = preparator.prepare(ctx.device, td)
            models = [algo.train(training_target(ctx, algo), pd) for algo in algorithms]
            out.append((eval_info, self.serve_fold(algorithms, models, serving, qa_pairs)))
        return out

    def batch_eval(
        self, ctx, engine_params_list: Sequence[EngineParams], workflow_params
    ) -> List[Tuple[EngineParams, List[Tuple[Any, List[Tuple[Any, Any, Any]]]]]]:
        """``eval`` over the params grid, ``eval_parallelism`` variants at a
        time (device launches queue on one stream; each variant's host
        stages overlap the others'). Results keep grid order."""
        self._require_data_source()
        return _run_grid(
            engine_params_list,
            lambda ep: (ep, self.eval(ctx, ep, workflow_params)),
            workflow_params,
        )

    # --- deploy ---

    def prepare_deploy(
        self,
        device: Union[torch.device, Mesh],
        engine_params: EngineParams,
        models: Sequence[Any],
        engine_instance_id: Optional[str] = None,
        ctx=None,
    ) -> List[Any]:
        """Load each ``PersistentModelManifest`` through its class's loader
        (the model saved under ``engine_instance_id``), re-train each model
        persisted as None (a ``sharded_model`` algorithm's), then bind each
        model's serving state to ``device`` (reference prepareDeploy
        :196-265). The re-train reads the data source with ``ctx``, the
        ``WorkflowContext`` it needs (``read_training`` → ``prepare`` →
        ``train`` on its ``training_target``, as the reference's :330-340);
        a None model without ``ctx`` raises ``ValueError``. ``device`` may
        be a ``Mesh``: an algorithm with ``MESH_SERVING`` serves over it,
        the others (and the loaders) on its first device."""
        mesh = device if isinstance(device, Mesh) else None
        if mesh is not None:
            device = mesh.devices[0]
        data_source, preparator, algorithms, _ = self.make_components(engine_params)
        if len(models) != len(algorithms):
            raise ValueError(
                f"{len(models)} models for {len(algorithms)} algorithms"
            )
        pd = None
        out = []
        for algo, m in zip(algorithms, models):
            if m is None:
                if ctx is None:
                    raise ValueError(
                        f"the model of {type(algo).__name__} was not persisted (a sharded "
                        "model): prepare_deploy needs the WorkflowContext to re-train it"
                    )
                if pd is None:
                    logger.info("some persisted models are absent; re-training for deploy")
                    self._require_data_source()
                    pd = preparator.prepare(ctx.device, data_source.read_training(ctx))
                m = algo.train(training_target(ctx, algo), pd)
            elif isinstance(m, PersistentModelManifest):
                if engine_instance_id is None:
                    raise ValueError(
                        f"a manifest of {m.class_name} needs the engine instance "
                        "id its model was saved under"
                    )
                m = load_persistent_model(m, engine_instance_id, algo.params, device)
            target = mesh if mesh is not None and algo.MESH_SERVING else device
            out.append(algo.prepare_serving(target, m))
        return out

    def make_serializable_models(
        self,
        device: torch.device,
        engine_instance_id: str,
        engine_params: EngineParams,
        models: Sequence[Any],
    ) -> List[Any]:
        """The persisted form of trained models (reference
        makeSerializableModels :282-300): a ``PersistentModel`` saves itself
        under ``engine_instance_id`` and is kept as its manifest, unless its
        ``save`` returns False; a ``sharded_model`` algorithm's other models
        are kept as None (re-trained on deploy); every other model is kept
        as it is."""
        _, _, algorithms, _ = self.make_components(engine_params)
        out = []
        for algo, model in zip(algorithms, models):
            if isinstance(model, PersistentModel):
                if model.save(engine_instance_id, algo.params, device):
                    cls = type(model)
                    out.append(PersistentModelManifest(f"{cls.__module__}.{cls.__qualname__}"))
                else:
                    out.append(model)
            elif algo.sharded_model:
                out.append(None)
            else:
                out.append(model)
        return out


class SimpleEngine(Engine):
    """1 algorithm + identity preparator + first serving
    (reference controller/EngineParams.scala:127)."""

    def __init__(self, data_source_class, algorithm_class):
        super().__init__(
            data_source_classes=data_source_class,
            preparator_classes=IdentityPreparator,
            algorithm_classes=algorithm_class,
            serving_classes=FirstServing,
        )


@dataclasses.dataclass(frozen=True)
class SimpleEngineParams:
    """Sugar mirroring reference SimpleEngineParams :141."""

    data_source_params: Params = EmptyParams()
    algorithm_params: Params = EmptyParams()

    def to_engine_params(self) -> EngineParams:
        return EngineParams(
            data_source_params=("", self.data_source_params),
            algorithm_params_list=(("", self.algorithm_params),),
        )


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
