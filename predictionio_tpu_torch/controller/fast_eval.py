"""FastEvalEngine: eval-time stage memoization for grid search, the
port's counterpart of ``predictionio_tpu/controller/fast_eval.py``
(reference controller/FastEvalEngine.scala:309-343 and
FastEvalEngineWorkflow :86-298): during ``batch_eval`` over a params grid,
stage results are cached keyed by the params *prefix* — data-source reads
by data-source params; prepared data by (data source, preparator); trained
models by (data source, preparator, algorithms); served eval results by
the full tuple — so a grid varying only algorithm params reads and
prepares the data once.

Before that, ``prefill_grid_models`` trains the variants that differ only
in an algorithm's ``GRID_AXES`` together (``BaseAlgorithm.train_grid``:
for ALS the regularizer grid, K13; on the workflow's mesh, K13s, where
the algorithm trains on one). ``grid_train="auto"`` runs it on a
CUDA device and not on the CPU, as the reference's ``auto`` skips its CPU
backend. A failed ``train_grid`` falls back to per-variant training with
a warning, as the reference's does, except when a kernel did not build or
launch (``native.KernelError``): that is raised.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
from typing import Any, Callable, Dict, List, Sequence, Tuple

from predictionio_tpu_torch.controller.base import doer
from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineParams,
    _run_grid,
    training_target,
)
from predictionio_tpu_torch.controller.params import Params, params_to_json
from predictionio_tpu_torch.ops.native import KernelError

logger = logging.getLogger(__name__)


def _key_of(pairs: Sequence[Tuple[str, Params]]) -> str:
    return json.dumps(
        [[name, params_to_json(p)] for name, p in pairs], sort_keys=True, default=str
    )


class FastEvalEngineWorkflow:
    """Holds the per-stage caches (reference FastEvalEngineWorkflow:295-298)."""

    def __init__(self, engine: "FastEvalEngine", ctx, workflow_params):
        self.engine = engine
        self.ctx = ctx
        self.workflow_params = workflow_params
        self.data_source_cache: Dict[str, Any] = {}
        self.preparator_cache: Dict[str, Any] = {}
        self.algorithms_cache: Dict[str, Any] = {}
        self.serving_cache: Dict[str, Any] = {}
        # Concurrent grid variants sharing a params-prefix must compute the
        # cached stage exactly once: a per-(cache, key) build lock makes the
        # second variant wait for the first's result instead of duplicating
        # an expensive train/prepare (memoization is the whole point here).
        self._guard = threading.Lock()
        self._build_locks: Dict[Tuple[int, str], threading.Lock] = {}

    def _memo(self, cache: Dict[str, Any], key: str, build: Callable[[], Any]) -> Any:
        if key in cache:
            return cache[key]
        with self._guard:
            lock = self._build_locks.setdefault((id(cache), key), threading.Lock())
        with lock:
            if key not in cache:
                cache[key] = build()
        return cache[key]

    # --- stage getters (reference :86-278) ---

    def get_eval_sets(self, ds_pair: Tuple[str, Params]):
        def build():
            cls = self.engine._lookup(
                self.engine.data_source_class_map, ds_pair[0], "DataSource"
            )
            return doer(cls, ds_pair[1]).read_eval(self.ctx)

        return self._memo(self.data_source_cache, _key_of([ds_pair]), build)

    def get_prepared(self, ds_pair, prep_pair):
        def build():
            cls = self.engine._lookup(
                self.engine.preparator_class_map, prep_pair[0], "Preparator"
            )
            prep = doer(cls, prep_pair[1])
            eval_sets = self.get_eval_sets(ds_pair)
            return [
                (prep.prepare(self.ctx.device, td), ei, qa) for td, ei, qa in eval_sets
            ]

        return self._memo(
            self.preparator_cache, _key_of([ds_pair, prep_pair]), build
        )

    def get_models(self, ds_pair, prep_pair, algo_list):
        def build():
            algos = [
                doer(
                    self.engine._lookup(
                        self.engine.algorithm_class_map, name, "Algorithm"
                    ),
                    p,
                )
                for name, p in algo_list
            ]
            prepared = self.get_prepared(ds_pair, prep_pair)
            return [
                [algo.train(training_target(self.ctx, algo), pd) for algo in algos]
                for pd, _, _ in prepared
            ]

        return self._memo(
            self.algorithms_cache,
            _key_of([ds_pair, prep_pair] + list(algo_list)),
            build,
        )

    def prefill_grid_models(
        self, engine_params_list: Sequence[EngineParams]
    ) -> int:
        """Device-side grid training: single-algorithm variants whose
        params differ only in the algorithm's GRID_AXES fields train
        together in one batched program (BaseAlgorithm.train_grid), and
        the per-variant models seed algorithms_cache so get_models is a
        cache hit. Returns the number of variants trained this way.

        Anything that doesn't group (multi-algo engines, differing
        non-axis params, an algorithm without a grid path) is left for
        the thread-parallel fallback in batch_eval."""
        # value validated by WorkflowParams.__post_init__
        mode = getattr(self.workflow_params, "grid_train", "auto")
        if mode == "never":
            return 0
        if mode == "auto" and self.ctx.device.type != "cuda":
            # on the CPU the twins run the variants one after another
            # anyway, as the reference's auto skips its CPU backend
            return 0

        # group by (ds, prep, algo name, params-with-axes-normalized)
        groups: Dict[Tuple, List[EngineParams]] = {}
        defaults_by_class: Dict[type, Any] = {}
        for ep in engine_params_list:
            if len(ep.algorithm_params_list) != 1:
                continue
            name, params = ep.algorithm_params_list[0]
            try:
                cls = self.engine._lookup(
                    self.engine.algorithm_class_map, name, "Algorithm"
                )
            except (KeyError, ValueError):
                continue
            axes = getattr(cls, "GRID_AXES", ())
            if not axes or not dataclasses.is_dataclass(params):
                continue
            fields = {f.name for f in dataclasses.fields(params)}
            if not all(a in fields for a in axes):
                continue
            pcls = type(params)
            if pcls not in defaults_by_class:
                try:
                    defaults_by_class[pcls] = pcls()
                except TypeError:
                    # params class with required fields can't provide
                    # neutral axis values — skip grouping, don't crash
                    defaults_by_class[pcls] = None
            default_params = defaults_by_class[pcls]
            if default_params is None:
                continue
            normalized = dataclasses.replace(
                params, **{a: getattr(default_params, a, None) for a in axes}
            )
            key = (
                _key_of([ep.data_source_params, ep.preparator_params]),
                name,
                _key_of([("", normalized)]),
            )
            groups.setdefault(key, []).append(ep)

        def grid_one_group(item) -> int:
            (_, name, _), eps = item
            # dedup variants whose FULL algo params match (they share a
            # cache entry anyway)
            unique: Dict[str, EngineParams] = {}
            for ep in eps:
                unique.setdefault(self._models_key(ep), ep)
            eps = list(unique.values())
            if len(eps) < 2:
                return 0
            cls = self.engine._lookup(
                self.engine.algorithm_class_map, name, "Algorithm"
            )
            algos = [
                doer(cls, ep.algorithm_params_list[0][1]) for ep in eps
            ]
            prepared = self.get_prepared(
                eps[0].data_source_params, eps[0].preparator_params
            )
            fold_models = []  # [fold][variant]
            for pd, _, _ in prepared:
                try:
                    models = cls.train_grid(training_target(self.ctx, algos[0]), pd, algos)
                except KernelError:
                    # a kernel that did not build or launch is a fault
                    # of the port, never hidden behind per-variant trains
                    raise
                except Exception:
                    # a failed batched train (e.g. the batched systems do
                    # not fit where serial variants would) must fall
                    # back, not abort the evaluation
                    logger.warning(
                        "train_grid failed for %s; falling back to "
                        "per-variant training", cls.__name__, exc_info=True,
                    )
                    return 0
                if models is None or len(models) != len(algos):
                    return 0
                fold_models.append(models)
            for v, ep in enumerate(eps):
                self.algorithms_cache[self._models_key(ep)] = [
                    [models[v]] for models in fold_models
                ]
            return len(eps)

        # groups (e.g. the rank-8 and rank-16 halves of a grid) run
        # concurrently: one's host packing overlaps the other's launches
        n_gridded = sum(
            _run_grid(list(groups.items()), grid_one_group, self.workflow_params)
        )
        if n_gridded:
            logger.info(
                "FastEval: %d grid variants trained together (train_grid)",
                n_gridded,
            )
        return n_gridded

    def _models_key(self, ep: EngineParams) -> str:
        return _key_of(
            [ep.data_source_params, ep.preparator_params]
            + list(ep.algorithm_params_list)
        )

    def get_results(self, engine_params: EngineParams):
        ds_pair = engine_params.data_source_params
        prep_pair = engine_params.preparator_params
        algo_list = list(engine_params.algorithm_params_list)
        serv_pair = engine_params.serving_params
        def build():
            algos = [
                doer(
                    self.engine._lookup(
                        self.engine.algorithm_class_map, name, "Algorithm"
                    ),
                    p,
                )
                for name, p in algo_list
            ]
            serving = doer(
                self.engine._lookup(
                    self.engine.serving_class_map, serv_pair[0], "Serving"
                ),
                serv_pair[1],
            )
            prepared = self.get_prepared(ds_pair, prep_pair)
            fold_models = self.get_models(ds_pair, prep_pair, algo_list)
            out = []
            for (pd, eval_info, qa_pairs), models in zip(prepared, fold_models):
                qpa = Engine.serve_fold(algos, models, serving, qa_pairs)
                out.append((eval_info, qpa))
            return out

        return self._memo(
            self.serving_cache,
            _key_of([ds_pair, prep_pair] + algo_list + [serv_pair]),
            build,
        )


class FastEvalEngine(Engine):
    """Engine whose batch_eval memoizes shared params-prefixes
    (reference FastEvalEngine.scala:309-343)."""

    def batch_eval(
        self, ctx, engine_params_list: Sequence[EngineParams], workflow_params
    ):
        self._require_data_source()
        workflow = FastEvalEngineWorkflow(self, ctx, workflow_params)
        # the grid pass first: variants differing only in an algorithm's
        # GRID_AXES train together; whatever it cannot batch trains per
        # variant in get_results below
        workflow.prefill_grid_models(engine_params_list)
        return _run_grid(
            engine_params_list,
            lambda ep: (ep, workflow.get_results(ep)),
            workflow_params,
        )
