"""Recommendation engine: the counterpart of
``predictionio_tpu/models/recommendation/engine.py`` (reference
examples/scala-parallel-recommendation/custom-query: Engine.scala,
DataSource.scala, Preparator.scala, ALSAlgorithm.scala:24-105,
Serving.scala).

Queries, results, training data and params keep the reference's fields and
JSON names. ``ALSAlgorithm.train`` trains on a ``torch.device`` through
``ops/streaming.train_als_streaming`` when the training data streams
(``StreamingTrainingData``), else through ``ops/als.train_als``: both take
the wire route (K4 and K5 pack, then K1 and K2 per half-step, with K12's
Gramian and objective under ``implicit_prefs=True``). On a ``Mesh`` of
several shards (``MESH_TRAINING``) it trains through ``train_als``'s mesh
route (K6s: row shards), and ``train_grid`` through ``train_als_grid``'s
(K13s). ``ALSModel.recommend_many``
serves a micro-batch with one K3 launch on the model's device; with
``precision="int8"`` or ``"bf16"`` it serves through an ``ItemRetriever``
(``ops/retrieval.py``) instead: the catalog resident quantized, stage 1
(kernel A) shortlists, stage 2 (kernel B) rescores the shortlist exactly,
and the host refines against the original rows. ``prepare_serving`` takes
a ``Mesh`` too: K3s (``ServingFactors(mesh)``) or the row-sharded
retriever (K10s and the K9m merge).
``DataSource`` reads the event columns the workflow context supplies for
its app (the port has no event store yet, ROADMAP.md queue 1 item 3) and
splits them into k folds for evaluation; ``ALSAlgorithm.train_grid``
trains an evaluation grid's regularizer variants together
(``ops/als.train_als_grid``, K13).
``als_model_from_numpy`` builds a model from a trained model's arrays,
which is how a model trained by the JAX package is carried across (as
numpy: the port never imports the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    BaseAlgorithm,
    BaseDataSource,
    BasePreparator,
    Engine,
    FirstServing,
    Params,
    SanityCheck,
)
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops.als import (
    ALSConfig,
    ALSModelArrays,
    ServingFactors,
    train_als,
    train_als_grid,
    validate_solver,
)
from predictionio_tpu_torch.ops.retrieval import ItemRetriever
from predictionio_tpu_torch.ops.streaming import train_als_streaming
from predictionio_tpu_torch.parallel.mesh import Mesh, split_target
from predictionio_tpu_torch.utils.shapes import pow2_topk_width


@dataclasses.dataclass(frozen=True)
class Query:
    user: str
    num: int = 10


@dataclasses.dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    item_scores: Tuple[ItemScore, ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self,
            "item_scores",
            tuple(
                s if isinstance(s, ItemScore) else ItemScore(**s)
                for s in self.item_scores
            ),
        )


@dataclasses.dataclass(frozen=True)
class ActualResult:
    items: Tuple[str, ...] = ()


@dataclasses.dataclass
class Rating:
    user: str
    item: str
    rating: float


@dataclasses.dataclass
class TrainingData(SanityCheck):
    """Dense-indexed rating columns: ``user_idx[n]``/``item_idx[n]`` are
    rows of ``user_index``/``item_index``."""

    user_idx: np.ndarray
    item_idx: np.ndarray
    ratings: np.ndarray
    user_index: BiMap
    item_index: BiMap

    def sanity_check(self) -> None:
        if len(self.ratings) == 0:
            raise ValueError(
                "ratings is empty — is the event store populated with "
                "rate/buy events?"
            )


class StreamingTrainingData(TrainingData):
    """Lazy TrainingData backed by a chunked store scan.

    The ALS algorithm feeds ``stream_factory`` straight into the
    streaming store→device pipeline (``ops/streaming``) without ever
    materializing the rating columns on host; any other consumer that
    touches the column attributes materializes them through ``loader``,
    so the DASE contract is unchanged."""

    def __init__(self, stream_factory, loader):
        # no super().__init__: columns materialize on first attribute
        # access through the class-level properties below
        self._stream_factory = stream_factory
        self._loader = loader
        self._td: Optional[TrainingData] = None

    @property
    def stream_factory(self):
        """() -> ColumnarStream for the streaming trainer (a FRESH stream
        per call)."""
        return self._stream_factory

    def materialize(self) -> TrainingData:
        if self._td is None:
            self._td = self._loader()
        return self._td

    user_idx = property(lambda self: self.materialize().user_idx)
    item_idx = property(lambda self: self.materialize().item_idx)
    ratings = property(lambda self: self.materialize().ratings)
    user_index = property(lambda self: self.materialize().user_index)
    item_index = property(lambda self: self.materialize().item_index)

    def sanity_check(self) -> None:
        # deferred: materializing here would serialize the very scan the
        # pipeline overlaps. The streaming trainer returns None on an
        # empty scan and the algorithm falls back to the materialized
        # path, whose sanity check raises the user-facing error.
        if self._td is not None:
            self._td.sanity_check()


@dataclasses.dataclass
class PreparedData:
    td: TrainingData


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "default"
    channel_name: Optional[str] = None
    event_names: Tuple[str, ...] = ("rate", "buy")
    # k-fold eval config (reference DataSource readEval)
    eval_k: Optional[int] = None
    eval_query_num: int = 10
    seed: int = 3


def _names(index: BiMap) -> np.ndarray:
    """The ids of a dense index in row order, as an object array."""
    names = np.empty(len(index), dtype=object)
    for name, row in index.items():
        names[row] = name
    return names


def _held_out_queries(
    users: np.ndarray, items: np.ndarray, user_names: np.ndarray,
    item_names: np.ndarray, num: int,
) -> List[Tuple[Query, ActualResult]]:
    """One (Query, ActualResult) per user with held-out items: users in the
    order they first appear, each one's items in scan order. The
    reference's loop over the events (``setdefault(u, []).append``),
    grouped with a stable sort instead."""
    if len(users) == 0:
        return []
    order = np.argsort(users, kind="stable")
    u_sorted = users[order]
    starts = np.flatnonzero(np.r_[True, u_sorted[1:] != u_sorted[:-1]])
    ends = np.r_[starts[1:], len(u_sorted)]
    held = item_names[items[order]].tolist()
    query_users = user_names[u_sorted[starts]].tolist()
    # a stable sort keeps each user's first event at the head of its run
    return [
        (Query(user=query_users[g], num=num),
         ActualResult(items=tuple(held[starts[g] : ends[g]])))
        for g in np.argsort(order[starts], kind="stable").tolist()
    ]


class DataSource(BaseDataSource):
    """Rating columns of an app (reference DataSource.scala). The reference
    scans the event store (``PEventStore.find_columns``); the port reads
    the columns the workflow context supplies for ``app_name``
    (``WorkflowContext.find_columns``) until the event store is ported
    (ROADMAP.md queue 1 item 3)."""

    params_class = DataSourceParams

    def read_training(self, ctx) -> TrainingData:
        cols = ctx.find_columns(self.params.app_name)
        return TrainingData(
            user_idx=cols.entity_idx,
            item_idx=cols.target_idx,
            ratings=cols.values,
            user_index=cols.entity_index,
            item_index=cols.target_index,
        )

    def read_eval(self, ctx):
        """``eval_k`` folds (the reference's :256-294): each rating goes to
        the fold ``default_rng(seed).integers(0, k, n)`` draws for it; a
        fold trains on the other folds' ratings and asks, per user with
        ratings in the fold, for ``eval_query_num`` items, the fold's items
        of that user being the actual result."""
        if not self.params.eval_k:
            return []
        cols = ctx.find_columns(self.params.app_name)
        k = self.params.eval_k
        rng = np.random.default_rng(self.params.seed)
        fold_of = rng.integers(0, k, size=cols.n)
        user_names, item_names = _names(cols.entity_index), _names(cols.target_index)
        out = []
        for fold in range(k):
            train_sel = fold_of != fold
            test_sel = ~train_sel
            td = TrainingData(
                user_idx=cols.entity_idx[train_sel],
                item_idx=cols.target_idx[train_sel],
                ratings=cols.values[train_sel],
                user_index=cols.entity_index,
                item_index=cols.target_index,
            )
            qa = _held_out_queries(
                cols.entity_idx[test_sel], cols.target_idx[test_sel],
                user_names, item_names, self.params.eval_query_num,
            )
            out.append((td, {"fold": fold}, qa))
        return out


class Preparator(BasePreparator):
    """Pass-through (reference Preparator.scala)."""

    def prepare(self, device, td: TrainingData) -> PreparedData:
        return PreparedData(td=td)


@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    """The reference's ALSAlgorithmParams, field for field, so an
    engine.json params block parses the same. Training takes explicit
    ratings, or implicit feedback with ``implicit_prefs=True`` and its
    confidence scale ``alpha`` (MLlib trainImplicit), with the exact solver
    or the iALS++ ``solver="subspace"`` and its ``block_size``. With
    ``checkpoint_dir`` training saves its factors every
    ``checkpoint_every`` sweeps and resumes a run of the same data and
    params from the latest save (ops/als.py). As the reference's, the params
    have no ``compute_dtype``: bfloat16 training is reached through
    ``ALSConfig``."""

    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    implicit_prefs: bool = False
    seed: Optional[int] = 3
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 5
    # deploy-time warm-up coverage: the largest query num and serving
    # batch size run once before traffic
    warm_num: int = 16
    warm_max_batch: int = 128
    delta_sweeps: int = 2
    # serving residency precision of the catalog: "float32" serves through
    # ServingFactors (K3); "bf16"/"int8" through an ItemRetriever (the
    # two-stage shortlist + exact rescore)
    precision: str = "float32"
    # stage-1 shortlist width multiplier c (shortlist = pow2(c*n))
    shortlist_mult: int = 4
    solver: str = "exact"
    block_size: int = 0

    def __post_init__(self):
        validate_solver(self.solver, self.block_size, self.rank)


@dataclasses.dataclass
class ALSModel:
    """Trained factors, id indexes and the params they were trained with.
    Device serving state is built lazily on the device attached at deploy
    (``attach_device``) and is never saved."""

    arrays: ALSModelArrays
    user_index: BiMap
    item_index: BiMap
    params: Optional[ALSAlgorithmParams] = None
    _device: Optional[torch.device] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _serving: Optional[ServingFactors] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _inv_item: Optional[BiMap] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # quantized serving state, built by prepare_serving; never saved
    _retriever: Optional[ItemRetriever] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # the deploy-time mesh (prepare_serving): query batches shard over it
    # and the catalog replicates (K3s); never saved
    _serving_mesh: Optional[Mesh] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def attach_device(self, device: DeviceLike) -> None:
        """Serve on ``device`` (drops serving state built elsewhere)."""
        self._device = resolve_device(device)
        self._serving_mesh = None
        self._serving = None

    def attach_serving_mesh(self, mesh: Mesh) -> None:
        """Serve over ``mesh`` (drops serving state built elsewhere, so the
        next predict uses the sharded factors). The mesh's first device
        stays the model's device: a straggler after ``release_serving``
        rebuilds its serving state there."""
        self._serving_mesh = mesh
        self._device = mesh.devices[0]
        self._serving = None

    @property
    def serving(self) -> ServingFactors:
        if self._serving is None:
            self._serving = ServingFactors(
                self.arrays.user_factors, self.arrays.item_factors,
                device=self._device, mesh=self._serving_mesh,
            )
        return self._serving

    def recommend(self, user: str, num: int) -> PredictedResult:
        [(_, result)] = self.recommend_many([(0, Query(user, num))])
        return result

    def recommend_many(self, queries) -> List[Tuple[int, PredictedResult]]:
        """Top-N for a batch of indexed queries: one K3 launch, or, on a
        quantized deployment, one retriever batch (kernels A and B).
        Unknown users get an empty result; the top-k width is the batch's
        largest ``num`` on the pow2 ladder (min 16, clamped to the
        catalog)."""
        known = [
            (qx, self.user_index[q.user], q.num)
            for qx, q in queries
            if q.user in self.user_index
        ]
        unknown = [
            (qx, PredictedResult())
            for qx, q in queries
            if q.user not in self.user_index
        ]
        if not known:
            return unknown
        max_num = pow2_topk_width(
            max(n for _, _, n in known), len(self.item_index)
        )
        users = [u for _, u, _ in known]
        retriever = self._retriever
        if retriever is not None:
            scores, idx = retriever.topn(
                self.arrays.user_factors[np.asarray(users, np.int64)], max_num
            )
        else:
            scores, idx = self.serving.topn_by_user(users, max_num)
        # the inverse index is catalog-sized: built once, not per request
        if self._inv_item is None:
            self._inv_item = self.item_index.inverse()
        inv_item = self._inv_item
        out = list(unknown)
        for row, (qx, _, num) in enumerate(known):
            item_scores = tuple(
                ItemScore(item=inv_item[int(idx[row, j])], score=float(scores[row, j]))
                for j in range(min(num, max_num))
            )
            out.append((qx, PredictedResult(item_scores=item_scores)))
        return out


def als_model_from_numpy(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    user_ids: Sequence[str],
    item_ids: Sequence[str],
    params: Optional[ALSAlgorithmParams] = None,
) -> ALSModel:
    """An ALSModel from a trained model's arrays: ``user_ids[r]`` is the id
    of factor row ``r`` (likewise items). For a model trained by the JAX
    package: ``model.arrays.user_factors``/``.item_factors`` and the ids
    of ``user_index``/``item_index`` in row order."""
    uf = np.asarray(user_factors, np.float32)
    itf = np.asarray(item_factors, np.float32)
    if uf.ndim != 2 or itf.ndim != 2 or uf.shape[1] != itf.shape[1]:
        raise ValueError(
            f"factor shapes {uf.shape} and {itf.shape} are not [U,k] and [I,k]"
        )
    if len(user_ids) != uf.shape[0] or len(item_ids) != itf.shape[0]:
        raise ValueError(
            f"{len(user_ids)} user ids for {uf.shape[0]} rows, "
            f"{len(item_ids)} item ids for {itf.shape[0]} rows"
        )
    return ALSModel(
        arrays=ALSModelArrays(user_factors=uf, item_factors=itf),
        user_index=BiMap({str(u): r for r, u in enumerate(user_ids)}),
        item_index=BiMap({str(i): r for r, i in enumerate(item_ids)}),
        params=params,
    )


class ALSAlgorithm(BaseAlgorithm):
    """ALS training and serving (replaces MLlib ALS.train, reference
    ALSAlgorithm.scala:66-105)."""

    params_class = ALSAlgorithmParams
    query_class = Query
    MESH_SERVING = True
    MESH_TRAINING = True
    # regularizer variants of one configuration train together in an
    # evaluation's grid (ops/als.py train_als_grid)
    GRID_AXES = ("lambda_",)

    @classmethod
    def train_grid(
        cls, device: Union[DeviceLike, Mesh], pd: PreparedData, algos
    ) -> Optional[List[ALSModel]]:
        """The variants ``algos`` trained together on ``device``, or on a
        ``Mesh`` (K13s), one model each, in order; None when they differ
        beyond ``lambda_``, checkpoint, or use the subspace solver (the
        reference's :457-488)."""
        base: ALSAlgorithmParams = algos[0].params
        for a in algos:
            p: ALSAlgorithmParams = a.params
            if dataclasses.replace(p, lambda_=0.0) != dataclasses.replace(base, lambda_=0.0):
                return None  # they differ beyond the regularizer
            if p.checkpoint_dir is not None:
                return None  # checkpoint state is per run, not per grid
            if p.solver != "exact":
                return None  # the blocked solver trains per variant
        td = pd.td
        config = ALSConfig(
            rank=base.rank,
            iterations=base.num_iterations,
            reg=0.0,  # the variants' regularizers travel in the grid axis
            alpha=base.alpha,
            implicit_prefs=base.implicit_prefs,
            seed=base.seed if base.seed is not None else 0,
        )
        mesh, device = split_target(device)
        arrays_list = train_als_grid(
            td.user_idx, td.item_idx, td.ratings,
            n_users=len(td.user_index), n_items=len(td.item_index),
            config=config, regs=[a.params.lambda_ for a in algos], device=device,
            mesh=mesh,
        )
        dev = resolve_device(device) if mesh is None else mesh.devices[0]
        return [
            ALSModel(arrays=arrays, user_index=td.user_index, item_index=td.item_index,
                     params=a.params, _device=dev)
            for arrays, a in zip(arrays_list, algos)
        ]

    def train(self, device: Union[DeviceLike, Mesh], pd: PreparedData) -> ALSModel:
        """Train on ``device`` (CUDA unless the CPU is asked for): training
        data that streams (``StreamingTrainingData``) goes through
        ``ops/streaming.train_als_streaming`` (a round that folds a delta
        into its pack cache trains ``delta_sweeps`` warm sweeps), the rest,
        and a stream that comes up empty, through ``ops/als.train_als``. On
        a ``Mesh`` of several shards the columns go to ``train_als``'s mesh
        route (a stream is read whole first, as the reference trains a
        stream only without a mesh, its :509-515); a mesh of one shard is
        its device. The model serves on ``device`` (a mesh's first device)
        until ``prepare_serving`` moves it."""
        td = pd.td
        p: ALSAlgorithmParams = self.params
        config = ALSConfig(
            rank=p.rank,
            iterations=p.num_iterations,
            reg=p.lambda_,
            alpha=p.alpha,
            implicit_prefs=p.implicit_prefs,
            seed=p.seed if p.seed is not None else 0,
            solver=p.solver,
            block_size=p.block_size,
        )
        mesh, device = split_target(device)
        dev = resolve_device(device) if mesh is None else mesh.devices[0]
        stream_factory = getattr(td, "stream_factory", None)
        if stream_factory is not None and mesh is None:
            result = train_als_streaming(
                stream_factory(), config, device=device,
                checkpoint_dir=p.checkpoint_dir,
                checkpoint_every=p.checkpoint_every,
                warm_sweeps=p.delta_sweeps,
            )
            if result is not None:
                return ALSModel(
                    arrays=result.arrays, user_index=result.user_index,
                    item_index=result.item_index, params=p, _device=dev,
                )
            # empty scan: the materialized path below owns the error
            # reporting (TrainingData.sanity_check)
            td.materialize().sanity_check()
        arrays = train_als(
            td.user_idx,
            td.item_idx,
            td.ratings,
            n_users=len(td.user_index),
            n_items=len(td.item_index),
            config=config,
            device=device,
            mesh=mesh,
            checkpoint_dir=p.checkpoint_dir,
            checkpoint_every=p.checkpoint_every,
        )
        return ALSModel(
            arrays=arrays, user_index=td.user_index,
            item_index=td.item_index, params=p, _device=dev,
        )

    def prepare_serving(
        self, device: Union[torch.device, Mesh], model: ALSModel
    ) -> ALSModel:
        """Bind the model's serving state to ``device``, or to a ``Mesh``
        (the reference's :549-566): float32 then serves data-parallel
        through ``ServingFactors(mesh)`` (K3s). With a quantized
        ``precision``, deploy an ItemRetriever: the catalog resides as
        int8/bf16 rows (row-sharded over the mesh) and retrieval runs the
        two-stage shortlist + exact rescore."""
        if isinstance(device, Mesh):
            model.attach_serving_mesh(device)
        else:
            model.attach_device(device)
        p: ALSAlgorithmParams = self.params
        if p.precision != "float32":
            model._retriever = ItemRetriever(
                model.arrays.item_factors,
                mesh=model._serving_mesh,
                component="recommendation",
                device=model._device,
                precision=p.precision,
                shortlist_mult=p.shortlist_mult,
            )
        return model

    def serving_precision(self, model: ALSModel) -> Optional[str]:
        if model._retriever is not None:
            return model._retriever.precision
        if model._serving is not None:
            return "float32"
        return None

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        return model.recommend(query.user, query.num)

    def batch_predict(self, model: ALSModel, queries) -> List[Tuple[int, PredictedResult]]:
        return model.recommend_many(queries)

    def release_serving(self, model: ALSModel) -> None:
        """Drop the device factors (and free the retriever, every shard);
        they free once the last in-flight batch lets go. A straggler query
        rebuilds float32 serving state lazily, off the mesh, on the model's
        device (a mesh's first device)."""
        model._serving = None
        model._serving_mesh = None
        retriever, model._retriever = model._retriever, None
        if retriever is not None:
            retriever.free()

    def warm(self, model: ALSModel) -> None:
        """Run every top-k tier up to warm_num and every padded batch size
        up to warm_max_batch once, before the server takes traffic. A
        quantized deployment warms the retriever's ladder instead."""
        p: ALSAlgorithmParams = self.params
        if model._retriever is not None:
            model._retriever.warm(
                n=p.warm_num, max_batch=p.warm_max_batch,
                flag_combos=((False, False),),
                exclude_widths=(1,),
            )
            return
        n = 16
        while True:
            model.serving.warm(n=n, max_batch=p.warm_max_batch)
            if n >= min(p.warm_num, len(model.item_index)):
                break
            n *= 2

    def result_to_json(self, result: PredictedResult):
        # reference wire format (Engine.scala PredictedResult(itemScores))
        return {
            "itemScores": [
                {"item": s.item, "score": s.score}
                for s in result.item_scores
            ]
        }


class Serving(FirstServing):
    """First-algorithm serving (reference Serving.scala)."""


def recommendation_engine() -> Engine:
    return Engine(
        data_source_classes=DataSource,
        preparator_classes=Preparator,
        algorithm_classes={"als": ALSAlgorithm},
        serving_classes=Serving,
    )
