"""Similar Product engine: the counterpart of
``predictionio_tpu/models/similarproduct/engine.py`` (reference
examples/scala-parallel-similarproduct/multi: Engine.scala,
Preparator.scala, ALSAlgorithm.scala, LikeAlgorithm.scala, Serving.scala).

Training: ``ALSAlgorithm.train`` runs implicit ALS (``ops/als.train_als``
with ``implicit_prefs=True``: K1 with implicit weights, K12's Gramian, K2
with ``+G``) over the deduplicated view counts per (user, item);
``LikeAlgorithm`` over like/dislike events, the latest per (user, item)
winning, like +1, dislike −1. The model keeps the item factors.

Serving. A query names items; the answer is the items most like them by
the sum of cosines of their ALS factors, under the query's candidacy rules
(the query items themselves and the ``black_list`` excluded,
``white_list`` ∩ the ``categories`` index as an inclusion list). A
prepared model serves every micro-batch through one ``ItemRetriever``
batch (``ops/retrieval.py``, cosine and ``positive_only``): the query
vector is the sum of the normalized query-item rows, and the rules are
on-device masks. Without a prepared retriever (a model just trained, or a
straggler after ``release_serving``) ``SPModel.similar`` scores on the
host path: K14 (``ops/similarity.py``) sums the cosines on the model's
device, and the rules and the selection run in numpy, as the reference's.
``Serving`` sums each item's scores across algorithms. ``prepare_serving``
takes a ``Mesh`` too: the retriever and the host path's scorer are then
row-sharded over it (K9s with the K9m merge, K14s).

Both ALS algorithms train with either solver: ``solver="subspace"`` (with
``block_size``) runs the iALS++ loop (K11, ``ops/subspace.py``).

The third algorithm, ``dimsum`` (``DIMSUMAlgorithm``, the reference's
experimental DIMSUM project), keeps the thresholded all-pairs item cosine
of the binary view matrix, computed on the device from the co-view counts
(K19, ``ops/cooccurrence.py``) and kept on the host as a ``DIMSUMModel``;
``predict`` sums the query items' rows and applies the candidacy rules in
numpy, as the reference does.

Queries, results, training data and params keep the reference's fields
and JSON names. A model crosses from the JAX package as arrays
(``sp_model_from_numpy``, ``dimsum_model_from_numpy``). Not ported yet:
the ``DataSource`` (it reads the event store, item 3).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    BaseAlgorithm,
    BasePreparator,
    BaseServing,
    Engine,
    Params,
    SanityCheck,
)
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops import cooccurrence, retrieval
from predictionio_tpu_torch.ops.als import ALSConfig, train_als, validate_solver
from predictionio_tpu_torch.ops.retrieval import ItemRetriever
from predictionio_tpu_torch.ops.similarity import SimilarityScorer, normalize_rows
from predictionio_tpu_torch.parallel.mesh import Mesh, split_target
from predictionio_tpu_torch.utils.shapes import pow2_topk_width

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Query:
    items: Tuple[str, ...]
    num: int = 10
    categories: Optional[Tuple[str, ...]] = None
    white_list: Optional[Tuple[str, ...]] = None
    black_list: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "items", tuple(self.items))
        for f in ("categories", "white_list", "black_list"):
            v = getattr(self, f)
            if v is not None:
                object.__setattr__(self, f, tuple(v))


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
class Item:
    categories: Tuple[str, ...] = ()


@dataclasses.dataclass
class ViewEvent:
    user: str
    item: str
    t: float


@dataclasses.dataclass
class LikeEvent:
    user: str
    item: str
    t: float
    like: bool  # like=True, dislike=False


@dataclasses.dataclass
class TrainingData(SanityCheck):
    users: Dict[str, dict]
    items: Dict[str, Item]
    view_events: List[ViewEvent]
    like_events: List[LikeEvent] = dataclasses.field(default_factory=list)

    def sanity_check(self) -> None:
        if not self.items:
            raise ValueError("items is empty — are item $set events present?")
        if not self.view_events and not self.like_events:
            raise ValueError("viewEvents is empty — are view events present?")


@dataclasses.dataclass
class PreparedData:
    td: TrainingData


class Preparator(BasePreparator):
    """Pass-through (reference Preparator.scala)."""

    def prepare(self, device, td: TrainingData) -> PreparedData:
        return PreparedData(td=td)


@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    """The reference's ALSAlgorithmParams, field for field, so an
    engine.json params block parses the same."""

    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    seed: Optional[int] = None
    warm_max_query_items: int = 16
    # deploy-time warm-up coverage for the retrieval kernels
    warm_num: int = 16
    warm_max_batch: int = 128
    # serving residency precision of the catalog: "float32" (exact, one
    # kernel pass), "bf16" or "int8" (two-stage shortlist + exact rescore)
    precision: str = "float32"
    # stage-1 shortlist width multiplier c (shortlist = pow2(c*n))
    shortlist_mult: int = 4
    # confidence scale of the implicit objective this engine always
    # trains (c = alpha*|r|, MLlib trainImplicit)
    alpha: float = 1.0
    # "exact", or the iALS++ "subspace" solver with its block_size
    solver: str = "exact"
    block_size: int = 0

    def __post_init__(self):
        validate_solver(self.solver, self.block_size, self.rank)


@dataclasses.dataclass
class SPModel:
    """Item factors, their ids and metadata, and the params they serve
    with. The retriever and the host path's scorer are device state, built
    on the model's device (the one it was trained or prepared on) and never
    saved."""

    item_factors: np.ndarray  # [n_items, k]
    item_index: BiMap
    items: Dict[int, Item]  # dense index -> metadata
    params: Optional[ALSAlgorithmParams] = None
    _device: Optional[torch.device] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _scorer: Optional[SimilarityScorer] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _inv_index: Optional[BiMap] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _retriever: Optional[ItemRetriever] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _normed_host: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _cat_items: Optional[Dict[str, np.ndarray]] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # the deploy-time mesh (prepare_serving): the retriever's and the host
    # path's scorer's rows shard over it; never saved
    _serving_mesh: Optional[Mesh] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def attach_device(self, device: DeviceLike) -> None:
        """Score on ``device`` (drops a scorer built elsewhere)."""
        self._device = resolve_device(device)
        self._serving_mesh = None
        self._scorer = None

    def attach_serving_mesh(self, mesh: Mesh) -> None:
        """Score over ``mesh`` (drops a scorer built elsewhere); the mesh's
        first device stays the model's device."""
        self._serving_mesh = mesh
        self._device = mesh.devices[0]
        self._scorer = None

    @property
    def normed_host(self) -> np.ndarray:
        if self._normed_host is None:
            self._normed_host = normalize_rows(self.item_factors)
        return self._normed_host

    @property
    def scorer(self) -> SimilarityScorer:
        """The host path's scorer: the normalized factors resident on the
        model's device (CUDA when none is attached), row-sharded over its
        serving mesh when it has one (K14s), built at first use."""
        if self._scorer is None:
            self._scorer = SimilarityScorer(
                self.item_factors, device=self._device, mesh=self._serving_mesh
            )
        return self._scorer

    def category_items(self, categories) -> np.ndarray:
        """Dense indices of items carrying one of the given categories."""
        if self._cat_items is None:
            self._cat_items = retrieval.build_category_index(self.items)
        return retrieval.category_candidates(self._cat_items, categories)

    @property
    def inv_index(self) -> BiMap:
        if self._inv_index is None:
            self._inv_index = self.item_index.inverse()
        return self._inv_index

    def _retrieval_spec(self, query: Query):
        """(query vector, exclusion idx, inclusion idx or None) for the
        retriever, or None when no query item has factors. The query
        vector is the sum of the normalized query-item rows; exclusions
        are the query items themselves plus the blackList; whiteList ∩
        category index becomes the inclusion list."""
        query_idx = [
            self.item_index[i] for i in query.items if i in self.item_index
        ]
        if not query_idx:
            return None
        qvec = self.normed_host[query_idx].sum(axis=0)
        excl = set(query_idx)
        for i in query.black_list or ():
            if i in self.item_index:
                excl.add(self.item_index[i])
        wl = retrieval.include_candidates(
            self.item_index, query.white_list, query.categories,
            self.category_items,
        )
        return qvec, np.asarray(sorted(excl), np.int64), wl

    def similar_batch(self, queries) -> List[Tuple[int, PredictedResult]]:
        """Every query of the micro-batch in ONE retriever batch (cosine,
        positive_only) over the resident factors (requires
        prepare_serving)."""
        out: List[Tuple[int, PredictedResult]] = []
        meta, rows, excludes, includes = [], [], [], []
        for qi, q in queries:
            spec = self._retrieval_spec(q)
            if spec is None:
                logger.info("no item factors for query items %s", q.items)
                out.append((qi, PredictedResult()))
                continue
            qvec, excl, incl = spec
            meta.append((qi, q))
            rows.append(qvec)
            excludes.append(excl)
            includes.append(incl)
        if not meta:
            return out
        n_req = pow2_topk_width(
            max(q.num for _, q in meta), self._retriever.n_items
        )
        scores, idx = self._retriever.topn(
            np.stack(rows).astype(np.float32),
            n_req,
            exclude=excludes,
            include=includes,
            positive_only=True,
            normalize=True,
        )
        inv = self.inv_index
        trimmed = retrieval.trimmed_results(
            scores, idx, [q.num for _, q in meta]
        )
        out += [
            (
                qi,
                PredictedResult(
                    item_scores=tuple(
                        ItemScore(item=inv[int(i)], score=float(s))
                        for i, s in zip(ids, ss)
                    )
                ),
            )
            for (qi, _), (ids, ss) in zip(meta, trimmed)
        ]
        return out

    def similar(self, query: Query) -> PredictedResult:
        """Reference ALSAlgorithm.predict for one query: through the
        prepared retriever when there is one, else the host path (K14's
        sum of cosines on the model's device, then the reference's rules
        and selection in numpy)."""
        if self._retriever is not None:
            [(_, result)] = self.similar_batch([(0, query)])
            return result
        query_idx = [
            self.item_index[i] for i in query.items if i in self.item_index
        ]
        if not query_idx:
            logger.info("no item factors for query items %s", query.items)
            return PredictedResult()
        scorer = self.scorer
        scores = scorer.cosine_sum(scorer.normed[query_idx])
        return rank_on_host(scores, query_idx, query, self)


def rank_on_host(scores: np.ndarray, query_idx, query: Query, model) -> PredictedResult:
    """The reference's candidacy rules and selection in numpy (the tail of
    its ALSAlgorithm and DIMSUMAlgorithm predict): positive ``scores``
    only, the query items and the ``black_list`` excluded, the
    ``white_list`` and ``categories`` as inclusion rules, then the top
    ``num`` by ``argpartition`` and ``argsort``. ``model`` gives the
    ``item_index``, ``inv_index`` and ``items``."""
    mask = scores > 0
    mask[query_idx] = False  # exclude the query items themselves
    if query.white_list is not None:
        wl = np.zeros_like(mask)
        wl[[
            model.item_index[i]
            for i in query.white_list
            if i in model.item_index
        ]] = True
        mask &= wl
    if query.black_list is not None:
        mask[[
            model.item_index[i]
            for i in query.black_list
            if i in model.item_index
        ]] = False
    if query.categories is not None:
        cats = set(query.categories)
        for idx in np.nonzero(mask)[0]:
            item = model.items.get(int(idx))
            if item is None or not cats.intersection(item.categories):
                mask[idx] = False

    scores = np.where(mask, scores, -np.inf)
    num = min(query.num, int(mask.sum()))
    if num <= 0:
        return PredictedResult()
    top = np.argpartition(-scores, num - 1)[:num]
    top = top[np.argsort(-scores[top])]
    inv = model.inv_index
    return PredictedResult(
        item_scores=tuple(
            ItemScore(item=inv[int(i)], score=float(scores[i]))
            for i in top
        )
    )


def sp_model_from_numpy(
    item_factors: np.ndarray,
    item_ids: Sequence[str],
    item_categories: Sequence[Sequence[str]],
    params: Optional[ALSAlgorithmParams] = None,
) -> SPModel:
    """An SPModel from a trained model's arrays: ``item_ids[r]`` is the id
    of factor row ``r`` and ``item_categories[r]`` its categories. For a
    model trained by the JAX package: ``model.item_factors``, the ids of
    ``item_index`` in row order, and ``model.items[r].categories``."""
    itf = np.asarray(item_factors, np.float32)
    if itf.ndim != 2:
        raise ValueError(f"item factors of shape {itf.shape} are not [I, k]")
    if len(item_ids) != itf.shape[0] or len(item_categories) != itf.shape[0]:
        raise ValueError(
            f"{len(item_ids)} item ids and {len(item_categories)} category "
            f"lists for {itf.shape[0]} rows"
        )
    return SPModel(
        item_factors=itf,
        item_index=BiMap({str(i): r for r, i in enumerate(item_ids)}),
        items={
            r: Item(categories=tuple(str(c) for c in cats))
            for r, cats in enumerate(item_categories)
        },
        params=params,
    )


class ALSAlgorithm(BaseAlgorithm):
    """Implicit ALS over deduplicated view counts, and similar-product
    serving of its item factors (reference ALSAlgorithm.scala: train is
    reduceByKey count -> ALS.trainImplicit; predict the sum of cosines)."""

    params_class = ALSAlgorithmParams
    query_class = Query
    MESH_SERVING = True
    MESH_TRAINING = True

    def _ratings(self, td: TrainingData) -> Dict[Tuple[str, str], float]:
        """(user, item) -> value. Overridden by LikeAlgorithm."""
        counts: Dict[Tuple[str, str], float] = {}
        for v in td.view_events:
            key = (v.user, v.item)
            counts[key] = counts.get(key, 0.0) + 1.0
        return counts

    def training_arrays(self, td: TrainingData):
        """(user_index, item_index, users, items, values): the indexes (items
        in sorted id order; users over the users, view and like events) and
        the int32 / int32 / float32 arrays of ``_ratings`` that ``train``
        gives ``train_als``."""
        item_index = BiMap.string_int(td.items.keys())
        user_index = BiMap.string_int(
            set(td.users.keys())
            | {v.user for v in td.view_events}
            | {e.user for e in td.like_events}
        )
        triples = [
            (user_index[u], item_index[i], val)
            for (u, i), val in self._ratings(td).items()
            if i in item_index
        ]
        if not triples:
            raise ValueError(
                "no valid (user, item) events after index mapping"
            )
        u, i, r = (np.asarray(x) for x in zip(*triples))
        return (user_index, item_index, u.astype(np.int32),
                i.astype(np.int32), r.astype(np.float32))

    def als_config(self) -> ALSConfig:
        """The implicit ``ALSConfig`` of these params."""
        p = self.params
        return ALSConfig(
            rank=p.rank,
            iterations=p.num_iterations,
            reg=p.lambda_,
            implicit_prefs=True,
            alpha=p.alpha,
            seed=p.seed if p.seed is not None else 0,
            solver=p.solver,
            block_size=p.block_size,
        )

    def train(self, device: Union[DeviceLike, Mesh], pd: PreparedData) -> SPModel:
        """Train on ``device`` (CUDA unless the CPU is asked for), or on a
        ``Mesh`` (the reference's :472; a mesh of one shard is its device):
        implicit ALS through ``ops/als.train_als`` over ``training_arrays``.
        The model scores on ``device`` (a mesh's first device) until
        ``prepare_serving`` moves it."""
        td = pd.td
        user_index, item_index, u, i, r = self.training_arrays(td)
        mesh, device = split_target(device)
        arrays = train_als(
            u, i, r,
            n_users=len(user_index),
            n_items=len(item_index),
            config=self.als_config(),
            device=device,
            mesh=mesh,
        )
        model = SPModel(
            item_factors=arrays.item_factors,
            item_index=item_index,
            items={item_index[i]: item for i, item in td.items.items()},
            params=self.params,
        )
        model.attach_device(device if mesh is None else mesh.devices[0])
        return model

    def predict(self, model: SPModel, query: Query) -> PredictedResult:
        return model.similar(query)

    def batch_predict(self, model: SPModel, queries):
        """With a prepared retriever, the whole micro-batch as ONE
        retriever batch (model.similar_batch); otherwise the host path, query
        by query."""
        if model._retriever is None:
            return [(i, self.predict(model, q)) for i, q in queries]
        return model.similar_batch(queries)

    def prepare_serving(self, device: Union[torch.device, Mesh], model: SPModel) -> SPModel:
        """Build the serving state: the item factors resident on
        ``device`` in the params' precision, or row-sharded over a ``Mesh``
        (the reference's :491-503; K9s and the K9m merge); candidacy rules
        apply as on-device masks. The host path scores there too."""
        if isinstance(device, Mesh):
            model.attach_serving_mesh(device)
        else:
            model.attach_device(device)
        model._retriever = ItemRetriever(
            model.item_factors, mesh=model._serving_mesh,
            component="similarproduct", device=model._device,
            precision=self.params.precision,
            shortlist_mult=self.params.shortlist_mult,
        )
        return model

    def serving_precision(self, model: SPModel) -> Optional[str]:
        if model._retriever is not None:
            return model._retriever.precision
        return None

    def release_serving(self, model: SPModel) -> None:
        """Null the model's references first (a straggler then scores on
        the host path, rebuilding its scorer), then free the retriever's
        device tensors."""
        retriever, model._retriever = model._retriever, None
        model._scorer = None
        if retriever is not None:
            retriever.free()

    def warm(self, model: SPModel) -> None:
        """Run the serving shapes once before traffic: the retriever's
        ladder for a prepared model, the host path's query widths up to
        ``warm_max_query_items`` otherwise."""
        if model._retriever is not None:
            model._retriever.warm(
                n=self.params.warm_num,
                max_batch=self.params.warm_max_batch,
                flag_combos=((True, True),),
            )
        else:
            model.scorer.warm(max_q=self.params.warm_max_query_items)

    def result_to_json(self, result: PredictedResult):
        return {
            "itemScores": [
                {"item": s.item, "score": s.score}
                for s in result.item_scores
            ]
        }


class LikeAlgorithm(ALSAlgorithm):
    """The multi variant's second algorithm (reference LikeAlgorithm.scala):
    like/dislike events, like +1, dislike −1, the LATEST event per (user,
    item) winning; the same implicit ALS (a dislike adds confidence and no
    preference) and cosine predict."""

    def _ratings(self, td: TrainingData) -> Dict[Tuple[str, str], float]:
        latest: Dict[Tuple[str, str], Tuple[float, float]] = {}
        for e in td.like_events:
            key = (e.user, e.item)
            value = 1.0 if e.like else -1.0
            if key not in latest or e.t >= latest[key][0]:
                latest[key] = (e.t, value)
        return {k: val for k, (_, val) in latest.items()}


@dataclasses.dataclass(frozen=True)
class DIMSUMAlgorithmParams(Params):
    threshold: float = 0.0


@dataclasses.dataclass
class DIMSUMModel:
    """The thresholded item-item cosine matrix (host numpy), the item ids
    and metadata, and the params it was trained with."""

    similarities: np.ndarray  # [n_items, n_items], zeroed under threshold
    item_index: BiMap
    items: Dict[int, Item]
    params: Optional[DIMSUMAlgorithmParams] = None
    _inv_index: Optional[BiMap] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def inv_index(self) -> BiMap:
        if self._inv_index is None:
            self._inv_index = self.item_index.inverse()
        return self._inv_index


def dimsum_model_from_numpy(
    similarities: np.ndarray,
    item_ids: Sequence[str],
    item_categories: Sequence[Sequence[str]],
    params: Optional[DIMSUMAlgorithmParams] = None,
) -> DIMSUMModel:
    """A DIMSUMModel from a trained model's arrays: ``item_ids[r]`` is the
    id of row and column ``r`` and ``item_categories[r]`` its categories.
    For a model trained by the JAX package: ``model.similarities``, the ids
    of ``item_index`` in row order, and ``model.items[r].categories``."""
    sims = np.asarray(similarities, np.float32)
    n = sims.shape[0] if sims.ndim == 2 else -1
    if sims.shape != (n, n):
        raise ValueError(f"similarities of shape {sims.shape} are not [I, I]")
    if len(item_ids) != n or len(item_categories) != n:
        raise ValueError(
            f"{len(item_ids)} item ids and {len(item_categories)} category "
            f"lists for {n} rows"
        )
    return DIMSUMModel(
        similarities=sims,
        item_index=BiMap({str(i): r for r, i in enumerate(item_ids)}),
        items={
            r: Item(categories=tuple(str(c) for c in cats))
            for r, cats in enumerate(item_categories)
        },
        params=params,
    )


class DIMSUMAlgorithm(BaseAlgorithm):
    """Item-item column similarity of the binary user x item view matrix
    (reference experimental scala-parallel-similarproduct-dimsum,
    DIMSUMAlgorithm.scala: RowMatrix.columnSimilarities(threshold)). As in
    the JAX package, the similarities are exact cosines and the threshold
    is a filter, not a sampling parameter; the port forms them from the
    co-view counts on the device (K19) instead of the dense product."""

    params_class = DIMSUMAlgorithmParams
    query_class = Query

    def view_arrays(self, td: TrainingData):
        """(item_index, users, items): the item index (sorted ids) and the
        int32 user / item indices of the views of catalog items (users over
        the users and the view events, as the reference indexes them)."""
        user_index = BiMap.string_int(
            set(td.users.keys()) | {v.user for v in td.view_events}
        )
        item_index = BiMap.string_int(td.items.keys())
        pairs = [
            (user_index[v.user], item_index[v.item])
            for v in td.view_events
            if v.item in item_index
        ]
        u = np.fromiter((p[0] for p in pairs), np.int32, len(pairs))
        i = np.fromiter((p[1] for p in pairs), np.int32, len(pairs))
        return item_index, u, i

    def train(self, device: DeviceLike, pd: PreparedData) -> DIMSUMModel:
        """The similarities on ``device`` (CUDA unless the CPU is asked
        for), copied to the host: the model is host numpy."""
        td = pd.td
        item_index, u, i = self.view_arrays(td)
        sims = cooccurrence.item_cosine(
            u, i, len(item_index), self.params.threshold, device=device
        )
        return DIMSUMModel(
            similarities=sims,
            item_index=item_index,
            items={item_index[i]: item for i, item in td.items.items()},
            params=self.params,
        )

    def predict(self, model: DIMSUMModel, query: Query) -> PredictedResult:
        """The reference's predict: the query items' rows summed, then the
        candidacy rules and the selection in numpy (``rank_on_host``)."""
        query_idx = [
            model.item_index[i] for i in query.items if i in model.item_index
        ]
        if not query_idx:
            return PredictedResult()
        scores = model.similarities[query_idx].sum(axis=0)
        return rank_on_host(scores, query_idx, query, model)

    result_to_json = ALSAlgorithm.result_to_json


class Serving(BaseServing):
    """Sums scores per item across algorithms (reference multi/Serving.scala
    combines the standard and like predictions by summed score)."""

    def serve(self, query: Query, predictions: Sequence[PredictedResult]) -> PredictedResult:
        combined: Dict[str, float] = {}
        for p in predictions:
            for s in p.item_scores:
                combined[s.item] = combined.get(s.item, 0.0) + s.score
        top = sorted(combined.items(), key=lambda kv: -kv[1])[: query.num]
        return PredictedResult(
            item_scores=tuple(
                ItemScore(item=i, score=sc) for i, sc in top
            )
        )


def similarproduct_engine() -> Engine:
    return Engine(
        algorithm_classes={
            "als": ALSAlgorithm,
            "likealgo": LikeAlgorithm,
            "dimsum": DIMSUMAlgorithm,
        },
        serving_classes=Serving,
    )
