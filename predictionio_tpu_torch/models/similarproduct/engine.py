"""Similar Product engine, the serving subset: the counterpart of
``predictionio_tpu/models/similarproduct/engine.py`` (reference
examples/scala-parallel-similarproduct/multi: Engine.scala,
ALSAlgorithm.scala predict, LikeAlgorithm.scala, Serving.scala).

A query names items; the answer is the items most like them by the sum of
cosines of their ALS factors, under the query's candidacy rules (the query
items themselves and the ``black_list`` excluded, ``white_list`` ∩ the
``categories`` index as an inclusion list). A prepared model serves every
micro-batch through one ``ItemRetriever`` batch (``ops/retrieval.py``,
cosine and ``positive_only``): the query vector is the sum of the
normalized query-item rows, and the rules are on-device masks. ``Serving``
sums each item's scores across algorithms.

Queries, results and params keep the reference's fields and JSON names.
A model crosses from the JAX package as arrays (``sp_model_from_numpy``).
Not ported yet, each raising ``NotImplementedError``: training (implicit
ALS, ROADMAP queue 1 item 6), scoring without a prepared retriever (the
host cosine-sum path, K14, item 6) and the ``dimsum`` algorithm (K19,
item 6).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    BaseAlgorithm,
    BaseServing,
    Engine,
    Params,
)
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.ops import retrieval
from predictionio_tpu_torch.ops.als import validate_solver
from predictionio_tpu_torch.ops.retrieval import ItemRetriever
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
    alpha: float = 1.0
    solver: str = "exact"
    block_size: int = 0

    def __post_init__(self):
        validate_solver(self.solver, self.block_size, self.rank)


def normalize_rows(factors: np.ndarray) -> np.ndarray:
    """L2-normalize rows; zero rows stay zero (cosine with a zero vector
    is 0 in the reference's cosine helper). A copy of
    ``predictionio_tpu/ops/similarity.py:54``, keeping its dtype."""
    f = np.asarray(factors, np.float32)
    norms = np.linalg.norm(f, axis=1, keepdims=True)
    return np.where(norms > 0, f / np.where(norms == 0, 1, norms), 0.0)


@dataclasses.dataclass
class SPModel:
    """Item factors, their ids and metadata, and the params they serve
    with. The retriever is device state, built by ``prepare_serving`` and
    never saved."""

    item_factors: np.ndarray  # [n_items, k]
    item_index: BiMap
    items: Dict[int, Item]  # dense index -> metadata
    params: Optional[ALSAlgorithmParams] = None
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

    @property
    def normed_host(self) -> np.ndarray:
        if self._normed_host is None:
            self._normed_host = normalize_rows(self.item_factors)
        return self._normed_host

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
        """Reference ALSAlgorithm.predict for one query, through the
        prepared retriever."""
        if self._retriever is None:
            raise NotImplementedError(
                "similar product scoring without a prepared retriever (the "
                "host cosine-sum path, K14) is not ported yet (ROADMAP.md "
                "queue 1 item 6); call prepare_serving first"
            )
        [(_, result)] = self.similar_batch([(0, query)])
        return result


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
    """Similar-product serving of ALS item factors (reference
    ALSAlgorithm.scala predict). Training, implicit ALS over view counts,
    is not ported yet."""

    params_class = ALSAlgorithmParams
    query_class = Query

    def train(self, device, pd) -> SPModel:
        raise NotImplementedError(
            "similar product training (implicit ALS) is not ported yet "
            "(ROADMAP.md queue 1 item 6); carry a trained model across with "
            "sp_model_from_numpy"
        )

    def predict(self, model: SPModel, query: Query) -> PredictedResult:
        return model.similar(query)

    def batch_predict(self, model: SPModel, queries):
        """The whole micro-batch as ONE retriever batch
        (model.similar_batch)."""
        if model._retriever is None:
            return [(i, self.predict(model, q)) for i, q in queries]
        return model.similar_batch(queries)

    def prepare_serving(self, device: torch.device, model: SPModel) -> SPModel:
        """Build the serving state: the item factors resident on
        ``device`` in the params' precision; candidacy rules apply as
        on-device masks."""
        model._retriever = ItemRetriever(
            model.item_factors, component="similarproduct", device=device,
            precision=self.params.precision,
            shortlist_mult=self.params.shortlist_mult,
        )
        return model

    def serving_precision(self, model: SPModel) -> Optional[str]:
        if model._retriever is not None:
            return model._retriever.precision
        return None

    def release_serving(self, model: SPModel) -> None:
        """Null the model's reference, then free the retriever's device
        tensors."""
        retriever, model._retriever = model._retriever, None
        if retriever is not None:
            retriever.free()

    def warm(self, model: SPModel) -> None:
        """Run the retriever's serving shapes once before traffic."""
        if model._retriever is not None:
            model._retriever.warm(
                n=self.params.warm_num,
                max_batch=self.params.warm_max_batch,
                flag_combos=((True, True),),
            )

    def result_to_json(self, result: PredictedResult):
        return {
            "itemScores": [
                {"item": s.item, "score": s.score}
                for s in result.item_scores
            ]
        }


class LikeAlgorithm(ALSAlgorithm):
    """The multi variant's second algorithm (reference LikeAlgorithm.scala):
    the same serving over factors trained from like/dislike events (latest
    event per user and item wins, like +1, dislike -1); its training waits
    with ALSAlgorithm's."""


class DIMSUMAlgorithm(BaseAlgorithm):
    """The DIMSUM item-item cosine algorithm (reference experimental
    scala-parallel-similarproduct-dimsum): not ported yet."""

    def __init__(self, params: Optional[Params] = None):
        raise NotImplementedError(
            "the dimsum algorithm (K19, the all-pairs cosine Rn·Rnᵀ) is not "
            "ported yet (ROADMAP.md queue 1 item 6)"
        )


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
