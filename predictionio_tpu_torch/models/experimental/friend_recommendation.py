"""Friend-recommendation example engines: the counterpart of
``predictionio_tpu/models/experimental/friend_recommendation.py``
(keyword similarity, random baseline, and graph SimRank).

Covers both reference experimental projects in one module:

* **scala-local-friend-recommendation** (KDD-2012 SNS data):
  - DataSource reads the item / user-keyword / user-action files
    (FriendRecommendationDataSource.scala:14-114, same line formats)
  - KeywordSimilarityAlgorithm: sparse dot of keyword weight maps, fixed
    weight 1.0 and threshold 1.0 (KeywordSimilarityAlgorithm.scala:14-66)
  - RandomAlgorithm: uniform confidence vs a 0.5 threshold
    (RandomAlgorithm.scala:12-24)
  - Query(user, item) -> Prediction(confidence, acceptance)
  All of it host code, copied.

* **scala-parallel-friend-recommendation** (SimRank):
  - DataSource variants default / node-sampling / forest-fire-sampling
    over an edge-list file (DataSource.scala:19-81, Sampling.scala), host
    numpy on the same ``default_rng(seed)`` calls as the JAX package, so
    the same edges come out
  - SimRankAlgorithm (SimRankAlgorithm.scala:14-42 + DeltaSimRankRDD.scala):
    the fixpoint S' = decay · P S Pᵀ (diagonal pinned to 1), which the JAX
    package runs as dense [n, n] products; here P is a CSR and each
    iteration two hand-written kernels (K20a, K20b, ``ops/simrank.py``).
    The model is the [n, n] score matrix on the host, as in the reference.
  - ``simrank_model_from_numpy`` carries a JAX-trained model's scores
    across; ``utils/serialize.save_model`` writes a model as engine
    ``"simrank"`` and ``tools.cli deploy`` serves ``{"item1", "item2"}``
    queries from it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np


from predictionio_tpu_torch.controller import (
    BaseAlgorithm,
    BaseDataSource,
    EngineFactory,
    FirstServing,
    Params,
)
from predictionio_tpu_torch.controller.engine import Engine
from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops import simrank as k20

logger = logging.getLogger(__name__)


# --- local friend recommendation (keyword similarity / random) ---


@dataclasses.dataclass(frozen=True)
class Query:
    """KDD-2012 scenario: given (user, item=candidate friend), predict
    acceptance."""

    user: int
    item: int


@dataclasses.dataclass(frozen=True)
class Prediction:
    confidence: float
    acceptance: bool


@dataclasses.dataclass
class TrainingData:
    user_id_map: Dict[int, int]  # external -> internal
    item_id_map: Dict[int, int]
    user_keyword: List[Dict[int, float]]  # internal id -> {keyword: weight}
    item_keyword: List[Dict[int, float]]
    social_action: List[List[Tuple[int, int]]]  # adjacency with weights


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    item_file_path: str = ""
    user_keyword_file_path: str = ""
    user_action_file_path: str = ""


class FriendRecommendationDataSource(BaseDataSource):
    """SNS file reader (FriendRecommendationDataSource.scala:14-114)."""

    params_class = DataSourceParams

    def read_training(self, ctx) -> TrainingData:
        p = self.params
        item_id_map, item_keyword = self._read_item(p.item_file_path)
        user_id_map, user_keyword = self._read_user(p.user_keyword_file_path)
        social = self._read_relationship(
            p.user_action_file_path, len(user_keyword), user_id_map
        )
        return TrainingData(
            user_id_map=user_id_map,
            item_id_map=item_id_map,
            user_keyword=user_keyword,
            item_keyword=item_keyword,
            social_action=social,
        )

    @staticmethod
    def _read_item(path):
        # "<id> <category> kw;kw;kw" — keywords weighted 1.0 (:30-51)
        id_map: Dict[int, int] = {}
        keywords: List[Dict[int, float]] = []
        with open(path) as f:
            for line in f:
                data = line.split()
                if not data:
                    continue
                id_map[int(data[0])] = len(keywords)
                keywords.append(
                    {int(t): 1.0 for t in data[2].split(";") if t}
                )
        return id_map, keywords

    @staticmethod
    def _read_user(path):
        # "<id> kw:weight;kw:weight" (:53-77)
        id_map: Dict[int, int] = {}
        keywords: List[Dict[int, float]] = []
        with open(path) as f:
            for line in f:
                data = line.split()
                if not data:
                    continue
                id_map[int(data[0])] = len(keywords)
                kw: Dict[int, float] = {}
                for term_weight in data[1].split(";"):
                    if term_weight:
                        term, weight = term_weight.split(":")
                        kw[int(term)] = float(weight)
                keywords.append(kw)
        return id_map, keywords

    @staticmethod
    def _read_relationship(path, n_users, user_id_map):
        # "<src> <dst> a b c" — weight = a+b+c (:79-103)
        adj: List[List[Tuple[int, int]]] = [[] for _ in range(n_users)]
        with open(path) as f:
            for line in f:
                data = [int(s) for s in line.split()]
                if not data:
                    continue
                if data[0] in user_id_map and data[1] in user_id_map:
                    adj[user_id_map[data[0]]].append(
                        (user_id_map[data[1]], sum(data[2:5]))
                    )
        return adj


@dataclasses.dataclass(frozen=True)
class AlgoParams(Params):
    pass


@dataclasses.dataclass
class KeywordSimilarityModel:
    td: TrainingData
    keyword_sim_weight: float = 1.0
    keyword_sim_threshold: float = 1.0


def keyword_similarity(
    kw1: Dict[int, float], kw2: Dict[int, float]
) -> float:
    """Sparse dot over the smaller map (KeywordSimilarityAlgorithm.scala:
    38-45). Host-side by design: keyword maps are tiny, data-dependent
    sparse dicts and the serving path is single-pair lookups — no batched
    device shape to exploit."""
    if len(kw2) < len(kw1):
        kw1, kw2 = kw2, kw1
    return sum(w * kw2.get(t, 0.0) for t, w in kw1.items())


class KeywordSimilarityAlgorithm(BaseAlgorithm):
    params_class = AlgoParams
    query_class = Query

    def train(self, device: DeviceLike, td: TrainingData) -> KeywordSimilarityModel:
        return KeywordSimilarityModel(td=td)

    def predict(self, model: KeywordSimilarityModel, query: Query) -> Prediction:
        td = model.td
        if query.user in td.user_id_map and query.item in td.item_id_map:
            confidence = keyword_similarity(
                td.user_keyword[td.user_id_map[query.user]],
                td.item_keyword[td.item_id_map[query.item]],
            )
        else:
            # unseen users/items score 0 (reference :50-63)
            confidence = 0.0
        acceptance = (
            confidence * model.keyword_sim_weight
            >= model.keyword_sim_threshold
        )
        return Prediction(confidence=confidence, acceptance=acceptance)


@dataclasses.dataclass(frozen=True)
class RandomAlgoParams(Params):
    seed: Optional[int] = None


@dataclasses.dataclass
class RandomModel:
    random_threshold: float = 0.5


class RandomAlgorithm(BaseAlgorithm):
    """Coin-flip baseline (RandomAlgorithm.scala:12-24), seedable for
    reproducible evaluation runs."""

    params_class = RandomAlgoParams
    query_class = Query

    def train(self, device: DeviceLike, td: TrainingData) -> RandomModel:
        return RandomModel(0.5)

    def predict(self, model: RandomModel, query: Query) -> Prediction:
        rng = (
            np.random.default_rng(
                None if self.params.seed is None
                else (self.params.seed, query.user, query.item)
            )
        )
        confidence = float(rng.random())
        return Prediction(
            confidence=confidence,
            acceptance=confidence >= model.random_threshold,
        )


def keyword_similarity_engine() -> Engine:
    return Engine(
        data_source_classes=FriendRecommendationDataSource,
        algorithm_classes={
            "KeywordSimilarityAlgorithm": KeywordSimilarityAlgorithm
        },
        serving_classes=FirstServing,
    )


class KeywordSimilarityEngineFactory(EngineFactory):
    def apply(self) -> Engine:
        return keyword_similarity_engine()


def random_engine() -> Engine:
    return Engine(
        data_source_classes=FriendRecommendationDataSource,
        algorithm_classes={"RandomAlgorithm": RandomAlgorithm},
        serving_classes=FirstServing,
    )


class RandomEngineFactory(EngineFactory):
    def apply(self) -> Engine:
        return random_engine()


# --- parallel friend recommendation (SimRank) ---


@dataclasses.dataclass(frozen=True)
class SimRankQuery:
    item1: int
    item2: int


@dataclasses.dataclass
class GraphTrainingData:
    n_vertices: int
    edges: np.ndarray  # [m, 2] int32 (src, dst), normalized to 0..n-1


@dataclasses.dataclass(frozen=True)
class SimRankDataSourceParams(Params):
    graph_edgelist_path: str = ""


def _load_edges(path) -> GraphTrainingData:
    """Edge-list file -> graph. Vertex ids are used as-is and must be
    dense in 0..n-1 — the reference makes the same assumption
    (DataSource.scala:34-36: "each of the n vertices should have vertexID
    in the range 0 to n-1"; its normalizeGraph is commented out there
    too), and queries address vertices by these same ids."""
    pairs = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2 and not parts[0].startswith("#"):
                pairs.append((int(parts[0]), int(parts[1])))
    edges = np.asarray(pairs, np.int32).reshape(len(pairs), 2)
    n = int(edges.max()) + 1 if len(pairs) else 0
    return GraphTrainingData(n_vertices=n, edges=edges)


class SimRankDataSource(BaseDataSource):
    params_class = SimRankDataSourceParams

    def read_training(self, ctx) -> GraphTrainingData:
        return _load_edges(self.params.graph_edgelist_path)


@dataclasses.dataclass(frozen=True)
class NodeSamplingDSParams(Params):
    graph_edgelist_path: str = ""
    sample_fraction: float = 1.0
    seed: int = 11


class NodeSamplingDataSource(BaseDataSource):
    """Uniform vertex sample + induced subgraph (Sampling.scala
    nodeSampling)."""

    params_class = NodeSamplingDSParams

    def read_training(self, ctx) -> GraphTrainingData:
        td = _load_edges(self.params.graph_edgelist_path)
        rng = np.random.default_rng(self.params.seed)
        n_keep = int(td.n_vertices * self.params.sample_fraction)
        keep = set(
            rng.choice(td.n_vertices, size=n_keep, replace=False).tolist()
        )
        mask = np.array(
            [s in keep and d in keep for s, d in td.edges], bool
        )
        # keep vertex ids stable (scores stay addressable); sampled-out
        # vertices simply lose their edges
        return GraphTrainingData(
            n_vertices=td.n_vertices, edges=td.edges[mask]
        )


@dataclasses.dataclass(frozen=True)
class ForestFireDSParams(Params):
    graph_edgelist_path: str = ""
    sample_fraction: float = 1.0
    geo_param: float = 0.7
    seed: int = 11


class ForestFireSamplingDataSource(BaseDataSource):
    """Forest-fire burn sampling with geometric branching (Sampling.scala
    forestFireSamplingInduced: burn queue, geometricSample(geoParam)
    neighbors per step, induced edges)."""

    params_class = ForestFireDSParams

    def read_training(self, ctx) -> GraphTrainingData:
        td = _load_edges(self.params.graph_edgelist_path)
        rng = np.random.default_rng(self.params.seed)
        target = int(td.n_vertices * self.params.sample_fraction)
        out_adj: List[List[int]] = [[] for _ in range(td.n_vertices)]
        for s, d in td.edges:
            out_adj[s].append(int(d))
        sampled: set = set()
        queue: List[int] = []
        order = rng.permutation(td.n_vertices)
        seed_iter = iter(order.tolist())
        while len(sampled) < target:
            try:
                seed_v = next(seed_iter)
            except StopIteration:
                break
            if seed_v in sampled:
                continue
            sampled.add(seed_v)
            queue.append(seed_v)
            while queue and len(sampled) < target:
                v = queue.pop(0)
                n_burn = 1
                while rng.random() <= self.params.geo_param:
                    n_burn += 1
                candidates = [d for d in out_adj[v] if d not in sampled]
                rng.shuffle(candidates)
                for d in candidates[:n_burn]:
                    sampled.add(d)
                    queue.append(d)
        mask = np.array(
            [s in sampled and d in sampled for s, d in td.edges], bool
        )
        return GraphTrainingData(
            n_vertices=td.n_vertices, edges=td.edges[mask]
        )


@dataclasses.dataclass(frozen=True)
class SimRankParams(Params):
    num_iterations: int = 5
    decay: float = 0.8


@dataclasses.dataclass
class SimRankModel:
    scores: np.ndarray  # [n, n] similarity matrix


class SimRankAlgorithm(BaseAlgorithm):
    """SimRank on the device (replaces DeltaSimRankRDD.compute).

    The reference propagates score deltas from a pair (a, b) to every
    out-neighbor pair, weighted decay / (out(x)·out(y)), i.e. the fixpoint
    S(x, y) = decay/(|O(x)||O(y)|) · Σ_{a∈O(x), b∈O(y)} S(a, b) with
    S(x, x) = 1. With P the out-degree-normalised adjacency this is
    S' = decay · P S Pᵀ, diagonal re-pinned: here P's CSR is built on the
    host and uploaded once, and each iteration is K20a (``U = P S``) then
    K20b (``decay · U Pᵀ``, diagonal 1), ``ops/simrank.py``."""

    params_class = SimRankParams
    query_class = SimRankQuery

    def train(self, device: DeviceLike, td: GraphTrainingData) -> SimRankModel:
        """The [n, n] scores on ``device`` (CUDA unless the CPU is asked
        for), fetched to the host in one copy, as the reference keeps them."""
        dev = resolve_device(device)
        csr = k20.place_csr(*k20.build_transition_csr(td.edges, td.n_vertices), dev)
        S = k20.simrank(csr, self.params.num_iterations, self.params.decay)
        return SimRankModel(scores=S.cpu().numpy())

    def predict(self, model: SimRankModel, query: SimRankQuery) -> float:
        return float(model.scores[query.item1, query.item2])


def simrank_model_from_numpy(scores: np.ndarray) -> SimRankModel:
    """A SimRankModel from a trained model's [n, n] scores (for a model
    trained by the JAX package: its ``scores``)."""
    s = np.asarray(scores, np.float32)
    if s.ndim != 2 or s.shape[0] != s.shape[1]:
        raise ValueError(f"SimRank scores of shape {s.shape} are not [n, n]")
    return SimRankModel(scores=s)


def simrank_engine() -> Engine:
    return Engine(
        data_source_classes={
            "default": SimRankDataSource,
            "node": NodeSamplingDataSource,
            "forest": ForestFireSamplingDataSource,
        },
        algorithm_classes={"simrank": SimRankAlgorithm},
        serving_classes=FirstServing,
    )


class PSimRankEngineFactory(EngineFactory):
    def apply(self) -> Engine:
        return simrank_engine()
