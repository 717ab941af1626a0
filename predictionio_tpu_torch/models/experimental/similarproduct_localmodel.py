"""Similar Product with an explicitly LOCAL (host-memory) model: the
counterpart of ``predictionio_tpu/models/experimental/similarproduct_localmodel.py``.

Reference mapping (examples/experimental/
scala-parallel-similarproduct-localmodel/): the similarproduct template
with the algorithm flipped from PAlgorithm to P2LAlgorithm: the trained
``productFeatures`` are ``collectAsMap``-ed into a plain in-process
``Map[Int, Array[Double]]`` and predict walks it with a PriorityQueue
(ALSAlgorithm.scala:25-42, 117-118, predict). The example teaches the
L-vs-P model split: a local model serves without a cluster.

``ALSLocalAlgorithm`` trains through the port's Similar Product
``ALSAlgorithm`` on the card (implicit ALS: K1, K2 and K12), then keeps the
item factors as a plain ``dict[int, np.ndarray]`` and scores queries with
host numpy cosines: no device state and nothing to warm. The port's
Similar Product engine has no ``DataSource`` yet (it reads the event
store, ROADMAP.md queue 1 item 3), so neither has this one: its
algorithm trains on the template's ``PreparedData``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import numpy as np

from predictionio_tpu_torch.controller import EngineFactory, FirstServing
from predictionio_tpu_torch.controller.engine import Engine
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.device import DeviceLike
from predictionio_tpu_torch.models.similarproduct.engine import (  # noqa: F401
    ALSAlgorithm,
    ALSAlgorithmParams,
    Item,
    ItemScore,
    PredictedResult,
    PreparedData,
    Preparator,
    Query,
    TrainingData,
)


@dataclasses.dataclass
class ALSLocalModel:
    """Reference ALSLocalModel (ALSAlgorithm.scala:25-42): a plain
    in-memory map of item -> feature vector plus the id maps."""

    product_features: Dict[int, np.ndarray]
    item_index: BiMap
    items: Dict[int, Item]


class ALSLocalAlgorithm(ALSAlgorithm):
    """Train with the Similar Product template's implicit ALS on the card,
    then materialize the model as host dictionaries (the reference's
    ``collectAsMap``, ALSAlgorithm.scala:117-118); predict is numpy cosine
    scoring, query by query."""

    def train(self, device: DeviceLike, pd: PreparedData) -> ALSLocalModel:
        device_model = super().train(device, pd)
        return ALSLocalModel(
            product_features={
                j: np.asarray(device_model.item_factors[j])
                for j in range(device_model.item_factors.shape[0])
            },
            item_index=device_model.item_index,
            items=device_model.items,
        )

    def prepare_serving(self, device, model: ALSLocalModel) -> ALSLocalModel:
        """Nothing to place: the local model never touches the device."""
        return model

    def warm(self, model: ALSLocalModel) -> None:
        """Nothing to build or load before traffic."""

    def serving_precision(self, model: ALSLocalModel) -> Optional[str]:
        return None

    def release_serving(self, model: ALSLocalModel) -> None:
        """No device state to free."""

    def batch_predict(self, model: ALSLocalModel, queries):
        return [(i, self.predict(model, q)) for i, q in queries]

    def predict(self, model: ALSLocalModel, query: Query) -> PredictedResult:
        # query items -> feature vectors (missing ids skipped, reference
        # predict's flatten over Option)
        q_feats = [
            model.product_features[model.item_index[i]]
            for i in query.items
            if i in model.item_index
            and model.item_index[i] in model.product_features
        ]
        if not q_feats:
            return PredictedResult(item_scores=())

        def as_set(ids) -> Optional[Set[int]]:
            if ids is None:
                return None
            return {
                model.item_index[i] for i in ids if i in model.item_index
            }

        white = as_set(query.white_list)
        black = as_set(query.black_list) or set()
        black |= {
            model.item_index[i] for i in query.items if i in model.item_index
        }
        cats = set(query.categories) if query.categories else None

        def cosine(a: np.ndarray, b: np.ndarray) -> float:
            na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
            if na == 0.0 or nb == 0.0:
                return 0.0
            return float(np.dot(a, b)) / (na * nb)

        scores: List[ItemScore] = []
        inverse = model.item_index.inverse()
        for j, feat in model.product_features.items():
            if white is not None and j not in white:
                continue
            if j in black:
                continue
            if cats is not None:
                item = model.items.get(j)
                if item is None or not cats.intersection(item.categories):
                    continue
            s = sum(cosine(qf, feat) for qf in q_feats)
            if s > 0:
                scores.append(ItemScore(item=inverse[j], score=s))
        scores.sort(key=lambda x: -x.score)
        return PredictedResult(item_scores=tuple(scores[: query.num]))


def similarproduct_localmodel_engine() -> Engine:
    return Engine(
        preparator_classes=Preparator,
        algorithm_classes={"als": ALSLocalAlgorithm},
        serving_classes=FirstServing,
    )


class SimilarProductLocalModelEngineFactory(EngineFactory):
    def apply(self) -> Engine:
        return similarproduct_localmodel_engine()
