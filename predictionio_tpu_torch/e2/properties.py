"""(property, value) -> binary feature vectors: the port's copy of
``predictionio_tpu/e2/properties.py``, on the port's ``BiMap``.

Capability parity with the reference PropertiesToBinary
(e2/src/main/scala/io/prediction/e2/engine/PropertiesToBinary.scala:24-52):
build an index over every distinct (property, value) pair seen in the
input (restricted to a whitelist of property names), then encode a
property map as a binary vector with 1.0 at each present pair's index.

The encoder returns dense float32 matrices (a batch encodes as one [n, F]
array, ready for ``torch.from_numpy``) plus a sparse-indices view for
parity with the reference's SparseVector output.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Sequence, Set, Tuple

import numpy as np

from predictionio_tpu_torch.data.bimap import BiMap


class PropertiesToBinary:
    def __init__(self, property_map: Mapping[Tuple[str, str], int]):
        self.property_map = BiMap(dict(property_map))

    @property
    def num_features(self) -> int:
        return len(self.property_map)

    @classmethod
    def fit(
        cls,
        input_maps: Iterable[Mapping[str, str]],
        properties: Set[str],
    ) -> "PropertiesToBinary":
        """Index all distinct whitelisted (property, value) pairs
        (reference object PropertiesToBinary.apply :44-52). Pair order is
        first-seen, deterministic for a given input order."""
        seen: Dict[Tuple[str, str], int] = {}
        for m in input_maps:
            for k, v in m.items():
                if k in properties and (k, v) not in seen:
                    seen[(k, v)] = len(seen)
        return cls(seen)

    def indices(self, pairs: Sequence[Tuple[str, str]]) -> List[int]:
        """Sparse view: indices set to 1 (reference toBinary's SparseVector)."""
        return sorted(
            idx
            for pair in pairs
            if (idx := self.property_map.get(pair)) is not None
        )

    def to_binary(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        """Dense binary vector [num_features]."""
        out = np.zeros(self.num_features, np.float32)
        out[self.indices(pairs)] = 1.0
        return out

    def to_binary_batch(
        self, maps: Sequence[Mapping[str, str]]
    ) -> np.ndarray:
        """Dense [n, num_features] batch."""
        out = np.zeros((len(maps), self.num_features), np.float32)
        for i, m in enumerate(maps):
            out[i, self.indices(list(m.items()))] = 1.0
        return out
