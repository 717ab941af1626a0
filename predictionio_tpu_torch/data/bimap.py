"""BiMap: bidirectional id <-> dense-index mapping.

The port's copy of ``predictionio_tpu/data/bimap.py`` (reference
data/src/main/scala/io/prediction/data/storage/BiMap.scala:93-164): the
bridge between string entity ids on the host and the dense row indices
of the factor matrices on the device.
"""

from __future__ import annotations

from typing import Dict, Generic, Iterable, Iterator, List, Mapping, Optional, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class BiMap(Generic[K, V]):
    """Immutable bidirectional map. Values must be unique."""

    __slots__ = ("_forward", "_inverse")

    def __init__(self, forward: Mapping[K, V], _inverse: Optional[Dict[V, K]] = None):
        fwd = dict(forward)
        if _inverse is None:
            inv: Dict[V, K] = {}
            for k, v in fwd.items():
                if v in inv:
                    raise ValueError(f"BiMap values must be unique; duplicate {v!r}")
                inv[v] = k
        else:
            inv = _inverse
        self._forward = fwd
        self._inverse = inv

    def __getitem__(self, key: K) -> V:
        return self._forward[key]

    def get(self, key: K, default: Optional[V] = None) -> Optional[V]:
        return self._forward.get(key, default)

    def __contains__(self, key: K) -> bool:
        return key in self._forward

    def __len__(self) -> int:
        return len(self._forward)

    def __iter__(self) -> Iterator[K]:
        return iter(self._forward)

    def keys(self):
        return self._forward.keys()

    def values(self):
        return self._forward.values()

    def items(self):
        return self._forward.items()

    def inverse(self) -> "BiMap[V, K]":
        return BiMap(self._inverse, dict(self._forward))

    def to_dict(self) -> Dict[K, V]:
        return dict(self._forward)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, BiMap):
            return self._forward == other._forward
        return NotImplemented

    def __repr__(self) -> str:
        return f"BiMap({self._forward!r})"

    # --- constructors (reference BiMap object :93-164) ---

    @staticmethod
    def string_int(keys: Iterable[str]) -> "BiMap[str, int]":
        """Map distinct string keys to dense 0-based int indices, in sorted
        order for determinism (the reference uses RDD `.distinct.collect`
        ordering, which is unspecified; sorted is reproducible)."""
        distinct = sorted(set(keys))
        return BiMap({k: i for i, k in enumerate(distinct)})

    @staticmethod
    def string_long(keys: Iterable[str]) -> "BiMap[str, int]":
        return BiMap.string_int(keys)

    @staticmethod
    def int_index(keys: Iterable[K]) -> "BiMap[K, int]":
        """Dense index over arbitrary hashable keys, insertion-ordered."""
        out: Dict[K, int] = {}
        for k in keys:
            if k not in out:
                out[k] = len(out)
        return BiMap(out)

    def take(self, n: int) -> "BiMap[K, V]":
        out = {}
        for i, (k, v) in enumerate(self._forward.items()):
            if i >= n:
                break
            out[k] = v
        return BiMap(out)

    def map_values_to_list(self, keys: Iterable[K]) -> List[V]:
        fw = self._forward
        return [fw[k] for k in keys]
