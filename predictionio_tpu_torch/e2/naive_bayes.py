"""Naive Bayes with string-categorical features: the counterpart of
``predictionio_tpu/e2/naive_bayes.py`` (reference
e2/src/main/scala/io/prediction/e2/engine/CategoricalNaiveBayes.scala:23-151).

``CategoricalNaiveBayes.train`` encodes labels and per-slot feature values
(``BiMap``, sorted) on the host, counts the flat (slot, label, value) keys
on the device (K17a, ``ops/categorical_nb.cnb_count``: int32, exact) and
turns the counts into log priors log(n_label / n_total) and log likelihoods
log(count(label, slot, value) / n_label) with the reference's numpy code.
``predict_batch`` scores a batch and takes each row's first maximum on the
device (K17b, ``cnb_scores_argmax``); ``log_score`` is host code with the
reference's pluggable default for unseen values.

The model carries the device it predicts on (None: CUDA) and keeps one
device copy of its likelihoods per device, never pickled.
``categorical_nb_model_from_numpy`` builds a model from a trained model's
arrays (a JAX-trained one included). On a 1-D ``data`` mesh of several
shards ``train`` shards the count only (K17s, ``cnb_count_mesh``): the
encoding stays on the host, as in the reference, and the model, one
device's bit for bit, predicts on the mesh's first device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops import categorical_nb
from predictionio_tpu_torch.parallel.mesh import check_data_axis, collapse_mesh

NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class LabeledPoint:
    """A labeled categorical data point (reference LabeledPoint)."""

    label: str
    features: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "features", tuple(self.features))


@dataclasses.dataclass
class CategoricalNaiveBayesModel:
    """Trained model. ``priors``/``likelihoods`` expose the reference's
    map-shaped view; scoring runs on the dense tensors."""

    label_index: BiMap  # label -> l
    value_indexes: Tuple[BiMap, ...]  # per slot: value -> v
    log_priors: np.ndarray  # [L]
    log_likelihoods: np.ndarray  # [L, S, V] (NEG_INF where unseen)
    device: Optional[torch.device] = None  # where predict_batch runs (None: CUDA)
    # (device, log_likelihoods, log_priors) placed once; device state, never pickled
    _placed: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_placed"] = None
        return state

    @property
    def feature_count(self) -> int:
        return self.log_likelihoods.shape[1]

    @property
    def priors(self) -> Dict[str, float]:
        return {label: float(self.log_priors[l]) for label, l in self.label_index.items()}

    @property
    def likelihoods(self) -> Dict[str, List[Dict[str, float]]]:
        out: Dict[str, List[Dict[str, float]]] = {}
        for label, l in self.label_index.items():
            out[label] = [
                {
                    value: float(self.log_likelihoods[l, s, v])
                    for value, v in self.value_indexes[s].items()
                    if self.log_likelihoods[l, s, v] != NEG_INF
                }
                for s in range(self.feature_count)
            ]
        return out

    def log_score(
        self,
        point: LabeledPoint,
        default_likelihood: Callable[[Sequence[float]], float] = lambda ls: NEG_INF,
    ) -> Optional[float]:
        """Log score of (label, features); None when the label is unknown
        (reference logScore :96-115)."""
        if point.label not in self.label_index:
            return None
        self._check_feature_count(point.features)
        l = self.label_index[point.label]
        total = float(self.log_priors[l])
        for s, feature in enumerate(point.features):
            v = self.value_indexes[s].get(feature)
            ll = self.log_likelihoods[l, s, v] if v is not None else NEG_INF
            if ll == NEG_INF:
                present = self.log_likelihoods[l, s]
                ll = default_likelihood([float(x) for x in present[present != NEG_INF]])
            total += ll
        return total

    def _check_feature_count(self, features: Sequence[str]) -> None:
        if len(features) != self.feature_count:
            raise ValueError(
                f"query has {len(features)} feature(s); model was trained "
                f"with {self.feature_count}"
            )

    def predict(self, features: Sequence[str]) -> str:
        """Label with the highest score (reference predict :122-133)."""
        return self.predict_batch([tuple(features)])[0]

    def encode(self, features_batch: Sequence[Sequence[str]]) -> Tuple[np.ndarray, np.ndarray]:
        """(codes [N, S] int32, known [N, S] bool) of a batch: each value's
        index in its slot's ``BiMap``, known False (code 0) where unseen."""
        n, S = len(features_batch), self.feature_count
        for features in features_batch:
            self._check_feature_count(features)
        enc = np.zeros((n, S), np.int32)
        known = np.zeros((n, S), bool)
        for s in range(S):
            vi = self.value_indexes[s]
            codes = [vi.get(features[s]) for features in features_batch]
            known[:, s] = [c is not None for c in codes]
            enc[:, s] = [0 if c is None else c for c in codes]
        return enc, known

    def predict_batch(self, features_batch: Sequence[Sequence[str]]) -> List[str]:
        """Vectorized prediction: one K17b launch (score and first maximum)
        for the whole batch, on the model's device (None: CUDA)."""
        dev = resolve_device(self.device)
        enc, known = self.encode(features_batch)
        ll, prior = self._device_arrays(dev)
        best, _ = categorical_nb.cnb_scores_argmax(
            ll, prior, torch.from_numpy(enc).to(dev), torch.from_numpy(known).to(dev)
        )
        inv = self.label_index.inverse()
        return [inv[int(b)] for b in best.cpu().numpy()]

    def _device_arrays(self, dev: torch.device):
        """The likelihoods and priors on ``dev``, placed once per device."""
        if self._placed is not None and self._placed[0] == dev:
            return self._placed[1], self._placed[2]
        ll = torch.from_numpy(np.ascontiguousarray(self.log_likelihoods, np.float32)).to(dev)
        prior = torch.from_numpy(np.ascontiguousarray(self.log_priors, np.float32)).to(dev)
        self._placed = (dev, ll, prior)
        return ll, prior


class CategoricalNaiveBayes:
    """Trainer (reference object CategoricalNaiveBayes :29-80)."""

    @staticmethod
    def train(
        points: Sequence[LabeledPoint],
        mesh=None,
        axis: str = "data",
        device: DeviceLike = None,
    ) -> CategoricalNaiveBayesModel:
        """Train on ``device`` (CUDA unless the CPU is asked for): the
        reference's host checks and encoding, one K17a launch over the flat
        keys (K17s over a 1-D ``data`` ``mesh`` of several shards), then the
        reference's logs. The model predicts on the same device (the mesh's
        first)."""
        check_data_axis(axis)
        mesh, device = collapse_mesh(mesh, device)
        dev = resolve_device(device) if mesh is None else mesh.devices[0]
        if not points:
            raise ValueError("cannot train on an empty dataset")
        S = len(points[0].features)
        for p in points:
            if len(p.features) != S:
                raise ValueError("all points must have the same number of features")

        n = len(points)
        label_index = BiMap.string_int([p.label for p in points])
        value_indexes = tuple(
            BiMap.string_int([p.features[s] for p in points]) for s in range(S)
        )
        L = len(label_index)
        V = max((len(vi) for vi in value_indexes), default=1)
        labels = np.fromiter((label_index[p.label] for p in points), np.int64, count=n)
        # flattened keys (s * L + l) * V + v, slot by slot, as the reference
        # lays them out
        flat_keys = np.empty(n * S, np.int64)
        for s in range(S):
            vi = value_indexes[s]
            values = np.fromiter((vi[p.features[s]] for p in points), np.int64, count=n)
            flat_keys[s * n:(s + 1) * n] = (s * L + labels) * V + values
        n_keys = S * L * V
        keys = flat_keys.astype(np.int32)
        if mesh is None:
            counts = categorical_nb.cnb_count(torch.from_numpy(keys).to(dev), n_keys)
        else:
            counts = categorical_nb.cnb_count_mesh(keys, n_keys, mesh)
        counts = counts.cpu().numpy().reshape(S, L, V)

        label_counts = np.bincount(labels, minlength=L).astype(np.float64)
        log_priors = np.log(label_counts / n).astype(np.float32)
        with np.errstate(divide="ignore"):
            log_likelihoods = np.where(
                counts > 0,
                np.log(counts / label_counts[None, :, None]),
                NEG_INF,
            ).transpose(1, 0, 2).astype(np.float32)  # [L, S, V]
        return CategoricalNaiveBayesModel(
            label_index=label_index,
            value_indexes=value_indexes,
            log_priors=log_priors,
            log_likelihoods=log_likelihoods,
            device=dev,
        )


def categorical_nb_model_from_numpy(
    labels: Sequence[str],
    values_per_slot: Sequence[Sequence[str]],
    log_priors: np.ndarray,
    log_likelihoods: np.ndarray,
    device: DeviceLike = None,
) -> CategoricalNaiveBayesModel:
    """A model from a trained model's arrays: the labels in index order,
    each slot's values in index order, ``log_priors`` [L] and
    ``log_likelihoods`` [L, S, V]; it predicts on ``device`` (CUDA unless
    the CPU is asked for)."""
    log_priors = np.asarray(log_priors, np.float32)
    log_likelihoods = np.asarray(log_likelihoods, np.float32)
    L = len(labels)
    S = len(values_per_slot)
    if log_priors.shape != (L,) or log_likelihoods.ndim != 3 or log_likelihoods.shape[:2] != (L, S):
        raise ValueError(
            f"{L} labels and {S} slots disagree with log_priors {log_priors.shape} "
            f"and log_likelihoods {log_likelihoods.shape}"
        )
    if any(len(vals) > log_likelihoods.shape[2] for vals in values_per_slot):
        raise ValueError(f"a slot has more values than V = {log_likelihoods.shape[2]}")
    return CategoricalNaiveBayesModel(
        label_index=BiMap({label: l for l, label in enumerate(labels)}),
        value_indexes=tuple(
            BiMap({value: v for v, value in enumerate(vals)}) for vals in values_per_slot
        ),
        log_priors=log_priors,
        log_likelihoods=log_likelihoods,
        device=resolve_device(device),
    )
