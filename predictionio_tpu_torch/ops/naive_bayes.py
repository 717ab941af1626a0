"""K15, multinomial naive Bayes: the counterpart of
``predictionio_tpu/ops/naive_bayes.py`` (reference
examples/scala-parallel-classification/add-algorithm/src/main/scala/
NaiveBayesAlgorithm.scala:24-44, MLlib ``NaiveBayes.train(points, lambda)``):

  pi[c]       = log(n_c + lambda) - log(n + lambda * C)
  theta[c][j] = log(S[c][j] + lambda) - log(sum_j S[c][j] + lambda * F)

where S[c][j] is the sum of feature j over class-c points, and a query's
label is the class of the largest ``x·theta[c] + pi[c]``.

- ``naive_bayes_fit(features, label_idx, n_classes, lam)`` (K15a, the
  reference's ``_fit``): the class counts, the sums S as a segmented
  per-class sum (no matmul), ``pi`` and ``theta``;
- ``naive_bayes_scores(features, pi, theta)`` (K15b, ``_scores`` fused with
  ``predict_naive_bayes``'s ``jnp.argmax``): each row's class index, the
  first NaN if the row's scores hold one, else the first maximum, and,
  when asked, the scores.

Three forms of each kernel, one function:
- the hand-written CUDA kernels for Hopper, ``csrc/naive_bayes.cu`` (its
  header states the bound and the design: fixed summation orders, no float
  atomics, so a rerun gives the same bits);
- the plain PyTorch twins ``fit_plain`` (``bincount``, ``index_add_`` and
  the logs) and ``scores_plain`` with ``argmax_first_nan`` (the kernel's
  product and add order, so the scores match it bit for bit);
- the wrappers, which route CPU tensors to the twins and CUDA tensors to
  the kernels (launch or raise, no fallback). ``LAUNCHES`` counts what
  they ran.

``train_naive_bayes`` and ``predict_naive_bayes`` keep the reference's host
checks and signatures, plus an explicit ``device`` (CUDA unless the CPU is
asked for); a ``mesh`` raises (ROADMAP.md queue 1 item 11).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts

SOURCE = "naive_bayes.cu"

LAUNCHES = LaunchCounts(
    "naive_bayes_fit", "naive_bayes_scores",
    "naive_bayes_fit_plain", "naive_bayes_scores_plain",
)

# K15a's plan: rows per block at least, blocks at most, the partials'
# floats at most, one block's threads and shared floats
_FIT_ROWS = 512
_FIT_BLOCKS = 528
_FIT_PARTIAL_FLOATS = 1 << 24
_FIT_THREADS = 256
_FIT_SHARED_FLOATS = 11_264


@dataclasses.dataclass
class NaiveBayesModelArrays:
    """log class priors [C] and log feature likelihoods [C, F], and the
    device the model predicts on (None: CUDA)."""

    pi: np.ndarray
    theta: np.ndarray
    labels: np.ndarray  # [C] the class label values (e.g. 0.0, 1.0, 2.0)
    device: Optional[torch.device] = None

    @property
    def n_classes(self) -> int:
        return self.pi.shape[0]


class NaiveBayesFit(NamedTuple):
    counts: torch.Tensor  # [C] int32
    sums: torch.Tensor  # [C, F] float32
    pi: torch.Tensor  # [C] float32
    theta: torch.Tensor  # [C, F] float32


def fit_plain(
    features: torch.Tensor, label_idx: torch.Tensor, n_classes: int, lam: float
) -> NaiveBayesFit:
    """The plain twin of K15a: counts by ``bincount``, sums by
    ``index_add_``, then the reference's logs in float32."""
    C, F = n_classes, features.shape[1]
    valid = (label_idx >= 0) & (label_idx < C)
    y = label_idx[valid].long()
    counts = torch.bincount(y, minlength=C).to(torch.int32)
    sums = torch.zeros((C, F), dtype=torch.float32, device=features.device)
    sums.index_add_(0, y, features[valid])
    lam_t = torch.tensor(lam, dtype=torch.float32, device=features.device)
    n = counts.sum().to(torch.float32)
    pi = torch.log(counts.to(torch.float32) + lam_t) - torch.log(n + lam_t * C)
    theta = torch.log(sums + lam_t) - torch.log(sums.sum(1, keepdim=True) + lam_t * F)
    return NaiveBayesFit(counts, sums, pi, theta)


def argmax_first_nan(scores: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` over each row of ``scores`` [B, C] as int32: the
    first NaN's index if the row holds one, else the first maximum's
    (torch's ``argmax`` documents no NaN order, so the rule is written
    out)."""
    C = scores.shape[1]
    idx = torch.arange(C, device=scores.device)
    nan = torch.isnan(scores)
    first_nan = torch.where(nan, idx, C).amin(1)
    filled = torch.where(nan, torch.full_like(scores, -float("inf")), scores)
    top = filled.amax(1, keepdim=True)
    first_max = torch.where(filled == top, idx, C).amin(1)
    return torch.where(first_nan < C, first_nan, first_max).to(torch.int32)


def scores_plain(features: torch.Tensor, pi: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """The plain twin of K15b's scores [B, C]: ``X·θᵀ + π`` summed in
    feature order with each product and add rounded on its own, as the
    kernel sums."""
    acc = torch.zeros((features.shape[0], theta.shape[0]), dtype=torch.float32,
                      device=features.device)
    for f in range(features.shape[1]):
        acc = acc + features[:, f:f + 1] * theta[None, :, f]
    return acc + pi[None, :]


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.naive_bayes_fit_f32.argtypes = [p, p, i64, i, i, f32, i, i64, i, i, i] + [p] * 7
    lib.naive_bayes_fit_f32.restype = ctypes.c_int
    lib.naive_bayes_scores_f32.argtypes = [p, p, p, i, i, i, p, p, p]
    lib.naive_bayes_scores_f32.restype = ctypes.c_int


_LIBRARY = native.Library(SOURCE, _declare, "naive_bayes_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return _LIBRARY.get()


def fit_plan(n: int, n_classes: int, n_features: int) -> Tuple[int, int, int, int, int]:
    """K15a's launch plan (nblk, rows_per_block, Ft, L, Ct): blocks of at
    least ``_FIT_ROWS`` rows (fewer blocks where the partials would pass
    ``_FIT_PARTIAL_FLOATS``), F tiles of at most 32 columns, L lanes of Ft
    threads, and class tiles whose lane partials fit the block's shared
    memory. A function of the shape alone, so the sums' order (and bits)
    does not depend on the card."""
    C, F = n_classes, n_features
    nblk = max(1, min(-(-n // _FIT_ROWS), _FIT_BLOCKS, _FIT_PARTIAL_FLOATS // (C * F)))
    rows = -(-n // nblk)
    nblk = -(-n // rows)
    Ft = min(F, 32)
    L = _FIT_THREADS // Ft
    Ct = min(C, _FIT_SHARED_FLOATS // (L * Ft))
    return nblk, rows, Ft, L, Ct


def naive_bayes_fit(
    features: torch.Tensor, label_idx: torch.Tensor, n_classes: int, lam: float
) -> NaiveBayesFit:
    """K15a: the class counts, per-class feature sums, ``pi`` and ``theta``
    of ``features`` [n, F] float32 under ``label_idx`` [n] int32 (an index
    outside [0, n_classes) counts nowhere, as the reference's padding rows).

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    if features.dim() != 2 or features.dtype != torch.float32:
        raise ValueError(f"features must be [n, F] float32, got {tuple(features.shape)} "
                         f"{features.dtype}")
    n, F = features.shape
    if label_idx.dtype != torch.int32 or tuple(label_idx.shape) != (n,):
        raise ValueError(f"label_idx must be [{n}] int32")
    if n < 1 or F < 1 or n_classes < 1:
        raise ValueError("naive_bayes_fit needs n, F and n_classes >= 1")
    if label_idx.device != features.device:
        raise ValueError("features and label_idx must be on one device")
    if features.device.type == "cpu":
        LAUNCHES.add("naive_bayes_fit_plain")
        return fit_plain(features, label_idx, n_classes, lam)
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    if not (features.is_contiguous() and label_idx.is_contiguous()):
        raise ValueError("features and label_idx must be contiguous")
    C, dev = n_classes, features.device
    nblk, rows, Ft, L, Ct = fit_plan(n, C, F)
    lib = load_library()
    part = torch.empty((nblk, C, F), dtype=torch.float32, device=dev)
    cpart = torch.empty((nblk, C), dtype=torch.int32, device=dev)
    out = NaiveBayesFit(
        torch.empty(C, dtype=torch.int32, device=dev),
        torch.empty((C, F), dtype=torch.float32, device=dev),
        torch.empty(C, dtype=torch.float32, device=dev),
        torch.empty((C, F), dtype=torch.float32, device=dev),
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.naive_bayes_fit_f32(
            features.data_ptr(), label_idx.data_ptr(), n, F, C, float(lam), nblk, rows,
            Ft, L, Ct, part.data_ptr(), cpart.data_ptr(), out.counts.data_ptr(),
            out.sums.data_ptr(), out.pi.data_ptr(), out.theta.data_ptr(), stream,
        )
    _LIBRARY.check(err, "naive_bayes_fit")
    LAUNCHES.add("naive_bayes_fit")
    return out


def naive_bayes_scores(
    features: torch.Tensor, pi: torch.Tensor, theta: torch.Tensor, with_scores: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K15b: (the int32 class index of each row of ``features`` [B, F]
    float32 under ``pi`` [C] and ``theta`` [C, F], and, if
    ``with_scores``, the scores [B, C], else None).

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    if features.dim() != 2 or theta.dim() != 2 or pi.dim() != 1:
        raise ValueError("features must be [B, F], theta [C, F] and pi [C]")
    B, F = features.shape
    C = theta.shape[0]
    if theta.shape[1] != F or pi.shape[0] != C or C < 1 or F < 1:
        raise ValueError(f"shapes disagree: features {tuple(features.shape)}, "
                         f"theta {tuple(theta.shape)}, pi {tuple(pi.shape)}")
    if any(t.dtype != torch.float32 for t in (features, pi, theta)):
        raise ValueError("features, pi and theta must be float32")
    if not (features.device == pi.device == theta.device):
        raise ValueError("features, pi and theta must be on one device")
    if features.device.type == "cpu":
        LAUNCHES.add("naive_bayes_scores_plain")
        scores = scores_plain(features, pi, theta)
        return argmax_first_nan(scores), (scores if with_scores else None)
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    if not (features.is_contiguous() and pi.is_contiguous() and theta.is_contiguous()):
        raise ValueError("features, pi and theta must be contiguous")
    dev = features.device
    idx = torch.empty(B, dtype=torch.int32, device=dev)
    scores = torch.empty((B, C), dtype=torch.float32, device=dev) if with_scores else None
    if B == 0:
        return idx, scores
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.naive_bayes_scores_f32(
            features.data_ptr(), pi.data_ptr(), theta.data_ptr(), B, C, F,
            None if scores is None else scores.data_ptr(), idx.data_ptr(), stream,
        )
    _LIBRARY.check(err, "naive_bayes_scores")
    LAUNCHES.add("naive_bayes_scores")
    return idx, scores


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a mesh is not supported: the port runs naive Bayes on one device "
            "(multi-GPU is ROADMAP.md queue 1 item 11)"
        )


def train_naive_bayes(
    features: np.ndarray,
    labels: np.ndarray,
    lam: float = 1.0,
    mesh=None,
    axis: str = "data",
    device: DeviceLike = None,
) -> NaiveBayesModelArrays:
    """Train on [n, F] nonnegative features with arbitrary scalar labels,
    on ``device`` (CUDA unless the CPU is asked for): the reference's host
    checks, ``np.unique`` over the labels, then K15a."""
    _no_mesh(mesh)
    dev = resolve_device(device)
    features = np.asarray(features, np.float32)
    labels = np.asarray(labels)
    if features.ndim != 2 or len(features) != len(labels):
        raise ValueError("features must be [n, F] aligned with labels [n]")
    if len(labels) == 0:
        raise ValueError("cannot train on an empty dataset")
    if (features < 0).any():
        raise ValueError("multinomial NB requires nonnegative features")
    classes, label_idx = np.unique(labels, return_inverse=True)
    fit = naive_bayes_fit(
        torch.tensor(features, device=dev),
        torch.tensor(label_idx.astype(np.int32).reshape(-1), device=dev),
        len(classes), lam,
    )
    return NaiveBayesModelArrays(
        pi=fit.pi.cpu().numpy(), theta=fit.theta.cpu().numpy(), labels=classes, device=dev
    )


def predict_naive_bayes(
    model: NaiveBayesModelArrays,
    features: np.ndarray,
    mesh=None,
    axis: str = "data",
    device: DeviceLike = None,
) -> np.ndarray:
    """Predicted label for each row of [B, F] (one K15b launch), on
    ``device``, else the model's device, else CUDA."""
    _no_mesh(mesh)
    dev = resolve_device(device if device is not None else model.device)
    features = np.atleast_2d(np.asarray(features, np.float32))
    idx, _ = naive_bayes_scores(
        torch.tensor(features, device=dev),
        torch.tensor(np.asarray(model.pi, np.float32), device=dev),
        torch.tensor(np.asarray(model.theta, np.float32), device=dev),
    )
    return model.labels[idx.cpu().numpy()]
