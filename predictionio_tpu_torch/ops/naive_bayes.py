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
  when asked, the scores; ``naive_bayes_scores_table`` the same over a
  shard table (``ScoresShard``: a row range of a device's upload and its
  blocks of one result), one launch per table.

Three forms of each kernel, one function:
- the hand-written CUDA kernels for Hopper, ``csrc/naive_bayes.cu`` (its
  header states the bound and the design: fixed summation orders, no float
  atomics, so a rerun gives the same bits);
- the plain PyTorch twins ``fit_plain`` (K15a's two passes:
  ``fit_partial_plain``, each block's per-class sums by ``index_add_`` in
  row order, and ``fit_finish_plain``, the blocks added in block order, then
  the logs) and ``scores_plain`` with ``argmax_first_nan`` (the kernel's
  product and add order, so the scores match it bit for bit);
- the wrappers, which route CPU tensors to the twins and CUDA tensors to
  the kernels (launch or raise, no fallback). ``LAUNCHES`` counts what
  they ran.

``train_naive_bayes`` and ``predict_naive_bayes`` keep the reference's host
checks and signatures, plus an explicit ``device`` (CUDA unless the CPU is
asked for).

K15a's kernel takes a shard table (per shard its rows and the index of its
first block in the partials) and runs both passes in one cooperative launch
of at most as many blocks as the card holds at once (``fit_capacity``, the
occupancy query); a fit with more work items than that (a wide feature
set) walks several a block, in the same order, so every shape is one
launch with the same bits. ``LAUNCHES`` counts a fit as one
``naive_bayes_fit``, a pass 1 alone (a device other than the result's) as
one ``naive_bayes_fit_shard``.

K15s, the two programs on a 1-D ``data`` mesh (the reference's :103-121 and
:144-151; ``parallel/mesh.py``): ``naive_bayes_fit_shards`` cuts the rows
at the whole-n plan's blocks (``fit_shard_bounds``) and runs one launch on
the first device over all of that device's shards; a shard on another
device runs pass 1 (one launch per distinct device) into partials there,
copied into the first device's before its launch. So the model is one
device's bit for bit whatever the shard count; ``predict_naive_bayes(mesh=)``
uploads each distinct device's shards' rows once and scores them in one
launch over that device's shard table, into their blocks of one [B] result
on the first device, fetched once. A mesh of one shard collapses to its
device.

Serving places a model's ``pi`` and ``theta`` once per device (``placed``:
``train_naive_bayes`` keeps its fit's, ``NaiveBayesAlgorithm.prepare_serving``
places them on the serving device) in the model's ``_placed``, serving
state that ``save_model`` and the persistent models never write; a batch
then uploads only its rows. ``PLACEMENTS`` counts the placements.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
from array import array
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts
from predictionio_tpu_torch.parallel.mesh import (
    check_data_axis,
    collapse_mesh,
    cut_rows,
    split_rows,
)

SOURCE = "naive_bayes.cu"

# K15a: "naive_bayes_fit" a fit (both passes, one launch),
# "naive_bayes_fit_shard" a launch of pass 1 alone (a device's other than
# the result's); K15s's score shards count as "naive_bayes_scores"
LAUNCHES = LaunchCounts(
    "naive_bayes_fit", "naive_bayes_scores",
    "naive_bayes_fit_plain", "naive_bayes_scores_plain",
    "naive_bayes_fit_shard",
)

# K15a's plan: rows per block at least, blocks at most, the partials'
# floats at most, one block's threads and shared floats
_FIT_ROWS = 512
_FIT_BLOCKS = 528
_FIT_PARTIAL_FLOATS = 1 << 24
_FIT_THREADS = 256
_FIT_SHARED_FLOATS = 11_264
MAX_SHARDS = 64  # a shard table's most shards (the kernels' parameter tables)


@dataclasses.dataclass
class NaiveBayesModelArrays:
    """log class priors [C] and log feature likelihoods [C, F], and the
    device the model predicts on (None: CUDA)."""

    pi: np.ndarray
    theta: np.ndarray
    labels: np.ndarray  # [C] the class label values (e.g. 0.0, 1.0, 2.0)
    device: Optional[torch.device] = None
    # serving state, never saved: {device: (pi, theta) placed there}
    _placed: Optional[Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]]] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_placed"] = None
        return state

    @property
    def n_classes(self) -> int:
        return self.pi.shape[0]


class NaiveBayesFit(NamedTuple):
    counts: torch.Tensor  # [C] int32
    sums: torch.Tensor  # [C, F] float32
    pi: torch.Tensor  # [C] float32
    theta: torch.Tensor  # [C, F] float32


def fit_partial_plain(
    features: torch.Tensor, label_idx: torch.Tensor, n_classes: int, rows_per_block: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of K15a's pass 1: for each block of ``rows_per_block``
    rows (block b holds rows b·rows_per_block..), the per-class sums
    [nblk, C, F] float32, each added by ``index_add_`` in row order, and the
    class counts [nblk, C] int32. A label outside [0, C) counts nowhere."""
    n, F = features.shape
    C, dev = n_classes, features.device
    nblk = -(-n // rows_per_block)
    valid = (label_idx >= 0) & (label_idx < C)
    block = torch.arange(n, device=dev) // rows_per_block
    key = (block * C + label_idx.long())[valid]
    part = torch.zeros((nblk * C, F), dtype=torch.float32, device=dev)
    part.index_add_(0, key, features[valid])
    cpart = torch.bincount(key, minlength=nblk * C).to(torch.int32)
    return part.view(nblk, C, F), cpart.view(nblk, C)


def fit_finish_plain(part: torch.Tensor, cpart: torch.Tensor, lam: float) -> NaiveBayesFit:
    """The plain twin of K15a's pass 2: the blocks' partials added in block
    order, the counts, then the reference's logs in float32."""
    _, C, F = part.shape
    sums = torch.zeros((C, F), dtype=torch.float32, device=part.device)
    for b in range(part.shape[0]):
        sums = sums + part[b]
    counts = cpart.sum(0, dtype=torch.int64).to(torch.int32)
    lam_t = torch.tensor(lam, dtype=torch.float32, device=part.device)
    n = counts.sum().to(torch.float32)
    pi = torch.log(counts.to(torch.float32) + lam_t) - torch.log(n + lam_t * C)
    theta = torch.log(sums + lam_t) - torch.log(sums.sum(1, keepdim=True) + lam_t * F)
    return NaiveBayesFit(counts, sums, pi, theta)


def fit_plain(
    features: torch.Tensor, label_idx: torch.Tensor, n_classes: int, lam: float
) -> NaiveBayesFit:
    """The plain twin of K15a: both passes over the blocks of K15a's plan
    (``fit_plan``)."""
    rows = fit_plan(features.shape[0], n_classes, features.shape[1])[1]
    return fit_finish_plain(*fit_partial_plain(features, label_idx, n_classes, rows), lam)


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
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.naive_bayes_fit_f32.argtypes = [p, ctypes.c_float, p]
    lib.naive_bayes_fit_f32.restype = i
    lib.naive_bayes_fit_capacity.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.naive_bayes_fit_capacity.restype = i
    lib.naive_bayes_scores_f32.argtypes = [p, p]
    lib.naive_bayes_scores_f32.restype = i


_LIBRARY = native.Library(SOURCE, _declare, "naive_bayes_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return _LIBRARY.get()


def fit_tiles(n_classes: int, n_features: int) -> Tuple[int, int, int]:
    """K15a pass 1's tiles (Ft, L, Ct): F tiles of at most 32 columns, L
    lanes of Ft threads, and class tiles whose lane partials fit the
    block's shared memory."""
    Ft = min(n_features, 32)
    L = _FIT_THREADS // Ft
    return Ft, L, min(n_classes, _FIT_SHARED_FLOATS // (L * Ft))


@functools.lru_cache(maxsize=1024)
def fit_plan(n: int, n_classes: int, n_features: int) -> Tuple[int, int, int, int, int]:
    """K15a's launch plan (nblk, rows_per_block, Ft, L, Ct): blocks of at
    least ``_FIT_ROWS`` rows (fewer blocks where the partials would pass
    ``_FIT_PARTIAL_FLOATS``) and ``fit_tiles``. A function of the shape
    alone, so the sums' order (and bits) does not depend on the card;
    memoised by shape."""
    C, F = n_classes, n_features
    nblk = max(1, min(-(-n // _FIT_ROWS), _FIT_BLOCKS, _FIT_PARTIAL_FLOATS // (C * F)))
    rows = -(-n // nblk)
    nblk = -(-n // rows)
    return (nblk, rows) + fit_tiles(C, F)


def fit_smem(n_classes: int, n_features: int) -> int:
    """K15a's dynamic shared bytes a block: the lanes' partials and a class
    tile's counts."""
    Ft, L, Ct = fit_tiles(n_classes, n_features)
    return 4 * (L * Ct * Ft + Ct)


def _table_size(n_shards: int) -> int:
    """The kernel's parameter table for ``n_shards`` shards (1, 8 or 64)."""
    return 1 if n_shards <= 1 else 8 if n_shards <= 8 else MAX_SHARDS


_CAPACITY: Dict[Tuple[int, int, int], int] = {}


def fit_capacity(device: torch.device, n_shards: int, smem: int) -> int:
    """Blocks of the fused fit that CUDA ``device`` holds at once (the
    occupancy query times the SM count; 0 without cooperative launch),
    memoised by device, table size and shared bytes."""
    key = (device.index, _table_size(n_shards), smem)
    cap = _CAPACITY.get(key)
    if cap is None:
        got = ctypes.c_int()
        err = _LIBRARY.get().naive_bayes_fit_capacity(device.index, n_shards, smem,
                                                      ctypes.byref(got))
        _LIBRARY.check(err, "naive_bayes_fit_capacity")
        cap = _CAPACITY[key] = got.value
    return cap


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
    if label_idx.dtype != torch.int32 or label_idx.shape != (n,):
        raise ValueError(f"label_idx must be [{n}] int32")
    if n < 1 or F < 1 or n_classes < 1:
        raise ValueError("naive_bayes_fit needs n, F and n_classes >= 1")
    dev = features.device
    if label_idx.device != dev:
        raise ValueError("features and label_idx must be on one device")
    if dev.type == "cuda" and not (features.is_contiguous() and label_idx.is_contiguous()):
        raise ValueError("features and label_idx must be contiguous")
    return _fit(dev, [(features, label_idx, 0, n, dev)], n, n_classes, F, lam)


def _fit(
    device: torch.device,
    shards: List[Tuple[torch.Tensor, torch.Tensor, int, int, torch.device]],
    n: int, C: int, F: int, lam: float,
) -> NaiveBayesFit:
    """K15a over the checked shards (rows, labels, first block, row count,
    device), every one holding whole blocks of the plan, in row order; the
    result on ``device``."""
    nblk, rows, Ft, L, Ct = fit_plan(n, C, F)
    if device.type == "cpu":
        LAUNCHES.add("naive_bayes_fit_plain")
        parts = [fit_partial_plain(X, y, C, rows) for X, y, _, n_s, _ in shards if n_s]
        if len(parts) > 1:
            parts = [tuple(torch.cat(t) for t in zip(*parts))]
        return fit_finish_plain(*parts[0], lam)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    # one allocation: counts, pi, theta, sums, then cpart and part; the
    # outputs are strided views of it at these offsets (in 32-bit words)
    CF = C * F
    head = 2 * C + 2 * CF
    o_counts, o_sums, o_pi, o_theta = 0, 2 * C + CF, C, 2 * C
    buf = torch.empty(head + nblk * (C + CF), dtype=torch.float32, device=device)
    out = NaiveBayesFit(buf.view(torch.int32).as_strided((C,), (1,), o_counts),
                        buf.as_strided((C, F), (F, 1), o_sums), buf.as_strided((C,), (1,), o_pi),
                        buf.as_strided((C, F), (F, 1), o_theta))
    base = buf.data_ptr()
    ptrs = (base + 4 * (head + nblk * C), base + 4 * head, base + 4 * o_counts,
            base + 4 * o_sums, base + 4 * o_pi, base + 4 * o_theta)
    if len(shards) == 1 and shards[0][4] == device:  # one device's fit
        mine = shards
    else:
        mine, others = [], {}
        for shard in shards:
            if shard[3]:
                if shard[4] == device:
                    mine.append(shard)
                else:
                    others.setdefault(shard[4], []).append(shard)
        if others:
            _pass1_elsewhere(others, buf[head:], nblk, rows, C, F, lam)
    cap = fit_capacity(device, len(mine), fit_smem(C, F))
    if cap < 1:
        raise native.KernelError(f"naive_bayes_fit: {device} holds no block of the cooperative "
                                 f"launch (occupancy 0 or no cooperative launch)")
    _launch_fit(device, mine, (n, F, C, nblk, rows, Ft, L, Ct), cap, ptrs, lam)
    return out


def _launch_fit(device, shards, plan, cap, ptrs, lam) -> None:
    """One call of ``naive_bayes_fit_f32`` on ``device``: the plan (n, F,
    C, nblk, rows, Ft, L, Ct), the fused launch's most blocks ``cap`` (0:
    pass 1 alone), the pointers (part, cpart, counts, sums, pi, theta) and
    the shard table (rows, labels, first block)."""
    cells = [device.index, *plan, cap, *ptrs, len(shards)]
    for X, y, b0, n_s, _ in shards:
        cells += (X.data_ptr(), y.data_ptr(), n_s, b0)
    args = array("q", cells)
    err = _LIBRARY.get().naive_bayes_fit_f32(
        args.buffer_info()[0], lam, native.current_stream(device.index))
    if err:
        _LIBRARY.check(err, "naive_bayes_fit" if cap else "naive_bayes_fit (pass 1)")
    LAUNCHES.add("naive_bayes_fit" if cap else "naive_bayes_fit_shard")


def _pass1_elsewhere(others, tail: torch.Tensor, nblk, rows, C, F, lam) -> None:
    """Pass 1 of the shards on devices other than the result's: one launch
    per device into partials there (its shards' blocks one after another),
    then each shard's blocks copied into ``tail`` (cpart [nblk, C] then part
    [nblk, C, F], as 32-bit words, on the result's device)."""
    cpart = tail[:nblk * C].view(torch.int32).view(nblk, C)
    part = tail[nblk * C:].view(nblk, C, F)
    Ft, L, Ct = fit_tiles(C, F)
    for dev, shards in others.items():
        nb = [-(-n_s // rows) for _, _, _, n_s, _ in shards]
        starts = list(itertools.accumulate(nb, initial=0))
        local = torch.empty(starts[-1] * (C + C * F), dtype=torch.float32, device=dev)
        lc = local[:starts[-1] * C].view(torch.int32).view(-1, C)
        lp = local[starts[-1] * C:].view(-1, C, F)
        table = [(X, y, j, n_s, d) for (X, y, _, n_s, d), j in zip(shards, starts)]
        base = local.data_ptr()
        _launch_fit(dev, table, (sum(s[3] for s in shards), F, C, starts[-1], rows, Ft, L, Ct),
                    0, [base + 4 * starts[-1] * C, base, 0, 0, 0, 0], lam)
        for (_, _, b0, _, _), j, k in zip(shards, starts, nb):  # the peer copies
            cpart[b0:b0 + k].copy_(lc[j:j + k])
            part[b0:b0 + k].copy_(lp[j:j + k])


def fit_shard_bounds(n: int, n_classes: int, n_features: int, n_shards: int) -> np.ndarray:
    """Row boundaries [n_shards + 1] of K15s's fit: the whole-n plan's
    blocks (``fit_plan``) cut by ``split_rows`` over each block's rows, so
    every shard holds whole blocks (none where there are fewer blocks than
    shards)."""
    nblk, rows = fit_plan(n, n_classes, n_features)[:2]
    weights = np.full(nblk, rows, np.int64)
    weights[-1] = n - rows * (nblk - 1)
    return np.minimum(split_rows(weights, n_shards) * rows, n)


def naive_bayes_fit_shards(
    features: Sequence[torch.Tensor],
    label_idx: Sequence[torch.Tensor],
    n_classes: int,
    lam: float,
    device: torch.device,
) -> NaiveBayesFit:
    """K15s's fit: K15a over the rows of every shard together, the result
    on ``device``. Shard s gives its rows ``features[s]`` [n_s, F] float32
    and ``label_idx[s]`` [n_s] int32 on its device, the shards in row order,
    each a whole number of the whole-n plan's blocks (``fit_shard_bounds``;
    an empty shard has 0 rows). The shards on ``device`` run in one launch
    of both passes, as ``naive_bayes_fit``; those on another device run
    pass 1 there, one launch per device, into partials copied to ``device``
    first. The result is one device's
    ``naive_bayes_fit`` of the rows, bit for bit, on the CPU's twins and on
    the card's kernels alike."""
    if len(features) != len(label_idx) or not features:
        raise ValueError("one features and one label_idx tensor per shard")
    if device.type == "cuda" and device.index is None:
        device = resolve_device(device)
    if len(features) > MAX_SHARDS:
        raise ValueError(f"at most {MAX_SHARDS} shards, got {len(features)}")
    shape = features[0].shape
    F = shape[1] if len(shape) == 2 else 0
    cuda = device.type == "cuda"
    n, checked = 0, []
    for X, y in zip(features, label_idx):
        dev, shape = X.device, X.shape
        if dev != device and dev.type != device.type:
            raise ValueError(f"the shards must lie on {device.type} devices, as the result")
        if len(shape) != 2 or shape[1] != F or X.dtype != torch.float32:
            raise ValueError(f"every shard's features must be [n_s, {F}] float32")
        n_s = shape[0]
        if y.dtype != torch.int32 or y.shape != (n_s,) or y.device != dev:
            raise ValueError(f"label_idx must be [{n_s}] int32 on {dev}")
        if cuda and not (X.is_contiguous() and y.is_contiguous()):
            raise ValueError("features and label_idx must be contiguous")
        checked.append((X, y, n, n_s, dev))
        n += n_s
    if n < 1 or F < 1 or n_classes < 1:
        raise ValueError("naive_bayes_fit_shards needs n, F and n_classes >= 1")
    rows = fit_plan(n, n_classes, F)[1]
    if any(n_s and (r0 % rows or (n_s % rows and r0 + n_s != n))
           for _, _, r0, n_s, _ in checked):
        raise ValueError(f"every shard must hold whole blocks of {rows} rows (fit_shard_bounds)")
    shards = [(X, y, r0 // rows, n_s, dev) for X, y, r0, n_s, dev in checked]
    return _fit(device, shards, n, n_classes, F, lam)


class ScoresShard(NamedTuple):
    """One shard of K15b's table: the rows ``X`` [rows, F] float32 (a row
    range of its device's upload of the batch), its block ``out`` [rows]
    int32 of the labels and, where given, its block ``scores`` [rows, C]
    float32 of the scores, all contiguous on the table's device."""

    X: torch.Tensor
    out: torch.Tensor
    scores: Optional[torch.Tensor] = None


def _checked_model(pi: torch.Tensor, theta: torch.Tensor) -> Tuple[int, int, torch.device]:
    """(C, F, device) of ``pi`` [C] and ``theta`` [C, F], float32 on one
    device; raises otherwise."""
    shape = theta.shape
    if len(shape) != 2 or pi.shape != shape[:1] or not shape[0] or not shape[1]:
        raise ValueError(f"pi [C] and theta [C, F] with C, F >= 1 expected, got "
                         f"{tuple(pi.shape)} and {tuple(shape)}")
    dev = theta.device
    if pi.dtype is not torch.float32 or theta.dtype is not torch.float32 or pi.device != dev:
        raise ValueError("pi and theta must be float32 on one device")
    return shape[0], shape[1], dev


def naive_bayes_scores_table(
    shards: Sequence[ScoresShard], pi: torch.Tensor, theta: torch.Tensor
) -> None:
    """K15b over a shard table: every shard's rows scored under ``pi`` [C]
    and ``theta`` [C, F] (float32, contiguous) into its blocks, in one
    launch on their device (the table's shards and the model lie on one
    device). The blocks must not overlap.

    On the CPU the twin runs once, over the shards' rows one after
    another. On CUDA the kernel must launch or this raises."""
    C, F, dev = _checked_model(pi, theta)
    if not 1 <= len(shards) <= MAX_SHARDS:
        raise ValueError(f"a table holds 1 to {MAX_SHARDS} shards, got {len(shards)}")
    for X, out, scores in shards:
        rows = X.shape[0]
        if X.dtype is not torch.float32 or X.dim() != 2 or X.shape[1] != F or X.device != dev:
            raise ValueError(f"every shard's rows must be [rows, {F}] float32 on {dev}")
        if out.dtype is not torch.int32 or out.shape != (rows,) or out.device != dev:
            raise ValueError(f"every shard's labels block must be [{rows}] int32 on {dev}")
        if scores is not None and (scores.dtype is not torch.float32
                                   or scores.shape != (rows, C) or scores.device != dev):
            raise ValueError(f"a shard's scores block must be [{rows}, {C}] float32 on {dev}")
    _score(dev, C, F, pi, theta, shards)


def _score(dev, C, F, pi, theta, shards) -> None:
    """K15b over checked shards: the twin on the CPU, else one launch."""
    if dev.type == "cpu":
        LAUNCHES.add("naive_bayes_scores_plain")
        Xs = [sh.X for sh in shards]
        scores = scores_plain(Xs[0] if len(Xs) == 1 else torch.cat(Xs), pi, theta)
        idx = argmax_first_nan(scores)
        r = 0
        for X, out, block in shards:
            n_s = X.shape[0]
            out.copy_(idx[r:r + n_s])
            if block is not None:
                block.copy_(scores[r:r + n_s])
            r += n_s
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (pi.is_contiguous() and theta.is_contiguous()):
        raise ValueError("pi and theta must be contiguous")
    cells = [dev.index, C, F, pi.data_ptr(), theta.data_ptr(), len(shards)]
    for X, out, scores in shards:
        if not (X.is_contiguous() and out.is_contiguous()
                and (scores is None or scores.is_contiguous())):
            raise ValueError("every shard's rows and blocks must be contiguous")
        cells += (X.data_ptr(), out.data_ptr(), 0 if scores is None else scores.data_ptr(),
                  X.shape[0])
    table = array("q", cells)
    err = _LIBRARY.get().naive_bayes_scores_f32(table.buffer_info()[0],
                                                native.current_stream(dev.index))
    if err:
        _LIBRARY.check(err, "naive_bayes_scores")
    LAUNCHES.add("naive_bayes_scores")


def naive_bayes_scores(
    features: torch.Tensor, pi: torch.Tensor, theta: torch.Tensor, with_scores: bool = False,
    out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K15b: (the int32 class index of each row of ``features`` [B, F]
    float32 under ``pi`` [C] and ``theta`` [C, F], written into ``out``
    [B] int32 where given, and, if ``with_scores``, the scores [B, C], else
    None). A table of one shard; the labels and the scores come from one
    allocation (none with ``out`` and no scores).

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    C, F, dev = _checked_model(pi, theta)
    shape = features.shape
    if len(shape) != 2 or shape[1] != F or features.dtype is not torch.float32:
        raise ValueError(f"features must be [B, {F}] float32, got {tuple(shape)} {features.dtype}")
    if features.device != dev:
        raise ValueError("features, pi and theta must be on one device")
    B = shape[0]
    if out is not None and (out.dtype is not torch.int32 or out.shape != (B,)
                            or out.device != dev):
        raise ValueError(f"out must be a [{B}] int32 tensor on {dev}")
    scores = None
    if with_scores:  # one allocation: the scores, then the labels where not given
        buf = torch.empty(B * C + (B if out is None else 0), dtype=torch.float32, device=dev)
        scores = buf[:B * C].view(B, C)
        if out is None:
            out = buf[B * C:].view(torch.int32)
    elif out is None:
        out = torch.empty(B, dtype=torch.int32, device=dev)
    if not B:
        return out, scores
    if dev.type != "cuda" or not (features.is_contiguous() and out.is_contiguous()):
        _score(dev, C, F, pi, theta, (ScoresShard(features, out, scores),))
        return out, scores
    # the table of one, built in place (the lean path a served batch takes)
    if not (pi.is_contiguous() and theta.is_contiguous()):
        raise ValueError("pi and theta must be contiguous")
    table = array("q", (dev.index, C, F, pi.data_ptr(), theta.data_ptr(), 1, features.data_ptr(),
                        out.data_ptr(), 0 if scores is None else scores.data_ptr(), B))
    err = _LIBRARY.get().naive_bayes_scores_f32(table.buffer_info()[0],
                                                native.current_stream(dev.index))
    if err:
        _LIBRARY.check(err, "naive_bayes_scores")
    LAUNCHES.add("naive_bayes_scores")
    return out, scores


# pi and theta placed on a device for serving ("naive_bayes_place": one per
# device a model is placed on)
PLACEMENTS = LaunchCounts("naive_bayes_place")


def placed(model: "NaiveBayesModelArrays", dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``model``'s pi and theta on ``dev``, placed at the first call for
    that device and kept in the model's serving state (``_placed``, which
    is never saved), so later batches upload only their rows."""
    if model._placed is None:
        model._placed = {}
    got = model._placed.get(dev)
    if got is None:
        got = model._placed[dev] = (torch.tensor(np.asarray(model.pi, np.float32), device=dev),
                                    torch.tensor(np.asarray(model.theta, np.float32), device=dev))
        PLACEMENTS.add("naive_bayes_place")
    return got


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
    checks, ``np.unique`` over the labels, then K15a. On a 1-D ``data``
    ``mesh`` of several shards the rows shard at K15a's block boundaries
    (K15s, ``naive_bayes_fit_shards``) and the model, one device's bit for
    bit, predicts on the mesh's first device."""
    check_data_axis(axis)
    mesh, device = collapse_mesh(mesh, device)
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    features = np.asarray(features, np.float32)
    labels = np.asarray(labels)
    if features.ndim != 2 or len(features) != len(labels):
        raise ValueError("features must be [n, F] aligned with labels [n]")
    if len(labels) == 0:
        raise ValueError("cannot train on an empty dataset")
    if (features < 0).any():
        raise ValueError("multinomial NB requires nonnegative features")
    classes, label_idx = np.unique(labels, return_inverse=True)
    label_idx = label_idx.astype(np.int32).reshape(-1)
    if mesh is None:
        fit = naive_bayes_fit(
            torch.tensor(features, device=dev), torch.tensor(label_idx, device=dev),
            len(classes), lam,
        )
    else:
        bounds = fit_shard_bounds(len(labels), len(classes), features.shape[1], mesh.size)
        fit = naive_bayes_fit_shards(
            cut_rows(mesh, features, bounds), cut_rows(mesh, label_idx, bounds),
            len(classes), lam, dev,
        )
    # the fit's pi and theta stay placed on its device for serving
    return NaiveBayesModelArrays(
        pi=fit.pi.cpu().numpy(), theta=fit.theta.cpu().numpy(), labels=classes, device=dev,
        _placed={dev: (fit.pi, fit.theta)},
    )


def predict_naive_bayes(
    model: NaiveBayesModelArrays,
    features: np.ndarray,
    mesh=None,
    axis: str = "data",
    device: DeviceLike = None,
) -> np.ndarray:
    """Predicted label for each row of [B, F], on ``device``, else the
    model's device, else CUDA: one upload of the rows and one K15b launch
    under the model's placed pi and theta (``placed``), one fetch. On a 1-D
    ``data`` ``mesh`` of several shards (K15s) the batch is cut into row
    shards; each distinct device uploads its shards' rows once and runs one
    launch over its shard table (the first device's shards into their
    blocks of one [B] result there, another device's into a buffer of its
    own, copied into their blocks), and the result is fetched once."""
    check_data_axis(axis)
    mesh, device = collapse_mesh(mesh, device)
    features = np.atleast_2d(np.asarray(features, np.float32))
    if mesh is None:
        dev = resolve_device(device if device is not None else model.device)
        idx, _ = naive_bayes_scores(torch.from_numpy(np.ascontiguousarray(features)).to(dev),
                                    *placed(model, dev))
        return model.labels[idx.cpu().numpy()]
    first = mesh.devices[0]
    bounds = split_rows(np.ones(len(features), np.int64), mesh.size)
    by_dev: Dict[torch.device, List[int]] = {}
    for s, d in enumerate(mesh.devices):
        if bounds[s + 1] > bounds[s]:
            by_dev.setdefault(d, []).append(s)
    out = torch.empty(len(features), dtype=torch.int32, device=first)
    for d, idx in by_dev.items():
        spans = [(int(bounds[s]), int(bounds[s + 1])) for s in idx]
        rows = features if len(by_dev) == 1 else np.concatenate(
            [features[a:b] for a, b in spans])
        up = torch.from_numpy(np.ascontiguousarray(rows)).to(d)
        dest = out if d == first else torch.empty(len(rows), dtype=torch.int32, device=d)
        shards, j = [], 0
        for a, b in spans:
            block = dest[a:b] if d == first else dest[j:j + b - a]
            shards.append(ScoresShard(up[j:j + b - a], block))
            j += b - a
        naive_bayes_scores_table(shards, *placed(model, d))
        if d != first:  # the peer copies, one per shard
            j = 0
            for a, b in spans:
                out[a:b].copy_(dest[j:j + b - a])
                j += b - a
    return model.labels[out.cpu().numpy()]
