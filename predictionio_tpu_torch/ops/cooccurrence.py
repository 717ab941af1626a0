"""K19, DIMSUM's all-pairs item cosine: the counterpart of the dense product
in the reference's ``predictionio_tpu/models/similarproduct/engine.py:615-622``
(``DIMSUMAlgorithm.train``: the binary [U, I] view matrix, its columns
L2-normalized, one float32 ``Rn·Rnᵀ``, then the diagonal and the values
under ``threshold`` zeroed).

The view matrix is binary, so ``Rn·Rnᵀ[i, j] = C[i, j] / sqrt(n_i·n_j)``
with ``C[i, j]`` the number of users who viewed both items and ``n_i =
C[i, i]``. The port computes that from the counts, sparse: the host
deduplicates the (user, item) pairs and uploads per-user item lists
(CSR); then

- ``cooccur_counts(user_ptr, items, n_items)`` (K19a): ``C`` [I, I] int32,
  its lower triangle (diagonal included) counting each user's item pairs
  i >= j;
- ``cosine_from_counts(C, rinv, threshold)`` (K19b): ``S`` [I, I] float32,
  ``C[hi, lo]·rinv[lo]·rinv[hi]`` mirrored into both triangles, the
  diagonal 0, values under ``threshold`` 0, where ``rinv = 1/sqrt(n)`` (0
  for an item nobody viewed, whose row is then 0, not NaN).

``item_cosine`` runs the whole function from (user, item) view arrays and
returns the host matrix the model keeps.

Three forms of each kernel, one function:
- the hand-written CUDA kernels for Hopper, ``csrc/cooccurrence.cu`` (its
  header states the bound and the design: integer atomics, exact in any
  order; a fixed product order, so K19b equals its twin bit for bit);
- the plain PyTorch twins ``cooccur_counts_plain`` (``index_put_`` with
  ``accumulate=True`` over the pair list) and ``cosine_from_counts_plain``
  (the epilogue in the kernel's float order);
- the wrappers, which route CPU tensors to the twins and CUDA tensors to
  the kernels (launch or raise, no fallback). ``LAUNCHES`` counts what
  they ran.
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts

SOURCE = "cooccurrence.cu"

LAUNCHES = LaunchCounts(
    "cooccur_counts", "cosine_from_counts",
    "cooccur_counts_plain", "cosine_from_counts_plain",
)


def dedup_views(
    users: np.ndarray, items: np.ndarray, n_items: int
) -> Tuple[np.ndarray, np.ndarray]:
    """The distinct (user, item) pairs of view arrays as CSR over users
    0..max(users): (user_ptr int64, items int32), each user's items
    ascending (setting a cell of the view matrix to 1.0 is idempotent, so
    a repeated view counts once)."""
    users = np.asarray(users, np.int64)
    items = np.asarray(items, np.int64)
    if len(users) != len(items):
        raise ValueError("users and items must have one length")
    n_users = int(users.max()) + 1 if len(users) else 0
    keys = np.unique(users * n_items + items)
    u = keys // n_items
    user_ptr = np.zeros(n_users + 1, np.int64)
    np.cumsum(np.bincount(u, minlength=n_users), out=user_ptr[1:])
    return user_ptr, (keys % n_items).astype(np.int32)


def inverse_norms(items: np.ndarray, n_items: int) -> np.ndarray:
    """``rinv`` [I] float32: 1/sqrt(viewers) per item, as the reference's
    ``normalize_rows`` scales a binary row (1/norm), and 0 for an item
    nobody viewed."""
    n = np.bincount(items, minlength=n_items).astype(np.float32)
    rinv = np.zeros(n_items, np.float32)
    seen = n > 0
    rinv[seen] = np.float32(1.0) / np.sqrt(n[seen])
    return rinv


def cooccur_counts_plain(
    user_ptr: torch.Tensor, items: torch.Tensor, n_items: int
) -> torch.Tensor:
    """The plain twin: every user's item pairs (a >= b in list order, so
    item_a >= item_b) as flat indices into C, added by ``index_put_`` with
    ``accumulate=True``."""
    dev = items.device
    C = torch.zeros((n_items, n_items), dtype=torch.int32, device=dev)
    nnz = items.shape[0]
    if nnz == 0:
        return C
    counts = user_ptr[1:] - user_ptr[:-1]
    owner = torch.repeat_interleave(torch.arange(len(counts), device=dev), counts)
    pos = torch.arange(nnz, device=dev) - user_ptr[owner]  # a, within the user
    reps = pos + 1  # item a pairs with b = 0..a
    first = torch.repeat_interleave(torch.arange(nnz, device=dev), reps)
    starts = torch.cumsum(reps, 0) - reps
    within = torch.arange(int(reps.sum()), device=dev) - torch.repeat_interleave(starts, reps)
    second = user_ptr[owner[first]] + within
    idx = items[first].long() * n_items + items[second].long()
    ones = torch.ones(idx.shape[0], dtype=torch.int32, device=dev)
    C.view(-1).index_put_((idx,), ones, accumulate=True)
    return C


def cosine_from_counts_plain(
    C: torch.Tensor, rinv: torch.Tensor, threshold: float
) -> torch.Tensor:
    """The plain twin: the lower triangle's ``C[i, j]·rinv[j]·rinv[i]`` in
    the kernel's float order, the threshold, then the mirror (adding the
    zero upper triangle is exact)."""
    V = C.to(torch.float32) * rinv[None, :] * rinv[:, None]
    V = torch.tril(V, diagonal=-1)
    V = torch.where(V < threshold, torch.zeros_like(V), V)
    return V + V.T


def _declare(lib: ctypes.CDLL) -> None:
    lib.cooccur_counts_i32.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p
    ] * 2
    lib.cooccur_counts_i32.restype = ctypes.c_int
    lib.cosine_from_counts_f32.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_float
    ] + [ctypes.c_void_p] * 2
    lib.cosine_from_counts_f32.restype = ctypes.c_int


_LIBRARY = native.Library(SOURCE, _declare, "cooccurrence_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return _LIBRARY.get()


def cooccur_counts(user_ptr: torch.Tensor, items: torch.Tensor, n_items: int) -> torch.Tensor:
    """K19a: C [n_items, n_items] int32 from per-user item lists (CSR:
    ``user_ptr`` [U + 1] int64, ``items`` int32, each list ascending and
    without repeats), its lower triangle counting co-viewing users and the
    upper triangle 0.

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    if user_ptr.dtype != torch.int64 or items.dtype != torch.int32:
        raise TypeError("user_ptr must be int64 and items int32")
    if user_ptr.dim() != 1 or items.dim() != 1 or user_ptr.shape[0] < 1:
        raise ValueError("user_ptr and items must be 1-d, user_ptr non-empty")
    if not 1 <= n_items < 2**31 or user_ptr.device != items.device:
        raise ValueError("n_items out of range or tensors on two devices")
    if items.device.type == "cpu":
        LAUNCHES.add("cooccur_counts_plain")
        return cooccur_counts_plain(user_ptr, items, n_items)
    if items.device.type != "cuda":
        raise ValueError(f"unsupported device {items.device}")
    if not (user_ptr.is_contiguous() and items.is_contiguous()):
        raise ValueError("user_ptr and items must be contiguous")
    lib = load_library()
    C = torch.zeros((n_items, n_items), dtype=torch.int32, device=items.device)
    with torch.cuda.device(items.device):
        stream = torch.cuda.current_stream(items.device).cuda_stream
        err = lib.cooccur_counts_i32(
            user_ptr.data_ptr(), items.data_ptr(), user_ptr.shape[0] - 1, n_items,
            C.data_ptr(), stream,
        )
    _LIBRARY.check(err, "cooccur_counts")
    LAUNCHES.add("cooccur_counts")
    return C


def cosine_from_counts(C: torch.Tensor, rinv: torch.Tensor, threshold: float) -> torch.Tensor:
    """K19b: S [I, I] float32 from the counts ``C`` [I, I] int32 (lower
    triangle read) and ``rinv`` [I] float32; see the module docstring.

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    if C.dim() != 2 or C.shape[0] != C.shape[1] or C.dtype != torch.int32:
        raise ValueError(f"C must be [I, I] int32, got {tuple(C.shape)} {C.dtype}")
    I = C.shape[0]
    if I < 1 or tuple(rinv.shape) != (I,) or rinv.dtype != torch.float32:
        raise ValueError(f"rinv must be [{I}] float32 and I >= 1")
    if rinv.device != C.device:
        raise ValueError("C and rinv must be on one device")
    if C.device.type == "cpu":
        LAUNCHES.add("cosine_from_counts_plain")
        return cosine_from_counts_plain(C, rinv, threshold)
    if C.device.type != "cuda":
        raise ValueError(f"unsupported device {C.device}")
    if not (C.is_contiguous() and rinv.is_contiguous()):
        raise ValueError("C and rinv must be contiguous")
    lib = load_library()
    S = torch.empty((I, I), dtype=torch.float32, device=C.device)
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        err = lib.cosine_from_counts_f32(
            C.data_ptr(), rinv.data_ptr(), I, float(threshold), S.data_ptr(), stream
        )
    _LIBRARY.check(err, "cosine_from_counts")
    LAUNCHES.add("cosine_from_counts")
    return S


def item_cosine(
    users: np.ndarray,
    items: np.ndarray,
    n_items: int,
    threshold: float = 0.0,
    device: DeviceLike = None,
    timings: Optional[dict] = None,
) -> np.ndarray:
    """The thresholded all-pairs item cosine [n_items, n_items] float32
    (host numpy) of view arrays (user and item indices, duplicates
    allowed), computed on ``device`` (CUDA unless the CPU is asked for):
    the host dedup and CSR, K19a, K19b, one device-to-host copy.
    ``timings``, if given, receives ``dedup_s``, ``device_s`` (the upload
    and both kernels, to their end) and ``d2h_s`` (the copy)."""
    dev = resolve_device(device)
    t = time.perf_counter()
    user_ptr, flat = dedup_views(users, items, n_items)
    rinv = inverse_norms(flat, n_items)
    t1 = time.perf_counter()
    C = cooccur_counts(
        torch.from_numpy(user_ptr).to(dev), torch.from_numpy(flat).to(dev), n_items
    )
    S = cosine_from_counts(C, torch.from_numpy(rinv).to(dev), threshold)
    del C
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    out = S.cpu().numpy()
    if timings is not None:
        timings.update(dedup_s=t1 - t, device_s=t2 - t1, d2h_s=time.perf_counter() - t2)
    return out
