"""Cosine-similarity scoring over factor matrices: the counterpart of
``predictionio_tpu/ops/similarity.py`` on one GPU (the kernel behind the
Similar Product template's host scoring path, reference
examples/scala-parallel-similarproduct ALSAlgorithm.scala predict: per
candidate, the sum over the query items of cosine(query, candidate)).

The factor matrix is L2-normalized once (``normalize_rows``, the
reference's :54) and uploaded once (``SimilarityScorer``, :69); a query's
normalized rows are padded to a power of two (min 4, zero rows score 0)
and scored by K14, ``cosine_sum``:

- the hand-written CUDA kernel for Hopper, ``csrc/cosine_sum.cu`` (its
  header states the bound and the design);
- the plain PyTorch twin ``cosine_sum_plain``, the reference's
  ``(q @ Yᵀ).sum(0)`` (:63);
- the wrapper ``cosine_sum``, which routes CPU tensors to the twin and CUDA
  tensors to the kernel (launch or raise, no fallback). ``LAUNCHES``
  counts what it ran.

With a ``mesh`` (K14s, the reference's :84-90 and :118-120) the normalized
matrix is row-sharded (zero-padded to a multiple of the shard count: zero
rows score 0 and are sliced off), the query rows go to every shard's
device, and K14 runs per shard, writing its block of one sum vector on the
mesh's first device (a peer copy, none where the shard shares that
device), which is fetched once. A mesh of one shard collapses to one
device.

Not ported: the device ledger registration (item 10).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts
from predictionio_tpu_torch.parallel.mesh import collapse_mesh, shard_batch
from predictionio_tpu_torch.utils.shapes import pad_rows_pow2

SOURCE = "cosine_sum.cu"
_MAX_K = 12 * 1024  # one query row must fit the kernel's 48 KB tile

# "cosine_sum": kernel launches; "cosine_sum_plain": CPU calls the wrapper
# routed to the plain twin
LAUNCHES = LaunchCounts("cosine_sum", "cosine_sum_plain")


def normalize_rows(factors: np.ndarray) -> np.ndarray:
    """L2-normalize rows; zero rows stay zero (cosine with a zero vector
    is 0 in the reference's cosine helper). A copy of the reference's
    :54, keeping its dtype."""
    f = np.asarray(factors, np.float32)
    norms = np.linalg.norm(f, axis=1, keepdims=True)
    return np.where(norms > 0, f / np.where(norms == 0, 1, norms), 0.0)


def cosine_sum_plain(q: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """The plain twin: ``(q @ Yᵀ).sum(0)``, [N]."""
    return (q @ Y.T).sum(0)


def _declare(lib: ctypes.CDLL) -> None:
    lib.cosine_sum_f32.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [
        ctypes.c_int
    ] * 2 + [ctypes.c_void_p] * 2
    lib.cosine_sum_f32.restype = ctypes.c_int


_LIBRARY = native.Library(SOURCE, _declare, "cosine_sum_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    return _LIBRARY.get()


def cosine_sum(
    q: torch.Tensor, Y: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K14: ``Σ_q q·y`` for every row y of Y [N, k] over the query rows
    q [Q, k] (both float32, on one device): [N] float32 (``out`` when
    given: a contiguous float32 ``[N]`` on Y's device). With both
    normalized, every product is a cosine.

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    if q.dim() != 2 or Y.dim() != 2 or q.shape[1] != Y.shape[1]:
        raise ValueError(f"q [Q, k] and Y [N, k] expected, got {tuple(q.shape)} and {tuple(Y.shape)}")
    if q.dtype != torch.float32 or Y.dtype != torch.float32:
        raise TypeError("q and Y must be float32")
    if q.device != Y.device:
        raise ValueError("q and Y must be on one device")
    Q, k = q.shape
    N = Y.shape[0]
    if not 1 <= k <= _MAX_K or Q < 1 or N < 1:
        raise ValueError(f"Q={Q}, N={N} or k={k} out of range (1 <= k <= {_MAX_K})")
    if out is not None and (out.dtype != torch.float32 or tuple(out.shape) != (N,)
                            or out.device != Y.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 [{N}] on {Y.device}")
    if Y.device.type == "cpu":
        LAUNCHES.add("cosine_sum_plain")
        res = cosine_sum_plain(q, Y)
        return res if out is None else out.copy_(res)
    if Y.device.type != "cuda":
        raise ValueError(f"unsupported device {Y.device}")
    if not (q.is_contiguous() and Y.is_contiguous()):
        raise ValueError("q and Y must be contiguous (row-major)")
    lib = load_library()
    if out is None:
        out = torch.empty(N, dtype=torch.float32, device=Y.device)
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream(Y.device).cuda_stream
        err = lib.cosine_sum_f32(q.data_ptr(), Q, Y.data_ptr(), N, k, out.data_ptr(), stream)
    _LIBRARY.check(err, "cosine_sum")
    LAUNCHES.add("cosine_sum")
    return out


class SimilarityScorer:
    """Device-resident normalized factors; each call ships only the query
    rows up and one score vector down. With a ``mesh`` the rows shard
    over it (see the module doc)."""

    def __init__(self, factors: np.ndarray, device: DeviceLike = None, mesh=None):
        mesh, device = collapse_mesh(mesh, device)
        self.mesh = mesh
        self.normed = normalize_rows(factors)
        if mesh is None:
            self.device = resolve_device(device)
            self._shards = [torch.from_numpy(
                np.ascontiguousarray(self.normed, np.float32)).to(self.device)]
        else:
            self.device = mesh.devices[0]
            self._shards, _ = shard_batch(mesh, self.normed.astype(np.float32))
        self._dev = self._shards[0]

    @property
    def n(self) -> int:
        return self.normed.shape[0]

    def cosine_sum(self, query_rows: np.ndarray) -> np.ndarray:
        """Sum of cosine similarities of every row of the matrix against
        the (already normalized) query rows: [N] scores. The query rows pad
        to a power of two (min 4) with zero rows, which add 0 to every
        sum, as the reference pads them."""
        q = torch.from_numpy(np.ascontiguousarray(
            pad_rows_pow2(np.atleast_2d(query_rows), 4), np.float32))
        on = {d: q.to(d) for d in dict.fromkeys(y.device for y in self._shards)}
        rows = self._shards[0].shape[0]
        sums = torch.empty(rows * len(self._shards), dtype=torch.float32, device=self.device)
        for s, y in enumerate(self._shards):
            dst = sums[s * rows : (s + 1) * rows]
            if y.device == self.device:
                cosine_sum(on[y.device], y, out=dst)
            else:
                dst.copy_(cosine_sum(on[y.device], y))  # the peer copy
        return sums.cpu().numpy()[: self.n]

    def warm(self, max_q: int = 16) -> None:
        """Run every padded query width a query of up to ``max_q`` items
        can hit once (including the width a non-power-of-two ``max_q`` pads
        into), so the kernel is built and loaded before traffic."""
        k = self.normed.shape[1]
        q = 4
        while True:
            self.cosine_sum(np.zeros((q, k), np.float32))
            if q >= max_q:
                break
            q *= 2
