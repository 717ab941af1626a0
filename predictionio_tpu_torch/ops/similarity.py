"""Cosine-similarity scoring over factor matrices: the counterpart of
``predictionio_tpu/ops/similarity.py`` on one GPU (the kernel behind the
Similar Product template's host scoring path, reference
examples/scala-parallel-similarproduct ALSAlgorithm.scala predict: per
candidate, the sum over the query items of cosine(query, candidate)).

The factor matrix is L2-normalized once (``normalize_rows``, the
reference's :54) and uploaded once (``SimilarityScorer``, :69); a query's
normalized rows are padded to a power of two (min 4, zero rows score 0)
and scored by K14:

- the hand-written CUDA kernel for Hopper, ``csrc/cosine_sum.cu`` (its
  header states the bound and the design), which scores every shard of a
  shard table (``CosineTable``: per shard its rows and the offset of its
  block of the result, all on one device) in one launch;
- the plain PyTorch twin ``cosine_sum_plain``, the reference's
  ``(q @ Yᵀ).sum(0)`` (:63);
- the wrapper ``cosine_sum_table``, which routes CPU tensors to the twin
  and CUDA tensors to the kernel (launch or raise, no fallback), and
  ``cosine_sum``, the same on one matrix for one-off calls (a table of one
  built a call). ``LAUNCHES`` counts what they ran: one per table.

With a ``mesh`` (K14s, the reference's :84-90 and :118-120) the normalized
matrix is row-sharded (zero-padded to a multiple of the shard count: zero
rows score 0 and are sliced off) and the scorer keeps one table per
distinct device: the mesh's first device's shards write straight into
their blocks of one sum vector there, and each other device's shards into
a buffer of that device, copied into their blocks (one peer copy per run of
adjacent shards). So a query is one launch per distinct device, and a
row's sum is K14's bit for bit (the kernel's arithmetic on a row does not
depend on its shard). The result is fetched once. A mesh of one shard
collapses to one device.

Not ported: the device ledger registration (item 10).
"""

from __future__ import annotations

import ctypes
from array import array
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts
from predictionio_tpu_torch.parallel.mesh import collapse_mesh, shard_batch
from predictionio_tpu_torch.utils.shapes import pad_rows_pow2

SOURCE = "cosine_sum.cu"
_MAX_K = 12 * 1024  # one query row must fit the kernel's 48 KB tile
MAX_SHARDS = 64  # a shard table's most shards (the kernel's parameter table)

# "cosine_sum": kernel launches (one per table); "cosine_sum_plain": CPU
# calls the wrappers routed to the plain twin
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
    p = ctypes.c_void_p
    lib.cosine_sum_f32.argtypes = [p, p, ctypes.c_int, p, p]
    lib.cosine_sum_f32.restype = ctypes.c_int


_LIBRARY = native.Library(SOURCE, _declare, "cosine_sum_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    return _LIBRARY.get()


class CosineTable:
    """K14's shard table on one device: shard s is ``ys[s]`` [rows_s, k]
    float32 (contiguous, on the table's device) and fills
    ``out[offsets[s]:offsets[s] + rows_s]`` of a [size] result. Built once
    per matrix (it holds the rows, so the pointers it packs stay valid);
    each call then passes the kernel one pointer."""

    def __init__(self, ys: Sequence[torch.Tensor], offsets: Sequence[int], size: int):
        if not 1 <= len(ys) <= MAX_SHARDS or len(offsets) != len(ys):
            raise ValueError(f"a table holds 1 to {MAX_SHARDS} shards, each with an offset; "
                             f"got {len(ys)} shards and {len(offsets)} offsets")
        dev, k = ys[0].device, ys[0].shape[-1]
        for y, off in zip(ys, offsets):
            if y.dim() != 2 or y.dtype != torch.float32 or y.shape[1] != k or y.device != dev:
                raise ValueError(f"every shard must be [rows, {k}] float32 on {dev}")
            if not y.is_contiguous():
                raise ValueError("every shard must be contiguous (row-major)")
            if not 0 <= off <= off + y.shape[0] <= size:
                raise ValueError(f"a shard's block [{off}, {off + y.shape[0]}) leaves the "
                                 f"result's [0, {size})")
        if not 1 <= k <= _MAX_K:
            raise ValueError(f"k={k} out of range (1 <= k <= {_MAX_K})")
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        self.ys, self.offsets = tuple(ys), tuple(int(o) for o in offsets)
        self.device, self.k, self.size = dev, int(k), int(size)
        self.rows = sum(int(y.shape[0]) for y in ys)
        if dev.type == "cuda":
            cells = [dev.index, self.k, len(ys)]
            for y, off in zip(self.ys, self.offsets):
                cells += [y.data_ptr(), y.shape[0], off]
            self._table = array("q", cells)
            self._addr = self._table.buffer_info()[0]


def cosine_sum_table(
    q: torch.Tensor, table: CosineTable, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K14 over a shard table: ``out[offsets[s] + r] = Σ_q q·ys[s][r]`` for
    the query rows q [Q, k] float32 on the table's device, in one launch;
    ``out`` (a contiguous float32 [size] there, new when not given) keeps
    its other entries.

    CPU tensors go to the plain twin (once, over the shards' rows one after
    another). CUDA tensors go to the kernel, which must build and launch or
    this raises."""
    if q.dtype != torch.float32 or q.dim() != 2 or q.shape[1] != table.k or q.shape[0] < 1:
        raise ValueError(f"q must be [Q >= 1, {table.k}] float32, got {tuple(q.shape)} {q.dtype}")
    if q.device != table.device:
        raise ValueError(f"q must be on the table's device {table.device}, not {q.device}")
    if out is None:
        out = torch.empty(table.size, dtype=torch.float32, device=table.device)
    elif (out.dtype != torch.float32 or tuple(out.shape) != (table.size,)
          or out.device != table.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 [{table.size}] on {table.device}")
    if table.device.type == "cpu":
        LAUNCHES.add("cosine_sum_plain")
        ys = table.ys
        sums = cosine_sum_plain(q, ys[0] if len(ys) == 1 else torch.cat(ys))
        r = 0
        for y, off in zip(ys, table.offsets):
            out[off:off + y.shape[0]] = sums[r:r + y.shape[0]]
            r += y.shape[0]
        return out
    if not q.is_contiguous():
        raise ValueError("q must be contiguous (row-major)")
    if not table.rows:
        return out
    err = _LIBRARY.get().cosine_sum_f32(
        table._addr, q.data_ptr(), q.shape[0], out.data_ptr(),
        native.current_stream(table.device.index))
    if err:
        _LIBRARY.check(err, "cosine_sum")
    LAUNCHES.add("cosine_sum")
    return out


def cosine_sum(
    q: torch.Tensor, Y: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K14 on one matrix: ``Σ_q q·y`` for every row y of Y [N, k] over the
    query rows q [Q, k] (both float32, on one device): [N] float32
    (``out`` when given: a contiguous float32 ``[N]`` on Y's device). With
    both normalized, every product is a cosine. A convenience for one-off
    calls: it builds a table of one shard a call, where ``SimilarityScorer``
    builds its tables once and calls ``cosine_sum_table``.

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    if q.dim() != 2 or Y.dim() != 2 or q.shape[1] != Y.shape[1]:
        raise ValueError(f"q [Q, k] and Y [N, k] expected, got {tuple(q.shape)} and {tuple(Y.shape)}")
    if q.dtype != torch.float32 or Y.dtype != torch.float32:
        raise TypeError("q and Y must be float32")
    if q.device != Y.device:
        raise ValueError("q and Y must be on one device")
    if Y.shape[0] < 1:
        raise ValueError("Y must hold at least one row")
    if Y.device.type == "cpu":
        Y = Y.contiguous()  # the twin takes any layout; a table holds row-major shards
    return cosine_sum_table(q, CosineTable([Y], [0], Y.shape[0]), out)


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
        rows = self._shards[0].shape[0]
        size = rows * len(self._shards)
        groups: Dict[torch.device, List[int]] = {}
        for s, y in enumerate(self._shards):
            groups.setdefault(y.device, []).append(s)
        if self._shards[0].device != self.device:
            raise ValueError(f"the first shard lies on {self._shards[0].device}, not {self.device}")
        # the first device's table writes into the sums; another device's
        # into its own buffer, copied by runs of adjacent shards
        first = groups.pop(self.device)
        self._first = CosineTable([self._shards[s] for s in first], [s * rows for s in first],
                                  size)
        self._others = []
        for dev, idx in groups.items():
            table = CosineTable([self._shards[s] for s in idx],
                                [j * rows for j in range(len(idx))], rows * len(idx))
            runs = []
            for j, s in enumerate(idx):
                if runs and runs[-1][0] + runs[-1][2] == s * rows:
                    runs[-1][2] += rows
                else:
                    runs.append([s * rows, j * rows, rows])
            self._others.append((table, runs))

    @property
    def n(self) -> int:
        return self.normed.shape[0]

    def sums(self, q: torch.Tensor) -> torch.Tensor:
        """K14 over every shard, one launch per distinct device, for the
        query rows q [Q, k] float32 (copied to a device where it does not
        lie): the padded matrix's [rows · shards] sums on the first
        device."""
        sums = cosine_sum_table(q if q.device == self.device else q.to(self.device), self._first)
        for table, runs in self._others:
            part = cosine_sum_table(q.to(table.device), table)
            for g, j, n in runs:
                sums[g:g + n].copy_(part[j:j + n])  # the peer copy
        return sums

    def cosine_sum(self, query_rows: np.ndarray) -> np.ndarray:
        """Sum of cosine similarities of every row of the matrix against
        the (already normalized) query rows: [N] scores. The query rows pad
        to a power of two (min 4) with zero rows, which add 0 to every
        sum, as the reference pads them."""
        q = torch.from_numpy(np.ascontiguousarray(
            pad_rows_pow2(np.atleast_2d(query_rows), 4), np.float32))
        return self.sums(q)[: self.n].cpu().numpy()

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
