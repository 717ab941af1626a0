"""K9m, the row-sharded retriever's cross-shard merge: the counterpart of the
reference's jitted program ``predictionio_tpu/ops/retrieval.py:425
_merge_candidates``.

``merge_topn(cand, n)`` takes the shards' packed candidates ``cand [B, S,
2, L]`` float32 (per query row and shard: L scores, then L int32 global ids
as raw bits, each shard's list sorted by score descending, as kernels A
and B emit them) and returns ``[B, 2n]``: the exact top-n of the S·L
candidates in the order ``lax.top_k`` gives over their concatenation
(score descending, ties to the lower position: the lower shard first, then
the shard's own order), then their ids as raw bits. ``cand`` may be a
strided view (the sharded retriever passes its ``[S, B, 2L]`` buffer
permuted), as long as each (row, shard) list is contiguous.

Two forms, one function: the hand-written CUDA kernel ``csrc/merge_topn.cu``
(its header states the bound and the design), built with nvcc at first use;
and the plain twin ``merge_topn_plain``, the concatenation and a stable
descending sort. A CPU tensor goes to the twin; a CUDA tensor to the
kernel, which launches or raises, never falls back. ``LAUNCHES`` counts
what it ran.
"""

from __future__ import annotations

import ctypes

import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts
from predictionio_tpu_torch.ops.topn import pack_topn

SOURCE = "merge_topn.cu"

# "merge_topn": kernel launches; "merge_topn_plain": CPU calls routed to
# the twin
LAUNCHES = LaunchCounts("merge_topn", "merge_topn_plain")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.merge_topn_launch.argtypes = [p, ll, ll, i, i, i, i, p, p]
    lib.merge_topn_launch.restype = i


_LIBRARY = native.Library(SOURCE, _declare, "merge_topn_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    return _LIBRARY.get()


def merge_topn_plain(cand: torch.Tensor, n: int) -> torch.Tensor:
    """The plain twin: the S lists concatenated per row, a stable
    descending sort by score (ties keep the concatenation's order), the
    first n, packed."""
    B, S, _, L = cand.shape
    scores = cand[:, :, 0, :].reshape(B, S * L)
    ids = cand[:, :, 1, :].contiguous().view(torch.int32).reshape(B, S * L)
    s, j = torch.sort(scores, dim=1, descending=True, stable=True)
    return pack_topn(s[:, :n], torch.gather(ids, 1, j[:, :n]))


def _check(cand: torch.Tensor, n: int) -> None:
    if cand.dim() != 4 or cand.shape[2] != 2:
        raise ValueError(f"cand must be [B, S, 2, L], got {tuple(cand.shape)}")
    if cand.dtype != torch.float32:
        raise TypeError(f"cand must be float32, got {cand.dtype}")
    B, S, _, L = cand.shape
    if not (1 <= B <= 65535 and S >= 1 and L >= 1):
        raise ValueError(f"B={B} (at most 65,535), S={S} or L={L} out of range")
    if not 1 <= n <= S * L:
        raise ValueError(f"n={n} out of range [1, S·L={S * L}]")
    if cand.stride(3) != 1 or cand.stride(2) != L:
        raise ValueError("each (row, shard) list of cand must be contiguous")


def merge_topn(cand: torch.Tensor, n: int) -> torch.Tensor:
    """K9m (see the module doc) -> ``[B, 2n]`` float32. CPU tensors go to
    the twin; CUDA tensors to the kernel, which must build and launch or
    this raises."""
    n = int(n)
    _check(cand, n)
    if cand.device.type == "cpu":
        LAUNCHES.add("merge_topn_plain")
        return merge_topn_plain(cand, n)
    if cand.device.type != "cuda":
        raise ValueError(f"unsupported device {cand.device}")
    lib = load_library()
    B, S, _, L = cand.shape
    out = torch.empty((B, 2 * n), dtype=torch.float32, device=cand.device)
    with torch.cuda.device(cand.device):
        stream = torch.cuda.current_stream(cand.device).cuda_stream
        err = lib.merge_topn_launch(
            cand.data_ptr(), cand.stride(0), cand.stride(1), B, S, L, n,
            out.data_ptr(), stream,
        )
    _LIBRARY.check(err, "merge_topn")
    LAUNCHES.add("merge_topn")
    return out
