"""K9m, the row-sharded retriever's cross-shard merge: the counterpart of the
reference's jitted program ``predictionio_tpu/ops/retrieval.py:425
_merge_candidates``.

``merge_topn(cand, n)`` takes the sharded retriever's candidate buffer as it
lays it out, ``cand [S, B, 2L]`` float32 (per shard and query row: L
scores, then L int32 global ids as raw bits, each shard's list sorted by
score descending, as kernels A and B emit them), and returns ``[B, 2n]``:
the exact top-n of the S·L candidates in the order ``lax.top_k`` gives over
their concatenation (score descending, ties to the lower position: the
lower shard first, then the shard's own order), then their ids as raw bits.
``out=`` takes the caller's ``[B, 2n]`` result (the retriever allocates it
beside the buffer), so a call allocates nothing.

Two forms, one function: the hand-written CUDA kernel ``csrc/merge_topn.cu``
(its header states the bound and the design), built with nvcc at first use
and called with only what it reads (its entry point makes the device
current); and the plain twin ``merge_topn_plain``, the concatenation and a
stable descending sort. A CPU tensor goes to the twin; a CUDA tensor to the
kernel, which launches or raises, never falls back. ``LAUNCHES`` counts
what it ran.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts
from predictionio_tpu_torch.ops.topn import pack_topn

SOURCE = "merge_topn.cu"
_MAX_B = 65535  # the kernel's grid holds a query row per y-block

# "merge_topn": kernel launches; "merge_topn_plain": CPU calls routed to
# the twin
LAUNCHES = LaunchCounts("merge_topn", "merge_topn_plain")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.merge_topn_f32.argtypes = [i, p, i, i, i, i, p, p]
    lib.merge_topn_f32.restype = i


_LIBRARY = native.Library(SOURCE, _declare, "merge_topn_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    return _LIBRARY.get()


def merge_topn_plain(cand: torch.Tensor, n: int) -> torch.Tensor:
    """The plain twin: each row's S lists concatenated in shard order, a
    stable descending sort by score (ties keep the concatenation's order),
    the first n, packed."""
    S, B, L2 = cand.shape
    L = L2 // 2
    scores = cand[:, :, :L].permute(1, 0, 2).reshape(B, S * L)
    ids = cand[:, :, L:].permute(1, 0, 2).contiguous().view(torch.int32).reshape(B, S * L)
    s, j = torch.sort(scores, dim=1, descending=True, stable=True)
    return pack_topn(s[:, :n], torch.gather(ids, 1, j[:, :n]))


def merge_topn(
    cand: torch.Tensor, n: int, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K9m (see the module doc) -> ``[B, 2n]`` float32 (``out`` when given:
    a contiguous float32 ``[B, 2n]`` on cand's device). CPU tensors go to
    the twin; CUDA tensors to the kernel, which must build and launch or
    this raises."""
    n = int(n)
    shape = cand.shape
    if len(shape) != 3 or shape[2] % 2:
        raise ValueError(f"cand must be [S, B, 2L], got {tuple(shape)}")
    if cand.dtype != torch.float32:
        raise TypeError(f"cand must be float32, got {cand.dtype}")
    S, B, L = shape[0], shape[1], shape[2] // 2
    if not (1 <= B <= _MAX_B and S >= 1 and L >= 1):
        raise ValueError(f"B={B} (at most {_MAX_B:,}), S={S} or L={L} out of range")
    if not 1 <= n <= S * L:
        raise ValueError(f"n={n} out of range [1, S·L={S * L}]")
    if not cand.is_contiguous():
        raise ValueError("cand must be contiguous: the retriever's [S, B, 2L] buffer")
    dev = cand.device
    if out is not None and (out.shape != (B, 2 * n) or out.dtype != torch.float32
                            or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 [{B}, {2 * n}] on {dev}")
    if dev.type == "cpu":
        LAUNCHES.add("merge_topn_plain")
        res = merge_topn_plain(cand, n)
        return res if out is None else out.copy_(res)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if out is None:
        out = torch.empty((B, 2 * n), dtype=torch.float32, device=dev)
    err = _LIBRARY.get().merge_topn_f32(
        dev.index, cand.data_ptr(), B, S, L, n, out.data_ptr(),
        native.current_stream(dev.index))
    if err:
        _LIBRARY.check(err, "merge_topn")
    LAUNCHES.add("merge_topn")
    return out
