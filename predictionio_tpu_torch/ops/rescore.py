"""Kernel B, the retriever's stage-2 exact rescore + top-n_out, packed: the
counterpart of the reference's jitted ``predictionio_tpu/ops/retrieval.py:316
_rescore_exact`` and the tail of ``:343 _fused_topn_single_2s`` (K10).

``rescore_topn(q, Y, scale, rn, stage1, n_out, ...)`` takes stage 1's packed
shortlist ``[B, 2S]`` (``ops/masked_topn.py``), gathers and dequantizes the
shortlisted rows of ``Y`` (int8 with ``scale``, or bf16), rescores them
against the f32 query (``* rn`` when ``normalize``; ``positive_only`` on the
exact score; stage 1's -inf slots stay -inf) and returns ``[B, 2·n_out]``:
the n_out best by (score descending, shortlist position ascending), then
their ids from the shortlist as raw int32 bits.

The row-shard form (stage 2 of the reference's ``:366
_shard_topk_kernel_2s``): a shard's stage 1 shortlists its LOCAL ids, which
index its own rows, and ``id_offset=off`` (the shard's first global row)
is added to the ids written; ``n_out`` is the shard's ``n_local``. The
single-device form is ``id_offset=0`` (the default).
``out=`` writes into a given contiguous ``[B, 2·n_out]`` float32 tensor.

A CPU tensor goes to the plain twin ``rescore_topn_plain``; a CUDA tensor
to the hand-written kernel ``csrc/rescore.cu`` (its header states the
bound and the design), built with nvcc at first use; on a CUDA tensor it
launches or raises, never falls back. ``LAUNCHES`` counts what it ran.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.masked_topn import check_offset
from predictionio_tpu_torch.ops.native import LaunchCounts
from predictionio_tpu_torch.ops.topn import check_out, pack_topn

SOURCE = "rescore.cu"
_PRECISION = {torch.bfloat16: 1, torch.int8: 2}

# "rescore_topn": kernel launches; "rescore_topn_plain": CPU calls routed
# to the twin
LAUNCHES = LaunchCounts("rescore_topn", "rescore_topn_plain")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rescore_topn_launch.argtypes = [p] * 5 + [i, p, i, p] + [i] * 7 + [p]
    lib.rescore_topn_launch.restype = i
    lib.rescore_scratch_floats.argtypes = [i] * 3
    lib.rescore_scratch_floats.restype = ctypes.c_longlong


_LIBRARY = native.Library(SOURCE, _declare, "rescore_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    return _LIBRARY.get()


def split_packed(packed: torch.Tensor):
    """``[B, 2S]`` packed -> (scores ``[B, S]``, int32 ids ``[B, S]``)."""
    S = packed.shape[1] // 2
    return packed[:, :S], packed[:, S:].contiguous().view(torch.int32)


def rescore_topn_plain(
    q: torch.Tensor, Y: torch.Tensor, scale: Optional[torch.Tensor],
    rn: Optional[torch.Tensor], stage1: torch.Tensor, n_out: int,
    positive_only: bool = False, normalize: bool = False, id_offset: int = 0,
) -> torch.Tensor:
    """The plain twin: the gathered rows dequantized, an f32 einsum with the
    query, the same scaling and masks, a stable descending sort over the
    shortlist positions, the first n_out with their shortlist ids plus
    ``id_offset``."""
    s1, i1 = split_packed(stage1)
    idx = i1.to(torch.int64)
    rows = Y[idx].to(torch.float32)
    if scale is not None:
        rows = rows * scale[idx][:, :, None]
    rescored = torch.einsum("bk,bck->bc", q, rows)
    if normalize:
        rescored = rescored * rn[idx]
    ninf = torch.full_like(rescored, float("-inf"))
    if positive_only:
        rescored = torch.where(rescored > 0, rescored, ninf)
    rescored = torch.where(s1 == float("-inf"), ninf, rescored)
    s, j = torch.sort(rescored, dim=1, descending=True, stable=True)
    return pack_topn(s[:, :n_out], torch.gather(i1, 1, j[:, :n_out]) + id_offset)


def _check(q, Y, scale, rn, stage1, n_out, normalize) -> int:
    if q.dim() != 2 or Y.dim() != 2 or stage1.dim() != 2:
        raise ValueError("q [B,k], Y [N,k] and stage1 [B, 2S] expected")
    if q.dtype != torch.float32 or stage1.dtype != torch.float32:
        raise TypeError("q and stage1 must be float32")
    if Y.dtype not in _PRECISION:
        raise TypeError(f"Y must be bfloat16 or int8, got {Y.dtype}")
    B, k = q.shape
    N = Y.shape[0]
    if Y.shape[1] != k or k < 1:
        raise ValueError(f"rank mismatch: q is {tuple(q.shape)}, Y is {tuple(Y.shape)}")
    if stage1.shape[0] != B or stage1.shape[1] % 2 or stage1.shape[1] < 2:
        raise ValueError(f"stage1 must be [{B}, 2S], got {tuple(stage1.shape)}")
    S = stage1.shape[1] // 2
    if not 1 <= n_out <= S:
        raise ValueError(f"n_out={n_out} out of range [1, S={S}]")
    if not 1 <= N < 2**31 or B < 1:
        raise ValueError(f"catalog {N} or batch {B} out of range")
    if (Y.dtype == torch.int8) != (scale is not None):
        raise ValueError("int8 rows take a per-row scale; bf16 rows take none")
    if scale is not None and (scale.dtype != torch.float32 or scale.shape != (N,)):
        raise ValueError(f"scale must be float32 [{N}]")
    if normalize and (rn is None or rn.dtype != torch.float32 or rn.shape != (N,)):
        raise ValueError(f"normalize needs rn, float32 [{N}]")
    devices = {t.device for t in (q, Y, stage1, scale, rn) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    return _PRECISION[Y.dtype]


def rescore_topn(
    q: torch.Tensor, Y: torch.Tensor, scale: Optional[torch.Tensor],
    rn: Optional[torch.Tensor], stage1: torch.Tensor, n_out: int,
    positive_only: bool = False, normalize: bool = False,
    id_offset: int = 0, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel B (see the module doc) -> ``[B, 2·n_out]`` float32 (``out``
    when given; a nonzero ``id_offset`` for a row shard). CPU tensors go
    to the twin; CUDA tensors to the kernel, which must build and launch or
    this raises."""
    n_out = int(n_out)
    precision = _check(q, Y, scale, rn, stage1, n_out, normalize)
    off = check_offset(id_offset, Y.shape[0])
    check_out(out, (q.shape[0], 2 * n_out), q.device)
    if q.device.type == "cpu":
        LAUNCHES.add("rescore_topn_plain")
        res = rescore_topn_plain(q, Y, scale, rn, stage1, n_out, positive_only, normalize, off)
        return res if out is None else out.copy_(res)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not all(t.is_contiguous() for t in (q, Y, stage1, scale, rn) if t is not None):
        raise ValueError("q, Y, scale, rn and stage1 must be contiguous")
    lib = load_library()
    B, k = q.shape
    N, S = Y.shape[0], stage1.shape[1] // 2
    if out is None:
        out = torch.empty((B, 2 * n_out), dtype=torch.float32, device=q.device)
    scratch = torch.empty(
        max(1, int(lib.rescore_scratch_floats(B, S, k))),
        dtype=torch.float32, device=q.device,
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rescore_topn_launch(
            q.data_ptr(), Y.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            rn.data_ptr() if rn is not None else None,
            stage1.data_ptr(), S, out.data_ptr(), n_out, scratch.data_ptr(),
            B, N, k, precision, int(normalize), int(positive_only), off, stream,
        )
    _LIBRARY.check(err, "rescore_topn")
    LAUNCHES.add("rescore_topn")
    return out
