"""Kernel A, the retriever's masked score + top-m, packed: the counterpart
of the reference's jitted programs ``predictionio_tpu/ops/retrieval.py:280
_fused_topn_single`` with ``:164 _mask_scores`` (K9), and of the stage-1
half of ``:343 _fused_topn_single_2s`` with ``:295 _approx_scores`` (K10).

Two wrappers, each with its plain PyTorch twin in this module:

- ``candidate_mask(allow0, excl, incl, has_incl)`` -> int32 bits
  ``[B, ceil(N/32)]``: bit j of row b is set when item j is a candidate of
  query b: ``allow0[j]``, not in the row's exclude ids, and in its include
  ids when ``has_incl[b]``. Ids outside ``[0, N)`` are dropped.
- ``masked_topn_packed(q, Y, scale, rn, bits, m, ...)`` -> ``[B, 2m]``
  float32: per query row the m best ``producer(q, y_j) [* rn[j]]`` over the
  candidates, ordered by (score descending, id ascending), a masked item
  scoring -inf with its real id; then the m ids as raw int32 bits. The
  producer follows ``Y``'s dtype: float32 (f32 FMAs), bfloat16 (the query
  rounded to bf16) or int8 (the query quantized per row, int32 sums, then
  ``(float)acc * qs * scale[j]``).

The row-shard forms (the reference's mesh path, ``:397
_shard_topk_kernel`` and stage 1 of ``:366 _shard_topk_kernel_2s``): with
``id_offset=off`` a shard holding the catalog rows ``[off, off + N)`` takes
the GLOBAL id lists, ``candidate_mask`` keeping an id g only where
``g - off`` lies in ``[0, N)`` (the reference's ``localize``), and
``masked_topn_packed`` writes ``local id + off``. The single-device form
is ``id_offset=0`` (the default) over the whole catalog: the same kernels,
the same launch counts. ``masked_topn_packed(..., out=t)`` writes into a
given contiguous ``[B, 2m]`` float32 tensor (a slice of the sharded
retriever's candidate buffer) instead of a new one.

A CPU tensor goes to the twin; a CUDA tensor to the hand-written kernels in
``csrc/masked_topn.cu`` (its header states the bound and the design),
built with nvcc at first use; on a CUDA tensor a wrapper launches or
raises, never falls back. ``LAUNCHES`` counts what each ran.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts
from predictionio_tpu_torch.ops.topn import check_out, pack_topn

SOURCE = "masked_topn.cu"
_MAX_B = 65535 * 8  # the tile kernel's grid holds 8 query rows per y-block
_PRECISION = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# "<name>": kernel launches; "<name>_plain": CPU calls routed to the twin
LAUNCHES = LaunchCounts(
    "candidate_mask", "candidate_mask_plain", "masked_topn", "masked_topn_plain",
)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.candidate_mask_launch.argtypes = [p, p, i, p, i, p, p, i, i, i, p]
    lib.candidate_mask_launch.restype = i
    lib.masked_topn_launch.argtypes = [p] * 7 + [i] * 8 + [p]
    lib.masked_topn_launch.restype = i
    lib.masked_topn_scratch_floats.argtypes = [i] * 3
    lib.masked_topn_scratch_floats.restype = ctypes.c_longlong


_LIBRARY = native.Library(SOURCE, _declare, "masked_topn_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return _LIBRARY.get()


def mask_words(n: int) -> int:
    """32-bit words of one query row's candidate bits over n items."""
    return (n + 31) // 32


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """Bool ``[B, N]`` -> int32 ``[B, ceil(N/32)]``, bit j of word w being
    item 32·w + j."""
    B, N = mask.shape
    W = mask_words(N)
    padded = torch.zeros((B, W * 32), dtype=torch.int64, device=mask.device)
    padded[:, :N] = mask.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (padded.view(B, W, 32) << shifts).sum(dim=2)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits(bits: torch.Tensor, n: int) -> torch.Tensor:
    """int32 ``[B, W]`` -> bool ``[B, n]`` (the inverse of ``pack_bits``)."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    flat = ((bits[:, :, None] >> shifts) & 1).reshape(bits.shape[0], -1)
    return flat[:, :n].to(torch.bool)


def candidate_mask_plain(
    allow0: torch.Tensor, excl: torch.Tensor, incl: torch.Tensor,
    has_incl: torch.Tensor, id_offset: int = 0,
) -> torch.Tensor:
    """The plain twin: the reference's mask as a dense ``[B, N]`` bool
    (allow0 & not excluded & (included | no include list)), packed; an id
    g names local row ``g - id_offset``."""
    B, N = excl.shape[0], allow0.shape[0]
    rows = torch.arange(B, device=allow0.device)[:, None]

    def scatter(ids: torch.Tensor) -> torch.Tensor:
        hit = torch.zeros((B, N + 1), dtype=torch.bool, device=allow0.device)
        ids = ids.to(torch.int64) - id_offset
        ids = torch.where((ids >= 0) & (ids < N), ids, N)  # N: dropped
        hit[rows.expand_as(ids), ids] = True
        return hit[:, :N]

    allow = allow0.to(torch.bool)[None, :] & ~scatter(excl)
    allow = allow & (scatter(incl) | ~has_incl.to(torch.bool)[:, None])
    return pack_bits(allow)


def check_offset(id_offset: int, N: int) -> int:
    """The offset a launch uses; global ids must stay int32."""
    if not 0 <= int(id_offset) <= 2**31 - 1 - N:
        raise ValueError(f"id_offset {id_offset} out of range for {N} rows")
    return int(id_offset)


def _check_mask_args(allow0, excl, incl, has_incl) -> None:
    if allow0.dim() != 1 or excl.dim() != 2 or incl.dim() != 2 or has_incl.dim() != 1:
        raise ValueError("allow0 [N], excl [B, We], incl [B, Wi], has_incl [B] expected")
    B = excl.shape[0]
    if incl.shape[0] != B or has_incl.shape[0] != B:
        raise ValueError("excl, incl and has_incl disagree on the batch")
    if excl.dtype != torch.int32 or incl.dtype != torch.int32:
        raise TypeError(f"id lists must be int32, got {excl.dtype}, {incl.dtype}")
    if allow0.dtype not in (torch.bool, torch.uint8) or has_incl.dtype not in (torch.bool, torch.uint8):
        raise TypeError("allow0 and has_incl must be bool or uint8")
    # the mask kernel's grid: a block per (row, 8,192 items), 65,535 of
    # those per row at most
    if not (1 <= B < 2**31 and 1 <= allow0.shape[0] <= 65535 * 8192):
        raise ValueError(f"batch {B} or catalog {allow0.shape[0]} out of range")
    if excl.shape[1] < 1 or incl.shape[1] < 1:
        raise ValueError("id lists need at least one column (pad with N)")
    devices = {t.device for t in (allow0, excl, incl, has_incl)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


def candidate_mask(
    allow0: torch.Tensor, excl: torch.Tensor, incl: torch.Tensor,
    has_incl: torch.Tensor, id_offset: int = 0,
) -> torch.Tensor:
    """The candidate bits ``[B, ceil(N/32)]`` int32 (see the module doc;
    a nonzero ``id_offset`` for a row shard). CPU tensors go to the twin;
    CUDA tensors to the kernel."""
    _check_mask_args(allow0, excl, incl, has_incl)
    off = check_offset(id_offset, allow0.shape[0])
    if allow0.device.type == "cpu":
        LAUNCHES.add("candidate_mask_plain")
        return candidate_mask_plain(allow0, excl, incl, has_incl, off)
    if allow0.device.type != "cuda":
        raise ValueError(f"unsupported device {allow0.device}")
    if not all(t.is_contiguous() for t in (allow0, excl, incl, has_incl)):
        raise ValueError("mask inputs must be contiguous")
    lib = load_library()
    B, N = excl.shape[0], allow0.shape[0]
    bits = torch.empty((B, mask_words(N)), dtype=torch.int32, device=allow0.device)
    with torch.cuda.device(allow0.device):
        stream = torch.cuda.current_stream(allow0.device).cuda_stream
        err = lib.candidate_mask_launch(
            allow0.data_ptr(), excl.data_ptr(), excl.shape[1],
            incl.data_ptr(), incl.shape[1], has_incl.data_ptr(),
            bits.data_ptr(), B, N, off, stream,
        )
    _LIBRARY.check(err, "candidate_mask")
    LAUNCHES.add("candidate_mask")
    return bits


def approx_scores_plain(
    q: torch.Tensor, Y: torch.Tensor, scale: Optional[torch.Tensor]
) -> torch.Tensor:
    """The twin's score producer, ``[B, N]`` float32, in ``Y``'s tier: an
    f32 product; a product of the bf16-rounded query with the bf16 rows in
    f32; or the int8 product of the per-row-quantized query, summed exactly
    (in float64, then cast to int32: CPU torch's int8 matmul wraps and CUDA
    torch has no int32 one), then ``acc * qs * scale``."""
    if Y.dtype == torch.float32:
        return q @ Y.T
    if Y.dtype == torch.bfloat16:
        return q.to(torch.bfloat16).to(torch.float32) @ Y.to(torch.float32).T
    amax = q.abs().amax(dim=1)
    # a tensor divisor: CUDA torch turns division by a Python scalar into a
    # product with its reciprocal, which is not IEEE division
    qs = amax / torch.full_like(amax, 127.0)
    qs = torch.where(qs > 0, qs, torch.ones_like(qs))
    qi = torch.clamp(torch.round(q / qs[:, None]), -127, 127)
    acc = (qi.to(torch.float64) @ Y.to(torch.float64).T).to(torch.int32)
    return acc.to(torch.float32) * qs[:, None] * scale[None, :]


def masked_topn_plain(
    q: torch.Tensor, Y: torch.Tensor, scale: Optional[torch.Tensor],
    rn: Optional[torch.Tensor], bits: torch.Tensor, m: int,
    positive_only: bool = False, normalize: bool = False, id_offset: int = 0,
) -> torch.Tensor:
    """The plain twin: the scores, ``* rn``, the mask (and ``s > 0``) as
    -inf, a stable descending sort (ties keep ascending ids), the first m,
    packed with ``id_offset`` added to the ids."""
    scores = approx_scores_plain(q, Y, scale)
    if normalize:
        scores = scores * rn[None, :]
    allow = unpack_bits(bits, Y.shape[0])
    if positive_only:
        allow = allow & (scores > 0)
    scores = torch.where(allow, scores, torch.full_like(scores, float("-inf")))
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return pack_topn(s[:, :m], i[:, :m] + id_offset)


def _check_topn_args(q, Y, scale, rn, bits, m, normalize) -> int:
    if q.dim() != 2 or Y.dim() != 2:
        raise ValueError(f"q and Y must be 2-D, got {tuple(q.shape)}, {tuple(Y.shape)}")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if Y.dtype not in _PRECISION:
        raise TypeError(f"Y must be float32, bfloat16 or int8, got {Y.dtype}")
    B, k = q.shape
    N = Y.shape[0]
    if Y.shape[1] != k or k < 1:
        raise ValueError(f"rank mismatch: q is {tuple(q.shape)}, Y is {tuple(Y.shape)}")
    if not 1 <= B <= _MAX_B:
        raise ValueError(f"batch {B} out of range [1, {_MAX_B}]")
    if not 1 <= N < 2**31:
        raise ValueError(f"catalog size {N} out of range [1, 2^31)")
    if not 1 <= m <= N:
        raise ValueError(f"m={m} out of range [1, N={N}]")
    if (Y.dtype == torch.int8) != (scale is not None):
        raise ValueError("int8 rows take a per-row scale; other tiers take none")
    if scale is not None and (scale.dtype != torch.float32 or scale.shape != (N,)):
        raise ValueError(f"scale must be float32 [{N}]")
    if normalize and (rn is None or rn.dtype != torch.float32 or rn.shape != (N,)):
        raise ValueError(f"normalize needs rn, float32 [{N}]")
    if bits.dtype != torch.int32 or tuple(bits.shape) != (B, mask_words(N)):
        raise ValueError(f"bits must be int32 [{B}, {mask_words(N)}]")
    devices = {t.device for t in (q, Y, bits, scale, rn) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    return _PRECISION[Y.dtype]


def masked_topn_packed(
    q: torch.Tensor, Y: torch.Tensor, scale: Optional[torch.Tensor],
    rn: Optional[torch.Tensor], bits: torch.Tensor, m: int,
    positive_only: bool = False, normalize: bool = False,
    id_offset: int = 0, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel A on ``q [B,k]`` f32, ``Y [N,k]`` (f32, bf16 or int8 with
    ``scale [N]``), ``rn [N]`` (read when ``normalize``) and the candidate
    ``bits`` -> ``[B, 2m]`` float32 (``out`` when given; a nonzero
    ``id_offset`` for a row shard). CPU tensors go to the twin; CUDA tensors to
    the kernel, which must build and launch or this raises."""
    m = int(m)
    precision = _check_topn_args(q, Y, scale, rn, bits, m, normalize)
    off = check_offset(id_offset, Y.shape[0])
    check_out(out, (q.shape[0], 2 * m), q.device)
    if q.device.type == "cpu":
        LAUNCHES.add("masked_topn_plain")
        res = masked_topn_plain(q, Y, scale, rn, bits, m, positive_only, normalize, off)
        return res if out is None else out.copy_(res)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not all(t.is_contiguous() for t in (q, Y, bits, scale, rn) if t is not None):
        raise ValueError("q, Y, scale, rn and bits must be contiguous")
    lib = load_library()
    B, k = q.shape
    N = Y.shape[0]
    if out is None:
        out = torch.empty((B, 2 * m), dtype=torch.float32, device=q.device)
    scratch = torch.empty(
        int(lib.masked_topn_scratch_floats(B, N, m)),
        dtype=torch.float32, device=q.device,
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.masked_topn_launch(
            q.data_ptr(), Y.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            rn.data_ptr() if rn is not None else None,
            bits.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            B, N, k, m, precision, int(normalize), int(positive_only), off, stream,
        )
    _LIBRARY.check(err, "masked_topn")
    LAUNCHES.add("masked_topn")
    return out
