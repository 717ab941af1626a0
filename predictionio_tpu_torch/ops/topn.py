"""K3, the serving score + top-n, packed: the counterpart of the reference's
jitted program ``predictionio_tpu/ops/als.py:2354 _topn_packed_impl``
(``_topn_packed`` at :2365).

``topn_packed(q, Y, n)`` returns ``[B, 2n]`` float32: per query row the n
best item scores (``q·Yᵀ``), descending, then the n int32 item ids as raw
bits. Ties break lowest index first, as ``lax.top_k`` does.

Three forms, one function:
- the hand-written CUDA kernel for Hopper, ``csrc/topn.cu`` (its header
  states the bound on the card and the design), built with nvcc at first
  use and called through ``ctypes``;
- the plain PyTorch twin ``topn_packed_plain``: an f32 product and a
  STABLE descending sort (``torch.topk`` does not fix the order of ties);
- the wrapper ``topn_packed``, which routes a CPU tensor to the twin and a
  CUDA tensor to the kernel. On a CUDA tensor it launches the kernel or
  raises; it never falls back to the twin. ``LAUNCHES`` counts what it ran.

K3c, ``topn_chain(q, Y, n, n_iters)``, is the counterpart of the
reference's timing program ``predictionio_tpu/ops/als.py:2382
_topn_packed_chain``: ``n_iters`` K3 passes enqueued back to back by one
host call, pass i on the query ``q + float32(i)·float32(1e-7)``
(``chain_offset``), returning the last pass's packed rows. Its kernel is
K3's with the offset added as the query is loaded (``csrc/topn.cu``
``topn_chain_f32``); its twin ``topn_chain_plain`` loops
``topn_packed_plain`` over the offset queries. ``ServingFactors.measure_compute_ms``
(``ops/als.py``) times it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts

SOURCE = "topn.cu"
_MAX_B = 65535 * 8  # the kernel's grid holds 8 query rows per y-block


# "topn_packed": kernel launches; "topn_packed_plain": CPU calls the
# wrapper routed to the plain twin
LAUNCHES = LaunchCounts("topn_packed", "topn_packed_plain", "topn_chain", "topn_chain_plain")


def _declare(lib: ctypes.CDLL) -> None:
    lib.topn_packed_f32.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int
    ] * 4 + [ctypes.c_void_p]
    lib.topn_packed_f32.restype = ctypes.c_int
    lib.topn_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.topn_scratch_floats.restype = ctypes.c_longlong
    lib.topn_chain_f32.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int
    ] * 5 + [ctypes.c_void_p]
    lib.topn_chain_f32.restype = ctypes.c_int


_LIBRARY = native.Library(SOURCE, _declare, "topn_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    return _LIBRARY.get()


def pack_topn(scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[B, 2n]``: scores, then the int32 ids as raw float32 bits (a
    bitcast, never a float cast, so ids >= 2^24 survive)."""
    bits = idx.to(torch.int32).contiguous().view(torch.float32)
    return torch.cat([scores.to(torch.float32), bits], dim=1)


def topn_packed_plain(q: torch.Tensor, Y: torch.Tensor, n: int) -> torch.Tensor:
    """The plain twin: f32 ``q @ Y.T``, a stable descending sort (ties keep
    ascending index order), the first n, packed."""
    scores = q @ Y.T
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return pack_topn(s[:, :n], i[:, :n])


def _check(q: torch.Tensor, Y: torch.Tensor, n: int) -> None:
    if q.dim() != 2 or Y.dim() != 2:
        raise ValueError(
            f"q and Y must be 2-D, got {tuple(q.shape)} and {tuple(Y.shape)}"
        )
    if q.dtype != torch.float32 or Y.dtype != torch.float32:
        raise TypeError(f"q and Y must be float32, got {q.dtype} and {Y.dtype}")
    if q.shape[1] != Y.shape[1] or q.shape[1] < 1:
        raise ValueError(
            f"rank mismatch: q is {tuple(q.shape)}, Y is {tuple(Y.shape)}"
        )
    B, N = q.shape[0], Y.shape[0]
    if not 1 <= B <= _MAX_B:
        raise ValueError(f"batch {B} out of range [1, {_MAX_B}]")
    if not 1 <= N < 2**31:
        raise ValueError(f"catalog size {N} out of range [1, 2^31)")
    if not 1 <= n <= N:
        raise ValueError(f"n={n} out of range [1, N={N}]")
    if q.device != Y.device:
        raise ValueError(f"q is on {q.device} but Y is on {Y.device}")


def check_out(out: Optional[torch.Tensor], shape, device) -> None:
    """A caller's output tensor must be a contiguous float32 tensor of
    ``shape`` on the inputs' device."""
    if out is not None and (
        out.dtype != torch.float32 or tuple(out.shape) != tuple(shape)
        or out.device != device or not out.is_contiguous()
    ):
        raise ValueError(f"out must be a contiguous float32 {list(shape)} on {device}")


def topn_packed(
    q: torch.Tensor, Y: torch.Tensor, n: int, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K3 on ``q [B,k]`` and ``Y [N,k]`` float32 -> ``[B, 2n]`` float32
    (``out`` when given: a contiguous float32 ``[B, 2n]``, such as a block
    of the sharded serving path's result).

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    n = int(n)
    _check(q, Y, n)
    check_out(out, (q.shape[0], 2 * n), q.device)
    if q.device.type == "cpu":
        LAUNCHES.add("topn_packed_plain")
        res = topn_packed_plain(q, Y, n)
        return res if out is None else out.copy_(res)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch("topn_packed", q, Y, n, out=out)


def _launch(
    name: str, q: torch.Tensor, Y: torch.Tensor, n: int, *extra: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch ``lib.<name>_f32`` (K3 or K3c, ``extra`` its trailing int
    arguments) on CUDA tensors that ``_check`` accepted, into ``out`` or a
    new ``[B, 2n]`` output, with its scratch; count the launch."""
    if not (q.is_contiguous() and Y.is_contiguous()):
        raise ValueError("q and Y must be contiguous (row-major)")
    lib = load_library()
    B, k = q.shape
    N = Y.shape[0]
    if out is None:
        out = torch.empty((B, 2 * n), dtype=torch.float32, device=q.device)
    scratch = torch.empty(
        int(lib.topn_scratch_floats(B, N, n)),
        dtype=torch.float32, device=q.device,
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"{name}_f32")(
            q.data_ptr(), Y.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            B, N, k, n, *extra, stream,
        )
    _LIBRARY.check(err, name)
    LAUNCHES.add(name)
    return out


def chain_offset(i: int) -> np.float32:
    """The query offset of K3c's pass ``i``: ``float32(i) · float32(1e-7)``,
    one float32 rounding, as the reference forms it."""
    return np.float32(i) * np.float32(1e-7)


def topn_chain_plain(q: torch.Tensor, Y: torch.Tensor, n: int, n_iters: int) -> torch.Tensor:
    """The plain twin of K3c: ``topn_packed_plain`` on ``q + chain_offset(i)``
    for i in 0..n_iters-1; the last pass's result."""
    out = None
    for i in range(int(n_iters)):
        off = torch.tensor(chain_offset(i), dtype=torch.float32, device=q.device)
        out = topn_packed_plain(q + off, Y, n)
    return out


def topn_chain(q: torch.Tensor, Y: torch.Tensor, n: int, n_iters: int) -> torch.Tensor:
    """K3c on ``q [B,k]`` and ``Y [N,k]`` float32: ``n_iters`` >= 1 chained
    K3 passes, pass i on ``q + chain_offset(i)``; the last pass's ``[B, 2n]``.
    One call counts one launch (of ``n_iters`` passes).

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    n, n_iters = int(n), int(n_iters)
    _check(q, Y, n)
    if n_iters < 1:
        raise ValueError(f"n_iters={n_iters} must be at least 1")
    if q.device.type == "cpu":
        LAUNCHES.add("topn_chain_plain")
        return topn_chain_plain(q, Y, n, n_iters)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch("topn_chain", q, Y, n, n_iters)


def check_topn_agreement(
    scores: np.ndarray,
    ids: np.ndarray,
    ref_scores: np.ndarray,
    ref_ids: np.ndarray,
    rtol: float = 1e-5,
    atol: float = 1e-6,
    q: Optional[np.ndarray] = None,
    Y: Optional[np.ndarray] = None,
) -> float:
    """Hold a top-n result against a reference computed with another
    summation order; return the largest absolute score difference.

    Scores must agree within ``atol + rtol·|ref|``. Ids must be unique per
    row and equal to the reference's, except inside a run of consecutive
    reference scores that lie within that tolerance of each other (a
    near-tie the two summation orders may order differently): there the id
    sets must agree. A run that reaches the end of the list may go on past
    it, so there the ids may differ. Given the inputs ``q`` and ``Y``, each
    reported score is also held against its id's float64 score. Raises
    ``AssertionError`` on disagreement."""
    scores, ids = np.atleast_2d(scores), np.atleast_2d(ids)
    ref_scores, ref_ids = np.atleast_2d(ref_scores), np.atleast_2d(ref_ids)
    if scores.shape != ref_scores.shape or ids.shape != ref_ids.shape:
        raise AssertionError(
            f"shape {scores.shape}/{ids.shape} != reference "
            f"{ref_scores.shape}/{ref_ids.shape}"
        )
    s = scores.astype(np.float64)
    r = ref_scores.astype(np.float64)
    tol = atol + rtol * np.abs(r)
    err = np.abs(s - r)
    if not np.all(err <= tol):
        row, col = np.argwhere(err > tol)[0]
        raise AssertionError(
            f"score mismatch at [{row}, {col}]: {s[row, col]!r} vs "
            f"{r[row, col]!r}"
        )
    n = r.shape[1]
    for row in range(r.shape[0]):
        if len(set(ids[row].tolist())) != n:
            raise AssertionError(f"row {row}: repeated ids {ids[row]}")
        if q is not None and Y is not None:
            exact = Y[ids[row]].astype(np.float64) @ q[row].astype(np.float64)
            if not np.all(np.abs(s[row] - exact) <= atol + rtol * np.abs(exact)):
                raise AssertionError(
                    f"row {row}: reported scores {s[row]} are not the "
                    f"scores {exact} of ids {ids[row]}"
                )
        start = 0
        while start < n:
            end = start + 1
            while end < n and abs(r[row, end] - r[row, end - 1]) <= tol[row, end - 1]:
                end += 1
            a, b = ids[row, start:end], ref_ids[row, start:end]
            if end < n and set(a.tolist()) != set(b.tolist()):
                raise AssertionError(
                    f"row {row}: ids {a} vs reference {b} in positions "
                    f"[{start}, {end})"
                )
            start = end
    return float(err.max()) if err.size else 0.0
