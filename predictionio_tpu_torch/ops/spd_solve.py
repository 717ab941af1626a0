"""K2, the batched SPD solve of an ALS half-step: the counterpart of the
reference's ``predictionio_tpu/ops/als.py:549 _spd_solve`` with the
epilogue of ``:612 _solve_side`` (regularizer on the diagonal, rows without
observations keep their previous factors).

``spd_solve(A, b, lam, has_obs, X_prev, sums, G)`` returns X [R, k]:
``X[r] = has_obs[r] ? (A[r] + G + lam[r]·I)⁻¹ b[r] : X_prev[r]``, where
``G`` is an optional [k, k] matrix added to every system (implicit
feedback's shared Gramian YᵀY, the reference's :630-632; none means
zero). Given a
2-float ``sums`` tensor it also writes ``[Σ (X − X_prev)², Σ X²]`` there,
the sweep telemetry's raw sums (the reference's RMS over the padded
arrays). Given ``out`` ([R, k] float32, not overlapping ``X_prev``), X is
written there: a row shard of a mesh (``ops/als.py``) solves its rows into
its range of the next factor array.

Three forms, one function:
- the hand-written CUDA kernel for Hopper, ``csrc/spd_solve.cu`` (its
  header states the bound and the design): in registers for k <= 32, a
  group of 8 lanes a system for k <= 8 and of 16 for k <= 16, one warp a
  system to 32, and in shared memory above (``solve_form``);
- the plain PyTorch twin ``spd_solve_plain``: the reference's vectorized
  in-place Cholesky with fused forward substitution, step by step over
  the whole batch, then back substitution and the select;
- the wrapper ``spd_solve``, which routes CPU tensors to the twin and CUDA
  tensors to the kernel (launch or raise, no fallback). ``LAUNCHES``
  counts what it ran.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts
from predictionio_tpu_torch.ops.topn import check_out

SOURCE = "spd_solve.cu"
_MAX_K = 200  # the largest k whose per-warp matrix fits in shared memory

# "spd_solve": kernel launches; "spd_solve_plain": CPU calls the wrapper
# routed to the plain twin
LAUNCHES = LaunchCounts("spd_solve", "spd_solve_plain")


def solve_form(k: int) -> Tuple[str, int]:
    """The kernel ``csrc/spd_solve.cuh``'s ``k2::launch`` takes for systems
    of size k, and the systems a warp holds: ``("small8", 4)`` for k <= 8,
    ``("small16", 2)`` for k <= 16 (``spd_solve_small``), ``("rows32", 1)``
    for k <= 32, ``("rows", 1)`` above. K2 and K13b (every variant and row
    shard) run the same choice."""
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"k={k} out of range [1, {_MAX_K}]")
    if k <= 8:
        return "small8", 4
    if k <= 16:
        return "small16", 2
    return ("rows32", 1) if k <= 32 else ("rows", 1)


def cholesky_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's ``_spd_solve`` in PyTorch: k steps, each a column
    rescale by the pivot's rsqrt, a forward-substitution step and a rank-1
    update over the whole batch; then k back-substitution steps."""
    n = A.shape[-1]
    idx = torch.arange(n, device=A.device)
    y = torch.zeros_like(b)
    dinv = torch.zeros_like(b)
    r = b.clone()
    for j in range(n):
        col = A[:, :, j]
        d = torch.rsqrt(col[:, j])
        col = torch.where(idx[None, :] >= j, col * d[:, None], 0.0)
        yj = r[:, j] * d
        r = r - col * yj[:, None]
        y[:, j] = yj
        dinv[:, j] = d
        A = torch.where(
            idx[None, None, :] == j,
            col[:, :, None],
            A - col[:, :, None] * col[:, None, :],
        )
    x = torch.zeros_like(b)
    for j in range(n - 1, -1, -1):
        s = torch.sum(A[:, :, j] * x, dim=-1)
        x[:, j] = (y[:, j] - s) * dinv[:, j]
    return x


def spd_solve_plain(
    A: torch.Tensor,
    b: torch.Tensor,
    lam: torch.Tensor,
    has_obs: torch.Tensor,
    X_prev: torch.Tensor,
    G: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin: (X, [Σ (X − X_prev)², Σ X²])."""
    k = A.shape[-1]
    eye = torch.eye(k, dtype=torch.float32, device=A.device)
    if G is not None:
        A = A + G[None]
    x = cholesky_solve_plain(A + lam[:, None, None] * eye, b)
    X = torch.where(has_obs[:, None], x, X_prev)
    d = X - X_prev
    return X, torch.stack([torch.sum(d * d), torch.sum(X * X)])


def _declare(lib: ctypes.CDLL) -> None:
    lib.spd_solve_blocks.argtypes = [ctypes.c_int] * 2
    lib.spd_solve_blocks.restype = ctypes.c_int
    lib.spd_solve_f32.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p
    ]
    lib.spd_solve_f32.restype = ctypes.c_int


_LIBRARY = native.Library(SOURCE, _declare, "spd_solve_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    return _LIBRARY.get()


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors' memory ranges meet."""
    if a.device != b.device or a.numel() == 0 or b.numel() == 0:
        return False
    a0, b0 = a.data_ptr(), b.data_ptr()
    a1 = a0 + a.numel() * a.element_size()
    b1 = b0 + b.numel() * b.element_size()
    return a0 < b1 and b0 < a1


def check_solve_out(out: Optional[torch.Tensor], X_prev: torch.Tensor) -> None:
    """``out`` must be a contiguous float32 tensor of ``X_prev``'s shape on
    its device whose memory does not meet ``X_prev``'s (the kernels read
    X_prev while they write X)."""
    check_out(out, X_prev.shape, X_prev.device)
    if out is not None and overlaps(out, X_prev):
        raise ValueError("out must not overlap X_prev")


def _check(A, b, lam, has_obs, X_prev, sums, G) -> None:
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"A must be [R, k, k], got {tuple(A.shape)}")
    R, k = A.shape[0], A.shape[1]
    if not 1 <= R < 2**31 or not 1 <= k <= _MAX_K:
        raise ValueError(f"R={R} or k={k} out of range (1 <= k <= {_MAX_K})")
    for name, t, shape in (
        ("b", b, (R, k)), ("lam", lam, (R,)), ("has_obs", has_obs, (R,)),
        ("X_prev", X_prev, (R, k)),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("A", A), ("b", b), ("lam", lam), ("X_prev", X_prev)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if has_obs.dtype != torch.bool:
        raise TypeError(f"has_obs must be bool, got {has_obs.dtype}")
    tensors = [A, b, lam, has_obs, X_prev] + [t for t in (sums, G) if t is not None]
    if any(t.device != A.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    if G is not None and (tuple(G.shape) != (k, k) or G.dtype != torch.float32):
        raise ValueError(f"G must be a [{k}, {k}] float32 tensor")
    if sums is not None and (sums.shape != (2,) or sums.dtype != torch.float32):
        raise ValueError("sums must be a float32 tensor of 2 elements")


def spd_solve(
    A: torch.Tensor,
    b: torch.Tensor,
    lam: torch.Tensor,
    has_obs: torch.Tensor,
    X_prev: torch.Tensor,
    sums: Optional[torch.Tensor] = None,
    G: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K2 on A [R, k, k], b [R, k], lam [R] float32, has_obs [R] bool,
    X_prev [R, k] float32 and an optional G [k, k] float32 -> X [R, k]
    (``out`` when given); see the module docstring.

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    _check(A, b, lam, has_obs, X_prev, sums, G)
    check_solve_out(out, X_prev)
    if A.device.type == "cpu":
        LAUNCHES.add("spd_solve_plain")
        X, s = spd_solve_plain(A, b, lam, has_obs, X_prev, G)
        if sums is not None:
            sums.copy_(s)
        if out is None:
            return X
        out.copy_(X)
        return out
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    if not all(
        t.is_contiguous() for t in (A, b, lam, has_obs, X_prev)
    ) or any(t is not None and not t.is_contiguous() for t in (sums, G)):
        raise ValueError("every tensor must be contiguous")
    lib = load_library()
    R, k = A.shape[0], A.shape[1]
    X = out if out is not None else torch.empty((R, k), dtype=torch.float32, device=A.device)
    partials = None
    if sums is not None:
        partials = torch.empty(
            2 * lib.spd_solve_blocks(R, k), dtype=torch.float32, device=A.device
        )
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.spd_solve_f32(
            A.data_ptr(), G.data_ptr() if G is not None else None,
            b.data_ptr(), lam.data_ptr(), has_obs.data_ptr(),
            X_prev.data_ptr(), X.data_ptr(),
            partials.data_ptr() if partials is not None else None,
            sums.data_ptr() if sums is not None else None,
            R, k, stream,
        )
    _LIBRARY.check(err, "spd_solve")
    LAUNCHES.add("spd_solve")
    return X
