"""K11, one column block of the iALS++ subspace solver: the counterpart of
the block body of the reference's ``predictionio_tpu/ops/als.py:640
_solve_side_subspace`` (explicit and implicit feedback, float32).

A half-step of ``solver="subspace"`` sweeps the rank's k/b column blocks
B = [s0, s0 + b) in order; block j reads the factors block j−1 has just
written (Gauss–Seidel). Per block:

- ``subspace_accumulate(Y, X, pack, s0, b, implicit, alpha)`` (K11a):
  for every system row, ``A = Σ w_a·y_B y_Bᵀ`` [R, b, b] and
  ``r = Σ (w_b − w_a·d)·y_B`` [R, b] over the row's observations, with
  ``d = y·x`` against the row's current factors (all k columns) and K1's
  weights (explicit ``w_a = 1``, ``w_b = v``; implicit ``w_a = α|v|``,
  ``w_b = 1(v>0)(1 + α|v|)``). With ``compute_dtype="bfloat16"``
  (K11a-bf16, the reference's :680-721): y and the row's current x are
  rounded to bfloat16 as they are read (x in every block, since it changes
  after each), d is summed in float32, A's weight is ``bf16(w_a)`` and the
  residual's ``bf16(w_b − w_a·d)`` from the float32 values;
- ``subspace_block_solve(A, r, X, lam, has_obs, s0, G, sums, last)``
  (K11b): ``δ = (A + G_BB + λI)⁻¹ (r − (G x)_B − λ·x_B)`` per row (G, the
  implicit Gramian, omitted in explicit mode), zero for rows without
  observations, and ``X[:, B] += δ`` in place (the port updates the factor
  array in place, as the reference's loop carry does, without a copy per
  block). Given a 2-float ``sums``, it writes ``[Σ δ², Σ X²]`` there, the
  second only after the sweep's ``last`` block (0 otherwise): the raw sums
  of the block's delta RMS and the factor RMS.

Three forms of each, one function:
- the hand-written CUDA kernels for Hopper, ``csrc/subspace.cu`` (its
  header states the bounds and the design: K1's group plan, fixed-order
  sums, no atomics, so runs repeat bit for bit);
- the plain PyTorch twins ``subspace_accumulate_plain`` (the reference's
  block einsums with ``index_add_``) and ``subspace_block_solve_plain``
  (the reference's epilogue with ``cholesky_solve_plain``);
- the wrappers, which route CPU tensors to the twins and CUDA tensors to
  the kernels (launch or raise, no fallback). ``LAUNCHES`` counts what
  they ran; ``subspace_combine`` counts the launches of K11a's combine
  kernel (rows with several groups), which runs inside K11a's call.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts
from predictionio_tpu_torch.ops.normal_eq import SegmentPack
from predictionio_tpu_torch.ops.precision import in_cdt, is_bf16
from predictionio_tpu_torch.ops.spd_solve import cholesky_solve_plain

SOURCE = "subspace.cu"
_MAX_K = 200  # the largest rank the kernels take (a row's x in registers)

LAUNCHES = LaunchCounts(
    "subspace_accumulate", "subspace_combine", "subspace_block_solve",
    "subspace_accumulate_plain", "subspace_block_solve_plain",
    "subspace_accumulate_bf16", "subspace_accumulate_bf16_plain",
)


def subspace_accumulate_plain(
    Y: torch.Tensor,
    X: torch.Tensor,
    seg_rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    rem: torch.Tensor,
    n_sys_rows: int,
    s0: int,
    b: int,
    implicit: bool = False,
    alpha: float = 1.0,
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin, the reference's block loop (:704-724): per chunk,
    gather ``Y[cols]``, score every slot against its row's current factors,
    weigh, two einsums over the block's columns, and a scatter-add of the
    segments into A [R, b, b] and r [R, b]. In bfloat16 compute y, x and
    the two weights are rounded where the reference casts them."""
    bf16 = is_bf16(compute_dtype)
    Y = in_cdt(Y, bf16)
    L = cols.shape[-1]
    iota = torch.arange(L, device=Y.device)
    A = torch.zeros((n_sys_rows, b, b), dtype=torch.float32, device=Y.device)
    r = torch.zeros((n_sys_rows, b), dtype=torch.float32, device=Y.device)
    for c in range(seg_rows.shape[0]):
        rows_c = seg_rows[c].long()
        mask = (iota[None, :] < rem[c][:, None]).to(torch.float32)
        Yg = Y[cols[c].long()]  # [Sc, L, k]
        Yb = Yg[:, :, s0 : s0 + b]
        d = torch.einsum("slk,sk->sl", Yg, in_cdt(X[rows_c], bf16))
        if implicit:
            aw = alpha * vals[c].abs() * mask
            bw = (vals[c] > 0).to(torch.float32) * mask * (1.0 + alpha * vals[c].abs())
        else:
            aw, bw = mask, vals[c] * mask
        A.index_add_(0, rows_c, torch.einsum("slb,sl,slc->sbc", Yb, in_cdt(aw, bf16), Yb))
        r.index_add_(0, rows_c, torch.einsum("sl,slb->sb", in_cdt(bw - aw * d, bf16), Yb))
    return A, r


def subspace_block_solve_plain(
    A: torch.Tensor,
    r: torch.Tensor,
    X: torch.Tensor,
    lam: torch.Tensor,
    has_obs: torch.Tensor,
    s0: int,
    G: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin, the reference's block epilogue (:725-737): X with
    the block updated in place, and ``[Σ δ², Σ X²]``."""
    b = A.shape[-1]
    xB = X[:, s0 : s0 + b]
    rs = r
    if G is not None:
        GB = G[s0 : s0 + b]  # [b, k]
        A = A + GB[:, s0 : s0 + b][None]
        rs = rs - X @ GB.T  # (G x)_B: G is symmetric
    A = A + lam[:, None, None] * torch.eye(b, dtype=torch.float32, device=A.device)
    rs = rs - lam[:, None] * xB
    delta = cholesky_solve_plain(A, rs)
    delta = torch.where(has_obs[:, None], delta, torch.zeros_like(delta))
    X[:, s0 : s0 + b] = xB + delta
    return X, torch.stack([torch.sum(delta * delta), torch.sum(X * X)])


def _declare(lib: ctypes.CDLL) -> None:
    lib.subspace_accumulate_f32.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.subspace_accumulate_f32.restype = ctypes.c_int
    lib.subspace_solve_blocks.argtypes = [ctypes.c_int] * 2
    lib.subspace_solve_blocks.restype = ctypes.c_int
    lib.subspace_block_solve_f32.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p
    ]
    lib.subspace_block_solve_f32.restype = ctypes.c_int


_LIBRARY = native.Library(SOURCE, _declare, "subspace_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return _LIBRARY.get()


def _check_block(k: int, s0: int, b: int) -> None:
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"rank {k} out of range [1, {_MAX_K}]")
    if b < 1 or k % b or s0 % b or not 0 <= s0 < k:
        raise ValueError(f"block [{s0}, {s0 + b}) is not a block of width {b} dividing rank {k}")


def subspace_accumulate(
    Y: torch.Tensor,
    X: torch.Tensor,
    pack: SegmentPack,
    s0: int,
    b: int,
    implicit: bool = False,
    alpha: float = 1.0,
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11a: A [R, b, b] and r [R, b] float32 of the column block
    [s0, s0 + b) for the side ``pack`` (R = ``pack.n_sys_rows``) against
    the counter-side factors ``Y`` [n, k] and the side's current factors
    ``X`` [R, k], in ``compute_dtype`` (``"bfloat16"``: K11a-bf16).

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    if Y.dim() != 2 or X.dim() != 2 or Y.dtype != torch.float32 or X.dtype != torch.float32:
        raise ValueError("X and Y must be [rows, k] float32")
    k = Y.shape[1]
    _check_block(k, s0, b)
    R = pack.n_sys_rows
    if X.shape != (R, k) or Y.shape[0] < pack.n_cols:
        raise ValueError(
            f"X {tuple(X.shape)} / Y {tuple(Y.shape)} do not match the pack "
            f"({R} rows, ids below {pack.n_cols})"
        )
    tensors = (X, pack.seg_rows, pack.cols, pack.vals, pack.rem)
    if any(t.device != Y.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    bf16 = is_bf16(compute_dtype)
    name = "subspace_accumulate_bf16" if bf16 else "subspace_accumulate"
    if Y.device.type == "cpu":
        LAUNCHES.add(f"{name}_plain")
        return subspace_accumulate_plain(
            Y, X, pack.seg_rows, pack.cols, pack.vals, pack.rem, R, s0, b, implicit, alpha,
            compute_dtype,
        )
    if Y.device.type != "cuda":
        raise ValueError(f"unsupported device {Y.device}")
    if not (Y.is_contiguous() and X.is_contiguous()):
        raise ValueError("X and Y must be contiguous (row-major)")
    lib = load_library()
    plan = pack.plan
    A = torch.empty((R, b, b), dtype=torch.float32, device=Y.device)
    r = torch.empty((R, b), dtype=torch.float32, device=Y.device)
    partials = torch.empty(
        (max(plan.n_partials, 1), b * b + b), dtype=torch.float32, device=Y.device
    )
    n_combine = plan.combine_rows.shape[0]
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream(Y.device).cuda_stream
        err = lib.subspace_accumulate_f32(
            Y.data_ptr(), X.data_ptr(), pack.cols.data_ptr(), pack.vals.data_ptr(),
            pack.rem.data_ptr(), plan.groups.data_ptr(), plan.groups.shape[1],
            plan.combine_rows.data_ptr(), plan.combine_start.data_ptr(), n_combine,
            partials.data_ptr(), A.data_ptr(), r.data_ptr(), k, pack.cols.shape[-1],
            s0, b, int(bool(implicit)), float(alpha), int(bf16), stream,
        )
    _LIBRARY.check(err, name)
    LAUNCHES.add(name)
    if n_combine:
        LAUNCHES.add("subspace_combine")
    return A, r


def subspace_block_solve(
    A: torch.Tensor,
    r: torch.Tensor,
    X: torch.Tensor,
    lam: torch.Tensor,
    has_obs: torch.Tensor,
    s0: int,
    G: Optional[torch.Tensor] = None,
    sums: Optional[torch.Tensor] = None,
    last: bool = False,
) -> torch.Tensor:
    """K11b on A [R, b, b], r [R, b], X [R, k] (updated in place and
    returned), lam [R] float32, has_obs [R] bool and an optional G [k, k];
    see the module docstring.

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    if A.dim() != 3 or A.shape[1] != A.shape[2] or X.dim() != 2:
        raise ValueError(f"A must be [R, b, b] and X [R, k], got {tuple(A.shape)}, {tuple(X.shape)}")
    R, b, k = A.shape[0], A.shape[1], X.shape[1]
    _check_block(k, s0, b)
    for name, t, shape in (("r", r, (R, b)), ("X", X, (R, k)), ("lam", lam, (R,)),
                           ("has_obs", has_obs, (R,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("A", A), ("r", r), ("X", X), ("lam", lam)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if has_obs.dtype != torch.bool:
        raise TypeError(f"has_obs must be bool, got {has_obs.dtype}")
    if G is not None and (tuple(G.shape) != (k, k) or G.dtype != torch.float32):
        raise ValueError(f"G must be a [{k}, {k}] float32 tensor")
    if sums is not None and (sums.shape != (2,) or sums.dtype != torch.float32):
        raise ValueError("sums must be a float32 tensor of 2 elements")
    tensors = [r, X, lam, has_obs] + [t for t in (G, sums) if t is not None]
    if any(t.device != A.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    if A.device.type == "cpu":
        LAUNCHES.add("subspace_block_solve_plain")
        _, s = subspace_block_solve_plain(A, r, X, lam, has_obs, s0, G)
        if sums is not None:
            sums[0] = s[0]
            sums[1] = s[1] if last else 0.0
        return X
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    if not all(t.is_contiguous() for t in [A] + tensors):
        raise ValueError("every tensor must be contiguous")
    lib = load_library()
    partials = None
    if sums is not None:
        partials = torch.empty(
            2 * lib.subspace_solve_blocks(R, b), dtype=torch.float32, device=A.device
        )
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.subspace_block_solve_f32(
            A.data_ptr(), r.data_ptr(), G.data_ptr() if G is not None else None,
            lam.data_ptr(), has_obs.data_ptr(), X.data_ptr(),
            partials.data_ptr() if partials is not None else None,
            sums.data_ptr() if sums is not None else None,
            R, k, s0, b, int(bool(last)), stream,
        )
    _LIBRARY.check(err, "subspace_block_solve")
    LAUNCHES.add("subspace_block_solve")
    return X
