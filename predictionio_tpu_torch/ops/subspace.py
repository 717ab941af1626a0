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

The carried score. Between two blocks of a half-step only the previous
block's columns of X change, so K11a need not form d over all k columns in
every block. ``_solve_side_subspace`` (``ops/als.py``) holds a score
buffer (one float32 a slot, shaped like ``pack.vals``) and a Δ buffer
[R, b], allocated once per training (``CarryBuffers``). Block 0's K11a
forms d over all k columns and writes it to the score buffer
(``score=``); K11b writes ``Δ = x_new − x_old`` over its block's columns
(``delta=``; in bfloat16 compute ``bf16(x_new) − bf16(x_old)``, zeros for
rows without observations); block j ≥ 1's K11a reads
``d = score + y[s0−b:s0]·Δ[row]`` (``score=`` and ``delta=``) and writes it
back, but in the half-step's last block (s0 + b = k), whose score nothing
reads. In
exact arithmetic d is unchanged; in float32 it drifts from a full
recompute by a few roundings a block, which the half-step's factors carry
within the tolerance the tests hold the port to against the reference
(rtol 1e-5, atol 1e-6), and the score within 1e-6 of its row's scale. The
lanes form carries (``carries(k, b)``: k ≤ 64 and b ∈ {1, 2, 4, 8}); the
groups form (any other k and b) forms d anew in every block and takes no
buffer. The twins carry the same way, so the CPU runs the same host logic.

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
from typing import Optional, Sequence, Tuple

import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts
from predictionio_tpu_torch.ops.normal_eq import SegmentPack
from predictionio_tpu_torch.ops.precision import in_cdt, is_bf16
from predictionio_tpu_torch.ops.spd_solve import cholesky_solve_plain

SOURCE = "subspace.cu"
_MAX_K = 200  # the largest rank the kernels take (a row's x in registers)

# the blocks the lanes form takes; the carried score runs only there
_LANES_BLOCKS = (1, 2, 4, 8)
_LANES_MAX_K = 64


def carries(k: int, b: int) -> bool:
    """Whether a half-step of rank ``k`` in blocks of ``b`` carries each
    slot's score across its blocks (the kernels' lanes form, and more than
    one block)."""
    return k <= _LANES_MAX_K and b in _LANES_BLOCKS and k // b > 1


class CarryBuffers:
    """The carried score's buffers of a training: per device one flat
    float32 score buffer and one flat Δ buffer, each sized for the largest
    pack (slots) and side (rows) that device solves, and handed out as
    views shaped for each pack (``views``). Every half-step on a device
    runs in its stream's order, so one pair serves both sides and every row
    shard there. Zeros at first: the twins read a padded slot's score
    (its weights are 0), and never a value that is not a number."""

    def __init__(self, packs: Sequence[SegmentPack], b: int):
        self.b = b
        sizes = {}
        for p in packs:
            slots, rows = sizes.get(p.vals.device, (0, 0))
            sizes[p.vals.device] = (max(slots, p.vals.numel()), max(rows, p.n_sys_rows))
        self._bufs = {
            d: (torch.zeros(slots, dtype=torch.float32, device=d),
                torch.zeros(rows * b, dtype=torch.float32, device=d))
            for d, (slots, rows) in sizes.items()
        }

    def views(self, pack: SegmentPack) -> Tuple[torch.Tensor, torch.Tensor]:
        """(score shaped like ``pack.vals``, Δ [R, b]) on the pack's device."""
        score, delta = self._bufs[pack.vals.device]
        R = pack.n_sys_rows
        return (score[: pack.vals.numel()].view(pack.vals.shape),
                delta[: R * self.b].view(R, self.b))


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
    score: Optional[torch.Tensor] = None,
    delta: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin, the reference's block loop (:704-724): per chunk,
    gather ``Y[cols]``, score every slot against its row's current factors,
    weigh, two einsums over the block's columns, and a scatter-add of the
    segments into A [R, b, b] and r [R, b]. In bfloat16 compute y, x and
    the two weights are rounded where the reference casts them. With
    ``score`` and ``delta`` the score is carried (the module docstring):
    ``d = score + y[s0−b:s0]·Δ[row]``, written back but in the last block;
    with ``score`` alone it is formed and written there."""
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
        if delta is None:
            d = torch.einsum("slk,sk->sl", Yg, in_cdt(X[rows_c], bf16))
        else:
            d = score[c] + torch.einsum("slb,sb->sl", Yg[:, :, s0 - b : s0], delta[rows_c])
        if score is not None and s0 + b < Y.shape[1]:
            score[c] = d
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
    delta: Optional[torch.Tensor] = None,
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin, the reference's block epilogue (:725-737): X with
    the block updated in place, and ``[Σ δ², Σ X²]``; given ``delta``
    ([R, b]), the block's change of X written there (the module
    docstring)."""
    b = A.shape[-1]
    xB = X[:, s0 : s0 + b].clone()
    rs = r
    if G is not None:
        GB = G[s0 : s0 + b]  # [b, k]
        A = A + GB[:, s0 : s0 + b][None]
        rs = rs - X @ GB.T  # (G x)_B: G is symmetric
    A = A + lam[:, None, None] * torch.eye(b, dtype=torch.float32, device=A.device)
    rs = rs - lam[:, None] * xB
    step = torch.where(has_obs[:, None], cholesky_solve_plain(A, rs), torch.zeros_like(xB))
    x_new = xB + step
    X[:, s0 : s0 + b] = x_new
    if delta is not None:
        bf16 = is_bf16(compute_dtype)
        delta.copy_(in_cdt(x_new, bf16) - in_cdt(xB, bf16))
    return X, torch.stack([torch.sum(step * step), torch.sum(X * X)])


def _declare(lib: ctypes.CDLL) -> None:
    lib.subspace_accumulate_f32.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.subspace_accumulate_f32.restype = ctypes.c_int
    lib.subspace_solve_blocks.argtypes = [ctypes.c_int] * 2
    lib.subspace_solve_blocks.restype = ctypes.c_int
    lib.subspace_block_solve_f32.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
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
    score: Optional[torch.Tensor] = None,
    delta: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11a: A [R, b, b] and r [R, b] float32 of the column block
    [s0, s0 + b) for the side ``pack`` (R = ``pack.n_sys_rows``) against
    the counter-side factors ``Y`` [n, k] and the side's current factors
    ``X`` [R, k], in ``compute_dtype`` (``"bfloat16"``: K11a-bf16). With
    ``score`` (float32 shaped like ``pack.vals``) each slot's score is
    written there (block 0); with ``score`` and ``delta`` ([R, b], the
    previous block's change of X as K11b writes it; s0 ≥ b) it is carried
    instead, and written back but in the half-step's last block (the module
    docstring).
    Only where ``carries(k, b)``.

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
    tensors = [X, pack.seg_rows, pack.cols, pack.vals, pack.rem]
    if score is not None or delta is not None:
        if not carries(k, b):
            raise ValueError(f"rank {k} in blocks of {b} carries no score")
        if score is None or tuple(score.shape) != tuple(pack.vals.shape) or (
                score.dtype != torch.float32):
            raise ValueError(f"score must be a float32 tensor of {tuple(pack.vals.shape)}")
        if delta is not None and (tuple(delta.shape) != (R, b) or delta.dtype != torch.float32
                                  or s0 < b):
            raise ValueError(f"delta must be a float32 [{R}, {b}] tensor, after block 0")
        tensors += [t for t in (score, delta) if t is not None]
    if any(t.device != Y.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    bf16 = is_bf16(compute_dtype)
    name = "subspace_accumulate_bf16" if bf16 else "subspace_accumulate"
    if Y.device.type == "cpu":
        LAUNCHES.add(f"{name}_plain")
        return subspace_accumulate_plain(
            Y, X, pack.seg_rows, pack.cols, pack.vals, pack.rem, R, s0, b, implicit, alpha,
            compute_dtype, score, delta,
        )
    if Y.device.type != "cuda":
        raise ValueError(f"unsupported device {Y.device}")
    if not all(t.is_contiguous() for t in [Y, X] + [t for t in (score, delta) if t is not None]):
        raise ValueError("X, Y, score and delta must be contiguous (row-major)")
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
            s0, b, int(bool(implicit)), float(alpha), int(bf16),
            score.data_ptr() if score is not None else None,
            delta.data_ptr() if delta is not None else None, int(s0 + b < k), stream,
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
    delta: Optional[torch.Tensor] = None,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """K11b on A [R, b, b], r [R, b], X [R, k] (updated in place and
    returned), lam [R] float32, has_obs [R] bool and an optional G [k, k];
    see the module docstring. Given ``delta`` ([R, b] float32) it writes
    the block's change of X there, in ``compute_dtype`` (the carried
    score's Δ).

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
    if delta is not None and (tuple(delta.shape) != (R, b) or delta.dtype != torch.float32):
        raise ValueError(f"delta must be a float32 [{R}, {b}] tensor")
    bf16 = is_bf16(compute_dtype)
    tensors = [r, X, lam, has_obs] + [t for t in (G, sums, delta) if t is not None]
    if any(t.device != A.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    if A.device.type == "cpu":
        LAUNCHES.add("subspace_block_solve_plain")
        _, s = subspace_block_solve_plain(A, r, X, lam, has_obs, s0, G, delta, compute_dtype)
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
            delta.data_ptr() if delta is not None else None,
            R, k, s0, b, int(bool(last)), int(bf16), stream,
        )
    _LIBRARY.check(err, "subspace_block_solve")
    LAUNCHES.add("subspace_block_solve")
    return X
