"""K1, the per-row normal equations of one ALS half-step: the counterpart
of the reference's ``predictionio_tpu/ops/als.py:481 _accumulate_systems``
(explicit and implicit feedback, float32 and bfloat16 compute).

For every system row r it forms ``A[r] = Σ w_a·y yᵀ`` and
``b[r] = Σ w_b·y`` over the row's observations, where y is the counter-side
factor row ``Y[col]`` and v the rating: explicit ``w_a = 1``, ``w_b = v``;
implicit (the reference's :521-530) ``w_a = α·|v|``,
``w_b = 1(v>0)·(1 + α·|v|)``, so a dislike (v < 0) adds confidence to A and
nothing to b. The observations arrive in the packed segment layout of
``ops/als.py pack_segments``: fixed-width segments of L slots, each
segment's valid slots a prefix (``rem``), a row's segments consecutive,
padding segments pointing at the sentinel row.

With ``compute_dtype="bfloat16"`` (K1-bf16) the function is the
reference's bfloat16 form: Y and the weights are rounded to bfloat16 where
the reference casts them (:506, :528-534; explicit ``w_b = bf16(v)``,
implicit ``w_a = bf16(α·|v|)``, ``w_b = bf16(1(v>0)·(1 + α·|v|))``) and
every product of two such values is formed exactly and summed in float32.
The float32 factors stay float32; A and b are float32.

Three forms, one function:
- the hand-written CUDA kernel for Hopper, ``csrc/normal_eq.cu`` (its header
  states the bound and the design). It walks a host-built ``GroupPlan``:
  groups of up to ``GROUP_SEGMENTS`` consecutive segments of one row, so a
  heavy row (8,531 segments for the most rated ML-20M item) is spread over
  many blocks and combined in a fixed order, never with atomics. At
  k <= 16 it runs a form sized to the rank, whose lanes own the lower
  triangle and b by the plan ``small_form_plan(k, V)`` builds (the kernel
  reads that plan as it is: ``SmallFormPlan.cells``); at 17 <= k <= 32 it
  forms A with warp MMAs on bfloat16 parts of the rows (float32: three
  parts a value, exact, six products; K1-bf16: the rows of
  ``bf16_rows(Y)``, one product, two in implicit mode), b on the CUDA
  cores;
- the plain PyTorch twin ``normal_eq_plain``, the reference's chunked
  gather + einsum + scatter-add, which takes the segments as they are;
- the wrapper ``normal_eq``, which routes CPU tensors to the twin and CUDA
  tensors to the kernel (launch or raise, no fallback). ``LAUNCHES``
  counts what it ran.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from array import array
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts
from predictionio_tpu_torch.ops.precision import in_cdt, is_bf16

SOURCE = "normal_eq.cu"
# segments one kernel block accumulates before it writes a row (or a
# partial of a longer row)
GROUP_SEGMENTS = 8
_MAX_K = 1024  # the largest k whose staged rows fit in shared memory

# "normal_eq": kernel launches; "normal_eq_plain": CPU calls the wrapper
# routed to the plain twin; "*_bf16*": the same in bfloat16 compute
LAUNCHES = LaunchCounts("normal_eq", "normal_eq_plain", "normal_eq_bf16", "normal_eq_bf16_plain")


@dataclasses.dataclass
class GroupPlan:
    """Which segments each K1 block sums, for one packed side.

    ``groups[:, g]`` is (row, first segment, segment count, partial slot)
    of group g. Every row 0..n_sys_rows-1 has at least one group (a row
    without observations has one empty group, which writes its zeros). A
    row with one group writes A/b directly (slot -1); a row with several
    writes partials to consecutive slots, which ``combine_start`` delimits
    for the rows in ``combine_rows``, summed in slot order."""

    groups: torch.Tensor  # [4, G] int32
    combine_rows: torch.Tensor  # [M] int32
    combine_start: torch.Tensor  # [M + 1] int32
    n_partials: int
    n_sys_rows: int


@dataclasses.dataclass
class SegmentPack:
    """One solve side's packed segments on a device, as K1 takes them
    (``ops/als.py PackedSide`` plus its ``GroupPlan``)."""

    seg_rows: torch.Tensor  # [C, Sc] int32 row of each segment
    cols: torch.Tensor  # [C, Sc, L] int32 counter-side ids
    vals: torch.Tensor  # [C, Sc, L] float32 ratings
    rem: torch.Tensor  # [C, Sc] int32 valid slots per segment (a prefix)
    plan: GroupPlan
    n_cols: int  # every col id is below this

    @property
    def n_sys_rows(self) -> int:
        return self.plan.n_sys_rows


def plan_groups(
    seg_rows: np.ndarray, rem: np.ndarray, n_sys_rows: int,
    group: int = GROUP_SEGMENTS,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The group plan of a packed side from its segment rows and counts:
    (groups [4, G], combine_rows [M], combine_start [M+1], n_partials), all
    int32. Segments with no valid slot (the padding) are left out. Raises
    if a row's segments are not consecutive."""
    seg_rows = np.asarray(seg_rows, np.int64).reshape(-1)
    rem = np.asarray(rem, np.int64).reshape(-1)
    R = int(n_sys_rows)
    real = np.flatnonzero(rem > 0)
    rows = seg_rows[real]
    if len(rows) and (rows.min() < 0 or rows.max() >= R):
        raise ValueError(f"segment rows out of range [0, {R})")
    if np.any(np.diff(rows) < 0):
        raise ValueError("segments are not ordered by row")
    nseg = np.bincount(rows, minlength=R)
    first = np.searchsorted(rows, np.arange(R))
    has = nseg > 0
    seg0 = np.zeros(R, np.int64)
    seg0[has] = real[first[has]]
    if np.any(real[first[has] + nseg[has] - 1] - seg0[has] != nseg[has] - 1):
        raise ValueError("a row's segments are not consecutive")
    ngroups = np.maximum(1, -(-nseg // group))
    g_row = np.repeat(np.arange(R), ngroups)
    g_first = np.zeros(R + 1, np.int64)
    np.cumsum(ngroups, out=g_first[1:])
    gi = np.arange(len(g_row)) - g_first[g_row]
    g_seg0 = seg0[g_row] + gi * group
    g_nseg = np.minimum(group, nseg[g_row] - gi * group)
    multi = ngroups > 1
    in_multi = multi[g_row]
    g_slot = np.full(len(g_row), -1, np.int64)
    g_slot[in_multi] = np.arange(int(in_multi.sum()))
    combine_rows = np.flatnonzero(multi)
    combine_start = np.zeros(len(combine_rows) + 1, np.int64)
    np.cumsum(ngroups[multi], out=combine_start[1:])
    groups = np.stack([g_row, g_seg0, g_nseg, g_slot]).astype(np.int32)
    return (
        groups, combine_rows.astype(np.int32),
        combine_start.astype(np.int32), int(in_multi.sum()),
    )


def upload_pack(
    seg_rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    rem: np.ndarray,
    plan: Tuple[np.ndarray, np.ndarray, np.ndarray, int],
    n_sys_rows: int,
    n_cols: int,
    device: torch.device,
) -> SegmentPack:
    """Check a host-packed side and upload it with its ``plan_groups``
    plan."""
    cols = np.asarray(cols, np.int32)
    rem = np.asarray(rem, np.int32)
    if (
        cols.ndim != 3 or np.shape(seg_rows) != cols.shape[:2]
        or np.shape(vals) != cols.shape or rem.shape != cols.shape[:2]
    ):
        raise ValueError("seg_rows/rem must be [C, Sc] and cols/vals [C, Sc, L]")
    if cols.size and (cols.min() < 0 or cols.max() >= n_cols):
        raise ValueError(f"column ids out of range [0, {n_cols})")
    if rem.size and (rem.min() < 0 or rem.max() > cols.shape[2]):
        raise ValueError(f"rem out of range [0, {cols.shape[2]}]")

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return pack_from_planes(
        seg_rows, up(cols, np.int32), up(vals, np.float32), rem, plan,
        n_sys_rows, n_cols,
    )


def pack_from_planes(
    seg_rows: np.ndarray,
    cols: torch.Tensor,
    vals: torch.Tensor,
    rem: np.ndarray,
    plan: Tuple[np.ndarray, np.ndarray, np.ndarray, int],
    n_sys_rows: int,
    n_cols: int,
) -> SegmentPack:
    """A side whose ``cols``/``vals`` planes ([C, Sc, L] int32/float32) are
    already on their device, as the device pack builds them: the host
    geometry (``seg_rows``, ``rem``) and the ``plan_groups`` plan go up
    beside them. The planes are not read back: the caller has checked the
    ids on the host."""
    device = cols.device
    if (
        cols.dim() != 3 or vals.shape != cols.shape
        or np.shape(seg_rows) != tuple(cols.shape[:2])
        or np.shape(rem) != tuple(cols.shape[:2])
    ):
        raise ValueError("seg_rows/rem must be [C, Sc] and cols/vals [C, Sc, L]")
    if cols.dtype != torch.int32 or vals.dtype != torch.float32 or vals.device != device:
        raise ValueError("cols/vals must be int32/float32 on one device")
    groups, c_rows, c_start, n_partials = plan

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return SegmentPack(
        seg_rows=up(seg_rows, np.int32),
        cols=cols,
        vals=vals,
        rem=up(rem, np.int32),
        plan=GroupPlan(
            groups=up(groups, np.int32),
            combine_rows=up(c_rows, np.int32),
            combine_start=up(c_start, np.int32),
            n_partials=int(n_partials),
            n_sys_rows=int(n_sys_rows),
        ),
        n_cols=int(n_cols),
    )


def normal_eq_plain(
    Y: torch.Tensor,
    seg_rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    rem: torch.Tensor,
    n_sys_rows: int,
    implicit: bool = False,
    alpha: float = 1.0,
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin, the reference's loop: per chunk, gather
    ``Y[cols]`` [Sc, L, k], mask the slots past ``rem``, weigh them, two
    einsums, and a scatter-add of the segments into A [R, k, k] and
    b [R, k]. In bfloat16 compute Y and the weights are rounded where the
    reference casts them; the float32 products of the rounded values are
    exact."""
    bf16 = is_bf16(compute_dtype)
    Y = in_cdt(Y, bf16)
    k = Y.shape[1]
    L = cols.shape[-1]
    iota = torch.arange(L, device=Y.device)
    A = torch.zeros((n_sys_rows, k, k), dtype=torch.float32, device=Y.device)
    b = torch.zeros((n_sys_rows, k), dtype=torch.float32, device=Y.device)
    for c in range(seg_rows.shape[0]):
        rows_c = seg_rows[c].long()
        mask = (iota[None, :] < rem[c][:, None]).to(torch.float32)
        Yg = Y[cols[c].long()]  # [Sc, L, k]
        if implicit:
            conf = alpha * vals[c].abs()
            aw = in_cdt(conf * mask, bf16)
            bw = in_cdt((vals[c] > 0).to(torch.float32) * mask * (1.0 + conf), bf16)
        else:
            aw, bw = mask, in_cdt(vals[c] * mask, bf16)
        A_seg = torch.einsum("slk,sl,slj->skj", Yg, aw, Yg)
        b_seg = torch.einsum("slk,sl->sk", Yg, bw)
        A.index_add_(0, rows_c, A_seg)
        b.index_add_(0, rows_c, b_seg)
    return A, b


SMALL_MAX_K = 16  # the largest rank the sized form takes
SMALL_UNITS = (1, 2, 3, 4, 8)  # the units a lane may own (the kernel's instantiations)


class SmallFormPlan(NamedTuple):
    """The k <= 16 form's lane plan for rank ``k`` and ``V`` variants.

    A warp takes one group and ``VW`` of its variants (``batches`` warps a
    group). Lane l owns ``lanes[l] = (v, ti, j0, n)``: units j0..j0+n-1 of
    variant v's row group ti (rows 4·ti..4·ti+3), where unit j below
    ``min(k, 4·ti + 4)`` sums column j of those rows of A (its entries on
    or below the diagonal are kept) and unit ``min(k, 4·ti + 4)`` sums their
    entries of b; n = 0 is an idle lane. ``U`` is the most units a lane
    owns. ``cells`` is the plan as the kernel takes it: U, VW, then each
    lane packed as v | ti << 8 | j0 << 16 | n << 24 (int32)."""

    k: int
    V: int
    U: int
    VW: int
    batches: int
    lanes: Tuple[Tuple[int, int, int, int], ...]
    cells: "array"


def _lanes_needed(k: int, VW: int, U: int) -> int:
    T = -(-k // 4)
    return VW * sum(-(-(min(k, 4 * t + 4) + 1) // U) for t in range(T))


@functools.lru_cache(maxsize=None)
def small_form_plan(k: int, V: int) -> SmallFormPlan:
    """The sized form's plan (see ``SmallFormPlan``): as many variants a
    warp as fit 32 floats of gathered rows a slot (VW·kp <= 32, kp = k
    rounded up to 4) and 32 lanes, then the fewest units a lane, U, from
    ``SMALL_UNITS``. A pure function of (k, V), memoised."""
    if not 1 <= k <= SMALL_MAX_K or V < 1:
        raise ValueError(f"the sized form takes 1 <= k <= {SMALL_MAX_K} and V >= 1, got k={k}, V={V}")
    kp = -(-k // 4) * 4
    for VW in range(min(V, 32 // kp), 0, -1):
        U = next((u for u in SMALL_UNITS if _lanes_needed(k, VW, u) <= 32), None)
        if U is not None:
            break
    lanes = []
    for v in range(VW):
        for t in range(-(-k // 4)):
            m = min(k, 4 * t + 4) + 1
            lanes += [(v, t, j0, min(U, m - j0)) for j0 in range(0, m, U)]
    lanes += [(0, 0, 0, 0)] * (32 - len(lanes))
    cells = array("i", [U, VW] + [v | t << 8 | j0 << 16 | n << 24 for v, t, j0, n in lanes])
    return SmallFormPlan(k, V, U, VW, -(-V // VW), tuple(lanes), cells)


def small_plan_address(k: int, V: int) -> Optional[int]:
    """The address of ``small_form_plan(k, V).cells`` for a kernel call
    (None above ``SMALL_MAX_K``, where the kernels do not read it)."""
    return small_form_plan(k, V).cells.buffer_info()[0] if k <= SMALL_MAX_K else None


MMA_MIN_K, MMA_MAX_K = 17, 32  # the ranks of the warp-MMA form


def bf16_rows(Y: torch.Tensor) -> Optional[torch.Tensor]:
    """K1-bf16's rows for the warp-MMA form: ``Y`` ([n, k] or [V, n, k])
    rounded to bfloat16 once, as the reference's :506 casts Y before its
    einsum, with each row padded with zeros to a multiple of 8 entries
    (16 bytes). None outside ``MMA_MIN_K <= k <= MMA_MAX_K``, where the
    kernels round each gathered row themselves."""
    k = Y.shape[-1]
    if not MMA_MIN_K <= k <= MMA_MAX_K:
        return None
    Yh = Y.to(torch.bfloat16)
    pad = -k % 8
    return torch.nn.functional.pad(Yh, (0, pad)) if pad else Yh


def _declare(lib: ctypes.CDLL) -> None:
    lib.normal_eq_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] + [
        ctypes.c_void_p
    ] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p
    ]
    lib.normal_eq_f32.restype = ctypes.c_int


_LIBRARY = native.Library(SOURCE, _declare, "normal_eq_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    return _LIBRARY.get()


def _check(Y: torch.Tensor, pack: SegmentPack) -> None:
    if Y.dim() != 2 or Y.dtype != torch.float32 or not 1 <= Y.shape[1] <= _MAX_K:
        raise ValueError(
            f"Y must be [n, k] float32 with 1 <= k <= {_MAX_K}, got "
            f"{tuple(Y.shape)} {Y.dtype}"
        )
    if Y.shape[0] < pack.n_cols:
        raise ValueError(f"Y has {Y.shape[0]} rows; the pack's ids reach {pack.n_cols}")
    for name in ("seg_rows", "cols", "vals", "rem"):
        if getattr(pack, name).device != Y.device:
            raise ValueError(f"pack.{name} is on {getattr(pack, name).device}, Y on {Y.device}")


def normal_eq(
    Y: torch.Tensor, pack: SegmentPack, implicit: bool = False, alpha: float = 1.0,
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: A [R, k, k] and b [R, k] float32 for the side ``pack`` against
    the counter-side factors ``Y`` [n, k] (R = ``pack.n_sys_rows``), with
    the implicit weights and confidence scale ``alpha`` when ``implicit``,
    in ``compute_dtype`` (``"bfloat16"``: K1-bf16).

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    _check(Y, pack)
    bf16 = is_bf16(compute_dtype)
    name = "normal_eq_bf16" if bf16 else "normal_eq"
    R = pack.n_sys_rows
    if Y.device.type == "cpu":
        LAUNCHES.add(f"{name}_plain")
        return normal_eq_plain(
            Y, pack.seg_rows, pack.cols, pack.vals, pack.rem, R, implicit, alpha,
            compute_dtype,
        )
    if Y.device.type != "cuda":
        raise ValueError(f"unsupported device {Y.device}")
    if not Y.is_contiguous():
        raise ValueError("Y must be contiguous (row-major)")
    lib = load_library()
    k = Y.shape[1]
    L = pack.cols.shape[-1]
    plan = pack.plan
    A = torch.empty((R, k, k), dtype=torch.float32, device=Y.device)
    b = torch.empty((R, k), dtype=torch.float32, device=Y.device)
    partials = torch.empty(
        (max(plan.n_partials, 1), k * k + k), dtype=torch.float32, device=Y.device
    )
    Yh = bf16_rows(Y) if bf16 else None
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream(Y.device).cuda_stream
        err = lib.normal_eq_f32(
            Y.data_ptr(), None if Yh is None else Yh.data_ptr(),
            pack.cols.data_ptr(), pack.vals.data_ptr(),
            pack.rem.data_ptr(), plan.groups.data_ptr(), plan.groups.shape[1],
            plan.combine_rows.data_ptr(), plan.combine_start.data_ptr(),
            plan.combine_rows.shape[0], partials.data_ptr(), A.data_ptr(),
            b.data_ptr(), k, L, int(bool(implicit)), float(alpha), int(bf16),
            small_plan_address(k, 1), stream,
        )
    _LIBRARY.check(err, name)
    LAUNCHES.add(name)
    return A, b
