"""K8, the resident delta scatter: the device work of the reference's eager
program ``predictionio_tpu/ops/streaming.py:1036 _fold_delta_resident``
(:1147-1268), which folds a user-sorted delta of ratings on existing ids
into a training pack that stays on the card between rounds:
- ``delta_counts_prefix`` (K8a): the delta's rows per user and per item
  and their exclusive prefixes;
- ``move_and_append`` (K8b): the old COO planes moved to their shifted
  slots in new planes, each delta row appended after its user's old run;
- ``shift_offsets`` (K8c): both sides' CSR offsets shifted, each row's
  last segment count raised by its delta rows, and (weighted
  regularization) the regularizer at the touched rows replaced.
``apply_delta`` runs the three in order on a resident pack's arrays.

Three forms of each, one function:
- the hand-written CUDA kernels for Hopper, ``csrc/delta_scatter.cu`` (its
  header states the bounds and the designs);
- the plain PyTorch twins ``*_plain``, the reference's programs op for op
  (clamped gathers, scatters that drop out-of-range positions, ``cumsum``
  for the prefixes); ids widen to int32 for the arithmetic, as torch cannot
  index with ``uint16``;
- the wrappers, which route CPU tensors to the twins and CUDA tensors to
  the kernels (launch or raise, no fallback). ``LAUNCHES`` counts what
  they ran.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts

SOURCE = "delta_scatter.cu"
_I32_MAX = 2**31 - 1

# kernel launches, and the CPU calls the wrappers routed to the twins
LAUNCHES = LaunchCounts(
    "delta_counts_prefix", "delta_counts_prefix_plain",
    "move_and_append", "move_and_append_plain",
    "shift_offsets", "shift_offsets_plain",
)

_ID_DTYPES = (torch.uint16, torch.int32)
_VAL_DTYPES = (torch.int8, torch.float32)


def _as_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int32 ``x`` as ``dtype``; uint16 through int16's bits (a cast to
    int16 keeps the low 16 bits, which every torch build supports)."""
    if dtype == torch.uint16:
        return x.to(torch.int16).view(torch.uint16)
    return x.to(dtype)


# --- the plain twins ---


def delta_counts_prefix_plain(
    du: torch.Tensor, di: torch.Tensor, n_users: int, n_items: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain K8a: (dense_u [n_users+1], dense_i [n_items+1], sh_u, sh_i)
    int32; ids outside [0, n] are dropped, as the reference's scatter-add
    drops them."""

    def side(ids: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        ids = ids.to(torch.int64)
        ids = ids[(ids >= 0) & (ids <= n)]
        dense = torch.zeros(n + 1, dtype=torch.int32, device=ids.device)
        dense.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
        sh = torch.zeros(n + 1, dtype=torch.int32, device=ids.device)
        sh[1:] = torch.cumsum(dense[:n], 0, dtype=torch.int32)
        return dense, sh

    dense_u, sh_u = side(du, n_users)
    dense_i, sh_i = side(di, n_items)
    return dense_u, dense_i, sh_u, sh_i


def move_and_append_plain(
    i_old: torch.Tensor, v_old: torch.Tensor, su: torch.Tensor,
    sh_u: torch.Tensor, du: torch.Tensor, di: torch.Tensor, dv: torch.Tensor,
    n_users: int, P_new: int, init_id: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain K8b, the reference's marks + cumsum: each old slot's user
    key, its move to ``p + sh_u[key]``, then the delta rows at
    ``su[du+1] + sh_u[du] + rank within the user's run``, into planes of
    ``P_new`` slots filled with ``init_id`` and 0."""
    dev = i_old.device
    P_old = i_old.shape[0]
    S = su.shape[0]
    su64, sh64 = su.to(torch.int64), sh_u.to(torch.int64)
    idx = su64[1:]
    idx = idx[(idx >= 0) & (idx <= P_old)]
    marks = torch.zeros(P_old + 1, dtype=torch.int32, device=dev)
    marks.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    keys = torch.cumsum(marks[:P_old], 0).to(torch.int64)
    new_pos = torch.arange(P_old, dtype=torch.int64, device=dev) + sh64[keys.clamp(0, n_users)]
    keep = (new_pos >= 0) & (new_pos < P_new)
    i_new = torch.full((P_new,), int(init_id), dtype=torch.int32, device=dev)
    v_new = torch.zeros(P_new, dtype=v_old.dtype, device=dev)
    i_new[new_pos[keep]] = i_old.to(torch.int32)[keep]
    v_new[new_pos[keep]] = v_old[keep]
    d = du.shape[0]
    if d:
        du64 = du.to(torch.int64)
        j = torch.arange(d, dtype=torch.int64, device=dev)
        newgrp = torch.ones(d, dtype=torch.bool, device=dev)
        newgrp[1:] = du64[1:] != du64[:-1]
        first = torch.cummax(torch.where(newgrp, j, torch.zeros_like(j)), 0).values
        d_pos = (
            su64[(du64 + 1).clamp(0, S - 1)] + sh64[du64.clamp(0, n_users)] + (j - first)
        )
        keep = (d_pos >= 0) & (d_pos < P_new)
        i_new[d_pos[keep]] = di.to(torch.int32)[keep]
        v_new[d_pos[keep]] = dv[keep]
    return _as_dtype(i_new, i_old.dtype), v_new


def _last_segment_add(seg_rows, seg_base, dense, n):
    seg_rows = seg_rows.to(torch.int64)
    seg_idx = torch.arange(seg_rows.shape[0], dtype=torch.int64, device=seg_rows.device)
    last = (seg_idx + 1) == seg_base.to(torch.int64)[(seg_rows + 1).clamp(0, seg_base.shape[0] - 1)]
    return torch.where(last, dense[seg_rows.clamp(0, n)], torch.zeros_like(dense[:1]))


def _touched(lam, rows, vals):
    if lam is None:
        return None
    out = lam.clone()
    out[rows.to(torch.int64)] = vals
    return out


def shift_offsets_plain(
    su, si, sh_u, sh_i, dense_u, dense_i, n_users, n_items, bu, bi,
    seg_rows_u, rem_u, seg_rows_i, rem_i, lam_u=None, rows_u=None,
    vals_u=None, lam_i=None, rows_i=None, vals_i=None,
):
    """The plain K8c: (su2, si2, rem_u2, rem_i2, lam_u2, lam_i2); the
    regularizers are None unless given (weighted regularization)."""

    def shifted(s, sh, n):
        m = torch.arange(s.shape[0], dtype=torch.int64, device=s.device).clamp(0, n)
        return s + sh[m]

    return (
        shifted(su, sh_u, n_users),
        shifted(si, sh_i, n_items),
        rem_u + _last_segment_add(seg_rows_u, bu, dense_u, n_users),
        rem_i + _last_segment_add(seg_rows_i, bi, dense_i, n_items),
        _touched(lam_u, rows_u, vals_u),
        _touched(lam_i, rows_i, vals_i),
    )


# --- the kernels ---


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.delta_counts_prefix.argtypes = [p, p, i, i, i, i, p, p, p, p, p]
    lib.delta_counts_prefix.restype = i
    lib.move_and_append.argtypes = [
        p, i, p, i, ll, p, i, p, i, p, p, p, i, i, p, p, ll, p,
    ]
    lib.move_and_append.restype = i
    lib.shift_offsets.argtypes = [
        p, i, p, i, p, p, p, p, i, i,  # su, si, prefixes, counts, sizes
        p, i, p, i,  # bu, bi
        p, p, i, p, p, i,  # segment rows and counts
        p, i, p, p, i, p, i, p, p, i,  # regularizers
        p, p, p, p, p, p, p,  # outputs and the stream
    ]
    lib.shift_offsets.restype = i


_LIBRARY = native.Library(SOURCE, _declare, "delta_scatter_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return _LIBRARY.get()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _on_one_device(**named: Optional[torch.Tensor]) -> torch.device:
    ts = {k: t for k, t in named.items() if t is not None}
    dev = next(iter(ts.values())).device
    for name, t in ts.items():
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("every tensor must be on one device")
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None or t.numel() == 0 else t.data_ptr()


def delta_counts_prefix(
    du: torch.Tensor, di: torch.Tensor, n_users: int, n_items: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8a on the delta's ids du [d] int32, di [d] uint16/int32 ->
    (dense_u [n_users+1], dense_i [n_items+1], sh_u [n_users+1],
    sh_i [n_items+1]) int32.

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    if du.dtype != torch.int32 or di.dtype not in _ID_DTYPES:
        raise TypeError(f"du must be int32 and di uint16/int32, got {du.dtype}, {di.dtype}")
    if di.shape != du.shape:
        raise ValueError("du and di must be of one length")
    if not (0 <= n_users < _I32_MAX and 0 <= n_items < _I32_MAX):
        raise ValueError("n_users and n_items must be int32 sizes")
    dev = _on_one_device(du=du, di=di)
    if dev.type == "cpu":
        LAUNCHES.add("delta_counts_prefix_plain")
        return delta_counts_prefix_plain(du, di, n_users, n_items)
    out = [torch.empty(n + 1, dtype=torch.int32, device=dev) for n in (n_users, n_items, n_users, n_items)]
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.delta_counts_prefix(
            _ptr(du), _ptr(di), int(di.dtype == torch.int32), du.shape[0],
            n_users, n_items, *(t.data_ptr() for t in out), _stream(dev),
        )
    _LIBRARY.check(err, "delta_counts_prefix")
    LAUNCHES.add("delta_counts_prefix")
    return tuple(out)


def move_and_append(
    i_old: torch.Tensor, v_old: torch.Tensor, su: torch.Tensor,
    sh_u: torch.Tensor, du: torch.Tensor, di: torch.Tensor, dv: torch.Tensor,
    n_users: int, P_new: int, init_id: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8b: old planes i_old [P_old] uint16/int32 and v_old [P_old]
    int8/float32, the CSR offsets su int32, K8a's sh_u [n_users+1], and the
    delta du [d] int32 (sorted), di [d] and dv [d] of the planes' types ->
    (i_new, v_new) [P_new] of the planes' types.

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    if i_old.dtype not in _ID_DTYPES or v_old.dtype not in _VAL_DTYPES:
        raise TypeError(f"planes must be uint16/int32 and int8/float32, got {i_old.dtype}, {v_old.dtype}")
    if v_old.shape != i_old.shape:
        raise ValueError("i_old and v_old must be of one length")
    if di.dtype != i_old.dtype or dv.dtype != v_old.dtype or du.dtype != torch.int32:
        raise TypeError("du must be int32, di and dv of the planes' types")
    if not (di.shape == du.shape == dv.shape):
        raise ValueError("du, di and dv must be of one length")
    if su.dtype != torch.int32 or su.shape[0] < 1 or sh_u.dtype != torch.int32:
        raise TypeError("su and sh_u must be int32, su non-empty")
    if sh_u.shape[0] != n_users + 1:
        raise ValueError(f"sh_u must hold n_users + 1 = {n_users + 1} entries")
    if max(P_new, i_old.shape[0] + du.shape[0]) > _I32_MAX:
        raise ValueError("planes must stay under 2^31 slots")
    dev = _on_one_device(i_old=i_old, v_old=v_old, su=su, sh_u=sh_u, du=du, di=di, dv=dv)
    if dev.type == "cpu":
        LAUNCHES.add("move_and_append_plain")
        return move_and_append_plain(i_old, v_old, su, sh_u, du, di, dv, n_users, P_new, init_id)
    i_new = torch.empty(P_new, dtype=i_old.dtype, device=dev)
    v_new = torch.empty(P_new, dtype=v_old.dtype, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.move_and_append(
            _ptr(i_old), int(i_old.dtype == torch.int32), _ptr(v_old),
            int(v_old.dtype == torch.float32), i_old.shape[0], su.data_ptr(),
            su.shape[0], sh_u.data_ptr(), n_users, _ptr(du), _ptr(di), _ptr(dv),
            du.shape[0], int(init_id), _ptr(i_new), _ptr(v_new), P_new,
            _stream(dev),
        )
    _LIBRARY.check(err, "move_and_append")
    LAUNCHES.add("move_and_append")
    return i_new, v_new


def shift_offsets(
    su, si, sh_u, sh_i, dense_u, dense_i, n_users, n_items, bu, bi,
    seg_rows_u, rem_u, seg_rows_i, rem_i, lam_u=None, rows_u=None,
    vals_u=None, lam_i=None, rows_i=None, vals_i=None,
):
    """K8c: the offsets su/si, K8a's prefixes and counts, the segment bases
    bu/bi and both sides' segment rows and counts (all int32), and, for
    weighted regularization, the regularizers lam_u/lam_i (float32) with
    their touched rows (int32, sorted, unique) and values -> (su2, si2,
    rem_u2, rem_i2, lam_u2, lam_i2); the regularizers are None unless given.

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    ints = dict(su=su, si=si, sh_u=sh_u, sh_i=sh_i, dense_u=dense_u, dense_i=dense_i,
                bu=bu, bi=bi, seg_rows_u=seg_rows_u, rem_u=rem_u, seg_rows_i=seg_rows_i,
                rem_i=rem_i)
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t, n in (("sh_u", sh_u, n_users), ("dense_u", dense_u, n_users),
                       ("sh_i", sh_i, n_items), ("dense_i", dense_i, n_items)):
        if t.shape[0] != n + 1:
            raise ValueError(f"{name} must hold {n + 1} entries")
    if rem_u.shape != seg_rows_u.shape or rem_i.shape != seg_rows_i.shape:
        raise ValueError("segment rows and counts must be of one length per side")
    if min(bu.shape[0], bi.shape[0]) < 1:
        raise ValueError("bu and bi must be non-empty")
    lams = dict(lam_u=lam_u, rows_u=rows_u, vals_u=vals_u, lam_i=lam_i, rows_i=rows_i, vals_i=vals_i)
    weighted = lam_u is not None
    if any((t is None) == weighted for t in lams.values()):
        raise ValueError("give all six regularizer arguments or none")
    if weighted:
        for side in ("u", "i"):
            lam, rows, vals = lams[f"lam_{side}"], lams[f"rows_{side}"], lams[f"vals_{side}"]
            if lam.dtype != torch.float32 or vals.dtype != torch.float32 or rows.dtype != torch.int32:
                raise TypeError("regularizers and values must be float32, rows int32")
            if rows.shape != vals.shape:
                raise ValueError("touched rows and values must be of one length")
    dev = _on_one_device(**ints, **lams)
    args = (su, si, sh_u, sh_i, dense_u, dense_i, n_users, n_items, bu, bi,
            seg_rows_u, rem_u, seg_rows_i, rem_i, lam_u, rows_u, vals_u, lam_i, rows_i, vals_i)
    if dev.type == "cpu":
        LAUNCHES.add("shift_offsets_plain")
        return shift_offsets_plain(*args)
    su2, si2 = torch.empty_like(su), torch.empty_like(si)
    rem_u2, rem_i2 = torch.empty_like(rem_u), torch.empty_like(rem_i)
    lam_u2 = torch.empty_like(lam_u) if weighted else None
    lam_i2 = torch.empty_like(lam_i) if weighted else None

    def n(t):
        return 0 if t is None else t.shape[0]

    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.shift_offsets(
            su.data_ptr(), n(su), si.data_ptr(), n(si), sh_u.data_ptr(),
            sh_i.data_ptr(), dense_u.data_ptr(), dense_i.data_ptr(), n_users,
            n_items, bu.data_ptr(), n(bu), bi.data_ptr(), n(bi),
            _ptr(seg_rows_u), _ptr(rem_u), n(rem_u), _ptr(seg_rows_i),
            _ptr(rem_i), n(rem_i), _ptr(lam_u), n(lam_u), _ptr(rows_u),
            _ptr(vals_u), n(rows_u), _ptr(lam_i), n(lam_i), _ptr(rows_i),
            _ptr(vals_i), n(rows_i), _ptr(su2), _ptr(si2), _ptr(rem_u2),
            _ptr(rem_i2), _ptr(lam_u2), _ptr(lam_i2), _stream(dev),
        )
    _LIBRARY.check(err, "shift_offsets")
    LAUNCHES.add("shift_offsets")
    return su2, si2, rem_u2, rem_i2, lam_u2, lam_i2


def apply_delta(planes: dict, du, di, dv, n_users: int, n_items: int,
                P_new: int, init_id: int, lam: Optional[dict] = None,
                plain: bool = False) -> dict:
    """K8a, K8b and K8c in order on a resident pack's ``planes`` (a dict
    with ``i_plane``, ``v_plane``, ``su``, ``si``, ``bu``, ``bi``,
    ``seg_rows_u``, ``rem_u``, ``seg_rows_i``, ``rem_i``) and a user-sorted
    delta; ``lam`` (weighted regularization) holds ``lam_u``, ``rows_u``,
    ``vals_u``, ``lam_i``, ``rows_i``, ``vals_i``. Returns the new
    ``i_plane``, ``v_plane``, ``su``, ``si``, ``rem_u``, ``rem_i`` and, with
    ``lam``, ``user_lam`` and ``item_lam``. ``plain`` runs the twins on any
    device (the chip check holds the kernels against them)."""
    k8a = delta_counts_prefix_plain if plain else delta_counts_prefix
    k8b = move_and_append_plain if plain else move_and_append
    k8c = shift_offsets_plain if plain else shift_offsets
    dense_u, dense_i, sh_u, sh_i = k8a(du, di, n_users, n_items)
    i_new, v_new = k8b(planes["i_plane"], planes["v_plane"], planes["su"], sh_u,
                       du, di, dv, n_users, P_new, init_id)
    lam = lam or {}
    su2, si2, rem_u2, rem_i2, lam_u2, lam_i2 = k8c(
        planes["su"], planes["si"], sh_u, sh_i, dense_u, dense_i, n_users, n_items,
        planes["bu"], planes["bi"], planes["seg_rows_u"], planes["rem_u"],
        planes["seg_rows_i"], planes["rem_i"], lam.get("lam_u"), lam.get("rows_u"),
        lam.get("vals_u"), lam.get("lam_i"), lam.get("rows_i"), lam.get("vals_i"),
    )
    out = {"i_plane": i_new, "v_plane": v_new, "su": su2, "si": si2,
           "rem_u": rem_u2, "rem_i": rem_i2}
    if lam:
        out["user_lam"], out["item_lam"] = lam_u2, lam_i2
    return out
