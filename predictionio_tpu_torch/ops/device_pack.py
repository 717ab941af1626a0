"""K4, K5a and K5b, the device side of the single-device training wire: the
counterparts of the reference's ``predictionio_tpu/ops/als.py:407
_unpack_nibbles``, ``:416 _device_pack_presorted`` and ``:449
_device_scatter_pack``.

The wire (``ops/als.py HostWire``) is the COO presorted by user with
narrowed item ids and values and each side's CSR offsets; these programs
turn it into both sides' padded segment planes on the card:
- ``unpack_nibbles``: uint8 [m] -> int8 [2m], low nibble first;
- ``device_pack_presorted``: the user side. Row ids rebuild from the CSR
  offsets (``keys[j] = #{m >= 1 : starts[m] <= j}``), then cols and
  ``vals * scale`` scatter into zeroed ``[total * L]`` planes at
  ``flat = (seg_base[key] + offset // L) * L + offset % L``,
  ``offset = j - starts[key]``; returns the keys too, which the item side
  takes as its column values;
- ``device_scatter_pack``: the item side, a stable sort by item key
  carrying (user key, value), then the same scatter.
Gathers clamp and scatters drop out-of-range indices, as the reference's
do, so the sentinel-padded tail of the wire lands in the padding segments
past the last real one, exactly where the reference puts it.

Three forms of each, one function:
- the hand-written CUDA kernels for Hopper, ``csrc/device_pack.cu`` (its
  header states the bounds and the designs; K5b's stable sort is an LSD
  radix sort written there by hand);
- the plain PyTorch twins ``*_plain``, the reference's programs op for op
  (the scatter twin sorts with ``torch.sort(stable=True)``);
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

SOURCE = "device_pack.cu"
RADIX_BITS = 8  # K5b sorts 8 key bits per pass
SORT_TILE = 4096  # elements per block of K5b's passes (csrc TILE)
_I32_MAX = 2**31 - 1

# kernel launches, and the CPU calls the wrappers routed to the twins
LAUNCHES = LaunchCounts(
    "unpack_nibbles", "unpack_nibbles_plain",
    "device_pack_presorted", "device_pack_presorted_plain",
    "device_scatter_pack", "device_scatter_pack_plain",
)


# --- the plain twins ---


def unpack_nibbles_plain(packed: torch.Tensor) -> torch.Tensor:
    """The plain K4: uint8 [m] -> int8 [2m], low nibble to the even index."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    return torch.stack([lo, hi], dim=1).reshape(-1)


def _scatter_plain(
    rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
    starts: torch.Tensor, seg_base: torch.Tensor, total: int, L: int,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's scatter of elements in row order (position j has
    row ``rows[j]``) into zeroed ``[total * L]`` planes: clamped gathers,
    floor division, out-of-range slots dropped."""
    n = rows.shape[0]
    dev = rows.device
    r = rows.long().clamp(0, starts.shape[0] - 1)
    offset = torch.arange(n, dtype=torch.int64, device=dev) - starts.long()[r]
    flat = (
        (seg_base.long()[r] + torch.div(offset, L, rounding_mode="floor")) * L
        + torch.remainder(offset, L)
    )
    keep = (flat >= 0) & (flat < total * L)
    p_cols = torch.zeros(total * L, dtype=torch.int32, device=dev)
    p_vals = torch.zeros(total * L, dtype=torch.float32, device=dev)
    # widened before indexing: CUDA has no indexing of uint16 tensors
    p_cols[flat[keep]] = cols.to(torch.int32)[keep]
    p_vals[flat[keep]] = vals.to(torch.float32)[keep] * scale
    return p_cols, p_vals


def device_pack_presorted_plain(
    cols: torch.Tensor, vals: torch.Tensor, starts: torch.Tensor,
    seg_base: torch.Tensor, total: int, L: int, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain K5a, the reference's indicator cumsum: a mark at each
    ``starts[1:]`` (dropped past n), their running sum the row ids."""
    n = cols.shape[0]
    idx = starts[1:].long()
    idx = idx[(idx >= 0) & (idx <= n)]
    marks = torch.zeros(n + 1, dtype=torch.int32, device=cols.device)
    marks.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    keys = torch.cumsum(marks[:n], 0, dtype=torch.int32)
    p_cols, p_vals = _scatter_plain(keys, cols, vals, starts, seg_base, total, L, scale)
    return keys, p_cols, p_vals


def device_scatter_pack_plain(
    keys: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
    starts: torch.Tensor, seg_base: torch.Tensor, total: int, L: int,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain K5b: a stable sort by key carrying (col, val), then the
    scatter."""
    ks, order = torch.sort(keys.to(torch.int32), stable=True)
    return _scatter_plain(ks, cols[order], vals[order], starts, seg_base, total, L, scale)


# --- the kernels ---


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.unpack_nibbles_u8.argtypes = [p, p, ll, p]
    lib.unpack_nibbles_u8.restype = i
    lib.pack_presorted.argtypes = [
        p, i, p, i, p, p, i, i, i, ll, ctypes.c_float, p, p, p, p,
    ]
    lib.pack_presorted.restype = i
    lib.scatter_pack.argtypes = [
        p, i, p, p, i, p, p, i, i, i, ll, ctypes.c_float, i,
        p, p, p, p, p, p, p,
    ]
    lib.scatter_pack.restype = i


_LIBRARY = native.Library(SOURCE, _declare, "device_pack_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return _LIBRARY.get()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("every tensor must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("every tensor must be contiguous")
    return dev


def unpack_nibbles(packed: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: uint8 [m] -> int8 [2m], written into ``out`` when given (a
    contiguous int8 [2m] tensor, for example a slice of a larger one).

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    if packed.dim() != 1 or packed.dtype != torch.uint8:
        raise ValueError(f"packed must be 1-D uint8, got {tuple(packed.shape)} {packed.dtype}")
    m = packed.shape[0]
    if out is None:
        out = torch.empty(2 * m, dtype=torch.int8, device=packed.device)
    elif out.shape != (2 * m,) or out.dtype != torch.int8:
        raise ValueError(f"out must be int8 [{2 * m}], got {tuple(out.shape)} {out.dtype}")
    dev = _check_device(packed, out)
    if dev.type == "cpu":
        LAUNCHES.add("unpack_nibbles_plain")
        out.copy_(unpack_nibbles_plain(packed))
        return out
    if m == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.unpack_nibbles_u8(packed.data_ptr(), out.data_ptr(), m, _stream(dev))
    _LIBRARY.check(err, "unpack_nibbles")
    LAUNCHES.add("unpack_nibbles")
    return out


def _check_pack(name, ids, vals, starts, seg_base, total, L, id_dtypes):
    if ids.dim() != 1 or vals.shape != ids.shape:
        raise ValueError(f"{name}: ids and vals must be 1-D of one length")
    if ids.dtype not in id_dtypes:
        raise TypeError(f"{name}: ids must be one of {id_dtypes}, got {ids.dtype}")
    if vals.dtype not in (torch.int8, torch.float32):
        raise TypeError(f"{name}: vals must be int8 or float32, got {vals.dtype}")
    for t in (starts, seg_base):
        if t.dim() != 1 or t.dtype != torch.int32 or t.shape[0] < 1:
            raise ValueError(f"{name}: starts and seg_base must be non-empty 1-D int32")
    if starts.shape != seg_base.shape:
        raise ValueError(f"{name}: starts and seg_base must be of one length")
    if L < 1 or total < 1 or total * L > _I32_MAX or ids.shape[0] > _I32_MAX:
        raise ValueError(f"{name}: need L >= 1, total >= 1 and planes under 2^31 slots")


def device_pack_presorted(
    cols: torch.Tensor, vals: torch.Tensor, starts: torch.Tensor,
    seg_base: torch.Tensor, total: int, L: int, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5a on a user-sorted wire side: cols [n] uint16/int32, vals [n]
    int8/float32, starts/seg_base int32 -> (keys [n] int32, p_cols
    [total·L] int32, p_vals [total·L] float32).

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    _check_pack("device_pack_presorted", cols, vals, starts, seg_base, total, L,
                (torch.uint16, torch.int32))
    dev = _check_device(cols, vals, starts, seg_base)
    if dev.type == "cpu":
        LAUNCHES.add("device_pack_presorted_plain")
        return device_pack_presorted_plain(cols, vals, starts, seg_base, total, L, scale)
    n = cols.shape[0]
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    p_cols = torch.empty(total * L, dtype=torch.int32, device=dev)
    p_vals = torch.empty(total * L, dtype=torch.float32, device=dev)
    if n == 0:
        return keys, p_cols.zero_(), p_vals.zero_()
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.pack_presorted(
            cols.data_ptr(), int(cols.dtype == torch.int32), vals.data_ptr(),
            int(vals.dtype == torch.float32), starts.data_ptr(),
            seg_base.data_ptr(), starts.shape[0], n, L, total * L,
            float(scale), keys.data_ptr(), p_cols.data_ptr(),
            p_vals.data_ptr(), _stream(dev),
        )
    _LIBRARY.check(err, "device_pack_presorted")
    LAUNCHES.add("device_pack_presorted")
    return keys, p_cols, p_vals


def radix_passes(key_bound: int) -> int:
    """K5b's sort passes for keys in [0, key_bound): one per 8 bits of the
    largest key, at least one."""
    bits = max(int(key_bound) - 1, 0).bit_length()
    return max(1, -(-bits // RADIX_BITS))


def device_scatter_pack(
    keys: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
    starts: torch.Tensor, seg_base: torch.Tensor, total: int, L: int,
    scale: float, key_bound: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5b: keys [n] uint16/int32 (every key in [0, ``key_bound``); by
    default the key dtype's full non-negative range), cols [n] int32, vals
    [n] int8/float32 -> (p_cols [total·L] int32, p_vals [total·L] float32)
    in the layout of the stable sort by key. ``key_bound`` sets the radix
    passes: the caller knows it from the host (the wire's ``n_items + 1``),
    so nothing is read back from the card.

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    _check_pack("device_scatter_pack", keys, vals, starts, seg_base, total, L,
                (torch.uint16, torch.int32))
    if cols.shape != keys.shape or cols.dtype != torch.int32:
        raise ValueError("device_scatter_pack: cols must be int32 of the keys' length")
    dev = _check_device(keys, cols, vals, starts, seg_base)
    if dev.type == "cpu":
        LAUNCHES.add("device_scatter_pack_plain")
        return device_scatter_pack_plain(keys, cols, vals, starts, seg_base, total, L, scale)
    if key_bound is None:
        key_bound = 2**16 if keys.dtype == torch.uint16 else 2**31
    passes = radix_passes(key_bound)
    n = keys.shape[0]
    p_cols = torch.empty(total * L, dtype=torch.int32, device=dev)
    p_vals = torch.empty(total * L, dtype=torch.float32, device=dev)
    if n == 0:
        return p_cols.zero_(), p_vals.zero_()
    halves = 0 if passes == 1 else (1 if passes == 2 else 2)
    keys_tmp = torch.empty(halves * n, dtype=keys.dtype, device=dev)
    cols_tmp = torch.empty(halves * n, dtype=torch.int32, device=dev)
    vals_tmp = torch.empty(halves * n, dtype=vals.dtype, device=dev)
    hist = torch.empty(256 * (-(-n // SORT_TILE)) + 256, dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.scatter_pack(
            keys.data_ptr(), int(keys.dtype == torch.int32), cols.data_ptr(),
            vals.data_ptr(), int(vals.dtype == torch.float32),
            starts.data_ptr(), seg_base.data_ptr(), starts.shape[0], n, L,
            total * L, float(scale), passes, keys_tmp.data_ptr(),
            cols_tmp.data_ptr(), vals_tmp.data_ptr(), hist.data_ptr(),
            p_cols.data_ptr(), p_vals.data_ptr(), _stream(dev),
        )
    _LIBRARY.check(err, "device_scatter_pack")
    LAUNCHES.add("device_scatter_pack")
    return p_cols, p_vals
