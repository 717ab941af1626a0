"""K12, the Gramian and the implicit objective of implicit-feedback ALS:
the counterparts of the reference's ``predictionio_tpu/ops/als.py:742
_gramian`` (K12a) and ``:752 _implicit_objective`` (K12b), float32.

- ``gramian(Y)``: ``YᵀY`` [k, k] over a factor array Y [n, k], in float32
  products (never TF32). The loop calls it on the counter side's padded
  factors before each implicit half-step (the shared ``G`` that K2 adds to
  every system) and twice per recorded sweep for the objective.
- ``implicit_objective(X, Y, user_pack, user_lam, item_lam, alpha)``: the
  Hu-Koren-Volinsky objective at the current factors,
  ``⟨XᵀX, YᵀY⟩ + Σ_obs [c·s² − 2(1+c)·p·s + (1+c)·p²] + Σ λ·‖·‖²`` over
  both padded sides (s = x·y, c = α·|r|, p = 1(r>0)), one gather-and-score
  pass over the user pack. Every event is a slot, so a store with repeated
  events can give a negative value, as the reference's can; compare it,
  never gate on its sign. With ``compute_dtype="bfloat16"`` (K12b-bf16,
  the reference's :779-780) the scores s are formed from x and y rounded
  to bfloat16; the weights, the Gramians and the regularizer stay float32.
- ``implicit_objective_shards(parts, Gx, Gy, alpha, out)``: the same
  objective on a row-sharded mesh (``ops/als.py``): each shard's partials
  over its own user segments, its rows of X and its rows of Y (K12b's
  first kernel, one launch a shard), then one finish on the first device
  over every shard's partials. Only the cross-shard sums' order differs
  from one device.

Three forms of each, one function:
- the hand-written CUDA kernels for Hopper, ``csrc/gramian.cu`` (its
  header states the bounds and the design: fixed-order two-level
  reductions, no atomics, so runs repeat bit for bit);
- the plain PyTorch twins ``gramian_plain`` and ``implicit_objective_plain``,
  the reference's arithmetic;
- the wrappers, which route CPU tensors to the twins and CUDA tensors to
  the kernels (launch or raise, no fallback). ``LAUNCHES`` counts what
  they ran.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts
from predictionio_tpu_torch.ops.normal_eq import SegmentPack
from predictionio_tpu_torch.ops.precision import in_cdt, is_bf16

SOURCE = "gramian.cu"
_MAX_K = 1024

# "gramian", "implicit_objective": kernel launches; "*_plain": CPU calls the
# wrappers routed to the plain twins
LAUNCHES = LaunchCounts(
    "gramian", "gramian_plain", "implicit_objective", "implicit_objective_plain",
    "implicit_objective_bf16", "implicit_objective_bf16_plain",
    # the mesh form: one partial launch a shard, one finish a call
    "implicit_objective_shard", "implicit_objective_shard_plain",
    "implicit_objective_shard_bf16", "implicit_objective_shard_bf16_plain",
    "implicit_objective_finish", "implicit_objective_finish_plain",
)


def gramian_plain(Y: torch.Tensor) -> torch.Tensor:
    """The plain twin: ``YᵀY`` as one float32 product."""
    return Y.T @ Y


def implicit_objective_plain(
    X: torch.Tensor,
    Y: torch.Tensor,
    seg_rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    rem: torch.Tensor,
    user_lam: torch.Tensor,
    item_lam: torch.Tensor,
    alpha: float,
    Gx: Optional[torch.Tensor] = None,
    Gy: Optional[torch.Tensor] = None,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """The plain twin, the reference's loop: per chunk of the user pack,
    score every slot against its row's factors (rounded to bfloat16 in
    bfloat16 compute) and sum the observed terms; then the two Gramians'
    inner product (``Gx``/``Gy`` when given, else formed here) and the
    regularizer."""
    obs = observed_plain(X, Y, seg_rows, cols, vals, rem, alpha, compute_dtype)
    Gx = gramian_plain(X) if Gx is None else Gx
    Gy = gramian_plain(Y) if Gy is None else Gy
    all_sq = (Gx * Gy).sum()
    reg = (user_lam * (X * X).sum(-1)).sum() + (item_lam * (Y * Y).sum(-1)).sum()
    return all_sq + obs + reg


def observed_plain(
    X: torch.Tensor,
    Y: torch.Tensor,
    seg_rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    rem: torch.Tensor,
    alpha: float,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """The objective's observed terms, the twin's chunk loop: every slot
    of the pack scored against its row's factors, weighed and summed."""
    bf16 = is_bf16(compute_dtype)
    Xc, Yc = in_cdt(X, bf16), in_cdt(Y, bf16)
    L = cols.shape[-1]
    iota = torch.arange(L, device=X.device)
    obs = torch.zeros((), dtype=torch.float32, device=X.device)
    for c in range(seg_rows.shape[0]):
        mask = (iota[None, :] < rem[c][:, None]).to(torch.float32)
        s = torch.einsum("slk,sk->sl", Yc[cols[c].long()], Xc[seg_rows[c].long()])
        cw = alpha * vals[c].abs() * mask
        p = (vals[c] > 0).to(torch.float32) * mask
        term = cw * s * s - 2.0 * (1.0 + cw) * p * s + (1.0 + cw) * p * p
        obs = obs + term.sum()
    return obs


def _declare(lib: ctypes.CDLL) -> None:
    lib.gramian_partials.argtypes = [ctypes.c_int]
    lib.gramian_partials.restype = ctypes.c_int
    lib.gramian_f32.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [
        ctypes.c_void_p
    ] * 3
    lib.gramian_f32.restype = ctypes.c_int
    lib.objective_partials.argtypes = [ctypes.c_int] * 3
    lib.objective_partials.restype = ctypes.c_int
    lib.implicit_objective_f32.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.implicit_objective_f32.restype = ctypes.c_int
    lib.objective_blocks.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.objective_blocks.restype = None
    lib.implicit_objective_partial_f32.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float]
        + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.implicit_objective_partial_f32.restype = ctypes.c_int
    lib.implicit_objective_finish_f32.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] + [ctypes.c_void_p] * 2
    )
    lib.implicit_objective_finish_f32.restype = ctypes.c_int


_LIBRARY = native.Library(SOURCE, _declare, "gramian_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return _LIBRARY.get()


def _check_factors(name: str, F: torch.Tensor) -> None:
    if F.dim() != 2 or F.dtype != torch.float32 or not 1 <= F.shape[1] <= _MAX_K:
        raise ValueError(
            f"{name} must be [n, k] float32 with 1 <= k <= {_MAX_K}, got "
            f"{tuple(F.shape)} {F.dtype}"
        )
    if F.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {F.device}")
    if F.device.type == "cuda" and not F.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major)")


def gramian(Y: torch.Tensor) -> torch.Tensor:
    """K12a: ``YᵀY`` [k, k] float32 for Y [n, k] float32.

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    _check_factors("Y", Y)
    if Y.device.type == "cpu":
        LAUNCHES.add("gramian_plain")
        return gramian_plain(Y)
    lib = load_library()
    n, k = Y.shape
    G = torch.empty((k, k), dtype=torch.float32, device=Y.device)
    partials = torch.empty(
        (lib.gramian_partials(n), k * k), dtype=torch.float32, device=Y.device
    )
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream(Y.device).cuda_stream
        err = lib.gramian_f32(
            Y.data_ptr(), n, k, partials.data_ptr(), G.data_ptr(), stream
        )
    _LIBRARY.check(err, "gramian")
    LAUNCHES.add("gramian")
    return G


def implicit_objective(
    X: torch.Tensor,
    Y: torch.Tensor,
    user_pack: SegmentPack,
    user_lam: torch.Tensor,
    item_lam: torch.Tensor,
    alpha: float,
    out: Optional[torch.Tensor] = None,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """K12b: the implicit objective (a float32 scalar) at the padded
    factors X [R_u, k] and Y [R_i, k], over ``user_pack`` (the user side's
    pack, its column ids rows of Y), with the per-row regularizers
    ``user_lam`` [R_u] and ``item_lam`` [R_i], in ``compute_dtype``
    (``"bfloat16"``: K12b-bf16). Runs K12a twice for the Gramians. Written
    into ``out`` (one float32 element) when given, else into a new 0-d
    tensor.

    CPU tensors go to the plain twins. CUDA tensors go to the kernels,
    which must build and launch or this raises."""
    _check_factors("X", X)
    _check_factors("Y", Y)
    k = X.shape[1]
    if Y.shape[1] != k:
        raise ValueError(f"X and Y ranks differ: {X.shape[1]} and {Y.shape[1]}")
    if user_pack.n_sys_rows != X.shape[0] or Y.shape[0] < user_pack.n_cols:
        raise ValueError("the pack's rows and ids do not match X and Y")
    if tuple(user_lam.shape) != (X.shape[0],) or tuple(item_lam.shape) != (Y.shape[0],):
        raise ValueError("user_lam / item_lam must have one entry per row of X / Y")
    tensors = [Y, user_lam, item_lam, user_pack.seg_rows, user_pack.cols,
               user_pack.vals, user_pack.rem] + ([out] if out is not None else [])
    if any(t.device != X.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    if out is not None and (out.numel() != 1 or out.dtype != torch.float32):
        raise ValueError("out must be one float32 element")
    if X.device.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("every tensor must be contiguous")
    bf16 = is_bf16(compute_dtype)
    name = "implicit_objective_bf16" if bf16 else "implicit_objective"
    Gx, Gy = gramian(X), gramian(Y)
    if X.device.type == "cpu":
        LAUNCHES.add(f"{name}_plain")
        value = implicit_objective_plain(
            X, Y, user_pack.seg_rows, user_pack.cols, user_pack.vals,
            user_pack.rem, user_lam, item_lam, alpha, Gx, Gy, compute_dtype,
        )
        if out is None:
            return value
        out.copy_(value.reshape(out.shape))
        return out
    lib = load_library()
    cols = user_pack.cols
    S, L = cols.shape[0] * cols.shape[1], cols.shape[2]
    partials = torch.empty(
        lib.objective_partials(S, X.shape[0], Y.shape[0]),
        dtype=torch.float32, device=X.device,
    )
    target = out if out is not None else torch.empty((), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.implicit_objective_f32(
            X.data_ptr(), X.shape[0], Y.data_ptr(), Y.shape[0],
            user_pack.seg_rows.data_ptr(), cols.data_ptr(),
            user_pack.vals.data_ptr(), user_pack.rem.data_ptr(), S, L, k,
            float(alpha), user_lam.data_ptr(), item_lam.data_ptr(),
            Gx.data_ptr(), Gy.data_ptr(), partials.data_ptr(),
            target.data_ptr(), int(bf16), stream,
        )
    _LIBRARY.check(err, name)
    LAUNCHES.add(name)
    return target


def implicit_objective_shards(
    parts,
    Gx: torch.Tensor,
    Gy: torch.Tensor,
    alpha: float,
    out: torch.Tensor,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """K12b on a row-sharded mesh: the implicit objective into ``out`` (one
    float32 element on the mesh's first device, where ``Gx`` = XᵀX and
    ``Gy`` = YᵀY [k, k] lie). ``parts`` holds one ``(X_s, Y, user_pack_s,
    user_lam_s, Y_s, item_lam_s)`` per shard on its device: the shard's
    rows of X, the whole counter side Y, the shard's user pack (its rows
    numbered from 0; None for a shard without user rows), their λ, and the
    shard's rows of Y with theirs (the item side's row split). Each shard sums its observed terms and both
    regularizer terms (one partial launch, ``implicit_objective_shard``);
    one finish (``implicit_objective_finish``) adds every shard's, each
    kind in one fixed order, to ⟨Gx, Gy⟩, as ``implicit_objective`` does.

    CPU tensors go to the plain twins. CUDA tensors go to the kernels,
    which must build and launch or this raises."""
    if not parts:
        raise ValueError("implicit_objective_shards needs at least one shard")
    bf16 = is_bf16(compute_dtype)
    name = "implicit_objective_shard_bf16" if bf16 else "implicit_objective_shard"
    k = Gx.shape[0]
    for X_s, Y, pack, lam_x, Y_s, lam_y in parts:
        for label, F in (("X_s", X_s), ("Y", Y), ("Y_s", Y_s)):
            _check_factors(label, F)
            if F.shape[1] != k:
                raise ValueError(f"{label} has rank {F.shape[1]}, the Gramians {k}")
        if pack is None and X_s.shape[0]:
            raise ValueError("a shard with user rows needs their pack")
        if pack is not None and (pack.n_sys_rows != X_s.shape[0] or Y.shape[0] < pack.n_cols):
            raise ValueError("a shard's pack does not match its rows of X and Y")
        if tuple(lam_x.shape) != (X_s.shape[0],) or tuple(lam_y.shape) != (Y_s.shape[0],):
            raise ValueError("a shard's λ must have one entry per row of X_s / Y_s")
        tensors = [Y, Y_s, lam_x, lam_y] + (
            [] if pack is None else [pack.seg_rows, pack.cols, pack.vals, pack.rem]
        )
        if any(t.device != X_s.device for t in tensors):
            raise ValueError("each shard's tensors must be on one device")
        if X_s.device.type == "cuda" and not all(t.is_contiguous() for t in tensors):
            raise ValueError("every tensor must be contiguous")
    if out.numel() != 1 or out.dtype != torch.float32 or Gy.shape != Gx.shape:
        raise ValueError("out must be one float32 element and Gx, Gy [k, k]")
    if any(t.device != out.device for t in (Gx, Gy)):
        raise ValueError("Gx, Gy and out must be on one device")
    d0 = out.device
    if d0.type == "cpu":
        obs, reg_x, reg_y = [], [], []
        for X_s, Y, pack, lam_x, Y_s, lam_y in parts:
            LAUNCHES.add(f"{name}_plain")
            obs.append(
                torch.zeros((), dtype=torch.float32, device=d0) if pack is None
                else observed_plain(X_s, Y, pack.seg_rows, pack.cols, pack.vals, pack.rem,
                                    alpha, compute_dtype)
            )
            reg_x.append((lam_x * (X_s * X_s).sum(-1)).sum())
            reg_y.append((lam_y * (Y_s * Y_s).sum(-1)).sum())
        LAUNCHES.add("implicit_objective_finish_plain")
        total = ((Gx * Gy).sum() + ordered_sum(obs)) + (ordered_sum(reg_x) + ordered_sum(reg_y))
        out.copy_(total.reshape(out.shape))
        return out
    lib = load_library()
    blocks = []
    for X_s, _, pack, _, Y_s, _ in parts:
        b3 = (ctypes.c_int * 3)()
        S = 0 if pack is None else pack.cols.shape[0] * pack.cols.shape[1]
        lib.objective_blocks(S, X_s.shape[0], Y_s.shape[0], b3)
        blocks.append(tuple(b3))
    totals = [sum(b[j] for b in blocks) for j in range(3)]
    partials = torch.empty(sum(totals), dtype=torch.float32, device=d0)
    kinds = [partials[: totals[0]], partials[totals[0] : totals[0] + totals[1]],
             partials[totals[0] + totals[1] :]]
    at = [0, 0, 0]
    for (X_s, Y, pack, lam_x, Y_s, lam_y), b3 in zip(parts, blocks):
        dst = [kinds[j][at[j] : at[j] + b3[j]] for j in range(3)]
        dev = X_s.device
        # a shard on another card writes its partials there, then copies them
        local = dst if dev == d0 else [torch.empty(n, dtype=torch.float32, device=dev) for n in b3]
        # a shard without user rows scores no segment (S = 0: the pack's
        # pointers are never read)
        seg = (None,) * 4 if pack is None else (
            pack.seg_rows.data_ptr(), pack.cols.data_ptr(), pack.vals.data_ptr(),
            pack.rem.data_ptr())
        S, L = (0, 1) if pack is None else (pack.cols.shape[0] * pack.cols.shape[1],
                                            pack.cols.shape[2])
        with torch.cuda.device(dev):
            err = lib.implicit_objective_partial_f32(
                X_s.data_ptr(), X_s.shape[0], Y.data_ptr(), Y_s.data_ptr(), Y_s.shape[0],
                *seg, S, L, k,
                float(alpha), lam_x.data_ptr(), lam_y.data_ptr(),
                local[0].data_ptr(), local[1].data_ptr(), local[2].data_ptr(),
                int(bf16), torch.cuda.current_stream(dev).cuda_stream,
            )
        _LIBRARY.check(err, name)
        LAUNCHES.add(name)
        if dev != d0:
            for d, l in zip(dst, local):
                d.copy_(l)
        at = [a + n for a, n in zip(at, b3)]
    with torch.cuda.device(d0):
        err = lib.implicit_objective_finish_f32(
            partials.data_ptr(), totals[0], totals[1], totals[2], Gx.data_ptr(),
            Gy.data_ptr(), k, out.data_ptr(), torch.cuda.current_stream(d0).cuda_stream,
        )
    _LIBRARY.check(err, "implicit_objective_finish")
    LAUNCHES.add("implicit_objective_finish")
    return out


def ordered_sum(values) -> torch.Tensor:
    """The shards' values summed in shard order."""
    total = values[0]
    for v in values[1:]:
        total = total + v
    return total
