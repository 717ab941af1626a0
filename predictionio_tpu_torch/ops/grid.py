"""K13, the regularizer-grid loop's kernels: the counterpart of the
reference's ``predictionio_tpu/ops/als.py:942 _run_iterations_grid``,
which vmaps K1 (``_accumulate_systems``) and K2 (``_spd_solve`` with the
epilogue of ``_solve_side``) over V regularizer variants that share one
pack.

- ``normal_eq_variants`` (K13a): A [V, R, k, k] and b [V, R, k], variant
  v's normal equations against its own factors ``Y[v]``, from one shared
  ``SegmentPack`` (K1's systems, with the implicit weights when asked);
  with ``compute_dtype="bfloat16"`` K13a-bf16, K1-bf16's systems per
  variant.
- ``spd_solve_variants`` (K13b): X [V, R, k], variant v's systems solved
  with its own λ row ``lam[v]`` and, in implicit mode, its own Gramian
  ``G[v]``; rows without observations (``has_obs``, shared) keep
  ``X_prev[v]``. No telemetry: the reference's grid keeps none. On a
  row-sharded mesh (``ops/als.py train_als_grid(mesh=)``, K13s) a shard
  passes its own systems [V, R_s, ·], the whole arrays ``lam``,
  ``has_obs``, ``X_prev`` and ``out``, and its first row ``row0``: the
  kernel solves rows ``row0 .. row0 + R_s`` of them where they lie.

Three forms, one function each:
- the hand-written CUDA kernels for Hopper, ``csrc/grid.cu`` (its header
  states the bound and the design): K1's and K2's own kernels
  (``csrc/normal_eq.cuh``, ``csrc/spd_solve.cuh``) with a variant axis,
  so variant v is bit-equal to K1 and K2 run on that variant alone; at
  k <= 16 one warp sums a group for all its variants
  (``normal_eq.small_form_plan(k, V)``);
- the plain PyTorch twins ``normal_eq_variants_plain`` and
  ``spd_solve_variants_plain``: a loop over the variants of K1's and K2's
  twins;
- the wrappers, which route CPU tensors to the twins and CUDA tensors to
  the kernels (launch or raise, no fallback). ``LAUNCHES`` counts what
  they ran.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops import normal_eq as _k1
from predictionio_tpu_torch.ops import spd_solve as _k2
from predictionio_tpu_torch.ops.native import LaunchCounts
from predictionio_tpu_torch.ops.normal_eq import SegmentPack
from predictionio_tpu_torch.ops.precision import is_bf16

SOURCE = "grid.cu"

# kernel launches, and CPU calls the wrappers routed to the plain twins
LAUNCHES = LaunchCounts(
    "normal_eq_variants", "normal_eq_variants_plain",
    "normal_eq_variants_bf16", "normal_eq_variants_bf16_plain",
    "spd_solve_variants", "spd_solve_variants_plain",
)


def normal_eq_variants_plain(
    Y: torch.Tensor, pack: SegmentPack, implicit: bool = False, alpha: float = 1.0,
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin: K1's twin on each variant's factors."""
    out = [
        _k1.normal_eq_plain(
            Y[v], pack.seg_rows, pack.cols, pack.vals, pack.rem,
            pack.n_sys_rows, implicit, alpha, compute_dtype,
        )
        for v in range(Y.shape[0])
    ]
    return torch.stack([a for a, _ in out]), torch.stack([b for _, b in out])


def spd_solve_variants_plain(
    A: torch.Tensor,
    b: torch.Tensor,
    lam: torch.Tensor,
    has_obs: torch.Tensor,
    X_prev: torch.Tensor,
    G: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain twin: K2's twin on each variant with its λ row and G."""
    return torch.stack([
        _k2.spd_solve_plain(
            A[v], b[v], lam[v], has_obs, X_prev[v], None if G is None else G[v]
        )[0]
        for v in range(A.shape[0])
    ])


def _declare(lib: ctypes.CDLL) -> None:
    lib.normal_eq_variants_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] + [
        ctypes.c_void_p
    ] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.normal_eq_variants_f32.restype = ctypes.c_int
    lib.spd_solve_variants_f32.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p
    ]
    lib.spd_solve_variants_f32.restype = ctypes.c_int


_LIBRARY = native.Library(SOURCE, _declare, "grid_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return _LIBRARY.get()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def normal_eq_variants(
    Y: torch.Tensor, pack: SegmentPack, implicit: bool = False, alpha: float = 1.0,
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13a: A [V, R, k, k] and b [V, R, k] float32 for the side ``pack``
    against each variant's counter-side factors ``Y`` [V, n, k]
    (R = ``pack.n_sys_rows``), in ``compute_dtype`` (``"bfloat16"``:
    K13a-bf16).

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    if Y.dim() != 3 or Y.shape[0] < 1:
        raise ValueError(f"Y must be [V, n, k] with V >= 1, got {tuple(Y.shape)}")
    _k1._check(Y[0], pack)
    bf16 = is_bf16(compute_dtype)
    name = "normal_eq_variants_bf16" if bf16 else "normal_eq_variants"
    if Y.device.type == "cpu":
        LAUNCHES.add(f"{name}_plain")
        return normal_eq_variants_plain(Y, pack, implicit, alpha, compute_dtype)
    if Y.device.type != "cuda":
        raise ValueError(f"unsupported device {Y.device}")
    if not Y.is_contiguous():
        raise ValueError("Y must be contiguous")
    lib = load_library()
    V, n_y, k = Y.shape
    R = pack.n_sys_rows
    L = pack.cols.shape[-1]
    plan = pack.plan
    P = max(plan.n_partials, 1)
    A = torch.empty((V, R, k, k), dtype=torch.float32, device=Y.device)
    b = torch.empty((V, R, k), dtype=torch.float32, device=Y.device)
    partials = torch.empty((V, P, k * k + k), dtype=torch.float32, device=Y.device)
    Yh = _k1.bf16_rows(Y) if bf16 else None
    with torch.cuda.device(Y.device):
        err = lib.normal_eq_variants_f32(
            Y.data_ptr(), None if Yh is None else Yh.data_ptr(),
            pack.cols.data_ptr(), pack.vals.data_ptr(),
            pack.rem.data_ptr(), plan.groups.data_ptr(), plan.groups.shape[1],
            plan.combine_rows.data_ptr(), plan.combine_start.data_ptr(),
            plan.combine_rows.shape[0], partials.data_ptr(), A.data_ptr(),
            b.data_ptr(), k, L, int(bool(implicit)), float(alpha), V, n_y * k, R, P,
            int(bf16), _k1.small_plan_address(k, V), _stream(Y.device),
        )
    _LIBRARY.check(err, name)
    LAUNCHES.add(name)
    return A, b


def spd_solve_variants(
    A: torch.Tensor,
    b: torch.Tensor,
    lam: torch.Tensor,
    has_obs: torch.Tensor,
    X_prev: torch.Tensor,
    G: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    row0: int = 0,
) -> torch.Tensor:
    """K13b on A [V, R, k, k], b [V, R, k], lam [V, N] float32, has_obs [N]
    bool, X_prev [V, N, k] float32 and an optional G [V, k, k] float32,
    solving rows ``row0 .. row0 + R`` of the N-row arrays: written into
    ``out`` [V, N, k] when given (its other rows untouched), else into a
    new X [V, R, k] (which needs N = R, ``row0`` 0); see the module
    docstring.

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    if A.dim() != 4 or A.shape[0] < 1:
        raise ValueError(f"A must be [V, R, k, k] with V >= 1, got {tuple(A.shape)}")
    V, R, k = A.shape[0], A.shape[1], A.shape[2]
    N = X_prev.shape[1] if X_prev.dim() == 3 else -1
    r1 = row0 + R
    if row0 < 0 or r1 > N or (out is None and (row0 != 0 or N != R)):
        raise ValueError(f"rows [{row0}, {r1}) of {N} need out= unless they are all of them")
    for name, t, shape in (("b", b, (V, R, k)), ("lam", lam, (V, N)),
                           ("X_prev", X_prev, (V, N, k))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if G is not None and (tuple(G.shape) != (V, k, k) or G.dtype != torch.float32):
        raise ValueError(f"G must be a [{V}, {k}, {k}] float32 tensor")
    # K2's checks on variant 0 cover the dtypes, has_obs and the devices
    _k2._check(A[0], b[0], lam[0, row0:r1], has_obs[row0:r1], X_prev[0, row0:r1], None,
               None if G is None else G[0])
    _k2.check_solve_out(out, X_prev)
    if A.device.type == "cpu":
        LAUNCHES.add("spd_solve_variants_plain")
        X = spd_solve_variants_plain(
            A, b, lam[:, row0:r1], has_obs[row0:r1], X_prev[:, row0:r1], G
        )
        if out is None:
            return X
        out[:, row0:r1] = X
        return out
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    if not all(t.is_contiguous() for t in (A, b, lam, has_obs, X_prev)) or (
        G is not None and not G.is_contiguous()
    ):
        raise ValueError("every tensor must be contiguous")
    lib = load_library()
    X = out if out is not None else torch.empty((V, R, k), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        err = lib.spd_solve_variants_f32(
            A.data_ptr(), G.data_ptr() if G is not None else None, b.data_ptr(),
            lam[0, row0:].data_ptr(), has_obs[row0:].data_ptr(),
            X_prev[0, row0:].data_ptr(), X[0, row0:].data_ptr(),
            R, k, V, N, _stream(A.device),
        )
    _LIBRARY.check(err, "spd_solve_variants")
    LAUNCHES.add("spd_solve_variants")
    return X
