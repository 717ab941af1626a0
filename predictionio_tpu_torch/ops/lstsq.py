"""K21/K22, minimum-norm least squares: the counterpart of
``jnp.linalg.lstsq`` as the stock template calls it (vmapped over
tickers, ``predictionio_tpu/models/experimental/stock.py:325 solve_all``)
and as the regression template calls it (one tall system,
``predictionio_tpu/models/experimental/regression.py:139``).

``lstsq(A, b)`` solves the systems A [N, m, n] (or one [m, n]) against
b [N, m] (or [m]) in JAX's sense: with A = U·diag(s)·Vᵀ,
``x = V·diag(mask/s)·Uᵀb``, ``mask = (s > 0) & (s ≥ rcond·s_max)``,
``rcond = eps_f32·max(m, n)`` — the minimum-norm answer when A is
rank-deficient, and zeros for an empty matrix. It returns x (float32), the
rank, the min(m, n) singular values in descending order and, from the
kernel, the Jacobi sweeps each system took: -1 where a system had not
converged after ``MAX_SWEEPS``, which ``require_converged`` turns into an
``ArithmeticError`` (the wrapper does not read the card back itself).

Three forms, one function:
- the hand-written CUDA kernels for Hopper, ``csrc/lstsq.cu``
  (``lsq_gram_partial``, then ``lsq_solve``; its header states the bound
  and the design): the Gram [A b]ᵀ[A b] in float64 over many blocks, then
  a cyclic Jacobi eigensolver per system in float64;
- the plain PyTorch twin ``lstsq_plain``: the same algebra in torch
  float64 (``A.T @ A``, ``torch.linalg.eigh``);
- the wrapper, which routes CPU tensors to the twin and CUDA tensors to the
  kernels (launch or raise, no fallback). ``LAUNCHES`` counts what it ran.

The normal equations square A's condition number. In float64 that loses
less than JAX's own float32 SVD until cond(A) reaches about 1e7; past that
the answer drifts from JAX's. At most ``MAX_COLS`` columns.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts

SOURCE = "lstsq.cu"

LAUNCHES = LaunchCounts("lsq", "lsq_plain")

MAX_COLS = 64  # columns of A at most (one solve thread per column)
MAX_SYSTEMS = 65_535  # systems per call at most (the grid's y extent)
MAX_SWEEPS = 60  # Jacobi sweeps per system at most
EPS_F32 = float(np.finfo(np.float32).eps)

# the Gram's plan: rows per chunk at least, chunks of all systems at most
_GRAM_ROWS = 1_024
_GRAM_BLOCKS = 528


class LstsqResult(NamedTuple):
    x: torch.Tensor  # [N, n] (or [n]) float32
    rank: torch.Tensor  # [N] (or []) int32
    s: torch.Tensor  # [N, min(m, n)] (or [min(m, n)]) float32, descending
    sweeps: Optional[torch.Tensor]  # [N] int32 Jacobi sweeps, -1: not converged (kernel only)


def rcond_of(m: int, n: int) -> float:
    """JAX's default cutoff: float32's epsilon times max(m, n)."""
    return EPS_F32 * max(m, n)


def lstsq_plain(A: torch.Tensor, b: torch.Tensor) -> LstsqResult:
    """The plain twin, on [N, m, n] and [N, m]: the normal equations in
    float64 (``AᵀA``, ``Aᵀb``), ``torch.linalg.eigh``, JAX's cutoff on
    s = sqrt(λ), and ``x = V·diag(mask/λ)·Vᵀ·Aᵀb``."""
    N, m, n = A.shape
    Ad, bd = A.double(), b.double()
    G = Ad.transpose(1, 2) @ Ad
    c = (Ad.transpose(1, 2) @ bd[:, :, None])[:, :, 0]
    lam, V = torch.linalg.eigh(G)
    s = torch.sqrt(lam.clamp(min=0.0))
    smax = s.max(dim=1, keepdim=True).values
    cut = float(np.float32(rcond_of(m, n))) * smax
    mask = (s > 0) & (s >= cut)
    proj = (V.transpose(1, 2) @ c[:, :, None])[:, :, 0]
    y = torch.where(mask, proj / torch.where(mask, lam, torch.ones_like(lam)), 0.0)
    x = (V @ y[:, :, None])[:, :, 0]
    s_desc = torch.sort(s, dim=1, descending=True).values[:, :min(m, n)]
    return LstsqResult(x.float(), mask.sum(1).to(torch.int32), s_desc.float(), None)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lsq_f32.argtypes = [p, p, i, i, i, i, i, ctypes.c_float, i, p, p, p, p, p, p]
    lib.lsq_f32.restype = ctypes.c_int


_LIBRARY = native.Library(SOURCE, _declare, "lstsq_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return _LIBRARY.get()


def gram_plan(N: int, m: int) -> Tuple[int, int]:
    """(P, rows_per_chunk): each system's rows cut into P chunks of at
    least ``_GRAM_ROWS`` rows, ``_GRAM_BLOCKS`` chunks over all systems at
    most (one chunk a system at least). A function of the shape alone, so
    the sums' order (and bits) does not depend on the card."""
    P = max(1, min(-(-m // _GRAM_ROWS), _GRAM_BLOCKS // N))
    rows = -(-m // P)
    return -(-m // rows), rows


def _empty(N: int, m: int, n: int, device) -> LstsqResult:
    """JAX's answer for an empty matrix: x of zeros, rank 0, no singular
    values."""
    z = torch.zeros((N, n), dtype=torch.float32, device=device)
    return LstsqResult(z, torch.zeros(N, dtype=torch.int32, device=device),
                       torch.zeros((N, 0), dtype=torch.float32, device=device), None)


def lstsq(A: torch.Tensor, b: torch.Tensor) -> LstsqResult:
    """K21/K22: the minimum-norm least-squares solutions of A [N, m, n]
    against b [N, m] (or of one system, A [m, n] and b [m]), float32.

    CPU tensors go to the plain twin. CUDA tensors go to the kernels, which
    must build and launch or this raises."""
    single = A.dim() == 2
    if single:
        if b.dim() != 1:
            raise ValueError(f"b must be [m] for A [m, n], got {tuple(b.shape)}")
        A, b = A[None], b[None]
    if A.dim() != 3 or b.dim() != 2 or b.shape != A.shape[:2]:
        raise ValueError(f"A must be [N, m, n] with b [N, m], got {tuple(A.shape)}, "
                         f"{tuple(b.shape)}")
    if A.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("A and b must be float32")
    if A.device != b.device:
        raise ValueError("A and b must be on one device")
    N, m, n = A.shape
    if n > MAX_COLS:
        raise ValueError(f"at most {MAX_COLS} columns, got {n}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {A.device}")
    if m == 0 or n == 0 or N == 0:
        out = _empty(N, m, n, A.device)
    elif A.device.type == "cpu":
        LAUNCHES.add("lsq_plain")
        out = lstsq_plain(A, b)
    else:
        out = _lstsq_cuda(A.contiguous(), b.contiguous())
    if single:
        out = LstsqResult(*(None if t is None else t[0] for t in out))
    return out


def require_converged(res: LstsqResult) -> LstsqResult:
    """``res``, or ``ArithmeticError`` if a system's Jacobi sweeps had not
    converged (a twin's result has no sweeps and passes). Reads the sweeps
    back from the card."""
    if res.sweeps is not None:
        bad = int((res.sweeps < 0).sum())
        if bad:
            raise ArithmeticError(f"least squares: {bad} of {res.sweeps.numel()} system(s) "
                                  f"did not converge in {MAX_SWEEPS} Jacobi sweeps")
    return res


def _lstsq_cuda(A: torch.Tensor, b: torch.Tensor, max_sweeps: int = MAX_SWEEPS) -> LstsqResult:
    N, m, n = A.shape
    if N > MAX_SYSTEMS:
        raise ValueError(f"at most {MAX_SYSTEMS} systems a call, got {N}")
    dev = A.device
    P, rows = gram_plan(N, m)
    w = n + 1
    part = torch.empty((N, P, w * (w + 1) // 2), dtype=torch.float64, device=dev)
    x = torch.empty((N, n), dtype=torch.float32, device=dev)
    rank = torch.empty(N, dtype=torch.int32, device=dev)
    s = torch.empty((N, min(m, n)), dtype=torch.float32, device=dev)
    sweeps = torch.empty(N, dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lsq_f32(
            A.data_ptr(), b.data_ptr(), N, m, n, P, rows, float(np.float32(rcond_of(m, n))),
            max_sweeps, part.data_ptr(), x.data_ptr(), rank.data_ptr(), s.data_ptr(), sweeps.data_ptr(),
            stream,
        )
    _LIBRARY.check(err, "lsq")
    LAUNCHES.add("lsq")
    return LstsqResult(x, rank, s, sweeps)
