"""K20, the SimRank fixpoint: the counterpart of the reference's jitted
program ``predictionio_tpu/models/experimental/friend_recommendation.py:433
run`` (``SimRankAlgorithm.train``, :416-443):

  S₀ = I,  S ← fill_diagonal(decay · ((P S) Pᵀ), 1),  ``iters`` times,

with P the out-degree-normalised adjacency. The reference builds P dense on
the host (``np.add.at``) and runs two dense [n, n] products an iteration.
The port keeps P as a CSR and runs each iteration as two kernels, in the
reference's association:

- ``build_transition_csr(edges, n)``: P's CSR on the host (out-degrees by
  ``bincount``, ``w = 1/out_deg[src]`` in float32, duplicate edges merged by
  adding their weights in edge order, as ``np.add.at`` adds them, so the
  CSR densifies to the reference's P bit for bit);
- ``place_csr``: the CSR on a device, uploaded once;
- K20a ``simrank_propagate(S, csr)``: ``U = P S``;
- K20b ``simrank_contract(U, csr, decay)``: ``decay · U Pᵀ``, diagonal 1;
- ``simrank(csr, iters, decay)``: the loop, one K20a and one K20b an
  iteration, on the CSR's device.

Three forms of each kernel, one function:
- the hand-written CUDA kernels for Hopper, ``csrc/simrank.cu`` (its header
  states the bound and the design);
- the plain PyTorch twins ``simrank_propagate_plain`` and
  ``simrank_contract_plain``: dense float32 products with the densified P
  (``simrank_csr_to_dense``); ``simrank_plain(P, iters, decay)`` is the
  reference's whole dense loop;
- the wrappers, which route CPU tensors to the twins and CUDA tensors to
  the kernels (launch or raise, no fallback). ``LAUNCHES`` counts what they
  ran.

K20b stages a row of U in one block's shared memory, so it takes at most
``MAX_CONTRACT_VERTICES`` vertices (the H100's 227 KB a block); the
wrapper raises above that.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts

SOURCE = "simrank.cu"

# a row of U in float32 within the opt-in shared memory of one block on an
# H100 (232,448 bytes)
MAX_CONTRACT_VERTICES = 232_448 // 4

LAUNCHES = LaunchCounts(
    "simrank_propagate", "simrank_contract",
    "simrank_propagate_plain", "simrank_contract_plain",
)


class TransitionCSR(NamedTuple):
    """P's CSR on one device: row i holds the out-edges of vertex i, columns
    ascending."""

    n: int
    indptr: torch.Tensor  # [n + 1] int32
    cols: torch.Tensor  # [m] int32
    vals: torch.Tensor  # [m] float32


def build_transition_csr(
    edges: np.ndarray, n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr [n + 1] int32, cols [m] int32, vals [m] float32) of the
    out-degree-normalised adjacency of ``edges`` [E, 2] (src, dst) over
    vertices 0..n-1: each edge weighs ``1/out_deg[src]`` in float32, and the
    edges of one (src, dst) pair add up in edge order from 0, as the
    reference's ``np.add.at`` into a dense P adds them; self-loops are
    entries like any other."""
    e = np.asarray(edges).reshape(-1, 2).astype(np.int64)
    if len(e) and (e.min() < 0 or e.max() >= n):
        raise ValueError(f"edge endpoints must lie in [0, {n})")
    src, dst = e[:, 0], e[:, 1]
    out_deg = np.bincount(src, minlength=n).astype(np.float32)
    w = (1.0 / out_deg[src]).astype(np.float32)
    keys, inverse = np.unique(src * n + dst, return_inverse=True)
    if len(keys) >= 2**31:
        raise ValueError("more than 2^31 - 1 distinct edges")
    vals = np.zeros(len(keys), np.float32)
    np.add.at(vals, inverse.reshape(-1), w)
    indptr = np.zeros(n + 1, np.int64)
    if n:
        indptr[1:] = np.cumsum(np.bincount(keys // n, minlength=n))
    return indptr.astype(np.int32), (keys % n).astype(np.int32), vals


def place_csr(
    indptr: np.ndarray, cols: np.ndarray, vals: np.ndarray, device: torch.device
) -> TransitionCSR:
    """The CSR on ``device``, uploaded once."""

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return TransitionCSR(
        len(indptr) - 1, up(indptr, np.int32), up(cols, np.int32), up(vals, np.float32)
    )


def simrank_csr_to_dense(csr: TransitionCSR) -> torch.Tensor:
    """P [n, n] float32 on the CSR's device."""
    n, dev = csr.n, csr.indptr.device
    P = torch.zeros((n, n), dtype=torch.float32, device=dev)
    rows = torch.repeat_interleave(
        torch.arange(n, device=dev), torch.diff(csr.indptr).long()
    )
    P[rows, csr.cols.long()] = csr.vals
    return P


def simrank_plain(P: torch.Tensor, iters: int, decay: float) -> torch.Tensor:
    """The reference's dense loop: from the identity, ``iters`` times
    ``S = decay * (P @ S @ P.T)`` with the diagonal set to 1, in float32."""
    S = torch.eye(P.shape[0], dtype=torch.float32, device=P.device)
    for _ in range(int(iters)):
        S = decay * (P @ S @ P.T)
        S.fill_diagonal_(1.0)
    return S


def simrank_propagate_plain(S: torch.Tensor, csr: TransitionCSR) -> torch.Tensor:
    """The plain twin of K20a: ``P @ S`` with the dense P."""
    return simrank_csr_to_dense(csr) @ S


def simrank_contract_plain(
    U: torch.Tensor, csr: TransitionCSR, decay: float
) -> torch.Tensor:
    """The plain twin of K20b: ``decay * (U @ P.T)``, diagonal 1."""
    P = simrank_csr_to_dense(csr)
    out = decay * (U @ P.T)
    out.fill_diagonal_(1.0)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.simrank_propagate_f32.argtypes = [p, p, p, p, i, p, p]
    lib.simrank_propagate_f32.restype = ctypes.c_int
    lib.simrank_contract_f32.argtypes = [p, p, p, p, i, f, p, p]
    lib.simrank_contract_f32.restype = ctypes.c_int


_LIBRARY = native.Library(SOURCE, _declare, "simrank_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return _LIBRARY.get()


def _check(M: torch.Tensor, csr: TransitionCSR, what: str) -> None:
    n = csr.n
    if M.dtype != torch.float32 or tuple(M.shape) != (n, n):
        raise ValueError(f"{what} must be [{n}, {n}] float32, got "
                         f"{tuple(M.shape)} {M.dtype}")
    if M.device != csr.indptr.device:
        raise ValueError(f"{what} is on {M.device}, the CSR on {csr.indptr.device}")
    if M.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {M.device}")
    if M.device.type == "cuda" and not M.is_contiguous():
        raise ValueError(f"{what} must be contiguous (row-major)")


def simrank_propagate(S: torch.Tensor, csr: TransitionCSR) -> torch.Tensor:
    """K20a: ``U = P S`` [n, n] float32, on ``S``'s device.

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    _check(S, csr, "S")
    if S.device.type == "cpu":
        LAUNCHES.add("simrank_propagate_plain")
        return simrank_propagate_plain(S, csr)
    U = torch.empty_like(S)
    if csr.n == 0:
        return U
    lib = load_library()
    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream(S.device).cuda_stream
        err = lib.simrank_propagate_f32(
            S.data_ptr(), csr.indptr.data_ptr(), csr.cols.data_ptr(),
            csr.vals.data_ptr(), csr.n, U.data_ptr(), stream,
        )
    _LIBRARY.check(err, "simrank_propagate")
    LAUNCHES.add("simrank_propagate")
    return U


def simrank_contract(
    U: torch.Tensor, csr: TransitionCSR, decay: float
) -> torch.Tensor:
    """K20b: ``decay · U Pᵀ`` with the diagonal set to 1, [n, n] float32 on
    ``U``'s device. Raises ``ValueError`` on a CUDA tensor past
    ``MAX_CONTRACT_VERTICES`` vertices.

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    _check(U, csr, "U")
    if U.device.type == "cpu":
        LAUNCHES.add("simrank_contract_plain")
        return simrank_contract_plain(U, csr, decay)
    if csr.n > MAX_CONTRACT_VERTICES:
        raise ValueError(
            f"K20b stages a row of U in one block's shared memory: at most "
            f"{MAX_CONTRACT_VERTICES} vertices, got {csr.n}"
        )
    out = torch.empty_like(U)
    if csr.n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        err = lib.simrank_contract_f32(
            U.data_ptr(), csr.indptr.data_ptr(), csr.cols.data_ptr(),
            csr.vals.data_ptr(), csr.n, float(decay), out.data_ptr(), stream,
        )
    _LIBRARY.check(err, "simrank_contract")
    LAUNCHES.add("simrank_contract")
    return out


def simrank(csr: TransitionCSR, iters: int, decay: float) -> torch.Tensor:
    """The SimRank scores [n, n] float32 on the CSR's device: from the
    identity, ``iters`` iterations of K20a then K20b."""
    S = torch.eye(csr.n, dtype=torch.float32, device=csr.indptr.device)
    for _ in range(int(iters)):
        S = simrank_contract(simrank_propagate(S, csr), csr, decay)
    return S
