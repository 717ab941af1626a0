"""K7, rating prediction for (user, item) pairs: the counterpart of the
reference's jitted program ``predictionio_tpu/ops/als.py:2330
_predict_pairs``, ``Σ_k X[u]·Y[i]``.

Three forms, one function:
- the hand-written CUDA kernel for Hopper, ``csrc/predict_pairs.cu`` (its
  header states the bound and the design);
- the plain PyTorch twin ``predict_pairs_plain``: gather both rows,
  multiply, sum over the rank;
- the wrapper ``predict_pairs``, which routes CPU tensors to the twin and
  CUDA tensors to the kernel (launch or raise, no fallback). ``LAUNCHES``
  counts what it ran.
"""

from __future__ import annotations

import ctypes

import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts

SOURCE = "predict_pairs.cu"

# "predict_pairs": kernel launches; "predict_pairs_plain": CPU calls the
# wrapper routed to the plain twin
LAUNCHES = LaunchCounts("predict_pairs", "predict_pairs_plain")


def predict_pairs_plain(
    X: torch.Tensor, Y: torch.Tensor, u: torch.Tensor, i: torch.Tensor
) -> torch.Tensor:
    """The plain twin: ``sum(X[u] * Y[i], -1)``."""
    return torch.sum(X[u.long()] * Y[i.long()], dim=-1)


def _declare(lib: ctypes.CDLL) -> None:
    lib.predict_pairs_f32.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.predict_pairs_f32.restype = ctypes.c_int


_LIBRARY = native.Library(SOURCE, _declare, "predict_pairs_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    return _LIBRARY.get()


def _check(X, Y, u, i, check_ids: bool) -> None:
    if X.dim() != 2 or Y.dim() != 2 or X.shape[1] != Y.shape[1] or X.shape[1] < 1:
        raise ValueError(f"X and Y must be [n, k], got {tuple(X.shape)} and {tuple(Y.shape)}")
    if X.dtype != torch.float32 or Y.dtype != torch.float32:
        raise TypeError(f"X and Y must be float32, got {X.dtype} and {Y.dtype}")
    if u.dim() != 1 or i.shape != u.shape:
        raise ValueError(f"u and i must be 1-D of one length, got {tuple(u.shape)}, {tuple(i.shape)}")
    if u.dtype != torch.int32 or i.dtype != torch.int32:
        raise TypeError(f"u and i must be int32, got {u.dtype} and {i.dtype}")
    if any(t.device != X.device for t in (Y, u, i)):
        raise ValueError("X, Y, u and i must be on one device")
    if not check_ids:
        return
    for name, ids, n in (("u", u, X.shape[0]), ("i", i, Y.shape[0])):
        if ids.numel():
            lo, hi = (int(v) for v in torch.aminmax(ids))
            if lo < 0 or hi >= n:
                raise ValueError(f"{name} ids out of range [0, {n})")


def predict_pairs(
    X: torch.Tensor, Y: torch.Tensor, u: torch.Tensor, i: torch.Tensor,
    check_ids: bool = True,
) -> torch.Tensor:
    """K7 on X [n_users, k], Y [n_items, k] float32 and int32 ids u, i [P]
    -> [P] float32.

    ``check_ids`` checks that every id is in range, which on the card costs
    a device-to-host sync per call; a caller that has checked the ids
    already (``ops/als.py predict_ratings``, on the host) passes False.
    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    _check(X, Y, u, i, check_ids)
    if X.device.type == "cpu":
        LAUNCHES.add("predict_pairs_plain")
        return predict_pairs_plain(X, Y, u, i)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if not all(t.is_contiguous() for t in (X, Y, u, i)):
        raise ValueError("X, Y, u and i must be contiguous")
    if X.shape[1] % 4 == 0 and (X.data_ptr() % 16 or Y.data_ptr() % 16):
        raise ValueError("X and Y must start on a 16-byte boundary")
    P = u.shape[0]
    out = torch.empty(P, dtype=torch.float32, device=X.device)
    if P == 0:
        return out
    lib = load_library()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.predict_pairs_f32(
            X.data_ptr(), Y.data_ptr(), u.data_ptr(), i.data_ptr(),
            out.data_ptr(), P, X.shape[1], stream,
        )
    _LIBRARY.check(err, "predict_pairs")
    LAUNCHES.add("predict_pairs")
    return out
