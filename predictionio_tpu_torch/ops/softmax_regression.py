"""K18, softmax regression by full-batch gradient descent: the counterpart
of the jitted ``fit`` in ``LogisticRegressionAlgorithm.train``
(``predictionio_tpu/models/classification/engine.py:213-251``: ``jax.grad``
of the template's loss under ``lax.scan``).

From ``W = 0`` [C, F] and ``b = 0`` [C], each of ``iterations`` steps is

  P = softmax(X·Wᵀ + b),  R = (P - onehot(y)) / n,
  W -= lr·(Rᵀ·X + 2·l2·W),  b -= lr·Σ_i R[i],

the gradient of ``-mean(Σ_c Y·log_softmax(X·Wᵀ + b)) + l2·ΣW²`` written out
in closed form, so no autodiff is needed.

Three forms, one function:
- the hand-written CUDA kernels for Hopper, ``csrc/softmax_regression.cu``
  (its header states the bound and the design: per step a partial pass
  and an update pass in fixed summation orders, all steps enqueued by one
  host call);
- the plain PyTorch twin ``softmax_regression_plain``, a loop of
  ``softmax_regression_grad_plain`` steps (the closed form in torch ops);
- the wrapper ``softmax_regression``, which routes CPU tensors to the twin
  and CUDA tensors to the kernels (launch or raise, no fallback).
  ``LAUNCHES`` counts each kernel launch: two a step.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts

SOURCE = "softmax_regression.cu"

LAUNCHES = LaunchCounts("softmax_regression", "softmax_regression_plain")

# the plan: rows per block at least, blocks at most, the tile sizes tried
# (largest first) and the shared memory a block may take
_ROWS = 512
_BLOCKS = 528
_TILES = (128, 64, 32)
_SHARED_BYTES = 48 * 1024


def softmax_regression_grad_plain(
    X: torch.Tensor, y: torch.Tensor, W: torch.Tensor, b: torch.Tensor, l2: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loss's gradient (gW [C, F], gb [C]) at (W, b) in closed form: the
    plain form of one step (an index of ``y`` outside [0, C) is a row of no
    class, as ``jax.nn.one_hot`` gives it)."""
    C = W.shape[0]
    z = X @ W.T + b
    z = z - z.amax(1, keepdim=True)
    e = torch.exp(z)
    P = e / e.sum(1, keepdim=True)
    Y = (y[:, None].long() == torch.arange(C, device=X.device)[None, :]).to(torch.float32)
    R = (P - Y) / X.shape[0]
    return R.T @ X + 2 * l2 * W, R.sum(0)


def softmax_regression_plain(
    X: torch.Tensor, y: torch.Tensor, n_classes: int, lr: float, l2: float, iterations: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of K18: ``iterations`` closed-form steps from zeros."""
    W = torch.zeros((n_classes, X.shape[1]), dtype=torch.float32, device=X.device)
    b = torch.zeros(n_classes, dtype=torch.float32, device=X.device)
    for _ in range(iterations):
        gW, gb = softmax_regression_grad_plain(X, y, W, b, l2)
        W = W - lr * gW
        b = b - lr * gb
    return W, b


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.softmax_regression_f32.argtypes = [p, p, i64, i, i, f32, f32, i, i, i64, i] + [p] * 4
    lib.softmax_regression_f32.restype = ctypes.c_int


_LIBRARY = native.Library(SOURCE, _declare, "softmax_regression_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return _LIBRARY.get()


def plan(n: int, n_classes: int, n_features: int) -> Tuple[int, int, int]:
    """The launch plan (nblk, rows_per_block, tile): blocks of at least
    ``_ROWS`` rows, and the largest tile whose rows, R and the block's
    partial fit ``_SHARED_BYTES``. A function of the shape alone, so the
    sums' order does not depend on the card. Raises ``ValueError`` where
    even the smallest tile does not fit."""
    C, F = n_classes, n_features
    for tile in _TILES:
        if 4 * (tile * (F + C) + C * (F + 1)) <= _SHARED_BYTES:
            break
    else:
        raise ValueError(
            f"softmax_regression: {C} classes x {F} features do not fit one "
            f"block's shared memory ({_SHARED_BYTES} bytes at {_TILES[-1]} rows)"
        )
    nblk = max(1, min(-(-n // _ROWS), _BLOCKS))
    rows = -(-n // nblk)
    return -(-n // rows), rows, tile


def softmax_regression(
    X: torch.Tensor, y: torch.Tensor, n_classes: int, lr: float, l2: float, iterations: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K18: (W [C, F], b [C]) after ``iterations`` gradient steps from zeros
    on ``X`` [n, F] float32 and class indices ``y`` [n] int32.

    CPU tensors go to the plain twin. CUDA tensors go to the kernels, which
    must build and launch or this raises."""
    if X.dim() != 2 or X.dtype != torch.float32:
        raise ValueError(f"X must be [n, F] float32, got {tuple(X.shape)} {X.dtype}")
    n, F = X.shape
    if y.dtype != torch.int32 or tuple(y.shape) != (n,):
        raise ValueError(f"y must be [{n}] int32")
    if n < 1 or F < 1 or n_classes < 1 or iterations < 0:
        raise ValueError("softmax_regression needs n, F, n_classes >= 1 and iterations >= 0")
    if y.device != X.device:
        raise ValueError("X and y must be on one device")
    if X.device.type == "cpu":
        LAUNCHES.add("softmax_regression_plain")
        return softmax_regression_plain(X, y, n_classes, lr, l2, iterations)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if not (X.is_contiguous() and y.is_contiguous()):
        raise ValueError("X and y must be contiguous")
    C, dev = n_classes, X.device
    nblk, rows, tile = plan(n, C, F)
    W = torch.zeros((C, F), dtype=torch.float32, device=dev)
    b = torch.zeros(C, dtype=torch.float32, device=dev)
    if iterations == 0:
        return W, b
    lib = load_library()
    part = torch.empty((nblk, C * (F + 1)), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.softmax_regression_f32(
            X.data_ptr(), y.data_ptr(), n, F, C, float(lr), float(l2), iterations,
            nblk, rows, tile, part.data_ptr(), W.data_ptr(), b.data_ptr(), stream,
        )
    _LIBRARY.check(err, "softmax_regression")
    LAUNCHES.add("softmax_regression", 2 * iterations)
    return W, b
