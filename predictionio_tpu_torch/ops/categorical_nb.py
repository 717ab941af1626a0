"""K17, categorical naive Bayes: the counterpart of the device programs of
``predictionio_tpu/e2/naive_bayes.py`` (reference
e2/src/main/scala/io/prediction/e2/engine/CategoricalNaiveBayes.scala):

- ``cnb_count(keys, n_keys)`` (K17a, the reference's ``_count_flat``): the
  histogram of the flat (slot, label, value) keys, in int32;
- ``cnb_scores_argmax(ll, log_priors, enc, known)`` (K17b, ``_batch_scores``
  fused with ``predict_batch``'s ``jnp.argmax``): each query row's scores
  over the labels, and its first maximum.

Three forms of each kernel, one function:
- the hand-written CUDA kernels for Hopper, ``csrc/categorical_nb.cu`` (its
  header states the bound and the design: integer partials added in block
  order; a warp per query row reduced by a total order);
- the plain PyTorch twins ``count_plain`` (``bincount``) and
  ``scores_plain`` (the reference's gather, mask and sum) with
  ``ops/naive_bayes.argmax_first_nan``;
- the wrappers, which route CPU tensors to the twins and CUDA tensors to
  the kernels (launch or raise, no fallback). ``LAUNCHES`` counts what
  they ran.

The counts are int32, exact past 2^24 per key, where the reference's
float32 scatter-add of ones stops counting (ROADMAP.md, reference
behaviour).

K17s, K17a on a 1-D ``data`` mesh (the reference's :208-221):
``cnb_count_shards`` runs pass 1 (``cnb_count_partial``, twin
``count_partial_plain``) on each shard's keys (whole blocks of the whole-M
plan, ``count_shard_bounds``; no sentinel padding) into its blocks' slice
of one partials array on the first device (a peer copy, none where the
shard shares that device) and one pass 2 (``cnb_count_finish``) there:
integer counts, one device's bit for bit. ``cnb_count_mesh`` cuts host
keys over a mesh.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts
from predictionio_tpu_torch.ops.naive_bayes import argmax_first_nan
from predictionio_tpu_torch.parallel.mesh import Mesh, cut_rows, split_rows

SOURCE = "categorical_nb.cu"

# K17s counts as "cnb_count_shard" (pass 1 on a shard) and "cnb_count_finish"
LAUNCHES = LaunchCounts(
    "cnb_count", "cnb_scores_argmax", "cnb_count_plain", "cnb_scores_argmax_plain",
    "cnb_count_shard", "cnb_count_finish", "cnb_count_shard_plain", "cnb_count_finish_plain",
)

# K17a's plan: keys per block at least, blocks at most, the partials'
# ints at most, the keys of a shared-memory tile at most (48 KB)
_COUNT_KEYS = 8_192
_COUNT_BLOCKS = 264
_COUNT_PARTIAL_INTS = 1 << 24
_COUNT_TILE = 12_288


def count_plain(keys: torch.Tensor, n_keys: int) -> torch.Tensor:
    """The plain twin of K17a: ``bincount`` of the keys in [0, n_keys), as
    int32."""
    valid = (keys >= 0) & (keys < n_keys)
    return torch.bincount(keys[valid].long(), minlength=n_keys).to(torch.int32)


def scores_plain(
    ll: torch.Tensor, log_priors: torch.Tensor, enc: torch.Tensor, known: torch.Tensor
) -> torch.Tensor:
    """The plain twin of K17b's scores [N, L]: the reference's gather of
    ``ll[l, s, enc[n, s]]``, -inf where the slot is unknown (or its code is
    outside [0, V)), summed over the slots, plus the log prior."""
    L, S, V = ll.shape
    ok = known & (enc >= 0) & (enc < V)
    idx = torch.where(ok, enc, 0).long()
    g = ll[:, torch.arange(S, device=ll.device)[None, :], idx]  # [L, N, S]
    g = torch.where(ok[None], g, torch.full_like(g, -float("inf")))
    return log_priors[None, :] + g.permute(1, 0, 2).sum(-1)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cnb_count_i32.argtypes = [p, i64, i, i, i64, i, p, p, p]
    lib.cnb_count_i32.restype = ctypes.c_int
    lib.cnb_count_partial_i32.argtypes = [p, i64, i, i, i64, i, p, p]
    lib.cnb_count_partial_i32.restype = ctypes.c_int
    lib.cnb_count_finish_i32.argtypes = [p, i, i, p, p]
    lib.cnb_count_finish_i32.restype = ctypes.c_int
    lib.cnb_scores_argmax_f32.argtypes = [p, p, p, p, i, i, i, i, p, p, p]
    lib.cnb_scores_argmax_f32.restype = ctypes.c_int


_LIBRARY = native.Library(SOURCE, _declare, "categorical_nb_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return _LIBRARY.get()


def count_plan(M: int, n_keys: int) -> Tuple[int, int, int]:
    """K17a's launch plan (nblk, keys_per_block, tile): ranges of at least
    ``_COUNT_KEYS`` keys (fewer where the partials would pass
    ``_COUNT_PARTIAL_INTS``), key tiles that fit a block's shared memory."""
    nblk = max(1, min(-(-M // _COUNT_KEYS), _COUNT_BLOCKS, _COUNT_PARTIAL_INTS // n_keys))
    per_block = -(-M // nblk)
    nblk = -(-M // per_block)
    return nblk, per_block, min(n_keys, _COUNT_TILE)


def cnb_count(keys: torch.Tensor, n_keys: int) -> torch.Tensor:
    """K17a: the int32 counts [n_keys] of ``keys`` [M] int32 (a key outside
    [0, n_keys) counts nowhere).

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    if keys.dim() != 1 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be [M] int32, got {tuple(keys.shape)} {keys.dtype}")
    if not 1 <= n_keys < 2**31:
        raise ValueError(f"n_keys must lie in [1, 2^31), got {n_keys}")
    if keys.device.type == "cpu":
        LAUNCHES.add("cnb_count_plain")
        return count_plain(keys, n_keys)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    dev, M = keys.device, keys.shape[0]
    counts = torch.zeros(n_keys, dtype=torch.int32, device=dev)
    if M == 0:
        return counts
    nblk, per_block, tile = count_plan(M, n_keys)
    partial = torch.empty((nblk, n_keys), dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cnb_count_i32(keys.data_ptr(), M, n_keys, nblk, per_block, tile,
                                partial.data_ptr(), counts.data_ptr(), stream)
    _LIBRARY.check(err, "cnb_count")
    LAUNCHES.add("cnb_count")
    return counts


def count_shard_bounds(M: int, n_keys: int, n_shards: int) -> np.ndarray:
    """Key boundaries [n_shards + 1] of K17s: the whole-M plan's blocks
    (``count_plan``) cut by ``split_rows`` over each block's keys, so every
    shard holds whole blocks (none where there are fewer blocks than
    shards, or no keys)."""
    if M == 0:
        return np.zeros(n_shards + 1, np.int64)
    nblk, per_block, _ = count_plan(M, n_keys)
    weights = np.full(nblk, per_block, np.int64)
    weights[-1] = M - per_block * (nblk - 1)
    return np.minimum(split_rows(weights, n_shards) * per_block, M)


def count_partial_plain(keys: torch.Tensor, n_keys: int, per_block: int) -> torch.Tensor:
    """The plain twin of K17a's pass 1: each block of ``per_block`` keys'
    histogram [nblk, n_keys] int32 (a key outside [0, n_keys) counts
    nowhere)."""
    nblk = -(-keys.shape[0] // per_block)
    valid = (keys >= 0) & (keys < n_keys)
    block = torch.arange(keys.shape[0], device=keys.device) // per_block
    flat = (block * n_keys + keys.long())[valid]
    return torch.bincount(flat, minlength=nblk * n_keys).to(torch.int32).view(nblk, n_keys)


def cnb_count_partial(
    keys: torch.Tensor, n_keys: int, per_block: int, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K17a's pass 1 alone, a K17s shard's launch: the per-block histograms
    [nblk, n_keys] int32 of ``keys`` [M] int32 (block b counts keys
    b·per_block..), written into ``out`` where given.

    CPU tensors go to the plain twin (``count_partial_plain``). CUDA
    tensors go to the kernel, which must build and launch or this raises."""
    if keys.dim() != 1 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be [M] int32, got {tuple(keys.shape)} {keys.dtype}")
    if not 1 <= n_keys < 2**31 or per_block < 1 or keys.shape[0] < 1:
        raise ValueError("cnb_count_partial needs M >= 1, n_keys in [1, 2^31), per_block >= 1")
    M, dev = keys.shape[0], keys.device
    nblk = -(-M // per_block)
    if out is not None and (tuple(out.shape) != (nblk, n_keys) or out.dtype != torch.int32
                            or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous [{nblk}, {n_keys}] int32 tensor on {dev}")
    if dev.type == "cpu":
        LAUNCHES.add("cnb_count_shard_plain")
        got = count_partial_plain(keys, n_keys, per_block)
        return got if out is None else out.copy_(got)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    out = out if out is not None else torch.empty((nblk, n_keys), dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cnb_count_partial_i32(keys.data_ptr(), M, n_keys, nblk, per_block,
                                        min(n_keys, _COUNT_TILE), out.data_ptr(), stream)
    _LIBRARY.check(err, "cnb_count_partial")
    LAUNCHES.add("cnb_count_shard")
    return out


def cnb_count_finish(partial: torch.Tensor) -> torch.Tensor:
    """K17a's pass 2 alone, K17s's last launch: the counts [n_keys] int32,
    the partials [nblk, n_keys] int32 added in block order.

    CPU tensors go to the plain twin (an integer ``sum``, exact). CUDA
    tensors go to the kernel, which must build and launch or this raises."""
    if partial.dim() != 2 or partial.dtype != torch.int32 or min(partial.shape) < 1:
        raise ValueError(f"partial must be [nblk, n_keys] int32, got {tuple(partial.shape)}")
    nblk, n_keys = partial.shape
    dev = partial.device
    if dev.type == "cpu":
        LAUNCHES.add("cnb_count_finish_plain")
        return partial.sum(0, dtype=torch.int64).to(torch.int32)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not partial.is_contiguous():
        raise ValueError("partial must be contiguous")
    counts = torch.empty(n_keys, dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cnb_count_finish_i32(partial.data_ptr(), nblk, n_keys, counts.data_ptr(),
                                       stream)
    _LIBRARY.check(err, "cnb_count_finish")
    LAUNCHES.add("cnb_count_finish")
    return counts


def cnb_count_shards(keys: Sequence[torch.Tensor], n_keys: int, device: torch.device) -> torch.Tensor:
    """K17s: the int32 counts [n_keys], on ``device``, of every shard's keys
    together. Shard s gives ``keys[s]`` [M_s] int32 on its device, the
    shards in order, each a whole number of the whole-M plan's blocks
    (``count_shard_bounds``; an empty shard has 0 keys). Each shard runs
    pass 1 (``cnb_count_partial``) into its blocks of the partials on
    ``device`` (a peer copy where it lies elsewhere) and one pass 2
    (``cnb_count_finish``) runs there: one device's ``cnb_count``, bit for
    bit."""
    if not keys:
        raise ValueError("one keys tensor per shard")
    if any(k.device.type != device.type for k in keys):
        raise ValueError(f"the shards must lie on {device.type} devices, as the result")
    if not 1 <= n_keys < 2**31:
        raise ValueError(f"n_keys must lie in [1, 2^31), got {n_keys}")
    sizes = [int(k.shape[0]) for k in keys]
    M = sum(sizes)
    if M == 0:
        return torch.zeros(n_keys, dtype=torch.int32, device=device)
    nblk, per_block, _ = count_plan(M, n_keys)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    if any(m and (k0 % per_block or (m % per_block and k0 + m != M))
           for k0, m in zip(starts, sizes)):
        raise ValueError(f"every shard must hold whole blocks of {per_block} keys "
                         "(count_shard_bounds)")
    partial = torch.empty((nblk, n_keys), dtype=torch.int32, device=device)
    for k0, k in zip(starts, keys):
        if not k.shape[0]:
            continue
        b0 = int(k0) // per_block
        b1 = b0 + -(-k.shape[0] // per_block)
        if k.device == device:
            cnb_count_partial(k, n_keys, per_block, out=partial[b0:b1])
        else:  # the peer copy of the shard's blocks
            partial[b0:b1].copy_(cnb_count_partial(k, n_keys, per_block))
    return cnb_count_finish(partial)


def cnb_count_mesh(keys: np.ndarray, n_keys: int, mesh: Mesh) -> torch.Tensor:
    """K17s over a 1-D ``data`` mesh: the host ``keys`` [M] int32 cut at the
    plan's block boundaries, each part uploaded to its shard's device, the
    counts on the mesh's first device."""
    bounds = count_shard_bounds(len(keys), n_keys, mesh.size)
    return cnb_count_shards(cut_rows(mesh, np.asarray(keys, np.int32), bounds), n_keys,
                            mesh.devices[0])


def cnb_scores_argmax(
    ll: torch.Tensor, log_priors: torch.Tensor, enc: torch.Tensor, known: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K17b: (the int32 label index [N] of each query row, its scores
    [N, L]) under ``ll`` [L, S, V] and ``log_priors`` [L] float32, for the
    codes ``enc`` [N, S] int32 and masks ``known`` [N, S] bool.

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    if ll.dim() != 3 or log_priors.dim() != 1 or enc.dim() != 2:
        raise ValueError("ll must be [L, S, V], log_priors [L] and enc [N, S]")
    L, S, V = ll.shape
    N = enc.shape[0]
    if log_priors.shape[0] != L or L < 1 or enc.shape[1] != S or tuple(known.shape) != (N, S):
        raise ValueError(f"shapes disagree: ll {tuple(ll.shape)}, log_priors "
                         f"{tuple(log_priors.shape)}, enc {tuple(enc.shape)}, known "
                         f"{tuple(known.shape)}")
    if ll.dtype != torch.float32 or log_priors.dtype != torch.float32:
        raise ValueError("ll and log_priors must be float32")
    if enc.dtype != torch.int32 or known.dtype != torch.bool:
        raise ValueError("enc must be int32 and known bool")
    if not (ll.device == log_priors.device == enc.device == known.device):
        raise ValueError("ll, log_priors, enc and known must be on one device")
    if ll.device.type == "cpu":
        LAUNCHES.add("cnb_scores_argmax_plain")
        scores = scores_plain(ll, log_priors, enc, known)
        return argmax_first_nan(scores), scores
    if ll.device.type != "cuda":
        raise ValueError(f"unsupported device {ll.device}")
    if not all(t.is_contiguous() for t in (ll, log_priors, enc, known)):
        raise ValueError("ll, log_priors, enc and known must be contiguous")
    dev = ll.device
    labels = torch.empty(N, dtype=torch.int32, device=dev)
    scores = torch.empty((N, L), dtype=torch.float32, device=dev)
    if N == 0:
        return labels, scores
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cnb_scores_argmax_f32(
            ll.data_ptr(), log_priors.data_ptr(), enc.data_ptr(), known.data_ptr(),
            N, L, S, V, scores.data_ptr(), labels.data_ptr(), stream,
        )
    _LIBRARY.check(err, "cnb_scores_argmax")
    LAUNCHES.add("cnb_scores_argmax")
    return labels, scores
