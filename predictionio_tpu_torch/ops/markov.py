"""K16, one Markov-chain step: the counterpart of
``predictionio_tpu/e2/markov_chain.py:127 _step`` (reference
e2/src/main/scala/io/prediction/e2/engine/MarkovChain.scala:68-88):

  next[j] = Σ_i cur[i]·probs[i, k]  over the kept transitions targets[i, k] = j.

- ``place_transitions(targets, probs, device)``: the kept transitions as a
  target-major CSR on ``device``, built once on the host at placement
  (each target's sources and probabilities in source order, in chunks of
  at most ``CHUNK`` entries), which both the kernel and the twin read;
- ``markov_step(cur, placed)``: the step.

Three forms of the step, one function:
- the hand-written CUDA kernel for Hopper, ``csrc/markov.cu`` (its header
  states the bound and the design: a gather per target in a fixed order,
  summed in float64, so every launch gives the same bits);
- the plain PyTorch twin ``markov_step_plain``: ``index_add_`` of the
  float32 products ``prob·cur[src]`` into each entry's target, in float64,
  rounded once;
- the wrapper, which routes CPU tensors to the twin and CUDA tensors to the
  kernel (launch or raise, no fallback). ``LAUNCHES`` counts what it ran.

Entries of zero probability (the reference's padding) and targets outside
[-n, n) add nothing, and a negative target counts from the end, as in the
reference's ``.at[targets].add(..., mode="drop")``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts

SOURCE = "markov.cu"

LAUNCHES = LaunchCounts("markov_step", "markov_step_plain")

CHUNK = 256  # entries of one target a warp sums at most


class PlacedTransitions(NamedTuple):
    """The kept transitions of an ``n_states`` chain on one device, as a
    target-major CSR."""

    n_states: int
    src: torch.Tensor  # [E] int32, source of each kept transition
    prob: torch.Tensor  # [E] float32
    chunk_start: torch.Tensor  # [n_chunks + 1] int32 entry offsets
    target_chunk: torch.Tensor  # [n_states + 1] int32 chunk offsets

    @property
    def n_chunks(self) -> int:
        return self.chunk_start.shape[0] - 1


def build_csr(targets: np.ndarray, probs: np.ndarray, n_states: int):
    """(src, prob, chunk_start, target_chunk) of the kept transitions,
    target-major, sources ascending within a target, zero probabilities and
    out-of-range targets left out (a negative target counts from the end,
    as the reference's indexing wraps it); a target's entries cut into
    chunks of at most ``CHUNK``."""
    t = np.asarray(targets).reshape(-1).astype(np.int64)
    p = np.asarray(probs, np.float32).reshape(-1)
    top_n = np.asarray(targets).shape[1] if np.asarray(targets).ndim == 2 else 1
    source = np.repeat(np.arange(len(t) // max(top_n, 1), dtype=np.int64), top_n)
    t = np.where(t < 0, t + n_states, t)  # the reference wraps negative indices
    keep = (p != 0) & (t >= 0) & (t < n_states)
    if int(keep.sum()) >= 2**31:
        raise ValueError("more than 2^31 - 1 kept transitions")
    t, p, source = t[keep], p[keep], source[keep]
    order = np.argsort(t, kind="stable")  # row-major flattening: sources ascend
    t, p, source = t[order], p[order], source[order]
    per_target = np.bincount(t, minlength=n_states)
    chunks = -(-per_target // CHUNK)
    target_chunk = np.zeros(n_states + 1, np.int64)
    np.cumsum(chunks, out=target_chunk[1:])
    entry_start = np.zeros(n_states + 1, np.int64)
    np.cumsum(per_target, out=entry_start[1:])
    # chunk c of target j starts at entry_start[j] + (c - target_chunk[j]) * CHUNK
    owner = np.repeat(np.arange(n_states), chunks)
    local = np.arange(int(target_chunk[-1])) - target_chunk[owner]
    chunk_start = np.empty(int(target_chunk[-1]) + 1, np.int64)
    chunk_start[:-1] = entry_start[owner] + local * CHUNK
    chunk_start[-1] = len(t)
    return (source.astype(np.int32), p, chunk_start.astype(np.int32),
            target_chunk.astype(np.int32))


def place_transitions(
    targets: np.ndarray, probs: np.ndarray, n_states: int, device: torch.device
) -> PlacedTransitions:
    """The kept transitions [n_states, top_n] placed on ``device``: built
    once, reused by every step."""
    src, prob, chunk_start, target_chunk = build_csr(targets, probs, n_states)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PlacedTransitions(
        n_states, up(src), up(prob), up(chunk_start), up(target_chunk)
    )


def entry_targets(placed: PlacedTransitions) -> torch.Tensor:
    """[E] int64: the target of each kept transition, read off the CSR's
    chunk offsets."""
    dev = placed.src.device
    chunk_target = torch.repeat_interleave(
        torch.arange(placed.n_states, device=dev), torch.diff(placed.target_chunk).long()
    )
    return torch.repeat_interleave(chunk_target, torch.diff(placed.chunk_start).long())


def markov_step_plain(cur: torch.Tensor, placed: PlacedTransitions) -> torch.Tensor:
    """The plain twin of K16: the float32 products ``prob·cur[src]`` added
    by ``index_add_`` into each entry's target in float64, then rounded to
    float32."""
    out = torch.zeros(placed.n_states, dtype=torch.float64, device=cur.device)
    contrib = placed.prob * cur[placed.src.long()]
    out.index_add_(0, entry_targets(placed), contrib.double())
    return out.float()


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.markov_step_f32.argtypes = [p, p, p, p, p, i, i, p, p, p]
    lib.markov_step_f32.restype = ctypes.c_int


_LIBRARY = native.Library(SOURCE, _declare, "markov_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    return _LIBRARY.get()


def markov_step(cur: torch.Tensor, placed: PlacedTransitions) -> torch.Tensor:
    """K16: the next-state vector [n] float32 of ``cur`` [n] float32 under
    ``placed`` (on ``cur``'s device).

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    n = placed.n_states
    if cur.dtype != torch.float32 or tuple(cur.shape) != (n,):
        raise ValueError(f"the state vector must be [{n}] float32, got "
                         f"{tuple(cur.shape)} {cur.dtype}")
    if cur.device != placed.src.device:
        raise ValueError(f"the state vector is on {cur.device}, the transitions "
                         f"on {placed.src.device}")
    if cur.device.type == "cpu":
        LAUNCHES.add("markov_step_plain")
        return markov_step_plain(cur, placed)
    if cur.device.type != "cuda":
        raise ValueError(f"unsupported device {cur.device}")
    if not cur.is_contiguous():
        raise ValueError("the state vector must be contiguous")
    dev = cur.device
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    partial = torch.empty(max(placed.n_chunks, 1), dtype=torch.float64, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.markov_step_f32(
            cur.data_ptr(), placed.src.data_ptr(), placed.prob.data_ptr(),
            placed.chunk_start.data_ptr(), placed.target_chunk.data_ptr(), n,
            placed.n_chunks, partial.data_ptr(), out.data_ptr(), stream,
        )
    _LIBRARY.check(err, "markov_step")
    LAUNCHES.add("markov_step")
    return out
