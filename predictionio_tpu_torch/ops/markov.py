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

K16s, the step on a 1-D ``data`` mesh (the reference's ``predict`` :70-91):
``place_transitions_mesh`` cuts the source states into contiguous shards
and places each shard's kept transitions, a target-major CSR of its own
sources, on its device once; ``markov_step_shards`` runs each shard's
partial next-state vector in float64, unrounded (``markov_step_partial``,
twin ``markov_partial_plain``), into its row of one [S, n] array on the
first device (a peer copy, none where the shard shares that device) and
adds the rows there in shard order, rounding once (``markov_sum_shards``,
twin ``sum_shards_plain``). Its
sums run in another order than one device's, so an entry may lie one
float32 step from one device's (``csrc/markov.cu``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts
from predictionio_tpu_torch.parallel.mesh import split_rows

SOURCE = "markov.cu"

# K16s counts as "markov_step_shard" (a shard's partial) and "markov_step_finish"
LAUNCHES = LaunchCounts("markov_step", "markov_step_plain", "markov_step_shard",
                        "markov_step_finish", "markov_step_shard_plain",
                        "markov_step_finish_plain")

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


class MeshTransitions(NamedTuple):
    """The kept transitions of an ``n_states`` chain on a mesh: shard s holds
    sources ``bounds[s]:bounds[s + 1]`` as a target-major CSR on its device
    (sources numbered from the shard's first; None where it has none)."""

    n_states: int
    bounds: np.ndarray  # [S + 1] source-state boundaries
    shards: Tuple[Optional[PlacedTransitions], ...]
    device: torch.device  # where the partials are added: the mesh's first


def place_transitions_mesh(
    targets: np.ndarray, probs: np.ndarray, n_states: int, devices: Sequence[torch.device]
) -> MeshTransitions:
    """The kept transitions [n_states, top_n] on the shards' ``devices``: the
    source states cut into contiguous ranges of about equal size, each
    range's transitions placed on its shard's device once."""
    targets = np.asarray(targets).reshape(n_states, -1)
    probs = np.asarray(probs, np.float32).reshape(n_states, -1)
    bounds = split_rows(np.ones(n_states, np.int64), len(devices))
    shards = tuple(
        place_transitions(targets[i0:i1], probs[i0:i1], n_states, d) if i1 > i0 else None
        for d, i0, i1 in zip(devices, bounds[:-1], bounds[1:])
    )
    return MeshTransitions(n_states, bounds, shards, devices[0])


def entry_targets(placed: PlacedTransitions) -> torch.Tensor:
    """[E] int64: the target of each kept transition, read off the CSR's
    chunk offsets."""
    dev = placed.src.device
    chunk_target = torch.repeat_interleave(
        torch.arange(placed.n_states, device=dev), torch.diff(placed.target_chunk).long()
    )
    return torch.repeat_interleave(chunk_target, torch.diff(placed.chunk_start).long())


def markov_partial_plain(cur: torch.Tensor, placed: PlacedTransitions) -> torch.Tensor:
    """The plain twin of a K16s shard: the float32 products of its kept
    transitions (``cur`` the shard's slice) added by ``index_add_`` into
    each entry's target in float64, unrounded."""
    out = torch.zeros(placed.n_states, dtype=torch.float64, device=cur.device)
    contrib = placed.prob * cur[placed.src.long()]
    return out.index_add_(0, entry_targets(placed), contrib.double())


def markov_step_plain(cur: torch.Tensor, placed: PlacedTransitions) -> torch.Tensor:
    """The plain twin of K16: the float32 products ``prob·cur[src]`` added
    by ``index_add_`` into each entry's target in float64, then rounded to
    float32."""
    return markov_partial_plain(cur, placed).float()


def sum_shards_plain(parts: torch.Tensor) -> torch.Tensor:
    """The plain twin of K16s's sum: the shards' float64 partials [S, n]
    added in shard order, rounded once to float32."""
    acc = torch.zeros_like(parts[0])
    for part in parts:
        acc = acc + part
    return acc.float()


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.markov_step_f32.argtypes = [p, p, p, p, p, i, i, p, p, p]
    lib.markov_step_f32.restype = ctypes.c_int
    lib.markov_step_partial_f64.argtypes = [p, p, p, p, p, i, i, p, p, p]
    lib.markov_step_partial_f64.restype = ctypes.c_int
    lib.markov_sum_shards_f32.argtypes = [p, i, i, p, p]
    lib.markov_sum_shards_f32.restype = ctypes.c_int


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


def markov_step_partial(
    cur: torch.Tensor, placed: PlacedTransitions, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """A K16s shard's launch: the unrounded partial next-state vector [n]
    float64 of its state slice ``cur`` [rows] float32 under its CSR
    ``placed`` (sources numbered from the shard's first), written into
    ``out`` where given.

    CPU tensors go to the plain twin (``markov_partial_plain``). CUDA
    tensors go to the kernel, which must build and launch or this raises."""
    n, dev = placed.n_states, cur.device
    if cur.dim() != 1 or cur.dtype != torch.float32:
        raise ValueError(f"a shard's state slice must be [rows] float32, got "
                         f"{tuple(cur.shape)} {cur.dtype}")
    if dev != placed.src.device:
        raise ValueError(f"the state slice is on {dev}, the transitions on {placed.src.device}")
    if out is not None and (tuple(out.shape) != (n,) or out.dtype != torch.float64
                            or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous [{n}] float64 tensor on {dev}")
    if dev.type == "cpu":
        LAUNCHES.add("markov_step_shard_plain")
        got = markov_partial_plain(cur, placed)
        return got if out is None else out.copy_(got)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not cur.is_contiguous():
        raise ValueError("the state slice must be contiguous")
    out = out if out is not None else torch.empty(n, dtype=torch.float64, device=dev)
    if n == 0:
        return out
    scratch = torch.empty(max(placed.n_chunks, 1), dtype=torch.float64, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.markov_step_partial_f64(
            cur.data_ptr(), placed.src.data_ptr(), placed.prob.data_ptr(),
            placed.chunk_start.data_ptr(), placed.target_chunk.data_ptr(), n, placed.n_chunks,
            scratch.data_ptr(), out.data_ptr(), stream,
        )
    _LIBRARY.check(err, "markov_step_partial")
    LAUNCHES.add("markov_step_shard")
    return out


def markov_sum_shards(parts: torch.Tensor) -> torch.Tensor:
    """K16s's last launch: the next-state vector [n] float32, the shards'
    partials ``parts`` [S, n] float64 added in shard order and rounded
    once.

    CPU tensors go to the plain twin (``sum_shards_plain``). CUDA tensors
    go to the kernel, which must build and launch or this raises."""
    if parts.dim() != 2 or parts.dtype != torch.float64 or parts.shape[0] < 1:
        raise ValueError(f"parts must be [S, n] float64, got {tuple(parts.shape)} {parts.dtype}")
    S, n = parts.shape
    dev = parts.device
    if dev.type == "cpu":
        LAUNCHES.add("markov_step_finish_plain")
        return sum_shards_plain(parts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not parts.is_contiguous():
        raise ValueError("parts must be contiguous")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.markov_sum_shards_f32(parts.data_ptr(), S, n, out.data_ptr(), stream)
    _LIBRARY.check(err, "markov_sum_shards")
    LAUNCHES.add("markov_step_finish")
    return out


def markov_step_shards(curs: Sequence[Optional[torch.Tensor]], placed: MeshTransitions) -> torch.Tensor:
    """K16s: the next-state vector [n] float32, on ``placed.device``, of the
    state vector given as its shards' slices ``curs[s]`` [rows_s] float32
    (each on its shard's device; None or 0 rows where the shard has no
    sources). Each shard writes its float64 partial
    (``markov_step_partial``) into its row of one [S, n] array on
    ``placed.device`` (a peer copy where it lies elsewhere), and
    ``markov_sum_shards`` adds the rows in shard order there."""
    n, dev0 = placed.n_states, placed.device
    if len(curs) != len(placed.shards):
        raise ValueError(f"{len(curs)} state slices for {len(placed.shards)} shards")
    work = []
    for cur, sh, i0, i1 in zip(curs, placed.shards, placed.bounds[:-1], placed.bounds[1:]):
        if sh is None:
            if cur is not None and cur.numel():
                raise ValueError("a shard without sources got a state slice")
            continue
        if cur is None or tuple(cur.shape) != (int(i1 - i0),) or cur.device.type != dev0.type:
            raise ValueError(f"shard {len(work)}'s state slice must be [{int(i1 - i0)}] on a "
                             f"{dev0.type} device")
        work.append((cur, sh))
    if not work:
        return torch.zeros(n, dtype=torch.float32, device=dev0)
    parts = torch.empty((len(work), n), dtype=torch.float64, device=dev0)
    for k, (cur, sh) in enumerate(work):
        if cur.device == dev0:
            markov_step_partial(cur, sh, out=parts[k])
        else:  # the peer copy of the shard's partial
            parts[k].copy_(markov_step_partial(cur, sh))
    return markov_sum_shards(parts)
