"""K3, the serving score + top-n, packed: the counterpart of the reference's
jitted program ``predictionio_tpu/ops/als.py:2354 _topn_packed_impl``
(``_topn_packed`` at :2365).

``topn_packed(q, Y, n)`` returns ``[B, 2n]`` float32: per query row the n
best item scores (``q·Yᵀ``), descending, then the n int32 item ids as raw
bits. Ties break lowest index first, as ``lax.top_k`` does.

Three forms, one function:
- the hand-written CUDA kernel for Hopper, ``csrc/topn.cu`` (its header
  states the bound on the card and the design), built with nvcc at first
  use and called through ``ctypes``;
- the plain PyTorch twin ``topn_packed_plain``: an f32 product and a
  STABLE descending sort (``torch.topk`` does not fix the order of ties);
- the wrapper ``topn_packed``, which routes a CPU tensor to the twin and a
  CUDA tensor to the kernel. On a CUDA tensor it launches the kernel or
  raises; it never falls back to the twin. ``LAUNCHES`` counts what it ran.

K3c, ``topn_chain(q, Y, n, n_iters)``, is the counterpart of the
reference's timing program ``predictionio_tpu/ops/als.py:2382
_topn_packed_chain``: ``n_iters`` K3 passes enqueued back to back by one
host call, pass i on the query ``q + float32(i)·float32(1e-7)``
(``chain_offset``), returning the last pass's packed rows. Its kernel is
K3's with the offset added as the query is loaded (``csrc/topn.cu``
``topn_f32`` with ``n_iters`` >= 1); its twin ``topn_chain_plain`` loops
``topn_packed_plain`` over the offset queries. ``ServingFactors.measure_compute_ms``
(``ops/als.py``) times it.

K3s, the mesh serving path's form: ``topn_packed(q, Y, n, table=t)`` and
``topn_chain(..., table=t)`` run K3 (K3c) once over a device's upload of
its shards' query rows (``TopnTable``: per shard its block of rows in the
upload and the block of the result it writes, built once per padded batch
size by ``ServingFactors(mesh)``), each row into its shard's block of one
``[t.size, 2n]`` result. A row's answer does not depend on its table, so it
is K3's on the whole batch bit for bit. The twin runs once over the upload
and places the rows (``topn_table_plain``); every form counts one launch a
call.

The wrapper is lean: the kernel's entry point makes the device current, the
stream comes from ``native.current_stream``, and a call makes one
allocation (the result and the kernel's scratch together; only the scratch
where the caller passes ``out``).
"""

from __future__ import annotations

import ctypes
import functools
from array import array
from typing import Optional, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops.native import LaunchCounts

SOURCE = "topn.cu"
_MAX_B = 65535 * 8  # the kernel's grid holds 8 query rows per y-block
MAX_SHARDS = 64  # a shard table's most shards (the merge kernel's parameters)


# "topn_packed": kernel launches (one per table for K3s); "topn_packed_plain":
# CPU calls the wrapper routed to the plain twin; the same for K3c
LAUNCHES = LaunchCounts("topn_packed", "topn_packed_plain", "topn_chain", "topn_chain_plain")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.topn_f32.argtypes = [i, p, p, p, p, p, i, i, i, i, i, p]
    lib.topn_f32.restype = i
    lib.topn_scratch_floats.argtypes = [i] * 3
    lib.topn_scratch_floats.restype = ctypes.c_longlong


_LIBRARY = native.Library(SOURCE, _declare, "topn_error_string")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    return _LIBRARY.get()


@functools.lru_cache(maxsize=256)
def _scratch_floats(B: int, N: int, n: int) -> int:
    """Floats of scratch the kernel needs for B query rows (the library's
    answer, asked once per shape)."""
    return int(_LIBRARY.get().topn_scratch_floats(B, N, n))


class TopnTable:
    """K3s's shard table on one device: shard s takes ``rows[s]`` query rows
    of the device's upload, the shards back to back in table order, and
    writes them to rows ``out0[s]:out0[s] + rows[s]`` of a ``[size, 2n]``
    result (blocks in any order, not overlapping). Built once per padded
    batch size; each call passes the kernel one pointer."""

    def __init__(self, device, rows: Sequence[int], out0: Sequence[int], size: int):
        rows, out0 = [int(r) for r in rows], [int(o) for o in out0]
        if not 1 <= len(rows) <= MAX_SHARDS or len(out0) != len(rows):
            raise ValueError(f"a table holds 1 to {MAX_SHARDS} shards, each with a block; "
                             f"got {len(rows)} shards and {len(out0)} blocks")
        blocks = sorted((o, o + r) for r, o in zip(rows, out0) if r)
        if any(r < 0 for r in rows) or any(
                not 0 <= a <= b <= size for a, b in blocks) or any(
                b > a2 for (_, b), (a2, _) in zip(blocks, blocks[1:])):
            raise ValueError(f"each shard's block must lie inside [0, {size}) and "
                             f"overlap no other: rows {rows}, blocks at {out0}")
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device}")
        self.device, self.rows, self.out0 = device, tuple(rows), tuple(out0)
        self.size, self.n_rows = int(size), sum(rows)
        if device.type == "cuda":
            cells, r0 = [len(rows)], 0
            for r, o in zip(rows, out0):
                cells += [r0, o]
                r0 += r
            self._table = array("q", cells)
            self._addr = self._table.buffer_info()[0]


def pack_topn(scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[B, 2n]``: scores, then the int32 ids as raw float32 bits (a
    bitcast, never a float cast, so ids >= 2^24 survive)."""
    bits = idx.to(torch.int32).contiguous().view(torch.float32)
    return torch.cat([scores.to(torch.float32), bits], dim=1)


def topn_packed_plain(q: torch.Tensor, Y: torch.Tensor, n: int) -> torch.Tensor:
    """The plain twin: f32 ``q @ Y.T``, a stable descending sort (ties keep
    ascending index order), the first n, packed."""
    scores = q @ Y.T
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return pack_topn(s[:, :n], i[:, :n])


def _check(q: torch.Tensor, Y: torch.Tensor, n: int) -> torch.device:
    """Refuse what the kernel does not take; return the inputs' device."""
    qs, ys = q.shape, Y.shape
    if len(qs) != 2 or len(ys) != 2:
        raise ValueError(f"q and Y must be 2-D, got {tuple(qs)} and {tuple(ys)}")
    if q.dtype != torch.float32 or Y.dtype != torch.float32:
        raise TypeError(f"q and Y must be float32, got {q.dtype} and {Y.dtype}")
    if qs[1] != ys[1] or qs[1] < 1:
        raise ValueError(f"rank mismatch: q is {tuple(qs)}, Y is {tuple(ys)}")
    if not 1 <= qs[0] <= _MAX_B:
        raise ValueError(f"batch {qs[0]} out of range [1, {_MAX_B}]")
    if not 1 <= ys[0] < 2**31:
        raise ValueError(f"catalog size {ys[0]} out of range [1, 2^31)")
    if not 1 <= n <= ys[0]:
        raise ValueError(f"n={n} out of range [1, N={ys[0]}]")
    dev = q.device
    if dev != Y.device:
        raise ValueError(f"q is on {dev} but Y is on {Y.device}")
    return dev


def check_out(out: Optional[torch.Tensor], shape, device) -> None:
    """A caller's output tensor must be a contiguous float32 tensor of
    ``shape`` on the inputs' device."""
    if out is not None and (
        out.dtype != torch.float32 or tuple(out.shape) != tuple(shape)
        or out.device != device or not out.is_contiguous()
    ):
        raise ValueError(f"out must be a contiguous float32 {list(shape)} on {device}")


def _check_table(q: torch.Tensor, dev: torch.device, table: Optional[TopnTable]) -> int:
    """The result's rows: q's, or the table's size once q (on ``dev``) is
    its upload."""
    if table is None:
        return q.shape[0]
    if q.shape[0] != table.n_rows or dev != table.device:
        raise ValueError(f"q must be the table's upload: {table.n_rows} rows on "
                         f"{table.device}, got {q.shape[0]} on {dev}")
    return table.size


def topn_table_plain(res: torch.Tensor, table: TopnTable,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The twin side of a shard table: the upload's packed rows ``res`` (the
    plain twin's answer over the whole upload) placed in their shards'
    blocks of ``out`` (new when not given), whose other rows are left as
    they are."""
    if out is None:
        out = res.new_empty((table.size, res.shape[1]))
    r0 = 0
    for r, o in zip(table.rows, table.out0):
        out[o:o + r] = res[r0:r0 + r]
        r0 += r
    return out


def topn_packed(
    q: torch.Tensor, Y: torch.Tensor, n: int, out: Optional[torch.Tensor] = None,
    table: Optional[TopnTable] = None,
) -> torch.Tensor:
    """K3 on ``q [B,k]`` and ``Y [N,k]`` float32 -> ``[B, 2n]`` float32; with
    a ``table`` (q its upload of B = ``table.n_rows`` rows), K3s: each row
    into its shard's block of a ``[table.size, 2n]`` result, one launch.
    ``out`` when given: a contiguous float32 tensor of the result's shape.

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    n = int(n)
    dev = _check(q, Y, n)
    rows = _check_table(q, dev, table)
    check_out(out, (rows, 2 * n), dev)
    if dev.type == "cpu":
        LAUNCHES.add("topn_packed_plain")
        res = topn_packed_plain(q, Y, n)
        if table is not None:
            return topn_table_plain(res, table, out)
        return res if out is None else out.copy_(res)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch("topn_packed", q, Y, n, 0, table, rows, out, dev)


def _launch(
    name: str, q: torch.Tensor, Y: torch.Tensor, n: int, n_iters: int,
    table: Optional[TopnTable], rows: int, out: Optional[torch.Tensor], dev: torch.device,
) -> torch.Tensor:
    """Launch K3 (``n_iters`` 0) or K3c on CUDA tensors on ``dev`` that the
    checks accepted, into ``out`` or a new ``[rows, 2n]`` result allocated
    with the kernel's scratch behind it; count the launch."""
    if not (q.is_contiguous() and Y.is_contiguous()):
        raise ValueError("q and Y must be contiguous (row-major)")
    B, k = q.shape
    N = Y.shape[0]
    floats = _scratch_floats(B, N, n)
    if out is None:
        # the result's rows, then the scratch, in one allocation
        buf = torch.empty((rows + -(-floats // (2 * n)), 2 * n), dtype=torch.float32, device=dev)
        out = buf[:rows]
        scratch = buf.data_ptr() + rows * 2 * n * 4
    else:
        buf = torch.empty(floats, dtype=torch.float32, device=dev)
        scratch = buf.data_ptr()
    err = _LIBRARY.get().topn_f32(
        dev.index, None if table is None else table._addr, q.data_ptr(), Y.data_ptr(),
        out.data_ptr(), scratch, B, N, k, n, n_iters, native.current_stream(dev.index))
    if err:
        _LIBRARY.check(err, name)
    LAUNCHES.add(name)
    return out


def chain_offset(i: int) -> np.float32:
    """The query offset of K3c's pass ``i``: ``float32(i) · float32(1e-7)``,
    one float32 rounding, as the reference forms it."""
    return np.float32(i) * np.float32(1e-7)


def topn_chain_plain(q: torch.Tensor, Y: torch.Tensor, n: int, n_iters: int) -> torch.Tensor:
    """The plain twin of K3c: ``topn_packed_plain`` on ``q + chain_offset(i)``
    for i in 0..n_iters-1; the last pass's result."""
    out = None
    for i in range(int(n_iters)):
        off = torch.tensor(chain_offset(i), dtype=torch.float32, device=q.device)
        out = topn_packed_plain(q + off, Y, n)
    return out


def topn_chain(
    q: torch.Tensor, Y: torch.Tensor, n: int, n_iters: int,
    table: Optional[TopnTable] = None, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K3c on ``q [B,k]`` and ``Y [N,k]`` float32: ``n_iters`` >= 1 chained
    K3 passes, pass i on ``q + chain_offset(i)``; the last pass's ``[B, 2n]``
    (with a ``table``, placed as ``topn_packed`` places K3s's rows). One
    call counts one launch (of ``n_iters`` passes).

    CPU tensors go to the plain twin. CUDA tensors go to the kernel, which
    must build and launch or this raises."""
    n, n_iters = int(n), int(n_iters)
    dev = _check(q, Y, n)
    if n_iters < 1:
        raise ValueError(f"n_iters={n_iters} must be at least 1")
    rows = _check_table(q, dev, table)
    check_out(out, (rows, 2 * n), dev)
    if dev.type == "cpu":
        LAUNCHES.add("topn_chain_plain")
        res = topn_chain_plain(q, Y, n, n_iters)
        if table is not None:
            return topn_table_plain(res, table, out)
        return res if out is None else out.copy_(res)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch("topn_chain", q, Y, n, n_iters, table, rows, out, dev)


def check_topn_agreement(
    scores: np.ndarray,
    ids: np.ndarray,
    ref_scores: np.ndarray,
    ref_ids: np.ndarray,
    rtol: float = 1e-5,
    atol: float = 1e-6,
    q: Optional[np.ndarray] = None,
    Y: Optional[np.ndarray] = None,
) -> float:
    """Hold a top-n result against a reference computed with another
    summation order; return the largest absolute score difference.

    Scores must agree within ``atol + rtol·|ref|``. Ids must be unique per
    row and equal to the reference's, except inside a run of consecutive
    reference scores that lie within that tolerance of each other (a
    near-tie the two summation orders may order differently): there the id
    sets must agree. A run that reaches the end of the list may go on past
    it, so there the ids may differ. Given the inputs ``q`` and ``Y``, each
    reported score is also held against its id's float64 score. Raises
    ``AssertionError`` on disagreement."""
    scores, ids = np.atleast_2d(scores), np.atleast_2d(ids)
    ref_scores, ref_ids = np.atleast_2d(ref_scores), np.atleast_2d(ref_ids)
    if scores.shape != ref_scores.shape or ids.shape != ref_ids.shape:
        raise AssertionError(
            f"shape {scores.shape}/{ids.shape} != reference "
            f"{ref_scores.shape}/{ref_ids.shape}"
        )
    s = scores.astype(np.float64)
    r = ref_scores.astype(np.float64)
    tol = atol + rtol * np.abs(r)
    err = np.abs(s - r)
    if not np.all(err <= tol):
        row, col = np.argwhere(err > tol)[0]
        raise AssertionError(
            f"score mismatch at [{row}, {col}]: {s[row, col]!r} vs "
            f"{r[row, col]!r}"
        )
    n = r.shape[1]
    for row in range(r.shape[0]):
        if len(set(ids[row].tolist())) != n:
            raise AssertionError(f"row {row}: repeated ids {ids[row]}")
        if q is not None and Y is not None:
            exact = Y[ids[row]].astype(np.float64) @ q[row].astype(np.float64)
            if not np.all(np.abs(s[row] - exact) <= atol + rtol * np.abs(exact)):
                raise AssertionError(
                    f"row {row}: reported scores {s[row]} are not the "
                    f"scores {exact} of ids {ids[row]}"
                )
        start = 0
        while start < n:
            end = start + 1
            while end < n and abs(r[row, end] - r[row, end - 1]) <= tol[row, end - 1]:
                end += 1
            a, b = ids[row, start:end], ref_ids[row, start:end]
            if end < n and set(a.tolist()) != set(b.tolist()):
                raise AssertionError(
                    f"row {row}: ids {a} vs reference {b} in positions "
                    f"[{start}, {end})"
                )
            start = end
    return float(err.max()) if err.size else 0.0
