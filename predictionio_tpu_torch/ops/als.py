"""ALS training and serving: the counterpart of
``predictionio_tpu/ops/als.py`` for one GPU, explicit and implicit
feedback, exact and subspace solvers.

Training is the reference's single-device route (``train_als`` with
``mesh=None``, :1788-1815): ``build_host_wire`` :1306 / ``finish_wire``
:1350 sort the COO by user and narrow it into a ``HostWire`` :1263,
``device_pack_from_wire`` :1582 uploads it and builds both sides' padded
segment planes on the card with K4 and K5 (``ops/device_pack.py``), and
``train_from_wire`` :1653 runs the loop; ``ops/streaming.py`` builds the
same wire from a stream. The host code is copied as numpy and gives the
same bytes as the reference's: ``ALSConfig`` :79, ``_segment_geometry``
:258, the wire helpers :332-399, ``aux_pad`` :1252, ``_bucket_count``
:1155, ``auto_segment_length`` :1172, ``_padded_rows`` :1385,
``_factor_init_host`` :1392, ``_lam_obs_host`` :1405. ``PackedSide`` /
``pack_segments`` :196 and ``device_pack`` are the reference's host
packer (its mesh branch, :1817-1897), kept for the multi-GPU route. The
device loop (``_run_iterations``, the reference's fused program :837) is
a host loop of two hand-written kernels per half-step: K1
(``ops/normal_eq.py``, the normal equations) and K2
(``ops/spd_solve.py``, the regularized solve, whose epilogue also sums
the sweep telemetry). Implicit feedback (``implicit_prefs=True``, MLlib's
trainImplicit) adds K12 (``ops/gramian.py``): before each half-step the
Gramian G of the counter side's padded factors, which K2 adds to every
system, and with telemetry the objective once per sweep. The iALS++
solver (``solver="subspace"``, :640 ``_solve_side_subspace``) replaces K1
and K2 by K11 (``ops/subspace.py``): per half-step, per column block of
width ``block_size``, K11a forms the block systems and residuals and K11b
solves them and updates the block in place, with one telemetry row per
block. ``predict_ratings`` / ``rmse`` run K7 (``ops/predict_pairs.py``).
``train_als_grid`` (:1023) trains the regularizer variants of one
configuration together, as an evaluation's grid does: both sides packed
once on the host (``mesh_pack_side``), then ``_run_iterations_grid`` (the
reference's :942), per half-step one K13a and one K13b launch
(``ops/grid.py``) for every variant (one device is a mesh of one row
shard). ``train_from_wire`` takes the
resident pack's geometry and hands back its final factors
(``ops/streaming.py`` delta rounds). ``compute_dtype="bfloat16"`` (the
reference's headline training config) runs the bfloat16 forms of the
accumulating kernels, K1-bf16, K11a-bf16, K12b-bf16 and, in the grid,
K13a-bf16: the gathered factor rows and the weights are rounded to bfloat16
where the reference casts them, and every product is formed exactly and
summed in float32; the factors, the systems and the solves (K2, K11b,
K13b, K12a) stay float32. ``checkpoint_dir`` saves the factors every
``checkpoint_every`` sweeps (``workflow/checkpoint.py``) and resumes a run
of the same data and config from its latest save (the reference's
``_train_packed`` :2130-2235).

On a 1-D ``data`` mesh (``parallel/mesh.py``; the reference's mesh route,
:1817-1897, and its sharded loop, K6s and K13s) ``train_als(mesh=)`` and
``train_als_grid(mesh=)`` pack on the host and shard ROWS, not segments:
``split_rows`` cuts each side into contiguous row ranges of about equal
segment slots, and shard s solves its range with its own pack (its rows
numbered from 0, the same L and per-row observation order as one device's
pack). Each distinct device holds one replica of both factor arrays; per
half-step every shard runs the single-device kernels on its rows (K1 then
K2 into its range of the next array, or K11a/K11b in place; K13a/K13b for
the grid), then its rows are copied to the other devices' replicas (the
all-gather; none on one card). Implicit mode forms G per device with K12a
over the rows one device pads to (the rest are zero), and the objective
from every shard's K12b partials and one finish. So every real row's
factors equal one device's bit for bit; only the telemetry's cross-shard
sums change order, and its RMS divides by the mesh's padded rows
(``_padded_rows(n, n_shards)``), as the reference's does.

Serving (slice 1): ``ALSModelArrays`` :1233, ``ServingFactors``
:2402-2558, ``recommend_batch`` :2560, ``_unpack_indices`` :2575.
``ServingFactors`` uploads the item matrix to its device once. Each
batch then pads its query rows to a power of two (min 8, the reference's
bucketing), launches K3 (``ops/topn.py``) and makes ONE device→host copy
of the packed ``[B, 2n]`` result; a batch of more than ``MAX_QUERY_ROWS``
rows (an evaluation fold's queries) goes in chunks of that many, which
bounds K3's scratch. ``measure_compute_ms`` times K3 on the device through
K3c's chained passes (``topn_chain``). With a ``mesh``
(``parallel/mesh.py``) ``ServingFactors`` is K3s: the catalog
replicated per device, the query rows sharded, one K3 launch per
distinct device over its shards' table, each shard's rows into their
block of one result on the mesh's first device, still one copy down.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import logging
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops import device_pack as _k5
from predictionio_tpu_torch.ops import gramian as _k12
from predictionio_tpu_torch.ops import grid as _k13
from predictionio_tpu_torch.ops import native
from predictionio_tpu_torch.ops import normal_eq as _k1
from predictionio_tpu_torch.ops import predict_pairs as _k7
from predictionio_tpu_torch.ops.precision import COMPUTE_DTYPES
from predictionio_tpu_torch.ops import spd_solve as _k2
from predictionio_tpu_torch.ops import subspace as _k11
from predictionio_tpu_torch.ops.normal_eq import (
    SegmentPack,
    pack_from_planes,
    plan_groups,
    upload_pack,
)
from predictionio_tpu_torch.ops.topn import TopnTable, topn_chain, topn_packed
from predictionio_tpu_torch.parallel.mesh import collapse_mesh, pad_to_multiple, split_rows
from predictionio_tpu_torch.utils.shapes import pad_rows_pow2
from predictionio_tpu_torch.workflow.checkpoint import StepCheckpointer

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    """The reference's training config, field for field (see its comments
    at ``predictionio_tpu/ops/als.py:79``). The port trains explicit and
    implicit feedback with either solver in ``compute_dtype="float32"`` or
    ``"bfloat16"`` (the grid with the exact solver only, as the
    reference's), and raises ``NotImplementedError`` for any other
    dtype."""

    rank: int = 10
    iterations: int = 10
    reg: float = 0.01
    alpha: float = 1.0
    implicit_prefs: bool = False
    # "weighted" scales reg by each row's observation count (ALS-WR)
    reg_mode: str = "weighted"
    seed: int = 0
    compute_dtype: str = "float32"
    # the largest segment width; each side takes the smallest power of two
    # >= its mean observation count (min 8) up to this
    segment_length: int = 128
    # the most slots per chunk of the packed grid
    chunk_slots: int = 4_194_304
    sweep_telemetry: bool = True
    solver: str = "exact"
    block_size: int = 0

    def __post_init__(self):
        if self.reg_mode not in ("weighted", "plain"):
            raise ValueError(f"reg_mode must be weighted|plain, got {self.reg_mode}")
        validate_solver(self.solver, self.block_size, self.rank)

    @property
    def telemetry_rows_per_sweep(self) -> int:
        """Telemetry rows the loop records per sweep: one for the exact
        solver, one per column block for the subspace solver (the
        reference's :123-130)."""
        if self.solver == "subspace" and self.block_size:
            return self.rank // self.block_size
        return 1


def config_train_key(config: ALSConfig) -> tuple:
    """What the loop computes for fixed data (the reference's :156): the
    resident pack (``ops/streaming.py``) warm-starts its device-held
    factors only under an equal key, and demotes to the host wire when a
    reg, mode, alpha, solver or block size changed. As the reference's, it
    leaves ``compute_dtype`` out: factors trained in float32 warm-start a
    bfloat16 round, and the reverse."""
    return (
        config.rank, config.reg, config.reg_mode,
        config.implicit_prefs, config.alpha,
        config.solver, config.block_size,
    )


def validate_solver(solver: str, block_size: int, rank: int) -> None:
    """The reference's solver-param coherence check
    (``predictionio_tpu/ops/als.py:133``), run when params are parsed."""
    if solver not in ("exact", "subspace"):
        raise ValueError(
            f"solver must be 'exact' or 'subspace', got {solver!r}"
        )
    if solver == "subspace":
        if not isinstance(block_size, int) or block_size <= 0:
            raise ValueError(
                "solver='subspace' requires block_size > 0 (a divisor of "
                f"rank={rank}); got block_size={block_size!r}"
            )
        if rank % block_size != 0:
            raise ValueError(
                f"block_size={block_size} must divide rank={rank} for "
                "the iALS++ blocked subspace solver"
            )


# query rows per K3 launch: K3's scratch grows with the padded batch
# (4·B·pow2(tiles)·n floats, csrc/topn_select.cuh), about 8.6 GB for a
# whole ML-20M fold in one launch and 0.54 GB for this many rows
MAX_QUERY_ROWS = 16_384


@dataclasses.dataclass
class ALSModelArrays:
    """Trained factors, host-resident numpy."""

    user_factors: np.ndarray  # [n_users, k]
    item_factors: np.ndarray  # [n_items, k]


class ServingFactors:
    """Device-resident factors for the serving hot path: the item matrix
    goes to ``device`` once; each request ships only its query rows up and
    one packed result buffer down.

    With a ``mesh`` (K3s, the reference's :2369 ``_topn_packed_sharded``),
    serving is data-parallel: the item matrix is replicated (one upload per
    DISTINCT device of the mesh, shared by the logical shards on it), and
    each batch's padded query rows cut into one block per shard, as
    ``shard_batch`` cuts them. Each distinct device gets its shards' blocks
    as one upload, in shard order, and runs ONE K3 launch over them through
    a shard table (``ops/topn.TopnTable``, built once per padded batch
    size): the first device's launch writes each shard's rows into their
    block of one packed result there, in any order and with gaps (an
    interleaved mesh); another device's writes a local result, sent to the
    first device by one peer copy. The result is fetched once. K3 reduces
    each row in one fixed order whatever the batch, so the answers are the
    single-device answers bit for bit. A mesh of one shard collapses to the
    single-device path on that shard's device."""

    def __init__(
        self,
        user_factors: np.ndarray,
        item_factors: np.ndarray,
        device: DeviceLike = None,
        mesh=None,
    ):
        mesh, device = collapse_mesh(mesh, device)
        self.mesh = mesh
        self.user_factors = np.asarray(user_factors)
        # the user rows are gathered on the host (topn_by_user), so only
        # the catalog goes to the device: once per distinct device
        self.device = resolve_device(device) if mesh is None else mesh.devices[0]
        devices = [self.device] if mesh is None else mesh.distinct_devices()
        self._if_on = {d: _upload(item_factors, d) for d in devices}
        self._if_dev = self._if_on[self.device]
        self.n_items = self._if_dev.shape[0]
        # each distinct device's shards, in shard order, the first device's
        # first; their tables by rows per shard
        self._groups: Dict[torch.device, List[int]] = {}
        for s, d in enumerate(mesh.devices if mesh is not None else ()):
            self._groups.setdefault(d, []).append(s)
        self._tables: Dict[int, list] = {}

    def topn_by_rows(
        self, user_rows: np.ndarray, n: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-N for explicit query factor rows [B, k]: (scores [B, n],
        item indices [B, n]), one K3 launch (one per distinct device on a
        mesh) and one fetch per ``MAX_QUERY_ROWS`` rows (rows are
        independent, so the chunks change no answer)."""
        b = len(user_rows)
        if b > MAX_QUERY_ROWS:
            parts = [
                self.topn_by_rows(user_rows[s : s + MAX_QUERY_ROWS], n)
                for s in range(0, b, MAX_QUERY_ROWS)
            ]
            return (
                np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
            )
        host = self.topn_packed_device(user_rows, n).cpu().numpy()[:b]
        return host[:, :n], _unpack_indices(host, n)

    def topn_packed_device(self, user_rows: np.ndarray, n: int) -> torch.Tensor:
        """Upload the query rows padded to a power of two (min 8), run K3,
        and return the packed ``[b_pad, 2n]`` result still on the device
        (on a mesh, the first shard's, every shard's rows in row order).
        Callers slice the padding rows off."""
        q = pad_rows_pow2(user_rows, 8)
        if self.mesh is None:
            return topn_packed(_upload(q, self.device), self._if_dev, n)
        return self._launch(self._place(q), n)

    def _shard_tables(self, per: int) -> list:
        """For ``per`` query rows a shard: per distinct device (the first
        first), (its shards, its ``TopnTable``, where its result goes on the
        first device: None for the first device's own, whose table writes
        the result; the first row of its block where its shards lie back to
        back; else its shards' indices there, for ``index_copy_``). Built
        once per padded batch size."""
        got = self._tables.get(per)
        if got is None:
            S = self.mesh.size
            got = []
            for dev, idx in self._groups.items():
                rows = [per] * len(idx)
                if dev == self.device:
                    got.append((idx, TopnTable(dev, rows, [s * per for s in idx], S * per), None))
                    continue
                table = TopnTable(dev, rows, [j * per for j in range(len(idx))], len(idx) * per)
                if idx == list(range(idx[0], idx[0] + len(idx))):
                    place = idx[0] * per
                else:
                    place = torch.tensor(idx, dtype=torch.int64, device=self.device)
                got.append((idx, table, place))
            self._tables[per] = got
        return got

    def _place(self, q: np.ndarray) -> list:
        """The query rows zero-padded to a multiple of the shards, cut into
        one block per shard (``shard_batch``'s cut), as one upload per
        distinct device of its shards' blocks in shard order: (upload,
        table, place) per device (``_shard_tables``)."""
        S = self.mesh.size
        rows = pad_to_multiple(max(len(q), 1), S)
        if rows != len(q):
            q = np.pad(q, ((0, rows - len(q)), (0, 0)))
        per = rows // S
        placed = []
        for idx, table, place in self._shard_tables(per):
            mine = q if len(idx) == S else q.reshape(S, per, -1)[idx].reshape(-1, q.shape[1])
            placed.append((_upload(mine, table.device), table, place))
        return placed

    def _launch(self, placed: list, n: int, n_iters: int = 0) -> torch.Tensor:
        """K3 (``n_iters`` 0) or K3c over ``_place``'s uploads, one launch
        per distinct device: the packed result on the first device."""
        packed = None
        for q, table, place in placed:
            Y = self._if_on[table.device]
            if n_iters:
                got = topn_chain(q, Y, n, n_iters, table=table)
            else:
                got = topn_packed(q, Y, n, table=table)
            if place is None:
                packed = got
            elif isinstance(place, int):  # the peer copy of shards back to back
                packed[place:place + got.shape[0]].copy_(got)
            else:  # one peer copy, then each shard's block into place
                per = table.rows[0]
                packed.view(-1, per, got.shape[1]).index_copy_(
                    0, place, got.to(self.device).view(-1, per, got.shape[1]))
        return packed

    def warm(self, n: int = 16, max_batch: int = 128) -> None:
        """Run every padded batch size the serving path can hit once at
        deploy, so the kernel is built and loaded (and a mesh's tables
        built) before traffic."""
        k = self._if_dev.shape[1]
        n = min(n, self.n_items)
        b = 8
        while True:
            self.topn_by_rows(np.zeros((b, k), np.float32), n)
            if b >= max_batch:
                break
            b *= 2

    def measure_compute_ms(
        self, user_rows: np.ndarray, n: int, iters: int = 256, reps: int = 5
    ) -> float:
        """Per-pass device time of the top-N, in ms: K3c chains ``iters``
        passes in one call, so the host's share of a call cancels in
        ``(t(iters) - t(1)) / (iters - 1)``; each ``t`` is one call of the
        chain (on a mesh, one per distinct device over its shard table, the
        query rows cut as serving cuts them) followed by a synchronize, and
        the result is the median over ``reps`` pairs (the reference's
        ``ServingFactors.measure_compute_ms``, :2526-2540 on a mesh)."""
        if iters < 2 or reps < 1:
            raise ValueError(f"iters={iters} must be >= 2 and reps={reps} >= 1")
        if self.mesh is None:
            q = _upload(user_rows, self.device)
            devices = [self.device]
            run = lambda k: topn_chain(q, self._if_dev, n, k)  # noqa: E731
        else:
            placed = self._place(np.asarray(user_rows, np.float32))
            devices = list(self._groups)
            run = lambda k: self._launch(placed, n, k)  # noqa: E731

        def chain(k: int) -> float:
            t0 = time.perf_counter()
            run(k)
            for d in devices:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            return time.perf_counter() - t0

        chain(1)  # the kernel's build and load
        samples = []
        for _ in range(reps):
            t1 = chain(1)
            tk = chain(iters)
            samples.append((tk - t1) / (iters - 1) * 1000.0)
        return float(np.median(samples))

    def topn_by_user(self, user_ids: Sequence[int], n: int):
        """Top-N for known user indices (rows gathered on the host)."""
        rows = self.user_factors[np.asarray(user_ids, np.int64)]
        return self.topn_by_rows(rows, n)


def recommend_batch(
    query_factors: np.ndarray,
    item_factors: np.ndarray,
    n: int,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot top-N (uploads the factors on every call: use
    ServingFactors on the serving path). Returns (scores [B, n], item
    indices [B, n])."""
    dev = resolve_device(device)
    packed = topn_packed(
        _upload(query_factors, dev),
        _upload(item_factors, dev),
        n,
    ).cpu().numpy()
    return packed[:, :n], _unpack_indices(packed, n)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` as a contiguous float32 tensor on ``device`` (on the CPU it
    may share ``a``'s memory)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _unpack_indices(packed: np.ndarray, n: int) -> np.ndarray:
    """Recover int32 indices from their raw bits in the packed buffer."""
    return np.ascontiguousarray(packed[:, n:]).view(np.int32)


# --- training: the host packing, copied from the reference as numpy ---


@dataclasses.dataclass
class PackedSide:
    """Host-side fixed-width segment view of one solve side: segment arrays
    are [C, Sc, L] with C·Sc >= #segments and Sc·L <= chunk_slots. Each
    segment's valid slots are a prefix of ``rem`` slots."""

    n_rows: int  # real (unpadded) row count
    seg_rows: np.ndarray  # [C, Sc] row id of each segment (padding -> n_rows)
    cols: np.ndarray  # [C, Sc, L] column ids (padding = 0, masked)
    vals: np.ndarray  # [C, Sc, L] ratings
    rem: np.ndarray  # [C, Sc] int32 valid slots per segment (prefix)
    counts: np.ndarray  # [n_rows] observation counts


def pack_segments(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    segment_length: int = 128,
    pad_segments_to: int = 1,
    chunk_slots: int = 4_194_304,
) -> PackedSide:
    """Pack COO observations into fixed-width row segments: each nonempty
    row occupies ``ceil(count / L)`` consecutive segments of L slots (the
    last one zero-padded); padding segments carry the sentinel row id
    ``n_rows``."""
    L = int(segment_length)
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    vals = np.asarray(vals, dtype=np.float32)
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    counts = np.bincount(rows_s, minlength=n_rows).astype(np.int32)
    g = _segment_geometry(counts, n_rows, L, pad_segments_to, chunk_slots)

    p_cols = np.zeros((g.total, L), dtype=np.int32)
    p_vals = np.zeros((g.total, L), dtype=np.float32)
    if len(rows_s):
        offset = np.arange(len(rows_s), dtype=np.int64) - g.starts[rows_s]
        flat = (g.seg_base[rows_s] + offset // L) * L + offset % L
        p_cols.reshape(-1)[flat] = cols_s
        p_vals.reshape(-1)[flat] = vals_s
    return PackedSide(
        n_rows=n_rows,
        seg_rows=g.seg_rows.reshape(g.n_chunks, g.sc),
        cols=p_cols.reshape(g.n_chunks, g.sc, L),
        vals=p_vals.reshape(g.n_chunks, g.sc, L),
        rem=g.rem.reshape(g.n_chunks, g.sc),
        counts=counts,
    )


@dataclasses.dataclass
class _SegGeometry:
    """Segment-grid geometry of one solve side, from per-row counts."""

    n_rows: int
    L: int
    counts: np.ndarray  # [n_rows] int32
    starts: np.ndarray  # [n_rows + 1] int64 CSR offsets of the sorted COO
    seg_base: np.ndarray  # [n_rows + 1] int64 first segment of each row
    n_segs: int
    sc: int
    n_chunks: int
    total: int  # n_chunks * sc >= n_segs
    seg_rows: np.ndarray  # [total] row of each segment (padding -> n_rows)
    rem: np.ndarray  # [total] valid slots per segment


def _segment_geometry(
    counts: np.ndarray,
    n_rows: int,
    L: int,
    pad_segments_to: int,
    chunk_slots: int,
) -> _SegGeometry:
    starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    segs_per_row = -(-counts // L)  # ceil; 0 for empty rows
    seg_base = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(segs_per_row, out=seg_base[1:])
    n_segs = int(seg_base[-1])

    # Sc segments per chunk: Sc·L <= chunk_slots, a multiple of the shard
    # count, and no larger than the data needs (bucketed, see _bucket_count)
    sc = max(1, int(chunk_slots) // L)
    sc = max(pad_segments_to, sc - sc % pad_segments_to)
    per_pad = -(-max(n_segs, 1) // pad_segments_to)
    sc_needed = pad_segments_to * _bucket_count(per_pad)
    sc = min(sc, sc_needed)
    n_chunks = max(1, -(-max(n_segs, 1) // sc))
    total = n_chunks * sc

    seg_rows = np.full(total, n_rows, dtype=np.int32)
    rem = np.zeros(total, dtype=np.int32)
    if n_segs:
        seg_rows[:n_segs] = np.repeat(
            np.arange(n_rows, dtype=np.int32), segs_per_row
        )
        # valid slots per segment: full L except each row's last segment
        seg_ord = np.arange(n_segs, dtype=np.int64) - seg_base[seg_rows[:n_segs]]
        rem[:n_segs] = np.minimum(
            counts[seg_rows[:n_segs]].astype(np.int64) - seg_ord * L, L
        )
    return _SegGeometry(
        n_rows=n_rows, L=L, counts=counts, starts=starts,
        seg_base=seg_base, n_segs=n_segs, sc=sc, n_chunks=n_chunks,
        total=total, seg_rows=seg_rows, rem=rem,
    )


def _bucket_count(n: int) -> int:
    """Round a count up at 4-significant-bit granularity (at most 12.5 %
    padding), so near-identical cardinalities share one shape."""
    n = int(n)
    granule = 1 << max(0, n.bit_length() - 4)
    return -(-n // granule) * granule


def auto_segment_length(
    idx: Optional[np.ndarray], n_rows: int, cap: int,
    counts: Optional[np.ndarray] = None,
) -> int:
    """Smallest power of two >= the side's mean observation count, within
    [min(8, cap), cap]. ``counts`` (per row) skips the bincount; ``idx``
    may then be None."""
    floor = min(8, cap)
    if counts is None:
        counts = np.bincount(idx, minlength=n_rows)
    nonempty = int((counts > 0).sum())
    if nonempty == 0:
        return floor
    mean = (
        len(idx) if idx is not None else int(counts.sum())
    ) / nonempty
    L = floor
    while L < cap and L < mean:
        L *= 2
    return L


def _pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# --- training: the host wire, copied from the reference as numpy ---
#
# The single-device route ships the COO presorted by user, WITHOUT its
# row-id plane (the CSR offsets encode it), with item ids narrowed to
# uint16 when they fit and half-step ratings to int8, nibble-packed two
# per byte when they lie in 0..7.5. K4 unpacks the nibbles on the device
# and K5 (``ops/device_pack.py``) builds both sides' padded segment
# layouts there. ML-20M: a 51.3 MB wire in place of ≈0.47 GB of planes.


def _narrow_ids(idx: np.ndarray) -> np.ndarray:
    """Ids as the narrowest lossless wire dtype (uint16 below 65,536)."""
    return idx.astype(np.uint16) if idx.size and idx.max() < 65536 else idx


def _narrow_vals(vals: np.ndarray) -> Tuple[np.ndarray, float]:
    """(wire_array, scale): ratings on a half-step scale travel as int8
    (doubled) with scale 0.5; anything else stays float32 with scale 1."""
    if vals.size == 0:
        return vals, 1.0
    doubled = vals * 2.0
    rounded = np.rint(doubled)
    if (
        np.abs(doubled - rounded).max() == 0.0
        and np.abs(rounded).max() <= 127
    ):
        return rounded.astype(np.int8), 0.5
    return vals, 1.0


def _nibble_packable(vw: np.ndarray) -> bool:
    """Doubled half-step ratings in 0..15 fit a nibble each, two per wire
    byte: int8, an even element count, no negatives."""
    return (
        vw.dtype == np.int8
        and vw.size > 0
        and vw.size % 2 == 0
        and vw.min() >= 0
        and vw.max() <= 15
    )


def _pack_nibbles_host(vw: np.ndarray) -> np.ndarray:
    return (
        (vw[0::2].astype(np.uint8) & 0xF)
        | (vw[1::2].astype(np.uint8) << 4)
    )


def _unpack_nibbles_host(packed: np.ndarray) -> np.ndarray:
    """Host inverse of ``_pack_nibbles_host``: low nibble to the even
    index, high nibble to the odd one."""
    out = np.empty(packed.size * 2, np.int8)
    out[0::2] = (packed & np.uint8(0xF)).astype(np.int8)
    out[1::2] = (packed >> np.uint8(4)).astype(np.int8)
    return out


def wire_coo(wire: "HostWire") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The exact user-major (user, item, value) COO a wire was finished
    from: every narrowing tier is lossless, so ``finish_wire`` of it gives
    the wire back byte for byte."""
    n = int(wire.counts_u.sum())
    u = np.repeat(np.arange(wire.n_users, dtype=np.int32), wire.counts_u)
    i = np.asarray(wire.iw[:n], dtype=np.int32)
    if wire.nibble:
        v = _unpack_nibbles_host(wire.vw)[:n].astype(np.float32)
        v *= np.float32(wire.v_scale)
    elif wire.vw.dtype == np.int8:
        v = wire.vw[:n].astype(np.float32) * np.float32(wire.v_scale)
    else:
        v = np.asarray(wire.vw[:n], dtype=np.float32)
    return u, i, v


def aux_pad(arr: np.ndarray) -> np.ndarray:
    """A CSR-offset array edge-padded to its bucketed length (it is only
    indexed by row ids up to its last real entry, so the padding is
    inert)."""
    out = np.full(_bucket_count(len(arr)), arr[-1], np.int32)
    out[: len(arr)] = arr
    return out


@dataclasses.dataclass
class HostWire:
    """The COO presorted by user and narrowed, plus both sides' segment
    geometry: everything the single-device route ships to the card."""

    n_users: int
    n_items: int
    L_u: int
    L_i: int
    geo_u: _SegGeometry
    geo_i: _SegGeometry
    iw: np.ndarray  # item ids, user-sorted, sentinel-padded, narrowed
    vw: np.ndarray  # values (nibble-packed uint8, int8, or float32)
    nibble: bool
    v_scale: float
    aux: dict  # su/bu/si/bi int32 CSR offsets + segment bases (aux_pad'd)
    counts_u: np.ndarray  # [n_users] int32 observation counts
    counts_i: np.ndarray  # [n_items]
    # a STRIPPED wire keeps only its geometry and metadata: its planes and
    # offsets live on the card under a ResidentPack (ops/streaming.py),
    # which restores them before any host use
    stripped: bool = False

    @property
    def wire_mb(self) -> float:
        return round(
            (
                self.iw.nbytes
                + self.vw.nbytes
                + sum(int(a.nbytes) for a in self.aux.values())
            )
            / 2**20,
            1,
        )

    @property
    def padded_slots(self) -> int:
        return self.geo_u.total * self.L_u + self.geo_i.total * self.L_i

    def identity_bytes(self) -> bytes:
        """The wire's data identity (the reference fingerprints
        checkpoints with it)."""
        return self.iw.tobytes() + self.vw.tobytes()


def build_host_wire(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    ratings: np.ndarray,
    n_users: int,
    n_items: int,
    config: ALSConfig,
    counts_u: Optional[np.ndarray] = None,
    counts_i: Optional[np.ndarray] = None,
) -> HostWire:
    """The wire of a COO batch: one stable sort by user, the COO length
    bucketed with sentinel padding (item id ``n_items``, value 0), then
    ``finish_wire``."""
    user_idx = np.asarray(user_idx, np.int32)
    item_idx = np.asarray(item_idx, np.int32)
    ratings_f = np.asarray(ratings, np.float32)
    if counts_u is None:
        counts_u = np.bincount(user_idx, minlength=n_users).astype(np.int32)
    if counts_i is None:
        counts_i = np.bincount(item_idx, minlength=n_items).astype(np.int32)
    L_u = auto_segment_length(
        user_idx, n_users, config.segment_length, counts=counts_u
    )
    L_i = auto_segment_length(
        item_idx, n_items, config.segment_length, counts=counts_i
    )
    geo_u = _segment_geometry(counts_u, n_users, L_u, 1, config.chunk_slots)
    geo_i = _segment_geometry(counts_i, n_items, L_i, 1, config.chunk_slots)
    n = len(ratings_f)
    order = np.argsort(user_idx, kind="stable")
    # padding elements land in masked padding segments or past the grid
    pad = (_bucket_count(n) - n) if n else 1
    iw = np.concatenate([item_idx[order], np.full(pad, n_items, np.int32)])
    vw = np.concatenate([ratings_f[order], np.zeros(pad, np.float32)])
    return finish_wire(
        iw, vw, n_users, n_items, L_u, L_i, geo_u, geo_i,
        counts_u, counts_i,
    )


def finish_wire(
    iw: np.ndarray,
    vw: np.ndarray,
    n_users: int,
    n_items: int,
    L_u: int,
    L_i: int,
    geo_u: _SegGeometry,
    geo_i: _SegGeometry,
    counts_u: np.ndarray,
    counts_i: np.ndarray,
) -> HostWire:
    """The shared tail of the monolithic and streaming packers: narrow a
    user-sorted, sentinel-padded item/value COO and assemble the wire."""
    iw = _narrow_ids(iw)
    vw, v_scale = _narrow_vals(vw)
    nibble = _nibble_packable(vw)
    if nibble:
        vw = _pack_nibbles_host(vw)
    aux = {
        "su": aux_pad(geo_u.starts.astype(np.int32)),
        "bu": aux_pad(geo_u.seg_base.astype(np.int32)),
        "si": aux_pad(geo_i.starts.astype(np.int32)),
        "bi": aux_pad(geo_i.seg_base.astype(np.int32)),
    }
    return HostWire(
        n_users=n_users, n_items=n_items, L_u=L_u, L_i=L_i,
        geo_u=geo_u, geo_i=geo_i, iw=iw, vw=vw, nibble=nibble,
        v_scale=v_scale, aux=aux, counts_u=counts_u, counts_i=counts_i,
    )


def _padded_rows(n: int, n_shards: int) -> int:
    # +1 sentinel row for segment padding, bucketed, and a multiple of
    # the shard count
    return _pad_to_multiple(_bucket_count(n + 1), n_shards)


def _factor_init_host(
    n_users: int, n_items: int, config: ALSConfig, n_shards: int
) -> Tuple[np.ndarray, np.ndarray]:
    """MLlib-style init: nonnegative scaled normals on the item side;
    sentinel/padding rows zero."""
    k = config.rank
    rng = np.random.default_rng(config.seed)
    X0 = np.zeros((_padded_rows(n_users, n_shards), k), np.float32)
    Y0 = np.zeros((_padded_rows(n_items, n_shards), k), np.float32)
    Y0[:n_items] = np.abs(rng.standard_normal((n_items, k))) / math.sqrt(k)
    return X0, Y0


def _lam_obs_host(
    counts: np.ndarray, n_real: int, n_sys_rows: int, config: ALSConfig
) -> Tuple[np.ndarray, np.ndarray]:
    padded = np.zeros(n_sys_rows, np.float32)
    padded[:n_real] = counts
    weighted = config.reg_mode == "weighted"
    lam = config.reg * padded if weighted else np.full_like(padded, config.reg)
    # guard zero-count/padding rows against singular systems (their
    # solutions are discarded by the has_obs select anyway)
    return np.maximum(lam, 1e-8).astype(np.float32), padded > 0


# --- training: the device loop ---

# sweeps the telemetry records per run (later sweeps are not recorded);
# each row is [dx_rms, dy_rms, x_rms, y_rms, objective], the objective 0
# outside implicit mode, as the reference records them. The subspace solver
# records one row per column block, so its buffer holds TELEMETRY_SLOTS x
# rows_per_sweep rows: the same sweeps fit with either solver
TELEMETRY_SLOTS = 64
TELEMETRY_COLS = 5


def _check_ported(config: ALSConfig) -> None:
    if config.compute_dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype={config.compute_dtype!r} is not ported; the port "
            f"trains in {' or '.join(COMPUTE_DTYPES)}"
        )


def device_pack(
    side: PackedSide, n_sys_rows: int, n_cols: int, device: torch.device,
) -> SegmentPack:
    """A host-packed side on ``device`` with its K1 group plan, which is
    built here on the host (``plan_groups``)."""
    plan = plan_groups(side.seg_rows, side.rem, n_sys_rows)
    return upload_pack(
        side.seg_rows, side.cols, side.vals, side.rem, plan, n_sys_rows,
        n_cols, device,
    )


def init_factor_state_single(
    counts_u: np.ndarray,
    counts_i: np.ndarray,
    n_users: int,
    n_items: int,
    config: ALSConfig,
    warm: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    device: DeviceLike = None,
) -> tuple:
    """The single-device factor/regularizer state on ``device``:
    (X, Y, user_lam, item_lam, user_has_obs, item_has_obs). Cold: X zeros
    and the seeded item init. ``warm``: ``([n_users, k], [n_items, k])``
    host factor seeds in place of the init."""
    dev = resolve_device(device)
    k = config.rank
    if warm is not None:
        Xw, Yw = warm
        if Xw.shape != (n_users, k) or Yw.shape != (n_items, k):
            raise ValueError(
                f"warm factor shapes {Xw.shape}/{Yw.shape} do not match "
                f"({n_users}, {k})/({n_items}, {k})"
            )
        X0 = np.zeros((_padded_rows(n_users, 1), k), np.float32)
        X0[:n_users] = Xw
        Y0 = np.zeros((_padded_rows(n_items, 1), k), np.float32)
        Y0[:n_items] = Yw
        X = _upload(X0, dev).clone()
    else:
        _, Y0 = _factor_init_host(n_users, n_items, config, 1)
        X = torch.zeros((_padded_rows(n_users, 1), k), dtype=torch.float32, device=dev)
    # owned copies: the loop never writes them, but the caller's arrays
    # must not alias device state
    Y = _upload(Y0, dev).clone()
    user_lam, user_obs = _lam_obs_host(counts_u, n_users, X.shape[0], config)
    item_lam, item_obs = _lam_obs_host(counts_i, n_items, Y.shape[0], config)
    return (
        X, Y,
        torch.from_numpy(user_lam).to(dev), torch.from_numpy(item_lam).to(dev),
        torch.from_numpy(user_obs).to(dev), torch.from_numpy(item_obs).to(dev),
    )


def _solve_side(
    X_prev: torch.Tensor,
    Y: torch.Tensor,
    pack: SegmentPack,
    lam: torch.Tensor,
    has_obs: torch.Tensor,
    sums: Optional[torch.Tensor] = None,
    G: Optional[torch.Tensor] = None,
    implicit: bool = False,
    alpha: float = 1.0,
    compute_dtype: str = "float32",
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One half-step: K1 forms the systems (with the implicit weights when
    ``implicit``, in ``compute_dtype``), K2 solves them with ``G``
    (implicit mode's Gramian of Y) and the regularizer and keeps
    ``X_prev`` for rows without observations (writing the telemetry sums
    into ``sums`` when given), into ``out`` when given."""
    A, b = _k1.normal_eq(Y, pack, implicit, alpha, compute_dtype)
    return _k2.spd_solve(A, b, lam, has_obs, X_prev, sums, G, out=out)


def _solve_side_subspace(
    X: torch.Tensor,
    Y: torch.Tensor,
    G: Optional[torch.Tensor],
    pack: SegmentPack,
    lam: torch.Tensor,
    has_obs: torch.Tensor,
    alpha: float,
    implicit: bool,
    block_size: int,
    sums: Optional[torch.Tensor] = None,
    compute_dtype: str = "float32",
    carry: Optional[_k11.CarryBuffers] = None,
) -> torch.Tensor:
    """One iALS++ half-step (the reference's :640): for each column block
    in order, K11a forms the block systems and residuals against the
    current X and K11b solves them (with ``G``, implicit mode's Gramian of
    Y, None in explicit mode) and adds the deltas into X in place, so each
    block sees the blocks before it. Rows without observations keep their
    factors. ``sums`` ([n_blocks, 2], one row per block) receives each
    block's ``Σ δ²`` and, in its last row, ``Σ X²`` of the updated array.
    Where the kernels carry each slot's score across the blocks
    (``subspace.carries``), block 0 writes it to ``carry``'s score buffer,
    each K11b but the last writes its Δ, and each later K11a carries the
    score (``ops/subspace.py``); without ``carry`` the buffers are
    allocated for this half-step."""
    k, b = X.shape[1], block_size
    nb = k // b
    score = delta = None
    if _k11.carries(k, b):
        score, delta = (carry or _k11.CarryBuffers([pack], b)).views(pack)
    for j in range(nb):
        s0 = j * b
        A, r = _k11.subspace_accumulate(Y, X, pack, s0, b, implicit, alpha, compute_dtype,
                                        score, None if j == 0 else delta)
        _k11.subspace_block_solve(
            A, r, X, lam, has_obs, s0, G, None if sums is None else sums[j],
            last=j == nb - 1, delta=None if j == nb - 1 else delta,
            compute_dtype=compute_dtype,
        )
    return X


def _run_iterations(
    X: torch.Tensor,
    Y: torch.Tensor,
    user_pack: SegmentPack,
    item_pack: SegmentPack,
    user_lam: torch.Tensor,
    item_lam: torch.Tensor,
    user_has_obs: torch.Tensor,
    item_has_obs: torch.Tensor,
    n_iters: int,
    telemetry: bool = True,
    implicit: bool = False,
    alpha: float = 1.0,
    solver: str = "exact",
    block_size: int = 0,
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The training loop on one device: ``_run_iterations_mesh`` over one
    shard that holds every row (see there)."""
    d = X.device
    X, Y, tel = _run_iterations_mesh(
        {d: X}, {d: Y}, MeshSide.whole(user_pack, d), MeshSide.whole(item_pack, d),
        {d: user_lam}, {d: item_lam}, {d: user_has_obs}, {d: item_has_obs}, n_iters,
        telemetry, implicit, alpha, solver, block_size, compute_dtype,
    )
    return X[d], Y[d], tel


# --- training on a row-sharded mesh (K6s, K13s) ---

# factors on a mesh: one replica of the whole padded array per distinct
# device, in the mesh's first-seen order (the first is the mesh's first)
Replicas = Dict[torch.device, torch.Tensor]
Factors = Union[torch.Tensor, Replicas]


@dataclasses.dataclass
class MeshSide:
    """One solve side on a 1-D mesh: shard s solves the rows
    ``[bounds[s], bounds[s + 1])`` of the side's ``n_rows`` padded rows on
    ``devices[s]`` with ``packs[s]`` (its rows numbered from 0; None for a
    shard with no rows). ``gram_rows`` is the row count one device pads
    the side to (``_padded_rows(n, 1)``): K12a sums over those rows, so G
    is one device's bit for bit (the mesh's extra rows are zero)."""

    devices: List[torch.device]
    bounds: np.ndarray  # [S + 1] int64
    packs: List[Optional[SegmentPack]]
    n_rows: int
    gram_rows: int

    @classmethod
    def whole(cls, pack: SegmentPack, device: torch.device) -> "MeshSide":
        """One device's pack as a mesh side of one shard holding every row."""
        R = pack.n_sys_rows
        return cls([device], np.array([0, R]), [pack], R, R)

    def shards(self):
        """(s, device, first row, end row, pack) of every shard with rows."""
        for s, pack in enumerate(self.packs):
            if pack is not None:
                yield s, self.devices[s], int(self.bounds[s]), int(self.bounds[s + 1]), pack


def mesh_pack_side(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_real: int,
    n_sys_rows: int,
    L: int,
    chunk_slots: int,
    n_shards: int,
) -> Tuple[np.ndarray, list, List[int], List[int]]:
    """The host half of a mesh side: (bounds, per-shard host packs,
    segment slots per shard, observations per shard). ``pack_segments``
    packs the whole side (its stable sort keeps each row's observations in
    the order given), ``split_rows`` cuts the ``n_sys_rows`` rows by
    segment count, and each shard's pack is its rows' segments, renumbered
    from 0, in ``ceil(n / (chunk_slots // L))`` equal chunks; the last
    chunk's padding segments (rem 0, which no kernel reads) name row 0.
    Each host pack is ``(seg_rows, cols, vals, rem, plan)`` with its
    ``plan_groups`` plan, or None for a shard with no rows."""
    side = pack_segments(rows, cols, vals, n_real, L, 1, chunk_slots)
    segs = np.zeros(n_sys_rows, np.int64)
    segs[:n_real] = -(-side.counts.astype(np.int64) // L)
    seg_base = np.zeros(n_sys_rows + 1, np.int64)
    np.cumsum(segs, out=seg_base[1:])
    bounds = split_rows(segs, n_shards)
    flat_rows = side.seg_rows.reshape(-1)
    flat_cols = side.cols.reshape(-1, L)
    flat_vals = side.vals.reshape(-1, L)
    flat_rem = side.rem.reshape(-1)
    per_chunk = max(1, int(chunk_slots) // L)
    packs, slots, real = [], [], []
    for s in range(n_shards):
        r0, r1 = int(bounds[s]), int(bounds[s + 1])
        g0, g1 = int(seg_base[r0]), int(seg_base[r1])
        slots.append((g1 - g0) * L)
        real.append(int(flat_rem[g0:g1].sum()))
        if r1 == r0:
            packs.append(None)
            continue
        n = g1 - g0
        n_chunks = max(1, -(-n // per_chunk))
        sc = max(1, -(-n // n_chunks))
        pad = n_chunks * sc - n

        def cut(a, fill=0):
            part = a[g0:g1]
            if pad:
                part = np.concatenate([part, np.full((pad,) + a.shape[1:], fill, a.dtype)])
            return part.reshape((n_chunks, sc) + a.shape[1:])

        seg_rows = cut(flat_rows - np.int32(r0))
        rem = cut(flat_rem)
        packs.append((seg_rows, cut(flat_cols), cut(flat_vals), rem,
                      plan_groups(seg_rows, rem, r1 - r0)))
    return bounds, packs, slots, real


def mesh_pack_sides(
    u: np.ndarray, i: np.ndarray, r: np.ndarray, n_users: int, n_items: int,
    R_u: int, R_i: int, L_u: int, L_i: int, chunk_slots: int, n_shards: int,
) -> tuple:
    """Both sides' ``mesh_pack_side`` at once: the user side on a worker
    thread while this one packs the item side (numpy's sorts and scatters
    release the interpreter lock)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        user = pool.submit(mesh_pack_side, u, i, r, n_users, R_u, L_u, chunk_slots, n_shards)
        item = mesh_pack_side(i, u, r, n_items, R_i, L_i, chunk_slots, n_shards)
        return user.result(), item


def upload_mesh_side(
    bounds: np.ndarray, host_packs: list, devices: Sequence[torch.device],
    n_sys_rows: int, n_cols: int, gram_rows: int,
) -> MeshSide:
    """``mesh_pack_side``'s bounds and packs, each pack uploaded to its
    shard's device."""
    packs = [
        None if h is None else upload_pack(
            *h[:4], h[4], int(bounds[s + 1] - bounds[s]), n_cols, devices[s]
        )
        for s, h in enumerate(host_packs)
    ]
    return MeshSide(list(devices), bounds, packs, n_sys_rows, gram_rows)


def _first(F: Factors) -> torch.Tensor:
    """A factor array, or a mesh's replica on its first device."""
    return F if isinstance(F, torch.Tensor) else next(iter(F.values()))


def _replicate(host: np.ndarray, devices: Sequence[torch.device]) -> Replicas:
    """An owned copy of ``host`` on each device."""
    return {d: _upload(host, d).clone() for d in devices}


def _share_rows(F: Replicas, side: MeshSide) -> None:
    """The all-gather: each shard's rows (the second-to-last axis) copied
    from its device's replica to the other devices' (nothing to copy when
    the mesh names one device)."""
    if len(F) == 1:
        return
    for _, dev, r0, r1, _ in side.shards():
        for d, dst in F.items():
            if d != dev:
                dst[..., r0:r1, :].copy_(F[dev][..., r0:r1, :])


def _half_step_mesh(
    X: Replicas,
    Y: Replicas,
    side: MeshSide,
    lam: Replicas,
    has_obs: Replicas,
    y_gram_rows: int,
    sums: Optional[torch.Tensor],
    implicit: bool,
    alpha: float,
    solver: str,
    block_size: int,
    compute_dtype: str,
    carry: Optional[_k11.CarryBuffers] = None,
) -> Replicas:
    """One half-step: G per distinct device (K12a, implicit mode), then
    each shard's rows as one device solves them, K1 + K2 into the shard's
    range of a new array or K11a/K11b per column block in place (with
    ``carry``'s buffers on the shard's device), and the rows shared.
    ``sums`` ([n_blocks, 2]) receives the telemetry's raw sums: one shard's
    directly, several shards' summed in shard order."""
    subspace = solver == "subspace"
    nb = X[next(iter(X))].shape[1] // block_size if subspace else 1
    G = {d: _k12.gramian(F[:y_gram_rows]) if implicit else None for d, F in Y.items()}
    X_next = X if subspace else {d: torch.empty_like(F) for d, F in X.items()}
    one = len(side.packs) == 1
    parts = []
    for _, dev, r0, r1, pack in side.shards():
        part = sums if one or sums is None else torch.zeros((nb, 2), dtype=torch.float32,
                                                             device=dev)
        if subspace:
            _solve_side_subspace(X[dev][r0:r1], Y[dev], G[dev], pack, lam[dev][r0:r1],
                                 has_obs[dev][r0:r1], alpha, implicit, block_size, part,
                                 compute_dtype, carry)
        else:
            _solve_side(X[dev][r0:r1], Y[dev], pack, lam[dev][r0:r1], has_obs[dev][r0:r1],
                        None if part is None else part[0], G[dev], implicit, alpha,
                        compute_dtype, out=X_next[dev][r0:r1])
        parts.append(part)
    _share_rows(X_next, side)
    if sums is not None and not one:
        sums.copy_(_k12.ordered_sum([p.to(sums.device) for p in parts]))
    return X_next


def _objective_mesh(
    X: Replicas, Y: Replicas, user: MeshSide, item: MeshSide, user_lam: Replicas,
    item_lam: Replicas, alpha: float, out: torch.Tensor, compute_dtype: str,
) -> None:
    """K12b into ``out``: on one device its two launches; on a mesh, shard
    s's partials over its user segments, its user rows and its item rows,
    then one finish on the first device with Gx, Gy from K12a there."""
    d0 = out.device
    if len(user.packs) == 1:
        _k12.implicit_objective(X[d0], Y[d0], user.packs[0], user_lam[d0], item_lam[d0], alpha,
                                out=out, compute_dtype=compute_dtype)
        return
    parts = []
    for s, dev in enumerate(user.devices):
        r0, r1 = int(user.bounds[s]), int(user.bounds[s + 1])
        i0, i1 = int(item.bounds[s]), int(item.bounds[s + 1])
        if r1 > r0 or i1 > i0:
            parts.append((X[dev][r0:r1], Y[dev], user.packs[s], user_lam[dev][r0:r1],
                          Y[dev][i0:i1], item_lam[dev][i0:i1]))
    Gx = _k12.gramian(X[d0][: user.gram_rows])
    Gy = _k12.gramian(Y[d0][: item.gram_rows])
    _k12.implicit_objective_shards(parts, Gx, Gy, alpha, out, compute_dtype)


def _run_iterations_mesh(
    X: Replicas,
    Y: Replicas,
    user: MeshSide,
    item: MeshSide,
    user_lam: Replicas,
    item_lam: Replicas,
    user_has_obs: Replicas,
    item_has_obs: Replicas,
    n_iters: int,
    telemetry: bool = True,
    implicit: bool = False,
    alpha: float = 1.0,
    solver: str = "exact",
    block_size: int = 0,
    compute_dtype: str = "float32",
) -> Tuple[Replicas, Replicas, Optional[torch.Tensor]]:
    """The training loop (the reference's fused program :837; on a
    row-sharded mesh, K6s, with its ``rep_sharding``/``row_sharding``):
    ``n_iters`` sweeps of (user half-step, item half-step,
    ``_half_step_mesh``) with no host sync. The exact solver launches K1
    and K2 per shard and half-step; ``solver="subspace"`` runs
    ``_solve_side_subspace`` (K11a and K11b per column block of
    ``block_size``), updating X and Y in place. K1, K11a and K12b compute
    in ``compute_dtype``. In ``implicit`` mode each half-step first forms
    G, the Gramian of the counter side's current padded factors (K12a), as
    the reference's ``half`` does (:883). With ``telemetry``, sweep i
    writes raw sums into its rows of ``tel`` ([TELEMETRY_SLOTS x
    rows_per_sweep, TELEMETRY_COLS] on the first device: Σ ΔX², Σ X², Σ
    ΔY², Σ Y², objective; one row per sweep, or per block with the
    subspace solver, whose Σ X², Σ Y² and objective go into the sweep's
    last row) and, in implicit mode, K12b (``_objective_mesh``) writes the
    objective at the sweep's factors; ``_telemetry_rows`` turns them into
    the reference's rows."""
    d0 = next(iter(X))
    subspace = solver == "subspace"
    nb = X[d0].shape[1] // block_size if subspace else 1
    # the carried score's buffers, once for the loop: both sides, every shard
    carry = (_k11.CarryBuffers([p for side in (user, item) for *_, p in side.shards()],
                               block_size)
             if subspace and _k11.carries(X[d0].shape[1], block_size) else None)
    tel = (
        torch.zeros((TELEMETRY_SLOTS * nb, TELEMETRY_COLS), dtype=torch.float32, device=d0)
        if telemetry else None
    )
    for it in range(n_iters):
        rows = tel[it * nb : (it + 1) * nb] if tel is not None and it < TELEMETRY_SLOTS else None
        X = _half_step_mesh(X, Y, user, user_lam, user_has_obs, item.gram_rows,
                            None if rows is None else rows[:, 0:2], implicit, alpha, solver,
                            block_size, compute_dtype, carry)
        Y = _half_step_mesh(Y, X, item, item_lam, item_has_obs, user.gram_rows,
                            None if rows is None else rows[:, 2:4], implicit, alpha, solver,
                            block_size, compute_dtype, carry)
        if rows is not None and implicit:
            _objective_mesh(X, Y, user, item, user_lam, item_lam, alpha, rows[nb - 1, 4:5],
                            compute_dtype)
    return X, Y, tel


def _telemetry_rows(
    tel: torch.Tensor, n_sweeps: int, x_numel: int, y_numel: int, rows_per_sweep: int = 1,
) -> np.ndarray:
    """[min(n_sweeps, TELEMETRY_SLOTS) x rows_per_sweep, TELEMETRY_COLS]
    float32 rows ``[RMS(ΔX), RMS(ΔY), RMS(X), RMS(Y), objective]``, the
    means over the padded factor arrays, as the reference records them.
    With several rows per sweep (the subspace solver's blocks) the delta
    columns are each block's update RMS over its columns; the factor RMS
    and objective stand in the sweep's last row, where
    ``_sweep_aggregate`` reads them."""
    rps = max(1, int(rows_per_sweep))
    s = tel.cpu().numpy()[: min(n_sweeps, TELEMETRY_SLOTS) * rps]
    rows = np.zeros((len(s), TELEMETRY_COLS), np.float32)
    nx, ny = np.float32(x_numel), np.float32(y_numel)
    rows[:, 0] = np.sqrt(s[:, 0] / np.float32(x_numel // rps))
    rows[:, 1] = np.sqrt(s[:, 2] / np.float32(y_numel // rps))
    rows[:, 2] = np.sqrt(s[:, 1] / nx)
    rows[:, 3] = np.sqrt(s[:, 3] / ny)
    rows[:, 4] = s[:, 4]
    return rows


def _sweep_aggregate(sweep_rows: np.ndarray, rows_per_sweep: int) -> np.ndarray:
    """Collapse per-block telemetry rows to one row per sweep (the
    reference's :1953): the delta columns combine as
    sqrt(mean(block_rms²)) — exact, since blocks are disjoint column sets
    of equal width — and the per-sweep columns (factor RMS, objective) come
    from the sweep's last block row."""
    rps = max(1, int(rows_per_sweep))
    if rps == 1:
        return sweep_rows
    per = sweep_rows.reshape(-1, rps, sweep_rows.shape[-1])
    out = per[:, -1, :].copy()
    out[:, 0] = np.sqrt(np.mean(np.square(per[:, :, 0]), axis=1))
    out[:, 1] = np.sqrt(np.mean(np.square(per[:, :, 1]), axis=1))
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sync_factors(F: Factors) -> None:
    for t in ([F] if isinstance(F, torch.Tensor) else F.values()):
        _sync(t.device)


def _train_packed(
    user_pack: Union[SegmentPack, MeshSide],
    item_pack: Union[SegmentPack, MeshSide],
    X: Factors,
    Y: Factors,
    user_lam: Factors,
    item_lam: Factors,
    user_has_obs: Factors,
    item_has_obs: Factors,
    *,
    config: ALSConfig,
    n_users: int,
    n_items: int,
    timings: Optional[dict] = None,
    compile_wait=None,
    factor_slots_out: Optional[dict] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 5,
    fp_material=None,
) -> ALSModelArrays:
    """The training tail: the loop and the factor fetch (the loop's final
    device X/Y also go into ``factor_slots_out`` when given). The loop's kernels
    are built before the timed loop (``compile_s``: nvcc at a process's
    first use, then a cached load): by the ``start_compile_async`` build
    that ``compile_wait`` waits for (its exposed wait is
    ``compile_exposed_s``), else here when ``timings`` is given. The loop
    is timed to its end (``device_loop_s``, summed over the chunks when
    checkpointing).

    With ``checkpoint_dir`` (the reference's :2130-2235) the loop runs in
    chunks of ``checkpoint_every`` sweeps and saves X, Y, the sweep count
    and the run's fingerprint after each; a run whose fingerprint
    (``_run_fingerprint`` of ``fp_material()``, the config and the shapes)
    matches the latest save resumes from it, and any other starts fresh.
    Every sum of the loop has a fixed order, so a resumed run equals an
    uninterrupted one bit for bit.

    On a mesh the packs are ``MeshSide``s and the factor state holds one
    replica per distinct device (``Replicas``): the loop is
    ``_run_iterations_mesh``, a checkpoint saves the first device's
    replicas and a resumed run places them on every device, and the run's
    identity hashes the shard count, so one device never resumes a mesh's
    checkpoint, nor the reverse (the reference's :2145-2150, :2173-2174)."""
    mesh = isinstance(user_pack, MeshSide)
    device = _first(X).device
    implicit = config.implicit_prefs
    kernels = _loop_kernels(config)
    if compile_wait is not None:
        t = time.perf_counter()
        rec = compile_wait()
        if timings is not None:
            timings["compile_exposed_s"] = time.perf_counter() - t
            timings["compile_s"] = rec["busy_s"]
        if "error" in rec:
            # the background build failed: build here, raising its error
            _load_libraries(device, kernels)
    elif timings is not None:
        t = time.perf_counter()
        _load_libraries(device, kernels)
        timings["compile_s"] = time.perf_counter() - t
    every = max(1, checkpoint_every)
    ckpt = StepCheckpointer(checkpoint_dir, every=every)
    start = 0
    fingerprint = None
    if ckpt.enabled:
        fingerprint = _run_fingerprint(
            fp_material, config, n_users, n_items, _first(X).shape[0], _first(Y).shape[0],
            len(user_pack.devices) if mesh else 1,
        )
        state = ckpt.restore_latest()
        if state is not None:
            saved = int(state["iteration"])
            if not np.array_equal(state.get("fingerprint"), fingerprint):
                logger.info(
                    "checkpoint in %s is from a different run (data/config "
                    "changed); training from scratch", checkpoint_dir,
                )
            elif saved > config.iterations:
                # a checkpoint past the requested sweeps would return an
                # over-trained model: start fresh
                logger.info(
                    "checkpoint at iteration %d exceeds requested %d; "
                    "training from scratch", saved, config.iterations,
                )
            else:
                start = saved
                if mesh:
                    X, Y = _replicate(state["X"], list(X)), _replicate(state["Y"], list(Y))
                else:
                    X = _upload(state["X"], device).clone()
                    Y = _upload(state["Y"], device).clone()
                logger.info("resuming ALS from iteration %d", start)
        if timings is not None:
            timings["checkpoint_resumed_at"] = start
    # the whole loop in one chunk without checkpoints, else chunks of the
    # cadence with a save at each chunk's end
    step = every if ckpt.enabled else max(1, config.iterations)
    loop = _run_iterations_mesh if mesh else _run_iterations
    tel_parts = []
    if timings is not None:
        timings["device_loop_s"] = 0.0
    try:
        it = start
        while it < config.iterations:
            chunk = min(step, config.iterations - it)
            t = time.perf_counter()
            X, Y, tel = loop(
                X, Y, user_pack, item_pack, user_lam, item_lam,
                user_has_obs, item_has_obs, chunk,
                telemetry=config.sweep_telemetry, implicit=implicit,
                alpha=config.alpha, solver=config.solver, block_size=config.block_size,
                compute_dtype=config.compute_dtype,
            )
            tel_parts.append((tel, chunk))
            if timings is not None:
                _sync_factors(X)
                timings["device_loop_s"] += time.perf_counter() - t
            it += chunk
            if ckpt.enabled:
                t = time.perf_counter()
                ckpt.maybe_save(it, {
                    "iteration": it, "X": _first(X).cpu().numpy(), "Y": _first(Y).cpu().numpy(),
                    "fingerprint": fingerprint,
                }, force=True)
                if timings is not None:
                    timings["checkpoint_save_s"] = (
                        timings.get("checkpoint_save_s", 0.0) + time.perf_counter() - t
                    )
    finally:
        ckpt.close()
    if factor_slots_out is not None:
        factor_slots_out["X"] = X
        factor_slots_out["Y"] = Y
    X_host = _first(X).cpu().numpy()
    Y_host = _first(Y).cpu().numpy()
    if tel_parts and config.sweep_telemetry and timings is not None:
        rps = config.telemetry_rows_per_sweep
        rows = np.concatenate([
            _telemetry_rows(tel, n, X_host.size, Y_host.size, rps) for tel, n in tel_parts
        ])
        # the objective only means something in implicit mode; explicit
        # rows keep their four keys, as the reference's (:2276-2299)
        timings["sweep_telemetry"] = [
            {
                "dx": float(r[0]), "dy": float(r[1]),
                "x_rms": float(r[2]), "y_rms": float(r[3]),
                **({"objective": float(r[4])} if implicit else {}),
            }
            for r in _sweep_aggregate(rows, rps)
        ]
        if rps > 1:
            timings["block_telemetry"] = [
                {"sweep": ri // rps, "block": ri % rps, "dx": float(r[0]), "dy": float(r[1])}
                for ri, r in enumerate(rows)
            ]
    return ALSModelArrays(X_host[:n_users].copy(), Y_host[:n_items].copy())


def _run_fingerprint(
    fp_material, config: ALSConfig, n_users: int, n_items: int, rows_x: int, rows_y: int,
    n_shards: int = 1,
) -> np.ndarray:
    """A run's identity, the reference's (:2167-2180): the SHA-256 of the
    data (``fp_material()``), the config with ``iterations=0`` (so a run
    in another dtype, reg or solver never resumes this one), the id
    counts, the shard count and the padded row counts, as 32 uint8. Equal
    identities may resume each other's checkpoints."""
    digest = hashlib.sha256(
        fp_material()
        + repr(dataclasses.replace(config, iterations=0)).encode()
        + f"{n_users},{n_items},{n_shards}".encode()
        + f";rows={rows_x},{rows_y}".encode()
    ).digest()
    return np.frombuffer(digest, dtype=np.uint8)


def _loop_kernels(config: ALSConfig) -> tuple:
    """The kernel modules the loop of ``config`` launches."""
    solver = (_k11,) if config.solver == "subspace" else (_k1, _k2)
    return solver + ((_k12,) if config.implicit_prefs else ())


def _load_libraries(device: torch.device, kernels) -> None:
    """Build (at first use) and load the kernels' libraries for a CUDA
    ``device``; the CPU runs the twins and needs none."""
    if device.type == "cuda":
        for kernel in kernels:
            kernel.load_library()


def start_compile_async(device: DeviceLike, config: ALSConfig):
    """Build and load the training kernels' libraries (K4 and K5, and those
    the loop of ``config`` launches) on a background thread, so nvcc at a
    process's first use hides under the host work that precedes the device
    pack: the counterpart of the reference's background XLA compile.
    Returns ``wait() -> dict`` with ``busy_s``, the thread's seconds (and
    ``error`` if the build failed; training then builds inline, which
    raises the error)."""
    dev = resolve_device(device)
    kernels = (_k5,) + _loop_kernels(config)
    rec: dict = {}
    if dev.type != "cuda":
        rec["busy_s"] = 0.0
        return lambda: rec

    def work() -> None:
        t0 = time.perf_counter()
        try:
            native.build_sources([k.SOURCE for k in kernels])
            _load_libraries(dev, kernels)
        except Exception as e:
            rec["error"] = repr(e)
        rec["busy_s"] = time.perf_counter() - t0

    th = threading.Thread(target=work, daemon=True, name="als-kernel-build")
    th.start()

    def wait() -> dict:
        th.join()
        return rec

    return wait


def upload_wire(wire: HostWire, device: torch.device, n_chunks: int = 1) -> tuple:
    """The wire on ``device`` as ``(i_dev, v_dev, aux_dev)``: the COO
    planes go up in ``n_chunks`` chunks at even boundaries, and each value
    chunk of a nibble-packed wire is unpacked by K4 into its slice of one
    int8 plane as soon as it is up."""

    def parts(a: np.ndarray):
        if n_chunks <= 1 or len(a) < 2 * n_chunks:
            return [(0, a)]
        step = -(-len(a) // n_chunks)
        step += step % 2  # even boundary: value pairs stay byte-aligned
        return [(s, a[s : s + step]) for s in range(0, len(a), step)]

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    i_dev = torch.empty(len(wire.iw), dtype=_TORCH_DTYPES[wire.iw.dtype], device=device)
    for s, part in parts(wire.iw):
        i_dev[s : s + len(part)].copy_(up(part))
    if wire.nibble:
        v_dev = torch.empty(2 * len(wire.vw), dtype=torch.int8, device=device)
        for s, part in parts(wire.vw):
            _k5.unpack_nibbles(up(part), out=v_dev[2 * s : 2 * (s + len(part))])
    else:
        v_dev = up(wire.vw)
    aux_dev = {k: up(a) for k, a in wire.aux.items()}
    return i_dev, v_dev, aux_dev


_TORCH_DTYPES = {
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int32): torch.int32,
}


def _geo_pack(
    geo: _SegGeometry, p_cols: torch.Tensor, p_vals: torch.Tensor,
    n_sys_rows: int, n_cols: int, resident: Optional[tuple] = None,
) -> SegmentPack:
    """One side's device planes with its host geometry and K1 plan, or with
    the ``resident`` ``(seg_rows, rem, plan)`` already on the card."""
    shape2 = (geo.n_chunks, geo.sc)
    if resident is not None:
        seg_rows, rem, plan = resident
        if plan.n_sys_rows != n_sys_rows:
            raise ValueError("the resident group plan is for another row count")
        return SegmentPack(
            seg_rows=seg_rows.reshape(shape2),
            cols=p_cols.reshape(*shape2, geo.L), vals=p_vals.reshape(*shape2, geo.L),
            rem=rem.reshape(shape2), plan=plan, n_cols=int(n_cols),
        )
    return pack_from_planes(
        geo.seg_rows.reshape(shape2),
        p_cols.reshape(*shape2, geo.L), p_vals.reshape(*shape2, geo.L),
        geo.rem.reshape(shape2),
        plan_groups(geo.seg_rows, geo.rem, n_sys_rows),
        n_sys_rows, n_cols,
    )


def device_pack_from_wire(
    wire: HostWire,
    device: DeviceLike = None,
    device_wire: Optional[tuple] = None,  # (i_dev, v_dev, aux_dev) pre-shipped
    timings: Optional[dict] = None,
    geo_dev: Optional[tuple] = None,  # resident (sr_u, rem_u, sr_i, rem_i, plan_u, plan_i)
) -> Tuple[SegmentPack, SegmentPack]:
    """Both sides' packs, built on the card from the wire: upload it
    (unless pre-shipped, which fixes the device), then K5a on the user
    side and K5b on the item side. ``seg_rows``, ``rem`` and the K1 plans
    come from the host geometry; nothing is read back from the planes.

    ``geo_dev`` (the reference's :1582, :1645) hands in a resident pack's
    flat int32 ``seg_rows``/``rem`` of both sides already on the card, so
    nothing of the geometry is uploaded. The port's K1 also takes a group
    plan, built on the host from the same geometry, so ``geo_dev`` carries
    both sides' ``GroupPlan`` too: a resident scatter round keeps each
    segment's row and the set of real segments, so the plans stay valid.

    ``timings`` receives ``device_put_s`` (the upload, K4 included, when
    this call ships the wire), ``wire_mb`` and ``device_pack_dispatch_s``
    (K5a and K5b enqueued, the plans built and the geometry uploaded)."""
    if device_wire is None:
        dev = resolve_device(device)
        t = time.perf_counter()
        device_wire = upload_wire(wire, dev)
        if timings is not None:
            _sync(dev)
            timings["device_put_s"] = time.perf_counter() - t
    i_dev, v_dev, aux = device_wire
    if timings is not None:
        timings["wire_mb"] = wire.wire_mb
    t = time.perf_counter()
    u_keys, pcu, pvu = _k5.device_pack_presorted(
        i_dev, v_dev, aux["su"], aux["bu"], wire.geo_u.total, wire.L_u,
        wire.v_scale,
    )
    pci, pvi = _k5.device_scatter_pack(
        i_dev, u_keys, v_dev, aux["si"], aux["bi"], wire.geo_i.total,
        wire.L_i, wire.v_scale, key_bound=wire.n_items + 1,
    )
    R_u, R_i = _padded_rows(wire.n_users, 1), _padded_rows(wire.n_items, 1)
    res_u = res_i = None
    if geo_dev is not None:
        sr_u, rem_u, sr_i, rem_i, plan_u, plan_i = geo_dev
        res_u, res_i = (sr_u, rem_u, plan_u), (sr_i, rem_i, plan_i)
    packs = (
        _geo_pack(wire.geo_u, pcu, pvu, R_u, R_i, res_u),
        _geo_pack(wire.geo_i, pci, pvi, R_i, R_u, res_i),
    )
    if timings is not None:
        timings["device_pack_dispatch_s"] = time.perf_counter() - t
    return packs


def train_from_wire(
    wire: HostWire,
    config: ALSConfig,
    *,
    device: DeviceLike = None,
    device_wire: Optional[tuple] = None,  # (i_dev, v_dev, aux_dev) pre-shipped
    timings: Optional[dict] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 5,
    compile_wait=None,  # from start_compile_async, or None
    factor_state: Optional[tuple] = None,  # pre-placed (X, Y, lam/obs x4)
    warm_start: Optional[ALSModelArrays] = None,
    _fp_material=None,  # () -> bytes: the data's identity for checkpoints
    geo_dev: Optional[tuple] = None,  # resident geometry, see device_pack_from_wire
    factor_slots_out: Optional[dict] = None,  # receives the final device X/Y
) -> ALSModelArrays:
    """Train from a wire: the device pack, then the loop. A pre-shipped
    ``device_wire``, a pre-placed ``factor_state`` and a ``compile_wait``
    let the streaming trainer hand in work it overlapped with the scan.
    ``warm_start`` seeds the factors from a model whose rows are aligned
    to this wire's id spaces. ``geo_dev`` passes a resident pack's
    geometry to ``device_pack_from_wire``; ``factor_slots_out`` (a dict)
    receives the loop's final device factors under ``"X"``/``"Y"`` and
    both packs' device geometry under ``"geo"`` (a ``geo_dev`` tuple), which
    the resident pack keeps for the next round (the reference's tail,
    :2242-2248). ``checkpoint_dir`` saves and resumes the loop every
    ``checkpoint_every`` sweeps (``_train_packed``); the run's data
    identity is ``_fp_material()`` when given (a stripped wire has no
    bytes to hash: the resident round hands in its entry's fingerprint and
    cursor), else the wire's bytes; a stripped wire with a
    ``checkpoint_dir`` and no ``_fp_material`` raises ``ValueError``."""
    _check_ported(config)
    if wire.stripped and device_wire is None:
        raise ValueError("a stripped wire trains only from its resident planes")
    if wire.stripped and checkpoint_dir is not None and _fp_material is None:
        # its planes live on the card, so its bytes would hash as empty and
        # two datasets of one shape could resume each other's checkpoints
        raise ValueError("a stripped wire checkpoints only with its _fp_material")
    dev = device_wire[0].device if device_wire is not None else resolve_device(device)
    if factor_state is None:
        factor_state = init_factor_state_single(
            wire.counts_u, wire.counts_i, wire.n_users, wire.n_items, config,
            warm=(
                None if warm_start is None
                else (
                    np.asarray(warm_start.user_factors, np.float32),
                    np.asarray(warm_start.item_factors, np.float32),
                )
            ),
            device=dev,
        )
    user_pack, item_pack = device_pack_from_wire(
        wire, dev, device_wire=device_wire, timings=timings, geo_dev=geo_dev
    )
    if timings is not None:
        timings["padded_slots"] = wire.padded_slots
    if factor_slots_out is not None:
        factor_slots_out["geo"] = (
            user_pack.seg_rows.reshape(-1), user_pack.rem.reshape(-1),
            item_pack.seg_rows.reshape(-1), item_pack.rem.reshape(-1),
            user_pack.plan, item_pack.plan,
        )
    return _train_packed(
        user_pack, item_pack, *factor_state,
        config=config, n_users=wire.n_users, n_items=wire.n_items,
        timings=timings, compile_wait=compile_wait,
        factor_slots_out=factor_slots_out,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        fp_material=_fp_material if _fp_material is not None else wire.identity_bytes,
    )


def train_als(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    ratings: np.ndarray,
    n_users: int,
    n_items: int,
    config: ALSConfig = ALSConfig(),
    device: DeviceLike = None,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 5,
    timings: Optional[dict] = None,
) -> ALSModelArrays:
    """Train ALS factors from COO ratings on ``device`` (CUDA unless the
    CPU is asked for): the reference's ``train_als``. Without a ``mesh``
    (or on a mesh of one shard, on its device) the wire route
    (``build_host_wire``, then ``train_from_wire``); on a 1-D ``data``
    ``Mesh`` of several shards the mesh route (``_train_als_mesh``), whose
    factors equal the wire route's bit for bit. A mesh with other axes
    raises ``ValueError``.

    With ``checkpoint_dir`` the factors are saved every
    ``checkpoint_every`` sweeps, and a run of the same ratings and config
    resumes from the latest save (the run's identity hashes the COO as
    given, as the reference's :1785, and the shard count).

    ``timings``, if given, receives the reference's phase breakdown:
    ``pack_s`` (the host wire), ``device_put_s`` (its upload, K4
    included), ``wire_mb``, ``device_pack_dispatch_s`` (K5 and the K1
    plans), ``compile_s``, ``device_loop_s``, ``padded_slots``
    (segment-grid slots of both sides) and ``sweep_telemetry`` (per sweep
    ``dx``, ``dy``, ``x_rms``, ``y_rms``, and ``objective`` in implicit
    mode), and with ``checkpoint_dir`` ``checkpoint_resumed_at`` (the
    sweep the run started from) and ``checkpoint_save_s``. On a mesh
    ``pack_s`` is the host packing and the shards' plans, ``device_put_s``
    their upload with the factor state, and ``shard_rows``,
    ``shard_slots`` and ``shard_ratings`` give each side's rows, segment
    slots (what the split balances) and observations per shard."""
    mesh, device = collapse_mesh(mesh, device)
    _check_ported(config)
    dev = resolve_device(device) if mesh is None else None
    t = time.perf_counter()
    user_idx = np.asarray(user_idx, np.int32)
    item_idx = np.asarray(item_idx, np.int32)
    ratings_f = np.asarray(ratings, np.float32)
    if len(user_idx) and (
        user_idx.min() < 0 or user_idx.max() >= n_users
        or item_idx.min() < 0 or item_idx.max() >= n_items
    ):
        raise ValueError("user or item ids out of range")

    def fp_material() -> bytes:
        return user_idx.tobytes() + item_idx.tobytes() + ratings_f.tobytes()

    if mesh is not None:
        return _train_als_mesh(
            user_idx, item_idx, ratings_f, n_users, n_items, config, mesh,
            checkpoint_dir, checkpoint_every, timings, fp_material, t,
        )
    wire = build_host_wire(user_idx, item_idx, ratings_f, n_users, n_items, config)
    if timings is not None:
        timings["pack_s"] = time.perf_counter() - t
    return train_from_wire(
        wire, config, device=dev, timings=timings, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, _fp_material=fp_material,
    )


def _train_als_mesh(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    ratings: np.ndarray,
    n_users: int,
    n_items: int,
    config: ALSConfig,
    mesh,
    checkpoint_dir: Optional[str],
    checkpoint_every: int,
    timings: Optional[dict],
    fp_material,
    t_start: float,
) -> ALSModelArrays:
    """The mesh route (the reference's :1817-1897, K6s): both sides packed
    on the host from the COO stably sorted by user (the wire's order, so
    each item row's observations come in the order K5b gives one device),
    cut into row shards (``mesh_pack_side``), each shard's pack uploaded to
    its device, the factor state replicated once per distinct device, then
    ``_train_packed``'s chunks and checkpoints over
    ``_run_iterations_mesh``, and one fetch of the first replica."""
    devices = list(mesh.devices)
    n_shards = len(devices)
    distinct = mesh.distinct_devices()
    counts_u = np.bincount(user_idx, minlength=n_users).astype(np.int32)
    counts_i = np.bincount(item_idx, minlength=n_items).astype(np.int32)
    L_u = auto_segment_length(user_idx, n_users, config.segment_length, counts=counts_u)
    L_i = auto_segment_length(item_idx, n_items, config.segment_length, counts=counts_i)
    order = np.argsort(user_idx, kind="stable")
    u, i, r = user_idx[order], item_idx[order], ratings[order]
    R_u, R_i = _padded_rows(n_users, n_shards), _padded_rows(n_items, n_shards)
    host_u, host_i = mesh_pack_sides(u, i, r, n_users, n_items, R_u, R_i, L_u, L_i,
                                     config.chunk_slots, n_shards)
    if timings is not None:
        timings["pack_s"] = time.perf_counter() - t_start
    t = time.perf_counter()
    user = upload_mesh_side(*host_u[:2], devices, R_u, R_i, _padded_rows(n_users, 1))
    item = upload_mesh_side(*host_i[:2], devices, R_i, R_u, _padded_rows(n_items, 1))
    X0, Y0 = _factor_init_host(n_users, n_items, config, n_shards)
    user_lam, user_obs = _lam_obs_host(counts_u, n_users, R_u, config)
    item_lam, item_obs = _lam_obs_host(counts_i, n_items, R_i, config)
    state = [_replicate(a, distinct) for a in (X0, Y0, user_lam, item_lam)]
    state += [{d: torch.from_numpy(a).to(d) for d in distinct} for a in (user_obs, item_obs)]
    if timings is not None:
        for d in distinct:
            _sync(d)
        timings["device_put_s"] = time.perf_counter() - t
        timings["padded_slots"] = sum(
            p.cols.numel() for side in (user, item) for p in side.packs if p is not None
        )
        timings["shard_rows"] = {"user": np.diff(user.bounds).tolist(),
                                 "item": np.diff(item.bounds).tolist()}
        timings["shard_slots"] = {"user": host_u[2], "item": host_i[2]}
        timings["shard_ratings"] = {"user": host_u[3], "item": host_i[3]}
    return _train_packed(
        user, item, *state,
        config=config, n_users=n_users, n_items=n_items, timings=timings,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        fp_material=fp_material,
    )


# --- the regularizer grid (evaluation) ---


def _half_step_grid_mesh(
    X: Replicas,
    Y: Replicas,
    side: MeshSide,
    lam: Replicas,
    has_obs: Replicas,
    y_gram_rows: int,
    implicit: bool,
    alpha: float,
    compute_dtype: str,
) -> Replicas:
    """One half-step of every variant: in implicit mode first each
    variant's Gramian of its counter-side factors per distinct device
    (K12a, one launch per variant, as the reference vmaps ``_gramian``,
    over the rows one device pads to), then per row shard one K13a (in
    ``compute_dtype``) and one K13b into the shard's rows of a new
    [V, R, k] array for all variants, and the rows shared."""
    G = {
        d: torch.stack([_k12.gramian(F[v, :y_gram_rows]) for v in range(F.shape[0])])
        if implicit else None
        for d, F in Y.items()
    }
    X_next = {d: torch.empty_like(F) for d, F in X.items()}
    for _, dev, r0, _, pack in side.shards():
        A, b = _k13.normal_eq_variants(Y[dev], pack, implicit, alpha, compute_dtype)
        _k13.spd_solve_variants(A, b, lam[dev], has_obs[dev], X[dev], G[dev],
                                out=X_next[dev], row0=r0)
    _share_rows(X_next, side)
    return X_next


def _run_iterations_grid_mesh(
    X: Replicas,  # [V, R_u, k] per-variant factors, one replica per device
    Y: Replicas,  # [V, R_i, k]
    user: MeshSide,  # shared by the variants: only λ differs
    item: MeshSide,
    user_lam: Replicas,  # [V, R_u]
    item_lam: Replicas,  # [V, R_i]
    user_has_obs: Replicas,  # [R_u]
    item_has_obs: Replicas,  # [R_i]
    alpha: float,
    n_iters: int,
    implicit: bool,
    compute_dtype: str = "float32",
) -> Tuple[Replicas, Replicas]:
    """The grid's loop (the reference's :942; on a mesh, K13s, with its
    shardings, :995-1013): per sweep the user half-step, then the item
    half-step, every variant in the same launches. Each variant sweeps
    exactly as a serial run of ``train_als`` with its regularizer does."""
    for _ in range(n_iters):
        X = _half_step_grid_mesh(X, Y, user, user_lam, user_has_obs, item.gram_rows,
                                 implicit, alpha, compute_dtype)
        Y = _half_step_grid_mesh(Y, X, item, item_lam, item_has_obs, user.gram_rows,
                                 implicit, alpha, compute_dtype)
    return X, Y


def _run_iterations_grid(
    X: torch.Tensor,  # [V, R_u, k] per-variant factors
    Y: torch.Tensor,  # [V, R_i, k]
    user_pack: SegmentPack,  # shared by the variants: only λ differs
    item_pack: SegmentPack,
    user_lam: torch.Tensor,  # [V, R_u]
    item_lam: torch.Tensor,  # [V, R_i]
    user_has_obs: torch.Tensor,  # [R_u]
    item_has_obs: torch.Tensor,  # [R_i]
    alpha: float,
    n_iters: int,
    implicit: bool,
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grid's loop on one device (the reference's :942, its
    single-device form): ``_run_iterations_grid_mesh`` over one shard that
    holds every row."""
    d = X.device
    X, Y = _run_iterations_grid_mesh(
        {d: X}, {d: Y}, MeshSide.whole(user_pack, d), MeshSide.whole(item_pack, d),
        {d: user_lam}, {d: item_lam}, {d: user_has_obs}, {d: item_has_obs},
        alpha, n_iters, implicit, compute_dtype,
    )
    return X[d], Y[d]


def train_als_grid(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    ratings: np.ndarray,
    n_users: int,
    n_items: int,
    config: ALSConfig,
    regs: Sequence[float],
    device: DeviceLike = None,
    mesh=None,
    timings: Optional[dict] = None,
) -> List[ALSModelArrays]:
    """Train ``len(regs)`` regularizer variants of one ALS configuration
    together on ``device`` (CUDA unless the CPU is asked for): the
    reference's :1023. Everything but ``config.reg`` is shared: both sides
    are packed once on the host, every variant starts from the same seeded
    factors, and the loop launches K13a and K13b once per half-step for all
    variants. Returns one ``ALSModelArrays`` per regularizer, in order,
    matching ``train_als`` with ``reg = regs[v]``. On a 1-D ``data``
    ``Mesh`` of several shards (K13s) each side is cut into row shards as
    ``train_als``'s mesh route cuts it and every shard launches K13a and
    K13b on its rows; the factors equal one device's grid bit for bit. A
    mesh of one shard is its device; a mesh with other axes raises
    ``ValueError``.

    ``timings``, if given, receives ``pack_s`` (the host packing and the
    K13a plans), ``device_put_s`` (the packs and the factor state to the
    device) and ``device_loop_s``."""
    if config.solver != "exact":
        raise ValueError(
            "train_als_grid supports solver='exact' only (the grid loop has "
            "no subspace variant); train subspace configs one at a time via "
            "train_als"
        )
    mesh, device = collapse_mesh(mesh, device)
    _check_ported(config)
    shard_devices = [resolve_device(device)] if mesh is None else list(mesh.devices)
    devices = list(dict.fromkeys(shard_devices))
    n_shards = len(shard_devices)
    k = config.rank
    n_variants = len(regs)
    if n_variants == 0:
        return []
    t = time.perf_counter()
    user_idx = np.asarray(user_idx, np.int32)
    item_idx = np.asarray(item_idx, np.int32)
    ratings = np.asarray(ratings, np.float32)
    if len(user_idx) and (
        user_idx.min() < 0 or user_idx.max() >= n_users
        or item_idx.min() < 0 or item_idx.max() >= n_items
    ):
        raise ValueError("user or item ids out of range")
    L_u = auto_segment_length(user_idx, n_users, config.segment_length)
    L_i = auto_segment_length(item_idx, n_items, config.segment_length)
    r_u, r_i = _padded_rows(n_users, n_shards), _padded_rows(n_items, n_shards)
    host_u, host_i = mesh_pack_sides(user_idx, item_idx, ratings, n_users, n_items, r_u, r_i,
                                     L_u, L_i, config.chunk_slots, n_shards)
    rng = np.random.default_rng(config.seed)
    Y0 = np.zeros((r_i, k), np.float32)
    Y0[:n_items] = np.abs(rng.standard_normal((n_items, k))) / math.sqrt(k)

    def lam_obs(idx: np.ndarray, n_real: int, n_sys_rows: int) -> Tuple[np.ndarray, np.ndarray]:
        counts = np.bincount(idx, minlength=n_real).astype(np.int32)
        lams, obs = [], None
        for reg in regs:
            lam, obs = _lam_obs_host(
                counts, n_real, n_sys_rows, dataclasses.replace(config, reg=float(reg))
            )
            lams.append(lam)
        return np.stack(lams), obs

    host_state = [
        *lam_obs(user_idx, n_users, r_u), *lam_obs(item_idx, n_items, r_i),
        np.zeros((n_variants, r_u, k), np.float32),
        np.repeat(Y0[None], n_variants, axis=0),
    ]
    if timings is not None:
        timings["pack_s"] = time.perf_counter() - t
    t = time.perf_counter()
    user = upload_mesh_side(*host_u[:2], shard_devices, r_u, r_i, _padded_rows(n_users, 1))
    item = upload_mesh_side(*host_i[:2], shard_devices, r_i, r_u, _padded_rows(n_items, 1))
    # the loop never writes these in place (each half-step makes a new X)
    user_lam, user_obs, item_lam, item_obs, X, Y = (
        {d: torch.from_numpy(a).to(d) for d in devices} for a in host_state
    )
    if timings is not None:
        for d in devices:
            _sync(d)
        timings["device_put_s"] = time.perf_counter() - t
    t = time.perf_counter()
    X, Y = _run_iterations_grid_mesh(
        X, Y, user, item, user_lam, item_lam, user_obs, item_obs, config.alpha,
        config.iterations, config.implicit_prefs, config.compute_dtype,
    )
    X_host, Y_host = _first(X).cpu().numpy(), _first(Y).cpu().numpy()
    if timings is not None:
        timings["device_loop_s"] = time.perf_counter() - t
    return [
        ALSModelArrays(X_host[v, :n_users].copy(), Y_host[v, :n_items].copy())
        for v in range(n_variants)
    ]


# --- prediction / evaluation ---


def predict_ratings(
    model: ALSModelArrays,
    user_idx,
    item_idx,
    chunk: int = 1_048_576,
    device: DeviceLike = None,
) -> np.ndarray:
    """Predicted rating for each (user, item) pair: K7 over chunks of
    ``chunk`` pairs on ``device``."""
    dev = resolve_device(device)
    user_idx = np.ascontiguousarray(user_idx, np.int32)
    item_idx = np.ascontiguousarray(item_idx, np.int32)
    if len(user_idx) != len(item_idx):
        raise ValueError("user_idx and item_idx must have one length")
    # the ids are checked once here, so K7 launches without a sync
    for name, ids, n in (("user", user_idx, model.user_factors.shape[0]),
                         ("item", item_idx, model.item_factors.shape[0])):
        if len(ids) and (ids.min() < 0 or ids.max() >= n):
            raise ValueError(f"{name} ids out of range [0, {n})")
    X = _upload(model.user_factors, dev)
    Y = _upload(model.item_factors, dev)
    u = torch.from_numpy(user_idx).to(dev)
    i = torch.from_numpy(item_idx).to(dev)
    outs: List[np.ndarray] = []
    for s in range(0, len(u), chunk):
        outs.append(_k7.predict_pairs(
            X, Y, u[s : s + chunk], i[s : s + chunk], check_ids=False
        ).cpu().numpy())
    return np.concatenate(outs) if outs else np.zeros(0, np.float32)


def rmse(model: ALSModelArrays, user_idx, item_idx, ratings, device: DeviceLike = None) -> float:
    pred = predict_ratings(model, user_idx, item_idx, device=device)
    err = pred - np.asarray(ratings, np.float32)
    return float(np.sqrt(np.mean(err * err)))
