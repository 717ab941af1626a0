"""On-device top-N retrieval over one resident item-factor matrix, on one
GPU or row-sharded over a ``Mesh``: the counterpart of
``predictionio_tpu/ops/retrieval.py``.

- Host helpers copied as numpy, same behaviour: ``PRECISIONS`` :128,
  ``quantize_rows_int8`` :131, ``dequantize_rows_int8`` :145,
  ``_reciprocal_norms`` :153, ``unpack_topn`` :191, ``trimmed_results``
  :218, ``build_category_index`` :233, ``category_candidates`` :245,
  ``include_candidates`` :256.
- ``ItemRetriever`` :542. The catalog goes to the card once, in its
  residency tier: ``float32``, ``bf16``, or ``int8`` rows with one f32
  scale per row. Each batch uploads its query rows and per-query id lists,
  builds the candidate bits (``ops/masked_topn.candidate_mask``) and runs
  kernel A (``masked_topn_packed``): the exact masked top-n for float32
  (K9), the stage-1 shortlist for the quantized tiers; those then run
  kernel B (``ops/rescore.rescore_topn``, K10's exact f32 rescore of the
  shortlist) and a host refinement of its candidates against the ORIGINAL
  f32 rows (``_refine_exact``), as the reference does. One device→host copy
  per batch.
- With a ``mesh`` (the reference's :640-668 residency and :941-996 batch):
  the catalog row-sharded, per shard the row-shard forms of the mask and
  kernel A (K9s) or kernels A and B (K10s, ``_shard_topk_kernel_2s``
  :366), each shard's candidates written (or, from another device, peer
  copied) into its block of one ``[S, b_pad, 2·n_local]`` buffer on the
  first shard's device, allocated with the merged rows behind it, and
  merged exactly by K9m on that buffer as it lies (``ops/merge_topn.py``,
  ``_merge_candidates`` :425) into those rows, one fetch, the same host
  refinement. The sampled shard/merge
  split and skew (``_record_skew`` :1037) are kept as numbers on the
  instance (``last_split_s``, ``shard_candidates``, ``shard_skew``).

Not ported yet: the retrieval metric families, the device ledger
registration and the executable-cache accounting wait for the
device-plane tier (item 10); ``resident_bytes`` reads the device tensors.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops.masked_topn import candidate_mask, masked_topn_packed
from predictionio_tpu_torch.ops.merge_topn import merge_topn
from predictionio_tpu_torch.ops.rescore import rescore_topn
from predictionio_tpu_torch.parallel.mesh import collapse_mesh, pad_to_multiple
from predictionio_tpu_torch.utils.shapes import (
    pad_rows_pow2,
    pow2_at_least,
    pow2_topk_width,
)

logger = logging.getLogger(__name__)

# serving-time residency precisions for the resident item matrix
PRECISIONS = ("float32", "bf16", "int8")
# the sharded path records its shard/merge split and skew on the first
# batch and every this many after (the split needs a host sync)
SPLIT_SAMPLE_EVERY = 16


def _synchronize(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def quantize_rows_int8(
    factors: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization: ``scale = max|row|/127``,
    ``row_q = round(row/scale)``. Zero rows get scale 1.0 (their
    quantized form is all-zero either way), so dequantization never
    divides by zero and padding rows stay exactly zero."""
    f = np.asarray(factors, np.float32)
    scale = np.abs(f).max(axis=1) / 127.0
    scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.clip(np.rint(f / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def dequantize_rows_int8(
    rows_q: np.ndarray, scale: np.ndarray
) -> np.ndarray:
    """f32 rows the int8 storage round-trips to: the matrix the stage-2
    rescore scores against."""
    return rows_q.astype(np.float32) * np.asarray(scale, np.float32)[:, None]


def _reciprocal_norms(factors: np.ndarray) -> np.ndarray:
    """1/||y|| per row, 0 for zero rows: raw dot scores times this are
    cosines against normalized candidates, so one resident matrix serves
    both raw-dot and cosine scoring."""
    norms = np.linalg.norm(np.asarray(factors, np.float32), axis=1)
    return np.where(norms > 0, 1.0 / np.where(norms == 0, 1.0, norms), 0.0).astype(
        np.float32
    )


def unpack_topn(packed: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(scores [B, n], global item idx [B, n]) from the packed buffer."""
    packed = np.asarray(packed)
    return (
        packed[:, :n],
        np.ascontiguousarray(packed[:, n:]).view(np.int32),
    )


def trimmed_results(
    scores: np.ndarray, idx: np.ndarray, nums: Sequence[int]
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-query ``(item idx, scores)`` pairs from a ``topn`` result,
    trimmed to each query's ``num`` and to its live candidates (masked
    slots carry ``-inf`` and sort to the tail, so the live rows are a
    prefix: the k > live-candidate-count edge)."""
    out = []
    for r, num in enumerate(nums):
        row_s, row_i = scores[r], idx[r]
        take = min(int(num), int((row_s > -np.inf).sum()))
        out.append((row_i[:take], row_s[:take]))
    return out


def build_category_index(items) -> Dict[str, np.ndarray]:
    """items dict (dense idx -> object with ``.categories``) inverted
    to category -> sorted dense indices, consumed as an inclusion list."""
    by_cat: Dict[str, list] = {}
    for idx, item in items.items():
        for c in item.categories:
            by_cat.setdefault(c, []).append(idx)
    return {c: np.asarray(sorted(v), np.int64) for c, v in by_cat.items()}


def category_candidates(
    index: Dict[str, np.ndarray], categories
) -> np.ndarray:
    """Union of the index rows for the given categories (empty array =
    no item carries any of them, i.e. NO candidates)."""
    arrs = [index[c] for c in categories if c in index]
    if not arrs:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate(arrs))


def include_candidates(
    item_index, white_list, categories, category_items
) -> Optional[np.ndarray]:
    """The per-query inclusion list: the ``whiteList`` mapped through the
    item index, intersected with the category candidates
    (``category_items`` is the model's cached inverted-index lookup).
    ``None`` = unrestricted; an EMPTY array = NO candidates."""
    wl: Optional[np.ndarray] = None
    if white_list is not None:
        wl = np.asarray(
            [item_index[i] for i in white_list if i in item_index],
            np.int64,
        )
    if categories is not None:
        cat = category_items(categories)
        wl = cat if wl is None else np.intersect1d(wl, cat)
    return wl


@dataclasses.dataclass(frozen=True)
class _Part:
    """The resident tensors of one device's rows: the whole catalog on one
    device (``off`` 0), or one row shard of a mesh holding global rows
    ``[off, off + rows)``."""

    device: torch.device
    off: int
    y: torch.Tensor
    scale: Optional[torch.Tensor]
    rn: torch.Tensor
    allow: torch.Tensor

    @property
    def nbytes(self) -> int:
        ts = [self.y, self.rn, self.allow] + ([self.scale] if self.scale is not None else [])
        return int(sum(t.numel() * t.element_size() for t in ts))


class ItemRetriever:
    """Device-resident top-N retrieval over one item-factor matrix (CUDA
    unless ``device`` or the mesh names the CPU, where the kernels' plain
    twins run).

    Construct once at ``prepare_serving``; each query batch then ships
    only its ``[B, k]`` query rows and small per-query id lists up, and one
    packed buffer down. ``precision`` selects the residency tier:
    ``"float32"`` (exact, one kernel pass), ``"bf16"`` or ``"int8"`` (rows
    + one f32 scale per row): stage 1 shortlists the
    top-(``shortlist_mult``·n) candidates from the quantized scores, stage
    2 rescores the shortlist in exact f32 over the dequantized rows, and a
    host refinement rescores its candidates against the ORIGINAL f32 rows
    (host RAM): returned scores are exact over the original matrix.

    With a ``mesh`` (``parallel/mesh.py``) the rows, norms, scales and mask
    are row-sharded: the catalog is zero-padded with invalid
    rows to a multiple of the shard count S, and shard s holds rows
    ``[s·R, (s+1)·R)`` on its device. Each shard runs the row-shard forms of
    kernel A (and B) on the replicated query and global id lists and keeps
    its ``n_local`` best with global ids (K9s, K10s); the blocks gather on
    the mesh's first device (a peer copy, none where a shard shares that
    device) and K9m (``ops/merge_topn.py``) merges them exactly. A mesh of
    one shard collapses to the single-device path on its device.
    """

    def __init__(
        self,
        item_factors: np.ndarray,
        mesh=None,
        component: str = "retrieval",
        device: DeviceLike = None,
        precision: str = "float32",
        shortlist_mult: int = 4,
    ):
        if precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, got {precision!r}"
            )
        if shortlist_mult < 1:
            raise ValueError(
                f"shortlist_mult must be >= 1, got {shortlist_mult}"
            )
        mesh, device = collapse_mesh(mesh, device)
        self.mesh = mesh
        self.component = component
        self.precision = precision
        self.shortlist_mult = int(shortlist_mult)
        factors = np.asarray(item_factors, np.float32)
        self.n_items, self.rank = factors.shape
        n_shards = mesh.size if mesh is not None else 1
        self._n_shards = n_shards
        n_pad = pad_to_multiple(max(self.n_items, 1), n_shards)
        self._n_pad = n_pad
        padded = np.zeros((n_pad, self.rank), np.float32)
        padded[: self.n_items] = factors
        # the resident rows and the f32 matrix stage 2 scores against;
        # norms fold from the DEQUANTIZED rows, so the cosine path agrees
        # with stage 2's rescore
        scale_host: Optional[np.ndarray] = None
        if precision == "int8":
            y_q, scale_host = quantize_rows_int8(padded)
            y_host = torch.from_numpy(y_q)
            deq = dequantize_rows_int8(y_q, scale_host)
        elif precision == "bf16":
            y_host = torch.from_numpy(padded).to(torch.bfloat16)
            deq = y_host.to(torch.float32).numpy()
        else:
            y_host, deq = torch.from_numpy(padded), padded
        self._y_host = y_host
        self._scale_host = scale_host
        # the final exact rescore reads the ORIGINAL f32 rows from host
        # RAM: only the quantized rows occupy device memory
        if precision != "float32":
            self._y_f32_host: Optional[np.ndarray] = padded
            rn_exact = np.zeros(n_pad, np.float32)
            rn_exact[: self.n_items] = _reciprocal_norms(factors)
            self._rn_f32_host: Optional[np.ndarray] = rn_exact
        else:
            self._y_f32_host = None
            self._rn_f32_host = None
        rn = np.zeros(n_pad, np.float32)
        rn[: self.n_items] = _reciprocal_norms(deq[: self.n_items])
        self._rn_host = rn
        self._valid = np.zeros(n_pad, bool)
        self._valid[: self.n_items] = True
        self._excluded_ids: Optional[np.ndarray] = None
        if mesh is None:
            self._device = resolve_device(device)
            places = [(self._device, 0, 0, n_pad)]
        else:
            rows = n_pad // n_shards
            self._device = None
            places = [
                (dev, s * rows, s * rows, (s + 1) * rows)
                for s, dev in enumerate(mesh.devices)
            ]
        self._parts: List[_Part] = [
            _Part(
                device=dev, off=off, y=y_host[lo:hi].to(dev),
                scale=(torch.from_numpy(scale_host[lo:hi]).to(dev)
                       if scale_host is not None else None),
                rn=torch.from_numpy(rn[lo:hi]).to(dev),
                allow=torch.from_numpy(self._valid[lo:hi]).to(dev),
            )
            for dev, off, lo, hi in places
        ]
        self._freed = False
        # the sampled shard/merge split and skew (the reference's metric
        # families, kept as plain numbers until the device-plane tier)
        self._batches = 0
        self.last_split_s: Optional[Dict[str, float]] = None
        self.shard_candidates: Optional[List[int]] = None
        self.shard_skew: Dict[str, float] = {}
        logger.info(
            "ItemRetriever[%s]: %d items (rank %d, %s) resident %s",
            component, self.n_items, self.rank, precision,
            f"row-sharded over {n_shards} shards" if mesh is not None
            else f"on {self._device}",
        )

    # the single-device tensors (the kernels' operands on one device)
    @property
    def _y_dev(self):
        return self._parts[0].y if self._parts else None

    @property
    def _scale_dev(self):
        return self._parts[0].scale if self._parts else None

    @property
    def _rn_dev(self):
        return self._parts[0].rn if self._parts else None

    @property
    def _allow_dev(self):
        return self._parts[0].allow if self._parts else None

    # --- resident global mask ---

    def set_excluded_ids(self, idx) -> bool:
        """Replace the resident exclusion set (dense item indices).
        Rebuilds and re-uploads the mask (each shard's slice on a mesh)
        only when the set changed; returns whether it did. The swap is one
        reference assignment, so in-flight batches keep the mask they
        started with."""
        idx = np.unique(np.asarray(idx, np.int64)) if len(idx) else np.zeros(
            0, np.int64
        )
        idx = idx[(idx >= 0) & (idx < self.n_items)]
        if self._excluded_ids is not None and np.array_equal(
            idx, self._excluded_ids
        ):
            return False
        allow = self._valid.copy()
        allow[idx] = False
        rows = self._n_pad // self._n_shards
        self._parts = [
            dataclasses.replace(
                p, allow=torch.from_numpy(allow[s * rows:(s + 1) * rows]).to(p.device)
            )
            for s, p in enumerate(self._parts)
        ]
        self._excluded_ids = idx
        return True

    @property
    def resident_bytes(self) -> int:
        """Bytes of the device tensors, summed over the shards: rows,
        norms, mask (and scales)."""
        return sum(p.nbytes for p in self._parts)

    def dequantized_factors(self) -> np.ndarray:
        """Host f32 matrix the device path scores against: the original
        factors for float32, the dequantized resident rows otherwise."""
        if self.precision == "int8":
            deq = dequantize_rows_int8(self._y_host.numpy(), self._scale_host)
        else:
            deq = self._y_host.to(torch.float32).numpy()
        return deq[: self.n_items]

    # --- the hot path ---

    def _assemble_idx(
        self, lists, b_pad: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-query id lists -> a sentinel-padded [b_pad, W] int32 block
        (W the next power of two) plus the has-list flag vector. The
        sentinel is n_pad: out of range on every shard and on the single
        device, so the mask kernel drops it."""
        has = np.zeros(b_pad, bool)
        width = 1
        rows: List[np.ndarray] = []
        for a in lists:
            if a is None:
                rows.append(np.zeros(0, np.int64))
                continue
            a = np.asarray(a, np.int64)
            rows.append(a)
            width = max(width, len(a))
        width = pow2_at_least(width)
        out = np.full((b_pad, width), self._n_pad, np.int32)
        for r, a in enumerate(rows):
            if len(a):
                out[r, : len(a)] = a
            has[r] = lists[r] is not None
        return out, has

    def topn(
        self,
        query_rows: np.ndarray,
        n: int,
        *,
        exclude: Optional[Sequence] = None,
        include: Optional[Sequence] = None,
        positive_only: bool = False,
        normalize: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact masked top-``n`` for a query batch.

        ``exclude``/``include`` are per-query dense item-index arrays
        (``None`` entries mean no list for that query; an ``include``
        entry restricts the query's candidates to exactly that set: an
        empty array means NO candidates). ``positive_only`` drops
        non-positive scores; ``normalize`` scores against L2-normalized
        candidates (the cosine path). Returns (scores [B, n], item idx
        [B, n]); slots past a query's live-candidate count carry -inf.
        """
        if self._freed:
            raise RuntimeError(
                "ItemRetriever was freed (release_serving); the owner "
                "must null its reference before freeing"
            )
        q = np.atleast_2d(np.asarray(query_rows, np.float32))
        b = q.shape[0]
        if not (0 < n <= self.n_items):
            raise ValueError(
                f"n must be in [1, {self.n_items}], got {n}"
            )
        # quantized tiers: the device returns the c·n-wide candidate list
        # and the host refinement rescores it against the original rows
        n_dev = (
            n if self.precision == "float32"
            else self._shortlist_width(n, self.n_items)
        )
        qp = pad_rows_pow2(q, 8)
        b_pad = qp.shape[0]
        excl, _ = self._assemble_idx(
            list(exclude or []) + [None] * (b_pad - b), b_pad
        )
        incl, has_incl = self._assemble_idx(
            list(include or []) + [None] * (b_pad - b), b_pad
        )
        if self.mesh is None:
            host = self._topn_single(qp, excl, incl, has_incl, n_dev,
                                     positive_only, normalize)[:b]
        else:
            host = self._topn_sharded(qp, excl, incl, has_incl, n_dev,
                                      positive_only, normalize, b)
        if self.precision != "float32":
            return self._refine_exact(q, host, n_dev, n, positive_only, normalize)
        return unpack_topn(host, n)

    def _topn_single(self, qp, excl, incl, has_incl, n_dev, positive_only,
                     normalize) -> np.ndarray:
        """One device: mask, kernel A (and B); the packed [b_pad, 2·n_dev]
        rows on the host."""
        part = self._parts[0]
        dev = part.device
        q_dev = torch.from_numpy(qp).to(dev)
        bits = candidate_mask(
            part.allow,
            torch.from_numpy(excl).to(dev),
            torch.from_numpy(incl).to(dev),
            torch.from_numpy(has_incl).to(dev),
        )
        rn = part.rn if normalize else None
        if self.precision == "float32":
            packed = masked_topn_packed(
                q_dev, part.y, None, rn, bits, n_dev, positive_only, normalize,
            )
            return packed.cpu().numpy()
        shortlist = self._shortlist_width(n_dev, self._n_pad)
        stage1 = masked_topn_packed(
            q_dev, part.y, part.scale, rn, bits, shortlist,
            positive_only, normalize,
        )
        return rescore_topn(
            q_dev, part.y, part.scale, rn, stage1, n_dev,
            positive_only, normalize,
        ).cpu().numpy()

    def _topn_sharded(self, qp, excl, incl, has_incl, n_dev, positive_only,
                      normalize, b) -> np.ndarray:
        """The mesh path (the reference's :941-996): per shard the mask,
        kernel A (and B) in their row-shard forms, each shard's
        ``n_local`` candidates with global ids into one ``[S, b_pad,
        2·n_local]`` buffer on the first shard's device (allocated with
        the merged rows behind it), K9m on that buffer as it lies into
        those rows, one fetch. The first batch and every
        ``SPLIT_SAMPLE_EVERY``-th record the shard/merge split and the skew
        (a host sync between the two)."""
        parts = self._parts
        S, rows = self._n_shards, self._n_pad // self._n_shards
        b_pad = qp.shape[0]
        n_local = min(n_dev, rows)
        shortlist = (
            None if self.precision == "float32"
            else self._shortlist_width(n_local, rows)
        )
        self._batches += 1
        split = self._batches % SPLIT_SAMPLE_EVERY == 1
        t0 = time.perf_counter()
        # the replicated query block and id lists: one upload per device
        ops = {}
        for dev in dict.fromkeys(p.device for p in parts):
            ops[dev] = tuple(torch.from_numpy(a).to(dev) for a in (qp, excl, incl, has_incl))
        dev0 = parts[0].device
        # the shards' candidates and the merged rows: one allocation
        size = S * b_pad * 2 * n_local
        buf = torch.empty(size + b_pad * 2 * n_dev, dtype=torch.float32, device=dev0)
        cand = buf[:size].view(S, b_pad, 2 * n_local)
        for s, part in enumerate(parts):
            q_dev, excl_dev, incl_dev, has_dev = ops[part.device]
            bits = candidate_mask(part.allow, excl_dev, incl_dev, has_dev, id_offset=part.off)
            rn = part.rn if normalize else None
            dst = cand[s] if part.device == dev0 else None
            if shortlist is None:
                got = masked_topn_packed(
                    q_dev, part.y, None, rn, bits, n_local, positive_only, normalize,
                    id_offset=part.off, out=dst,
                )
            else:
                stage1 = masked_topn_packed(
                    q_dev, part.y, part.scale, rn, bits, shortlist,
                    positive_only, normalize,
                )
                got = rescore_topn(
                    q_dev, part.y, part.scale, rn, stage1, n_local,
                    positive_only, normalize, id_offset=part.off, out=dst,
                )
            if dst is None:
                cand[s].copy_(got)  # the peer copy to the first device
        if split:
            _synchronize(dict.fromkeys(p.device for p in parts))
            t1 = time.perf_counter()
        packed = merge_topn(cand, n_dev, out=buf[size:].view(b_pad, 2 * n_dev))
        host = packed.cpu().numpy()[:b]
        if split:
            self.last_split_s = {"shards": t1 - t0, "merge": time.perf_counter() - t1}
            self._record_skew(cand.cpu().numpy()[:, :b], host, n_dev, n_local)
        return host

    def _refine_exact(
        self,
        q: np.ndarray,
        packed: np.ndarray,
        n_dev: int,
        n: int,
        positive_only: bool,
        normalize: bool,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Final exact rescore of the device's c·n candidates against the
        ORIGINAL float32 rows in host RAM (B·c·n·k host FLOPs per batch):
        recall@n is then limited only by whole-shortlist misses."""
        s_d, i_d = unpack_topn(packed, n_dev)
        rows = self._y_f32_host[i_d]  # [B, n_dev, k] gather, host RAM
        sc = np.einsum(
            "bk,bnk->bn", q, rows, optimize=True
        ).astype(np.float32)
        if normalize:
            sc = sc * self._rn_f32_host[i_d]
        if positive_only:
            sc = np.where(sc > 0, sc, -np.inf)
        # dead device slots stay dead whatever their placeholder id
        # rescores to
        sc = np.where(s_d == -np.inf, -np.inf, sc)
        # descending exact score, ties broken by LOWEST global id
        order = np.lexsort((i_d, -sc), axis=1)[:, :n]
        return (
            np.take_along_axis(sc, order, axis=1),
            np.take_along_axis(i_d, order, axis=1),
        )

    def _record_skew(
        self, cand: np.ndarray, host: np.ndarray, n: int, n_local: int
    ) -> None:
        """Cross-shard imbalance from one sampled batch (the reference's
        :1037): live candidates per shard, and which shard each final
        top-n row came from, as max over mean. ``cand`` is the batch's
        ``[S, b, 2·n_local]`` candidates."""
        S = self._n_shards
        if not cand.shape[1]:
            return
        live = (cand[:, :, :n_local] > -np.inf).sum(axis=(1, 2)).astype(float)
        self.shard_candidates = [int(v) for v in live]
        if live.mean() > 0:
            self.shard_skew["candidates"] = float(live.max() / live.mean())
        idx = np.ascontiguousarray(host[:, n:]).view(np.int32)
        owners = idx[host[:, :n] > -np.inf] // (self._n_pad // S)
        counts = np.bincount(owners, minlength=S).astype(float)
        if counts.mean() > 0:
            self.shard_skew["results"] = float(counts.max() / counts.mean())

    def _shortlist_width(self, n: int, rows: int) -> int:
        """Stage-1 shortlist width for a final top-``n`` over ``rows``
        candidate rows: ``shortlist_mult``·n on the pow2 ladder, clamped
        to the row count, never below ``n``."""
        return pow2_topk_width(min(self.shortlist_mult * n, rows), rows)

    def free(self) -> None:
        """Drop the device-resident tensors (every shard's). Owner contract:
        null the model's retriever reference first and call this after the
        last in-flight batch drained; a later ``topn`` raises. The memory frees
        by refcount, so a straggler still holding the tensors keeps them
        alive until it ends."""
        self._freed = True
        self._parts = []
        self._y_f32_host = None
        self._rn_f32_host = None

    def warm(
        self,
        n: int = 16,
        max_batch: int = 128,
        flag_combos: Sequence[Tuple[bool, bool]] = ((True, False),),
        exclude_widths: Sequence[int] = (1, 16, 64),
    ) -> None:
        """Run one batch per flag combo before traffic, so the kernels'
        libraries are built and loaded. The signature is the reference's,
        which compiles one program per (top-k tier, flags, exclude width,
        padded batch); these kernels take any shape once their library is
        loaded, so ``max_batch`` and ``exclude_widths`` change nothing and
        one top-``n`` call (clamped to the catalog) per combo suffices."""
        q = np.zeros((8, self.rank), np.float32)
        for positive_only, normalize in flag_combos:
            self.topn(q, min(n, self.n_items),
                      positive_only=positive_only, normalize=normalize)
