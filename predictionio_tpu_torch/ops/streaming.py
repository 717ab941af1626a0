"""Streaming store→device ALS training: the cold path of
``predictionio_tpu/ops/streaming.py``.

The store scan, the host pack, the upload and the kernels' build overlap:
- the scan (a ``data.storage.columnar.ColumnarStream``) runs on a
  background thread and pushes its batches through a bounded queue
  (``_scan_worker`` :648);
- each batch is folded while the next one is read: dense per-side ids in
  first-appearance order, per-row counts, and a stable presort of the
  batch by user (``_scan_and_pack`` :677);
- when the scan ends, the ids are relabelled into sorted-name order, the
  geometry is known, the kernels' build starts on its own thread
  (``als.start_compile_async``), and the presorted batches merge into the
  final ``als.HostWire`` with one counting-sort scatter
  (``_scatter_merge`` :613, no global argsort);
- the wire goes up in ``ship_chunks`` chunks, K4 unpacking each value
  chunk into its slice of one plane as soon as it is up (the reference's
  ``_ship_wire`` :1322 is ``als.upload_wire`` here), then the factor state
  is placed and ``als.train_from_wire`` packs with K5 and runs the loop.
The wire is byte-identical to ``als.build_host_wire`` over the relabelled
COO, so the factors equal the direct route's bit for bit.

Not ported yet (ROADMAP.md queue 1 item 4): the pack-artifact cache, the
delta fold, the device-resident pack and the workflow timer. A stream with
a cache identity (``cache_key``, ``cache_scope`` and ``fingerprint`` all
set) would reach the cache, so it raises ``NotImplementedError`` unless
``cache=False``; a stream without one trains as the reference trains it,
``pack_cache`` "miss" ("off" with ``cache=False``).
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from typing import Optional

import numpy as np

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops import als as _als

# batches the scan thread may run ahead of the fold
QUEUE_BATCHES = 4

# --- incremental pack state ---


class _SideCodes:
    """Dense per-side row ids over the stream's SHARED code space.

    The stream's batches carry codes from one table-global dictionary
    (users and items mixed); each solve side needs its own dense 0..n-1
    id space. Dense ids are assigned in first-appearance order as
    batches fold in, and the shared code of each dense id is kept so the
    stream's post-scan ``names`` array resolves dense ids to id strings.
    """

    def __init__(self):
        self._dense_of = np.full(1024, -1, np.int64)
        self._code_chunks = []
        self.n = 0

    def fold(self, codes: np.ndarray) -> np.ndarray:
        codes = np.asarray(codes)
        if not len(codes):
            return np.empty(0, np.int32)
        hi = int(codes.max()) + 1
        if hi > len(self._dense_of):
            grown = np.full(max(hi, 2 * len(self._dense_of)), -1, np.int64)
            grown[: len(self._dense_of)] = self._dense_of
            self._dense_of = grown
        dense = self._dense_of[codes]
        miss = dense < 0
        if miss.any():
            new_codes = codes[miss]
            uniq, first = np.unique(new_codes, return_index=True)
            uniq = uniq[np.argsort(first, kind="stable")]  # appearance order
            self._dense_of[uniq] = np.arange(
                self.n, self.n + len(uniq), dtype=np.int64
            )
            self._code_chunks.append(uniq)
            self.n += len(uniq)
            dense = self._dense_of[codes]
        return dense.astype(np.int32)

    def codes(self) -> np.ndarray:
        """Shared code of each dense id (dense-id order)."""
        if not self._code_chunks:
            return np.empty(0, np.int64)
        return np.concatenate(self._code_chunks)


def _grow_add(acc: np.ndarray, add: np.ndarray) -> np.ndarray:
    if len(add) > len(acc):
        grown = np.zeros(len(add), np.int64)
        grown[: len(acc)] = acc
        acc = grown
    acc[: len(add)] += add
    return acc


def _scatter_merge(
    batches, n, n_users, n_items, geo_u,
    remap_u=None, remap_i=None,
):
    """Counting-sort merge of user-presorted COO batches into the final
    sentinel-padded item/value planes. Each batch must be sorted by its
    user ids; ``remap_u``/``remap_i`` optionally relabel per-batch ids
    into the final dense spaces (injective and monotone, so the sort
    survives it). Scattering batch b's run of user u right after the runs
    batches 0..b-1 wrote reproduces EXACTLY the stable global argsort of
    the monolithic packer: per user, batches in scan order, original
    order within."""
    pad = (_als._bucket_count(n) - n) if n else 1
    iw = np.full(n + pad, n_items, np.int32)  # padding -> sentinel id
    vw = np.zeros(n + pad, np.float32)
    heads = geo_u.starts[:-1].copy()  # [n_users] int64 write heads
    for u, i, v in batches:
        m = len(u)
        if not m:
            continue
        idx = np.arange(m, dtype=np.int64)
        newgrp = np.empty(m, bool)
        newgrp[0] = True
        np.not_equal(u[1:], u[:-1], out=newgrp[1:])
        first = np.maximum.accumulate(np.where(newgrp, idx, 0))
        u_f = remap_u[u] if remap_u is not None else u
        pos = heads[u_f] + (idx - first)
        iw[pos] = remap_i[i] if remap_i is not None else i
        vw[pos] = v
        heads += np.bincount(u_f, minlength=n_users)
    return iw, vw


def _scan_worker(stream, q: "_queue.Queue", box: dict) -> None:
    """Drive the scan on this thread, pushing batches through the bounded
    queue; resolve ``stream.names`` here too, since it is only valid after
    exhaustion."""
    busy = 0.0
    try:
        it = iter(stream)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            busy += time.perf_counter() - t0
            q.put(batch)
        t0 = time.perf_counter()
        box["names"] = stream.names
        busy += time.perf_counter() - t0
    except BaseException as e:
        box["error"] = e
    finally:
        box["scan_s"] = busy
        box["done_at"] = time.perf_counter()
        q.put(None)


def _scan_and_pack(stream, config, timings: dict, device):
    """Consume a ColumnarStream into a HostWire + id indexes, folding
    each batch while the scan of the next runs on the producer thread.

    Returns ``(wire, user_index, item_index, compile_wait)`` or None for
    an empty scan (callers fall back to the materialized path, whose
    sanity check owns the user-facing error)."""
    q: "_queue.Queue" = _queue.Queue(maxsize=QUEUE_BATCHES)
    box: dict = {}
    th = threading.Thread(
        target=_scan_worker, args=(stream, q, box),
        daemon=True, name="als-stream-scan",
    )
    th.start()

    uspace, ispace = _SideCodes(), _SideCodes()
    counts_u = np.zeros(0, np.int64)
    counts_i = np.zeros(0, np.int64)
    batches = []
    n = 0
    fold_busy = 0.0
    while True:
        batch = q.get()
        if batch is None:
            break
        e_codes, t_codes, values = batch
        t0 = time.perf_counter()
        u = uspace.fold(e_codes)
        i = ispace.fold(t_codes)
        # stable presort by user NOW, under the scan of the next batch;
        # the merge below then only scatters
        order = np.argsort(u, kind="stable")
        u, i = u[order], i[order]
        v = np.asarray(values, np.float32)[order]
        counts_u = _grow_add(counts_u, np.bincount(u, minlength=uspace.n))
        counts_i = _grow_add(counts_i, np.bincount(i, minlength=ispace.n))
        batches.append((u, i, v))
        n += len(v)
        fold_busy += time.perf_counter() - t0
    th.join()
    if "error" in box:
        raise box["error"]
    timings["scan_s"] = box.get("scan_s", 0.0)
    timings["fold_s"] = fold_busy
    if n == 0:
        return None
    t_scan_done = box["done_at"]

    # Final dense ids relabel the provisional (first-appearance) ids into
    # SORTED-NAME order, the order a monolithic scan assigns, so the wire
    # is byte-identical to the monolithic packer's and the factors match
    # it exactly. The relabeling is catalog-sized, not event-sized.
    names = box["names"]
    u_names = names[uspace.codes()]
    i_names = names[ispace.codes()]
    n_users, n_items = uspace.n, ispace.n
    perm_u = np.argsort(u_names)
    perm_i = np.argsort(i_names)
    remap_u = np.empty(n_users, np.int32)
    remap_u[perm_u] = np.arange(n_users, dtype=np.int32)
    remap_i = np.empty(n_items, np.int32)
    remap_i[perm_i] = np.arange(n_items, dtype=np.int32)
    counts_u32 = np.zeros(n_users, np.int64)
    counts_u32[: len(counts_u)] = counts_u
    counts_u32 = counts_u32[perm_u].astype(np.int32)
    counts_i32 = np.zeros(n_items, np.int64)
    counts_i32[: len(counts_i)] = counts_i
    counts_i32 = counts_i32[perm_i].astype(np.int32)
    L_u = _als.auto_segment_length(
        None, n_users, config.segment_length, counts=counts_u32
    )
    L_i = _als.auto_segment_length(
        None, n_items, config.segment_length, counts=counts_i32
    )
    geo_u = _als._segment_geometry(
        counts_u32, n_users, L_u, 1, config.chunk_slots
    )
    geo_i = _als._segment_geometry(
        counts_i32, n_items, L_i, 1, config.chunk_slots
    )
    # geometry known: the kernels' build starts NOW, under the merge,
    # the narrowing and the upload
    compile_wait = _als.start_compile_async(device, config)

    iw, vw = _scatter_merge(
        batches, n, n_users, n_items, geo_u,
        remap_u=remap_u, remap_i=remap_i,
    )
    batches.clear()

    wire = _als.finish_wire(
        iw, vw, n_users, n_items, L_u, L_i, geo_u, geo_i,
        counts_u32, counts_i32,
    )
    user_index = BiMap(
        {str(nm): j for j, nm in enumerate(u_names[perm_u])}
    )
    item_index = BiMap(
        {str(nm): j for j, nm in enumerate(i_names[perm_i])}
    )
    now = time.perf_counter()
    # exposed = the tail the scan could not hide: late folds + geometry
    # + merge + narrow/nibble + index build
    timings["pack_exposed_s"] = max(0.0, now - t_scan_done)
    timings["pack_s"] = fold_busy + timings["pack_exposed_s"]
    return wire, user_index, item_index, compile_wait


# --- the pipeline entry ---


@dataclasses.dataclass
class StreamTrainResult:
    arrays: "_als.ALSModelArrays"
    user_index: BiMap
    item_index: BiMap
    timings: dict


def train_als_streaming(
    stream,
    config: "_als.ALSConfig",
    *,
    device: DeviceLike = None,
    timings: Optional[dict] = None,
    timer=None,
    checkpoint_dir: Optional[str] = None,
    ship_chunks: int = 2,
    cache: bool = True,
) -> Optional[StreamTrainResult]:
    """Train ALS from a ``ColumnarStream`` on ``device`` (CUDA unless the
    CPU is asked for) through the overlapped pipeline (module docstring).
    Returns None when ``stream`` is None or the scan is empty: callers
    fall back to the materialized ``train_als`` and its error reporting.

    ``timings`` gains the pipeline's phase split: ``scan_s``/``fold_s``/
    ``compile_s`` (busy, overlapped), ``pack_exposed_s``/
    ``device_put_exposed_s``/``compile_exposed_s`` (critical-path wall),
    ``pack_cache`` ("miss", or "off" with ``cache=False``), and the
    training tail's ``wire_mb``/``device_pack_dispatch_s``/
    ``device_loop_s``/``padded_slots``/``sweep_telemetry``. The port's
    uploads block the host, so ``device_put_exposed_s`` spans the whole
    upload (K4 included) and the factor-state placement."""
    if timer is not None:
        raise NotImplementedError(
            "the workflow phase timer is not ported yet (ROADMAP.md queue 1 "
            "item 4)"
        )
    if stream is None:
        return None
    identity = (stream.cache_key, stream.cache_scope, stream.fingerprint)
    if cache and all(x is not None for x in identity):
        raise NotImplementedError(
            "the pack-artifact cache and the delta fold are not ported yet "
            "(ROADMAP.md queue 1 item 4); pass cache=False to train this "
            "stream cold"
        )
    _als._check_ported(config, checkpoint_dir=checkpoint_dir)
    dev = resolve_device(device)
    timings = {} if timings is None else timings
    t_start = time.perf_counter()
    timings["pack_cache"] = "miss" if cache else "off"
    packed = _scan_and_pack(stream, config, timings, dev)
    if packed is None:
        return None
    wire, user_index, item_index, compile_wait = packed

    t0 = time.perf_counter()
    device_wire = _als.upload_wire(wire, dev, n_chunks=ship_chunks)
    factor_state = _als.init_factor_state_single(
        wire.counts_u, wire.counts_i, wire.n_users, wire.n_items, config,
        device=dev,
    )
    _als._sync(dev)
    timings["device_put_exposed_s"] = time.perf_counter() - t0

    arrays = _als.train_from_wire(
        wire, config,
        device_wire=device_wire,
        timings=timings,
        compile_wait=compile_wait,
        factor_state=factor_state,
    )
    timings["stream_wall_s"] = time.perf_counter() - t_start
    return StreamTrainResult(
        arrays=arrays, user_index=user_index, item_index=item_index,
        timings=timings,
    )
