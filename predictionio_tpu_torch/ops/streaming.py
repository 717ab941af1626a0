"""Streaming store→device ALS training: ``predictionio_tpu/ops/streaming.py``
on one GPU, cold path, pack cache, delta fold and device-resident pack.

The cold path. The store scan, the host pack, the upload and the kernels'
build overlap:
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

The pack-artifact cache (:64-234). A stream with a cache identity
(``cache_key``, a weakref-able ``cache_scope`` compared by identity, and a
``fingerprint`` read before its scan) keeps its wire, id indexes, scan
cursor and trained factors in a process-wide LRU of
``PACK_CACHE_MAX_ENTRIES``. The next round over an unchanged store is a
``hit`` (no scan, no pack); over a store that grew, a ``fold``: the
stream's ``delta_factory(cursor)`` yields only the new rows, which fold
into the cached wire (``_fold_delta_host`` :933: the old COO through
``als.wire_coo`` and the monotone relabel, the delta presorted, one
``_scatter_merge``), byte-identical to a cold rescan of the grown store,
and training warm-starts from the last factors for ``warm_sweeps`` sweeps.
Anything else is a ``miss``.

The device-resident pack (:237-553, :1036). With
``set_resident_training(True)`` a cold round parks its uploaded planes,
offsets, segment geometry, K1 group plans and final factors on the card
(``ResidentPack``) and strips the cached host wire to its metadata. A hit
then uploads nothing store-sized; a fold whose delta lands on existing ids
without changing the segment geometry, the value tier, the id dtype, the
training semantics or the device runs K8 (``ops/delta_scatter.py``) on the
resident arrays, uploading only the delta rows and the touched
regularizer entries. Every other fold demotes the pack (the host wire
restored byte for byte from the card) and runs the host fold.

The reference's Prometheus families (``pio_pack_cache_total``,
``pio_resident_pack_bytes``, ``pio_resident_pack_rounds_total``,
``pio_train_delta_upload_bytes``) and its device ledger wait for ROADMAP.md
queue 1 item 10; here they are ``pack_cache_stats()``,
``resident_pack_bytes()``, ``resident_round_stats()`` and
``timings["delta_upload_bytes"]``. ``checkpoint_dir`` and
``checkpoint_every`` go to ``als.train_from_wire``, which saves and
resumes the loop; a resident round hands it the entry's fingerprint and
cursor as the run's data identity (its stripped wire has no bytes to hash),
as the reference does (:1655-1672). ``profile_dir`` (item 10) raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops import als as _als
from predictionio_tpu_torch.ops import delta_scatter as _k8

# batches the scan thread may run ahead of the fold
QUEUE_BATCHES = 4

# --- pack-artifact cache ---


@dataclasses.dataclass
class _PackEntry:
    scope_ref: "weakref.ref"  # the producing scope, by identity
    fingerprint: tuple  # store state the wire was packed from
    wire: "_als.HostWire"
    user_index: BiMap
    item_index: BiMap
    # the foldable checkpoint: the cursor of the store prefix the wire
    # covers (None: no delta path) and the factors trained on it
    cursor: Optional[object] = None
    arrays: Optional["_als.ALSModelArrays"] = None
    # when set, the wire's planes and the factor state live on the card
    # and ``wire`` is its stripped metadata shell
    resident: Optional["ResidentPack"] = None


_PACK_CACHE: "OrderedDict[tuple, _PackEntry]" = OrderedDict()
_PACK_CACHE_LOCK = threading.Lock()
# a wire is ~50 MB at ML-20M; a small LRU covers retrains without growing
# with the number of apps
PACK_CACHE_MAX_ENTRIES = 4
_CACHE_STATS = {"hit": 0, "miss": 0, "fold": 0, "off": 0}
_RESIDENT_ROUNDS = {"cold": 0, "scatter": 0, "fallback": 0}


def pack_cache_clear() -> None:
    """Drop every cached wire with its fold state (releasing any resident
    pack) and reset the hit/miss/fold counters."""
    with _PACK_CACHE_LOCK:
        evicted = list(_PACK_CACHE.values())
        _PACK_CACHE.clear()
        for k in _CACHE_STATS:
            _CACHE_STATS[k] = 0
    for entry in evicted:
        _release_resident(entry)


def pack_cache_stats() -> dict:
    """Lifetime {'hit', 'miss', 'fold'} counters (reset by
    ``pack_cache_clear``)."""
    with _PACK_CACHE_LOCK:
        return {k: _CACHE_STATS[k] for k in ("hit", "miss", "fold")}


def _stat_bump(kind: str) -> None:
    with _PACK_CACHE_LOCK:
        _CACHE_STATS[kind] += 1


def resident_round_stats() -> dict:
    """Lifetime counts of streaming rounds trained with residency on, by
    outcome: ``cold`` (no pack involved), ``scatter`` (the delta applied on
    the card, or a hit on the resident planes), ``fallback`` (the pack
    demoted to the host)."""
    with _PACK_CACHE_LOCK:
        return dict(_RESIDENT_ROUNDS)


def resident_pack_bytes() -> int:
    """Bytes of the live resident packs' device arrays (planes, offsets,
    geometry, group plans, factors, regularizers)."""
    with _PACK_CACHE_LOCK:
        packs = [e.resident for e in _PACK_CACHE.values() if e.resident is not None]
    return sum(p.device_bytes() for p in packs)


def _cache_key(stream, config) -> Optional[tuple]:
    # the wire depends on config only through its pack geometry knobs
    if (
        stream.cache_key is None
        or stream.cache_scope is None
        or stream.fingerprint is None
    ):
        return None
    return (stream.cache_key, config.segment_length, config.chunk_slots)


def _cache_lookup(stream, config, any_fingerprint: bool):
    key = _cache_key(stream, config)
    if key is None:
        return None
    with _PACK_CACHE_LOCK:
        entry = _PACK_CACHE.get(key)
        if entry is None:
            return None
        # identity, not id(): the weakref keeps a dead scope's entry from
        # matching a new object that reused its address
        if entry.scope_ref() is not stream.cache_scope:
            return None
        if not any_fingerprint and entry.fingerprint != stream.fingerprint:
            return None
        _PACK_CACHE.move_to_end(key)
        return entry


def _cache_get(stream, config) -> Optional[_PackEntry]:
    """Exact-state lookup: same scope identity AND same fingerprint."""
    return _cache_lookup(stream, config, any_fingerprint=False)


def _cache_get_foldable(stream, config) -> Optional[_PackEntry]:
    """Stale-state lookup for the delta fold: same key and scope identity,
    any fingerprint, and a cursor to scan the delta from."""
    entry = _cache_lookup(stream, config, any_fingerprint=True)
    if entry is None or entry.cursor is None:
        return None
    return entry


def _cache_put(
    stream, config, wire, user_index, item_index,
    fingerprint=None, cursor=None,
) -> Optional[_PackEntry]:
    key = _cache_key(stream, config)
    if key is None:
        return None
    try:
        ref = weakref.ref(stream.cache_scope)
    except TypeError:  # a scope that cannot be weakref'd: no caching
        return None
    entry = _PackEntry(
        ref,
        stream.fingerprint if fingerprint is None else fingerprint,
        wire, user_index, item_index, cursor=cursor,
    )
    evicted = []
    with _PACK_CACHE_LOCK:
        displaced = _PACK_CACHE.pop(key, None)
        if displaced is not None:
            evicted.append(displaced)
        _PACK_CACHE[key] = entry
        while len(_PACK_CACHE) > PACK_CACHE_MAX_ENTRIES:
            evicted.append(_PACK_CACHE.popitem(last=False)[1])
    for old in evicted:
        _release_resident(old)
    return entry


# --- device-resident pack ---
#
# After a full round uploads the wire, its planes, offsets, geometry and
# the trained factors stay on the card under a ResidentPack. The next delta
# round resolves ids and checks the geometry on the host (delta-sized and
# catalog-sized work) and runs K8 on the resident arrays: nothing
# store-sized crosses the link. The arm is an optimisation of the host
# fold, never a semantic fork: whatever it cannot scatter demotes the pack
# (the byte-identical host wire restored from the card) and the host fold
# runs. Packs are released on fallback, on eviction, on
# ``pack_cache_clear`` and by ``release_resident_packs``.

_RESIDENT_ENABLED = False


def resident_training_enabled() -> bool:
    return _RESIDENT_ENABLED


def set_resident_training(enabled: bool) -> bool:
    """Toggle the device-resident arm (default off: a batch train gains
    nothing from parking state on the card; a continuous loop turns it on
    for its lifetime). Returns the previous setting."""
    global _RESIDENT_ENABLED
    with _PACK_CACHE_LOCK:
        prev = _RESIDENT_ENABLED
        _RESIDENT_ENABLED = bool(enabled)
    return prev


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class ResidentPack:
    """The device-resident arm of one ``_PackEntry``: the wire's planes,
    offsets and segment geometry, both sides' K1 group plans, and the
    trained factor state, all on ``device``. The entry's ``wire`` is its
    stripped shell while a pack is live; ``_reconstruct_wire`` restores the
    byte-identical host wire from these tensors."""

    # wire planes, user-sorted, plane_len long: item ids (uint16|int32) and
    # value codes (int8 unpacked from nibbles, or float32)
    i_plane: object
    v_plane: object
    # aux CSR offsets and segment bases (aux_pad'd int32)
    su: object
    bu: object
    si: object
    bi: object
    # flat segment geometry (int32) and the K1 group plans the device pack
    # takes in place of the host geometry
    seg_rows_u: object
    rem_u: object
    seg_rows_i: object
    rem_i: object
    plan_u: object
    plan_i: object
    # padded factor slots (the loop's final X/Y, handed back every round)
    # and the regularizer / has-observation vectors
    X: object
    Y: object
    user_lam: object
    item_lam: object
    user_obs: object
    item_obs: object
    # host-side metadata
    device: torch.device  # the device the tensors live on
    plane_len: int  # bucketed COO length of the planes
    n: int  # real (unpadded) observation count
    v_lo: int  # min/max of the real int8 value codes (nibble recompute)
    v_hi: int
    config_key: tuple  # _als.config_train_key of the factor state
    valid: bool = True

    _ARRAY_FIELDS = (
        "i_plane", "v_plane", "su", "bu", "si", "bi",
        "seg_rows_u", "rem_u", "seg_rows_i", "rem_i",
        "X", "Y", "user_lam", "item_lam", "user_obs", "item_obs",
    )

    def device_arrays(self) -> list:
        arrays = [getattr(self, f) for f in self._ARRAY_FIELDS]
        for plan in (self.plan_u, self.plan_i):
            if plan is not None:
                arrays += [plan.groups, plan.combine_rows, plan.combine_start]
        return [a for a in arrays if a is not None]

    def device_bytes(self) -> int:
        return sum(_nbytes(a) for a in self.device_arrays())

    def release(self) -> None:
        """Drop every device reference (idempotent); the memory frees once
        training's own references go."""
        self.valid = False
        for f in self._ARRAY_FIELDS + ("plan_u", "plan_i"):
            setattr(self, f, None)


def _release_resident(entry: _PackEntry) -> None:
    """Release an entry's pack WITHOUT restoring the host wire: only for
    entries being discarded (eviction, cache clear)."""
    pack = entry.resident
    if pack is None:
        return
    entry.resident = None
    pack.release()


def _reconstruct_wire(entry: _PackEntry) -> "_als.HostWire":
    """The full host wire of a resident entry, rebuilt byte for byte from
    the card's planes (exact integer images of the host planes) and the
    retained geometry."""
    meta = entry.wire
    if not meta.stripped:
        return meta
    pack = entry.resident
    i_host = pack.i_plane.cpu().numpy()
    v_host = pack.v_plane.cpu().numpy()
    vw = _als._pack_nibbles_host(v_host) if meta.nibble else v_host
    aux = {
        "su": _als.aux_pad(meta.geo_u.starts.astype(np.int32)),
        "bu": _als.aux_pad(meta.geo_u.seg_base.astype(np.int32)),
        "si": _als.aux_pad(meta.geo_i.starts.astype(np.int32)),
        "bi": _als.aux_pad(meta.geo_i.seg_base.astype(np.int32)),
    }
    return dataclasses.replace(meta, iw=i_host, vw=vw, aux=aux, stripped=False)


def _demote_resident(entry: _PackEntry) -> None:
    """Fallback to the host: restore the entry's full host wire from the
    card, then release the pack. The entry stays a valid host-fold
    checkpoint."""
    if entry.resident is None:
        return
    restored = _reconstruct_wire(entry)
    with _PACK_CACHE_LOCK:
        entry.wire = restored
    _release_resident(entry)


def release_resident_packs() -> int:
    """Demote every cached entry's resident pack back to its host wire (a
    continuous loop's shutdown), so ``resident_pack_bytes()`` reads 0.
    Returns the number of packs released."""
    with _PACK_CACHE_LOCK:
        entries = list(_PACK_CACHE.values())
    released = 0
    for entry in entries:
        if entry.resident is not None:
            _demote_resident(entry)
            released += 1
    return released


def _resident_usable(pack: Optional[ResidentPack], device: torch.device) -> bool:
    """A pack is reusable only on the device that holds its tensors (the
    ``torch.device``, index included)."""
    if pack is None or not pack.valid or pack.i_plane is None:
        return False
    return pack.device == device


def _resolve_existing(codes, names_arr, index: BiMap):
    """Delta codes (the delta stream's shared code space) as the cached
    side's EXISTING dense ids, or None when any name is unseen: the
    resident scatter cannot grow a side's id space (a new id reshuffles
    the sorted-name relabel)."""
    codes = np.asarray(codes, np.int64)
    if not len(codes):
        return codes
    uniq = np.unique(codes)
    lut = np.zeros(int(uniq[-1]) + 1, np.int64)
    names = np.asarray(names_arr)
    for c in uniq:
        dense = index.get(str(names[int(c)]))
        if dense is None:
            return None
        lut[int(c)] = dense
    return lut[codes]


def _establish_resident(
    entry: _PackEntry, wire, device_wire, factor_state, fs_out, config
) -> Optional[ResidentPack]:
    """Park a just-trained round's device state under a ResidentPack: the
    uploaded planes and offsets, the device packs' geometry and group
    plans (``fs_out["geo"]``) and the loop's final factors stay on the
    card; the entry's host wire is stripped to its metadata shell."""
    X, Y, geo = fs_out.get("X"), fs_out.get("Y"), fs_out.get("geo")
    if X is None or Y is None or geo is None:
        return None
    i_dev, v_dev, aux_dev = device_wire
    if wire.nibble:
        codes = _als._unpack_nibbles_host(wire.vw)
        v_lo, v_hi = int(codes.min()), int(codes.max())
    elif wire.vw.dtype == np.int8:
        v_lo, v_hi = int(wire.vw.min()), int(wire.vw.max())
    else:
        v_lo = v_hi = 0
    sr_u, rem_u, sr_i, rem_i, plan_u, plan_i = geo
    entry.resident = ResidentPack(
        i_plane=i_dev, v_plane=v_dev,
        su=aux_dev["su"], bu=aux_dev["bu"], si=aux_dev["si"], bi=aux_dev["bi"],
        seg_rows_u=sr_u, rem_u=rem_u, seg_rows_i=sr_i, rem_i=rem_i,
        plan_u=plan_u, plan_i=plan_i,
        X=X, Y=Y,
        user_lam=factor_state[2], item_lam=factor_state[3],
        user_obs=factor_state[4], item_obs=factor_state[5],
        device=i_dev.device,
        plane_len=int(i_dev.shape[0]),
        n=int(wire.counts_u.sum()),
        v_lo=v_lo, v_hi=v_hi,
        config_key=_als.config_train_key(config),
    )
    with _PACK_CACHE_LOCK:
        entry.wire = dataclasses.replace(
            wire, iw=wire.iw[:0], vw=wire.vw[:0], aux={}, stripped=True
        )
    return entry.resident


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
    queue; resolve ``stream.names`` and ``stream.cursor`` here too, since
    they are only valid after exhaustion."""
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
        box["cursor"] = getattr(stream, "cursor", None)
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

    Returns ``(wire, user_index, item_index, compile_wait, cursor)`` or
    None for an empty scan (callers fall back to the materialized path, whose
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
    return wire, user_index, item_index, compile_wait, box.get("cursor")


# --- delta fold ---
#
# A retrain whose cost follows the delta: the stream's delta_factory scans
# ONLY the rows after the cached entry's cursor; the cached wire inverts to
# the old user-major COO (als.wire_coo), the delta's ids merge into the old
# sorted-name spaces (a monotone relabel, so the old COO stays user-sorted),
# and one counting-sort scatter re-finishes the wire. Per user the folded
# sequence (old wire order, then the delta in scan order) IS a cold scan's,
# so the wire is byte-identical to a cold rescan of the grown store.


def _names_of(index: BiMap) -> np.ndarray:
    """A BiMap's keys as a sorted object-str array (the cache's BiMaps are
    built from sorted names, so iteration order is sorted order)."""
    out = np.empty(len(index), object)
    out[:] = [str(k) for k in index]
    return out


def _merge_sorted_names(old_names: np.ndarray, add_names: np.ndarray):
    """Merge ``add_names`` (sorted, disjoint from ``old_names``) into the
    sorted ``old_names``. Returns ``(merged, old_to_new)``, the monotone
    relabel of old dense ids."""
    if not len(add_names):
        return old_names, np.arange(len(old_names), dtype=np.int64)
    old_pos = (
        np.arange(len(old_names), dtype=np.int64)
        + np.searchsorted(add_names, old_names)
    )
    new_pos = (
        np.arange(len(add_names), dtype=np.int64)
        + np.searchsorted(old_names, add_names)
    )
    merged = np.empty(len(old_names) + len(add_names), object)
    merged[old_pos] = old_names
    merged[new_pos] = add_names
    return merged, old_pos


def _side_fold_codes(codes: np.ndarray, names_arr, old_names: np.ndarray):
    """Fold one side's delta codes into the cached side's sorted-name
    space, extending it with unseen names (delta-sized work). Returns
    ``(merged_names, old_to_new, dense_codes)``."""
    if not len(codes):
        return (
            old_names,
            np.arange(len(old_names), dtype=np.int64),
            codes.astype(np.int64),
        )
    uniq = np.unique(codes)  # distinct delta codes, ascending
    uniq_names = np.empty(len(uniq), object)
    uniq_names[:] = [str(x) for x in np.asarray(names_arr)[uniq]]
    if len(old_names):
        pos = np.minimum(
            np.searchsorted(old_names, uniq_names), len(old_names) - 1
        )
        is_old = old_names[pos] == uniq_names
    else:
        is_old = np.zeros(len(uniq_names), bool)
    add = np.sort(uniq_names[~is_old])  # distinct by construction
    merged, old_to_new = _merge_sorted_names(old_names, add)
    lut = np.zeros(int(uniq[-1]) + 1, np.int64)
    lut[uniq] = np.searchsorted(merged, uniq_names)
    return merged, old_to_new, lut[np.asarray(codes, np.int64)]


def _scan_delta(dstream, timings: dict) -> Optional[dict]:
    """Consume a delta stream into flat code/value arrays (for the host
    fold and the resident scatter alike). Returns None when the stream
    cannot vouch for its own chain (no cursor): the caller repacks in
    full."""
    t0 = time.perf_counter()
    parts = []
    n_delta = 0
    for e, g, v in dstream:
        parts.append(
            (
                np.asarray(e, np.int64),
                np.asarray(g, np.int64),
                np.asarray(v, np.float32),
            )
        )
        n_delta += len(v)
    new_cursor = dstream.cursor
    if new_cursor is None:
        return None
    timings["delta_scan_s"] = time.perf_counter() - t0
    if parts:
        e_codes = np.concatenate([p[0] for p in parts])
        g_codes = np.concatenate([p[1] for p in parts])
        dv = np.concatenate([p[2] for p in parts])
        names_arr = dstream.names
    else:
        e_codes = g_codes = np.empty(0, np.int64)
        dv = np.empty(0, np.float32)
        names_arr = None
    return {
        "e_codes": e_codes,
        "g_codes": g_codes,
        "dv": dv,
        "names": names_arr,
        "cursor": new_cursor,
        "fingerprint": dstream.fingerprint,
        "n_delta": n_delta,
    }


def _fold_delta(entry: _PackEntry, dstream, config, timings: dict, device):
    """Fold a delta stream into a cached entry: the re-finished wire, the
    merged id indexes, the warm-start seeds and the chained cursor. Returns
    None when the delta stream has no cursor (the caller repacks in full).
    With residency on and a pack on the entry, the delta first goes to the
    resident scatter; whatever it cannot scatter demotes the pack and the
    host fold runs."""
    scanned = _scan_delta(dstream, timings)
    if scanned is None:
        return None
    if _RESIDENT_ENABLED and entry.resident is not None:
        folded = _fold_delta_resident(entry, scanned, config, timings, device)
        if folded is not None:
            return folded
    if entry.resident is not None:
        _demote_resident(entry)
        timings["resident"] = "fallback"
    return _fold_delta_host(entry, scanned, config, timings, device)


def _fold_delta_host(entry: _PackEntry, scanned: dict, config, timings: dict, device):
    """The host fold: invert the cached wire to COO, merge the delta in,
    re-finish. Needs the entry's full host wire (a resident entry is
    demoted first)."""
    n_delta = scanned["n_delta"]
    t0 = time.perf_counter()
    old_u_names = _names_of(entry.user_index)
    old_i_names = _names_of(entry.item_index)
    names_arr = scanned["names"]
    u_names, u_old2new, du = _side_fold_codes(scanned["e_codes"], names_arr, old_u_names)
    i_names, i_old2new, di = _side_fold_codes(scanned["g_codes"], names_arr, old_i_names)
    dv = scanned["dv"]
    n_users, n_items = len(u_names), len(i_names)

    old_wire = entry.wire
    counts_u = np.zeros(n_users, np.int64)
    counts_u[u_old2new] = old_wire.counts_u
    counts_u += np.bincount(du, minlength=n_users)
    counts_i = np.zeros(n_items, np.int64)
    counts_i[i_old2new] = old_wire.counts_i
    counts_i += np.bincount(di, minlength=n_items)
    counts_u32 = counts_u.astype(np.int32)
    counts_i32 = counts_i.astype(np.int32)

    L_u = _als.auto_segment_length(None, n_users, config.segment_length, counts=counts_u32)
    L_i = _als.auto_segment_length(None, n_items, config.segment_length, counts=counts_i32)
    geo_u = _als._segment_geometry(counts_u32, n_users, L_u, 1, config.chunk_slots)
    geo_i = _als._segment_geometry(counts_i32, n_items, L_i, 1, config.chunk_slots)
    # geometry known: the kernels' build starts NOW, under the merge
    compile_wait = _als.start_compile_async(device, config)

    # the old COO straight off the cached wire (user-major, each user's
    # original order: the cold scan's prefix), relabelled by the monotone
    # old->merged map so it stays user-sorted; the delta gets its own
    # stable presort, keeping scan order within each user
    ou, oi, ov = _als.wire_coo(old_wire)
    ou = u_old2new[ou].astype(np.int64)
    oi = i_old2new[oi]
    order = np.argsort(du, kind="stable")
    n = len(ov) + n_delta
    iw, vw = _scatter_merge(
        [(ou, oi, ov), (du[order], di[order], dv[order])],
        n, n_users, n_items, geo_u,
    )
    wire = _als.finish_wire(
        iw, vw, n_users, n_items, L_u, L_i, geo_u, geo_i, counts_u32, counts_i32,
    )
    user_index = BiMap({str(nm): j for j, nm in enumerate(u_names)})
    item_index = BiMap({str(nm): j for j, nm in enumerate(i_names)})

    warm = None
    k = config.rank
    if (
        entry.arrays is not None
        and entry.arrays.user_factors.shape == (old_wire.n_users, k)
        and entry.arrays.item_factors.shape == (old_wire.n_items, k)
    ):
        # old rows carry over; a new user starts at zero (its first
        # half-step solves it from the items), a new item gets the cold
        # init row a fresh train would give it
        X0 = np.zeros((n_users, k), np.float32)
        X0[u_old2new] = entry.arrays.user_factors
        Y0 = np.ascontiguousarray(
            _als._factor_init_host(n_users, n_items, config, 1)[1][:n_items]
        )
        Y0[i_old2new] = entry.arrays.item_factors
        warm = _als.ALSModelArrays(user_factors=X0, item_factors=Y0)

    timings["fold_exposed_s"] = time.perf_counter() - t0
    return {
        "wire": wire,
        "user_index": user_index,
        "item_index": item_index,
        "compile_wait": compile_wait,
        "cursor": scanned["cursor"],
        "fingerprint": scanned["fingerprint"],
        "warm": warm,
        "delta_events": n_delta,
    }


def _fold_delta_resident(
    entry: _PackEntry, scanned: dict, config, timings: dict, device
) -> Optional[dict]:
    """The resident scatter arm of the delta fold. The host resolves ids,
    sorts the delta, checks the geometry and computes the touched rows'
    regularizers (delta- and catalog-sized work); K8 does the device work;
    the uploads are the delta rows and the touched regularizer entries.
    Returns None whenever the scatter could not give a cold rescan's wire
    byte for byte, and the caller demotes the pack and folds on the host:
    an unseen id, a value off the pack's int8 half-step tier, a changed
    auto segment length, a changed segment grid (seg_rows, n_chunks, sc or
    total), an id-plane dtype flip, a different ``config_train_key`` (the
    parked factors were trained under other semantics) or another device.
    A K8 build or launch error raises; it never turns into a host fold."""
    pack = entry.resident
    if not _resident_usable(pack, device) or pack.X is None or pack.Y is None:
        return None
    if pack.config_key != _als.config_train_key(config):
        return None
    old = entry.wire
    names_arr = scanned["names"]
    du = _resolve_existing(scanned["e_codes"], names_arr, entry.user_index)
    if du is None:
        return None
    di = _resolve_existing(scanned["g_codes"], names_arr, entry.item_index)
    if di is None:
        return None
    t0 = time.perf_counter()
    d = int(scanned["n_delta"])
    dv = scanned["dv"]
    n_users, n_items = old.n_users, old.n_items

    # the merged plane must stay on the pack's value tier, or a cold
    # wire's value dtype would differ
    if old.v_scale == 0.5:
        doubled = dv * 2.0
        codes = np.rint(doubled)
        if d and (
            np.abs(doubled - codes).max() != 0.0
            or np.abs(codes).max() > 127
        ):
            return None
        d_codes = codes.astype(np.int8)
    else:
        d_codes = dv.astype(np.float32)

    counts_u32 = (old.counts_u.astype(np.int64) + np.bincount(du, minlength=n_users)).astype(np.int32)
    counts_i32 = (old.counts_i.astype(np.int64) + np.bincount(di, minlength=n_items)).astype(np.int32)
    n_new = pack.n + d
    L_u = _als.auto_segment_length(None, n_users, config.segment_length, counts=counts_u32)
    L_i = _als.auto_segment_length(None, n_items, config.segment_length, counts=counts_i32)
    if L_u != old.L_u or L_i != old.L_i:
        return None
    geo_u = _als._segment_geometry(counts_u32, n_users, L_u, 1, config.chunk_slots)
    geo_i = _als._segment_geometry(counts_i32, n_items, L_i, 1, config.chunk_slots)
    for g2, g1 in ((geo_u, old.geo_u), (geo_i, old.geo_i)):
        if (
            g2.n_chunks != g1.n_chunks
            or g2.sc != g1.sc
            or g2.total != g1.total
            or not np.array_equal(g2.seg_rows, g1.seg_rows)
        ):
            return None
    P_new = _als._bucket_count(n_new)
    i_dtype = old.iw.dtype  # a stripped wire keeps its planes' dtypes
    top_id = n_items if P_new > n_new else n_items - 1
    if np.dtype(np.uint16 if top_id < 65536 else np.int32) != i_dtype:
        return None
    if d_codes.dtype == np.int8:
        v_lo = min(pack.v_lo, int(d_codes.min()) if d else pack.v_lo)
        v_hi = max(pack.v_hi, int(d_codes.max()) if d else pack.v_hi)
        nibble = P_new % 2 == 0 and v_lo >= 0 and v_hi <= 15
    else:
        v_lo = v_hi = 0
        nibble = False

    compile_wait = _als.start_compile_async(device, config)

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(pack.device)

    upload = 0
    new = {
        "i_plane": pack.i_plane, "v_plane": pack.v_plane, "su": pack.su,
        "si": pack.si, "rem_u": pack.rem_u, "rem_i": pack.rem_i,
        "user_lam": pack.user_lam, "item_lam": pack.item_lam,
    }
    if d:
        order = np.argsort(du, kind="stable")
        du_s = du[order].astype(np.int32)
        di_s = di[order].astype(i_dtype)
        dc_s = d_codes[order]
        upload += du_s.nbytes + di_s.nbytes + dc_s.nbytes
        lam = None
        if config.reg_mode == "weighted":
            # weighted regularization follows the counts: the touched rows
            # get the host's values (bit-equal to a cold _lam_obs_host);
            # has-observation never changes (touched rows had ratings)
            lam_u_full, _ = _als._lam_obs_host(counts_u32, n_users, pack.user_lam.shape[0], config)
            lam_i_full, _ = _als._lam_obs_host(counts_i32, n_items, pack.item_lam.shape[0], config)
            uniq_u = np.unique(du_s).astype(np.int32)
            uniq_i = np.unique(di_s.astype(np.int64)).astype(np.int32)
            vals_u, vals_i = lam_u_full[uniq_u], lam_i_full[uniq_i]
            lam = {
                "lam_u": pack.user_lam, "rows_u": up(uniq_u), "vals_u": up(vals_u),
                "lam_i": pack.item_lam, "rows_i": up(uniq_i), "vals_i": up(vals_i),
            }
            upload += uniq_u.nbytes + vals_u.nbytes + uniq_i.nbytes + vals_i.nbytes
        planes = {
            "i_plane": pack.i_plane, "v_plane": pack.v_plane, "su": pack.su,
            "si": pack.si, "bu": pack.bu, "bi": pack.bi,
            "seg_rows_u": pack.seg_rows_u, "rem_u": pack.rem_u,
            "seg_rows_i": pack.seg_rows_i, "rem_i": pack.rem_i,
        }
        init_id = n_items if P_new > n_new else 0
        new.update(_k8.apply_delta(
            planes, up(du_s), up(di_s), up(dc_s), n_users, n_items, P_new, init_id, lam,
        ))

    new_meta = dataclasses.replace(
        old,
        geo_u=geo_u, geo_i=geo_i,
        counts_u=counts_u32, counts_i=counts_i32,
        iw=np.empty(0, i_dtype),
        vw=np.empty(0, np.uint8 if nibble else d_codes.dtype),
        nibble=nibble, aux={}, stripped=True,
    )
    pack.i_plane, pack.v_plane = new["i_plane"], new["v_plane"]
    pack.su, pack.si = new["su"], new["si"]
    pack.rem_u, pack.rem_i = new["rem_u"], new["rem_i"]
    pack.user_lam, pack.item_lam = new["user_lam"], new["item_lam"]
    pack.plane_len = P_new
    pack.n = n_new
    pack.v_lo, pack.v_hi = v_lo, v_hi
    with _PACK_CACHE_LOCK:
        entry.wire = new_meta
        entry.fingerprint = scanned["fingerprint"]
        entry.cursor = scanned["cursor"]

    timings["fold_exposed_s"] = time.perf_counter() - t0
    timings["resident"] = "scatter"
    timings["delta_upload_bytes"] = int(upload)
    return {
        "wire": new_meta,
        "user_index": entry.user_index,
        "item_index": entry.item_index,
        "compile_wait": compile_wait,
        "cursor": scanned["cursor"],
        "fingerprint": scanned["fingerprint"],
        "warm": None,
        "delta_events": d,
        "resident_pack": pack,
        "device_wire": (
            pack.i_plane, pack.v_plane,
            {"su": pack.su, "bu": pack.bu, "si": pack.si, "bi": pack.bi},
        ),
        "geo_dev": (
            pack.seg_rows_u, pack.rem_u, pack.seg_rows_i, pack.rem_i,
            pack.plan_u, pack.plan_i,
        ),
        # the loop updates the subspace solver's factors in place: it gets
        # copies (on the card), and the pack keeps its own until the
        # round hands back the final ones
        "factor_state": (
            pack.X.clone(), pack.Y.clone(), pack.user_lam, pack.item_lam,
            pack.user_obs, pack.item_obs,
        ),
    }


# --- the pipeline entry ---


@dataclasses.dataclass
class StreamTrainResult:
    arrays: "_als.ALSModelArrays"
    user_index: BiMap
    item_index: BiMap
    timings: dict


def _attribute_phases(timer, timings: dict) -> None:
    """Record the pipeline's sub-phases on a phase timer (any object with
    ``add(name, seconds, overlapped=...)`` and ``note(key, value)``),
    marking those that ran under another phase as overlapped."""
    add = getattr(timer, "add", None)
    if add is None:
        return
    for name, key, overlapped in (
        ("stream:scan", "scan_s", True),
        ("stream:fold", "fold_s", True),
        ("stream:delta-scan", "delta_scan_s", False),
        ("stream:delta-fold", "fold_exposed_s", False),
        ("stream:pack-exposed", "pack_exposed_s", False),
        ("stream:device-put-exposed", "device_put_exposed_s", False),
        ("stream:compile", "compile_s", True),
        ("stream:compile-exposed", "compile_exposed_s", False),
        ("stream:device-loop", "device_loop_s", False),
    ):
        if timings.get(key):
            add(name, timings[key], overlapped=overlapped)
    note = getattr(timer, "note", None)
    if note is None:
        return
    # this round's cache outcome, the lifetime counters and the delta size
    if timings.get("pack_cache"):
        note("pack_cache", timings["pack_cache"])
    stats = pack_cache_stats()
    note(
        "pack_cache_stats",
        f"hit={stats['hit']} miss={stats['miss']} fold={stats['fold']}",
    )
    if "delta_events" in timings:
        note("delta_events", timings["delta_events"])
    if timings.get("resident"):
        note("resident", timings["resident"])
    # the loop's convergence headline: the sweep count and the final
    # factor-delta RMS (and the objective in implicit mode)
    tel = timings.get("sweep_telemetry")
    if tel:
        note("sweeps", len(tel))
        note(
            "final_factor_delta",
            f"user={tel[-1]['dx']:.2e} item={tel[-1]['dy']:.2e}",
        )
        if "objective" in tel[-1]:
            note("objective", f"{tel[-1]['objective']:.6g}")


def train_als_streaming(
    stream,
    config: "_als.ALSConfig",
    *,
    device: DeviceLike = None,
    timings: Optional[dict] = None,
    timer=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 5,
    profile_dir: Optional[str] = None,
    ship_chunks: int = 2,
    cache: bool = True,
    delta: bool = True,
    warm_sweeps: int = 2,
) -> Optional[StreamTrainResult]:
    """Train ALS from a ``ColumnarStream`` on ``device`` (CUDA unless the
    CPU is asked for) through the overlapped pipeline (module docstring).
    Returns None when ``stream`` is None or the scan is empty: callers
    fall back to the materialized ``train_als`` and its error reporting.

    With ``cache`` and ``delta`` on, a store that grew since the cached
    round folds only its new rows into the cached wire and trains warm from
    the previous factors for ``warm_sweeps`` sweeps (0 keeps
    ``config.iterations``); with residency on, the fold may run on the card
    (K8). A stream whose delta path cannot vouch for its chain repacks in
    full.

    ``timings`` gains the pipeline's phase split: ``scan_s``/``fold_s``/
    ``compile_s`` (busy, overlapped), ``pack_exposed_s``/
    ``device_put_exposed_s``/``compile_exposed_s`` (critical-path wall),
    ``pack_cache`` ("hit", "miss", "fold", or "off" with ``cache=False``),
    ``delta_events``/``delta_scan_s``/``fold_exposed_s``/``warm_sweeps`` on
    fold rounds, ``resident`` ("cold", "scatter" or "fallback", with
    residency on), ``delta_upload_bytes`` (host→device bytes of the round),
    and the training tail's ``wire_mb``/``device_pack_dispatch_s``/
    ``device_loop_s``/``padded_slots``/``sweep_telemetry``. The port's
    uploads block the host, so ``device_put_exposed_s`` spans the whole
    upload (K4 included) and the factor-state placement. ``timer`` receives
    the phases (``_attribute_phases``)."""
    if profile_dir is not None:
        raise NotImplementedError(
            "the device profile capture is not ported yet (ROADMAP.md queue 1 "
            "item 10)"
        )
    if stream is None:
        return None
    _als._check_ported(config)
    dev = resolve_device(device)
    timings = {} if timings is None else timings
    t_start = time.perf_counter()

    warm_arrays = None
    train_config = config
    cache_entry: Optional[_PackEntry] = None
    resident_round = False  # the wire's planes are already on the card
    resident_pack: Optional[ResidentPack] = None
    resident_geo = None
    resident_wire_dev = None
    pre_factor_state = None  # scatter rounds: the resident factors
    demoted = False  # a resident pack fell back to the host this round
    entry = _cache_get(stream, config) if cache else None
    if entry is not None:
        _stat_bump("hit")
        timings["pack_cache"] = "hit"
        timings["scan_s"] = timings["fold_s"] = 0.0
        timings["pack_exposed_s"] = 0.0
        cache_entry = entry
        if entry.resident is not None:
            if _RESIDENT_ENABLED and _resident_usable(entry.resident, dev):
                # zero-upload hit: planes and geometry stay on the card;
                # the factor state is built fresh below, so the result is
                # the plain hit's, bit for bit
                resident_round = True
                resident_pack = entry.resident
            else:
                _demote_resident(entry)
                demoted = True
        wire = entry.wire
        user_index, item_index = entry.user_index, entry.item_index
        compile_wait = _als.start_compile_async(dev, config)
    else:
        folded = None
        prior = (
            _cache_lookup(stream, config, any_fingerprint=True) if cache else None
        )
        if delta and prior is not None and prior.cursor is not None:
            dfactory = getattr(stream, "delta_factory", None)
            if dfactory is not None:
                dstream = dfactory(prior.cursor)
                if dstream is not None:
                    folded = _fold_delta(prior, dstream, config, timings, dev)
        if timings.get("resident") == "fallback":
            demoted = True
        if folded is not None:
            _stat_bump("fold")
            timings["pack_cache"] = "fold"
            timings["delta_events"] = folded["delta_events"]
            timings["scan_s"] = timings["fold_s"] = 0.0
            timings["pack_exposed_s"] = 0.0
            wire = folded["wire"]
            user_index = folded["user_index"]
            item_index = folded["item_index"]
            compile_wait = folded["compile_wait"]
            warm_arrays = folded["warm"]
            if "resident_pack" in folded:
                # K8 already updated the resident pack and the entry in
                # place: no _cache_put, which would displace the entry and
                # release the pack this round trains from
                resident_round = True
                resident_pack = folded["resident_pack"]
                resident_wire_dev = folded["device_wire"]
                resident_geo = folded["geo_dev"]
                pre_factor_state = folded["factor_state"]
                cache_entry = prior
            else:
                cache_entry = _cache_put(
                    stream, config, wire, user_index, item_index,
                    fingerprint=folded["fingerprint"],
                    cursor=folded["cursor"],
                )
            if (
                (warm_arrays is not None or pre_factor_state is not None)
                and 0 < warm_sweeps < config.iterations
            ):
                # warm factors recover full quality in a few sweeps after
                # a small delta
                train_config = dataclasses.replace(config, iterations=warm_sweeps)
                timings["warm_sweeps"] = warm_sweeps
        else:
            if prior is not None and prior.resident is not None:
                # the full repack replaces the entry: restore the host wire
                # and release the pack, even if the rescan comes up empty
                _demote_resident(prior)
                demoted = True
            _stat_bump("miss" if cache else "off")
            timings["pack_cache"] = "miss" if cache else "off"
            packed = _scan_and_pack(stream, config, timings, dev)
            if packed is None:
                return None
            wire, user_index, item_index, compile_wait, cursor = packed
            if cache:
                cache_entry = _cache_put(
                    stream, config, wire, user_index, item_index, cursor=cursor,
                )

    fs_out: Optional[dict] = (
        {} if (_RESIDENT_ENABLED and cache_entry is not None and not demoted) else None
    )
    if resident_round:
        # nothing store-sized crosses the link: planes, offsets and
        # geometry are already on the card
        pack = resident_pack
        if pre_factor_state is not None:
            device_wire = resident_wire_dev
            factor_state = pre_factor_state
        else:
            device_wire = (
                pack.i_plane, pack.v_plane,
                {"su": pack.su, "bu": pack.bu, "si": pack.si, "bi": pack.bi},
            )
            resident_geo = (
                pack.seg_rows_u, pack.rem_u, pack.seg_rows_i, pack.rem_i,
                pack.plan_u, pack.plan_i,
            )
            factor_state = _als.init_factor_state_single(
                wire.counts_u, wire.counts_i, wire.n_users, wire.n_items,
                train_config, device=dev,
            )
            timings["delta_upload_bytes"] = int(
                _nbytes(factor_state[1]) + sum(_nbytes(a) for a in factor_state[2:])
            )
        timings["device_put_exposed_s"] = 0.0
    else:
        t0 = time.perf_counter()
        device_wire = _als.upload_wire(wire, dev, n_chunks=ship_chunks)
        factor_state = _als.init_factor_state_single(
            wire.counts_u, wire.counts_i, wire.n_users, wire.n_items, train_config,
            warm=(
                None if warm_arrays is None
                else (warm_arrays.user_factors, warm_arrays.item_factors)
            ),
            device=dev,
        )
        _als._sync(dev)
        timings["device_put_exposed_s"] = time.perf_counter() - t0
        timings["delta_upload_bytes"] = int(
            wire.iw.nbytes + wire.vw.nbytes
            + sum(int(a.nbytes) for a in wire.aux.values())
            + _nbytes(factor_state[1])
            + (_nbytes(factor_state[0]) if warm_arrays is not None else 0)
            + sum(_nbytes(a) for a in factor_state[2:])
        )

    try:
        arrays = _als.train_from_wire(
            wire, train_config,
            device_wire=device_wire,
            timings=timings,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            compile_wait=compile_wait,
            factor_state=factor_state,
            geo_dev=resident_geo,
            factor_slots_out=fs_out,
            _fp_material=(
                (lambda: repr((cache_entry.fingerprint, cache_entry.cursor)).encode())
                if resident_round else None
            ),
        )
    except BaseException:
        if resident_round and cache_entry is not None:
            # a failed round strands no pack: restore the host wire from
            # the card's planes and release it, and drop the factors
            if resident_pack is not None:
                resident_pack.X = resident_pack.Y = None
            if cache_entry.resident is not None:
                _demote_resident(cache_entry)
            with _PACK_CACHE_LOCK:
                cache_entry.arrays = None
        raise
    if cache_entry is not None:
        # the trained factors ride the entry, so the next delta round can
        # warm-start (the entry may already be evicted: harmless)
        with _PACK_CACHE_LOCK:
            cache_entry.arrays = arrays
    if fs_out is not None and cache_entry is not None:
        if resident_round and resident_pack is not None and resident_pack.valid:
            if fs_out.get("X") is None or fs_out.get("Y") is None:
                # without the final slots the pack has no factors for the
                # next scatter: demote instead
                resident_pack.X = resident_pack.Y = None
                _demote_resident(cache_entry)
            else:
                # the loop's final X/Y go back into the pack; the
                # regularizers follow, so the next scatter reuses them
                resident_pack.X = fs_out["X"]
                resident_pack.Y = fs_out["Y"]
                resident_pack.user_lam = factor_state[2]
                resident_pack.item_lam = factor_state[3]
                resident_pack.user_obs = factor_state[4]
                resident_pack.item_obs = factor_state[5]
                resident_pack.config_key = _als.config_train_key(config)
        elif (
            not resident_round
            and cache_entry.resident is None
            and not wire.stripped
        ):
            _establish_resident(
                cache_entry, wire, device_wire, factor_state, fs_out, config,
            )
    if _RESIDENT_ENABLED:
        outcome = timings.get("resident") or (
            "scatter" if resident_round else ("fallback" if demoted else "cold")
        )
        timings["resident"] = outcome
        with _PACK_CACHE_LOCK:
            _RESIDENT_ROUNDS[outcome] += 1
    timings["stream_wall_s"] = time.perf_counter() - t_start
    if timer is not None:
        _attribute_phases(timer, timings)
    return StreamTrainResult(
        arrays=arrays, user_index=user_index, item_index=item_index,
        timings=timings,
    )
