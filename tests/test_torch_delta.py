"""The pack-artifact cache and the host delta fold of the streaming trainer
(``ops/streaming.py``) on the CPU, against the JAX package's
``train_als_streaming`` on equal in-memory stores: ``MemStore`` streams
its events as both packages' ``ColumnarStream``s with one cache identity
(its fingerprint and cursor are the events covered) and a
``delta_factory`` that streams the events after a cursor.

Tolerances, stated beforehand:
- wires and id indexes: byte for byte (integer and copy work);
- port against JAX factors: within 1e-4 of the largest factor entry, the
  tolerance of ``test_torch_streaming.py`` (both float32, summed in
  different orders);
- the port against itself (a hit against the round it hit, the engine
  against ``train_als_streaming``): bit for bit.
Every test clears both packages' caches and restores the residency
setting.
"""

import dataclasses

import numpy as np
import pytest

from predictionio_tpu.data.storage.columnar import ColumnarStream as JaxColumnarStream
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops import streaming as jax_streaming
from predictionio_tpu_torch.data.storage.columnar import ColumnarStream
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.models.recommendation.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    Preparator,
    StreamingTrainingData,
)
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import streaming as port_streaming

CFG = dict(rank=8, iterations=4, reg=0.05, seed=3, segment_length=16, chunk_slots=1024)
N_USERS, N_ITEMS, NNZ = 300, 150, 6000
BATCH = 700


class MemStore:
    """Events (user name, item name, rating) in one shared code space,
    codes given in first-appearance order; read through ``stream(cls)``."""

    def __init__(self, key=("app",)):
        self.key = key
        self.e, self.t, self.r = [], [], []
        self.names, self.code = [], {}
        self.delta_ok = True  # False: delta streams cannot vouch for their chain

    def _code(self, name):
        if name not in self.code:
            self.code[name] = len(self.names)
            self.names.append(name)
        return self.code[name]

    def add(self, users, items, ratings):
        for u, i, r in zip(users, items, ratings):
            self.e.append(self._code(f"u{u}"))
            self.t.append(self._code(f"i{i}"))
            self.r.append(float(r))
        return self

    def _stream(self, cls, lo, scope):
        hi = len(self.r)
        e = np.array(self.e[lo:hi], np.int32)
        t = np.array(self.t[lo:hi], np.int32)
        r = np.array(self.r[lo:hi], np.float32)
        names = np.array(self.names, object)
        batches = [(e[a:a + BATCH], t[a:a + BATCH], r[a:a + BATCH]) for a in range(0, hi - lo, BATCH)]
        cursor = (lambda: hi) if (lo == 0 or self.delta_ok) else None
        s = cls(iter(batches), lambda: names, fingerprint=(hi,), cache_key=self.key,
                cache_scope=self if scope is None else scope, cursor_fn=cursor)
        s.delta_factory = lambda cur: self._stream(cls, cur, scope)
        return s

    def stream(self, cls, scope=None):
        return self._stream(cls, 0, scope)

    def counts(self):
        """Per-name event counts of both sides."""
        cu, ci = {}, {}
        for e, t in zip(self.e, self.t):
            cu[self.names[e]] = cu.get(self.names[e], 0) + 1
            ci[self.names[t]] = ci.get(self.names[t], 0) + 1
        return cu, ci


def seeded_store(key=("app",), nnz=NNZ, seed=0):
    rng = np.random.default_rng(seed)
    return MemStore(key).add(
        rng.integers(0, N_USERS, nnz), rng.integers(0, N_ITEMS, nnz),
        rng.integers(1, 11, nnz) / 2,
    )


def random_delta(store, n, seed, n_users=N_USERS, n_items=N_ITEMS):
    rng = np.random.default_rng(seed)
    store.add(rng.integers(0, n_users, n), rng.integers(0, n_items, n), rng.integers(1, 11, n) / 2)


def scatterable_delta(store, n, L_u, L_i, ratings=None):
    """n events on EXISTING ids whose counts stay clear of a segment
    boundary (``count % L == 0``), as ``bench.py:2280`` builds them."""
    cu, ci = store.counts()
    users, items = sorted(cu), sorted(ci)
    us, its, ui, ii = [], [], 0, 0
    for _ in range(n):
        while cu[users[ui % len(users)]] % L_u == 0:
            ui += 1
        while ci[items[ii % len(items)]] % L_i == 0:
            ii += 1
        u, i = users[ui % len(users)], items[ii % len(items)]
        cu[u] += 1
        ci[i] += 1
        ui += 1
        ii += 1
        us.append(int(u[1:]))
        its.append(int(i[1:]))
    if ratings is None:
        ratings = [((j % 10) + 1) / 2 for j in range(n)]
    store.add(us, its, ratings)


def wire_bytes(w):
    return (
        w.n_users, w.n_items, w.L_u, w.L_i, w.nibble, w.v_scale, w.iw.dtype.str,
        w.iw.tobytes(), w.vw.dtype.str, w.vw.tobytes(),
        tuple((k, a.tobytes()) for k, a in sorted(w.aux.items())),
        w.counts_u.tobytes(), w.counts_i.tobytes(),
    )


def only_entry(module):
    [entry] = list(module._PACK_CACHE.values())
    return entry


def cold_wire(store, config):
    return port_streaming._scan_and_pack(store.stream(ColumnarStream), config, {}, "cpu")[0]


def train_both(store, cfg=None, **kw):
    """One round on each package: (jax result, jax timings, port result,
    port timings)."""
    cfg = dict(CFG, **(cfg or {}))
    t_jax, t_port = {}, {}
    ref = jax_streaming.train_als_streaming(
        store.stream(JaxColumnarStream), jax_als.ALSConfig(**cfg), timings=t_jax, **kw)
    got = port_streaming.train_als_streaming(
        store.stream(ColumnarStream), port_als.ALSConfig(**cfg), device="cpu", timings=t_port, **kw)
    return ref, t_jax, got, t_port


def close(a, b, rel=1e-4):
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())


def assert_matches(ref, got):
    assert got.user_index.to_dict() == ref.user_index.to_dict()
    assert got.item_index.to_dict() == ref.item_index.to_dict()
    close(got.arrays.user_factors, ref.arrays.user_factors)
    close(got.arrays.item_factors, ref.arrays.item_factors)


def same_bits(a, b):
    return np.array_equal(a.user_factors, b.user_factors) and np.array_equal(
        a.item_factors, b.item_factors)


@pytest.fixture(autouse=True)
def fresh_caches():
    port_streaming.pack_cache_clear()
    jax_streaming.pack_cache_clear()
    prev_port = port_streaming.set_resident_training(False)
    prev_jax = jax_streaming.set_resident_training(False)
    yield
    port_streaming.set_resident_training(prev_port)
    jax_streaming.set_resident_training(prev_jax)
    port_streaming.pack_cache_clear()
    jax_streaming.pack_cache_clear()


def test_scan_and_pack_returns_the_scan_cursor():
    store = seeded_store()
    *_, cursor = port_streaming._scan_and_pack(
        store.stream(ColumnarStream), port_als.ALSConfig(**CFG), {}, "cpu")
    *_, ref_cursor = jax_streaming._scan_and_pack(
        store.stream(JaxColumnarStream), jax_als.ALSConfig(**CFG), {}, 2)
    assert cursor == ref_cursor == NNZ


@pytest.mark.parametrize("warm_sweeps", [2, 0])
def test_chained_fold_rounds_match_jax_and_a_cold_rescan(warm_sweeps):
    """Four fold rounds, new ids and existing ids mixed: each wire equals
    JAX's and a cold rescan's byte for byte; the factors, trained warm for
    ``warm_sweeps`` sweeps (0: all of ``iterations``), match JAX's."""
    store = seeded_store()
    ref, t_jax, got, t_port = train_both(store, warm_sweeps=warm_sweeps)
    assert t_port["pack_cache"] == t_jax["pack_cache"] == "miss"
    assert_matches(ref, got)
    config = port_als.ALSConfig(**CFG)
    for rnd, (n, nu, ni) in enumerate([(150, 330, 150), (90, N_USERS, 170), (200, 360, 180), (40, 10, 10)]):
        random_delta(store, n, seed=10 + rnd, n_users=nu, n_items=ni)
        ref, t_jax, got, t_port = train_both(store, warm_sweeps=warm_sweeps)
        assert t_port["pack_cache"] == t_jax["pack_cache"] == "fold"
        assert t_port["delta_events"] == t_jax["delta_events"] == n
        sweeps = warm_sweeps if warm_sweeps else CFG["iterations"]
        assert len(t_port["sweep_telemetry"]) == len(t_jax["sweep_telemetry"]) == sweeps
        assert t_port.get("warm_sweeps") == t_jax.get("warm_sweeps")
        assert_matches(ref, got)
        wire = only_entry(port_streaming).wire
        assert wire_bytes(wire) == wire_bytes(only_entry(jax_streaming).wire)
        assert wire_bytes(wire) == wire_bytes(cold_wire(store, config))
        for key in ("delta_scan_s", "fold_exposed_s", "device_put_exposed_s", "device_loop_s"):
            assert t_port[key] >= 0, key
        assert t_port["delta_upload_bytes"] == t_jax["delta_upload_bytes"]


def test_warm_start_seeds_old_rows_and_new_items_like_jax():
    """A fold with new users and items: old rows carry over, a new item gets
    the cold init row and a new user zeros, as JAX's fold seeds them."""
    store = seeded_store()
    train_both(store)
    random_delta(store, 120, seed=5, n_users=340, n_items=170)
    config = port_als.ALSConfig(**CFG)
    entry = only_entry(port_streaming)
    ref_entry = only_entry(jax_streaming)
    dstream = store._stream(ColumnarStream, entry.cursor, None)
    ref_dstream = store._stream(JaxColumnarStream, ref_entry.cursor, None)
    folded = port_streaming._fold_delta(entry, dstream, config, {}, resolve_device("cpu"))
    ref = jax_streaming._fold_delta(ref_entry, ref_dstream, jax_als.ALSConfig(**CFG), {})
    assert wire_bytes(folded["wire"]) == wire_bytes(ref["wire"])
    close(folded["warm"].user_factors, ref["warm"].user_factors)
    close(folded["warm"].item_factors, ref["warm"].item_factors)
    new_users = [j for n, j in folded["user_index"].to_dict().items() if n not in entry.user_index]
    assert new_users and not folded["warm"].user_factors[new_users].any()
    init = port_als._factor_init_host(len(folded["user_index"]), len(folded["item_index"]), config, 1)[1]
    new_items = [j for n, j in folded["item_index"].to_dict().items() if n not in entry.item_index]
    assert new_items
    np.testing.assert_array_equal(folded["warm"].item_factors[new_items], init[new_items])


def test_hit_miss_fold_counters_and_clear():
    store = seeded_store()
    _, _, first, t = train_both(store)
    assert t["pack_cache"] == "miss"
    ref, t_jax, hit, t = train_both(store)
    assert t["pack_cache"] == t_jax["pack_cache"] == "hit"
    assert t["scan_s"] == t["pack_exposed_s"] == 0.0
    assert same_bits(hit.arrays, first.arrays)  # a hit trains the cached wire cold
    random_delta(store, 50, seed=1)
    train_both(store)
    assert port_streaming.pack_cache_stats() == jax_streaming.pack_cache_stats() == {
        "hit": 1, "miss": 1, "fold": 1}
    port_streaming.pack_cache_clear()
    jax_streaming.pack_cache_clear()
    assert port_streaming.pack_cache_stats() == {"hit": 0, "miss": 0, "fold": 0}
    _, t_jax, _, t = train_both(store)
    assert t["pack_cache"] == t_jax["pack_cache"] == "miss"


def test_the_cache_scope_is_held_by_identity():
    """A scope that cannot be weakref'd caches nothing; another scope object
    under the same key never hits; the cursor-less foldable lookup misses."""
    store = seeded_store()
    config = port_als.ALSConfig(**CFG)
    bare = object()
    for _ in range(2):
        t = {}
        port_streaming.train_als_streaming(store.stream(ColumnarStream, scope=bare), config,
                                           device="cpu", timings=t)
        assert t["pack_cache"] == "miss"
    assert not port_streaming._PACK_CACHE
    port_streaming.train_als_streaming(store.stream(ColumnarStream), config, device="cpu")
    other = MemStore()
    t = {}
    port_streaming.train_als_streaming(store.stream(ColumnarStream, scope=other), config,
                                       device="cpu", timings=t)
    assert t["pack_cache"] == "miss"
    stream = store.stream(ColumnarStream, scope=other)
    assert port_streaming._cache_get(stream, config) is not None
    only_entry(port_streaming).cursor = None
    assert port_streaming._cache_get_foldable(stream, config) is None


def test_the_cache_keeps_the_newest_entries():
    config = port_als.ALSConfig(**CFG)
    stores = [seeded_store(key=("app", j), nnz=800, seed=j) for j in range(port_streaming.PACK_CACHE_MAX_ENTRIES + 1)]
    for s in stores:
        port_streaming.train_als_streaming(s.stream(ColumnarStream), config, device="cpu")
    keys = [key[0] for key in port_streaming._PACK_CACHE]
    assert keys == [s.key for s in stores[1:]]


@pytest.mark.parametrize(
    "setup, outcome",
    [("no_cursor", "miss"), ("delta_off", "miss"), ("cache_off", "off")],
)
def test_rounds_that_do_not_fold(setup, outcome):
    """A delta stream without a cursor, ``delta=False`` and ``cache=False``
    repack in full, as JAX's rounds do."""
    store = seeded_store()
    train_both(store)
    random_delta(store, 60, seed=2)
    kw = {}
    if setup == "no_cursor":
        store.delta_ok = False
    elif setup == "delta_off":
        kw["delta"] = False
    else:
        kw["cache"] = False
    ref, t_jax, got, t = train_both(store, **kw)
    assert t["pack_cache"] == t_jax["pack_cache"] == outcome
    assert_matches(ref, got)
    assert len(t["sweep_telemetry"]) == CFG["iterations"]


def test_implicit_fold_rounds_match_jax():
    """Implicit feedback folds like explicit (the wire carries raw values);
    the warm rounds run K12 in the loop."""
    cfg = dict(implicit_prefs=True, alpha=2.0)
    store = seeded_store()
    ref, _, got, _ = train_both(store, cfg)
    assert_matches(ref, got)
    for rnd in range(2):
        random_delta(store, 80, seed=30 + rnd, n_users=320)
        ref, t_jax, got, t = train_both(store, cfg)
        assert t["pack_cache"] == t_jax["pack_cache"] == "fold"
        assert "objective" in t["sweep_telemetry"][-1]
        assert_matches(ref, got)


class RecordingTimer:
    def __init__(self):
        self.added, self.notes = [], {}

    def add(self, name, seconds, overlapped=False):
        self.added.append((name, overlapped))

    def note(self, key, value):
        self.notes[key] = value


def test_attribute_phases_records_what_jax_records():
    store = seeded_store()
    for rnd in range(3):
        if rnd == 2:
            random_delta(store, 70, seed=4)
        t_jax, t_port = RecordingTimer(), RecordingTimer()
        jax_streaming.train_als_streaming(
            store.stream(JaxColumnarStream), jax_als.ALSConfig(**CFG), timer=t_jax)
        port_streaming.train_als_streaming(
            store.stream(ColumnarStream), port_als.ALSConfig(**CFG), device="cpu", timer=t_port)
        # the phases recorded, each with its overlap flag (zero-time phases,
        # such as the CPU's build, are left out on both sides)
        ref_added = dict(t_jax.added)
        for name, overlapped in t_port.added:
            assert ref_added.get(name, overlapped) == overlapped, name
        assert {"stream:device-loop"} <= {n for n, _ in t_port.added}
        assert set(t_port.notes) == set(t_jax.notes)
        for key in ("pack_cache", "pack_cache_stats", "delta_events", "sweeps"):
            assert t_port.notes.get(key) == t_jax.notes.get(key), key
    assert t_port.notes["pack_cache"] == "fold"
    port_streaming._attribute_phases(object(), {"scan_s": 1.0})  # no add/note: nothing


def test_als_algorithm_train_honours_delta_sweeps():
    """The engine's fold rounds train ``delta_sweeps`` warm sweeps: equal to
    ``train_als_streaming(warm_sweeps=1)`` on an equal store, bit for bit,
    and unlike 2."""
    params = ALSAlgorithmParams(rank=8, num_iterations=4, lambda_=0.05, seed=3, delta_sweeps=1)
    config = port_als.ALSConfig(rank=8, iterations=4, reg=0.05, seed=3)

    def loader():
        raise AssertionError("the streaming route materialized the columns")

    a, b = seeded_store(key=("engine",)), seeded_store(key=("direct",))
    td = StreamingTrainingData(lambda: a.stream(ColumnarStream), loader)
    alg = ALSAlgorithm(params)
    alg.train("cpu", Preparator().prepare("cpu", td))
    port_streaming.train_als_streaming(b.stream(ColumnarStream), config, device="cpu")
    for s in (a, b):
        random_delta(s, 90, seed=8)
    model = alg.train("cpu", Preparator().prepare("cpu", td))
    t = {}
    direct = port_streaming.train_als_streaming(b.stream(ColumnarStream), config, device="cpu",
                                                timings=t, warm_sweeps=1)
    assert t["pack_cache"] == "fold" and len(t["sweep_telemetry"]) == 1
    assert same_bits(model.arrays, direct.arrays)
    for s in (a, b):
        random_delta(s, 60, seed=9)
    two = ALSAlgorithm(dataclasses.replace(params, delta_sweeps=2)).train(
        "cpu", Preparator().prepare("cpu", td))
    one = port_streaming.train_als_streaming(b.stream(ColumnarStream), config, device="cpu",
                                             warm_sweeps=1)
    assert not same_bits(two.arrays, one.arrays)


def test_profile_dir_and_checkpoints_still_raise():
    """The profile capture still raises (item 10). Its other half, the
    checkpoint leg, is ``test_a_fold_round_checkpoints``."""
    store = seeded_store()
    config = port_als.ALSConfig(**CFG)
    with pytest.raises(NotImplementedError, match="item 10"):
        port_streaming.train_als_streaming(store.stream(ColumnarStream), config, device="cpu",
                                           profile_dir="prof")


def test_a_fold_round_checkpoints(tmp_path):
    """A delta round with ``checkpoint_dir`` (it raised before checkpoints
    were ported): the warm sweeps save under the folded wire's identity,
    and the same fold's factors come out as without the checkpoint."""
    config = port_als.ALSConfig(**CFG)
    results = []
    for ckdir in (None, str(tmp_path / "ckpt")):
        port_streaming.pack_cache_clear()
        store = seeded_store()
        port_streaming.train_als_streaming(store.stream(ColumnarStream), config, device="cpu")
        random_delta(store, 90, seed=8)
        t = {}
        res = port_streaming.train_als_streaming(store.stream(ColumnarStream), config,
                                                 device="cpu", timings=t, warm_sweeps=2,
                                                 checkpoint_dir=ckdir, checkpoint_every=1)
        assert t["pack_cache"] == "fold"
        results.append(res.arrays)
    port_streaming.pack_cache_clear()
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_1.npz", "step_2.npz"]
    assert same_bits(results[0], results[1])
