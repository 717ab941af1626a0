"""The device-resident pack of the streaming trainer (``ops/streaming.py``)
and K8's plain twins (``ops/delta_scatter.py``) on the CPU, against the
JAX package's resident arm on equal in-memory stores
(``tests/test_torch_delta.py``'s ``MemStore``).

Tolerances, stated beforehand:
- wires and indexes: byte for byte;
- K8's twins against the JAX program's arrays (``i_plane``, ``v_plane``,
  ``su``, ``si``, ``rem_u``, ``rem_i``, ``user_lam``, ``item_lam``) after
  the same rounds: exactly (integer copy work, and regularizers computed
  by one host function);
- port factors against JAX factors: within 1e-4 of the largest entry;
- the port's scatter rounds against its own host fold on the same data:
  bit for bit (one wire, one warm start, one device program).
Every test clears both packages' caches and restores the residency
setting.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.data.storage.columnar import ColumnarStream as JaxColumnarStream
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops import streaming as jax_streaming
from predictionio_tpu_torch.data.storage.columnar import ColumnarStream
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import delta_scatter as k8
from predictionio_tpu_torch.ops import device_pack as k5
from predictionio_tpu_torch.ops import streaming as port_streaming
from tests.test_torch_delta import (
    CFG,
    assert_matches,
    cold_wire,
    only_entry,
    random_delta,
    same_bits,
    scatterable_delta,
    seeded_store,
    train_both,
    wire_bytes,
)

PACK_FIELDS = ("i_plane", "v_plane", "su", "si", "rem_u", "rem_i", "user_lam", "item_lam")


@pytest.fixture(autouse=True)
def resident_on():
    port_streaming.pack_cache_clear()
    jax_streaming.pack_cache_clear()
    prev_port = port_streaming.set_resident_training(True)
    prev_jax = jax_streaming.set_resident_training(True)
    yield
    port_streaming.set_resident_training(prev_port)
    jax_streaming.set_resident_training(prev_jax)
    port_streaming.pack_cache_clear()
    jax_streaming.pack_cache_clear()


def port_train(store, timings=None, **cfg):
    t = {} if timings is None else timings
    res = port_streaming.train_als_streaming(
        store.stream(ColumnarStream), port_als.ALSConfig(**dict(CFG, **cfg)), device="cpu",
        timings=t)
    return res, t


def seed_resident(**cfg):
    """A seeded store and one cold resident round on the port."""
    store = seeded_store()
    _, t = port_train(store, **cfg)
    assert (t["pack_cache"], t["resident"]) == ("miss", "cold")
    assert port_streaming.resident_pack_bytes() > 0
    return store


def geometry(module=port_streaming):
    wire = only_entry(module).wire
    return wire.L_u, wire.L_i


def test_three_chained_scatter_rounds_match_jax_planes_exactly():
    """K8's twins give the JAX program's resident arrays exactly, round
    after round; the factors match JAX's, the uploads equal JAX's, and the
    restored wire equals a cold rescan's."""
    store = seeded_store()
    ref, t_jax, got, t = train_both(store)
    assert t["resident"] == t_jax["resident"] == "cold"
    cold_upload = t["delta_upload_bytes"]
    for rnd in range(3):
        scatterable_delta(store, 150, *geometry())
        before = k8.LAUNCHES.snapshot()
        ref, t_jax, got, t = train_both(store)
        after = k8.LAUNCHES.snapshot()
        assert (t["pack_cache"], t["resident"]) == (t_jax["pack_cache"], t_jax["resident"]) == ("fold", "scatter")
        for name in ("delta_counts_prefix", "move_and_append", "shift_offsets"):
            assert after[f"{name}_plain"] - before[f"{name}_plain"] == 1, name
        assert t["delta_upload_bytes"] == t_jax["delta_upload_bytes"] < cold_upload / 4
        assert_matches(ref, got)
        pack, ref_pack = only_entry(port_streaming).resident, only_entry(jax_streaming).resident
        for f in PACK_FIELDS:
            a, b = getattr(pack, f).numpy(), np.asarray(getattr(ref_pack, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert (pack.plane_len, pack.n, pack.v_lo, pack.v_hi) == (
            ref_pack.plane_len, ref_pack.n, ref_pack.v_lo, ref_pack.v_hi)
    wire = port_streaming._reconstruct_wire(only_entry(port_streaming))
    assert wire_bytes(wire) == wire_bytes(jax_streaming._reconstruct_wire(only_entry(jax_streaming)))
    assert wire_bytes(wire) == wire_bytes(cold_wire(store, port_als.ALSConfig(**CFG)))


def test_scatter_rounds_equal_the_host_fold_bit_for_bit():
    """Three scatter rounds, then the same data through the host fold with
    residency off: the same factors, bit for bit, and the same wire; the
    loop never writes into the factors the pack still owns."""
    store = seeded_store()
    deltas = []
    res, _ = port_train(store)
    factors = [res.arrays]
    for rnd in range(3):
        n0 = len(store.r)
        scatterable_delta(store, 150, *geometry())
        deltas.append((store.e[n0:], store.t[n0:], store.r[n0:]))
        pack = only_entry(port_streaming).resident
        X_owned, X_before = pack.X, pack.X.clone()
        res, t = port_train(store)
        assert t["resident"] == "scatter"
        assert torch.equal(X_owned, X_before)
        assert pack.X is not X_owned  # the round's final factors came back
        factors.append(res.arrays)
    resident_wire = wire_bytes(port_streaming._reconstruct_wire(only_entry(port_streaming)))

    port_streaming.set_resident_training(False)
    port_streaming.pack_cache_clear()
    replay = seeded_store()
    res, _ = port_train(replay)
    assert same_bits(res.arrays, factors[0])
    for rnd, (e, tt, r) in enumerate(deltas, 1):
        replay.e += e
        replay.t += tt
        replay.r += r
        res, t = port_train(replay)
        assert t["pack_cache"] == "fold" and "resident" not in t
        assert same_bits(res.arrays, factors[rnd]), rnd
    assert wire_bytes(only_entry(port_streaming).wire) == resident_wire


def test_a_hit_reuses_the_resident_planes():
    store = seed_resident()
    entry = only_entry(port_streaming)
    pack = entry.resident
    cold = entry.arrays
    before = k5.LAUNCHES.snapshot()
    res, t = port_train(store)
    after = k5.LAUNCHES.snapshot()
    assert (t["pack_cache"], t["resident"]) == ("hit", "scatter")
    assert after["unpack_nibbles_plain"] == before["unpack_nibbles_plain"]  # no wire upload
    assert t["device_put_exposed_s"] == 0.0
    fs = port_als.init_factor_state_single(
        entry.wire.counts_u, entry.wire.counts_i, entry.wire.n_users, entry.wire.n_items,
        port_als.ALSConfig(**CFG), device="cpu")
    assert t["delta_upload_bytes"] == sum(a.numel() * a.element_size() for a in fs[1:])
    assert same_bits(res.arrays, cold)
    assert only_entry(port_streaming).resident is pack and pack.valid


def test_establish_strips_the_host_wire_and_release_restores_it():
    store = seed_resident()
    entry = only_entry(port_streaming)
    pack = entry.resident
    assert entry.wire.stripped and entry.wire.iw.size == 0 and not entry.wire.aux
    assert port_streaming.resident_pack_bytes() == pack.device_bytes() > 0
    full = wire_bytes(port_streaming._reconstruct_wire(entry))
    assert full == wire_bytes(cold_wire(store, port_als.ALSConfig(**CFG)))
    assert port_streaming.release_resident_packs() == 1
    assert port_streaming.resident_pack_bytes() == 0
    assert entry.resident is None and not pack.valid and not entry.wire.stripped
    assert wire_bytes(entry.wire) == full
    assert port_streaming.release_resident_packs() == 0
    _, t = port_train(store)  # a hit on the host wire parks the pack again
    assert (t["pack_cache"], t["resident"]) == ("hit", "cold")
    assert only_entry(port_streaming).resident is not None


def test_round_outcomes_are_counted():
    before = port_streaming.resident_round_stats()
    store = seed_resident()
    scatterable_delta(store, 40, *geometry())
    port_train(store)
    random_delta(store, 40, seed=3, n_users=320)
    port_train(store)
    after = port_streaming.resident_round_stats()
    assert {k: after[k] - before[k] for k in after} == {"cold": 1, "scatter": 1, "fallback": 1}


FALLBACKS = ["new_ids", "geometry_growth", "value_tier", "rank", "implicit", "alpha",
             "solver", "block_size", "device"]


def _trigger(case, store, jax_entry, port_entry):
    """Apply one fallback trigger; returns the config changes of the round."""
    L_u, L_i = port_entry.wire.L_u, port_entry.wire.L_i
    if case == "new_ids":
        random_delta(store, 60, seed=11, n_users=330, n_items=170)
        return {}
    if case == "geometry_growth":
        cu, _ = store.counts()
        hot = max(cu, key=cu.get)  # one burst crosses a segment boundary
        store.add([int(hot[1:])] * (L_u + 1), [j % 60 for j in range(L_u + 1)], [3.0] * (L_u + 1))
        return {}
    if case == "value_tier":
        scatterable_delta(store, 1, L_u, L_i, ratings=[0.3])
        return {}
    scatterable_delta(store, 60, L_u, L_i)
    if case == "device":
        jax_entry.resident.device = object()
        port_entry.resident.device = torch.device("cuda", 7)
        return {}
    return {
        "rank": dict(rank=6),
        "implicit": dict(implicit_prefs=True),
        "alpha": dict(alpha=3.0),
        "solver": dict(solver="subspace", block_size=4),
        "block_size": dict(solver="subspace", block_size=4),
    }[case]


@pytest.mark.parametrize("case", FALLBACKS)
def test_the_fallback_matrix(case):
    """Every condition the scatter cannot take demotes the pack and folds on
    the host, as JAX's does: the pack released, the wire a cold rescan's.
    (``block_size`` starts from a subspace pack of block 2.)"""
    seed_cfg = dict(solver="subspace", block_size=2) if case == "block_size" else {}
    store = seeded_store()
    _, t_jax, _, t = train_both(store, seed_cfg)
    assert t["resident"] == t_jax["resident"] == "cold"
    change = _trigger(case, store, only_entry(jax_streaming), only_entry(port_streaming))
    cfg = dict(seed_cfg, **change)
    ref, t_jax, got, t = train_both(store, cfg)
    assert (t["pack_cache"], t["resident"]) == (t_jax["pack_cache"], t_jax["resident"]) == ("fold", "fallback")
    assert_matches(ref, got)
    assert port_streaming.resident_pack_bytes() == 0
    entry = only_entry(port_streaming)
    assert entry.resident is None and not entry.wire.stripped
    assert wire_bytes(entry.wire) == wire_bytes(only_entry(jax_streaming).wire)
    assert wire_bytes(entry.wire) == wire_bytes(cold_wire(store, port_als.ALSConfig(**dict(CFG, **cfg))))


@pytest.mark.parametrize("cfg", [dict(implicit_prefs=True, alpha=2.0),
                                 dict(implicit_prefs=True, alpha=2.0, solver="subspace", block_size=2),
                                 dict(reg_mode="plain")])
def test_implicit_subspace_and_plain_delta_rounds_scatter(cfg):
    store = seeded_store()
    train_both(store, cfg)
    scatterable_delta(store, 150, *geometry())
    ref, t_jax, got, t = train_both(store, cfg)
    assert t["resident"] == t_jax["resident"] == "scatter"
    assert t["delta_upload_bytes"] == t_jax["delta_upload_bytes"]
    assert_matches(ref, got)
    pack, ref_pack = only_entry(port_streaming).resident, only_entry(jax_streaming).resident
    for f in PACK_FIELDS:
        assert np.array_equal(getattr(pack, f).numpy(), np.asarray(getattr(ref_pack, f))), f


def test_an_error_mid_round_demotes_and_releases(monkeypatch):
    store = seed_resident()
    scatterable_delta(store, 50, *geometry())

    def fail(*args, **kwargs):
        raise RuntimeError("loop failed")

    monkeypatch.setattr(port_als, "_run_iterations", fail)
    with pytest.raises(RuntimeError, match="loop failed"):
        port_train(store)
    monkeypatch.undo()
    entry = only_entry(port_streaming)
    assert entry.resident is None and not entry.wire.stripped and entry.arrays is None
    assert port_streaming.resident_pack_bytes() == 0
    # the entry holds the scattered wire, a cold rescan's byte for byte
    assert wire_bytes(entry.wire) == wire_bytes(cold_wire(store, port_als.ALSConfig(**CFG)))
    _, t = port_train(store)
    assert (t["pack_cache"], t["resident"]) == ("hit", "cold")


def test_the_twins_are_the_wrappers_on_the_cpu():
    """On CPU tensors each wrapper runs its twin (counted as such), and
    the wrappers refuse what the kernels do not take."""
    rng = np.random.default_rng(0)
    n_users, n_items = 6, 5
    du = torch.tensor([0, 0, 2, 5], dtype=torch.int32)
    di = torch.tensor([4, 1, 1, 0], dtype=torch.uint16)
    before = k8.LAUNCHES.snapshot()
    dense_u, dense_i, sh_u, sh_i = k8.delta_counts_prefix(du, di, n_users, n_items)
    assert k8.LAUNCHES.snapshot()["delta_counts_prefix_plain"] == before["delta_counts_prefix_plain"] + 1
    assert dense_u.tolist() == [2, 0, 1, 0, 0, 1, 0] and sh_u.tolist() == [0, 2, 2, 3, 3, 3, 4]
    assert dense_i.tolist() == [1, 2, 0, 0, 1, 0] and sh_i.tolist() == [0, 1, 3, 3, 3, 4]
    # six users with counts 1, 2, 0, 1, 1, 1 (n = 6, planes of 8)
    su = torch.tensor([0, 1, 3, 3, 4, 5, 6, 6], dtype=torch.int32)
    i_old = torch.tensor([1, 2, 3, 0, 4, 2, 5, 5], dtype=torch.uint16)
    v_old = torch.from_numpy(rng.integers(1, 11, 8).astype(np.int8))
    v_old[6:] = 0
    dv = torch.tensor([7, 8, 9, 10], dtype=torch.int8)
    i_new, v_new = k8.move_and_append(i_old, v_old, su, sh_u, du, di, dv, n_users, 10, n_items)
    assert i_new.dtype == torch.uint16
    assert i_new.tolist() == [1, 4, 1, 2, 3, 1, 0, 4, 2, 0]
    vo = v_old.tolist()
    assert v_new.tolist() == [vo[0], 7, 8, vo[1], vo[2], 9, vo[3], vo[4], vo[5], 10]
    with pytest.raises(TypeError):
        k8.move_and_append(i_old, v_old, su, sh_u, du, di.to(torch.int32), dv, n_users, 10, n_items)
    with pytest.raises(ValueError):
        k8.delta_counts_prefix(du[:2], di, n_users, n_items)
    with pytest.raises(ValueError, match="all six"):
        z = torch.zeros(1, dtype=torch.int32)
        k8.shift_offsets(su, su, sh_u, sh_u, dense_u, dense_u, n_users, n_users, z, z, z, z, z, z,
                         lam_u=torch.zeros(8))


def test_a_stale_device_or_config_never_reaches_k8():
    """``_resident_usable`` compares devices index and all; a changed
    ``config_train_key`` keeps K8 from running (the round demotes)."""
    store = seed_resident()
    pack = only_entry(port_streaming).resident
    assert port_streaming._resident_usable(pack, torch.device("cpu"))
    assert not port_streaming._resident_usable(pack, torch.device("cuda", 0))
    assert not port_streaming._resident_usable(None, torch.device("cpu"))
    assert port_als.config_train_key(port_als.ALSConfig(**CFG)) == jax_als.config_train_key(
        jax_als.ALSConfig(**CFG))
    scatterable_delta(store, 30, *geometry())
    before = k8.LAUNCHES.snapshot()
    _, t = port_train(store, reg=0.1)
    assert t["resident"] == "fallback"
    assert k8.LAUNCHES.snapshot() == before
