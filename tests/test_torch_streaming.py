"""The streaming trainer (``ops/streaming.py``) on the CPU against the JAX
package's ``train_als_streaming(stream, config, cache=False)`` on an equal
multi-batch ``ColumnarStream``, and ``ALSAlgorithm.train`` through
``StreamingTrainingData`` against ``TrainingData``.

Tolerances, stated beforehand:
- the wire, byte for byte, and the id indexes, exactly: both are integer
  and copy work;
- port against JAX factors: within 1e-4 of the largest factor entry, the
  tolerance of ``test_torch_als_train.py`` (both float32, summed in
  different orders);
- the port's streaming route against its direct route on the relabelled
  COO, and the two ``ALSAlgorithm.train`` routes: bit for bit (one wire,
  one device program).
"""

import dataclasses

import numpy as np
import pytest

from predictionio_tpu.data.storage import columnar as jax_columnar
from predictionio_tpu.data.storage.columnar import ColumnarStream as JaxColumnarStream
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops import streaming as jax_streaming
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.storage import columnar as port_columnar
from predictionio_tpu_torch.data.storage.columnar import ColumnarEvents, ColumnarStream
from predictionio_tpu_torch.models.recommendation.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    Preparator,
    StreamingTrainingData,
    TrainingData,
)
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import device_pack as k5
from predictionio_tpu_torch.ops import streaming as port_streaming

N_USERS, N_ITEMS, NNZ = 300, 150, 6000
CFG = dict(rank=8, iterations=4, reg=0.05, seed=3, segment_length=16, chunk_slots=1024)


@pytest.fixture(scope="module")
def events():
    """Ratings with string ids ("u<n>", "i<n>", so sorted-name order is not
    numeric order) in ONE shuffled code space, cut into uneven batches."""
    rng = np.random.default_rng(0)
    u = rng.integers(0, N_USERS, NNZ).astype(np.int32)
    i = rng.integers(0, N_ITEMS, NNZ).astype(np.int32)
    i[:400] = 7  # a long item row
    r = (rng.integers(1, 11, NNZ) / 2).astype(np.float32)
    names = np.array([f"u{n}" for n in range(N_USERS)] + [f"i{n}" for n in range(N_ITEMS)], object)
    code_of = rng.permutation(len(names)).astype(np.int32)  # name index -> code
    names_by_code = np.empty(len(names), object)
    names_by_code[code_of] = names
    e_codes, t_codes = code_of[u], code_of[N_USERS + i]
    cuts = [0, 700, 1900, 2000, 4100, NNZ]
    batches = [(e_codes[a:b], t_codes[a:b], r[a:b]) for a, b in zip(cuts, cuts[1:])]
    return u, i, r, names_by_code, batches


def _stream(cls, events, **kw):
    *_, names, batches = events
    return cls(iter(list(batches)), lambda: names, **kw)


def _relabel(u, i, user_index, item_index):
    ru = np.array([user_index[f"u{n}"] if f"u{n}" in user_index else -1 for n in range(N_USERS)])
    ri = np.array([item_index[f"i{n}"] if f"i{n}" in item_index else -1 for n in range(N_ITEMS)])
    return ru[u].astype(np.int32), ri[i].astype(np.int32)


def _close(a, b, rel):
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())


def _wire_bytes(w):
    return (
        w.iw.dtype.str, w.iw.tobytes(), w.vw.dtype.str, w.vw.tobytes(), w.nibble,
        w.v_scale, w.L_u, w.L_i, {k: a.tobytes() for k, a in w.aux.items()},
        w.counts_u.tobytes(), w.counts_i.tobytes(),
    )


def test_scan_and_pack_matches_jax_and_build_host_wire(events):
    u, i, r, _, _ = events
    t_port, t_jax = {}, {}
    wire, user_index, item_index, wait, _ = port_streaming._scan_and_pack(
        _stream(ColumnarStream, events), port_als.ALSConfig(**CFG), t_port, "cpu"
    )
    assert wait()["busy_s"] == 0.0  # the CPU builds no kernels
    ref, ref_users, ref_items, ref_wait, _ = jax_streaming._scan_and_pack(
        _stream(JaxColumnarStream, events), jax_als.ALSConfig(**CFG), t_jax, 2
    )
    ref_wait()
    assert _wire_bytes(wire) == _wire_bytes(ref)
    assert user_index.to_dict() == ref_users.to_dict()
    assert item_index.to_dict() == ref_items.to_dict()
    # ids in sorted-name order, the monolithic scan's order
    assert list(user_index.keys()) == sorted(f"u{n}" for n in range(N_USERS) if n in set(u))
    u_rel, i_rel = _relabel(u, i, user_index, item_index)
    direct = port_als.build_host_wire(
        u_rel, i_rel, r, len(user_index), len(item_index), port_als.ALSConfig(**CFG)
    )
    assert _wire_bytes(wire) == _wire_bytes(direct)
    for key in ("scan_s", "fold_s", "pack_s", "pack_exposed_s"):
        assert t_port[key] >= 0


def test_train_als_streaming_matches_jax_and_the_direct_route(events):
    u, i, r, _, _ = events
    t_port = {}
    before = k5.LAUNCHES.snapshot()
    got = port_streaming.train_als_streaming(
        _stream(ColumnarStream, events), port_als.ALSConfig(**CFG), device="cpu",
        timings=t_port, ship_chunks=3,
    )
    after = k5.LAUNCHES.snapshot()
    assert after["unpack_nibbles_plain"] - before["unpack_nibbles_plain"] == 3  # one per chunk
    assert after["device_pack_presorted_plain"] - before["device_pack_presorted_plain"] == 1
    assert after["device_scatter_pack_plain"] - before["device_scatter_pack_plain"] == 1
    ref = jax_streaming.train_als_streaming(
        _stream(JaxColumnarStream, events), jax_als.ALSConfig(**CFG), cache=False
    )
    assert got.user_index.to_dict() == ref.user_index.to_dict()
    assert got.item_index.to_dict() == ref.item_index.to_dict()
    _close(got.arrays.user_factors, ref.arrays.user_factors, 1e-4)
    _close(got.arrays.item_factors, ref.arrays.item_factors, 1e-4)
    assert t_port["pack_cache"] == "miss"
    for key in ("scan_s", "fold_s", "pack_s", "pack_exposed_s", "device_put_exposed_s",
                "compile_s", "compile_exposed_s", "device_pack_dispatch_s", "device_loop_s"):
        assert t_port[key] >= 0, key
    assert len(t_port["sweep_telemetry"]) == CFG["iterations"]

    u_rel, i_rel = _relabel(u, i, got.user_index, got.item_index)
    direct = port_als.train_als(
        u_rel, i_rel, r, len(got.user_index), len(got.item_index),
        port_als.ALSConfig(**CFG), device="cpu",
    )
    np.testing.assert_array_equal(direct.user_factors, got.arrays.user_factors)
    np.testing.assert_array_equal(direct.item_factors, got.arrays.item_factors)


def test_empty_stream_returns_none():
    for stream in (None, ColumnarStream(iter([]), lambda: np.empty(0, object))):
        assert port_streaming.train_als_streaming(stream, port_als.ALSConfig(rank=4), device="cpu") is None
    empty = ColumnarStream.from_columnar(ColumnarEvents.empty())
    assert port_streaming.train_als_streaming(empty, port_als.ALSConfig(rank=4), device="cpu") is None
    ref = jax_streaming.train_als_streaming(
        JaxColumnarStream(iter([]), lambda: np.empty(0, object)), jax_als.ALSConfig(rank=4), cache=False
    )
    assert ref is None


def test_from_columnar_trains_like_the_batched_stream(events):
    u, i, r, _, _ = events
    cols = ColumnarEvents(
        entity_names=np.array([f"u{n}" for n in range(N_USERS)], object),
        target_names=np.array([f"i{n}" for n in range(N_ITEMS)], object),
        entity_codes=u, target_codes=i, values=r,
    )
    one = port_streaming.train_als_streaming(
        ColumnarStream.from_columnar(cols), port_als.ALSConfig(**CFG), device="cpu"
    )
    many = port_streaming.train_als_streaming(
        _stream(ColumnarStream, events), port_als.ALSConfig(**CFG), device="cpu"
    )
    assert one.user_index.to_dict() == many.user_index.to_dict()
    np.testing.assert_array_equal(one.arrays.user_factors, many.arrays.user_factors)
    np.testing.assert_array_equal(one.arrays.item_factors, many.arrays.item_factors)


def test_a_stream_with_a_cache_identity_raises_unless_the_cache_is_off(events):
    """A stream with a cache identity reaches the pack cache (a miss, then a
    hit on the same fingerprint, as JAX's); ``cache=False`` trains it cold
    ("off"). The name is from before the cache was ported, when such a
    stream raised."""

    class Scope:
        pass

    scope = Scope()
    identity = dict(fingerprint=(1, 2), cache_key=("app", None), cache_scope=scope)
    port_streaming.pack_cache_clear()
    jax_streaming.pack_cache_clear()
    try:
        outcomes = []
        for _ in range(2):
            t_port, t_jax = {}, {}
            port_streaming.train_als_streaming(
                _stream(ColumnarStream, events, **identity), port_als.ALSConfig(**CFG),
                device="cpu", timings=t_port,
            )
            jax_streaming.train_als_streaming(
                _stream(JaxColumnarStream, events, **identity), jax_als.ALSConfig(**CFG), timings=t_jax,
            )
            outcomes.append((t_port["pack_cache"], t_jax["pack_cache"]))
        assert outcomes == [("miss", "miss"), ("hit", "hit")]
        timings = {}
        res = port_streaming.train_als_streaming(
            _stream(ColumnarStream, events, **identity), port_als.ALSConfig(**CFG),
            device="cpu", cache=False, timings=timings,
        )
        assert res is not None and timings["pack_cache"] == "off"
    finally:
        port_streaming.pack_cache_clear()
        jax_streaming.pack_cache_clear()


@pytest.mark.parametrize(
    "kwargs, match",
    [(dict(profile_dir="prof"), "item 10")],
)
def test_legs_not_ported_raise(events, kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        port_streaming.train_als_streaming(
            _stream(ColumnarStream, events), port_als.ALSConfig(**CFG), device="cpu", **kwargs
        )


def test_checkpoint_dir_saves_and_resumes(events, tmp_path):
    """``checkpoint_dir`` (a case of ``test_legs_not_ported_raise`` before
    checkpoints were ported): the streaming trainer saves the loop's
    factors and a rerun of the same stream resumes at the last save, to
    the same factors bit for bit."""
    ckdir = str(tmp_path / "ckpt")
    runs = []
    for _ in range(2):
        t = {}
        res = port_streaming.train_als_streaming(
            _stream(ColumnarStream, events), port_als.ALSConfig(**CFG), device="cpu",
            cache=False, timings=t, checkpoint_dir=ckdir, checkpoint_every=2,
        )
        runs.append((res.arrays, t["checkpoint_resumed_at"]))
    assert [at for _, at in runs] == [0, CFG["iterations"]]
    assert np.array_equal(runs[0][0].user_factors, runs[1][0].user_factors)
    assert np.array_equal(runs[0][0].item_factors, runs[1][0].item_factors)


def test_a_timer_receives_the_stream_phases(events):
    """Any object with ``add`` and ``note`` is a phase timer (the
    reference's ``_attribute_phases``); before the timer was ported this
    was a case of ``test_legs_not_ported_raise``."""
    added, notes = [], {}

    class Timer:
        def add(self, name, seconds, overlapped=False):
            added.append((name, overlapped))

        def note(self, key, value):
            notes[key] = value

    port_streaming.train_als_streaming(
        _stream(ColumnarStream, events), port_als.ALSConfig(**CFG), device="cpu", timer=Timer()
    )
    names = dict(added)
    assert names["stream:scan"] is True and names["stream:device-loop"] is False
    assert notes["pack_cache"] == "miss" and notes["sweeps"] == CFG["iterations"]


def test_train_from_wire_takes_a_checkpoint_dir(tmp_path):
    """``train_from_wire`` with ``checkpoint_dir`` (it raised before
    checkpoints were ported, ``test_train_from_wire_legs_not_ported_raise``):
    a chunked run saves each chunk and equals an unchunked one."""
    one = np.zeros(1, np.int32)
    wire = port_als.build_host_wire(one, one, np.ones(1, np.float32), 2, 2, port_als.ALSConfig(rank=2))
    config = port_als.ALSConfig(rank=2, iterations=3)
    plain = port_als.train_from_wire(wire, config, device="cpu")
    saved = port_als.train_from_wire(wire, config, device="cpu",
                                     checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2.npz", "step_3.npz"]
    assert np.array_equal(plain.user_factors, saved.user_factors)


@pytest.mark.parametrize("leg", ["geo_dev", "factor_slots_out"])
def test_train_from_wire_takes_and_hands_back_resident_state(events, leg):
    """The resident pack's legs of ``train_from_wire`` (before they were
    ported, cases of ``test_train_from_wire_legs_not_ported_raise``):
    ``factor_slots_out`` receives the loop's final device factors and both
    packs' device geometry; ``geo_dev`` trains from that geometry to the
    same factors, bit for bit."""
    u, i, r, _, _ = events
    config = port_als.ALSConfig(**CFG)
    wire = port_als.build_host_wire(u, i, r, N_USERS, N_ITEMS, config)
    slots = {}
    got = port_als.train_from_wire(wire, config, device="cpu", factor_slots_out=slots)
    if leg == "factor_slots_out":
        assert set(slots) == {"X", "Y", "geo"}
        np.testing.assert_array_equal(slots["X"][:N_USERS].numpy(), got.user_factors)
        np.testing.assert_array_equal(slots["Y"][:N_ITEMS].numpy(), got.item_factors)
        sr_u, rem_u, sr_i, rem_i, plan_u, plan_i = slots["geo"]
        np.testing.assert_array_equal(sr_u.numpy(), wire.geo_u.seg_rows)
        np.testing.assert_array_equal(rem_i.numpy(), wire.geo_i.rem)
        assert plan_u.n_sys_rows == port_als._padded_rows(N_USERS, 1)
        return
    again = port_als.train_from_wire(
        wire, config, device_wire=port_als.upload_wire(wire, port_als.resolve_device("cpu")),
        geo_dev=slots["geo"],
    )
    np.testing.assert_array_equal(again.user_factors, got.user_factors)
    np.testing.assert_array_equal(again.item_factors, got.item_factors)
    stripped = dataclasses.replace(wire, iw=wire.iw[:0], vw=wire.vw[:0], aux={}, stripped=True)
    with pytest.raises(ValueError, match="stripped"):
        port_als.train_from_wire(stripped, config, device="cpu")


def _algorithm():
    return ALSAlgorithm(ALSAlgorithmParams(rank=8, num_iterations=4, lambda_=0.05, seed=3))


def test_als_algorithm_streams_and_matches_the_materialized_route(events):
    u, i, r, _, _ = events

    def loader():
        raise AssertionError("the streaming route materialized the columns")

    streamed = _algorithm().train(
        "cpu", Preparator().prepare("cpu", StreamingTrainingData(lambda: _stream(ColumnarStream, events), loader))
    )
    # the same ratings as materialized columns, ids in sorted-name order
    user_index = BiMap.string_int(f"u{n}" for n in np.unique(u))
    item_index = BiMap.string_int(f"i{n}" for n in np.unique(i))
    assert streamed.user_index.to_dict() == user_index.to_dict()
    assert streamed.item_index.to_dict() == item_index.to_dict()
    u_rel, i_rel = _relabel(u, i, user_index, item_index)
    td = TrainingData(u_rel, i_rel, r, user_index, item_index)
    direct = _algorithm().train("cpu", Preparator().prepare("cpu", td))
    np.testing.assert_array_equal(streamed.arrays.user_factors, direct.arrays.user_factors)
    np.testing.assert_array_equal(streamed.arrays.item_factors, direct.arrays.item_factors)
    assert streamed.params == direct.params


def test_als_algorithm_falls_back_on_an_empty_stream():
    empty = TrainingData(
        np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float32),
        BiMap({}), BiMap({}),
    )
    std = StreamingTrainingData(lambda: ColumnarStream(iter([]), lambda: np.empty(0, object)), lambda: empty)
    std.sanity_check()  # deferred: nothing materialized yet
    with pytest.raises(ValueError, match="ratings is empty"):
        _algorithm().train("cpu", Preparator().prepare("cpu", std))


def test_columnar_events_concat_and_from_columnar_match_jax():
    rng = np.random.default_rng(4)

    def parts(mod):
        out = []
        for k in range(3):
            e_names = np.array([f"u{n}" for n in rng.permutation(6)[: 3 + k]], object)
            t_names = np.array([f"i{n}" for n in rng.permutation(5)[: 2 + k]], object)
            m = 4 + k
            out.append(mod.ColumnarEvents(
                entity_names=e_names, target_names=t_names,
                entity_codes=rng.integers(0, len(e_names), m).astype(np.int32),
                target_codes=rng.integers(0, len(t_names), m).astype(np.int32),
                values=rng.uniform(0, 5, m).astype(np.float32),
            ))
        return out

    state = rng.bit_generator.state
    port_parts = parts(port_columnar)
    rng.bit_generator.state = state
    jax_parts = parts(jax_columnar)
    got = ColumnarEvents.concat(port_parts + [ColumnarEvents.empty()])
    ref = jax_columnar.ColumnarEvents.concat(jax_parts + [jax_columnar.ColumnarEvents.empty()])
    for name in ("entity_names", "target_names", "entity_codes", "target_codes", "values"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert got.n == ref.n == 15
    assert ColumnarEvents.concat([]).n == 0
    stream = ColumnarStream.from_columnar(got)
    ref_stream = JaxColumnarStream.from_columnar(ref)
    for (e, t, v), (re_, rt, rv) in zip(list(stream), list(ref_stream)):
        np.testing.assert_array_equal(e, re_)
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(stream.names, ref_stream.names)


def test_streaming_and_wire_training_default_to_cuda_and_raise_without_it(events, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_streaming.train_als_streaming(_stream(ColumnarStream, events), port_als.ALSConfig(**CFG))
    one = np.zeros(1, np.int32)
    wire = port_als.build_host_wire(one, one, np.ones(1, np.float32), 2, 2, port_als.ALSConfig(rank=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_als.train_from_wire(wire, port_als.ALSConfig(rank=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_als.device_pack_from_wire(wire)
