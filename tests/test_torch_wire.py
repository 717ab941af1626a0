"""The training wire, copied as numpy into the port's ``ops/als.py``,
against the JAX package's: ``build_host_wire``, ``finish_wire``,
``wire_coo``, the narrowing tiers and ``aux_pad`` give the same bytes,
dtypes and geometry for the same input, in every tier (uint16 or int32
ids; nibble, int8 or float32 values; the empty COO)."""

import numpy as np
import pytest

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.ops import als as port_als

CFG = dict(rank=4, segment_length=16, chunk_slots=1024)


def _ratings(kind, n, rng):
    half = (rng.integers(1, 11, n) / 2).astype(np.float32)
    if kind == "nibble":
        return half
    if kind == "int8":  # a negative rating keeps the plain int8 tier
        half[0] = -1.5
        return half
    if kind == "float32":
        return rng.uniform(0.0, 5.0, n).astype(np.float32)
    raise ValueError(kind)


def _coo(n_users, n_items, nnz, kind, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz).astype(np.int32)
    i = rng.integers(0, n_items, nnz).astype(np.int32)
    if nnz:
        i[0] = n_items - 1  # the widest id reaches the narrowing limit
    return u, i, _ratings(kind, nnz, rng)


def _assert_same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _assert_same_wire(port, ref):
    for name in ("n_users", "n_items", "L_u", "L_i", "nibble", "v_scale", "wire_mb", "padded_slots"):
        assert getattr(port, name) == getattr(ref, name), name
    for name in ("iw", "vw", "counts_u", "counts_i"):
        _assert_same_array(getattr(port, name), getattr(ref, name))
    assert sorted(port.aux) == sorted(ref.aux) == ["bi", "bu", "si", "su"]
    for key in port.aux:
        _assert_same_array(port.aux[key], ref.aux[key])
    for side in ("geo_u", "geo_i"):
        gp, gr = getattr(port, side), getattr(ref, side)
        for name in ("n_rows", "L", "n_segs", "sc", "n_chunks", "total"):
            assert getattr(gp, name) == getattr(gr, name), (side, name)
        for name in ("counts", "starts", "seg_base", "seg_rows", "rem"):
            _assert_same_array(getattr(gp, name), getattr(gr, name))
    assert port.identity_bytes() == ref.identity_bytes()


@pytest.mark.parametrize(
    "n_users, n_items, nnz, kind, ids",
    [
        (300, 150, 6000, "nibble", np.uint16),
        (300, 150, 6000, "int8", np.uint16),
        (300, 150, 6000, "float32", np.uint16),
        (200, 70_000, 5000, "nibble", np.int32),
        (200, 70_000, 5000, "float32", np.int32),
        (1000, 40, 3001, "nibble", np.uint16),  # bucketed to an even length
        (5, 3, 0, "nibble", np.uint16),  # the empty COO: a one-element wire
    ],
)
def test_build_host_wire_matches_jax(n_users, n_items, nnz, kind, ids):
    u, i, r = _coo(n_users, n_items, nnz, kind)
    port = port_als.build_host_wire(u, i, r, n_users, n_items, port_als.ALSConfig(**CFG))
    ref = jax_als.build_host_wire(u, i, r, n_users, n_items, jax_als.ALSConfig(**CFG))
    _assert_same_wire(port, ref)
    assert port.iw.dtype == ids
    assert len(port.iw) == (jax_als._bucket_count(nnz) if nnz else 1)
    want_vw = {"nibble": np.uint8, "int8": np.int8, "float32": np.float32}[kind]
    if nnz == 0:  # one zero value: int8, odd length, not nibble-packed
        want_vw = np.int8
    assert port.vw.dtype == want_vw


@pytest.mark.parametrize("kind", ["nibble", "int8", "float32"])
def test_finish_wire_and_wire_coo_match_jax(kind):
    u, i, r = _coo(400, 90, 4000, kind, seed=1)
    wire = port_als.build_host_wire(u, i, r, 400, 90, port_als.ALSConfig(**CFG))
    ref = jax_als.build_host_wire(u, i, r, 400, 90, jax_als.ALSConfig(**CFG))
    cu, ci, cv = port_als.wire_coo(wire)
    for a, b in zip((cu, ci, cv), jax_als.wire_coo(ref)):
        _assert_same_array(a, b)
    # the COO is exactly the user-sorted input
    order = np.argsort(u, kind="stable")
    np.testing.assert_array_equal(cu, u[order])
    np.testing.assert_array_equal(ci, i[order])
    np.testing.assert_array_equal(cv, r[order])
    # finishing the recovered COO gives the wire back, byte for byte
    n = len(cv)
    pad = port_als._bucket_count(n) - n
    iw = np.concatenate([ci, np.full(pad, 90, np.int32)])
    vw = np.concatenate([cv, np.zeros(pad, np.float32)])
    args = (400, 90, wire.L_u, wire.L_i, wire.geo_u, wire.geo_i, wire.counts_u, wire.counts_i)
    again = port_als.finish_wire(iw, vw, *args)
    _assert_same_wire(again, wire)
    ref_args = (400, 90, ref.L_u, ref.L_i, ref.geo_u, ref.geo_i, ref.counts_u, ref.counts_i)
    _assert_same_wire(again, jax_als.finish_wire(iw, vw, *ref_args))


@pytest.mark.parametrize(
    "ids",
    [np.array([], np.int32), np.array([0, 65535], np.int32), np.array([0, 65536], np.int32)],
)
def test_narrow_ids_matches_jax(ids):
    _assert_same_array(port_als._narrow_ids(ids), jax_als._narrow_ids(ids))


@pytest.mark.parametrize(
    "vals",
    [
        np.array([], np.float32),
        np.array([0.5, 5.0, 3.0], np.float32),
        np.array([-1.0, 2.5], np.float32),
        np.array([63.5, -64.0], np.float32),
        np.array([64.0], np.float32),  # doubled past int8
        np.array([0.25, 1.0], np.float32),  # not a half step
    ],
)
def test_narrow_vals_and_nibbles_match_jax(vals):
    pw, ps = port_als._narrow_vals(vals)
    jw, js = jax_als._narrow_vals(vals)
    _assert_same_array(pw, jw)
    assert ps == js
    assert port_als._nibble_packable(pw) == jax_als._nibble_packable(jw)


def test_nibble_pack_round_trip_matches_jax():
    codes = np.random.default_rng(2).integers(0, 16, 1000).astype(np.int8)
    packed = port_als._pack_nibbles_host(codes)
    _assert_same_array(packed, jax_als._pack_nibbles_host(codes))
    _assert_same_array(port_als._unpack_nibbles_host(packed), jax_als._unpack_nibbles_host(packed))
    np.testing.assert_array_equal(port_als._unpack_nibbles_host(packed), codes)


@pytest.mark.parametrize("length", [1, 2, 15, 16, 17, 1001, 138_494])
def test_aux_pad_matches_jax(length):
    arr = np.cumsum(np.random.default_rng(length).integers(0, 5, length)).astype(np.int32)
    got = port_als.aux_pad(arr)
    _assert_same_array(got, jax_als.aux_pad(arr))
    assert len(got) == port_als._bucket_count(length)
    assert (got[length:] == arr[-1]).all()
