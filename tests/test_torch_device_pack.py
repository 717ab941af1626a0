"""K4, K5a and K5b on the CPU: the port's plain twins (each wrapper routes
CPU tensors to them) against the JAX package's ``_unpack_nibbles``,
``_device_pack_presorted`` and ``_device_scatter_pack`` on the same wire,
and ``device_pack_from_wire`` against the JAX one, plane for plane.

Every comparison is exact: the values are small integers times 0.5 or
float32 copies, and every index is an integer, so the planes must agree
bit for bit, the padding segments that the wire's sentinel tail lands in
included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import device_pack as k5

CFG = dict(rank=4, segment_length=16, chunk_slots=1024)


def _wire(n_users, n_items, nnz, kind, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz).astype(np.int32)
    i = rng.integers(0, n_items, nnz).astype(np.int32)
    r = (rng.integers(1, 11, nnz) / 2).astype(np.float32)
    if nnz:
        i[0] = n_items - 1
    if kind == "int8":
        r[0] = -2.0
    elif kind == "float32":
        r = rng.uniform(0.0, 5.0, nnz).astype(np.float32)
    return port_als.build_host_wire(u, i, r, n_users, n_items, port_als.ALSConfig(**CFG))


def _assert_bits_equal(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()


# (n_users, n_items, nnz, values): uint16 and int32 ids, nibble, int8 and
# float32 values; 1000 users lengthen the user offsets from 1001 to 1024
# entries (aux_pad), and every case pads its COO with sentinel elements
WIRES = [
    (300, 150, 6000, "nibble"),
    (1000, 150, 6000, "int8"),
    (300, 150, 6000, "float32"),
    (200, 70_000, 5000, "nibble"),
    (1000, 70_000, 3000, "float32"),
    (5, 3, 0, "nibble"),  # the empty COO: one sentinel element
]


@pytest.fixture(params=WIRES, ids=lambda p: f"{p[0]}x{p[1]}-{p[2]}-{p[3]}")
def wire(request):
    return _wire(*request.param)


def _values(wire):
    """The unpacked value plane, as the JAX package and the port see it."""
    if wire.nibble:
        return jnp.asarray(jax_als._unpack_nibbles(jnp.asarray(wire.vw)))
    return jnp.asarray(wire.vw)


def test_unpack_nibbles_matches_jax():
    packed = np.random.default_rng(1).integers(0, 256, 1001).astype(np.uint8)
    ref = jax_als._unpack_nibbles(jnp.asarray(packed))
    before = k5.LAUNCHES.snapshot()["unpack_nibbles_plain"]
    _assert_bits_equal(k5.unpack_nibbles(torch.from_numpy(packed)), ref)
    assert k5.LAUNCHES.snapshot()["unpack_nibbles_plain"] == before + 1
    # into slices of one plane, at offsets that are not 16-byte aligned
    out = torch.full((2 * len(packed),), 99, dtype=torch.int8)
    for s, e in ((0, 334), (334, 668), (668, 1001)):
        k5.unpack_nibbles(torch.from_numpy(packed[s:e]), out=out[2 * s : 2 * e])
    _assert_bits_equal(out, ref)


def test_device_pack_presorted_matches_jax(wire):
    v = _values(wire)
    ref = jax_als._device_pack_presorted(
        jnp.asarray(wire.iw), v, jnp.asarray(wire.aux["su"]), jnp.asarray(wire.aux["bu"]),
        total=wire.geo_u.total, L=wire.L_u, scale=wire.v_scale,
    )
    before = k5.LAUNCHES.snapshot()["device_pack_presorted_plain"]
    got = k5.device_pack_presorted(
        torch.from_numpy(wire.iw), torch.from_numpy(np.asarray(v)),
        torch.from_numpy(wire.aux["su"]), torch.from_numpy(wire.aux["bu"]),
        wire.geo_u.total, wire.L_u, wire.v_scale,
    )
    assert k5.LAUNCHES.snapshot()["device_pack_presorted_plain"] == before + 1
    for g, r in zip(got, ref):
        _assert_bits_equal(g, r)


def test_device_scatter_pack_matches_jax(wire):
    v = _values(wire)
    keys, _, _ = jax_als._device_pack_presorted(
        jnp.asarray(wire.iw), v, jnp.asarray(wire.aux["su"]), jnp.asarray(wire.aux["bu"]),
        total=wire.geo_u.total, L=wire.L_u, scale=wire.v_scale,
    )
    ref = jax_als._device_scatter_pack(
        jnp.asarray(wire.iw), keys, v, jnp.asarray(wire.aux["si"]), jnp.asarray(wire.aux["bi"]),
        total=wire.geo_i.total, L=wire.L_i, scale=wire.v_scale,
    )
    got = k5.device_scatter_pack(
        torch.from_numpy(wire.iw), torch.from_numpy(np.asarray(keys)),
        torch.from_numpy(np.asarray(v)), torch.from_numpy(wire.aux["si"]),
        torch.from_numpy(wire.aux["bi"]), wire.geo_i.total, wire.L_i, wire.v_scale,
        key_bound=wire.n_items + 1,
    )
    for g, r in zip(got, ref):
        _assert_bits_equal(g, r)


def test_device_pack_from_wire_matches_jax_plane_for_plane(wire):
    ref = jax_als.device_pack_from_wire(wire)
    timings = {}
    got = port_als.device_pack_from_wire(wire, "cpu", timings=timings)
    for pack, ref_pack in zip(got, ref):
        for plane, ref_plane in zip((pack.seg_rows, pack.cols, pack.vals, pack.rem), ref_pack):
            _assert_bits_equal(plane, ref_plane)
    assert timings["wire_mb"] == wire.wire_mb
    assert timings["device_put_s"] >= 0 and timings["device_pack_dispatch_s"] >= 0


def test_sentinel_tail_lands_in_padding_segments():
    """1,000 users: the user offsets are lengthened to 1,024 entries, the
    padded COO tail gets row keys past the last real row, and both sides
    hold tail elements in segments past their last real one, exactly
    where the JAX package puts them."""
    wire = _wire(1000, 1000, 30_000, "nibble", seed=3)
    assert len(wire.aux["su"]) == 1024 > wire.n_users + 1
    n = len(wire.iw)
    nnz = int(wire.counts_u.sum())
    assert n > nnz
    got_u, got_i = port_als.device_pack_from_wire(wire, "cpu")
    ref_u, ref_i = jax_als.device_pack_from_wire(wire)
    keys, _, _ = k5.device_pack_presorted(
        torch.from_numpy(wire.iw), torch.from_numpy(np.asarray(_values(wire))),
        torch.from_numpy(wire.aux["su"]), torch.from_numpy(wire.aux["bu"]),
        wire.geo_u.total, wire.L_u, wire.v_scale,
    )
    assert (keys[nnz:] == len(wire.aux["su"]) - 1).all()
    for got, ref, geo, sentinel in (
        (got_u, ref_u, wire.geo_u, wire.n_items),
        (got_i, ref_i, wire.geo_i, len(wire.aux["su"]) - 1),
    ):
        cols = got.cols.reshape(-1, geo.L)[geo.n_segs :]
        # the tail's columns sit in padding segments (rem 0, masked in K1)
        assert (cols == sentinel).any()
        assert not got.rem.reshape(-1)[geo.n_segs :].any()
        _assert_bits_equal(got.cols, ref[1])


@pytest.mark.parametrize(
    "call, match",
    [
        (lambda: k5.unpack_nibbles(torch.zeros(4, dtype=torch.int8)), "uint8"),
        (lambda: k5.device_pack_presorted(
            torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int8),
            torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32), 1, 4, 0.5,
        ), "ids must be"),
        (lambda: k5.device_scatter_pack(
            torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int64),
            torch.zeros(4, dtype=torch.int8), torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), 1, 4, 0.5,
        ), "cols must be int32"),
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(call, match):
    with pytest.raises((TypeError, ValueError), match=match):
        call()


@pytest.mark.parametrize("key_bound, passes", [(1, 1), (256, 1), (257, 2), (26_745, 2), (70_001, 3), (2**31, 4)])
def test_radix_passes(key_bound, passes):
    assert k5.radix_passes(key_bound) == passes
