"""The port's host packing (``predictionio_tpu_torch.ops.als``, copied as
numpy) against the JAX package's, byte for byte, and the segment-layout
properties the reference's own tests hold (tests/test_als.py
TestPackSegments), plus the factor init and the regularizer vectors.

Tolerance: none. The same inputs must give the same bytes.
"""

import numpy as np
import pytest

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops.als_reference import init_item_factors
from predictionio_tpu_torch.ops import als as port_als


def synthetic(n_users=60, n_items=40, k=4, density=0.4, seed=1):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n_users, k)) / np.sqrt(k)
    V = rng.standard_normal((n_items, k)) / np.sqrt(k)
    mask = rng.random((n_users, n_items)) < density
    u, i = np.nonzero(mask)
    r = (U @ V.T + 3.0)[u, i]
    return u.astype(np.int32), i.astype(np.int32), r.astype(np.float32)


def dense_mask(side):
    L = side.cols.shape[2]
    return (np.arange(L)[None, None, :] < side.rem[:, :, None]).astype(np.uint8)


def assert_same_pack(port, ref):
    assert port.n_rows == ref.n_rows
    for name in ("seg_rows", "cols", "vals", "rem", "counts"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=name)


def _long_row():
    return np.zeros(100, np.int32), np.arange(100, dtype=np.int32), np.ones(100, np.float32)


def _empty_rows():
    return np.array([5], np.int32), np.array([0], np.int32), np.array([1.0], np.float32)


@pytest.mark.parametrize(
    "case, n_rows, kwargs",
    [
        ("synthetic", 60, dict(segment_length=8, pad_segments_to=8)),
        ("synthetic", 60, dict(segment_length=8, chunk_slots=64)),
        ("long_row", 1, dict(segment_length=16)),
        ("empty_rows", 10, dict(segment_length=4)),
        ("skewed", 300, dict(segment_length=16, chunk_slots=256)),
    ],
)
def test_pack_segments_matches_jax_byte_for_byte(case, n_rows, kwargs):
    if case == "synthetic":
        u, i, r = synthetic()
    elif case == "long_row":
        u, i, r = _long_row()
    elif case == "empty_rows":
        u, i, r = _empty_rows()
    else:
        rng = np.random.default_rng(4)
        u = (rng.zipf(1.4, 5000) % n_rows).astype(np.int32)
        i = rng.integers(0, 50, 5000).astype(np.int32)
        r = (rng.integers(1, 11, 5000) / 2).astype(np.float32)
    port = port_als.pack_segments(u, i, r, n_rows, **kwargs)
    ref = jax_als.pack_segments(u, i, r, n_rows, **kwargs)
    assert_same_pack(port, ref)
    assert int(dense_mask(port).sum()) == len(u)


def test_segments_cover_all_ratings():
    u, i, r = synthetic()
    L = 8
    side = port_als.pack_segments(u, i, r, 60, segment_length=L, pad_segments_to=8)
    assert side.seg_rows.shape[1] % 8 == 0
    seg_rows = side.seg_rows.reshape(-1)
    cols = side.cols.reshape(-1, L)
    vals = side.vals.reshape(-1, L)
    mask = dense_mask(side).reshape(-1, L)
    for rid in range(60):
        sel = seg_rows == rid
        got_cols = cols[sel][mask[sel] > 0]
        assert sorted(got_cols.tolist()) == sorted(i[u == rid].tolist())
        got = dict(zip(got_cols.tolist(), vals[sel][mask[sel] > 0].tolist()))
        for cc, vv in zip(i[u == rid].tolist(), r[u == rid].tolist()):
            assert got[cc] == pytest.approx(vv)


def test_long_row_spans_consecutive_segments():
    side = port_als.pack_segments(*_long_row(), 1, segment_length=16)
    seg_rows = side.seg_rows.reshape(-1)
    assert int((seg_rows == 0).sum()) == 7  # 6 full + 1 partial
    assert int(dense_mask(side).sum()) == 100


def test_empty_rows_get_no_segments():
    side = port_als.pack_segments(*_empty_rows(), 10, segment_length=4)
    seg_rows = side.seg_rows.reshape(-1)
    assert int((seg_rows == 5).sum()) == 1
    assert side.counts[5] == 1 and side.counts.sum() == 1
    assert (seg_rows[seg_rows != 5] == 10).all()


def test_chunk_grid_bounds_slots():
    u, i, r = synthetic()
    side = port_als.pack_segments(u, i, r, 60, segment_length=8, chunk_slots=64)
    assert side.cols.shape[1] * side.cols.shape[2] <= 64
    assert int(dense_mask(side).sum()) == len(u)


@pytest.mark.parametrize("n", [0, 1, 7, 15, 16, 17, 138_493, 138_494, 26_745, 2**20 + 3])
def test_bucketing_and_padded_rows_match_jax(n):
    assert port_als._bucket_count(n) == jax_als._bucket_count(n)
    for shards in (1, 8):
        assert port_als._padded_rows(n, shards) == jax_als._padded_rows(n, shards)


@pytest.mark.parametrize("cap", [4, 16, 128])
def test_auto_segment_length_matches_jax(cap):
    u, _, _ = synthetic()
    counts = np.bincount(u, minlength=70)
    assert port_als.auto_segment_length(u, 70, cap) == jax_als.auto_segment_length(u, 70, cap)
    assert port_als.auto_segment_length(
        None, 70, cap, counts=counts
    ) == jax_als.auto_segment_length(None, 70, cap, counts=counts)
    empty = np.zeros(5, np.int64)
    assert port_als.auto_segment_length(
        None, 5, cap, counts=empty
    ) == jax_als.auto_segment_length(None, 5, cap, counts=empty)


@pytest.mark.parametrize("reg_mode", ["weighted", "plain"])
def test_factor_init_and_lam_match_jax(reg_mode):
    kw = dict(rank=5, seed=9, reg=0.07, reg_mode=reg_mode)
    pc, jc = port_als.ALSConfig(**kw), jax_als.ALSConfig(**kw)
    for a, b in zip(port_als._factor_init_host(13, 17, pc, 1), jax_als._factor_init_host(13, 17, jc, 1)):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    counts = np.array([0, 3, 1, 0, 7], np.int32)
    for a, b in zip(port_als._lam_obs_host(counts, 5, 8, pc), jax_als._lam_obs_host(counts, 5, 8, jc)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_init_scheme_matches_oracle():
    # the item init is the oracle's (tests/test_mllib_parity.py)
    _, Y0 = port_als._factor_init_host(3, 17, port_als.ALSConfig(rank=5, seed=9), 1)
    np.testing.assert_allclose(Y0[:17], init_item_factors(17, 5, seed=9), rtol=1e-6)
    assert not Y0[17:].any()


def test_config_fields_match_jax():
    import dataclasses

    port = {f.name: f.default for f in dataclasses.fields(port_als.ALSConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jax_als.ALSConfig)}
    assert port == ref
    with pytest.raises(ValueError):
        port_als.ALSConfig(reg_mode="other")
