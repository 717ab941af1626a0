"""K1 parity: the port's normal equations (``ops/normal_eq.py``; on the CPU
its plain twin) against the JAX package's ``_accumulate_systems`` on a
pack with multi-segment rows, empty rows and sentinel padding; and the
kernel's group plan, replayed in numpy exactly as ``csrc/normal_eq.cu``
walks it, against the twin.

Tolerance: rtol 1e-5 on the row's scale, atol 1e-6: XLA and PyTorch sum
in different orders in float32. The scale of A's row is its largest
diagonal entry, which bounds every Σ|y_i y_j| of the row; that of b's row
is sqrt(Σ v² · that diagonal), which bounds every Σ|v y_i| (Cauchy-Schwarz).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import normal_eq as k1

RTOL, ATOL = 1e-5, 1e-6


def _pack(seed, n_rows=40, n_cols=30, nnz=1500, L=8, chunk_slots=128):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_rows, nnz).astype(np.int32)
    u[: nnz // 3] = 3  # one row of many segments: more than one group
    u[u == 7] = 8  # an empty row
    i = rng.integers(0, n_cols, nnz).astype(np.int32)
    r = (rng.integers(1, 11, nnz) / 2).astype(np.float32)
    side = port_als.pack_segments(u, i, r, n_rows, L, 1, chunk_slots)
    return side, port_als._padded_rows(n_rows, 1), port_als._padded_rows(n_cols, 1)


def _assert_systems_close(side, A, b, A_ref, b_ref):
    diag = np.abs(np.diagonal(A_ref, axis1=1, axis2=2)).max(axis=1)
    np.testing.assert_array_less(
        np.abs(A - A_ref).max(axis=(1, 2)), ATOL + RTOL * diag
    )
    vsq = np.bincount(
        side.seg_rows.reshape(-1), weights=np.square(side.vals).sum(-1).reshape(-1),
        minlength=len(b),
    )[: len(b)]
    np.testing.assert_array_less(
        np.abs(b - b_ref).max(axis=1), ATOL + RTOL * np.sqrt(vsq * diag)
    )


@pytest.mark.parametrize("k", [1, 4, 33])
def test_plain_twin_matches_jax_accumulate_systems(k):
    side, R, n_cols = _pack(k)
    assert side.seg_rows.shape[0] > 1  # several chunks
    rng = np.random.default_rng(100 + k)
    Y = rng.normal(size=(n_cols, k)).astype(np.float32)
    pack = port_als.device_pack(side, R, n_cols, torch.device("cpu"))
    assert pack.plan.n_partials > 0  # the long row is combined
    A, b = k1.normal_eq(torch.from_numpy(Y), pack)
    A_ref, b_ref = jax_als._accumulate_systems(
        jnp.asarray(Y), jnp.asarray(side.seg_rows), jnp.asarray(side.cols),
        jnp.asarray(side.vals), jnp.asarray(side.rem), 1.0, R,
        implicit=False, compute_dtype="float32",
    )
    A_ref, b_ref = np.asarray(A_ref), np.asarray(b_ref)
    assert A.shape == (R, k, k) and b.shape == (R, k)
    _assert_systems_close(side, A.numpy(), b.numpy(), A_ref, b_ref)
    # empty, sentinel and padding rows hold zeros
    empty = np.setdiff1d(np.arange(R), side.seg_rows[side.rem > 0])
    assert 7 in empty and side.n_rows in empty
    assert not A.numpy()[empty].any() and not b.numpy()[empty].any()


def _replay_plan(Y, side, plan, R):
    """The kernel's walk of the plan in numpy: each group sums its
    segments' valid slots, single-group rows write directly, the others
    write partials that the combine pass sums in slot order."""
    groups, c_rows, c_start, n_partials = plan
    k = Y.shape[1]
    cols = side.cols.reshape(-1, side.cols.shape[-1])
    vals = side.vals.reshape(cols.shape)
    rem = side.rem.reshape(-1)
    A = np.full((R, k, k), np.nan, np.float64)
    b = np.full((R, k), np.nan, np.float64)
    PA = np.full((max(n_partials, 1), k, k), np.nan)
    Pb = np.full((max(n_partials, 1), k), np.nan)
    for row, seg0, nseg, slot in groups.T:
        a = np.zeros((k, k))
        bb = np.zeros(k)
        for s in range(seg0, seg0 + nseg):
            y = Y[cols[s, : rem[s]]].astype(np.float64)
            a += y.T @ y
            bb += y.T @ vals[s, : rem[s]]
        if slot < 0:
            assert np.isnan(A[row]).all(), "a row written twice"
            A[row], b[row] = a, bb
        else:
            PA[slot], Pb[slot] = a, bb
    for m, row in enumerate(c_rows):
        assert np.isnan(A[row]).all(), "a combined row also written directly"
        A[row] = PA[c_start[m]:c_start[m + 1]].sum(axis=0)
        b[row] = Pb[c_start[m]:c_start[m + 1]].sum(axis=0)
    return A, b


@pytest.mark.parametrize("group", [1, 2, k1.GROUP_SEGMENTS])
def test_group_plan_replay_matches_twin(group):
    side, R, n_cols = _pack(5)
    k = 4
    Y = np.random.default_rng(9).normal(size=(n_cols, k)).astype(np.float32)
    plan = k1.plan_groups(side.seg_rows, side.rem, R, group)
    groups, _, c_start, n_partials = plan
    # every real segment is in exactly one group, every row has a group
    covered = np.concatenate([np.arange(s, s + n) for _, s, n, _ in groups.T])
    real = np.flatnonzero(side.rem.reshape(-1) > 0)
    np.testing.assert_array_equal(np.sort(covered), real)
    assert set(groups[0].tolist()) == set(range(R))
    assert (groups[2] <= group).all() and c_start[-1] == n_partials
    A, b = _replay_plan(Y, side, plan, R)
    assert not np.isnan(A).any() and not np.isnan(b).any()
    pack = port_als.device_pack(side, R, n_cols, torch.device("cpu"))
    A_t, b_t = k1.normal_eq_plain(
        torch.from_numpy(Y), pack.seg_rows, pack.cols, pack.vals, pack.rem, R
    )
    _assert_systems_close(side, A_t.numpy(), b_t.numpy(), A, b)


def test_plan_rejects_rows_out_of_order():
    seg_rows = np.array([[0, 2, 1, 3]], np.int32)
    rem = np.ones((1, 4), np.int32)
    with pytest.raises(ValueError, match="ordered"):
        k1.plan_groups(seg_rows, rem, 4)
    with pytest.raises(ValueError, match="range"):
        k1.plan_groups(np.array([[0, 5]]), np.ones((1, 2)), 4)


def test_cpu_tensors_route_to_plain_twin_and_count():
    side, R, n_cols = _pack(2)
    pack = port_als.device_pack(side, R, n_cols, torch.device("cpu"))
    before = k1.LAUNCHES.snapshot()
    k1.normal_eq(torch.zeros((n_cols, 3)), pack)
    after = k1.LAUNCHES.snapshot()
    assert after["normal_eq_plain"] == before["normal_eq_plain"] + 1
    assert after["normal_eq"] == before["normal_eq"]
    with pytest.raises(ValueError, match="rows"):
        k1.normal_eq(torch.zeros((n_cols - 1, 3)), pack)
    with pytest.raises(ValueError):
        k1.normal_eq(torch.zeros((n_cols, 3), dtype=torch.float64), pack)
    with pytest.raises(ValueError, match="out of range"):
        port_als.device_pack(side, R, n_cols - 5, torch.device("cpu"))
