"""The iALS++ subspace solver in the port (``solver="subspace"``, K11)
against the JAX package on the CPU (``device="cpu"``: every kernel by its
plain twin): K11a's twin against a numpy transcription of the reference's
block einsums, one half-step against JAX's ``_solve_side_subspace``,
``train_als`` against JAX's with its per-sweep and per-block telemetry,
``block_size == rank`` against the exact solver, ranking parity with the
float64 oracle, repeat runs, the streaming route, and rows without
observations.

Inputs are made from numpy seeds at 80 users x 50 items, rank 8, with
segments of 8 slots, so a heavy item spans several of K1's groups (the
plan the kernel walks; the twins take the segments as they are).
Tolerances, stated beforehand:
- K11a and one half-step: rtol 1e-5, atol 1e-6. Both sides are float32;
  XLA and PyTorch sum the rank and the slots in different orders, and a
  b x b Cholesky rounds in other places.
- ``train_als`` after 3 sweeps: rtol 2e-4, atol 2e-5 on the factors (the
  reference's own bar for two float32 programs of one algorithm,
  tests/test_als.py:468); 3 sweeps of 2 x k/b dependent block solves carry
  each block's rounding into the next. Telemetry rows rtol 1e-5: RMS
  values of whole arrays, where rounding averages out.
- ``block_size == rank`` against the exact solver: rtol 2e-4, atol 2e-5
  (the same fixed point reached by x + A⁻¹(b − A x) instead of A⁻¹ b, the
  reference's test).
- against the float64 oracle: hit-rate@10 within 2 points of the oracle's
  (the reference's gate, tests/test_mllib_parity.py:172: the blocked
  solver reaches another local solution, so factors are not compared).
- repeat runs and the two training routes: bit for bit (one program on
  one input).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops.als_reference import train_als_reference
from predictionio_tpu_torch.data.storage.columnar import ColumnarStream
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import streaming as port_streaming
from predictionio_tpu_torch.ops import subspace as k11

RTOL, ATOL = 1e-5, 1e-6
N_USERS, N_ITEMS, NNZ, RANK = 80, 50, 1600, 8
CFG = dict(rank=RANK, iterations=3, reg=0.05, alpha=0.5, seed=3, segment_length=8,
           chunk_slots=256, solver="subspace")


@pytest.fixture(scope="module")
def ratings():
    """Half-step ratings, a heavy item (several groups of segments), a
    user and an item without ratings, repeated events."""
    rng = np.random.default_rng(0)
    u = rng.integers(0, N_USERS, NNZ).astype(np.int32)
    i = rng.integers(0, N_ITEMS, NNZ).astype(np.int32)
    i[:300] = 3
    u[u == 11] = 12
    i[i == 7] = 8
    r = (rng.integers(1, 11, NNZ) / 2).astype(np.float32)
    return u, i, r


def _side(rows, cols, r, n_rows=N_USERS, n_cols=N_ITEMS):
    side = port_als.pack_segments(rows, cols, r, n_rows, CFG["segment_length"], 1,
                                  CFG["chunk_slots"])
    R, n_y = port_als._padded_rows(n_rows, 1), port_als._padded_rows(n_cols, 1)
    return side, R, n_y


def _factors(R, n_y, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((R, RANK)).astype(np.float32) * 0.3
    Y = rng.standard_normal((n_y, RANK)).astype(np.float32) * 0.3
    return X, Y


def _weights(vals, mask, implicit, alpha):
    if implicit:
        aw = alpha * np.abs(vals) * mask
        bw = (vals > 0).astype(np.float32) * mask * (1.0 + alpha * np.abs(vals))
    else:
        aw, bw = mask, vals * mask
    return aw.astype(np.float32), bw.astype(np.float32)


@pytest.mark.parametrize("implicit", [False, True])
def test_k11a_twin_matches_the_reference_block_einsums(ratings, implicit):
    """Every block of the rank on the item side: the twin's A and r against
    the reference's per-chunk einsums (:704-724) written in numpy, with the
    multi-group heavy row and the empty row."""
    u, i, r = ratings
    side, R, n_y = _side(i, u, r, N_ITEMS, N_USERS)
    X, Y = _factors(R, n_y)
    pack = port_als.device_pack(side, R, n_y, torch.device("cpu"))
    assert pack.plan.n_partials > 0  # a row spans several groups
    L = side.cols.shape[-1]
    for b in (2, 4):
        for s0 in range(0, RANK, b):
            A_ref = np.zeros((R, b, b), np.float32)
            r_ref = np.zeros((R, b), np.float32)
            for c in range(side.seg_rows.shape[0]):
                rows = side.seg_rows[c]
                mask = (np.arange(L)[None, :] < side.rem[c][:, None]).astype(np.float32)
                Yg = Y[side.cols[c]]
                Yb = Yg[:, :, s0 : s0 + b]
                d = np.einsum("slk,sk->sl", Yg, X[rows])
                aw, bw = _weights(side.vals[c], mask, implicit, 0.5)
                np.add.at(A_ref, rows, np.einsum("slb,sl,slc->sbc", Yb, aw, Yb))
                np.add.at(r_ref, rows, np.einsum("sl,slb->sb", bw - aw * d, Yb))
            A, rv = k11.subspace_accumulate(
                torch.from_numpy(Y), torch.from_numpy(X), pack, s0, b, implicit, 0.5
            )
            scale = np.abs(A_ref).max()
            np.testing.assert_allclose(A.numpy(), A_ref, rtol=RTOL, atol=ATOL * scale)
            np.testing.assert_allclose(rv.numpy(), r_ref, rtol=RTOL,
                                       atol=ATOL * np.abs(r_ref).max())
            assert not A[7].any() and not rv[7].any()  # the item without ratings


@pytest.mark.parametrize("implicit", [False, True])
def test_half_step_matches_jax_solve_side_subspace(ratings, implicit):
    u, i, r = ratings
    side, R, n_y = _side(u, i, r)
    X, Y = _factors(R, n_y)
    counts = np.bincount(u, minlength=N_USERS)
    cfg = port_als.ALSConfig(**dict(CFG, implicit_prefs=implicit, block_size=2))
    lam, obs = port_als._lam_obs_host(counts, N_USERS, R, cfg)
    G = Y.T @ Y if implicit else np.zeros((RANK, RANK), np.float32)
    want, deltas = jax_als._solve_side_subspace(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(G),
        tuple(jnp.asarray(a) for a in (side.seg_rows, side.cols, side.vals, side.rem)),
        jnp.asarray(lam), jnp.asarray(obs), 0.5,
        implicit=implicit, compute_dtype="float32", block_size=2,
    )
    pack = port_als.device_pack(side, R, n_y, torch.device("cpu"))
    sums = torch.zeros((RANK // 2, 2), dtype=torch.float32)
    before = k11.LAUNCHES.snapshot()
    got = port_als._solve_side_subspace(
        torch.from_numpy(X.copy()), torch.from_numpy(Y), torch.from_numpy(G) if implicit else None,
        pack, torch.from_numpy(lam), torch.from_numpy(obs), 0.5, implicit, 2, sums,
    )
    after = k11.LAUNCHES.snapshot()
    assert after["subspace_accumulate_plain"] - before["subspace_accumulate_plain"] == RANK // 2
    assert after["subspace_block_solve_plain"] - before["subspace_block_solve_plain"] == RANK // 2
    assert after["subspace_accumulate"] == before["subspace_accumulate"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    block_rms = np.sqrt(sums[:, 0].numpy() / (R * 2))
    np.testing.assert_allclose(block_rms, np.asarray(deltas), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy()[11], X[11])  # no ratings: kept
    assert sums[-1, 1] > 0 and not sums[:-1, 1].any()


def _telemetry(t, key, cols):
    return np.array([[row[c] for c in cols] for row in t[key]], np.float64)


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("block_size", [1, 2, 4])
def test_train_als_matches_jax(ratings, block_size, implicit):
    u, i, r = ratings
    cfg = dict(CFG, block_size=block_size, implicit_prefs=implicit)
    t_port, t_jax = {}, {}
    port = port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**cfg),
                              device="cpu", timings=t_port)
    ref = jax_als.train_als(u, i, r, N_USERS, N_ITEMS, jax_als.ALSConfig(**cfg), timings=t_jax)
    for a, b in ((port.user_factors, ref.user_factors), (port.item_factors, ref.item_factors)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    cols = ("dx", "dy", "x_rms", "y_rms") + (("objective",) if implicit else ())
    assert len(t_port["sweep_telemetry"]) == 3
    np.testing.assert_allclose(_telemetry(t_port, "sweep_telemetry", cols),
                               _telemetry(t_jax, "sweep_telemetry", cols), rtol=1e-5)
    assert len(t_port["block_telemetry"]) == 3 * RANK // block_size
    cols = ("sweep", "block", "dx", "dy")
    np.testing.assert_allclose(_telemetry(t_port, "block_telemetry", cols),
                               _telemetry(t_jax, "block_telemetry", cols), rtol=1e-5)


def test_telemetry_keeps_the_first_slots_sweeps():
    """Past TELEMETRY_SLOTS sweeps the rows drop, per sweep and per block,
    as the reference's do."""
    rng = np.random.default_rng(2)
    u = rng.integers(0, 20, 200).astype(np.int32)
    i = rng.integers(0, 12, 200).astype(np.int32)
    r = rng.integers(1, 6, 200).astype(np.float32)
    cfg = dict(rank=4, iterations=port_als.TELEMETRY_SLOTS + 2, reg=0.05, seed=1,
               solver="subspace", block_size=2)
    t_port, t_jax = {}, {}
    port_als.train_als(u, i, r, 20, 12, port_als.ALSConfig(**cfg), device="cpu", timings=t_port)
    jax_als.train_als(u, i, r, 20, 12, jax_als.ALSConfig(**cfg), timings=t_jax)
    assert len(t_port["sweep_telemetry"]) == len(t_jax["sweep_telemetry"]) == 64
    assert len(t_port["block_telemetry"]) == len(t_jax["block_telemetry"]) == 128
    np.testing.assert_allclose(_telemetry(t_port, "block_telemetry", ("dx", "dy")),
                               _telemetry(t_jax, "block_telemetry", ("dx", "dy")),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("implicit", [False, True])
def test_full_rank_block_matches_exact(ratings, implicit):
    """block_size == rank: one block whose residual-form solve is the exact
    normal-equation update (the reference's tests/test_als.py:468)."""
    u, i, r = ratings
    cfg = port_als.ALSConfig(**dict(CFG, block_size=RANK, implicit_prefs=implicit))
    sub = port_als.train_als(u, i, r, N_USERS, N_ITEMS, cfg, device="cpu")
    exact = port_als.train_als(u, i, r, N_USERS, N_ITEMS,
                               dataclasses.replace(cfg, solver="exact", block_size=0),
                               device="cpu")
    np.testing.assert_allclose(sub.user_factors, exact.user_factors, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(sub.item_factors, exact.item_factors, rtol=2e-4, atol=2e-5)


def _hit_rate_at_n(X, Y, u, i, n=10):
    """The reference's in-matrix ranking gate (tests/test_mllib_parity.py:
    151): per user, the observed items in the model's top n."""
    scores = np.asarray(X, np.float64) @ np.asarray(Y, np.float64).T
    hits, total = 0, 0
    for uu in np.unique(u):
        obs = set(i[u == uu].tolist())
        top = set(np.argsort(-scores[uu])[:n].tolist())
        hits += len(obs & top)
        total += min(len(obs), n)
    return hits / total


def test_hit_rate_matches_the_float64_oracle():
    """The reference's ranking parity (tests/test_mllib_parity.py:172) on
    its own data: the implicit blocked solver within 2 points of the
    oracle's exact implicit ALS."""
    rng = np.random.default_rng(5)
    U = rng.standard_normal((N_USERS, 6)) / np.sqrt(6)
    V = rng.standard_normal((N_ITEMS, 6)) / np.sqrt(6)
    base = U @ V.T
    base = 1 + 4 * (base - base.min()) / (base.max() - base.min())
    w = 1.0 / (1.0 + np.arange(N_ITEMS))
    u = rng.integers(0, N_USERS, 1500).astype(np.int32)
    i = rng.choice(N_ITEMS, size=1500, p=w / w.sum()).astype(np.int32)
    _, first = np.unique(u.astype(np.int64) * N_ITEMS + i, return_index=True)
    u, i = u[first], i[first]
    r = np.clip(np.round(base[u, i] + 0.3 * rng.standard_normal(len(u))), 1, 5).astype(np.float32)
    X, Y = train_als_reference(u, i, r, N_USERS, N_ITEMS, rank=8, iterations=10, reg=0.05,
                               alpha=2.0, implicit_prefs=True, reg_mode="weighted", seed=0)
    model = port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(
        rank=8, iterations=10, reg=0.05, alpha=2.0, implicit_prefs=True, seed=0,
        solver="subspace", block_size=2), device="cpu")
    hr_ref = _hit_rate_at_n(X, Y, u, i)
    hr_sub = _hit_rate_at_n(model.user_factors, model.item_factors, u, i)
    assert hr_ref > 0.6, hr_ref
    assert hr_sub >= hr_ref - 0.02, (hr_sub, hr_ref)


def test_repeat_runs_are_bit_identical(ratings):
    u, i, r = ratings
    cfg = port_als.ALSConfig(**dict(CFG, block_size=2, implicit_prefs=True))
    runs = [port_als.train_als(u, i, r, N_USERS, N_ITEMS, cfg, device="cpu", timings={})
            for _ in range(2)]
    for name in ("user_factors", "item_factors"):
        np.testing.assert_array_equal(getattr(runs[0], name), getattr(runs[1], name))


@pytest.mark.parametrize("implicit", [False, True])
def test_streaming_and_direct_routes_are_bit_identical(ratings, implicit):
    u, i, r = ratings
    cfg = port_als.ALSConfig(**dict(CFG, block_size=4, implicit_prefs=implicit))
    names = np.array([f"u{n}" for n in range(N_USERS)] + [f"i{n}" for n in range(N_ITEMS)], object)
    t_codes = (i + N_USERS).astype(np.int32)
    cuts = [0, 500, 1100, NNZ]
    batches = [(u[a:b], t_codes[a:b], r[a:b]) for a, b in zip(cuts, cuts[1:])]
    t_stream, t_direct = {}, {}
    got = port_streaming.train_als_streaming(
        ColumnarStream(iter(batches), lambda: names), cfg, device="cpu", timings=t_stream)
    ru = np.array([got.user_index.get(f"u{n}", -1) for n in range(N_USERS)])
    ri = np.array([got.item_index.get(f"i{n}", -1) for n in range(N_ITEMS)])
    direct = port_als.train_als(ru[u], ri[i], r, len(got.user_index), len(got.item_index), cfg,
                                device="cpu", timings=t_direct)
    np.testing.assert_array_equal(direct.user_factors, got.arrays.user_factors)
    np.testing.assert_array_equal(direct.item_factors, got.arrays.item_factors)
    assert t_stream["sweep_telemetry"] == t_direct["sweep_telemetry"]
    assert t_stream["block_telemetry"] == t_direct["block_telemetry"]


def test_rows_without_observations_keep_their_init(ratings):
    """User 11 and item 7 have no ratings: the user row stays at its zero
    init and the item row at the seeded init, whatever G and the blocks
    do (the reference zeroes their deltas before the update lands)."""
    u, i, r = ratings
    cfg = port_als.ALSConfig(**dict(CFG, block_size=2, implicit_prefs=True))
    model = port_als.train_als(u, i, r, N_USERS, N_ITEMS, cfg, device="cpu")
    _, Y0 = port_als._factor_init_host(N_USERS, N_ITEMS, cfg, 1)
    assert not model.user_factors[11].any()
    np.testing.assert_array_equal(model.item_factors[7], Y0[7])
    assert model.user_factors[12].any() and model.item_factors[8].any()


def test_wrappers_check_their_inputs_and_bf16_still_raises(ratings):
    """The wrappers' checks; the name is from when bfloat16 raised, and its
    last case now holds that bfloat16 trains."""
    u, i, r = ratings
    side, R, n_y = _side(u, i, r)
    pack = port_als.device_pack(side, R, n_y, torch.device("cpu"))
    X, Y = (torch.from_numpy(a) for a in _factors(R, n_y))
    with pytest.raises(ValueError, match="block"):
        k11.subspace_accumulate(Y, X, pack, 1, 2)  # not a block boundary
    with pytest.raises(ValueError, match="block"):
        k11.subspace_accumulate(Y, X, pack, 0, 3)  # 3 does not divide 8
    A, rv = k11.subspace_accumulate(Y, X, pack, 0, 2)
    lam, obs = torch.ones(R), torch.ones(R, dtype=torch.bool)
    with pytest.raises(TypeError):
        k11.subspace_block_solve(A, rv, X, lam, obs.int(), 0)
    with pytest.raises(ValueError):
        k11.subspace_block_solve(A, rv, X, lam, obs, 0, G=torch.zeros(2, 2))
    with pytest.raises(ValueError):
        k11.subspace_block_solve(A, rv, X, lam, obs, 0, sums=torch.zeros(3))
    # bfloat16 trains (it raised before K11a-bf16 was ported): the block
    # systems come from K11a's bfloat16 twin, and the result is not the
    # float32 training's
    before = k11.LAUNCHES.snapshot()["subspace_accumulate_bf16_plain"]
    bf16 = port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(
        **dict(CFG, block_size=2, compute_dtype="bfloat16")), device="cpu")
    assert k11.LAUNCHES.snapshot()["subspace_accumulate_bf16_plain"] - before == 2 * 4 * CFG["iterations"]
    f32 = port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(
        **dict(CFG, block_size=2)), device="cpu")
    assert np.isfinite(bf16.user_factors).all()
    assert not np.array_equal(bf16.user_factors, f32.user_factors)
