"""The regularizer grid in the port (``train_als_grid``, K13) against the
JAX package on the CPU (``device="cpu"``: every kernel by its plain twin):
K13's twins against the reference's ``_run_iterations_grid`` on one sweep,
``train_als_grid`` against JAX's per variant, against the port's serial
``train_als`` per regularizer, and the chunked serving of large batches.

Inputs are made from numpy seeds at 60 users x 40 items, rank 4 (the
reference's grid test, tests/test_als.py:374, and its rank-4-plus-noise
ratings) with segments of 8 slots, so a heavy item spans several segments.
Tolerances, stated beforehand:
- the twins on one sweep, and ``train_als_grid`` after 4 sweeps against
  JAX and against the serial ``train_als``: rtol 2e-4, atol 2e-5, the
  reference's own bar for its grid against its serial runs (float32
  programs that sum in different orders; tests/test_als.py:394).
- the grid on ratings sorted by user against ``train_als``: bit for bit.
  The wire route packs each item's ratings in user order, the grid's host
  pack in the order given: sorted by user, both sum in one order.
- chunked serving: equal to one launch over the whole batch (rows are
  independent).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import grid as k13

RTOL, ATOL = 2e-4, 2e-5
N_USERS, N_ITEMS, RANK = 60, 40, 4
CFG = dict(rank=RANK, iterations=4, seed=3, segment_length=8, chunk_slots=256)


@pytest.fixture(scope="module")
def ratings():
    """Rank-4 ratings with noise at density 0.4 (the reference's
    ``synthetic``), a heavy item rated by every user, a user and an item
    without ratings, in a shuffled scan order."""
    rng = np.random.default_rng(7)
    U = rng.standard_normal((N_USERS, RANK)) / np.sqrt(RANK)
    V = rng.standard_normal((N_ITEMS, RANK)) / np.sqrt(RANK)
    mask = rng.random((N_USERS, N_ITEMS)) < 0.4
    mask[:, 3] = True
    mask[11, :] = False
    mask[:, 7] = False
    u, i = np.nonzero(mask)
    r = (U @ V.T + 3.0)[u, i] + 0.1 * rng.standard_normal(len(u))
    order = rng.permutation(len(u))
    return u[order].astype(np.int32), i[order].astype(np.int32), r[order].astype(np.float32)


def _configs(implicit, reg_mode):
    kw = dict(CFG, implicit_prefs=implicit, reg_mode=reg_mode, alpha=0.5)
    return jax_als.ALSConfig(**kw), port_als.ALSConfig(**kw)


REGS = (0.01, 0.1, 1.0)


@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
@pytest.mark.parametrize("reg_mode", ["weighted", "plain"])
def test_k13_twins_match_the_reference_grid_on_one_sweep(ratings, implicit, reg_mode):
    """One sweep of the port's grid loop (K13a and K13b by their twins,
    K12a per variant in implicit mode) against the reference's
    ``_run_iterations_grid`` on the same packs, λ rows and init."""
    u, i, r = ratings
    jcfg, _ = _configs(implicit, reg_mode)
    sides = [
        port_als.pack_segments(rows, cols, r, n, 8, 1, 256)
        for rows, cols, n in ((u, i, N_USERS), (i, u, N_ITEMS))
    ]
    R_u, R_i = port_als._padded_rows(N_USERS, 1), port_als._padded_rows(N_ITEMS, 1)
    rng = np.random.default_rng(1)
    X0 = np.zeros((len(REGS), R_u, RANK), np.float32)
    Y0 = np.abs(rng.standard_normal((len(REGS), R_i, RANK))).astype(np.float32) * 0.5
    Y0[:, N_ITEMS:] = 0.0
    lam_obs = [
        [port_als._lam_obs_host(s.counts, s.n_rows, R,
                                port_als.ALSConfig(reg=reg, reg_mode=reg_mode))
         for reg in REGS]
        for s, R in zip(sides, (R_u, R_i))
    ]
    lams = [np.stack([lo[0] for lo in side]) for side in lam_obs]
    obs = [side[0][1] for side in lam_obs]

    Xj, Yj = jax_als._run_iterations_grid(
        jnp.asarray(X0), jnp.asarray(Y0),
        *[(jnp.asarray(s.seg_rows), jnp.asarray(s.cols), jnp.asarray(s.vals),
           jnp.asarray(s.rem)) for s in sides],
        jnp.asarray(lams[0]), jnp.asarray(lams[1]), jnp.asarray(obs[0]), jnp.asarray(obs[1]),
        jcfg.alpha, jnp.int32(1), implicit=implicit, compute_dtype="float32",
    )
    packs = [
        port_als.device_pack(s, R, n_y, torch.device("cpu"))
        for s, R, n_y in ((sides[0], R_u, R_i), (sides[1], R_i, R_u))
    ]
    k13.LAUNCHES.reset()
    Xp, Yp = port_als._run_iterations_grid(
        torch.from_numpy(X0), torch.from_numpy(Y0), *packs,
        torch.from_numpy(lams[0]), torch.from_numpy(lams[1]),
        torch.from_numpy(obs[0]), torch.from_numpy(obs[1]),
        jcfg.alpha, 1, implicit,
    )
    assert k13.LAUNCHES.snapshot() == {
        "normal_eq_variants": 0, "normal_eq_variants_plain": 2,
        "normal_eq_variants_bf16": 0, "normal_eq_variants_bf16_plain": 0,
        "spd_solve_variants": 0, "spd_solve_variants_plain": 2,
    }
    np.testing.assert_allclose(Xp.numpy(), np.asarray(Xj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(Yp.numpy(), np.asarray(Yj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_variants", [1, 2, 3])
@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
@pytest.mark.parametrize("reg_mode", ["weighted", "plain"])
def test_train_als_grid_matches_the_reference_grid(ratings, n_variants, implicit, reg_mode):
    u, i, r = ratings
    jcfg, pcfg = _configs(implicit, reg_mode)
    regs = list(REGS[:n_variants])
    want = jax_als.train_als_grid(u, i, r, N_USERS, N_ITEMS, jcfg, regs)
    got = port_als.train_als_grid(u, i, r, N_USERS, N_ITEMS, pcfg, regs, device="cpu")
    assert len(got) == n_variants
    for g, w in zip(got, want):
        assert g.user_factors.shape == (N_USERS, RANK)
        assert g.item_factors.shape == (N_ITEMS, RANK)
        np.testing.assert_allclose(g.user_factors, w.user_factors, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.item_factors, w.item_factors, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
def test_train_als_grid_matches_serial_train_als_per_regularizer(ratings, implicit):
    u, i, r = ratings
    _, pcfg = _configs(implicit, "weighted")
    grid = port_als.train_als_grid(u, i, r, N_USERS, N_ITEMS, pcfg, list(REGS), device="cpu")
    for g, reg in zip(grid, REGS):
        single = port_als.train_als(u, i, r, N_USERS, N_ITEMS,
                                    dataclasses.replace(pcfg, reg=reg), device="cpu")
        np.testing.assert_allclose(g.user_factors, single.user_factors, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.item_factors, single.item_factors, rtol=RTOL, atol=ATOL)


def test_train_als_grid_on_user_sorted_ratings_equals_train_als_bit_for_bit(ratings):
    u, i, r = ratings
    by_user = np.argsort(u, kind="stable")
    _, pcfg = _configs(False, "weighted")
    grid = port_als.train_als_grid(u[by_user], i[by_user], r[by_user], N_USERS, N_ITEMS,
                                   pcfg, list(REGS), device="cpu")
    for g, reg in zip(grid, REGS):
        single = port_als.train_als(u, i, r, N_USERS, N_ITEMS,
                                    dataclasses.replace(pcfg, reg=reg), device="cpu")
        np.testing.assert_array_equal(g.user_factors, single.user_factors)
        np.testing.assert_array_equal(g.item_factors, single.item_factors)


def test_subspace_solver_raises_and_no_regs_is_empty(ratings):
    u, i, r = ratings
    cfg = port_als.ALSConfig(rank=RANK, solver="subspace", block_size=2)
    with pytest.raises(ValueError, match="solver='exact' only"):
        port_als.train_als_grid(u, i, r, N_USERS, N_ITEMS, cfg, [0.1], device="cpu")
    assert port_als.train_als_grid(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(rank=RANK),
                                   [], device="cpu") == []


def test_a_batch_larger_than_one_chunk_is_served_in_chunks(monkeypatch):
    """A batch of more than MAX_QUERY_ROWS rows is served one chunk per K3
    launch, with the answers of one launch over the whole batch."""
    from predictionio_tpu_torch.ops import topn as k3

    rng = np.random.default_rng(3)
    uf = rng.standard_normal((50, 8)).astype(np.float32)
    itf = rng.standard_normal((30, 8)).astype(np.float32)
    sf = port_als.ServingFactors(uf, itf, device="cpu")
    whole_s, whole_i = sf.topn_by_rows(uf[:20], 5)
    monkeypatch.setattr(port_als, "MAX_QUERY_ROWS", 8)
    k3.LAUNCHES.reset()
    s, i = sf.topn_by_rows(uf[:20], 5)
    assert k3.LAUNCHES.snapshot()["topn_packed_plain"] == 3
    np.testing.assert_array_equal(s, whole_s)
    np.testing.assert_array_equal(i, whole_i)


def test_k13_wrappers_check_shapes():
    A = torch.zeros((2, 5, 3, 3))
    b = torch.zeros((2, 5, 3))
    with pytest.raises(ValueError, match="lam must be"):
        k13.spd_solve_variants(A, b, torch.ones(5), torch.ones(5, dtype=torch.bool),
                               torch.zeros((2, 5, 3)))
    with pytest.raises(ValueError, match=r"G must be"):
        k13.spd_solve_variants(A, b, torch.ones((2, 5)), torch.ones(5, dtype=torch.bool),
                               torch.zeros((2, 5, 3)), torch.zeros((3, 3)))
