"""K2 parity: the port's batched SPD solve (``ops/spd_solve.py``; on the CPU
its plain twin) against the JAX package's ``_spd_solve`` on random SPD
batches (the reference's own test, tests/test_als.py TestSpdSolve), and
one half-step (K1 + K2: ``ops/als.py _solve_side``) against the JAX
package's ``_solve_side`` with the regularizer and rows without
observations.

Tolerance: rtol 1e-4, atol 1e-5 between the two float32 implementations
of one algorithm (they round in different places: XLA fuses, PyTorch does
not); rtol 2e-3, atol 2e-4 against float64 numpy, the reference's own
tolerance for these random systems.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import spd_solve as k2

RTOL, ATOL = 1e-4, 1e-5


def _systems(k, R=50, seed=None):
    rng = np.random.default_rng(k if seed is None else seed)
    M = rng.standard_normal((R, k, k)).astype(np.float32)
    A = np.einsum("rij,rkj->rik", M, M)
    b = rng.standard_normal((R, k)).astype(np.float32)
    lam = rng.uniform(0.5, 2.5, R).astype(np.float32)
    has_obs = rng.random(R) < 0.8
    X_prev = rng.standard_normal((R, k)).astype(np.float32)
    return A, b, lam, has_obs, X_prev


@pytest.mark.parametrize("k", [1, 2, 7, 10, 32, 33])
def test_plain_twin_matches_jax_spd_solve(k):
    A, b, lam, has_obs, X_prev = _systems(k)
    A_reg = A + 2.0 * np.eye(k, dtype=np.float32)
    x = k2.cholesky_solve_plain(torch.from_numpy(A_reg), torch.from_numpy(b)).numpy()
    ref = np.asarray(jax_als._spd_solve(jnp.asarray(A_reg), jnp.asarray(b)))
    np.testing.assert_allclose(x, ref, rtol=RTOL, atol=ATOL)
    exact = np.linalg.solve(A_reg.astype(np.float64), b[..., None].astype(np.float64))[..., 0]
    np.testing.assert_allclose(x, exact, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("k", [1, 2, 7, 10, 32, 33])
def test_wrapper_adds_lam_keeps_rows_without_observations_and_sums(k):
    A, b, lam, has_obs, X_prev = _systems(k, seed=100 + k)
    sums = torch.zeros(2)
    X = k2.spd_solve(*(torch.from_numpy(a) for a in (A, b, lam, has_obs, X_prev)), sums=sums)
    X = X.numpy()
    exact = np.linalg.solve(
        A.astype(np.float64) + lam[:, None, None] * np.eye(k), b[..., None].astype(np.float64)
    )[..., 0]
    np.testing.assert_allclose(X[has_obs], exact[has_obs], rtol=2e-3, atol=2e-4)
    np.testing.assert_array_equal(X[~has_obs], X_prev[~has_obs])
    d = X.astype(np.float64) - X_prev
    np.testing.assert_allclose(
        sums.numpy(), [np.sum(d * d), np.sum(X.astype(np.float64) ** 2)], rtol=1e-5
    )


@pytest.mark.parametrize("reg_mode", ["weighted", "plain"])
def test_half_step_matches_jax_solve_side(reg_mode):
    rng = np.random.default_rng(7)
    n_users, n_items, k = 40, 30, 6
    u = rng.integers(0, n_users, 900).astype(np.int32)
    u[u == 4] = 5  # a user without ratings keeps X_prev
    i = rng.integers(0, n_items, 900).astype(np.int32)
    r = (rng.integers(1, 11, 900) / 2).astype(np.float32)
    cfg = port_als.ALSConfig(rank=k, reg=0.05, reg_mode=reg_mode)
    side = port_als.pack_segments(u, i, r, n_users, 8, 1, 128)
    R, n_cols = port_als._padded_rows(n_users, 1), port_als._padded_rows(n_items, 1)
    counts = np.bincount(u, minlength=n_users)
    lam, has_obs = port_als._lam_obs_host(counts, n_users, R, cfg)
    Y = np.abs(rng.standard_normal((n_cols, k))).astype(np.float32)
    X_prev = rng.standard_normal((R, k)).astype(np.float32)
    pack = port_als.device_pack(side, R, n_cols, torch.device("cpu"))
    X = port_als._solve_side(
        torch.from_numpy(X_prev), torch.from_numpy(Y), pack,
        torch.from_numpy(lam), torch.from_numpy(has_obs),
    ).numpy()
    ref = np.asarray(jax_als._solve_side(
        jnp.asarray(X_prev), jnp.asarray(Y), jnp.zeros((k, k)),
        tuple(jnp.asarray(a) for a in (side.seg_rows, side.cols, side.vals, side.rem)),
        jnp.asarray(lam), jnp.asarray(has_obs), 1.0,
        implicit=False, compute_dtype="float32",
    ))
    np.testing.assert_allclose(X, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(X[4], X_prev[4])
    np.testing.assert_array_equal(X[n_users:], X_prev[n_users:])


def test_cpu_tensors_route_to_plain_twin_count_and_reject():
    A, b, lam, has_obs, X_prev = (torch.from_numpy(a) for a in _systems(3))
    before = k2.LAUNCHES.snapshot()
    k2.spd_solve(A, b, lam, has_obs, X_prev)
    after = k2.LAUNCHES.snapshot()
    assert after["spd_solve_plain"] == before["spd_solve_plain"] + 1
    assert after["spd_solve"] == before["spd_solve"]
    with pytest.raises(ValueError):
        k2.spd_solve(A[:, :2], b, lam, has_obs, X_prev)
    with pytest.raises(ValueError):
        k2.spd_solve(A, b[:-1], lam, has_obs, X_prev)
    with pytest.raises(TypeError):
        k2.spd_solve(A, b, lam, has_obs.to(torch.int32), X_prev)
    with pytest.raises(ValueError):
        k2.spd_solve(A, b, lam, has_obs, X_prev, sums=torch.zeros(3))
