"""The form of K2's solve (``ops/spd_solve.py solve_form``: the kernel
``csrc/spd_solve.cuh``'s ``k2::launch`` takes by k, and the systems a warp
holds), and K2's and K13b's twins at the sizes the sized form takes over
(k = 8 and 16, the evaluation grid's ranks) against the JAX package's
``_spd_solve`` with ``_solve_side``'s epilogue, on the CPU.

Tolerance: rtol 1e-4, atol 1e-5, tests/test_torch_spd_solve.py's limit
between the two float32 implementations of one algorithm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.ops import grid as k13
from predictionio_tpu_torch.ops import spd_solve as k2

RTOL, ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("k,form", [
    (1, ("small8", 4)), (8, ("small8", 4)), (9, ("small16", 2)), (16, ("small16", 2)),
    (17, ("rows32", 1)), (32, ("rows32", 1)), (33, ("rows", 1)),
])
def test_solve_form_by_rank(k, form):
    assert k2.solve_form(k) == form


@pytest.mark.parametrize("k", [0, 201])
def test_solve_form_refuses_ranks_out_of_range(k):
    with pytest.raises(ValueError, match="out of range"):
        k2.solve_form(k)


def _systems(k, V, R=60, seed=0):
    rng = np.random.default_rng(seed + k)
    M = rng.standard_normal((V, R, k, k)).astype(np.float32)
    A = np.einsum("vrij,vrkj->vrik", M, M)
    b = rng.standard_normal((V, R, k)).astype(np.float32)
    lam = rng.uniform(0.5, 2.5, (V, R)).astype(np.float32)
    has_obs = rng.random(R) < 0.8
    X_prev = rng.standard_normal((V, R, k)).astype(np.float32)
    Gm = rng.standard_normal((V, 3 * k, k)).astype(np.float32)
    G = np.einsum("vnk,vnj->vkj", Gm, Gm)
    return A, b, lam, has_obs, X_prev, G


def _jax_solve(A, b, lam, has_obs, X_prev, G):
    """JAX's ``_spd_solve`` with ``_solve_side``'s epilogue (:630-640) on one
    variant: A (+ G) + λI, the solve, and X_prev where no observations."""
    k = A.shape[-1]
    M = A + (0 if G is None else G[None]) + lam[:, None, None] * np.eye(k, dtype=np.float32)
    x = np.asarray(jax_als._spd_solve(jnp.asarray(M), jnp.asarray(b)))
    return np.where(has_obs[:, None], x, X_prev)


@pytest.mark.parametrize("with_g", [False, True], ids=["explicit", "gramian"])
@pytest.mark.parametrize("k", [8, 16])
def test_k2_and_k13b_twins_match_jax_spd_solve_at_sized_ranks(k, with_g):
    V = 2
    A, b, lam, has_obs, X_prev, G = _systems(k, V)
    T = [torch.from_numpy(a) for a in (A, b, lam, has_obs, X_prev, G)]
    Gt = T[5] if with_g else None
    X13 = k13.spd_solve_variants(T[0], T[1], T[2], T[3], T[4], Gt).numpy()
    for v in range(V):
        want = _jax_solve(A[v], b[v], lam[v], has_obs, X_prev[v], G[v] if with_g else None)
        X2 = k2.spd_solve(T[0][v], T[1][v], T[2][v], T[3], T[4][v], None,
                          None if Gt is None else Gt[v]).numpy()
        np.testing.assert_allclose(X2, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(X13[v], want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(X13[v], X2)  # K13b's twin is K2's per variant
