"""How far JAX's own bfloat16 iALS++ half-step moves with the way it is
run: the limit against which the port's bf16 half-step was to be held.

``tests/test_torch_subspace_carry.py`` holds the port's bf16 half-step at
rank 64 to atol 1e-4 of the largest entry of JAX's, on its own small store,
and explains the distance as summation order across bfloat16 rounding
boundaries: a float32 difference in a slot's score that crosses a bf16
boundary flips a residual weight. If that were the whole story, JAX's own
half-step compiled whole (``jax.jit``) and run op by op would lie about as
far apart as the port lies from either.

This module states that limit on the float32 cases' store of
``tests/test_torch_subspace_carry.py`` (400 users × 300 items, 12,000
ratings, a tenth of them dislikes, a heavy user over several groups, a
user without ratings, segments of 8 slots; factors standard normal × 0.3),
rank 64, b = 8, explicit and implicit, over three factor draws. There
JAX's two runs agree within two float32 steps of the largest entry, and
the test holds that. The port does not lie within that gap: its twins'
half-steps, with each slot's score carried across the blocks or formed
anew in every block, lie up to 2.5e-4 of the largest entry from JAX's in
the second draw (explicit: one row of 38 ratings) and up to 1.1e-4 in the
others. ROADMAP.md's queue 3 records that as a fault, with the figures for
every draw; no tolerance here or elsewhere was changed for it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.ops import als as port_als

N_USERS, N_ITEMS, NNZ = 400, 300, 12_000  # tests/test_torch_subspace_carry.py's store
HEAVY, EMPTY = 2, 11
ALPHA = 0.5
RANK, BLOCK = 64, 8
STEPS = 2  # float32 steps of the largest entry: JAX's jit against op by op
JAX_HALF_STEP = jax.jit(jax_als._solve_side_subspace,
                        static_argnames=("implicit", "compute_dtype", "block_size"))


@pytest.fixture(scope="module")
def ratings():
    rng = np.random.default_rng(20)
    u = rng.integers(0, N_USERS, NNZ).astype(np.int32)
    i = rng.integers(0, N_ITEMS, NNZ).astype(np.int32)
    u[:1500] = HEAVY
    u[u == EMPTY] = EMPTY + 1
    r = (rng.integers(1, 11, NNZ) / 2).astype(np.float32)
    r[rng.random(NNZ) < 0.1] *= -1
    return u, i, r


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
def test_jax_bf16_half_step_moves_by_at_most_two_float32_steps_between_jit_and_op_by_op(
        ratings, seed, implicit):
    u, i, r = ratings
    side = port_als.pack_segments(u, i, r, N_USERS, 8, 1, 1024)
    R, n_y = port_als._padded_rows(N_USERS, 1), port_als._padded_rows(N_ITEMS, 1)
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((R, RANK)) * 0.3).astype(np.float32)
    Y = (rng.standard_normal((n_y, RANK)) * 0.3).astype(np.float32)
    cfg = port_als.ALSConfig(rank=RANK, reg=0.05, implicit_prefs=implicit, solver="subspace",
                             block_size=BLOCK)
    lam, obs = port_als._lam_obs_host(np.bincount(u, minlength=N_USERS), N_USERS, R, cfg)
    G = Y.T @ Y if implicit else np.zeros((RANK, RANK), np.float32)
    args = (jnp.asarray(X), jnp.asarray(Y), jnp.asarray(G),
            tuple(jnp.asarray(a) for a in (side.seg_rows, side.cols, side.vals, side.rem)),
            jnp.asarray(lam), jnp.asarray(obs), ALPHA)
    kw = dict(implicit=implicit, compute_dtype="bfloat16", block_size=BLOCK)
    jitted = np.asarray(JAX_HALF_STEP(*args, **kw)[0])
    op_by_op = np.asarray(jax_als._solve_side_subspace(*args, **kw)[0])
    largest = np.abs(op_by_op).max()
    assert np.isfinite(jitted).all() and largest > 0
    gap = np.abs(jitted - op_by_op).max()
    assert gap <= STEPS * np.spacing(np.float32(largest)), (gap, largest)
