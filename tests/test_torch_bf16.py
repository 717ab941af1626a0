"""bfloat16 training in the port (``ALSConfig(compute_dtype="bfloat16")``,
the reference's headline training config) against the JAX package's
bfloat16 programs on the CPU (``device="cpu"``: every kernel by its plain
twin): K1-bf16 (``_accumulate_systems``), one K11a-bf16 block pass
(``_solve_side_subspace``), K12b-bf16 (``_implicit_objective``), K13a-bf16
(the vmapped grid, ``_run_iterations_grid``), one sweep and five sweeps of
``train_als``, and a bfloat16 training against the float32 one. The port's
own bit-for-bit identities in bfloat16 (the streaming and direct routes,
the grid against the serial trainer, and the resident pack's key, which
leaves the dtype out) are in ``tests/test_torch_bf16_training.py``, on the
inputs and fixtures of this module.

Inputs are made from numpy seeds: 240 users x 120 items, 5,000 events,
ranks 4 and 8, standard-normal factors, ratings off the bfloat16 grid (a
0.5-step rating plus 0.2: 3.7, 1.2, ...; the reference rounds them, so a
half-step rating, exact in bfloat16, would hide the rounding), a tenth of
them dislikes in implicit mode, alpha 0.37. Tolerances, stated
beforehand:
- each twin against the JAX function in bfloat16: within 1e-5 of the
  row's scale (A: its largest diagonal entry, which bounds every
  Σ|w_a y_i y_j|; b: sqrt(Σ w_b² · that entry); a solved row: its largest
  entry; the objective: its largest term's magnitude). Both round the same
  values to bfloat16 and form exact products, and sum them in float32 in
  different orders;
- each twin against its own float32 form: more than 1e-4 of that scale
  apart somewhere, which shows the rounding happens;
- one sweep against JAX: within 1e-4 of the largest entry (the item
  half-step rounds X to bfloat16, and float32 noise in X flips a
  bfloat16 rounding now and then);
- five sweeps against JAX: training RMSE within 1e-4, factors within 1e-2
  of the largest entry. Summation order alone moves bfloat16 factors in
  steps: a float32 difference in X or Y that crosses a bfloat16 rounding
  boundary flips one rounding, and later sweeps carry it on. On these
  ratings (explicit, exact solver) JAX's own training with the events
  permuted moved them by 4.1e-3 of the largest entry, the port's by
  4.9e-3, and the port against JAX, two unrelated orders, by 7.3e-3, one
  row of few ratings; 4e-3 held in the other modes (largest 2.6e-3). In
  float32 the same comparison is within 1.2e-5. The RMSE gap was 1.8e-5;
- a bfloat16 training against the float32 one: factors more than 1e-3 of
  the largest entry apart, RMSE within 5e-3;
- the streaming and direct routes, and the grid on user-sorted ratings
  against ``train_als``: bit for bit (one program on one input).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import gramian as k12
from predictionio_tpu_torch.ops import grid as k13
from predictionio_tpu_torch.ops import normal_eq as k1
from predictionio_tpu_torch.ops import subspace as k11
from predictionio_tpu_torch.parallel import Mesh

N_USERS, N_ITEMS, NNZ, RANK = 240, 120, 5000, 8
ALPHA = 0.37
BF16 = "bfloat16"
CPU = torch.device("cpu")
CFG = dict(rank=RANK, iterations=5, reg=0.05, alpha=ALPHA, seed=3, segment_length=16,
           chunk_slots=512, compute_dtype=BF16)
MODES = pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])


@pytest.fixture(scope="module")
def ratings():
    """0.5-step ratings plus 0.2 (none of them exact in bfloat16) on
    zipf-popular items, a heavy user spanning several segments, a user and
    an item without ratings."""
    rng = np.random.default_rng(0)
    u = rng.integers(0, N_USERS, NNZ).astype(np.int32)
    i = (rng.zipf(1.3, NNZ) % N_ITEMS).astype(np.int32)
    u[:200] = 4
    u[u == 9] = 10
    i[i == 7] = 8
    r = (rng.integers(1, 10, NNZ) / 2 + 0.2).astype(np.float32)
    return u, i, r


def _signed(r, implicit):
    """Implicit mode's values: every tenth event a dislike."""
    if not implicit:
        return r
    out = r.copy()
    out[::10] = -1.0
    return out


def _side(rows, cols, r, n_rows, n_cols):
    side = port_als.pack_segments(rows, cols, r, n_rows, 16, 1, 512)
    R, n_y = port_als._padded_rows(n_rows, 1), port_als._padded_rows(n_cols, 1)
    return side, R, n_y


def _jax_pack(side):
    return tuple(jnp.asarray(a) for a in (side.seg_rows, side.cols, side.vals, side.rem))


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _k1_errors(A, b, A_ref, b_ref, side, R, implicit):
    """Per-row |ΔA| and |Δb| over the row's scale (see the module
    docstring)."""
    diag = np.abs(np.diagonal(A_ref, axis1=1, axis2=2)).max(axis=1)
    v = side.vals
    wb = np.where(v > 0, 1 + ALPHA * np.abs(v), 0.0) if implicit else v
    wsq = np.bincount(side.seg_rows.reshape(-1), weights=np.square(wb).sum(-1).reshape(-1),
                      minlength=R + 1)[:R]
    scale_a = np.maximum(diag, 1e-30)
    scale_b = np.maximum(np.sqrt(wsq * diag), 1e-30)
    return (np.abs(A - A_ref).max(axis=(1, 2)) / scale_a,
            np.abs(b - b_ref).max(axis=1) / scale_b)


@MODES
def test_k1_bf16_twin_matches_jax_accumulate_systems(ratings, implicit):
    u, i, r = ratings
    r = _signed(r, implicit)
    side, R, n_y = _side(u, i, r, N_USERS, N_ITEMS)
    assert side.seg_rows.shape[0] > 1  # several chunks
    Y = _normal((n_y, RANK), 1)
    pack = port_als.device_pack(side, R, n_y, CPU)
    before = k1.LAUNCHES.snapshot()
    A, b = (t.numpy() for t in k1.normal_eq(torch.from_numpy(Y), pack, implicit, ALPHA, BF16))
    after = k1.LAUNCHES.snapshot()
    assert after["normal_eq_bf16_plain"] == before["normal_eq_bf16_plain"] + 1
    assert after["normal_eq_plain"] == before["normal_eq_plain"]
    A_ref, b_ref = (np.asarray(a) for a in jax_als._accumulate_systems(
        jnp.asarray(Y), *_jax_pack(side), ALPHA, R, implicit=implicit, compute_dtype=BF16,
    ))
    ea, eb = _k1_errors(A, b, A_ref, b_ref, side, R, implicit)
    assert ea.max() <= 1e-5 and eb.max() <= 1e-5, (ea.max(), eb.max())
    # the float32 form is another function: the rounding shows
    A32, b32 = (t.numpy() for t in k1.normal_eq(torch.from_numpy(Y), pack, implicit, ALPHA))
    fa, fb = _k1_errors(A32, b32, A_ref, b_ref, side, R, implicit)
    assert max(fa.max(), fb.max()) > 1e-4, (fa.max(), fb.max())
    assert not A[9].any() and not b[9].any() and not A[N_USERS:].any()


@MODES
def test_k11a_bf16_block_pass_matches_jax_solve_side_subspace(ratings, implicit):
    """The first column block of a subspace half-step (its columns are
    written by that block alone) against JAX's ``_solve_side_subspace`` in
    bfloat16; the whole half-step at the sweep tolerance."""
    u, i, r = ratings
    r = _signed(r, implicit)
    b = 2
    side, R, n_y = _side(u, i, r, N_USERS, N_ITEMS)
    X, Y = _normal((R, RANK), 2) * 0.3, _normal((n_y, RANK), 3) * 0.3
    cfg = port_als.ALSConfig(**dict(CFG, implicit_prefs=implicit, solver="subspace", block_size=b))
    lam, obs = port_als._lam_obs_host(np.bincount(u, minlength=N_USERS), N_USERS, R, cfg)
    G = Y.T @ Y if implicit else np.zeros((RANK, RANK), np.float32)
    want, _ = jax_als._solve_side_subspace(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(G), _jax_pack(side), jnp.asarray(lam),
        jnp.asarray(obs), ALPHA, implicit=implicit, compute_dtype=BF16, block_size=b,
    )
    want = np.asarray(want)
    pack = port_als.device_pack(side, R, n_y, CPU)
    Gt = torch.from_numpy(G) if implicit else None

    def block(compute_dtype):
        Xt = torch.from_numpy(X.copy())
        A, rv = k11.subspace_accumulate(torch.from_numpy(Y), Xt, pack, 0, b, implicit, ALPHA,
                                        compute_dtype)
        k11.subspace_block_solve(A, rv, Xt, torch.from_numpy(lam), torch.from_numpy(obs), 0, Gt)
        return Xt.numpy()

    before = k11.LAUNCHES.snapshot()
    got = block(BF16)
    assert (k11.LAUNCHES.snapshot()["subspace_accumulate_bf16_plain"]
            == before["subspace_accumulate_bf16_plain"] + 1)
    scale = np.maximum(np.abs(want[:, :b]).max(axis=1), 1e-30)
    err = np.abs(got[:, :b] - want[:, :b]).max(axis=1) / scale
    assert err.max() <= 1e-5, err.max()
    f32 = block("float32")
    assert (np.abs(f32[:, :b] - want[:, :b]).max(axis=1) / scale).max() > 1e-4
    # the whole half-step: later blocks round the x earlier blocks wrote
    Xt = torch.from_numpy(X.copy())
    port_als._solve_side_subspace(Xt, torch.from_numpy(Y), Gt, pack, torch.from_numpy(lam),
                                  torch.from_numpy(obs), ALPHA, implicit, b, compute_dtype=BF16)
    np.testing.assert_allclose(Xt.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_k12b_bf16_twin_matches_jax_implicit_objective(ratings):
    u, i, r = ratings
    r = _signed(r, True)
    side, R_u, R_i = _side(u, i, r, N_USERS, N_ITEMS)
    X, Y = _normal((R_u, RANK), 4) * 0.5, _normal((R_i, RANK), 5) * 0.5
    X[N_USERS:], Y[N_ITEMS:] = 0.0, 0.0
    lam_u = np.random.default_rng(6).uniform(0.1, 1.0, R_u).astype(np.float32)
    lam_i = np.random.default_rng(7).uniform(0.1, 1.0, R_i).astype(np.float32)
    want = float(jax_als._implicit_objective(
        jnp.asarray(X), jnp.asarray(Y), _jax_pack(side), jnp.asarray(lam_u),
        jnp.asarray(lam_i), ALPHA, compute_dtype=BF16,
    ))
    pack = port_als.device_pack(side, R_u, R_i, CPU)
    args = (torch.from_numpy(X), torch.from_numpy(Y), pack, torch.from_numpy(lam_u),
            torch.from_numpy(lam_i), ALPHA)
    before = k12.LAUNCHES.snapshot()
    got = float(k12.implicit_objective(*args, compute_dtype=BF16))
    after = k12.LAUNCHES.snapshot()
    assert after["implicit_objective_bf16_plain"] == before["implicit_objective_bf16_plain"] + 1
    assert after["implicit_objective_plain"] == before["implicit_objective_plain"]
    # the scale: the largest of the three terms' magnitudes, in float64
    X64, Y64 = X.astype(np.float64), Y.astype(np.float64)
    s = np.einsum("nk,nk->n", X64[u], Y64[i])
    c = ALPHA * np.abs(r)
    p = (r > 0).astype(np.float64)
    obs = np.abs(c * s * s).sum() + np.abs(2 * (1 + c) * p * s).sum() + ((1 + c) * p).sum()
    scale = max(np.abs((X64.T @ X64) * (Y64.T @ Y64)).sum(), obs,
                (lam_u * (X64 ** 2).sum(1)).sum() + (lam_i * (Y64 ** 2).sum(1)).sum())
    assert abs(got - want) <= 1e-5 * scale, (got, want, scale)
    # the float32 form, on one row (the heavy user 4): only the observed
    # term rounds, and over all rows its rounding errors average out, so
    # the rounding shows against one row's observed term
    sel = u == 4
    one, _, _ = _side(u[sel], i[sel], r[sel], N_USERS, N_ITEMS)
    one_args = (args[0], args[1], port_als.device_pack(one, R_u, R_i, CPU)) + args[3:]
    gap = abs(float(k12.implicit_objective(*one_args, compute_dtype=BF16))
              - float(k12.implicit_objective(*one_args)))
    s1 = s[sel]
    obs1 = (np.abs(c[sel] * s1 * s1).sum() + np.abs(2 * (1 + c[sel]) * p[sel] * s1).sum()
            + ((1 + c[sel]) * p[sel]).sum())
    assert gap > 1e-4 * obs1, (gap, obs1)


@MODES
def test_k13a_bf16_grid_matches_jax_run_iterations_grid(ratings, implicit):
    """One sweep of the vmapped grid, V = 2: the user half-step (Y0 as
    given) within 1e-5 of each row's largest entry, the item half-step at
    the sweep tolerance; K13a's twin is K1's twin on each variant."""
    u, i, r = ratings
    r = _signed(r, implicit)
    regs = (0.02, 0.2)
    cfg = dict(CFG, rank=4, implicit_prefs=implicit)
    sides = (_side(u, i, r, N_USERS, N_ITEMS)[0], _side(i, u, r, N_ITEMS, N_USERS)[0])
    R_u, R_i = port_als._padded_rows(N_USERS, 1), port_als._padded_rows(N_ITEMS, 1)
    lams, obs = [], []
    for side, R in ((sides[0], R_u), (sides[1], R_i)):
        per = [port_als._lam_obs_host(side.counts, side.n_rows, R,
                                      port_als.ALSConfig(**dict(cfg, reg=g))) for g in regs]
        lams.append(np.stack([lam for lam, _ in per]))
        obs.append(per[0][1])
    X0 = np.zeros((2, R_u, 4), np.float32)
    Y0 = np.broadcast_to(np.abs(_normal((R_i, 4), 8)) / 2, (2, R_i, 4)).copy()
    Y0[:, N_ITEMS:] = 0.0
    Xj, Yj = (np.asarray(a) for a in jax_als._run_iterations_grid(
        jnp.asarray(X0), jnp.asarray(Y0), _jax_pack(sides[0]), _jax_pack(sides[1]),
        jnp.asarray(lams[0]), jnp.asarray(lams[1]), jnp.asarray(obs[0]), jnp.asarray(obs[1]),
        ALPHA, jnp.int32(1), implicit=implicit, compute_dtype=BF16,
    ))
    packs = [port_als.device_pack(sides[0], R_u, R_i, CPU),
             port_als.device_pack(sides[1], R_i, R_u, CPU)]
    k13.LAUNCHES.reset()
    Xp, Yp = port_als._run_iterations_grid(
        torch.from_numpy(X0), torch.from_numpy(Y0), *packs,
        torch.from_numpy(lams[0]), torch.from_numpy(lams[1]),
        torch.from_numpy(obs[0]), torch.from_numpy(obs[1]), ALPHA, 1, implicit, BF16,
    )
    counts = k13.LAUNCHES.snapshot()
    assert counts["normal_eq_variants_bf16_plain"] == 2 and counts["normal_eq_variants_plain"] == 0
    scale = np.maximum(np.abs(Xj).max(axis=2), 1e-30)
    assert (np.abs(Xp.numpy() - Xj).max(axis=2) / scale).max() <= 1e-5
    np.testing.assert_allclose(Yp.numpy(), Yj, rtol=0, atol=1e-4 * np.abs(Yj).max())
    A, b = k13.normal_eq_variants(torch.from_numpy(Y0), packs[0], implicit, ALPHA, BF16)
    for v in range(2):
        A1, b1 = k1.normal_eq(torch.from_numpy(Y0[v]), packs[0], implicit, ALPHA, BF16)
        assert torch.equal(A[v], A1) and torch.equal(b[v], b1)


def _train_both(ratings, implicit, **cfg):
    u, i, r = ratings
    r = _signed(r, implicit)
    c = dict(CFG, implicit_prefs=implicit, **cfg)
    port = port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**c), device="cpu")
    ref = jax_als.train_als(u, i, r, N_USERS, N_ITEMS, jax_als.ALSConfig(**c))
    return port, ref, (u, i, r)


SOLVERS = pytest.mark.parametrize("solver", [{}, dict(solver="subspace", block_size=4)],
                                  ids=["exact", "subspace"])


@SOLVERS
@MODES
def test_one_bf16_sweep_matches_jax(ratings, implicit, solver):
    port, ref, _ = _train_both(ratings, implicit, iterations=1, **solver)
    for got, want in ((port.user_factors, ref.user_factors), (port.item_factors, ref.item_factors)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@SOLVERS
@MODES
def test_five_bf16_sweeps_match_jax(ratings, implicit, solver):
    port, ref, (u, i, r) = _train_both(ratings, implicit, **solver)
    for got, want in ((port.user_factors, ref.user_factors), (port.item_factors, ref.item_factors)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())
    rmse_port = port_als.rmse(port, u, i, r, device="cpu")
    pred = np.einsum("nk,nk->n", ref.user_factors[u], ref.item_factors[i])
    rmse_ref = float(np.sqrt(np.mean((pred - r) ** 2)))
    assert abs(rmse_port - rmse_ref) <= 1e-4, (rmse_port, rmse_ref)


@MODES
def test_bf16_training_is_not_the_float32_training(ratings, implicit):
    """The bfloat16 run counts its own twins and lands elsewhere than the
    float32 run: nothing trains in float32 when bfloat16 was asked for."""
    u, i, r = ratings
    r = _signed(r, implicit)
    c = dict(CFG, implicit_prefs=implicit)
    before = k1.LAUNCHES.snapshot()
    bf = port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**c), device="cpu")
    after = k1.LAUNCHES.snapshot()
    assert after["normal_eq_bf16_plain"] - before["normal_eq_bf16_plain"] == 2 * c["iterations"]
    assert after["normal_eq_plain"] == before["normal_eq_plain"]
    f32 = port_als.train_als(u, i, r, N_USERS, N_ITEMS,
                             port_als.ALSConfig(**dict(c, compute_dtype="float32")), device="cpu")
    gap = np.abs(bf.user_factors - f32.user_factors).max() / np.abs(f32.user_factors).max()
    assert gap > 1e-3, gap
    if not implicit:
        rm_bf = port_als.rmse(bf, u, i, r, device="cpu")
        rm_32 = port_als.rmse(f32, u, i, r, device="cpu")
        assert abs(rm_bf - rm_32) <= 5e-3, (rm_bf, rm_32)


def test_other_dtypes_and_a_mesh_still_raise(ratings):
    u, i, r = ratings
    with pytest.raises(NotImplementedError, match="float16"):
        port_als.train_als(u, i, r, N_USERS, N_ITEMS,
                           port_als.ALSConfig(**dict(CFG, compute_dtype="float16")), device="cpu")
    # a Mesh trains since the sharded-training slice; a non-Mesh and a
    # mesh with a model axis are still refused
    with pytest.raises(TypeError, match="Mesh"):
        port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**CFG), device="cpu",
                           mesh=object())
    with pytest.raises(ValueError, match="1-D 'data' mesh"):
        port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**CFG),
                           mesh=Mesh(["cpu"] * 4, {"data": 2, "model": 2}))
    side, R, n_y = _side(u, i, r, N_USERS, N_ITEMS)
    pack = port_als.device_pack(side, R, n_y, CPU)
    with pytest.raises(ValueError, match="compute_dtype"):
        k1.normal_eq(torch.zeros((n_y, RANK)), pack, compute_dtype="float16")
