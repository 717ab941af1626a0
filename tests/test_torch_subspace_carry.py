"""The iALS++ half-step with each slot's score carried across the column
blocks (``ops/subspace.py``'s module docstring: block 0 writes d = y·x to
a score buffer, K11b writes Δ = x_new − x_old, block j >= 1 reads
d + y_{B−1}·Δ) against the JAX package on the CPU (``device="cpu"``: the
kernels' plain twins, which carry d as the kernels do).

Inputs are made from numpy seeds: 400 users x 300 items, 12,000 ratings
(a tenth of them dislikes), a heavy user (about 1,500 ratings over many
groups of segments), a user without ratings, segments of 8 slots; the
bfloat16 case takes tests/test_torch_bf16.py's store (240 x 120, 5,000
ratings off the bfloat16 grid) with its standard-normal factors.

Tolerances, stated beforehand:
- the carried half-step against JAX's ``_solve_side_subspace``, which forms
  d anew in every block: rtol 1e-5, atol 1e-6, the tolerance
  tests/test_torch_subspace.py holds one half-step to (the carry adds a
  few float32 roundings a block to d, well inside it);
- the bfloat16 half-step against JAX's (run as tests/test_torch_bf16.py
  runs it, op by op), and against the port's own half-step that forms d
  anew in every block: atol 1e-4 of the largest entry,
  tests/test_torch_bf16.py's limit for a whole bf16 half-step. At rank 64
  that limit is about what summation order alone allows: a float32
  difference in d that crosses a bfloat16 rounding boundary flips one
  residual weight bf16(w_b − w_a·d), and in a row of few ratings that
  moves the factors by up to 1e-3 of the largest entry. JAX's own
  half-step compiled whole (``jax.jit``) is 7.4x the limit from its op by
  op run on these explicit inputs; on the float32 cases' store, and on
  this one with factors scaled by 0.3 in implicit mode, JAX's and the
  port's bf16 half-steps are 2.4–7.9x the limit apart with d carried or
  formed anew alike (the same row, the same largest difference);
- the score after block j against d formed over all k columns at the X
  that block sees: 1e-6 of the row's scale (the largest Σ_c |y_c x_c| over
  the row's slots); K11a's A and r from the carried score against those
  from a full recompute: rtol 1e-5, atol 1e-6 of the largest entry;
- Δ: exactly x_new − x_old (bfloat16 compute: bf16(x_new) − bf16(x_old)),
  exactly 0 on a row without observations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import subspace as k11
from predictionio_tpu_torch.ops.precision import round_bf16

RTOL, ATOL = 1e-5, 1e-6
BF16_ATOL = 1e-4
N_USERS, N_ITEMS, NNZ = 400, 300, 12_000
HEAVY, EMPTY = 2, 11
ALPHA = 0.5
CPU = torch.device("cpu")
MODES = pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
# the reference half-step compiled once per (mode, dtype, block), not traced op by op
JAX_HALF_STEP = jax.jit(jax_als._solve_side_subspace,
                        static_argnames=("implicit", "compute_dtype", "block_size"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The twins' small einsums on one thread: beside XLA's own thread pool
    in this process, torch's pool spends seconds waiting on the CPU's
    cores (a rank-64 half-step: 0.1 s alone, up to 50 s after a JAX call).
    Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ratings():
    rng = np.random.default_rng(20)
    u = rng.integers(0, N_USERS, NNZ).astype(np.int32)
    i = rng.integers(0, N_ITEMS, NNZ).astype(np.int32)
    u[:1500] = HEAVY
    u[u == EMPTY] = EMPTY + 1
    r = (rng.integers(1, 11, NNZ) / 2).astype(np.float32)
    r[rng.random(NNZ) < 0.1] *= -1  # dislikes: confidence without preference (implicit)
    return u, i, r


def _setup(ratings, rank, b, implicit, seed=1):
    u, i, r = ratings
    side = port_als.pack_segments(u, i, r, N_USERS, 8, 1, 1024)
    R, n_y = port_als._padded_rows(N_USERS, 1), port_als._padded_rows(N_ITEMS, 1)
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((R, rank)) * 0.3).astype(np.float32)
    Y = (rng.standard_normal((n_y, rank)) * 0.3).astype(np.float32)
    cfg = port_als.ALSConfig(rank=rank, reg=0.05, implicit_prefs=implicit, solver="subspace",
                             block_size=b)
    lam, obs = port_als._lam_obs_host(np.bincount(u, minlength=N_USERS), N_USERS, R, cfg)
    G = Y.T @ Y if implicit else np.zeros((rank, rank), np.float32)
    pack = port_als.device_pack(side, R, n_y, CPU)
    return side, pack, X, Y, lam, obs, G


def _jax_half_step(side, X, Y, G, lam, obs, implicit, b, compute_dtype):
    want, deltas = JAX_HALF_STEP(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(G),
        tuple(jnp.asarray(a) for a in (side.seg_rows, side.cols, side.vals, side.rem)),
        jnp.asarray(lam), jnp.asarray(obs), ALPHA,
        implicit=implicit, compute_dtype=compute_dtype, block_size=b,
    )
    return np.asarray(want), np.asarray(deltas)


def _spy_carry(monkeypatch):
    """Record, per K11a twin call, whether it carried the score (got Δ)."""
    calls = []
    orig = k11.subspace_accumulate_plain

    def spy(*args, **kwargs):
        calls.append((args[12] if len(args) > 12 else kwargs.get("score")) is not None and
                     (args[13] if len(args) > 13 else kwargs.get("delta")) is not None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(k11, "subspace_accumulate_plain", spy)
    return calls


@MODES
@pytest.mark.parametrize("rank,b", [(64, 8), (32, 4)])
def test_carried_half_step_matches_jax_solve_side_subspace(ratings, monkeypatch, rank, b,
                                                            implicit):
    side, pack, X, Y, lam, obs, G = _setup(ratings, rank, b, implicit)
    assert pack.plan.n_partials > 0  # the heavy user spans several groups
    want, deltas = _jax_half_step(side, X, Y, G, lam, obs, implicit, b, "float32")
    calls = _spy_carry(monkeypatch)
    nb = rank // b
    sums = torch.zeros((nb, 2), dtype=torch.float32)
    got = port_als._solve_side_subspace(
        torch.from_numpy(X.copy()), torch.from_numpy(Y),
        torch.from_numpy(G) if implicit else None, pack, torch.from_numpy(lam),
        torch.from_numpy(obs), ALPHA, implicit, b, sums,
    ).numpy()
    assert calls == [False] + [True] * (nb - 1)  # block 0 forms d, the others carry it
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    R = X.shape[0]
    np.testing.assert_allclose(np.sqrt(sums[:, 0].numpy() / (R * b)), deltas, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got[EMPTY], X[EMPTY])


@MODES
def test_carried_bf16_half_step_matches_jax(monkeypatch, implicit):
    import test_torch_bf16 as tb

    rank, b = 64, 8
    rng = np.random.default_rng(0)  # tests/test_torch_bf16.py's ratings fixture
    u = rng.integers(0, tb.N_USERS, tb.NNZ).astype(np.int32)
    i = (rng.zipf(1.3, tb.NNZ) % tb.N_ITEMS).astype(np.int32)
    u[:200] = 4
    u[u == 9] = 10
    i[i == 7] = 8
    r = tb._signed((rng.integers(1, 10, tb.NNZ) / 2 + 0.2).astype(np.float32), implicit)
    side, R, n_y = tb._side(u, i, r, tb.N_USERS, tb.N_ITEMS)
    X, Y = tb._normal((R, rank), 2), tb._normal((n_y, rank), 3)
    cfg = port_als.ALSConfig(rank=rank, reg=0.05, implicit_prefs=implicit, solver="subspace",
                             block_size=b)
    lam, obs = port_als._lam_obs_host(np.bincount(u, minlength=tb.N_USERS), tb.N_USERS, R, cfg)
    G = Y.T @ Y if implicit else np.zeros((rank, rank), np.float32)
    want = np.asarray(jax_als._solve_side_subspace(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(G), tb._jax_pack(side), jnp.asarray(lam),
        jnp.asarray(obs), tb.ALPHA, implicit=implicit, compute_dtype="bfloat16", block_size=b,
    )[0])
    pack = port_als.device_pack(side, R, n_y, CPU)

    def half_step():
        return port_als._solve_side_subspace(
            torch.from_numpy(X.copy()), torch.from_numpy(Y),
            torch.from_numpy(G) if implicit else None, pack, torch.from_numpy(lam),
            torch.from_numpy(obs), tb.ALPHA, implicit, b, compute_dtype="bfloat16").numpy()

    calls = _spy_carry(monkeypatch)
    got = half_step()
    assert calls == [False] + [True] * (rank // b - 1)
    limit = BF16_ATOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=limit)
    monkeypatch.setattr(k11, "carries", lambda k, bb: False)  # d formed in every block
    np.testing.assert_allclose(got, half_step(), rtol=0, atol=limit)
    assert calls[rank // b:] == [False] * (rank // b)


def _full_scores(pack, X, Y):
    """d = y·x over all k columns for every slot, and each slot's row
    scale (the largest Σ_c |y_c x_c| over its row's slots)."""
    rows = pack.seg_rows.long()
    Yg = Y[pack.cols.long()]  # [C, Sc, L, k]
    Xr = X[rows]  # [C, Sc, k]
    d = torch.einsum("cslk,csk->csl", Yg.double(), Xr.double())
    mag = torch.einsum("cslk,csk->csl", Yg.abs().double(), Xr.abs().double())
    valid = torch.arange(pack.cols.shape[-1])[None, None, :] < pack.rem[..., None]
    per_row = torch.zeros(X.shape[0], dtype=torch.float64)
    per_row.scatter_reduce_(0, rows[..., None].expand_as(mag)[valid], mag[valid], "amax")
    return d, per_row[rows][..., None].expand_as(d), valid


@MODES
@pytest.mark.parametrize("rank,b", [(64, 8), (32, 4), (16, 2), (8, 1)])
def test_score_after_each_block_matches_a_full_recompute(ratings, rank, b, implicit):
    _, pack, X, Y, lam, obs, G = _setup(ratings, rank, b, implicit, seed=3)
    Xt, Yt = torch.from_numpy(X.copy()), torch.from_numpy(Y)
    Gt = torch.from_numpy(G) if implicit else None
    lam_t, obs_t = torch.from_numpy(lam), torch.from_numpy(obs)
    assert k11.carries(rank, b)
    score, delta = k11.CarryBuffers([pack], b).views(pack)
    nb = rank // b
    for j in range(nb):
        s0 = j * b
        before = score.clone()
        A, r = k11.subspace_accumulate(Yt, Xt, pack, s0, b, implicit, ALPHA, "float32", score,
                                       None if j == 0 else delta)
        if j == nb - 1:  # the last block's score is read by no block: not written
            assert torch.equal(score, before)
        else:
            d, scale, valid = _full_scores(pack, Xt, Yt)
            err = (score.double() - d).abs()[valid]
            assert bool((err <= 1e-6 * scale[valid]).all()), (j, (err / scale[valid]).max().item())
        A_full, r_full = k11.subspace_accumulate(Yt, Xt, pack, s0, b, implicit, ALPHA)
        np.testing.assert_allclose(A.numpy(), A_full.numpy(), rtol=RTOL,
                                   atol=ATOL * A_full.abs().max().item())
        np.testing.assert_allclose(r.numpy(), r_full.numpy(), rtol=RTOL,
                                   atol=ATOL * r_full.abs().max().item())
        k11.subspace_block_solve(A, r, Xt, lam_t, obs_t, s0, Gt, delta=delta)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_delta_is_the_change_of_x_and_zero_without_observations(ratings, compute_dtype):
    rank, b, s0 = 32, 4, 8
    _, pack, X, Y, lam, obs, G = _setup(ratings, rank, b, True, seed=4)
    Xt = torch.from_numpy(X.copy())
    A, r = k11.subspace_accumulate(torch.from_numpy(Y), Xt, pack, s0, b, True, ALPHA,
                                   compute_dtype)
    delta = torch.full((X.shape[0], b), float("nan"))
    k11.subspace_block_solve(A, r, Xt, torch.from_numpy(lam), torch.from_numpy(obs), s0,
                             torch.from_numpy(G), delta=delta, compute_dtype=compute_dtype)
    old, new = torch.from_numpy(X[:, s0:s0 + b]), Xt[:, s0:s0 + b]
    if compute_dtype == "bfloat16":
        old, new = round_bf16(old), round_bf16(new)
    assert torch.equal(delta, new - old)
    assert not obs[EMPTY] and not obs[N_USERS:].any()
    assert not delta[EMPTY].any() and not delta[N_USERS:].any()
    assert not torch.signbit(delta[~torch.from_numpy(obs)]).any()  # +0, not −0
    assert delta[HEAVY].abs().max() > 0


@pytest.mark.parametrize("rank,b", [(6, 3), (72, 8), (8, 8)])
def test_forms_without_a_carry_form_d_in_every_block(ratings, monkeypatch, rank, b):
    """The groups form (b not in {1, 2, 4, 8}, or k > 64) and a single block
    take no score buffer: every block forms d anew, and the wrapper refuses
    a buffer there."""
    _, pack, X, Y, lam, obs, G = _setup(ratings, rank, b, True, seed=5)
    assert not k11.carries(rank, b)
    calls = _spy_carry(monkeypatch)
    port_als._solve_side_subspace(torch.from_numpy(X.copy()), torch.from_numpy(Y),
                                  torch.from_numpy(G), pack, torch.from_numpy(lam),
                                  torch.from_numpy(obs), ALPHA, True, b)
    assert calls == [False] * (rank // b)
    score = torch.zeros(pack.vals.shape)
    with pytest.raises(ValueError, match="carries no score"):
        k11.subspace_accumulate(torch.from_numpy(Y), torch.from_numpy(X), pack, 0, b, True,
                                ALPHA, score=score)


def test_carry_buffers_serve_both_sides_from_one_allocation(ratings):
    u, i, r = ratings
    rank, b = 32, 4
    user = port_als.pack_segments(u, i, r, N_USERS, 8, 1, 1024)
    item = port_als.pack_segments(i, u, r, N_ITEMS, 8, 1, 1024)
    R_u, R_i = port_als._padded_rows(N_USERS, 1), port_als._padded_rows(N_ITEMS, 1)
    up = port_als.device_pack(user, R_u, R_i, CPU)
    ip = port_als.device_pack(item, R_i, R_u, CPU)
    bufs = k11.CarryBuffers([up, ip], b)
    (su, du), (si, di) = bufs.views(up), bufs.views(ip)
    assert su.shape == up.vals.shape and si.shape == ip.vals.shape
    assert du.shape == (R_u, b) and di.shape == (R_i, b)
    assert su.data_ptr() == si.data_ptr() and du.data_ptr() == di.data_ptr()
    assert not su.any() and not du.any()  # zeros at first
    with pytest.raises(ValueError, match="delta must be"):
        k11.subspace_accumulate(torch.zeros((R_i, rank)), torch.zeros((R_u, rank)), up, 0, b,
                                score=su, delta=du)  # Δ before block 0
