"""The port's least-squares solve (``ops/lstsq.py``: K21, the stock
template's batch of per-ticker systems, and K22, the regression template's
one tall system) on the CPU, through its plain twin, against JAX's
``jnp.linalg.lstsq`` and float64 numpy on the same seeded inputs.

Tolerances:
- well-conditioned systems (cond <= 1e3): the port's answer within 1e-5 of
  the largest entry of float64 ``np.linalg.lstsq(rcond=eps_f32·max(m,
  n))``; JAX's float32 answer too at cond <= 10. Past that JAX's own
  float32 SVD drifts (about 1e-5 to 3e-4 of the largest entry at cond 1e2
  to 1e3 on these inputs), so there the port is held no farther from
  float64 than JAX is;
- rank-deficient systems (a duplicated column, a zero column, m < n): the
  same rank as JAX and the minimum-norm answer within 1e-5;
- the stock shape [5, 173, 5]: the port no farther from the float64
  answer than JAX's float32 answer is, plus 1e-6 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import lstsq as k21

TOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)


def conditioned(rng, m, n, cond):
    """An [m, n] float32 matrix with singular values spread log-evenly from
    1 to 1/cond."""
    u, _ = np.linalg.qr(rng.standard_normal((m, max(n, 1))))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.logspace(0, -np.log10(cond), n)
    return ((u[:, :n] * s) @ v.T).astype(np.float32)


def oracle(A, b):
    """float64 numpy at JAX's cutoff: (x, rank)."""
    m, n = A.shape
    x, _, rank, _ = np.linalg.lstsq(A.astype(np.float64), b.astype(np.float64),
                                    rcond=EPS32 * max(m, n))
    return x, rank


def jax_lstsq(A, b):
    """JAX's answer, vmapped over the batch as the stock template does."""
    out = jax.jit(jax.vmap(lambda a, c: jnp.linalg.lstsq(a, c)))(jnp.asarray(A), jnp.asarray(b))
    return np.asarray(out[0]), np.asarray(out[2]), np.asarray(out[3])


def port_lstsq(A, b):
    k21.LAUNCHES.reset()
    out = k21.lstsq(torch.from_numpy(A), torch.from_numpy(b))
    assert k21.LAUNCHES.snapshot() == {"lsq": 0, "lsq_plain": 1}
    return out


def assert_near(got, want, tol=TOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(np.asarray(got, np.float64) - want).max()) <= tol * scale


@pytest.mark.parametrize("cond", [1.0, 10.0, 1e2, 1e3])
@pytest.mark.parametrize("m,n", [(40, 4), (173, 5), (300, 10), (12, 12)])
def test_well_conditioned_batches_agree_with_float64(m, n, cond):
    rng = np.random.default_rng(m + n)
    A = np.stack([conditioned(rng, m, n, cond) for _ in range(3)])
    b = rng.standard_normal((3, m)).astype(np.float32)
    jx, jrank, js = jax_lstsq(A, b)
    got = port_lstsq(A, b)
    for i in range(3):
        want, rank = oracle(A[i], b[i])
        assert_near(got.x[i].numpy(), want)
        if cond <= 10:
            assert_near(jx[i], want)
        else:
            port_err = np.abs(got.x[i].numpy() - want).max()
            assert port_err <= np.abs(jx[i] - want).max() + 1e-6 * np.abs(want).max()
        assert int(got.rank[i]) == int(jrank[i]) == rank == n
    np.testing.assert_allclose(got.s.numpy(), js, rtol=1e-5, atol=1e-6)


def rank_deficient(rng, kind):
    if kind == "m<n":
        return rng.standard_normal((6, 9)).astype(np.float32), 6
    A = rng.standard_normal((50, 6)).astype(np.float32)
    if kind == "duplicated":
        A[:, 4] = A[:, 1]
    elif kind == "zero":
        A[:, 2] = 0.0
    else:  # both
        A[:, 4] = A[:, 1]
        A[:, 0] = 0.0
        return A, 4
    return A, 5


@pytest.mark.parametrize("kind", ["duplicated", "zero", "both", "m<n"])
def test_rank_deficient_systems_get_the_minimum_norm_answer(kind):
    rng = np.random.default_rng(len(kind))
    A, want_rank = rank_deficient(rng, kind)
    b = rng.standard_normal(A.shape[0]).astype(np.float32)
    jx, jrank, js = jax_lstsq(A[None], b[None])
    got = port_lstsq(A[None], b[None])
    want, rank = oracle(A, b)
    assert int(got.rank[0]) == int(jrank[0]) == rank == want_rank
    assert_near(jx[0], want)
    assert_near(got.x[0].numpy(), want)
    assert got.s.shape == (1, min(A.shape))
    np.testing.assert_allclose(got.s.numpy()[0, :want_rank], js[0, :want_rank], rtol=1e-5)


def test_one_system_and_the_empty_matrix():
    rng = np.random.default_rng(1)
    A = conditioned(rng, 200, 3, 10.0)
    b = rng.standard_normal(200).astype(np.float32)
    out = k21.lstsq(torch.from_numpy(A), torch.from_numpy(b))
    assert out.x.shape == (3,) and out.rank.shape == () and out.s.shape == (3,)
    assert_near(out.x.numpy(), np.asarray(jnp.linalg.lstsq(A, b)[0]))
    for m, n in [(0, 3), (4, 0), (0, 0)]:
        want = np.asarray(jnp.linalg.lstsq(jnp.zeros((m, n)), jnp.zeros(m))[0])
        k21.LAUNCHES.reset()
        got = k21.lstsq(torch.zeros((m, n)), torch.zeros(m))
        assert k21.LAUNCHES.snapshot() == {"lsq": 0, "lsq_plain": 0}
        assert got.x.shape == want.shape == (n,) and not got.x.any()
        assert int(got.rank) == 0 and got.s.shape == (0,)
    # a zero matrix: rank 0, x = 0, as JAX
    z = k21.lstsq(torch.zeros((5, 7, 2)), torch.ones((5, 7)))
    assert not z.x.any() and not z.rank.any()


def test_the_stock_shape_is_as_close_to_float64_as_jax():
    """[5, 173, 5]: RSI, three shifts and the intercept over 173 days, as
    ``RegressionStrategy.train`` builds them from the default panel."""
    from predictionio_tpu.models.experimental import stock as jstock

    ds = jstock.DataSource(jstock.DataSourceParams())
    td = ds.read_training(None)
    algo = jstock.RegressionStrategy()
    log_price = np.log(td.view().price_frame(td.max_window))
    inds = algo._indicators()
    first = max(ind.min_window() for ind in inds) + 3
    feats = np.stack([ind.get_training(log_price) for ind in inds], axis=-1)
    X = feats[first:-1].transpose(1, 0, 2)
    X = np.concatenate([X, np.ones((*X.shape[:2], 1))], axis=-1).astype(np.float32)
    ret = np.zeros_like(log_price)
    ret[:-1] = log_price[1:] - log_price[:-1]
    y = ret[first:-1].T.astype(np.float32).copy()
    assert X.shape == (5, 173, 5)
    jx, _, _ = jax_lstsq(X, y)
    got = port_lstsq(X, y).x.numpy()
    for i in range(5):
        want, _ = oracle(X[i], y[i])
        scale = np.abs(want).max()
        assert np.abs(got[i] - want).max() <= np.abs(jx[i] - want).max() + 1e-6 * scale


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="float32"):
        k21.lstsq(torch.zeros((3, 2), dtype=torch.float64), torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="b must"):
        k21.lstsq(torch.zeros((3, 2)), torch.zeros((3, 1)))
    with pytest.raises(ValueError, match="columns"):
        k21.lstsq(torch.zeros((100, k21.MAX_COLS + 1)), torch.zeros(100))
    with pytest.raises(ValueError):
        k21.lstsq(torch.zeros((2, 3, 2)), torch.zeros((2, 4)))


@pytest.mark.parametrize("N,m", [(1, 1), (1, 200_000), (500, 173), (5, 173), (3, 5_000)])
def test_the_gram_plan_covers_every_row_once(N, m):
    P, rows = k21.gram_plan(N, m)
    assert P * rows >= m and (P - 1) * rows < m
    assert N * P <= max(k21._GRAM_BLOCKS, N)
    if m >= 200_000:
        assert P > 100  # a tall system spreads over many blocks


def test_require_converged_raises_where_a_system_did_not_converge():
    x, rank, s = torch.zeros((3, 2)), torch.full((3,), 2, dtype=torch.int32), torch.ones((3, 2))
    done = k21.LstsqResult(x, rank, s, torch.tensor([0, 7, k21.MAX_SWEEPS - 1], dtype=torch.int32))
    assert k21.require_converged(done) is done
    twin = k21.lstsq(torch.eye(3), torch.ones(3))  # the twin reports no sweeps
    assert twin.sweeps is None and k21.require_converged(twin) is twin
    cut = done._replace(sweeps=torch.tensor([3, -1, -1], dtype=torch.int32))
    with pytest.raises(ArithmeticError, match="2 of 3 system"):
        k21.require_converged(cut)
