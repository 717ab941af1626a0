"""K15, multinomial naive Bayes in the port (``ops/naive_bayes.py``) on the
CPU, where its wrappers run the plain twins, against the JAX package's
``predictionio_tpu/ops/naive_bayes.py`` on the same seeded numpy inputs.

Tolerances:
- integer features (Poisson counts, the bench's family): the class counts
  and sums exact (every partial sum is an integer below 2^24), ``pi`` and
  ``theta`` within 2e-6 absolute (``log`` differs between XLA's CPU and
  torch by about one float32 step);
- float features: sums within 1e-5 of their float64 value relative, ``pi``
  and ``theta`` within 1e-5 absolute (the sums' order differs);
- scores within 1e-5 absolute (XLA's dot sums in its own order); predicted
  labels equal, with the NaN and tie rules of ``jnp.argmax`` exact.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import naive_bayes as jnb
from predictionio_tpu_torch.ops import naive_bayes as pnb

INT_TOL, FLOAT_TOL, SCORE_TOL = 2e-6, 1e-5, 1e-5


def poisson_data(n, F, C, seed):
    rng = np.random.default_rng(seed)
    means = rng.uniform(1.0, 8.0, size=(C, F))
    y = rng.integers(0, C, n)
    return rng.poisson(means[y]).astype(np.float32), y


def float_data(n, F, C, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, C, n)
    return rng.uniform(0.0, 3.0, size=(n, F)).astype(np.float32), y


def jax_fit(X, y, C, lam):
    pi, theta = jnb._fit(jnp.asarray(X), jnp.asarray(y.astype(np.int32)), jnp.float32(lam),
                         n_classes=C)
    return np.asarray(pi), np.asarray(theta)


def port_fit(X, y, C, lam):
    return pnb.naive_bayes_fit(torch.from_numpy(X), torch.from_numpy(y.astype(np.int32)), C, lam)


@pytest.mark.parametrize("n,F,C,lam,seed", [
    (2_000, 3, 4, 1.0, 13), (500, 7, 5, 0.7, 2), (300, 40, 3, 1.0, 5), (50, 1, 1, 0.5, 9),
], ids=["bench-like", "7x5", "wide", "one-class"])
def test_fit_on_integer_features_is_exact_and_matches_jax(n, F, C, lam, seed):
    X, y = poisson_data(n, F, C, seed)
    fit = port_fit(X, y, C, lam)
    want_counts = np.bincount(y, minlength=C)
    want_sums = np.zeros((C, F))
    np.add.at(want_sums, y, X.astype(np.float64))
    np.testing.assert_array_equal(fit.counts.numpy(), want_counts)
    np.testing.assert_array_equal(fit.sums.numpy(), want_sums.astype(np.float32))
    jpi, jtheta = jax_fit(X, y, C, lam)
    np.testing.assert_allclose(fit.pi.numpy(), jpi, rtol=0, atol=INT_TOL)
    np.testing.assert_allclose(fit.theta.numpy(), jtheta, rtol=0, atol=INT_TOL)


@pytest.mark.parametrize("n,F,C,lam,seed", [(5_000, 7, 5, 0.7, 3), (800, 64, 10, 1.0, 4)],
                         ids=["5000x7", "800x64"])
def test_fit_on_float_features_matches_jax(n, F, C, lam, seed):
    X, y = float_data(n, F, C, seed)
    fit = port_fit(X, y, C, lam)
    want_sums = np.zeros((C, F))
    np.add.at(want_sums, y, X.astype(np.float64))
    np.testing.assert_array_equal(fit.counts.numpy(), np.bincount(y, minlength=C))
    np.testing.assert_allclose(fit.sums.numpy(), want_sums, rtol=FLOAT_TOL, atol=0)
    jpi, jtheta = jax_fit(X, y, C, lam)
    np.testing.assert_allclose(fit.pi.numpy(), jpi, rtol=0, atol=FLOAT_TOL)
    np.testing.assert_allclose(fit.theta.numpy(), jtheta, rtol=0, atol=FLOAT_TOL)


def test_labels_outside_the_classes_count_nowhere():
    """An index outside [0, C) counts in no class, as the reference's
    padding rows (label index C) do."""
    X, y = poisson_data(400, 3, 4, 1)
    y_pad = np.concatenate([y, [4, 4, -1]]).astype(np.int32)
    X_pad = np.concatenate([X, np.full((3, 3), 9.0, np.float32)])
    fit = port_fit(X_pad, y_pad, 4, 1.0)
    ref = port_fit(X, y, 4, 1.0)
    for got, want in zip(fit, ref):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    jpi, jtheta = jax_fit(X_pad, np.where(y_pad < 0, 4, y_pad), 4, 1.0)
    np.testing.assert_allclose(fit.pi.numpy(), jpi, rtol=0, atol=INT_TOL)
    np.testing.assert_allclose(fit.theta.numpy(), jtheta, rtol=0, atol=INT_TOL)


@pytest.mark.parametrize("label_values", [
    (0.0, 1.0, 2.0, 3.0), (7.0, 0.5, 2.0), (-1.0, 3.25),
], ids=["0..3", "7,0.5,2", "-1,3.25"])
def test_train_naive_bayes_matches_jax(label_values):
    rng = np.random.default_rng(len(label_values))
    n, F = 600, 3
    X, y = poisson_data(n, F, len(label_values), 11)
    labels = np.asarray(label_values, np.float32)[y]
    m = pnb.train_naive_bayes(X, labels, lam=1.0, device="cpu")
    j = jnb.train_naive_bayes(X, labels, lam=1.0)
    np.testing.assert_array_equal(m.labels, j.labels)
    np.testing.assert_allclose(m.pi, j.pi, rtol=0, atol=INT_TOL)
    np.testing.assert_allclose(m.theta, j.theta, rtol=0, atol=INT_TOL)
    assert m.device == torch.device("cpu") and m.n_classes == len(label_values)
    Q = rng.poisson(4.0, size=(64, F)).astype(np.float32)
    np.testing.assert_array_equal(
        pnb.predict_naive_bayes(m, Q), jnb.predict_naive_bayes(j, Q))


def test_scores_match_jax_and_labels_match_jax_predict():
    rng = np.random.default_rng(7)
    X, y = float_data(1_000, 6, 5, 7)
    j = jnb.train_naive_bayes(X, y.astype(np.float32), lam=1.0)
    Q = rng.uniform(0.0, 3.0, size=(257, 6)).astype(np.float32)
    pi, theta = torch.tensor(j.pi), torch.tensor(j.theta)
    idx, scores = pnb.naive_bayes_scores(torch.from_numpy(Q), pi, theta, with_scores=True)
    jscores = np.asarray(jnb._scores(jnp.asarray(Q), jnp.asarray(j.pi), jnp.asarray(j.theta)))
    np.testing.assert_allclose(scores.numpy(), jscores, rtol=0, atol=SCORE_TOL)
    assert idx.dtype == torch.int32
    model = pnb.NaiveBayesModelArrays(j.pi, j.theta, j.labels, device=torch.device("cpu"))
    np.testing.assert_array_equal(pnb.predict_naive_bayes(model, Q), jnb.predict_naive_bayes(j, Q))
    # without scores the wrapper returns None for them
    idx2, none = pnb.naive_bayes_scores(torch.from_numpy(Q), pi, theta)
    assert none is None and torch.equal(idx, idx2)


@pytest.mark.parametrize("row", [
    [1.0, math.nan, 2.0, math.nan], [2.0, 2.0], [-math.inf, -math.inf, -math.inf],
    [math.nan, math.nan], [0.5, 3.0, 3.0, -1.0], [-math.inf, math.nan, 5.0], [4.0],
    [1.0, math.inf, math.inf, math.nan],
], ids=["nan-mid", "tie", "all-minus-inf", "all-nan", "tie-late", "nan-after-inf", "one",
        "inf-then-nan"])
def test_argmax_first_nan_is_jnp_argmax(row):
    scores = np.asarray([row], np.float32)
    got = pnb.argmax_first_nan(torch.from_numpy(scores))
    assert got.dtype == torch.int32
    assert int(got[0]) == int(jnp.argmax(jnp.asarray(scores), axis=1)[0])


def test_lambda_zero_nan_scores_and_ties_predict_as_jax():
    """lam = 0 with a class whose feature 1 sums to 0: theta holds -inf,
    a query with that feature 0 scores 0·(-inf) = NaN, and the label is the
    first NaN's class. Two classes trained on the same points tie on every
    query, and the label is the first of them."""
    X = np.asarray([[2, 0, 1], [1, 0, 3], [0, 2, 2], [1, 4, 0], [3, 1, 1], [0, 0, 5]],
                   np.float32)
    labels = np.asarray([5.0, 5.0, 1.0, 1.0, 3.0, 3.0], np.float32)
    Q = np.asarray([[1, 0, 0], [0, 0, 0], [0, 1, 1], [2, 0, 3], [0, 0, 1]], np.float32)
    j = jnb.train_naive_bayes(X, labels, lam=0.0)
    m = pnb.train_naive_bayes(X, labels, lam=0.0, device="cpu")
    assert np.isneginf(m.theta).any()
    _, scores = pnb.naive_bayes_scores(torch.from_numpy(Q), torch.from_numpy(m.pi),
                                       torch.from_numpy(m.theta), with_scores=True)
    assert np.isnan(scores.numpy()).any(axis=1).tolist() == [True, True, False, True, True]
    assert np.isneginf(scores.numpy()[2, 2])
    np.testing.assert_array_equal(pnb.predict_naive_bayes(m, Q), jnb.predict_naive_bayes(j, Q))
    # classes 2.0 and 4.0 see the same points: equal pi and theta rows
    X2 = np.concatenate([X[:2], X[:2], X[2:4]])
    labels2 = np.asarray([4.0, 4.0, 2.0, 2.0, 9.0, 9.0], np.float32)
    j2 = jnb.train_naive_bayes(X2, labels2, lam=1.0)
    m2 = pnb.train_naive_bayes(X2, labels2, lam=1.0, device="cpu")
    _, scores = pnb.naive_bayes_scores(torch.from_numpy(Q), torch.from_numpy(m2.pi),
                                       torch.from_numpy(m2.theta), with_scores=True)
    assert (scores.numpy()[:, 0] == scores.numpy()[:, 1]).all()
    got = pnb.predict_naive_bayes(m2, Q)
    np.testing.assert_array_equal(got, jnb.predict_naive_bayes(j2, Q))
    assert 4.0 not in got


@pytest.mark.parametrize("features,labels", [
    (np.asarray([[-1.0, 2.0]]), np.asarray([0.0])),
    (np.zeros((0, 3), np.float32), np.zeros(0)),
    (np.zeros((4, 3), np.float32), np.zeros(3)),
    (np.zeros(4, np.float32), np.zeros(4)),
], ids=["negative", "empty", "misaligned", "one-dimensional"])
def test_host_checks_raise_as_the_reference(features, labels):
    with pytest.raises(ValueError):
        jnb.train_naive_bayes(features, labels)
    with pytest.raises(ValueError):
        pnb.train_naive_bayes(features, labels, device="cpu")


def test_a_mesh_raises_and_names_item_11():
    """Since the mesh forms (K15s, ROADMAP.md queue 1 item 11) a mesh that is
    not a port ``Mesh`` raises ``TypeError``, and another axis
    ``ValueError``."""
    X, y = poisson_data(20, 3, 2, 0)
    with pytest.raises(TypeError, match="Mesh"):
        pnb.train_naive_bayes(X, y, mesh=object(), device="cpu")
    m = pnb.train_naive_bayes(X, y, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        pnb.predict_naive_bayes(m, X, mesh=object())
    with pytest.raises(ValueError, match="axis"):
        pnb.train_naive_bayes(X, y, axis="model", device="cpu")


def test_cpu_tensors_run_the_twins_and_are_counted():
    X, y = poisson_data(100, 3, 2, 0)
    pnb.LAUNCHES.reset()
    fit = port_fit(X, y, 2, 1.0)
    pnb.naive_bayes_scores(torch.from_numpy(X), fit.pi, fit.theta)
    assert pnb.LAUNCHES.snapshot() == {
        "naive_bayes_fit": 0, "naive_bayes_scores": 0,
        "naive_bayes_fit_plain": 1, "naive_bayes_scores_plain": 1,
        "naive_bayes_fit_shard": 0,
    }


@pytest.mark.parametrize("bad", ["dtype", "labels-shape", "scores-shape"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    X = torch.zeros((4, 3))
    y = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        if bad == "dtype":
            pnb.naive_bayes_fit(X.double(), y, 2, 1.0)
        elif bad == "labels-shape":
            pnb.naive_bayes_fit(X, y[:3], 2, 1.0)
        else:
            pnb.naive_bayes_scores(X, torch.zeros(2), torch.zeros((2, 4)))


@pytest.mark.parametrize("n,C,F", [
    (1, 1, 1), (50_000, 4, 3), (200_000, 10, 64), (10_000, 300, 5), (7, 2, 1_000),
    (3_000_000, 2_000, 40),
])
def test_fit_plan_covers_every_row_once_and_fits_a_block(n, C, F):
    """The plan's blocks split [0, n) with none empty; a block's lanes and
    class tile fit its threads and shared memory; the partials stay within
    their cap."""
    nblk, rows, Ft, L, Ct = pnb.fit_plan(n, C, F)
    assert (nblk - 1) * rows < n <= nblk * rows
    assert 1 <= Ft <= 32 and 1 <= L and L * Ft <= 256
    assert 1 <= Ct <= C and (L * Ct * Ft + Ct) * 4 <= 48 * 1024
    assert nblk == 1 or nblk * C * F <= pnb._FIT_PARTIAL_FLOATS
