"""Classification and the e2 models on a device mesh in the port (K15s:
``train_naive_bayes``/``predict_naive_bayes(mesh=)``; K17s:
``CategoricalNaiveBayes.train(mesh=)``; K16s: ``MarkovChainModel.predict
(mesh=)``), the classification template's ``Engine.train`` on a mesh, and
``PAlgorithm``'s sharded-model persistence, on the CPU: the port's
``["cpu"] * S`` mesh against the JAX package's mesh over S of the
conftest's 8 virtual CPU devices, S in {4, 8}, on the reference's own
mesh-test data (``tests/test_mesh_kernels.py:24-130``) and on larger
seeded data whose cut gives every shard rows.

Tolerances, stated beforehand:
- against JAX's mesh: naive Bayes ``pi`` and ``theta`` within rtol 1e-5
  (the reference's bar for its mesh against its single device), labels
  equal; categorical naive Bayes counts and likelihoods equal exactly
  (integer counts); Markov within rtol 1e-6, atol 1e-7 (both sum the same
  float32 products; the port in float64).
- against the port's own single device: the K15s fit, every K15s label and
  the K17s counts bit for bit (the shards cut at K15a's and K17a's block
  boundaries, so every sum keeps its order); K16s within one float32 step
  of each entry (its float64 sums run in another order). K15a's shard
  tables (uneven and empty shards, 32-column tiles) keep the twin's bits,
  and a table past 64 shards is refused.
"""

import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.e2.markov_chain import MarkovChain as JaxMarkovChain
from predictionio_tpu.e2.naive_bayes import CategoricalNaiveBayes as JaxCNB
from predictionio_tpu.e2.naive_bayes import LabeledPoint as JaxPoint
from predictionio_tpu.ops import naive_bayes as jnb
from predictionio_tpu.parallel import make_mesh as jax_make_mesh
from predictionio_tpu_torch import controller as pctl
from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.e2 import CategoricalNaiveBayes, LabeledPoint, MarkovChain
from predictionio_tpu_torch.models.classification import engine as pcls
from predictionio_tpu_torch.ops import categorical_nb as k17
from predictionio_tpu_torch.ops import markov as k16
from predictionio_tpu_torch.ops import naive_bayes as k15
from predictionio_tpu_torch.parallel import Mesh, make_mesh
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.workflow_params import WorkflowParams

SHARDS = [4, 8]
NB_RTOL, MC_RTOL, MC_ATOL = 1e-5, 1e-6, 1e-7
CPU = torch.device("cpu")


def port_mesh(S):
    return make_mesh({"data": S}, ["cpu"] * S)


def jax_mesh(S):
    return jax_make_mesh({"data": S}, jax.devices()[:S])


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def steps_apart(a, b):
    """The largest distance in float32 steps between entries of two
    non-negative float32 vectors."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


# --- K15s: multinomial naive Bayes ---


def spy_fit_shards(monkeypatch):
    """The shard count of every ``naive_bayes_fit_shards`` call from here
    on: the evidence that a fit went through the mesh's shard table (the
    CPU counts one ``naive_bayes_fit_plain`` a fit either way)."""
    calls, real = [], k15.naive_bayes_fit_shards
    monkeypatch.setattr(k15, "naive_bayes_fit_shards",
                        lambda X, *a, **kw: calls.append(len(X)) or real(X, *a, **kw))
    return calls


def nb_data(n, F, C, seed, high=3.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, high, (n, F)).astype(np.float32), rng.integers(0, C, n).astype(np.float64)


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("n,F,C,lam,seed,high", [
    (67, 12, 3, 0.7, 0, 3.0), (64, 5, 2, 1.0, 1, 1.0), (3_000, 12, 3, 0.7, 2, 3.0),
], ids=["67-rows", "64-rows", "3000-rows"])
def test_nb_fit_on_a_mesh_matches_jax_and_one_device(S, n, F, C, lam, seed, high, monkeypatch):
    """The reference's two fit cases (67 rows, which do not divide the
    shards, and 64), and 3,000 rows, whose 6 blocks of 500 give several
    shards rows."""
    X, y = nb_data(n, F, C, seed, high)
    fits = spy_fit_shards(monkeypatch)
    k15.LAUNCHES.reset()
    got = k15.train_naive_bayes(X, y, lam=lam, mesh=port_mesh(S))
    counts = k15.LAUNCHES.snapshot()
    assert fits == [S]  # one fit over the S shards' table
    want = jnb.train_naive_bayes(X, y, lam=lam, mesh=jax_mesh(S))
    np.testing.assert_allclose(got.pi, want.pi, rtol=NB_RTOL)
    np.testing.assert_allclose(got.theta, want.theta, rtol=NB_RTOL)
    np.testing.assert_array_equal(got.labels, want.labels)
    one = k15.train_naive_bayes(X, y, lam=lam, device="cpu")
    assert same_bits(got.pi, one.pi) and same_bits(got.theta, one.theta)
    assert got.device == CPU
    bounds = k15.fit_shard_bounds(n, C, F, S)
    filled = int(np.count_nonzero(np.diff(bounds)))
    # every shard lies on the CPU: one fit over the shard table, as the card
    # runs one launch for the shards of a device
    assert counts["naive_bayes_fit_plain"] == 1 and counts["naive_bayes_fit_shard"] == 0
    if n == 3_000:
        assert filled > 1


def test_fit_shard_bounds_cut_whole_blocks():
    for n, C, F, S in [(50_000, 4, 3, 4), (3_000, 3, 12, 8), (513, 2, 1, 3), (1, 1, 1, 4)]:
        nblk, rows = k15.fit_plan(n, C, F)[:2]
        b = k15.fit_shard_bounds(n, C, F, S)
        assert b[0] == 0 and b[-1] == n and len(b) == S + 1 and (np.diff(b) >= 0).all()
        assert all(r % rows == 0 or r == n for r in b)


@pytest.mark.parametrize("n,F,C", [(5_000, 7, 5), (2_049, 3, 4)], ids=["5000x7", "2049x3"])
def test_the_fit_shard_twins_are_the_one_device_twin_bit_for_bit(n, F, C):
    """``naive_bayes_fit_shards`` on any whole-block cut (float features:
    every partial keeps its order) equals ``naive_bayes_fit``; a cut inside
    a block is refused."""
    X, y = nb_data(n, F, C, 4)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y.astype(np.int32))
    one = k15.naive_bayes_fit(Xt, yt, C, 0.7)
    rows = k15.fit_plan(n, C, F)[1]
    for cut in ([0, rows, n], [0, 0, 2 * rows, 2 * rows, n], [0, n, n]):
        parts = [(Xt[a:b], yt[a:b]) for a, b in zip(cut[:-1], cut[1:])]
        got = k15.naive_bayes_fit_shards([p[0] for p in parts], [p[1] for p in parts], C, 0.7,
                                         CPU)
        for g, w in zip(got, one):
            assert same_bits(g.numpy(), w.numpy())
    with pytest.raises(ValueError, match="whole blocks"):
        k15.naive_bayes_fit_shards([Xt[:7], Xt[7:]], [yt[:7], yt[7:]], C, 0.7, CPU)


@pytest.mark.parametrize("S", [3, 4])
@pytest.mark.parametrize("cut", ["plan", "uneven", "all-in-one"])
@pytest.mark.parametrize("n,F,C", [(5_000, 40, 3), (2_049, 3, 4)], ids=["F40", "F3"])
def test_the_fit_on_shard_tables_keeps_the_twins_bits(S, cut, n, F, C):
    """``naive_bayes_fit_shards`` on a ``["cpu"] * S`` shard table (the
    plan's cut; an uneven cut with an empty shard; every row in the last
    shard; F = 40 spans two 32-column tiles) is the single-device twin bit
    for bit, counted as one fit, as is ``naive_bayes_fit``."""
    X, y = nb_data(n, F, C, 6)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y.astype(np.int32))
    one = k15.fit_plain(Xt, yt, C, 0.7)
    rows = k15.fit_plan(n, C, F)[1]
    bounds = {"plan": k15.fit_shard_bounds(n, C, F, S).tolist(),
              "uneven": {3: [0, 0, 3 * rows, n], 4: [0, rows, rows, 3 * rows, n]}[S],
              "all-in-one": [0] * S + [n]}[cut]
    k15.LAUNCHES.reset()
    got = k15.naive_bayes_fit_shards([Xt[a:b] for a, b in zip(bounds[:-1], bounds[1:])],
                                     [yt[a:b] for a, b in zip(bounds[:-1], bounds[1:])], C, 0.7,
                                     CPU)
    assert all(same_bits(g.numpy(), w.numpy()) for g, w in zip(got, one)), bounds
    assert {k: v for k, v in k15.LAUNCHES.snapshot().items() if v} == {"naive_bayes_fit_plain": 1}
    got = k15.naive_bayes_fit(Xt, yt, C, 0.7)
    assert all(same_bits(g.numpy(), w.numpy()) for g, w in zip(got, one))


def test_the_fit_plan_and_its_shard_table_limits():
    """K15a's plan at 3n's shape (50,000 x 3, C = 4: 98 row blocks, one tile
    of each, 4,096 shared bytes a block) and a wide one (200,000 x 64,
    C = 10: 391 row blocks, 2 F tiles); a shard table holds at most 64
    shards, empty ones included."""
    assert k15.fit_plan(50_000, 4, 3) == (98, 511, 3, 85, 4)
    assert k15.fit_smem(4, 3) == 4 * (85 * 4 * 3 + 4) <= 48 * 1024
    assert k15.fit_plan(200_000, 10, 64)[:3] == (391, 512, 32)
    assert k15.fit_smem(10, 64) <= 48 * 1024
    X, y = nb_data(100, 3, 2, 1)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y.astype(np.int32))
    with pytest.raises(ValueError, match="at most 64 shards"):
        k15.naive_bayes_fit_shards([Xt[:0]] * 64 + [Xt], [yt[:0]] * 64 + [yt], 2, 1.0, CPU)
    got = k15.naive_bayes_fit_shards([Xt[:0]] * 63 + [Xt], [yt[:0]] * 63 + [yt], 2, 1.0, CPU)
    assert all(same_bits(g.numpy(), w.numpy()) for g, w in zip(got, k15.fit_plain(Xt, yt, 2, 1.0)))


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("B", [13, 3, 1_000], ids=["13-rows", "fewer-rows-than-shards",
                                                    "1000-rows"])
def test_nb_predict_on_a_mesh_matches_jax_and_one_device(S, B):
    rng = np.random.default_rng(2)
    X, y = nb_data(50, 8, 3, 2)
    j = jnb.train_naive_bayes(X, y)
    model = k15.NaiveBayesModelArrays(j.pi, j.theta, j.labels, device=CPU)
    q = rng.uniform(0, 3, (B, 8)).astype(np.float32)
    k15.LAUNCHES.reset()
    got = k15.predict_naive_bayes(model, q, mesh=port_mesh(S))
    # every shard on the one CPU device: one shard table, one twin call
    assert k15.LAUNCHES.snapshot()["naive_bayes_scores_plain"] == 1
    np.testing.assert_array_equal(got, jnb.predict_naive_bayes(j, q, mesh=jax_mesh(S)))
    np.testing.assert_array_equal(got, k15.predict_naive_bayes(model, q))


def test_nb_nan_and_tie_models_predict_on_a_mesh_as_on_one_device():
    """lam = 0 with a class whose feature 1 sums to 0 (NaN scores: the first
    NaN's class), and two classes trained on the same points (a tie: the
    first), on 4 shards."""
    X = np.asarray([[2, 0, 1], [1, 0, 3], [0, 2, 2], [1, 4, 0], [3, 1, 1], [0, 0, 5]], np.float32)
    Q = np.asarray([[1, 0, 0], [0, 0, 0], [0, 1, 1], [2, 0, 3], [0, 0, 1]], np.float32)
    X2 = np.concatenate([X[:2], X[:2], X[2:4]])
    mesh = port_mesh(4)
    for feats, labels, lam in ((X, [5, 5, 1, 1, 3, 3], 0.0), (X2, [4, 4, 2, 2, 9, 9], 1.0)):
        labels = np.asarray(labels, np.float32)
        m = k15.train_naive_bayes(feats, labels, lam=lam, mesh=mesh)
        one = k15.train_naive_bayes(feats, labels, lam=lam, device="cpu")
        assert same_bits(m.theta, one.theta) and same_bits(m.pi, one.pi)
        np.testing.assert_array_equal(k15.predict_naive_bayes(m, Q, mesh=mesh),
                                      k15.predict_naive_bayes(one, Q))
        j = jnb.train_naive_bayes(feats, labels, lam=lam)
        np.testing.assert_array_equal(k15.predict_naive_bayes(m, Q, mesh=mesh),
                                      jnb.predict_naive_bayes(j, Q, mesh=jax_mesh(4)))


# --- K17s: categorical naive Bayes ---


def categorical_points(n, seed, slots=(5, 4, 2), labels=3):
    rng = np.random.default_rng(seed)
    return [(str(rng.integers(0, labels)), tuple(str(rng.integers(0, c)) for c in slots))
            for _ in range(n)]


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("n,seed", [(41, 3), (2, 0), (30_000, 5)],
                         ids=["41-points", "fewer-points-than-devices", "30000-points"])
def test_cnb_train_on_a_mesh_equals_jax_and_one_device(S, n, seed):
    """The reference's two cases (41 points; 2 points on 8 devices) and
    30,000 points (90,000 keys: 11 blocks, so several shards count)."""
    raw = categorical_points(n, seed) if n != 2 else [("a", ("x",)), ("b", ("y",))]
    k17.LAUNCHES.reset()
    got = CategoricalNaiveBayes.train([LabeledPoint(l, f) for l, f in raw], mesh=port_mesh(S))
    counts = k17.LAUNCHES.snapshot()
    want = JaxCNB.train([JaxPoint(l, f) for l, f in raw], mesh=jax_mesh(S))
    one = CategoricalNaiveBayes.train([LabeledPoint(l, f) for l, f in raw], device="cpu")
    for m in (want, one):
        np.testing.assert_array_equal(got.log_priors, m.log_priors)
        np.testing.assert_array_equal(got.log_likelihoods, m.log_likelihoods)
    assert same_bits(got.log_likelihoods, one.log_likelihoods)
    assert got.device == CPU
    assert got.predict(raw[0][1]) == want.predict(raw[0][1]) == one.predict(raw[0][1])
    M = n * len(raw[0][1])
    filled = int(np.count_nonzero(np.diff(k17.count_shard_bounds(M, 1, S))))
    assert counts["cnb_count_shard_plain"] == filled and counts["cnb_count_finish_plain"] == 1
    assert counts["cnb_count_plain"] == 0
    if n == 30_000:
        assert filled > 1


def test_the_count_shard_twins_are_the_one_device_counts():
    rng = np.random.default_rng(9)
    keys = torch.from_numpy(rng.integers(-3, 700, 40_000).astype(np.int32))  # some out of range
    one = k17.cnb_count(keys, 650)
    per = k17.count_plan(len(keys), 650)[1]
    for cut in ([0, per, len(keys)], [0, 0, 3 * per, len(keys), len(keys)]):
        got = k17.cnb_count_shards([keys[a:b] for a, b in zip(cut[:-1], cut[1:])], 650, CPU)
        assert torch.equal(got, one)
    with pytest.raises(ValueError, match="whole blocks"):
        k17.cnb_count_shards([keys[:5], keys[5:]], 650, CPU)
    assert torch.equal(k17.cnb_count_shards([keys[:0]] * 3, 650, CPU), torch.zeros(650, dtype=torch.int32))


# --- K16s: one Markov step ---


def markov_entries(n_states, n_entries, seed):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, n_states)), int(rng.integers(0, n_states)),
             float(rng.integers(1, 9))) for _ in range(n_entries)]


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("n_states,n_entries,top_n,seed", [
    (21, 200, 3, 12), (3, 4, 2, 1), (700, 6_000, 5, 7),
], ids=["21-states", "fewer-states-than-shards", "700-states"])
def test_markov_predict_on_a_mesh_matches_jax_and_one_device(S, n_states, n_entries, top_n, seed):
    """The reference's case (21 states, which do not divide 8), a chain of
    fewer states than shards, and 700 states."""
    entries = markov_entries(n_states, n_entries, seed)
    model = MarkovChain.train(entries, n_states, top_n, device="cpu")
    jmodel = JaxMarkovChain.train(entries, n_states, top_n)
    rng = np.random.default_rng(seed + 1)
    mesh = port_mesh(S)
    for _ in range(3):
        cur = rng.dirichlet(np.ones(n_states)).astype(np.float32)
        k16.LAUNCHES.reset()
        got = model.predict(cur, mesh=mesh)
        counts = k16.LAUNCHES.snapshot()
        assert counts["markov_step_shard_plain"] == min(n_states, S)
        assert counts["markov_step_finish_plain"] == 1 and counts["markov_step_plain"] == 0
        np.testing.assert_allclose(got, jmodel.predict(cur, mesh=jax_mesh(S)),
                                   rtol=MC_RTOL, atol=MC_ATOL)
        assert steps_apart(got, model.predict(cur)) <= 1


def test_the_markov_shard_twins_are_within_a_step_of_one_device():
    """Through the wrappers: ``markov_step_shards`` on every cut of a
    skewed chain (a hot target with hundreds of sources) within one float32
    step of ``markov_step``, and a 1-shard cut bit for bit."""
    n = 400
    rng = np.random.default_rng(4)
    entries = [(int(s), int(t), float(c)) for s, t, c in zip(
        rng.integers(0, n, 8_000), np.where(rng.random(8_000) < 0.3, 7, rng.integers(0, n, 8_000)),
        rng.integers(1, 6, 8_000))]
    model = MarkovChain.train(entries, n, 10, device="cpu")
    cur = torch.from_numpy(rng.dirichlet(np.ones(n)).astype(np.float32))
    one = k16.markov_step(cur, k16.place_transitions(model.targets, model.probs, n, CPU))
    for S in (1, 2, 5, 8):
        placed = k16.place_transitions_mesh(model.targets, model.probs, n, [CPU] * S)
        curs = [cur[a:b] for a, b in zip(placed.bounds[:-1], placed.bounds[1:])]
        got = k16.markov_step_shards(curs, placed)
        assert steps_apart(got.numpy(), one.numpy()) <= (0 if S == 1 else 1)
    with pytest.raises(ValueError, match="state slice"):
        k16.markov_step_shards([cur[:3]] + curs[1:], placed)


def test_markov_placement_cache_keys_the_mesh_by_identity():
    """As the reference's ``tests/test_e2.py:130-166``: the cache holds the
    mesh by weakref and compares identity; a dead mesh's entry serves
    neither ``mesh=None`` nor another mesh, and ``mesh=None`` never hits a
    mesh's entry."""
    model = MarkovChain.train([(0, 1, 1.0), (1, 2, 3.0), (1, 0, 1.0), (2, 2, 1.0)], 3, 2,
                              device="cpu")
    mesh = port_mesh(2)
    expected = model.predict([1.0, 0.0, 0.0])
    assert model.predict([1.0, 0.0, 0.0], mesh=mesh) == expected
    placed_for_mesh = model._placed
    assert isinstance(placed_for_mesh[0], weakref.ref) and placed_for_mesh[0]() is mesh
    assert model.predict([1.0, 0.0, 0.0], mesh=mesh) == expected
    assert model._placed is placed_for_mesh  # reused, not placed again
    assert model.predict([1.0, 0.0, 0.0]) == expected
    assert model._placed[0] is None and isinstance(model._placed[2], k16.PlacedTransitions)

    class _Gone:
        pass

    dead = weakref.ref(_Gone())
    gc.collect()
    assert dead() is None
    model._placed = (dead,) + placed_for_mesh[1:]
    assert model.predict([1.0, 0.0, 0.0]) == expected
    assert model._placed[0] is None  # placed again, not served stale
    mesh2 = port_mesh(2)
    model._placed = (dead,) + placed_for_mesh[1:]
    assert model.predict([1.0, 0.0, 0.0], mesh=mesh2) == expected
    assert model._placed[0]() is mesh2


# --- the edges every program shares ---


def test_a_one_shard_mesh_collapses_and_other_meshes_raise(monkeypatch):
    X, y = nb_data(300, 3, 2, 0)
    fits = spy_fit_shards(monkeypatch)
    one_mesh = make_mesh({"data": 1}, ["cpu"])
    two_d = Mesh(["cpu"] * 4, {"data": 2, "model": 2})
    model = MarkovChain.train(markov_entries(9, 40, 3), 9, 2, device="cpu")
    pts = [LabeledPoint(l, f) for l, f in categorical_points(20, 1)]
    for mod in (k15, k16, k17):
        mod.LAUNCHES.reset()
    m = k15.train_naive_bayes(X, y, mesh=one_mesh)
    k15.predict_naive_bayes(m, X[:9], mesh=one_mesh)
    CategoricalNaiveBayes.train(pts, mesh=one_mesh)
    assert model.predict(np.full(9, 1 / 9), mesh=one_mesh) == model.predict(np.full(9, 1 / 9))
    # one shard runs the single-device wrappers, never a shard form
    assert k15.LAUNCHES.snapshot()["naive_bayes_fit_plain"] == 1 and fits == []
    assert k17.LAUNCHES.snapshot()["cnb_count_plain"] == 1
    assert k16.LAUNCHES.snapshot()["markov_step_shard_plain"] == 0
    assert m.device == CPU
    calls = [
        lambda mesh: k15.train_naive_bayes(X, y, mesh=mesh),
        lambda mesh: k15.predict_naive_bayes(m, X, mesh=mesh),
        lambda mesh: CategoricalNaiveBayes.train(pts, mesh=mesh),
        lambda mesh: model.predict(np.full(9, 1 / 9), mesh=mesh),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="1-D"):
            call(two_d)
        with pytest.raises(TypeError, match="Mesh"):
            call(jax_mesh(4))
    with pytest.raises(ValueError, match="axis"):
        model.predict(np.full(9, 1 / 9), mesh=port_mesh(2), axis="model")
    with pytest.raises(ValueError, match="axis"):
        CategoricalNaiveBayes.train(pts, mesh=port_mesh(2), axis="model")


# --- the classification template and PAlgorithm ---


def classification_context(S, n=2_000, seed=13):
    """Config 2's family (class-conditional Poisson counts) as the users'
    aggregated properties, on a ``["cpu"] * S`` mesh."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(1.0, 8.0, size=(4, 3))
    y = rng.integers(0, 4, n)
    X = rng.poisson(means[y]).astype(np.float32)
    props = {f"u{j}": {"plan": float(y[j]), "attr0": float(X[j, 0]), "attr1": float(X[j, 1]),
                       "attr2": float(X[j, 2])} for j in range(n)}
    mesh = port_mesh(S) if S > 1 else None
    return WorkflowContext("cpu", properties={("app", "user"): props}, mesh=mesh)


def nb_engine_params():
    return EngineParams(
        data_source_params=("", pcls.DataSourceParams(app_name="app")),
        algorithm_params_list=(("naive", pcls.NaiveBayesAlgorithmParams(lambda_=0.5)),),
    )


def test_the_classification_engine_trains_naive_bayes_on_the_mesh(monkeypatch):
    assert pcls.NaiveBayesAlgorithm.MESH_TRAINING
    assert not pcls.LogisticRegressionAlgorithm.MESH_TRAINING
    engine = pcls.classification_engine()
    fits = spy_fit_shards(monkeypatch)
    k15.LAUNCHES.reset()
    [got] = engine.train(classification_context(4), nb_engine_params(), WorkflowParams())
    counts = k15.LAUNCHES.snapshot()
    # trained on the 4-shard mesh: one fit over its shard table
    assert fits == [4] and counts["naive_bayes_fit_plain"] == 1
    [one] = engine.train(classification_context(1), nb_engine_params(), WorkflowParams())
    assert fits == [4]  # one device: no shard table
    assert same_bits(got.pi, one.pi) and same_bits(got.theta, one.theta)
    np.testing.assert_array_equal(got.labels, one.labels)
    assert got.device == CPU
    queries = [(i, pcls.Query(features=(float(i % 5), 2.0, 3.0))) for i in range(20)]
    algo = pcls.NaiveBayesAlgorithm(pcls.NaiveBayesAlgorithmParams(lambda_=0.5))
    assert algo.batch_predict(got, queries) == algo.batch_predict(one, queries)


class ShardedNaiveBayes(pcls.NaiveBayesAlgorithm, pctl.PAlgorithm):
    """A naive Bayes whose model is declared sharded: not persisted."""


def test_a_sharded_model_persists_as_none_and_is_retrained_on_deploy(monkeypatch):
    engine = Engine(pcls.DataSource, pcls.Preparator,
                    {"sharded": ShardedNaiveBayes, "naive": pcls.NaiveBayesAlgorithm})
    ep = EngineParams(
        data_source_params=("", pcls.DataSourceParams(app_name="app")),
        algorithm_params_list=(("sharded", pcls.NaiveBayesAlgorithmParams(lambda_=0.5)),
                               ("naive", pcls.NaiveBayesAlgorithmParams(lambda_=0.5))),
    )
    ctx = classification_context(4)
    assert ShardedNaiveBayes.sharded_model and not pcls.NaiveBayesAlgorithm.sharded_model
    models = engine.train(ctx, ep, WorkflowParams())
    kept = engine.make_serializable_models(CPU, "inst", ep, models)
    assert kept[0] is None and kept[1] is models[1]
    with pytest.raises(ValueError, match="ShardedNaiveBayes"):
        engine.prepare_deploy(CPU, ep, kept)
    k15.LAUNCHES.reset()
    fits = spy_fit_shards(monkeypatch)
    deployed = engine.prepare_deploy(CPU, ep, kept, ctx=ctx)
    # re-trained on the 4-shard mesh: one fit over its shard table
    assert fits == [4] and k15.LAUNCHES.snapshot()["naive_bayes_fit_plain"] == 1
    assert same_bits(deployed[0].theta, models[0].theta) and deployed[1] is not None
    assert same_bits(deployed[1].theta, models[1].theta)


def test_the_reference_aliases_are_the_bases():
    assert pctl.PDataSource is pctl.LDataSource is pctl.BaseDataSource
    assert pctl.PPreparator is pctl.LPreparator is pctl.BasePreparator
    assert pctl.P2LAlgorithm is pctl.LAlgorithm is pctl.BaseAlgorithm
    assert issubclass(pctl.PAlgorithm, pctl.BaseAlgorithm) and pctl.PAlgorithm.sharded_model
    assert issubclass(pctl.LServing, pctl.BaseServing)
    assert pctl.AverageServing().serve(None, [1.0, 2.0, 4.5]) == 2.5
