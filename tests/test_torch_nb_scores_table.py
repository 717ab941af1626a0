"""K15b over a shard table (``ops/naive_bayes.naive_bayes_scores_table``)
and the serving placement of a naive Bayes model's pi and theta, on the
CPU, where the wrappers run the plain twin.

A batch cut into S shards (S in {1, 2, 3, 4}, empty shards and blocks out
of the upload's order included) must give one device's labels and scores
bit for bit (every row's arithmetic is the same whatever its shard), and
the labels of the JAX package's ``predict_naive_bayes``, on a random model,
a lam = 0 model with NaN scores and a model with tied classes. No
tolerance: labels are compared exactly, scores bit for bit.
"""

import pickle

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import naive_bayes as jnb
from predictionio_tpu_torch.models.classification import engine as pcls
from predictionio_tpu_torch.ops import naive_bayes as k15
from predictionio_tpu_torch.parallel import Mesh
from predictionio_tpu_torch.utils.serialize import load_model, save_model

CPU = torch.device("cpu")
X_ODD = np.asarray([[2, 0, 1], [1, 0, 3], [0, 2, 2], [1, 4, 0], [3, 1, 1], [0, 0, 5]], np.float32)


def model_and_queries(kind):
    """(JAX model, port model, queries) of one of three kinds."""
    rng = np.random.default_rng(11)
    if kind == "random":
        y = rng.integers(0, 5, 400)
        X = rng.poisson(rng.uniform(1, 6, (5, 7))[y]).astype(np.float32)
        labels, lam = (y * 1.5).astype(np.float32), 1.0
        Q = rng.poisson(3.0, (37, 7)).astype(np.float32)
    elif kind == "nan":  # lam = 0: class 5.0 has theta -inf on feature 1
        X, labels, lam = X_ODD, np.asarray([5, 5, 1, 1, 3, 3], np.float32), 0.0
        Q = np.tile(np.asarray([[1, 0, 0], [0, 0, 0], [0, 1, 1], [2, 0, 3], [0, 0, 1]],
                               np.float32), (3, 1))
    else:  # classes 2.0 and 4.0 saw the same points: a tie on every row
        X = np.concatenate([X_ODD[:2], X_ODD[:2], X_ODD[2:4]])
        labels, lam = np.asarray([4, 4, 2, 2, 9, 9], np.float32), 1.0
        Q = rng.poisson(2.0, (11, 3)).astype(np.float32)
    j = jnb.train_naive_bayes(X, labels, lam=lam)
    m = k15.train_naive_bayes(X, labels, lam=lam, device="cpu")
    return j, m, Q


def cuts(B, S, kind):
    """Row bounds of S shards over B rows: even, or with empty shards."""
    if kind == "even":
        return np.linspace(0, B, S + 1).astype(int)
    inner = sorted(np.random.default_rng(S).integers(0, B + 1, S - 1).tolist())
    bounds = [0, *inner, B]
    if S > 1:
        bounds[1] = 0  # the first shard empty
    return np.asarray(bounds)


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("cut", ["even", "empty"])
@pytest.mark.parametrize("kind", ["random", "nan", "tie"])
def test_a_shard_table_is_one_device_bit_for_bit_and_jax(S, cut, kind):
    j, m, Q = model_and_queries(kind)
    pi, theta = k15.placed(m, CPU)
    X = torch.from_numpy(Q)
    want, want_scores = k15.naive_bayes_scores(X, pi, theta, with_scores=True)
    B, C = len(Q), len(m.pi)
    bounds = cuts(B, S, cut)
    # the blocks in reverse shard order: a shard's block need not follow
    # its place in the upload
    out = torch.full((B,), -7, dtype=torch.int32)
    scores = torch.full((B, C), 123.0)
    shards, at = [], B
    for a, b in zip(bounds[:-1], bounds[1:]):
        at -= b - a
        shards.append(k15.ScoresShard(X[a:b], out[at:at + b - a], scores[at:at + b - a]))
    k15.LAUNCHES.reset()
    k15.naive_bayes_scores_table(shards, pi, theta)
    assert k15.LAUNCHES.snapshot()["naive_bayes_scores_plain"] == 1
    order = np.concatenate([np.arange(a, b) for a, b in zip(bounds[:-1], bounds[1:])][::-1])
    assert torch.equal(out, want[order])
    assert np.array_equal(scores.numpy().view(np.int32), want_scores[order].numpy().view(np.int32))
    np.testing.assert_array_equal(m.labels[out.numpy()], jnb.predict_naive_bayes(j, Q[order]))


def test_scores_without_a_scores_block_and_into_out():
    _, m, Q = model_and_queries("random")
    pi, theta = k15.placed(m, CPU)
    X = torch.from_numpy(Q)
    want, _ = k15.naive_bayes_scores(X, pi, theta)
    out = torch.empty(len(Q), dtype=torch.int32)
    k15.naive_bayes_scores_table([k15.ScoresShard(X[:20], out[:20]),
                                  k15.ScoresShard(X[20:], out[20:])], pi, theta)
    assert torch.equal(out, want)
    got, none = k15.naive_bayes_scores(X, pi, theta, out=torch.empty(len(Q), dtype=torch.int32))
    assert none is None and torch.equal(got, want)
    idx, sc = k15.naive_bayes_scores(X, pi, theta, with_scores=True)
    assert torch.equal(idx, want) and sc.shape == (len(Q), len(m.pi))


def refusals():
    _, m, Q = model_and_queries("random")
    pi, theta = k15.placed(m, CPU)
    X = torch.from_numpy(Q)
    B, C = X.shape[0], theta.shape[0]
    out = torch.empty(B, dtype=torch.int32)
    one = k15.ScoresShard(X, out)
    return {
        "no-shards": lambda: k15.naive_bayes_scores_table([], pi, theta),
        "65-shards": lambda: k15.naive_bayes_scores_table([k15.ScoresShard(X[:0], out[:0])] * 64
                                                          + [one], pi, theta),
        "float64-rows": lambda: k15.naive_bayes_scores_table(
            [k15.ScoresShard(X.double(), out)], pi, theta),
        "wide-rows": lambda: k15.naive_bayes_scores_table(
            [k15.ScoresShard(torch.zeros((B, 8)), out)], pi, theta),
        "short-block": lambda: k15.naive_bayes_scores_table(
            [k15.ScoresShard(X, out[:-1])], pi, theta),
        "int64-block": lambda: k15.naive_bayes_scores_table(
            [k15.ScoresShard(X, out.long())], pi, theta),
        "scores-shape": lambda: k15.naive_bayes_scores_table(
            [k15.ScoresShard(X, out, torch.empty((B, C + 1)))], pi, theta),
        "another-device": lambda: k15.naive_bayes_scores_table(
            [k15.ScoresShard(X.to("meta"), out)], pi, theta),
        "pi-theta": lambda: k15.naive_bayes_scores_table([one], pi[:-1], theta),
        "float64-model": lambda: k15.naive_bayes_scores_table([one], pi.double(), theta.double()),
    }


@pytest.mark.parametrize("case", list(refusals()))
def test_the_table_refuses_what_the_entry_point_does_not_take(case):
    with pytest.raises(ValueError):
        refusals()[case]()


def test_two_batches_reuse_one_placement_and_another_device_places_again():
    _, m, Q = model_and_queries("random")
    fresh = pcls.nb_model_from_numpy(m.pi, m.theta, m.labels, device="cpu")
    assert fresh._placed is None
    k15.PLACEMENTS.reset()
    first = k15.predict_naive_bayes(fresh, Q)
    second = k15.predict_naive_bayes(fresh, Q[:5])
    assert k15.PLACEMENTS.snapshot()["naive_bayes_place"] == 1
    np.testing.assert_array_equal(second, first[:5])
    # a trained model keeps its fit's arrays: no placement at all
    k15.PLACEMENTS.reset()
    k15.predict_naive_bayes(m, Q)
    assert k15.PLACEMENTS.snapshot()["naive_bayes_place"] == 0
    # served on another device (the CPU named by index): placed again, once
    other = torch.device("cpu", 0)
    algo = pcls.NaiveBayesAlgorithm(pcls.NaiveBayesAlgorithmParams())
    served = algo.prepare_serving(other, m)
    assert served.device == other and other in served._placed
    assert k15.PLACEMENTS.snapshot()["naive_bayes_place"] == 1
    got = algo.batch_predict(served, [(i, pcls.Query(features=tuple(q))) for i, q in enumerate(Q)])
    assert k15.PLACEMENTS.snapshot()["naive_bayes_place"] == 1
    np.testing.assert_array_equal([p.label for _, p in got], first)


def test_a_saved_model_carries_no_serving_state(tmp_path):
    _, m, Q = model_and_queries("random")
    k15.predict_naive_bayes(m, Q)
    assert m._placed
    path = tmp_path / "nb.npz"
    save_model(path, m)
    back = load_model(path)
    assert back._placed is None
    with np.load(path) as z:
        assert not any(name.startswith("_") for name in z.files)
    assert pickle.loads(pickle.dumps(m))._placed is None
    np.testing.assert_array_equal(k15.predict_naive_bayes(back, Q, device="cpu"),
                                  k15.predict_naive_bayes(m, Q))


@pytest.mark.parametrize("B", [2, 13, 64])
def test_a_mesh_of_two_devices_runs_one_table_per_device(B):
    """Shards on two distinct devices (the CPU, and the CPU named by index),
    interleaved: one twin call per device, the second device's blocks
    copied into the first's result, every label one device's."""
    j, m, Q = model_and_queries("random")
    Q = np.resize(Q, (B, Q.shape[1]))
    mesh = Mesh(["cpu", torch.device("cpu", 0)] * 2, {"data": 4})
    k15.LAUNCHES.reset()
    got = k15.predict_naive_bayes(m, Q, mesh=mesh)
    bounds = k15.split_rows(np.ones(B, np.int64), 4)
    devices = {mesh.devices[s] for s in range(4) if bounds[s + 1] > bounds[s]}
    assert k15.LAUNCHES.snapshot()["naive_bayes_scores_plain"] == len(devices)
    assert B < 4 or len(devices) == 2
    np.testing.assert_array_equal(got, k15.predict_naive_bayes(m, Q))
    np.testing.assert_array_equal(got, jnb.predict_naive_bayes(j, Q))
