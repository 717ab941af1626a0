"""The e2 library's device models in the port (``e2/naive_bayes.py`` with
K17a/K17b in ``ops/categorical_nb.py``, ``e2/markov_chain.py`` with K16 in
``ops/markov.py``) on the CPU, against the JAX package on the same seeded
inputs.

Tolerances:
- K17: counts, log priors and log likelihoods equal bit for bit (integer
  counts; the port turns them into logs with the reference's numpy code);
  K17b's scores within 1e-6 relative with -inf in the same places (sums of
  eight float32 terms in two orders); labels equal, except where a row's
  two best scores lie within 1e-5 (a tie the two orders may break apart);
- K16: ``predict`` within rtol 1e-6 / atol 1e-7 (the reference sums the
  float32 products in float32, the port in float64); ``transition_map``
  equal (host code copied).
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.e2 import markov_chain as jmc
from predictionio_tpu.e2 import naive_bayes as jnb
from predictionio_tpu_torch import e2 as pe2
from predictionio_tpu_torch.e2 import markov_chain as pmc
from predictionio_tpu_torch.e2 import naive_bayes as pnb
from predictionio_tpu_torch.ops import categorical_nb as k17
from predictionio_tpu_torch.ops import markov as k16

CPU = "cpu"
SCORE_RTOL, TIE_GAP = 1e-6, 1e-5
MC_RTOL, MC_ATOL = 1e-6, 1e-7

# the reference suite's weather set (tests/test_e2.py)
WEATHER = [
    ("yes", ("sunny", "hot")),
    ("yes", ("sunny", "mild")),
    ("yes", ("overcast", "hot")),
    ("no", ("rainy", "mild")),
    ("no", ("rainy", "cool")),
    ("no", ("sunny", "cool")),
]


def seeded_points(n=3_000, cards=(5, 3, 7, 2), n_labels=3, seed=11):
    """Class-conditional categorical points: (label, features) pairs."""
    rng = np.random.default_rng(seed)
    probs = [rng.dirichlet(np.ones(c), size=n_labels) for c in cards]
    labels = rng.integers(0, n_labels, n)
    out = []
    for l in labels:
        feats = tuple(f"s{s}v{rng.choice(c, p=probs[s][l])}" for s, c in enumerate(cards))
        out.append((f"label{l}", feats))
    return out


def both_models(raw):
    jm = jnb.CategoricalNaiveBayes.train([jnb.LabeledPoint(l, f) for l, f in raw])
    pm = pnb.CategoricalNaiveBayes.train([pnb.LabeledPoint(l, f) for l, f in raw], device=CPU)
    return jm, pm


def flat_keys(model, raw):
    """The reference's flat (slot, label, value) keys of ``raw``."""
    L, S, V = model.log_likelihoods.shape
    labels = np.asarray([model.label_index[l] for l, _ in raw])
    return np.concatenate([
        (s * L + labels) * V + np.asarray([model.value_indexes[s][f[s]] for _, f in raw])
        for s in range(S)
    ]).astype(np.int32), S * L * V


# --- K17 ---


@pytest.mark.parametrize("raw", [WEATHER, seeded_points()], ids=["weather", "seeded"])
def test_counts_priors_and_likelihoods_equal_the_reference_bit_for_bit(raw):
    jm, pm = both_models(raw)
    keys, n_keys = flat_keys(jm, raw)
    want = np.asarray(jnb._count_flat(jnp.asarray(keys), n_keys))
    k17.LAUNCHES.reset()
    got = k17.cnb_count(torch.from_numpy(keys), n_keys).numpy()
    assert k17.LAUNCHES.snapshot()["cnb_count_plain"] == 1
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert pm.label_index.to_dict() == jm.label_index.to_dict()
    assert [v.to_dict() for v in pm.value_indexes] == [v.to_dict() for v in jm.value_indexes]
    for name in ("log_priors", "log_likelihoods"):
        a, b = getattr(pm, name), getattr(jm, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b), name
    assert pm.priors == jm.priors and pm.likelihoods == jm.likelihoods


def test_the_twin_counts_past_two_to_the_24():
    """The reference's float32 scatter-add of ones stops at 2^24 per key;
    the port's int32 counts do not (the JAX side is not run at this size)."""
    n = 2**24 + 3
    keys = torch.full((n,), 2, dtype=torch.int32)
    keys[:5] = torch.tensor([0, 7, -1, 9, 1], dtype=torch.int32)  # 7, 9, -1 drop
    counts = k17.cnb_count(keys, 7)
    assert counts.dtype == torch.int32
    assert counts.tolist() == [1, 1, n - 5, 0, 0, 0, 0]
    assert int(counts[2]) == 16_777_214 and n == 16_777_219


def query_batch(model, rng, n=400, unknown=0.1):
    """Rows of known values, a share of them replaced by unseen ones."""
    rows = []
    for _ in range(n):
        row = []
        for vi in model.value_indexes:
            vals = sorted(vi.keys())
            row.append("unseen" if rng.random() < unknown else vals[rng.integers(len(vals))])
        rows.append(tuple(row))
    return rows


def check_scores_and_labels(jm, pm, rows):
    enc, known = pm.encode(rows)
    want = np.asarray(jnb._batch_scores(
        jnp.asarray(jm.log_likelihoods), jnp.asarray(jm.log_priors),
        jnp.asarray(enc), jnp.asarray(known)))
    k17.LAUNCHES.reset()
    labels, scores = k17.cnb_scores_argmax(
        torch.from_numpy(pm.log_likelihoods), torch.from_numpy(pm.log_priors),
        torch.from_numpy(enc), torch.from_numpy(known))
    assert k17.LAUNCHES.snapshot()["cnb_scores_argmax_plain"] == 1
    got = scores.numpy()
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf)
    np.testing.assert_array_equal(got[inf], want[inf])
    np.testing.assert_allclose(got[~inf], want[~inf], rtol=SCORE_RTOL, atol=0)
    jl, pl = jm.predict_batch(rows), pm.predict_batch(rows)
    srt = np.sort(want, axis=1)
    with np.errstate(invalid="ignore"):  # -inf - -inf: no tie to break
        gap = srt[:, -1] - srt[:, -2] if want.shape[1] > 1 else np.full(len(rows), np.inf)
    for r, (a, b) in enumerate(zip(jl, pl)):
        assert a == b or gap[r] <= TIE_GAP, (r, a, b)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jnp.argmax(want, axis=1)))
    return pl


@pytest.mark.parametrize("unknown", [0.0, 0.15])
def test_batch_scores_and_labels_agree_with_the_reference(unknown):
    jm, pm = both_models(seeded_points())
    check_scores_and_labels(jm, pm, query_batch(pm, np.random.default_rng(3), unknown=unknown))


def test_a_row_whose_every_score_is_minus_infinity_gets_label_zero():
    jm, pm = both_models(WEATHER)
    rows = [("sunny", "cool"), ("nowhere", "never"), ("overcast", "cool"), ("rainy", "hot")]
    labels = check_scores_and_labels(jm, pm, rows)
    # ("nowhere", "never") is unknown in both slots: every score -inf -> index 0
    assert labels[1] == pm.label_index.inverse()[0] == "no"
    assert pm.predict(("sunny", "hot")) == jm.predict(("sunny", "hot")) == "yes"


def test_log_score_and_feature_count_checks_match_the_reference():
    jm, pm = both_models(WEATHER)
    for label, feats in [("yes", ("sunny", "hot")), ("no", ("rainy", "x")), ("maybe", ("a", "b"))]:
        for default in (lambda ls: float("-inf"), lambda ls: min(ls) - 1.0):
            assert pm.log_score(pnb.LabeledPoint(label, feats), default) == \
                jm.log_score(jnb.LabeledPoint(label, feats), default)
    with pytest.raises(ValueError, match="feature"):
        pm.predict_batch([("sunny",)])
    with pytest.raises(ValueError, match="empty"):
        pnb.CategoricalNaiveBayes.train([], device=CPU)
    with pytest.raises(ValueError, match="same number"):
        pnb.CategoricalNaiveBayes.train(
            [pnb.LabeledPoint("a", ("x",)), pnb.LabeledPoint("b", ("x", "y"))], device=CPU)


def test_the_jax_model_carried_across_predicts_as_the_reference():
    raw = seeded_points(n=1_000, seed=4)
    jm, _ = both_models(raw)
    inv = [jm.label_index.inverse()[l] for l in range(len(jm.label_index))]
    vals = [[vi.inverse()[v] for v in range(len(vi))] for vi in jm.value_indexes]
    pm = pe2.categorical_nb_model_from_numpy(inv, vals, jm.log_priors, jm.log_likelihoods,
                                             device=CPU)
    rows = query_batch(pm, np.random.default_rng(8), n=200)
    assert pm.predict_batch(rows) == jm.predict_batch(rows)
    with pytest.raises(ValueError, match="disagree"):
        pe2.categorical_nb_model_from_numpy(inv[:-1], vals, jm.log_priors, jm.log_likelihoods,
                                            device=CPU)


def test_the_model_pickles_without_its_device_copy():
    _, pm = both_models(WEATHER)
    pm.predict(("sunny", "hot"))
    assert pm._placed is not None
    back = pickle.loads(pickle.dumps(pm))
    assert back._placed is None and back.predict(("sunny", "hot")) == "yes"


def test_the_kernel_wrappers_refuse_bad_input():
    with pytest.raises(ValueError, match="int32"):
        k17.cnb_count(torch.zeros(3, dtype=torch.int64), 4)
    with pytest.raises(ValueError, match="n_keys"):
        k17.cnb_count(torch.zeros(3, dtype=torch.int32), 0)
    ll = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="disagree"):
        k17.cnb_scores_argmax(ll, torch.zeros(2), torch.zeros((5, 2), dtype=torch.int32),
                              torch.ones((5, 2), dtype=torch.bool))
    with pytest.raises(ValueError, match="bool"):
        k17.cnb_scores_argmax(ll, torch.zeros(2), torch.zeros((5, 3), dtype=torch.int32),
                              torch.ones((5, 3), dtype=torch.int32))


@pytest.mark.parametrize("M,n_keys", [(1, 1), (10_000, 672), (3_000_000, 672), (50, 200_000)])
def test_the_count_plan_covers_every_key_once(M, n_keys):
    nblk, per_block, tile = k17.count_plan(M, n_keys)
    assert nblk * per_block >= M and (nblk - 1) * per_block < M
    assert nblk * n_keys <= max(k17._COUNT_PARTIAL_INTS, n_keys)
    assert 1 <= tile <= min(n_keys, k17._COUNT_TILE)


# --- K16 ---


def seeded_tally(n_states=300, n_entries=4_000, seed=5):
    """(from, to, count) triples: Zipf-skewed targets, repeated pairs,
    integer counts (ties in the top-N); states 0..9 have no outgoing row."""
    rng = np.random.default_rng(seed)
    src = rng.integers(10, n_states, n_entries)
    dst = (rng.zipf(1.3, n_entries) - 1) % n_states
    cnt = rng.integers(1, 4, n_entries).astype(float)
    return list(zip(src.tolist(), dst.tolist(), cnt.tolist())), n_states


@pytest.mark.parametrize("top_n", [1, 3, 10])
def test_markov_predict_and_transition_map_match_the_reference(top_n):
    entries, n = seeded_tally()
    jm = jmc.MarkovChain.train(entries, n, top_n)
    pm = pmc.MarkovChain.train(entries, n, top_n, device=CPU)
    assert pm.transition_map() == jm.transition_map()
    assert not any(s in pm.transition_map() for s in range(10))
    np.testing.assert_array_equal(pm.targets, jm.targets)
    np.testing.assert_array_equal(pm.probs, jm.probs)
    rng = np.random.default_rng(top_n)
    k16.LAUNCHES.reset()
    for cur in (rng.dirichlet(np.ones(n)), np.eye(n)[42], rng.standard_normal(n)):
        cur = cur.astype(np.float32)
        got = pm.predict(cur)
        assert isinstance(got, list) and isinstance(got[0], float)
        np.testing.assert_allclose(got, jm.predict(cur), rtol=MC_RTOL, atol=MC_ATOL)
    assert k16.LAUNCHES.snapshot()["markov_step_plain"] == 3
    assert pm._placed is not None  # placed once, reused


def test_markov_csr_holds_every_kept_transition_in_source_order():
    entries, n = seeded_tally(n_states=80, n_entries=6_000, seed=9)
    pm = pmc.MarkovChain.train(entries, n, 50, device=CPU)
    src, prob, chunk_start, target_chunk = k16.build_csr(pm.targets, pm.probs, n)
    assert len(chunk_start) == target_chunk[-1] + 1
    kept = [(int(t), i, float(p)) for i in range(n) for t, p in zip(pm.targets[i], pm.probs[i])
            if p != 0]
    assert len(src) == len(kept)
    assert sorted(kept) == [(t, int(s), float(p)) for t, s, p in zip(
        np.repeat(np.arange(n), np.diff(np.concatenate([[0], np.cumsum(
            np.bincount([k[0] for k in kept], minlength=n))]))), src, prob)]
    sizes = np.diff(chunk_start)
    assert sizes.max() <= k16.CHUNK and sizes.min() >= 1
    for t in range(n):  # a target's chunks are contiguous and hold only its entries
        lo, hi = chunk_start[target_chunk[t]], chunk_start[target_chunk[t + 1]]
        assert all(k[0] == t for k in sorted(kept)[lo:hi])
    # the twin reads each entry's target off the placed chunk offsets
    placed = k16.place_transitions(pm.targets, pm.probs, n, torch.device("cpu"))
    assert k16.entry_targets(placed).tolist() == [k[0] for k in sorted(kept)]


def test_markov_drops_padding_and_out_of_range_targets():
    targets = np.asarray([[1, 5], [0, 0], [-1, -4]], np.int32)
    probs = np.asarray([[0.5, 0.5], [1.0, 0.0], [0.3, 0.7]], np.float32)
    pm = pe2.markov_model_from_numpy(3, targets, probs, device=CPU)
    got = pm.predict([1.0, 2.0, 4.0])
    # targets 5 and -4 drop and -1 counts from the end, as the reference's
    # .at[targets].add(..., mode="drop")
    assert got == pytest.approx([2.0, 0.5, 1.2], rel=1e-7)
    jm = jmc.MarkovChainModel(n_states=3, n=2, targets=targets, probs=probs)
    np.testing.assert_allclose(got, jm.predict([1.0, 2.0, 4.0]), rtol=MC_RTOL)


def test_markov_model_from_jax_arrays_and_its_checks():
    entries, n = seeded_tally(seed=2)
    jm = jmc.MarkovChain.train(entries, n, 4)
    pm = pe2.markov_model_from_numpy(jm.n_states, jm.targets, jm.probs, device=CPU)
    cur = np.random.default_rng(0).dirichlet(np.ones(n)).astype(np.float32)
    np.testing.assert_allclose(pm.predict(cur), jm.predict(cur), rtol=MC_RTOL, atol=MC_ATOL)
    with pytest.raises(ValueError, match="states"):
        pm.predict(cur[:-1])
    with pytest.raises(ValueError):
        pe2.markov_model_from_numpy(n + 1, jm.targets, jm.probs, device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        pmc.MarkovChain.train([(0, n, 1.0)], n, 2, device=CPU)
    back = pickle.loads(pickle.dumps(pm))
    assert back._placed is None and back.predict(cur) == pm.predict(cur)


def test_a_mesh_raises_and_no_device_means_cuda(monkeypatch):
    entries, n = seeded_tally(seed=3)
    pm = pmc.MarkovChain.train(entries, n, 2, device=CPU)
    # a mesh that is not a port Mesh raises (the mesh forms are K16s, K17s)
    with pytest.raises(TypeError, match="Mesh"):
        pm.predict(np.ones(n, np.float32), mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        pnb.CategoricalNaiveBayes.train([pnb.LabeledPoint("a", ("x",))], mesh=object(),
                                        device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmc.MarkovChain.train(entries, n, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pnb.CategoricalNaiveBayes.train([pnb.LabeledPoint("a", ("x",))])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmc.MarkovChainModel(pm.n_states, pm.n, pm.targets, pm.probs).predict(np.ones(n))
