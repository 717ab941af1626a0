"""The port's Similar Product engine against the JAX package's, on the CPU
(``device="cpu"``): one catalog of item factors with seeded categories,
carried across as numpy with ``sp_model_from_numpy``, prepared on both
sides (the JAX ``SPModel`` with its prepared ``ItemRetriever``), and the
same queries served through ``similar_batch`` and the summed-score
``Serving``; then training (``ALSAlgorithm`` over view counts,
``LikeAlgorithm`` over likes and dislikes) on one ``TrainingData`` on both
sides, the host scoring path (K14, no retriever) over the candidacy rules,
and a query after ``release_serving``.

Tolerances: scores rtol 1e-5 / atol 1e-6 (XLA and PyTorch sum the rank in
different orders; the quantized tiers end in the reference's own host
refinement), item lists equal outside near-tie runs
(``check_topn_agreement``); trained factors within 2e-5 of the largest
entry (``test_torch_implicit.py``'s training tolerance).
"""

import dataclasses

import numpy as np
import pytest

from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models.similarproduct import engine as jsp
from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.controller.params import params_from_json
from predictionio_tpu_torch.models.similarproduct import engine as psp
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import similarity as k14
from predictionio_tpu_torch.ops.topn import check_topn_agreement
from predictionio_tpu_torch.utils.serialize import load_model, save_model

RTOL, ATOL = 1e-5, 1e-6
N_ITEMS, RANK, N_CATS = 600, 12, 24


def make_catalog(seed=5):
    """Clustered factors (the bench's generator) and 1-3 of 24 categories
    per item."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((64, RANK)).astype(np.float32)
    factors = (base[rng.integers(0, 64, N_ITEMS)]
               + 0.3 * rng.standard_normal((N_ITEMS, RANK))).astype(np.float32)
    cats = [
        sorted({f"c{c}" for c in rng.integers(0, N_CATS, rng.integers(1, 4))})
        for _ in range(N_ITEMS)
    ]
    return factors, [f"i{r}" for r in range(N_ITEMS)], cats


def make_queries(module, seed=6, count=40):
    """1-10 query items each; some with categories, a whitelist or a
    blacklist; unknown items only; nums 1..40."""
    rng = np.random.default_rng(seed)
    queries = []
    for qx in range(count):
        items = [f"i{r}" for r in rng.integers(0, N_ITEMS, rng.integers(1, 11))]
        kw = {"num": int(rng.integers(1, 41))}
        if qx % 3 == 0:
            kw["categories"] = [f"c{c}" for c in rng.integers(0, N_CATS, 2)]
        if qx % 7 == 1:
            kw["white_list"] = [f"i{r}" for r in rng.integers(0, N_ITEMS, 80)]
        if qx % 5 == 2:
            kw["black_list"] = [f"i{r}" for r in rng.integers(0, N_ITEMS, 20)] + ["nope"]
        if qx in (4, 17):
            items = ["unknown-a", "unknown-b"]
        queries.append((qx, module.Query(items=items, **kw)))
    queries.append((count, module.Query(items=["i1"], num=5, white_list=[])))
    queries.append((count + 1, module.Query(items=["i2"], num=5, categories=["none"])))
    return queries


def jax_model(factors, ids, cats, precision):
    index = JaxBiMap({i: r for r, i in enumerate(ids)})
    model = jsp.SPModel(
        item_factors=factors, item_index=index,
        items={r: jsp.Item(categories=tuple(c)) for r, c in enumerate(cats)},
    )
    alg = jsp.ALSAlgorithm(jsp.ALSAlgorithmParams(rank=RANK, precision=precision))
    return alg, alg.prepare_serving(None, model)


def assert_same(port_results, jax_results, item_row):
    assert sorted(port_results) == sorted(jax_results)
    for qx, j in jax_results.items():
        p = port_results[qx]
        assert len(p.item_scores) == len(j.item_scores), qx
        if not j.item_scores:
            continue
        check_topn_agreement(
            np.array([[s.score for s in p.item_scores]]),
            np.array([[item_row[s.item] for s in p.item_scores]]),
            np.array([[s.score for s in j.item_scores]]),
            np.array([[item_row[s.item] for s in j.item_scores]]),
            RTOL, ATOL,
        )


@pytest.mark.parametrize("precision", ["float32", "bf16", "int8"])
def test_similar_batch_through_serving_matches_jax(precision):
    factors, ids, cats = make_catalog()
    jalg, jmodel = jax_model(factors, ids, cats, precision)
    params = psp.ALSAlgorithmParams(rank=RANK, precision=precision)
    palg = psp.ALSAlgorithm(params)
    pmodel = palg.prepare_serving("cpu", psp.sp_model_from_numpy(factors, ids, cats, params))
    assert palg.serving_precision(pmodel) == jalg.serving_precision(jmodel) == precision
    try:
        jq, pq = make_queries(jsp), make_queries(psp)
        jout = dict(jalg.batch_predict(jmodel, jq))
        pout = dict(palg.batch_predict(pmodel, pq))
        assert_same(pout, jout, pmodel.item_index)
        for qx in (4, 17, len(jq) - 2, len(jq) - 1):
            assert pout[qx].item_scores == ()
        # the summed-score Serving over two algorithms (als + likealgo on
        # the same factors): every score doubles, the order holds
        jserve, pserve = jsp.Serving(), psp.Serving()
        jalg2, jmodel2 = jax_model(factors, ids, cats, precision)
        palg2 = psp.LikeAlgorithm(params)
        pmodel2 = palg2.prepare_serving("cpu", psp.sp_model_from_numpy(factors, ids, cats, params))
        jout2 = dict(jalg2.batch_predict(jmodel2, jq))
        pout2 = dict(palg2.batch_predict(pmodel2, pq))
        served_j = {qx: jserve.serve(q, [jout[qx], jout2[qx]]) for qx, q in jq}
        served_p = {qx: pserve.serve(q, [pout[qx], pout2[qx]]) for qx, q in pq}
        assert_same(served_p, served_j, pmodel.item_index)
        for qx, q in pq:
            assert len(served_p[qx].item_scores) <= q.num
        # one query alone, through predict
        assert_same({0: palg.predict(pmodel, pq[0][1])}, {0: jout[0]}, pmodel.item_index)
    finally:
        jalg.release_serving(jmodel)
        palg.release_serving(pmodel)
    assert pmodel._retriever is None and palg.serving_precision(pmodel) is None


def test_unported_paths_raise_naming_their_items():
    """Training, predict and batch_predict without a retriever answer; the
    retriever and the host path's scorer take a port ``Mesh``
    (``tests/test_torch_mesh_serving.py``) and refuse any other mesh
    object."""
    factors, ids, cats = make_catalog()
    model = psp.sp_model_from_numpy(factors, ids, cats)
    model.attach_device("cpu")
    alg = psp.ALSAlgorithm(psp.ALSAlgorithmParams(rank=4, num_iterations=2))
    td = make_training_data(psp)
    trained = alg.train("cpu", psp.Preparator().prepare("cpu", td))
    assert trained.item_factors.shape == (len(td.items), 4)
    answer = alg.predict(model, psp.Query(items=["i1"], num=3))
    assert len(answer.item_scores) == 3
    assert dict(alg.batch_predict(model, [(0, psp.Query(items=["i1"], num=3))]))[0] == answer
    with pytest.raises(TypeError, match="Mesh"):
        psp.ItemRetriever(factors, device="cpu", mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        psp.SimilarityScorer(factors, device="cpu", mesh=object())


def test_subspace_and_dimsum_train():
    """The subspace solver (K11) trains both ALS algorithms, as train_als
    with the same config does, and the engine's ``dimsum`` algorithm (K19)
    builds, trains and answers (both raised before they were ported;
    ``test_torch_subspace.py`` and ``test_torch_dimsum.py`` hold them
    against the JAX package)."""
    td = make_training_data(psp)
    for name in ("ALSAlgorithm", "LikeAlgorithm"):
        alg = getattr(psp, name)(psp.ALSAlgorithmParams(
            rank=4, num_iterations=2, solver="subspace", block_size=2))
        trained = alg.train("cpu", psp.Preparator().prepare("cpu", td))
        user_index, item_index, u, i, r = alg.training_arrays(td)
        direct = port_als.train_als(u, i, r, len(user_index), len(item_index),
                                    alg.als_config(), device="cpu")
        np.testing.assert_array_equal(trained.item_factors, direct.item_factors)
    _, _, [dimsum], _ = psp.similarproduct_engine().make_components(
        EngineParams(algorithm_params_list=(("dimsum", psp.DIMSUMAlgorithmParams()),))
    )
    assert isinstance(dimsum, psp.DIMSUMAlgorithm)
    model = dimsum.train("cpu", psp.Preparator().prepare("cpu", td))
    assert model.similarities.shape == (N_ITEMS_T, N_ITEMS_T)
    answer = dimsum.predict(model, psp.Query(items=["i1"], num=3))
    assert 0 < len(answer.item_scores) <= 3


N_USERS_T, N_ITEMS_T = 80, 50
TRAIN_PARAMS = dict(rank=8, num_iterations=5, lambda_=0.01, alpha=1.0, seed=3)


def make_training_data(module, seed=9):
    """Users, items with categories, view events with repeats (and one of
    an item not in the catalog), like and dislike events, several per
    (user, item) at distinct times, so the latest must win."""
    rng = np.random.default_rng(seed)
    users = {f"u{n}": {} for n in range(N_USERS_T)}
    items = {
        f"i{n}": module.Item(categories=tuple(
            sorted({f"c{c}" for c in rng.integers(0, 6, rng.integers(1, 3))})))
        for n in range(N_ITEMS_T)
    }
    views = [
        module.ViewEvent(user=f"u{a}", item=f"i{b}", t=float(t))
        for t, (a, b) in enumerate(zip(rng.integers(0, N_USERS_T, 1500),
                                       rng.zipf(1.4, 1500) % N_ITEMS_T))
    ]
    views.append(module.ViewEvent(user="u3", item="not-in-catalog", t=2000.0))
    likes = [
        module.LikeEvent(user=f"u{a}", item=f"i{b}", t=float(t), like=bool(k))
        for t, (a, b, k) in enumerate(zip(rng.integers(0, N_USERS_T, 900),
                                          rng.integers(0, N_ITEMS_T, 900),
                                          rng.random(900) < 0.7))
    ]
    return module.TrainingData(users=users, items=items, view_events=views, like_events=likes)


def _trained_pair(algorithm):
    """The same algorithm trained by both packages on one TrainingData."""
    jalg = getattr(jsp, algorithm)(jsp.ALSAlgorithmParams(**TRAIN_PARAMS))
    jmodel = jalg.train(None, jsp.Preparator().prepare(None, make_training_data(jsp)))
    palg = getattr(psp, algorithm)(psp.ALSAlgorithmParams(**TRAIN_PARAMS))
    pmodel = palg.train("cpu", psp.Preparator().prepare("cpu", make_training_data(psp)))
    return jalg, jmodel, palg, pmodel


def _host_queries(module, seed=4):
    rng = np.random.default_rng(seed)
    queries = []
    for qx in range(24):
        items = [f"i{r}" for r in rng.integers(0, N_ITEMS_T, rng.integers(1, 6))]
        kw = {"num": int(rng.integers(1, 12))}
        if qx % 3 == 0:
            kw["categories"] = [f"c{c}" for c in rng.integers(0, 6, 2)]
        if qx % 4 == 1:
            kw["white_list"] = [f"i{r}" for r in rng.integers(0, N_ITEMS_T, 15)]
        if qx % 5 == 2:
            kw["black_list"] = [f"i{r}" for r in rng.integers(0, N_ITEMS_T, 6)] + ["nope"]
        queries.append((qx, module.Query(items=items, **kw)))
    queries.append((24, module.Query(items=["unknown"])))
    queries.append((25, module.Query(items=["i1"], num=5, white_list=[])))
    return queries


@pytest.mark.parametrize("algorithm", ["ALSAlgorithm", "LikeAlgorithm"])
def test_training_and_host_scoring_match_jax(algorithm):
    jalg, jmodel, palg, pmodel = _trained_pair(algorithm)
    assert pmodel.item_index.to_dict() == jmodel.item_index.to_dict()
    assert pmodel.items == {r: psp.Item(categories=it.categories) for r, it in jmodel.items.items()}
    ref = jmodel.item_factors
    np.testing.assert_allclose(pmodel.item_factors, ref, rtol=0, atol=2e-5 * np.abs(ref).max())
    # the host path over the same factors: the JAX model carries the
    # port's, so the answers compare at the scoring tolerance
    jmodel.item_factors = pmodel.item_factors
    assert pmodel._retriever is None  # a model just trained scores on the host path
    before = k14.LAUNCHES.snapshot()["cosine_sum_plain"]
    jq, pq = _host_queries(jsp), _host_queries(psp)
    pout = dict(palg.batch_predict(pmodel, pq))
    known = sum(any(i in pmodel.item_index for i in q.items) for _, q in pq)
    assert k14.LAUNCHES.snapshot()["cosine_sum_plain"] == before + known
    assert_same(pout, dict(jalg.batch_predict(jmodel, jq)), pmodel.item_index)
    assert pout[24].item_scores == () and pout[25].item_scores == ()


def test_a_query_after_release_serving_is_answered_by_the_host_path():
    jalg, jmodel, palg, pmodel = _trained_pair("ALSAlgorithm")
    palg.prepare_serving("cpu", pmodel)
    query = psp.Query(items=["i2", "i7"], num=6, categories=["c1", "c2"])
    served = palg.predict(pmodel, query)
    palg.release_serving(pmodel)
    assert pmodel._retriever is None and pmodel._scorer is None
    before = k14.LAUNCHES.snapshot()["cosine_sum_plain"]
    straggler = palg.predict(pmodel, query)
    assert k14.LAUNCHES.snapshot()["cosine_sum_plain"] == before + 1
    jmodel.item_factors = pmodel.item_factors
    ref = jalg.predict(jmodel, jsp.Query(items=["i2", "i7"], num=6, categories=["c1", "c2"]))
    assert_same({0: straggler}, {0: ref}, pmodel.item_index)
    assert_same({0: straggler}, {0: served}, pmodel.item_index)
    palg.warm(pmodel)  # the host path's query widths


def test_normalize_rows_and_params_match_jax():
    from predictionio_tpu.ops.similarity import normalize_rows

    factors, _, _ = make_catalog()
    factors[3] = 0.0
    a, b = psp.normalize_rows(factors), normalize_rows(factors)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(psp.ALSAlgorithmParams) == fields(jsp.ALSAlgorithmParams)
    raw = {"rank": 12, "precision": "int8", "shortlist_mult": 2, "warm_num": 32}
    assert params_from_json(raw, psp.ALSAlgorithmParams) == psp.ALSAlgorithmParams(**raw)
    q = {"items": ["i1", "i2"], "num": 4, "categories": ["c1"], "white_list": ["i3"],
         "black_list": ["i4"]}
    assert params_from_json(q, psp.Query) == psp.Query(**q)


def test_save_load_round_trips(tmp_path):
    factors, ids, cats = make_catalog()
    params = psp.ALSAlgorithmParams(rank=RANK, precision="bf16", warm_max_batch=8)
    model = psp.sp_model_from_numpy(factors, ids, cats, params)
    path = tmp_path / "sp.npz"
    save_model(path, model)
    loaded = load_model(path)
    assert isinstance(loaded, psp.SPModel)
    np.testing.assert_array_equal(loaded.item_factors.view(np.uint32), factors.view(np.uint32))
    assert loaded.item_index == model.item_index
    assert loaded.items == model.items
    assert loaded.params == params
    with np.load(path, allow_pickle=False) as z:
        assert str(z["engine"]) == "similarproduct"
