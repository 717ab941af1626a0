"""The port's recommendation serving against the JAX package's, on a tiny
model trained by JAX ``train_als`` on the CPU and carried across as numpy
with ``als_model_from_numpy``.

Tolerance: scores rtol 1e-5, atol 1e-6 (XLA and PyTorch sum the rank in
different orders); item lists equal except inside near-tie runs
(``check_topn_agreement``). Fed the same result, ``result_to_json`` is
equal exactly. Where each package trains its own model from the same
ratings, the factors agree within 1e-4 of their largest entry (float32
ALS, two summation orders; tests/test_torch_als_train.py), so scores are
held at rtol 1e-4, atol 1e-5.
"""

import copy

import numpy as np
import pytest

from predictionio_tpu.controller.params import params_to_json as jax_params_to_json
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models.recommendation import engine as jax_engine
from predictionio_tpu.ops.als import ALSConfig, train_als
from predictionio_tpu_torch.controller.params import params_from_json, params_to_json
from predictionio_tpu_torch.models.recommendation import engine as port_engine
from predictionio_tpu_torch.ops.topn import check_topn_agreement
from predictionio_tpu_torch.utils.serialize import load_model, save_model

RTOL, ATOL = 1e-5, 1e-6
N_USERS, N_ITEMS, RANK = 60, 40, 8


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    nnz = 600
    u = rng.integers(0, N_USERS, nnz).astype(np.int32)
    i = rng.integers(0, N_ITEMS, nnz).astype(np.int32)
    r = rng.integers(1, 6, nnz).astype(np.float32)
    arrays = train_als(
        u, i, r, n_users=N_USERS, n_items=N_ITEMS,
        config=ALSConfig(rank=RANK, iterations=4, seed=1),
    )
    user_index = JaxBiMap.string_int(f"u{x}" for x in range(N_USERS))
    item_index = JaxBiMap.string_int(f"i{x}" for x in range(N_ITEMS))
    jax_model = jax_engine.ALSModel(
        arrays=arrays, user_index=user_index, item_index=item_index
    )
    inv_u, inv_i = user_index.inverse(), item_index.inverse()
    params = port_engine.ALSAlgorithmParams(rank=RANK)
    port_model = port_engine.als_model_from_numpy(
        np.asarray(arrays.user_factors),
        np.asarray(arrays.item_factors),
        [inv_u[r] for r in range(N_USERS)],
        [inv_i[r] for r in range(N_ITEMS)],
        params,
    )
    port_engine.ALSAlgorithm(params).prepare_serving("cpu", port_model)
    return jax_model, port_model


def _queries(module):
    users = ["u0", "u17", "nobody", "u59", "u3", "u42", "u-1", "u8"]
    nums = [10, 1, 5, 16, 25, 40, 3, 100]
    return [(qx, module.Query(user=u, num=n)) for qx, (u, n) in enumerate(zip(users, nums))]


def test_recommend_many_matches_jax(models):
    jax_model, port_model = models
    jax_out = dict(jax_model.recommend_many(_queries(jax_engine)))
    port_out = dict(port_model.recommend_many(_queries(port_engine)))
    assert sorted(jax_out) == sorted(port_out)
    jax_alg = jax_engine.ALSAlgorithm(jax_engine.ALSAlgorithmParams(rank=RANK))
    port_alg = port_engine.ALSAlgorithm(port_engine.ALSAlgorithmParams(rank=RANK))
    item_row = port_model.item_index
    for qx, (_, q) in enumerate(_queries(port_engine)):
        j, p = jax_out[qx], port_out[qx]
        assert len(p.item_scores) == len(j.item_scores)
        if q.user not in port_model.user_index:
            assert p.item_scores == ()
            continue
        assert len(p.item_scores) == min(q.num, N_ITEMS)
        check_topn_agreement(
            np.array([[s.score for s in p.item_scores]]),
            np.array([[item_row[s.item] for s in p.item_scores]]),
            np.array([[s.score for s in j.item_scores]]),
            np.array([[item_row[s.item] for s in j.item_scores]]),
            RTOL, ATOL,
        )
        pj, jj = port_alg.result_to_json(p), jax_alg.result_to_json(j)
        assert [x["item"] for x in pj["itemScores"]] == [x["item"] for x in jj["itemScores"]]
        np.testing.assert_allclose(
            [x["score"] for x in pj["itemScores"]],
            [x["score"] for x in jj["itemScores"]], rtol=RTOL, atol=ATOL,
        )
        # the same result serializes to the same JSON
        same = port_engine.PredictedResult(
            item_scores=[port_engine.ItemScore(s.item, s.score) for s in j.item_scores]
        )
        assert port_alg.result_to_json(same) == jj


def test_params_json_matches_jax():
    raw = {"rank": 12, "num_iterations": 3, "lambda_": 0.05, "warm_num": 32}
    port = params_from_json(raw, port_engine.ALSAlgorithmParams)
    jax_params = jax_engine.ALSAlgorithmParams(**raw)
    assert params_to_json(port) == jax_params_to_json(jax_params)


def test_save_load_round_trips_bit_for_bit(models, tmp_path):
    _, port_model = models
    path = tmp_path / "model.npz"
    save_model(path, port_model)
    loaded = load_model(path)
    for a, b in [
        (loaded.arrays.user_factors, port_model.arrays.user_factors),
        (loaded.arrays.item_factors, port_model.arrays.item_factors),
    ]:
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert loaded.user_index == port_model.user_index
    assert loaded.item_index == port_model.item_index
    assert loaded.params == port_model.params
    loaded.attach_device("cpu")
    qs = _queries(port_engine)
    assert loaded.recommend_many(qs) == port_model.recommend_many(qs)


def test_quantized_precision_is_not_served_as_float32(models):
    """A quantized precision deploys the retriever in that tier (kernels A
    and B), never the float32 K3 path."""
    _, port_model = models
    for precision in ("int8", "bf16"):
        alg = port_engine.ALSAlgorithm(
            port_engine.ALSAlgorithmParams(rank=RANK, precision=precision, warm_max_batch=8)
        )
        model = alg.prepare_serving("cpu", copy.copy(port_model))
        assert model._retriever is not None
        assert model._retriever.precision == alg.serving_precision(model) == precision
        alg.warm(model)
        assert model._serving is None  # the float32 serving state is never built
        alg.release_serving(model)
        assert model._retriever is None and alg.serving_precision(model) is None


@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_quantized_batch_predict_matches_jax(models, precision):
    """Mirrors tests/test_retrieval_quantized.py: the port's quantized
    deployment against the JAX package's (``prepare_serving(None, ...)``)
    and against the port's own float32 deployment."""
    jax_model, port_model = models
    jax_alg = jax_engine.ALSAlgorithm(
        jax_engine.ALSAlgorithmParams(rank=RANK, precision=precision))
    port_alg = port_engine.ALSAlgorithm(
        port_engine.ALSAlgorithmParams(rank=RANK, precision=precision))
    jq = jax_alg.prepare_serving(None, copy.deepcopy(jax_model))
    pq = port_alg.prepare_serving("cpu", copy.copy(port_model))
    try:
        assert jax_alg.serving_precision(jq) == port_alg.serving_precision(pq) == precision
        jax_out = dict(jax_alg.batch_predict(jq, _queries(jax_engine)))
        port_out = dict(port_alg.batch_predict(pq, _queries(port_engine)))
        exact_out = dict(port_model.recommend_many(_queries(port_engine)))
        item_row = port_model.item_index
        for qx, (_, q) in enumerate(_queries(port_engine)):
            j, p, e = jax_out[qx], port_out[qx], exact_out[qx]
            assert len(p.item_scores) == len(j.item_scores) == len(e.item_scores)
            if q.user not in port_model.user_index:
                assert p.item_scores == ()
                continue
            for ref in (j, e):
                check_topn_agreement(
                    np.array([[s.score for s in p.item_scores]]),
                    np.array([[item_row[s.item] for s in p.item_scores]]),
                    np.array([[s.score for s in ref.item_scores]]),
                    np.array([[item_row[s.item] for s in ref.item_scores]]),
                    RTOL, ATOL,
                )
    finally:
        jax_alg.release_serving(jq)
        port_alg.release_serving(pq)


def test_trained_saved_loaded_model_serves_like_jax(tmp_path):
    """Train → save → load → serve in the port against train → recommend
    in the JAX package, from the same ratings and params (seed 3)."""
    from predictionio_tpu_torch.data.bimap import BiMap as PortBiMap

    rng = np.random.default_rng(3)
    nnz = 900
    u = rng.integers(0, N_USERS, nnz).astype(np.int32)
    u[u == 17] = 18  # row 17 has no ratings: zero factors, exact ties
    i = rng.integers(0, N_ITEMS, nnz).astype(np.int32)
    r = (rng.integers(1, 11, nnz) / 2).astype(np.float32)
    users = [f"u{x}" for x in range(N_USERS)]
    items = [f"i{x}" for x in range(N_ITEMS)]
    raw = {"rank": RANK, "num_iterations": 5, "lambda_": 0.05}

    jax_td = jax_engine.TrainingData(
        user_idx=u, item_idx=i, ratings=r,
        user_index=JaxBiMap.string_int(users), item_index=JaxBiMap.string_int(items),
    )
    jax_alg = jax_engine.ALSAlgorithm(jax_engine.ALSAlgorithmParams(**raw))
    jax_model = jax_alg.train(None, jax_engine.Preparator().prepare(None, jax_td))

    port_td = port_engine.TrainingData(
        user_idx=u, item_idx=i, ratings=r,
        user_index=PortBiMap.string_int(users), item_index=PortBiMap.string_int(items),
    )
    assert dict(port_td.item_index.items()) == dict(jax_td.item_index.items())
    port_td.sanity_check()
    port_alg = port_engine.ALSAlgorithm(params_from_json(raw, port_engine.ALSAlgorithmParams))
    trained = port_alg.train("cpu", port_engine.Preparator().prepare("cpu", port_td))
    np.testing.assert_allclose(
        trained.arrays.user_factors, jax_model.arrays.user_factors, rtol=0,
        atol=1e-4 * np.abs(jax_model.arrays.user_factors).max(),
    )
    path = tmp_path / "trained.npz"
    save_model(path, trained)
    port_model = port_alg.prepare_serving("cpu", load_model(path))
    assert port_model.params == port_alg.params

    unrated = port_td.user_index.inverse()[17]
    queries = _queries(port_engine) + [(8, port_engine.Query(user=unrated, num=5))]
    jax_queries = _queries(jax_engine) + [(8, jax_engine.Query(user=unrated, num=5))]
    port_out = dict(port_model.recommend_many(queries))
    item_row = port_model.item_index
    for qx, q in jax_queries:
        j = jax_model.recommend(q.user, q.num)
        p = port_out[qx]
        assert len(p.item_scores) == len(j.item_scores)
        if not p.item_scores:
            continue
        check_topn_agreement(
            np.array([[s.score for s in p.item_scores]]),
            np.array([[item_row[s.item] for s in p.item_scores]]),
            np.array([[s.score for s in j.item_scores]]),
            np.array([[item_row[s.item] for s in j.item_scores]]),
            1e-4, 1e-5,
        )
    # zero factors: every score ties at 0, lowest item index first
    inv = port_model.item_index.inverse()
    assert [s.item for s in port_out[8].item_scores] == [inv[n] for n in range(5)]


def test_empty_training_data_fails_its_sanity_check():
    from predictionio_tpu_torch.data.bimap import BiMap as PortBiMap

    td = port_engine.TrainingData(
        user_idx=np.zeros(0, np.int32), item_idx=np.zeros(0, np.int32),
        ratings=np.zeros(0, np.float32), user_index=PortBiMap({}), item_index=PortBiMap({}),
    )
    with pytest.raises(ValueError, match="empty"):
        td.sanity_check()


def test_model_files_without_an_engine_field_load_as_recommendation(models, tmp_path):
    """Files written before the ``engine`` field existed load as the
    recommendation engine's; a file naming an unknown engine is refused."""
    _, port_model = models
    path = tmp_path / "model.npz"
    save_model(path, port_model)
    with np.load(path, allow_pickle=False) as z:
        assert str(z["engine"]) == "recommendation"
        arrays = {name: z[name] for name in z.files}
    np.savez(tmp_path / "older.npz", **{k: v for k, v in arrays.items() if k != "engine"})
    loaded = load_model(tmp_path / "older.npz")
    assert isinstance(loaded, port_engine.ALSModel)
    assert loaded.user_index == port_model.user_index
    np.testing.assert_array_equal(loaded.arrays.item_factors, port_model.arrays.item_factors)
    np.savez(tmp_path / "other.npz", **dict(arrays, engine=np.asarray("nosuch")))
    with pytest.raises(ValueError, match="unknown engine"):
        load_model(tmp_path / "other.npz")
