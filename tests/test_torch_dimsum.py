"""DIMSUM item similarity in the port (K19, ``ops/cooccurrence.py``, and
the Similar Product engine's ``DIMSUMAlgorithm``) against the JAX package
on the CPU (``device="cpu"``: the kernels by their plain twins), on one
``TrainingData`` with repeated views, an item nobody viewed, a user with no
views, a viewer missing from ``users`` and views of items outside the
catalog; ``predict`` under the candidacy rules, the model file, the
standalone ``dimsum_engine`` deployed by the CLI, and the reference's
``tests/test_experimental.py::TestDIMSUM`` properties.

Tolerances, stated beforehand:
- similarities: rtol 1e-5, atol 1e-6. The JAX package sums a float32
  product of normalized columns; the port multiplies integer co-view
  counts by two float32 inverse norms. Entries whose exact cosine lies
  within 1e-5 of the threshold are left out of the comparison: rounding
  may put them on either side of it, so one side keeps the value and the
  other zeroes it.
- co-view counts: exact (integers).
- ``predict``: the same answers, id for id and score for score, with the
  JAX model carrying the port's similarities (both rank in numpy).
"""

import json

import numpy as np
import pytest
import torch

from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models.similarproduct import engine as jsp
from predictionio_tpu_torch.controller import FirstServing
from predictionio_tpu_torch.models.experimental import similarproduct_dimsum as pdim
from predictionio_tpu_torch.models.similarproduct import engine as psp
from predictionio_tpu_torch.ops import cooccurrence as k19
from predictionio_tpu_torch.utils.serialize import load_model, save_model

RTOL, ATOL = 1e-5, 1e-6
N_USERS, N_ITEMS = 70, 40


def make_training_data(module, seed=3):
    """Clustered views (users mostly view one of four item clusters),
    repeated; item i39 viewed by nobody; user u69 with no views; a viewer
    "ghost" not in ``users``; views of items not in the catalog."""
    rng = np.random.default_rng(seed)
    users = {f"u{n}": {} for n in range(N_USERS)}
    items = {
        f"i{n}": module.Item(categories=tuple(
            sorted({f"c{c}" for c in rng.integers(0, 5, rng.integers(1, 3))})))
        for n in range(N_ITEMS)
    }
    views = []
    for t in range(900):
        a = int(rng.integers(0, N_USERS - 1))
        cluster = a % 4 if rng.random() < 0.8 else int(rng.integers(0, 4))
        b = cluster * 10 + int(rng.integers(0, 10)) if cluster < 3 else 30 + int(rng.integers(0, 9))
        views.append(module.ViewEvent(user=f"u{a}", item=f"i{b}", t=float(t)))
    views += [module.ViewEvent(user="u1", item="i2", t=1000.0 + n) for n in range(5)]
    views += [module.ViewEvent(user="ghost", item=f"i{b}", t=2000.0) for b in (0, 1, 2)]
    views += [module.ViewEvent(user="u3", item="not-in-catalog", t=3000.0),
              module.ViewEvent(user="u4", item="zzz", t=3001.0)]
    return module.TrainingData(users=users, items=items, view_events=views)


def exact_cosine(td_port):
    """The float64 cosine of the deduplicated binary view matrix, from the
    port's own index arrays."""
    alg = psp.DIMSUMAlgorithm(psp.DIMSUMAlgorithmParams())
    item_index, u, i = alg.view_arrays(td_port)
    R = np.zeros((u.max() + 1, len(item_index)))
    R[u, i] = 1.0
    C = R.T @ R
    n = np.sqrt(np.diag(C))
    with np.errstate(divide="ignore", invalid="ignore"):
        S = np.where(np.outer(n, n) > 0, C / np.outer(n, n), 0.0)
    np.fill_diagonal(S, 0.0)
    return C, S


def trained_pair(threshold):
    jalg = jsp.DIMSUMAlgorithm(jsp.DIMSUMAlgorithmParams(threshold=threshold))
    jmodel = jalg.train(None, jsp.Preparator().prepare(None, make_training_data(jsp)))
    palg = psp.DIMSUMAlgorithm(psp.DIMSUMAlgorithmParams(threshold=threshold))
    td = make_training_data(psp)
    pmodel = palg.train("cpu", psp.Preparator().prepare("cpu", td))
    return jalg, jmodel, palg, pmodel, td


@pytest.mark.parametrize("threshold", [0.0, 0.3])
def test_train_matches_jax(threshold):
    before = k19.LAUNCHES.snapshot()
    jalg, jmodel, palg, pmodel, td = trained_pair(threshold)
    after = k19.LAUNCHES.snapshot()
    assert after["cooccur_counts_plain"] == before["cooccur_counts_plain"] + 1
    assert after["cosine_from_counts_plain"] == before["cosine_from_counts_plain"] + 1
    assert after["cooccur_counts"] == before["cooccur_counts"]
    assert after["cosine_from_counts"] == before["cosine_from_counts"]
    assert pmodel.item_index.to_dict() == jmodel.item_index.to_dict()
    assert pmodel.items == {r: psp.Item(categories=it.categories) for r, it in jmodel.items.items()}
    assert pmodel.params == psp.DIMSUMAlgorithmParams(threshold=threshold)
    got, want = pmodel.similarities, jmodel.similarities
    assert got.shape == want.shape == (N_ITEMS, N_ITEMS) and got.dtype == np.float32
    _, exact = exact_cosine(td)
    keep = np.abs(exact - threshold) >= 1e-5
    np.testing.assert_allclose(got[keep], want[keep], rtol=RTOL, atol=ATOL)
    assert (got[keep] == 0).tolist() == (want[keep] == 0).tolist()
    np.testing.assert_allclose(got[keep], exact[keep] * (exact[keep] >= threshold),
                               rtol=RTOL, atol=ATOL)
    row = pmodel.item_index["i39"]  # nobody viewed it: a zero row, not NaN
    assert not got[row].any() and not got[:, row].any()
    if threshold > 0:
        assert (got[got > 0] >= threshold).all() and (got == 0).sum() > (exact == 0).sum()


def test_twins_match_counts_and_jax():
    """K19a's twin equals the integer co-view counts, and K19b's twin on
    them equals JAX's similarities; the CSR drops repeats."""
    td = make_training_data(psp)
    alg = psp.DIMSUMAlgorithm(psp.DIMSUMAlgorithmParams())
    item_index, u, i = alg.view_arrays(td)
    assert len(u) == 910 - 2  # the two views of unknown items drop
    user_ptr, items = k19.dedup_views(u, i, N_ITEMS)
    assert len(items) < len(u)  # repeats counted once
    C = k19.cooccur_counts(torch.from_numpy(user_ptr), torch.from_numpy(items), N_ITEMS)
    C_exact, _ = exact_cosine(td)
    np.testing.assert_array_equal(C.numpy(), np.tril(C_exact).astype(np.int32))
    rinv = torch.from_numpy(k19.inverse_norms(items, N_ITEMS))
    assert rinv[item_index["i39"]] == 0
    S = k19.cosine_from_counts(C, rinv, 0.0)
    jmodel = jsp.DIMSUMAlgorithm(jsp.DIMSUMAlgorithmParams()).train(
        None, jsp.Preparator().prepare(None, make_training_data(jsp)))
    np.testing.assert_allclose(S.numpy(), jmodel.similarities, rtol=RTOL, atol=ATOL)
    assert torch.equal(S, S.T)


def test_reference_properties():
    """tests/test_experimental.py::TestDIMSUM: symmetric, zero diagonal,
    within [0, 1]; the co-viewed cluster ranks first; a high threshold
    keeps only values at or above it."""
    _, _, palg, pmodel, td = trained_pair(0.0)
    sims = pmodel.similarities
    np.testing.assert_array_equal(sims, sims.T)
    assert not np.diag(sims).any()
    assert (sims >= 0).all() and (sims <= 1.0 + 1e-5).all()
    got = {s.item for s in palg.predict(pmodel, psp.Query(items=("i0",), num=3)).item_scores}
    assert "i0" not in got and len(got & {f"i{n}" for n in range(1, 10)}) >= 2
    high = psp.DIMSUMAlgorithm(psp.DIMSUMAlgorithmParams(threshold=0.99)).train(
        "cpu", psp.Preparator().prepare("cpu", td))
    assert (high.similarities[high.similarities > 0] >= 0.99).all()


def queries(module):
    return [
        module.Query(items=("i1", "i2"), num=5),
        module.Query(items=("i11",), num=4, categories=("c1", "c2")),
        module.Query(items=("i21", "i22", "i23"), num=20,
                     white_list=tuple(f"i{r}" for r in range(0, 40, 3))),
        module.Query(items=("i31",), num=6, black_list=("i32", "i33", "nope")),
        module.Query(items=("i5",), num=3, white_list=()),
        module.Query(items=("i39",), num=3),  # no co-views: nothing
        module.Query(items=("unknown",), num=3),
        module.Query(items=("i0", "unknown"), num=40, categories=("c0",), black_list=("i1",)),
    ]


def test_predict_matches_jax():
    jalg, jmodel, palg, pmodel, _ = trained_pair(0.0)
    jmodel.similarities = pmodel.similarities.copy()  # rank the same numbers
    answered = 0
    for pq, jq in zip(queries(psp), queries(jsp)):
        got, want = palg.predict(pmodel, pq), jalg.predict(jmodel, jq)
        assert [(s.item, s.score) for s in got.item_scores] == [
            (s.item, s.score) for s in want.item_scores]
        assert len(got.item_scores) <= pq.num
        answered += bool(got.item_scores)
        assert palg.result_to_json(got) == jalg.result_to_json(want)
    assert answered >= 5


def test_model_from_numpy_and_save_load_round_trip(tmp_path):
    _, _, _, pmodel, _ = trained_pair(0.3)
    ids = [pmodel.inv_index[r] for r in range(N_ITEMS)]
    cats = [list(pmodel.items[r].categories) for r in range(N_ITEMS)]
    rebuilt = psp.dimsum_model_from_numpy(pmodel.similarities, ids, cats, pmodel.params)
    assert rebuilt.item_index == pmodel.item_index and rebuilt.items == pmodel.items
    np.testing.assert_array_equal(rebuilt.similarities, pmodel.similarities)
    path = tmp_path / "dimsum.npz"
    save_model(path, pmodel)
    loaded = load_model(path)
    assert isinstance(loaded, psp.DIMSUMModel)
    np.testing.assert_array_equal(loaded.similarities.view(np.uint32),
                                  pmodel.similarities.view(np.uint32))
    assert loaded.item_index == pmodel.item_index and loaded.items == pmodel.items
    assert loaded.params == psp.DIMSUMAlgorithmParams(threshold=0.3)
    with np.load(path, allow_pickle=False) as z:
        assert str(z["engine"]) == "dimsum"
    with pytest.raises(ValueError):
        psp.dimsum_model_from_numpy(np.zeros((3, 4), np.float32), ["a", "b", "c"], [[]] * 3)
    # a JAX model crosses as arrays
    jmodel = jsp.DIMSUMAlgorithm(jsp.DIMSUMAlgorithmParams()).train(
        None, jsp.Preparator().prepare(None, make_training_data(jsp)))
    inv = {r: key for key, r in jmodel.item_index.to_dict().items()}
    crossed = psp.dimsum_model_from_numpy(
        jmodel.similarities, [inv[r] for r in range(N_ITEMS)],
        [jmodel.items[r].categories for r in range(N_ITEMS)])
    assert crossed.item_index.to_dict() == jmodel.item_index.to_dict()


def test_dimsum_engine_is_deployed_by_the_cli(tmp_path):
    """``dimsum_engine()`` (DIMSUM the only algorithm, first serving) and
    its factory; a saved DIMSUM model deployed by ``tools.cli`` on the CPU
    answers a query as the algorithm's predict does."""
    import urllib.request

    from test_torch_engine_server import _deploy_file_in_thread, _free_port, _request

    engine = pdim.dimsum_engine()
    assert engine.algorithm_class_map == {"dimsum": psp.DIMSUMAlgorithm}
    assert engine.serving_class_map == {"": FirstServing}
    assert pdim.DIMSUMEngineFactory().apply().algorithm_class_map == engine.algorithm_class_map
    _, _, palg, pmodel, _ = trained_pair(0.0)
    path = tmp_path / "dimsum_model.npz"
    save_model(path, pmodel)
    port = _free_port()
    thread, failures = _deploy_file_in_thread(path, port)
    try:
        body = {"items": ["i1", "i2"], "num": 5, "categories": ["c0", "c1", "c2"]}
        status, raw = _request(port, "POST", "/queries.json", json.dumps(body).encode())
        assert status == 200
        payload = json.loads(raw)
        assert payload["modelVersion"] == "dimsum_model"
        want = palg.predict(pmodel, psp.Query(**body))
        assert payload["itemScores"] == palg.result_to_json(want)["itemScores"]
        assert payload["itemScores"]
        status = json.loads(_request(port, "GET", "/status.json")[1])
        assert status["algorithms"] == ["DIMSUMAlgorithm"]
        assert _request(port, "GET", "/stop") == (200, b"Shutting down...")
        thread.join(timeout=30)
        assert not thread.is_alive() and not failures
    finally:
        if thread.is_alive():
            urllib.request.urlopen(f"http://127.0.0.1:{port}/stop", timeout=10)
