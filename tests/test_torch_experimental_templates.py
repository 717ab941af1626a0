"""The experimental templates that run no new kernel, in the port
(``models/experimental``: custom_datasource, movielens_filtering,
refactor_test, similarproduct_localmodel, standalone_recommendations),
with ``Engine.train``, ``make_serializable_models`` and the manifest branch
of ``prepare_deploy``, on the CPU (every kernel by its plain twin), against
the JAX package's templates.

Every template reads one seeded ``user::item::rate`` file of 2,000 ratings
at ML-100K's shape cut to size (200 users, 300 items, ratings 1..5; the
Similar Product template reads its lines as views), or, for the filtering
engine, the same ratings through a JAX memory event store and the port's
``EventColumns`` of that store's scan.

Tolerances:
- trained factors within 1e-4 of the largest factor entry, the tolerance
  tests/test_torch_recommendation.py holds a template that trains its own
  model from the same ratings to (float32 ALS, two summation orders, each
  half-step's rounding carried into the next). The 2e-5 of
  tests/test_torch_als_train.py does not hold on these ratings: with 6.7
  ratings an item, many items' systems are ill-conditioned at lambda 0.05,
  and after 6 sweeps the JAX package's own factors lie 3.8e-5 of the
  largest entry off the float64 oracle (``ops/als_reference.py``), the
  port's 4.6e-5, and the two 4.6e-5 apart;
- predictions (a rank-long dot product of such factors, or a sum of
  cosines of them) within 1e-4 of the largest predicted value; ranked items
  equal outside runs of scores that lie within that tolerance of each other
  (``check_topn_agreement``);
- the host code (the filter, the vanilla engine and evaluator, the file
  readers): equal.
"""

import os

import numpy as np
import pytest
import torch

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.data import storage as storage_mod
from predictionio_tpu.data.event import DataMap, Event
from predictionio_tpu.data.storage.base import App
from predictionio_tpu.data.store import PEventStore
from predictionio_tpu.models.experimental import custom_datasource as jcd
from predictionio_tpu.models.experimental import movielens_filtering as jmf
from predictionio_tpu.models.experimental import refactor_test as jrt
from predictionio_tpu.models.experimental import similarproduct_localmodel as jlm
from predictionio_tpu.models.experimental import standalone_recommendations as jsr
from predictionio_tpu.models.recommendation import engine as jrec
from predictionio_tpu.models.similarproduct import engine as jsp
from predictionio_tpu.workflow.context import WorkflowContext as JaxContext
from predictionio_tpu.workflow.workflow_params import WorkflowParams as JaxWorkflowParams
from predictionio_tpu_torch.controller import PersistentModelManifest
from predictionio_tpu_torch.controller.engine import (
    EngineParams,
    StopAfterPrepareInterruption,
    StopAfterReadInterruption,
)
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.store import EventColumns
from predictionio_tpu_torch.models.experimental import custom_datasource as pcd
from predictionio_tpu_torch.models.experimental import movielens_filtering as pmf
from predictionio_tpu_torch.models.experimental import refactor_test as prt
from predictionio_tpu_torch.models.experimental import similarproduct_localmodel as plm
from predictionio_tpu_torch.models.experimental import standalone_recommendations as psr
from predictionio_tpu_torch.models.similarproduct import engine as psp
from predictionio_tpu_torch.ops.topn import check_topn_agreement
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.workflow_params import WorkflowParams

CPU = torch.device("cpu")
TOL = 1e-4  # of the largest factor entry / predicted value
N_USERS, N_ITEMS, N_RATINGS = 200, 300, 2_000
ALS = {"rank": 8, "num_iterations": 6, "lambda_": 0.05}


def seeded_ratings(seed=100):
    """(users, items, ratings) of N_RATINGS distinct (user, item) pairs: two
    taste clusters, as a small ML-100K."""
    rng = np.random.default_rng(seed)
    seen, out = set(), []
    while len(out) < N_RATINGS:
        u = int(rng.integers(0, N_USERS))
        lo = 0 if u % 2 == 0 else N_ITEMS // 2
        i = lo + int(rng.integers(0, N_ITEMS // 2))
        if (u, i) not in seen:
            seen.add((u, i))
            out.append((u, i, int(rng.integers(1, 6))))
    return np.asarray(out)


@pytest.fixture(scope="module")
def ratings_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("ml") / "ratings.dat"
    path.write_text("".join(f"{u}::{i}::{r}\n" for u, i, r in seeded_ratings()))
    return str(path)


def assert_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def assert_ranked_close(port_results, jax_results, index):
    """Each port PredictedResult against the JAX one: scores within TOL of
    the largest score, items equal outside near-tie runs."""
    scale = max(abs(s.score) for r in jax_results for s in r.item_scores)
    for p, j in zip(port_results, jax_results):
        assert len(p.item_scores) == len(j.item_scores)
        if not j.item_scores:
            continue
        check_topn_agreement(
            np.array([[s.score for s in p.item_scores]]),
            np.array([[index[s.item] for s in p.item_scores]]),
            np.array([[s.score for s in j.item_scores]]),
            np.array([[index[s.item] for s in j.item_scores]]),
            rtol=0.0, atol=TOL * scale,
        )


# --- custom_datasource ---


def test_custom_datasource_trains_and_recommends_as_the_reference(ratings_file):
    jep = JaxEngineParams(
        data_source_params=("", jcd.FileDataSourceParams(filepath=ratings_file)),
        algorithm_params_list=(("als", jcd.ALSAlgorithmParams(**ALS)),),
    )
    pep = EngineParams(
        data_source_params=("", pcd.FileDataSourceParams(filepath=ratings_file)),
        algorithm_params_list=(("als", pcd.ALSAlgorithmParams(**ALS)),),
    )
    [jm] = jcd.custom_datasource_engine().train(None, jep, JaxWorkflowParams())
    [pm] = pcd.custom_datasource_engine().train(WorkflowContext(CPU), pep, WorkflowParams())
    assert pm.user_index.to_dict() == jm.user_index.to_dict()
    assert pm.item_index.to_dict() == jm.item_index.to_dict()
    assert_close(pm.arrays.user_factors, jm.arrays.user_factors)
    assert_close(pm.arrays.item_factors, jm.arrays.item_factors)
    users = [str(u) for u in range(0, N_USERS, 7)]
    _, _, algos, serving = pcd.custom_datasource_engine().make_components(pep)
    got = [serving.serve(q, [algos[0].predict(pm, q)])
           for q in (pcd.Query(user=u, num=10) for u in users)]
    want = [jm.recommend(u, 10) for u in users]
    assert_ranked_close(got, want, pm.item_index)


def test_custom_datasource_rejects_a_malformed_line(tmp_path):
    path = tmp_path / "bad.dat"
    path.write_text("1::2::3\n1::2\n")
    with pytest.raises(ValueError, match="bad.dat:2: expected"):
        pcd.FileDataSource(pcd.FileDataSourceParams(filepath=str(path))).read_training(None)


# --- movielens_filtering ---


@pytest.fixture(scope="module")
def rating_store():
    """The seeded ratings in a JAX memory event store, and the port's
    EventColumns of the same scan."""
    storage = storage_mod.memory_storage()
    app_id = storage.get_meta_data_apps().insert(App(id=0, name="flt"))
    events = storage.get_l_events()
    events.init(app_id)
    for u, i, r in seeded_ratings():
        events.insert(
            Event(event="rate", entity_type="user", entity_id=str(u),
                  target_entity_type="item", target_entity_id=str(i),
                  properties=DataMap({"rating": float(r)})),
            app_id,
        )
    cols = PEventStore(storage).find_columns(
        "flt", value_spec=jrec.RATING_SPEC, entity_type="user",
        target_entity_type="item", event_names=["rate", "buy"],
    )
    port_cols = EventColumns(
        BiMap(cols.entity_index.to_dict()), BiMap(cols.target_index.to_dict()),
        np.asarray(cols.entity_idx), np.asarray(cols.target_idx), np.asarray(cols.values),
    )
    return storage, port_cols


def test_filtering_engine_drops_exactly_the_blacklist_and_rereads_it(rating_store, tmp_path):
    storage, port_cols = rating_store
    blacklist = tmp_path / "blacklist.txt"
    jep = JaxEngineParams(
        data_source_params=("", jmf.DataSourceParams(app_name="flt", eval_k=0)),
        algorithm_params_list=(("als", jmf.ALSAlgorithmParams(**ALS)),),
        serving_params=("", jmf.TempFilterParams(filepath=str(blacklist))),
    )
    pep = EngineParams(
        data_source_params=("", pmf.DataSourceParams(app_name="flt")),
        algorithm_params_list=(("als", pmf.ALSAlgorithmParams(**ALS)),),
        serving_params=("", pmf.TempFilterParams(filepath=str(blacklist))),
    )
    [jm] = jmf.filtering_engine().train(JaxContext(storage=storage), jep, JaxWorkflowParams())
    [pm] = pmf.filtering_engine().train(
        WorkflowContext(CPU, {"flt": port_cols}), pep, WorkflowParams())
    assert_close(pm.arrays.user_factors, jm.arrays.user_factors)
    assert_close(pm.arrays.item_factors, jm.arrays.item_factors)
    _, _, jalgos, jserving = jmf.filtering_engine().make_components(jep)
    _, _, palgos, pserving = pmf.filtering_engine().make_components(pep)
    users = [str(u) for u in range(0, N_USERS, 11)]

    def served(blocked):
        blacklist.write_text("".join(f"{b}\n" for b in blocked))
        port, ref, unfiltered = [], [], []
        for u in users:
            pq, jq = pmf.Query(user=u, num=20), jmf.Query(user=u, num=20)
            p = palgos[0].predict(pm, pq)
            unfiltered.append(p)
            port.append(pserving.serve(pq, [p]))
            ref.append(jserving.serve(jq, [jalgos[0].predict(jm, jq)]))
        return port, ref, unfiltered

    first = [s.item for s in palgos[0].predict(pm, pmf.Query(user=users[0], num=20)).item_scores]
    for blocked in (first[:3] + ["no-such-item"], first[3:6]):  # the file edited in place
        port, ref, unfiltered = served(blocked)
        for p, u in zip(port, unfiltered):
            assert [s for s in u.item_scores if s.item not in blocked] == list(p.item_scores)
        assert not any(s.item in blocked for p in port for s in p.item_scores)
        assert any(len(p.item_scores) < 20 for p in port)
        assert_ranked_close(port, ref, pm.item_index)
    os.remove(blacklist)  # no file: nothing is filtered
    pq = pmf.Query(user=users[0], num=20)
    assert pserving.serve(pq, [palgos[0].predict(pm, pq)]) == palgos[0].predict(pm, pq)


# --- refactor_test ---


def test_the_vanilla_engine_and_evaluator_equal_the_reference():
    for mult in (1, 3):
        [jm] = jrt.refactor_test_engine().train(
            None, jrt.default_engine_params(mult), JaxWorkflowParams())
        [pm] = prt.refactor_test_engine().train(
            WorkflowContext(CPU), prt.default_engine_params(mult), WorkflowParams())
        assert pm.mc == jm.mc == sum(range(100)) * mult
        _, _, palgos, pserving = prt.refactor_test_engine().make_components(
            prt.default_engine_params(mult))
        assert pserving.serve(prt.Query(q=5), [palgos[0].predict(pm, prt.Query(q=5))]).p == jm.mc + 5
    jset = jrt.refactor_test_engine().batch_eval(
        None, [jrt.default_engine_params(1), jrt.default_engine_params(2)], JaxWorkflowParams())
    pset = prt.refactor_test_engine().batch_eval(
        WorkflowContext(CPU), [prt.default_engine_params(1), prt.default_engine_params(2)],
        WorkflowParams())
    jres = jrt.VanillaEvaluator().evaluate_base(None, None, jset, JaxWorkflowParams())
    pres = prt.VanillaEvaluator().evaluate_base(None, None, pset, WorkflowParams())
    assert (pres.n_sets, pres.total) == (jres.n_sets, jres.total) == (6, -3 * 20 * 3 * sum(range(100)))
    assert pres.to_one_liner() == jres.to_one_liner()
    assert pres.to_json() == jres.to_json()


def test_train_stops_after_read_and_after_prepare_and_checks_the_data(ratings_file):
    ep = EngineParams(
        data_source_params=("", pcd.FileDataSourceParams(filepath=ratings_file)),
        algorithm_params_list=(("als", pcd.ALSAlgorithmParams(**ALS)),),
    )
    engine, ctx = pcd.custom_datasource_engine(), WorkflowContext(CPU)
    with pytest.raises(StopAfterReadInterruption):
        engine.train(ctx, ep, WorkflowParams(stop_after_read=True))
    with pytest.raises(StopAfterPrepareInterruption):
        engine.train(ctx, ep, WorkflowParams(stop_after_prepare=True))
    empty = EngineParams(
        data_source_params=("", pcd.FileDataSourceParams(filepath=os.devnull)),
        algorithm_params_list=ep.algorithm_params_list,
    )
    with pytest.raises(ValueError, match="ratings is empty"):
        engine.train(ctx, empty, WorkflowParams())
    # an engine without a data source trains nothing
    with pytest.raises(NotImplementedError, match="event store"):
        plm.similarproduct_localmodel_engine().train(
            ctx, EngineParams(algorithm_params_list=(("als", plm.ALSAlgorithmParams()),)),
            WorkflowParams())


# --- similarproduct_localmodel ---


def views_of(module):
    rows = seeded_ratings()
    items = {f"i{i}": module.Item(categories=("even" if i % 2 == 0 else "odd",))
             for i in range(N_ITEMS)}
    return module.PreparedData(td=module.TrainingData(
        users={f"u{u}": {} for u in range(N_USERS)},
        items=items,
        view_events=[module.ViewEvent(user=f"u{u}", item=f"i{i}", t=float(n))
                     for n, (u, i, _) in enumerate(rows)],
    ))


def test_the_local_model_trains_and_predicts_as_the_reference():
    params = {"rank": 8, "num_iterations": 6, "lambda_": 0.01, "seed": 1}
    jm = jlm.ALSLocalAlgorithm(jlm.ALSAlgorithmParams(**params)).train(None, views_of(jsp))
    palgo = plm.ALSLocalAlgorithm(plm.ALSAlgorithmParams(**params))
    pm = palgo.train(CPU, views_of(psp))
    assert isinstance(pm, plm.ALSLocalModel) and isinstance(pm.product_features, dict)
    assert sorted(pm.product_features) == sorted(jm.product_features)
    assert_close(np.stack([pm.product_features[j] for j in sorted(pm.product_features)]),
                 np.stack([jm.product_features[j] for j in sorted(jm.product_features)]))
    assert pm.item_index.to_dict() == jm.item_index.to_dict()
    # no device state: serving hooks change nothing
    assert palgo.prepare_serving(CPU, pm) is pm and palgo.serving_precision(pm) is None
    palgo.warm(pm)
    palgo.release_serving(pm)
    queries = [
        dict(items=("i3",), num=10),
        dict(items=("i4", "i150"), num=8),
        dict(items=("i3",), num=10, categories=("even",)),
        dict(items=("i3",), num=5, white_list=("i1", "i5", "i7", "i9"), black_list=("i1",)),
        dict(items=("nope",), num=5),
    ]
    jalgo = jlm.ALSLocalAlgorithm(jlm.ALSAlgorithmParams(**params))
    got = [r for _, r in palgo.batch_predict(pm, list(enumerate(plm.Query(**q) for q in queries)))]
    want = [jalgo.predict(jm, jlm.Query(**q)) for q in queries]
    assert_ranked_close(got, want, pm.item_index)
    assert got[-1].item_scores == ()
    assert all(int(s.item[1:]) % 2 == 0 for s in got[2].item_scores)
    assert {s.item for s in got[3].item_scores} <= {"i5", "i7", "i9"}


# --- standalone_recommendations ---


def test_run_standalone_trains_and_predicts_as_the_reference(ratings_file):
    [jm] = jsr.run_standalone(ratings_file, **ALS)
    [pm] = psr.run_standalone(ratings_file, **ALS, device=CPU)
    assert pm.rank == jm.rank == ALS["rank"]
    assert_close(pm.user_features, jm.user_features)
    assert_close(pm.product_features, jm.product_features)
    palgo = psr.ALSAlgorithm(psr.AlgorithmParams(rank=ALS["rank"]))
    jalgo = jsr.ALSAlgorithm(jsr.AlgorithmParams(rank=ALS["rank"]))
    pairs = [tuple(map(int, p)) for p in seeded_ratings()[:200:5, :2]]
    got = [palgo.predict(pm, palgo.query_from_json(list(p))) for p in pairs]
    want = [jalgo.predict(jm, p) for p in pairs]
    assert_close(got, want)
    assert palgo.query_from_json([3, 4]) == (3, 4) and palgo.result_to_json(1.5) == 1.5
    # read_eval: every rating a (user, item) query with its rating
    [(data, _, qa)] = psr.FileDataSource(
        psr.FileDataSourceParams(filepath=ratings_file)).read_eval(None)
    [(_, _, jqa)] = jsr.FileDataSource(
        jsr.FileDataSourceParams(filepath=ratings_file)).read_eval(None)
    assert qa == jqa and len(qa) == N_RATINGS


def test_the_persistent_model_saves_as_npz_and_deploys_equal(ratings_file, tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "fs"))
    engine = psr.standalone_recommendations_engine()
    ep = psr.standalone_engine_params(ratings_file, **ALS, persist_model=True)
    models = engine.train(WorkflowContext(CPU), ep, WorkflowParams())
    [kept] = engine.make_serializable_models(CPU, "inst-1", ep, models)
    assert kept == PersistentModelManifest(
        "predictionio_tpu_torch.models.experimental.standalone_recommendations."
        "PMatrixFactorizationModel")
    saved = os.listdir(tmp_path / "fs" / "pmodels")
    assert saved == ["inst-1-PMatrixFactorizationModel.npz"]
    with np.load(tmp_path / "fs" / "pmodels" / saved[0], allow_pickle=False) as z:
        assert sorted(z.files) == ["__none_fields__", "product_features", "rank",
                                   "user_features"]
    [loaded] = engine.prepare_deploy(CPU, ep, [kept], engine_instance_id="inst-1")
    np.testing.assert_array_equal(loaded.user_features, models[0].user_features)
    np.testing.assert_array_equal(loaded.product_features, models[0].product_features)
    assert loaded.rank == ALS["rank"] and isinstance(loaded.rank, int)
    algo = psr.ALSAlgorithm(ep.algorithm_params_list[0][1])
    for p in [(0, 0), (3, 5), (N_USERS - 1, N_ITEMS - 2)]:
        assert algo.predict(loaded, p) == algo.predict(models[0], p)
    with pytest.raises(ValueError, match="engine instance id"):
        engine.prepare_deploy(CPU, ep, [kept])
    # persist_model off: the model is kept as it is, nothing written
    ep_off = psr.standalone_engine_params(ratings_file, **ALS, persist_model=False)
    [as_is] = engine.make_serializable_models(CPU, "inst-2", ep_off, models)
    assert as_is is models[0]
    assert os.listdir(tmp_path / "fs" / "pmodels") == saved
    [deployed] = engine.prepare_deploy(CPU, ep_off, [as_is])
    assert deployed is models[0]


def test_a_model_with_a_field_npz_cannot_hold_is_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "fs"))
    model = psr.PMatrixFactorizationModel(rank=2, user_features=np.zeros((2, 2)),
                                          product_features=np.array(["a", "b"]))
    with pytest.raises(ValueError, match="product_features"):
        model.save("x", psr.AlgorithmParams(persist_model=True), CPU)
    pmodels = tmp_path / "fs" / "pmodels"
    assert not pmodels.exists() or not os.listdir(pmodels)
