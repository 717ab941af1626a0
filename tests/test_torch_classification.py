"""The classification template in the port (``models/classification``,
``e2``, K18's ``ops/softmax_regression.py``, the context's
``aggregate_properties``, the model files and the CLI deploy) on the CPU,
against the JAX package on the same seeded inputs.

Tolerances:
- K18's twin: one step's gradient within 1e-6 of jax.grad's largest entry
  (float32 sums in two orders); whole trainings within 1e-5 of the
  largest entry of W and of b (200 steps carry that rounding);
- naive Bayes models within 2e-6 (integer-valued attributes give exact
  sums; ``log`` differs by about one float32 step); predicted labels,
  folds, queries and actuals equal.
"""

import concurrent.futures
import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.data.store import PEventStore
from predictionio_tpu.e2 import PropertiesToBinary as JaxPropertiesToBinary
from predictionio_tpu.e2 import split_data as jax_split_data
from predictionio_tpu.models.classification import engine as jcls
from predictionio_tpu.workflow.context import WorkflowContext as JaxWorkflowContext
from predictionio_tpu_torch.api.engine_server import DeployedEngine
from predictionio_tpu_torch.controller import FirstServing
from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.e2 import PropertiesToBinary, split_data
from predictionio_tpu_torch.models import classification as pcls_pkg
from predictionio_tpu_torch.models.classification import engine as pcls
from predictionio_tpu_torch.ops import naive_bayes as pnb
from predictionio_tpu_torch.ops import softmax_regression as sr
from predictionio_tpu_torch.utils.serialize import load_model, save_model
from predictionio_tpu_torch.workflow.context import WorkflowContext

NB_TOL, GRAD_RTOL, TRAIN_RTOL = 2e-6, 1e-6, 1e-5
APP = "clsapp"
LR_CASES = [(0.1, 0.0, 200), (0.05, 0.01, 200), (0.1, 0.0, 0)]


def bench_like(n=2_000, F=3, C=4, seed=13):
    rng = np.random.default_rng(seed)
    means = rng.uniform(1.0, 8.0, size=(C, F))
    y = rng.integers(0, C, n)
    return rng.poisson(means[y]).astype(np.float32), y


def template_loss(X, Y, l2):
    """The loss of the JAX template's LogisticRegressionAlgorithm.train."""
    def loss(params):
        W, b = params
        logp = jax.nn.log_softmax(X @ W.T + b)
        return -(Y * logp).sum(axis=1).mean() + l2 * (W ** 2).sum()
    return loss


def assert_within(got, want, rtol):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(np.asarray(got) - np.asarray(want)).max()) <= rtol * scale


# --- e2 ---


@pytest.mark.parametrize("eval_k", [1, 2, 3, 5])
def test_split_data_equals_the_reference(eval_k):
    data = list(range(11))
    args = (lambda d: list(d), lambda d: ("q", d), lambda d: ("a", d))
    assert split_data(eval_k, data, "info", *args) == jax_split_data(eval_k, data, "info", *args)


def test_split_data_refuses_eval_k_below_one():
    with pytest.raises(ValueError):
        split_data(0, [1, 2], None, list, str, str)


def test_properties_to_binary_equals_the_reference():
    maps = [{"color": "red", "size": "big", "noise": "x"}, {"color": "blue", "size": "big"},
            {"color": "red"}, {"size": "small", "color": "green"}]
    whitelist = {"color", "size"}
    port, ref = PropertiesToBinary.fit(maps, whitelist), JaxPropertiesToBinary.fit(maps, whitelist)
    assert port.property_map.to_dict() == ref.property_map.to_dict()
    assert port.num_features == ref.num_features == 5
    pairs = [("color", "blue"), ("size", "small"), ("noise", "x")]
    assert port.indices(pairs) == ref.indices(pairs)
    np.testing.assert_array_equal(port.to_binary(pairs), ref.to_binary(pairs))
    np.testing.assert_array_equal(port.to_binary_batch(maps), ref.to_binary_batch(maps))


# --- K18 ---


def test_one_step_gradient_equals_jax_grad_and_autograd():
    X, y = bench_like(300, seed=2)
    C, l2 = 4, 0.01
    rng = np.random.default_rng(3)
    W = (0.3 * rng.normal(size=(C, 3))).astype(np.float32)
    b = (0.3 * rng.normal(size=C)).astype(np.float32)
    jgW, jgb = jax.grad(template_loss(jnp.asarray(X), jax.nn.one_hot(jnp.asarray(y), C), l2))(
        (jnp.asarray(W), jnp.asarray(b)))
    gW, gb = sr.softmax_regression_grad_plain(
        torch.from_numpy(X), torch.from_numpy(y.astype(np.int32)), torch.from_numpy(W),
        torch.from_numpy(b), l2)
    assert_within(gW.numpy(), jgW, GRAD_RTOL)
    assert_within(gb.numpy(), jgb, GRAD_RTOL)
    # and torch.autograd of the same loss
    Wt = torch.from_numpy(W).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    Xt = torch.from_numpy(X)
    Yt = torch.nn.functional.one_hot(torch.from_numpy(y), C).float()
    logp = torch.log_softmax(Xt @ Wt.T + bt, dim=1)
    (-(Yt * logp).sum(1).mean() + l2 * (Wt ** 2).sum()).backward()
    assert_within(gW.numpy(), Wt.grad.numpy(), GRAD_RTOL)
    assert_within(gb.numpy(), bt.grad.numpy(), GRAD_RTOL)


@pytest.mark.parametrize("lr,l2,iterations", LR_CASES)
def test_training_equals_the_template(lr, l2, iterations):
    X, y = bench_like(1_500, seed=5)
    labels = np.asarray([2.0, 0.5, 9.0, 4.0], np.float32)[y]
    params = dict(learning_rate=lr, l2=l2, iterations=iterations)
    td_j = jcls.TrainingData(labels=labels, features=X)
    want = jcls.LogisticRegressionAlgorithm(
        jcls.LogisticRegressionAlgorithmParams(**params)).train(None, jcls.PreparedData(td_j))
    got = pcls.LogisticRegressionAlgorithm(pcls.LogisticRegressionAlgorithmParams(**params)).train(
        torch.device("cpu"), pcls.PreparedData(pcls.TrainingData(labels=labels, features=X)))
    np.testing.assert_array_equal(got.labels, want.labels)
    if iterations == 0:
        assert not got.weights.any() and not got.bias.any()
        assert got.weights.shape == (4, 3) and got.bias.shape == (4,)
    assert_within(got.weights, want.weights, TRAIN_RTOL)
    assert_within(got.bias, want.bias, TRAIN_RTOL)


def test_softmax_regression_routes_cpu_tensors_to_the_twin_and_refuses_bad_input():
    X, y = bench_like(100)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y.astype(np.int32))
    sr.LAUNCHES.reset()
    W, b = sr.softmax_regression(Xt, yt, 4, 0.1, 0.0, 3)
    want = sr.softmax_regression_plain(Xt, yt, 4, 0.1, 0.0, 3)
    assert torch.equal(W, want[0]) and torch.equal(b, want[1])
    assert sr.LAUNCHES.snapshot() == {"softmax_regression": 0, "softmax_regression_plain": 1}
    for bad in ((Xt.double(), yt), (Xt, yt.long()), (Xt, yt[:5])):
        with pytest.raises(ValueError):
            sr.softmax_regression(*bad, 4, 0.1, 0.0, 1)
    with pytest.raises(ValueError):
        sr.softmax_regression(Xt, yt, 4, 0.1, 0.0, -1)


@pytest.mark.parametrize("n,C,F", [(1, 1, 1), (50_000, 4, 3), (200_000, 10, 64), (7, 60, 100)])
def test_softmax_regression_plan_fits_a_block(n, C, F):
    nblk, rows, tile = sr.plan(n, C, F)
    assert (nblk - 1) * rows < n <= nblk * rows and nblk <= 528
    assert tile in (32, 64, 128) and 4 * (tile * (F + C) + C * (F + 1)) <= 48 * 1024


def test_softmax_regression_plan_refuses_a_partial_that_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        sr.plan(100, 200, 100)


# --- the template end to end ---


def put_users(storage, rng, n_users=90):
    """$set events of users with plan and attr0..attr2 (some missing attr2,
    some updated later), as tests/test_templates.py builds them."""
    from test_templates import make_app, put

    app_id = make_app(storage, APP)
    for uid in range(n_users):
        plan = float(uid % 3) * 1.5
        props = {"plan": plan, "attr0": float(rng.poisson(1 + 3 * (uid % 3))),
                 "attr1": float(rng.poisson(2)), "attr2": float(rng.poisson(5 - uid % 3))}
        if uid % 17 == 5:
            del props["attr2"]
        put(storage, app_id, "$set", "user", f"u{uid}", props=props)
    for uid in range(0, n_users, 10):  # a later $set overrides attr1
        put(storage, app_id, "$set", "user", f"u{uid}", props={"attr1": 7.0})
    put(storage, app_id, "$set", "item", "i0", props={"plan": 1.0})


@pytest.fixture()
def stores(mem_storage):
    put_users(mem_storage, np.random.default_rng(21))
    maps = PEventStore(mem_storage).aggregate_properties(APP, entity_type="user")
    ctx = WorkflowContext(
        "cpu", properties={(APP, "user"): {eid: dict(pm) for eid, pm in maps.items()}})
    return JaxWorkflowContext(mode="training", storage=mem_storage), ctx


def port_and_jax(name, params):
    palg = {"naive": pcls.NaiveBayesAlgorithm,
            "logisticregression": pcls.LogisticRegressionAlgorithm}[name]
    jalg = {"naive": jcls.NaiveBayesAlgorithm,
            "logisticregression": jcls.LogisticRegressionAlgorithm}[name]
    return palg(palg.params_class(**params)), jalg(jalg.params_class(**params))


@pytest.mark.parametrize("name,params", [
    ("naive", {}), ("naive", {"lambda_": 0.3}), ("logisticregression", {}),
    ("logisticregression", {"learning_rate": 0.05, "l2": 0.01, "iterations": 50}),
])
def test_the_template_trains_and_predicts_as_the_reference(stores, name, params):
    jctx, ctx = stores
    jtd = jcls.DataSource(jcls.DataSourceParams(app_name=APP)).read_training(jctx)
    td = pcls.DataSource(pcls.DataSourceParams(app_name=APP)).read_training(ctx)
    np.testing.assert_array_equal(td.labels, jtd.labels)
    np.testing.assert_array_equal(td.features, jtd.features)
    assert len(td.labels) == 90 - 5  # five users lack attr2; the item is not a user
    palg, jalg = port_and_jax(name, params)
    model = palg.train(torch.device("cpu"), pcls.Preparator().prepare(torch.device("cpu"), td))
    jmodel = jalg.train(None, jcls.Preparator().prepare(None, jtd))
    if name == "naive":
        np.testing.assert_allclose(model.pi, jmodel.pi, rtol=0, atol=NB_TOL)
        np.testing.assert_allclose(model.theta, jmodel.theta, rtol=0, atol=NB_TOL)
    else:
        assert_within(model.weights, jmodel.weights, TRAIN_RTOL)
        assert_within(model.bias, jmodel.bias, TRAIN_RTOL)
    np.testing.assert_array_equal(model.labels, jmodel.labels)
    rng = np.random.default_rng(8)
    feats = rng.poisson(3.0, size=(40, 3)).astype(float)
    queries = [(i, pcls.Query(features=tuple(f))) for i, f in enumerate(feats)]
    jqueries = [(i, jcls.Query(features=tuple(f))) for i, f in enumerate(feats)]
    got = [(i, p.label) for i, p in palg.batch_predict(model, queries)]
    assert got == [(i, p.label) for i, p in jalg.batch_predict(jmodel, jqueries)]
    assert palg.predict(model, queries[3][1]).label == got[3][1]


def test_read_eval_gives_the_reference_folds(stores):
    jctx, ctx = stores
    jfolds = jcls.DataSource(jcls.DataSourceParams(app_name=APP, eval_k=3)).read_eval(jctx)
    folds = pcls.DataSource(pcls.DataSourceParams(app_name=APP, eval_k=3)).read_eval(ctx)
    assert len(folds) == len(jfolds) == 3
    for (td, info, qa), (jtd, jinfo, jqa) in zip(folds, jfolds):
        assert info is None and jinfo is None
        np.testing.assert_array_equal(td.labels, jtd.labels)
        np.testing.assert_array_equal(td.features, jtd.features)
        assert [(q.features, a.label) for q, a in qa] == [(q.features, a.label) for q, a in jqa]
    assert pcls.DataSource(pcls.DataSourceParams(app_name=APP)).read_eval(ctx) == []


def test_engine_eval_serves_each_fold_with_both_algorithms(stores):
    _, ctx = stores
    engine = pcls_pkg.classification_engine()
    ep = EngineParams(
        data_source_params=("", pcls.DataSourceParams(app_name=APP, eval_k=3)),
        algorithm_params_list=(("naive", pcls.NaiveBayesAlgorithmParams()),
                               ("logisticregression", pcls.LogisticRegressionAlgorithmParams())),
    )
    out = engine.eval(ctx, ep, None)
    assert len(out) == 3 and sum(len(rows) for _, rows in out) == 85
    folds = pcls.DataSource(pcls.DataSourceParams(app_name=APP, eval_k=3)).read_eval(ctx)
    for (td, _, qa), (_, rows) in zip(folds, out):
        # first serving: the naive Bayes model's answers
        nb = pcls.NaiveBayesAlgorithm()
        model = nb.train(ctx.device, pcls.PreparedData(td))
        want = nb.batch_predict(model, list(enumerate(q for q, _ in qa)))
        assert [p for _, p, _ in rows] == [p for _, p in want]
    assert isinstance(engine.serving_class_map[""](), FirstServing)
    assert pcls_pkg.ClassificationEngineFactory().apply().algorithm_class_map == {
        "naive": pcls.NaiveBayesAlgorithm,
        "logisticregression": pcls.LogisticRegressionAlgorithm,
    }


def test_context_properties_filter_required_and_name_the_event_store():
    props = {"a": {"plan": 1, "x": 2}, "b": {"x": 3}, "c": {"plan": 0}}
    ctx = WorkflowContext("cpu", properties={("app", "user"): props})
    assert list(ctx.aggregate_properties("app", "user")) == ["a", "b", "c"]
    assert list(ctx.aggregate_properties("app", "user", required=["plan"])) == ["a", "c"]
    assert list(ctx.aggregate_properties("app", "user", required=["plan", "x"])) == ["a"]
    with pytest.raises(KeyError, match="item 3"):
        ctx.aggregate_properties("app", "item")
    with pytest.raises(KeyError, match="item 3"):
        ctx.aggregate_properties("other", "user")
    with pytest.raises(NotImplementedError, match="item 3"):
        ctx.aggregate_properties("app", "user", channel_name="ch")
    with pytest.raises(KeyError):
        WorkflowContext("cpu").find_columns("app")


# --- models across, files, deploy ---


def jax_models():
    X, y = bench_like(800, seed=4)
    labels = np.asarray([1.0, 0.0, 7.5, 3.0], np.float32)[y]
    td = jcls.PreparedData(jcls.TrainingData(labels=labels, features=X))
    nb = jcls.NaiveBayesAlgorithm().train(None, td)
    lr = jcls.LogisticRegressionAlgorithm(
        jcls.LogisticRegressionAlgorithmParams(iterations=60)).train(None, td)
    return nb, lr, X


def test_models_from_numpy_serve_jax_trained_models_as_jax():
    nb, lr, X = jax_models()
    pnb_model = pcls.nb_model_from_numpy(nb.pi, nb.theta, nb.labels, device="cpu")
    plr_model = pcls.lr_model_from_numpy(lr.weights, lr.bias, lr.labels)
    queries = [(i, pcls.Query(features=tuple(x))) for i, x in enumerate(X[:64])]
    jqueries = [(i, jcls.Query(features=tuple(x))) for i, x in enumerate(X[:64])]
    for palg, jalg, pm, jm in ((pcls.NaiveBayesAlgorithm(), jcls.NaiveBayesAlgorithm(), pnb_model, nb),
                               (pcls.LogisticRegressionAlgorithm(),
                                jcls.LogisticRegressionAlgorithm(), plr_model, lr)):
        assert [p.label for _, p in palg.batch_predict(pm, queries)] == [
            p.label for _, p in jalg.batch_predict(jm, jqueries)]
    with pytest.raises(ValueError):
        pcls.nb_model_from_numpy(nb.pi, nb.theta[:2], nb.labels, device="cpu")
    with pytest.raises(ValueError):
        pcls.lr_model_from_numpy(lr.weights, lr.bias[:2], lr.labels)


@pytest.mark.parametrize("name", ["naive", "logisticregression"])
def test_save_and_load_round_trip(tmp_path, name):
    nb, lr, _ = jax_models()
    model = (pcls.nb_model_from_numpy(nb.pi, nb.theta, nb.labels, device="cpu") if name == "naive"
             else pcls.lr_model_from_numpy(lr.weights, lr.bias, lr.labels))
    path = tmp_path / f"{name}.npz"
    save_model(path, model)
    with np.load(path, allow_pickle=False) as z:
        assert str(z["engine"]) == "classification" and str(z["algorithm"]) == name
    back = load_model(path)
    assert type(back) is type(model)
    for field in dataclasses.fields(model):
        if field.name != "device":
            np.testing.assert_array_equal(getattr(back, field.name), getattr(model, field.name))
    # labels that are not numbers are refused before a pickle could be written
    with pytest.raises(ValueError, match="labels"):
        save_model(tmp_path / "bad.npz", dataclasses.replace(
            model, labels=np.asarray([object()] * len(model.labels), dtype=object)))


def test_deploying_both_models_serves_the_first(tmp_path):
    """Both algorithms in one deployed engine: each batch goes through
    both models (``serve_batch``), and first serving answers with the naive
    Bayes model's label."""
    nb, lr, X = jax_models()
    engine = pcls.classification_engine()
    ep = EngineParams(algorithm_params_list=(
        ("naive", pcls.NaiveBayesAlgorithmParams()),
        ("logisticregression", pcls.LogisticRegressionAlgorithmParams())))
    models = engine.prepare_deploy(
        torch.device("cpu"), ep, [pcls.nb_model_from_numpy(nb.pi, nb.theta, nb.labels, "cpu"),
                                  pcls.lr_model_from_numpy(lr.weights, lr.bias, lr.labels)])
    assert models[0].device == torch.device("cpu")
    deployed = DeployedEngine(engine, ep, models)
    queries = [pcls.Query(features=tuple(x)) for x in X[:32]]
    got = deployed.serve_batch(queries)
    want = pcls.NaiveBayesAlgorithm().batch_predict(models[0], list(enumerate(queries)))
    assert got == [p for _, p in want]


@pytest.mark.parametrize("name", ["naive", "logisticregression"])
def test_a_model_file_deployed_by_the_cli_answers_as_batch_predict(tmp_path, name):
    from test_torch_engine_server import _deploy_file_in_thread, _free_port, _request

    nb, lr, X = jax_models()
    model = (pcls.nb_model_from_numpy(nb.pi, nb.theta, nb.labels, device="cpu") if name == "naive"
             else pcls.lr_model_from_numpy(lr.weights, lr.bias, lr.labels))
    algo = (pcls.NaiveBayesAlgorithm() if name == "naive" else pcls.LogisticRegressionAlgorithm())
    path = tmp_path / f"cls_{name}.npz"
    save_model(path, model)
    port = _free_port()
    thread, failures = _deploy_file_in_thread(path, port)
    try:
        bodies = [{"features": [float(v) for v in x]} for x in X[:24]]
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(
                lambda b: _request(port, "POST", "/queries.json", json.dumps(b).encode()), bodies))
        want = algo.batch_predict(model, [(i, pcls.Query(**b)) for i, b in enumerate(bodies)])
        for (status, raw), (_, p) in zip(answers, want):
            assert status == 200
            payload = json.loads(raw)
            assert payload["label"] == p.label
            assert payload["modelVersion"] == f"cls_{name}"
        status = json.loads(_request(port, "GET", "/status.json")[1])
        assert status["algorithms"] == [type(algo).__name__]
        assert _request(port, "POST", "/queries.json", b'{"feat": [1]}')[0] == 400
        assert _request(port, "GET", "/stop") == (200, b"Shutting down...")
        thread.join(timeout=30)
        assert not thread.is_alive() and not failures
    finally:
        if thread.is_alive():
            urllib.request.urlopen(f"http://127.0.0.1:{port}/stop", timeout=10)


def test_naive_bayes_predicts_through_k15b_and_counts_it():
    nb, _, X = jax_models()
    model = pcls.nb_model_from_numpy(nb.pi, nb.theta, nb.labels, device="cpu")
    pnb.LAUNCHES.reset()
    pcls.NaiveBayesAlgorithm().batch_predict(
        model, [(i, pcls.Query(features=tuple(x))) for i, x in enumerate(X[:50])])
    assert pnb.LAUNCHES.snapshot()["naive_bayes_scores_plain"] == 1
