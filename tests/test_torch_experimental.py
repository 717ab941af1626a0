"""The experimental templates of the port (``models/experimental``:
regression, stock, helloworld) and ``SimpleEngine`` on the CPU, against the
JAX package's templates on the same seeded inputs, and the OLS model file
served by ``tools.cli deploy``.

Tolerances:
- regression: coefficients within 1e-5 of the largest entry (float32 SVD
  against the port's float64 normal equations, both near float64 on a
  well-conditioned design), predictions and the 3-fold MSE within 1e-5
  relative;
- stock: the backtest's predictions within 1e-4 of the largest prediction
  of the day; the daily decisions equal, except for a ticker whose
  prediction lies within that gap of a threshold; ``MomentumStrategy``
  (host numpy, copied) bit for bit.
"""

import concurrent.futures
import json
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import EmptyParams as JaxEmptyParams
from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.controller.engine import SimpleEngineParams as JaxSimpleEngineParams
from predictionio_tpu.controller.evaluation import Evaluation as JaxEvaluation
from predictionio_tpu.data.storage import memory_storage
from predictionio_tpu.models.experimental import helloworld as jhello
from predictionio_tpu.models.experimental import regression as jreg
from predictionio_tpu.models.experimental import stock as jstock
from predictionio_tpu.workflow.context import WorkflowContext as JaxContext
from predictionio_tpu.workflow.core_workflow import CoreWorkflow as JaxCoreWorkflow
from predictionio_tpu.workflow.workflow_params import WorkflowParams as JaxWorkflowParams
from predictionio_tpu_torch.controller import EmptyParams, SimpleEngine, SimpleEngineParams
from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.controller.evaluation import Evaluation
from predictionio_tpu_torch.controller.params import params_from_json, params_to_json
from predictionio_tpu_torch.models.experimental import helloworld as phello
from predictionio_tpu_torch.models.experimental import regression as preg
from predictionio_tpu_torch.models.experimental import stock as pstock
from predictionio_tpu_torch.ops import lstsq as k21
from predictionio_tpu_torch.utils.serialize import load_model, save_model
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.core_workflow import run_evaluation

CPU = torch.device("cpu")
REG_TOL = 1e-5
STOCK_TOL = 1e-4


@pytest.fixture(scope="module")
def reg_file(tmp_path_factory):
    """2,000 lines of "y x1 .. x6": a seeded linear model with noise."""
    rng = np.random.default_rng(21)
    w = rng.uniform(-2.0, 2.0, 6)
    X = rng.standard_normal((2_000, 6))
    y = X @ w + 0.05 * rng.standard_normal(2_000)
    path = tmp_path_factory.mktemp("reg") / "reg.txt"
    with open(path, "w") as f:
        for xi, yi in zip(X, y):
            f.write(f"{yi} {' '.join(str(v) for v in xi)}\n")
    return str(path)


def assert_within(got, want, rtol):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(np.asarray(got) - np.asarray(want)).max()) <= rtol * scale


# --- regression ---


def test_ols_train_and_batch_predict_match_the_reference(reg_file):
    jtd = jreg.DataSource(jreg.DataSourceParams(filepath=reg_file)).read_training(None)
    ptd = preg.DataSource(preg.DataSourceParams(filepath=reg_file)).read_training(None)
    np.testing.assert_array_equal(ptd.x, jtd.x)
    prep = preg.Preparator(preg.PreparatorParams(n=5, k=1)).prepare(CPU, ptd)
    jprep = jreg.Preparator(jreg.PreparatorParams(n=5, k=1)).prepare(None, jtd)
    np.testing.assert_array_equal(prep.y, jprep.y)
    k21.LAUNCHES.reset()
    model = preg.OLSAlgorithm().train(CPU, prep)
    assert k21.LAUNCHES.snapshot()["lsq_plain"] == 1
    want = jreg.OLSAlgorithm().train(None, jprep)
    assert model.dtype == np.float32 and model.shape == want.shape == (6,)
    assert_within(model, want, REG_TOL)
    queries = [(i, preg.Query(tuple(x))) for i, x in enumerate(ptd.x[:300])]
    got = [p.prediction for _, p in preg.OLSAlgorithm().batch_predict(model, queries)]
    ref = [p.prediction for _, p in jreg.OLSAlgorithm().batch_predict(
        want, [(i, jreg.Query(q.features)) for i, q in queries])]
    assert_within(got, ref, REG_TOL)
    assert preg.OLSAlgorithm().predict(model, queries[0][1]).prediction == pytest.approx(got[0])
    with pytest.raises(ValueError, match="empty"):
        preg.OLSAlgorithm().train(CPU, preg.TrainingData(np.zeros((0, 6), np.float32),
                                                         np.zeros(0, np.float32)))


def test_run_evaluation_mse_over_three_folds_matches_the_reference(reg_file):
    ds_params = dict(filepath=reg_file, eval_k=3)
    want = JaxCoreWorkflow.run_evaluation(
        JaxEvaluation().set_engine_metric(jreg.regression_engine(), jreg.MeanSquareError()),
        [JaxEngineParams(data_source_params=("", jreg.DataSourceParams(**ds_params)),
                         algorithm_params_list=(("ols", JaxEmptyParams()),))],
        ctx=JaxContext(mode="evaluation", storage=memory_storage()),
    )
    k21.LAUNCHES.reset()
    got = run_evaluation(
        Evaluation().set_engine_metric(preg.regression_engine(), preg.MeanSquareError()),
        [EngineParams(data_source_params=("", preg.DataSourceParams(**ds_params)),
                      algorithm_params_list=(("ols", EmptyParams()),))],
        ctx=WorkflowContext("cpu"),
    )
    assert k21.LAUNCHES.snapshot()["lsq_plain"] == 3  # one solve a fold
    assert got.best_score.score == pytest.approx(want.best_score.score, rel=REG_TOL)
    assert got.best_score.score < 0.01
    assert got.metric_header == want.metric_header == "MeanSquareError"


def test_the_ols_model_file_deployed_by_the_cli_answers_as_batch_predict(tmp_path, reg_file):
    from test_torch_engine_server import _deploy_file_in_thread, _free_port, _request

    td = preg.DataSource(preg.DataSourceParams(filepath=reg_file)).read_training(None)
    model = preg.OLSAlgorithm().train(CPU, td)
    path = tmp_path / "ols.npz"
    save_model(path, model)
    np.testing.assert_array_equal(load_model(path), model)
    with pytest.raises(ValueError, match="coefficient"):
        save_model(tmp_path / "bad.npz", np.zeros((2, 2), np.float32))
    port = _free_port()
    thread, failures = _deploy_file_in_thread(path, port)
    try:
        bodies = [{"features": [float(v) for v in x]} for x in td.x[:24]]
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(
                lambda b: _request(port, "POST", "/queries.json", json.dumps(b).encode()), bodies))
        want = preg.OLSAlgorithm().batch_predict(
            model, [(i, preg.Query(**b)) for i, b in enumerate(bodies)])
        for (status, raw), (_, p) in zip(answers, want):
            assert status == 200
            payload = json.loads(raw)
            assert payload["prediction"] == p.prediction and payload["modelVersion"] == "ols"
        status = json.loads(_request(port, "GET", "/status.json")[1])
        assert status["algorithms"] == ["OLSAlgorithm"]
        assert _request(port, "GET", "/stop") == (200, b"Shutting down...")
        thread.join(timeout=30)
        assert not thread.is_alive() and not failures
    finally:
        if thread.is_alive():
            urllib.request.urlopen(f"http://127.0.0.1:{port}/stop", timeout=10)


# --- stock ---


def backtest_with_predictions(module, algo, train_arg):
    """``backtest``'s loop, keeping each day's predictions: (decisions,
    predictions, result)."""
    ds = module.DataSource(module.DataSourceParams())
    ev = module.BacktestingEvaluator(module.BacktestingParams())
    decisions, preds, raw = [], [], None
    for td, _, qa in ds.read_eval(None):
        raw = td.raw
        model = algo.train(train_arg, td)
        for query, _ in qa:
            pred = algo.predict(model, query)
            preds.append(pred.data)
            decisions.append(ev.daily_decision(query.idx, pred))
    return decisions, preds, ev.evaluate_all(raw, decisions)


def test_the_regression_backtest_matches_the_reference():
    k21.LAUNCHES.reset()
    got_dec, got_pred, got = backtest_with_predictions(
        pstock, pstock.RegressionStrategy(), CPU)
    assert k21.LAUNCHES.snapshot()["lsq_plain"] == 4  # one solve a window
    want_dec, want_pred, want = backtest_with_predictions(
        jstock, jstock.RegressionStrategy(), None)
    assert len(got_pred) == len(want_pred) == 200
    params = pstock.BacktestingParams()
    thresholds = np.asarray([params.enter_threshold, params.exit_threshold])
    exact = True
    for day, (g, w, gd, wd) in enumerate(zip(got_pred, want_pred, got_dec, want_dec)):
        assert list(g) == list(w)
        gv, wv = np.asarray(list(g.values())), np.asarray(list(w.values()))
        gap = STOCK_TOL * np.abs(wv).max()
        assert np.abs(gv - wv).max() <= gap, day
        if gd != wd:
            exact = False
            near = {t for t, v in w.items() if np.abs(v - thresholds).min() <= gap}
            differ = (set(gd[1]) ^ set(wd[1])) | (set(gd[2]) ^ set(wd[2]))
            assert differ <= near, (day, differ)
    if exact:
        assert [d.nav for d in got.daily] == pytest.approx([d.nav for d in want.daily], rel=1e-12)
        assert got.overall.days == want.overall.days == 200
    # the template's own entry point runs the same loop
    result = pstock.backtest(pstock.RegressionStrategy(), ctx=WorkflowContext("cpu"))
    assert [d.nav for d in result.daily] == [d.nav for d in got.daily]


def test_the_momentum_backtest_equals_the_reference_bit_for_bit():
    params = dict(n_days=450, from_idx=350, until_idx=430, training_window_size=200,
                  max_test_duration=40)
    bt = dict(enter_threshold=0.0005, exit_threshold=0.0, max_positions=2)
    got = pstock.backtest(pstock.MomentumStrategy(pstock.MomentumStrategyParams(l=20, s=3)),
                          pstock.DataSourceParams(**params), pstock.BacktestingParams(**bt),
                          ctx=WorkflowContext("cpu"))
    want = jstock.backtest(jstock.MomentumStrategy(jstock.MomentumStrategyParams(l=20, s=3)),
                           jstock.DataSourceParams(**params), jstock.BacktestingParams(**bt))
    assert [vars(d) for d in got.daily] == [vars(d) for d in want.daily]
    assert vars(got.overall) == vars(want.overall)


def test_a_panel_of_other_tickers_through_the_data_source_params():
    tickers = ("SPY",) + tuple(f"T{j:03d}" for j in range(40))
    params = pstock.DataSourceParams(tickers=tickers)
    assert params_from_json(params_to_json(params), pstock.DataSourceParams) == params
    k21.LAUNCHES.reset()
    result = pstock.backtest(pstock.RegressionStrategy(), params, ctx=WorkflowContext("cpu"))
    assert k21.LAUNCHES.snapshot()["lsq_plain"] == 4
    assert result.overall.days == 200 and np.isfinite(result.overall.sharpe)
    raw = pstock.DataSource(params)._raw()
    assert raw.tickers == tickers and raw.mkt_ticker == "SPY" and raw.price.shape == (600, 41)


def test_the_stock_engine_and_its_errors(monkeypatch):
    engine = pstock.stock_engine("momentum")
    assert isinstance(engine, SimpleEngine)
    assert engine.algorithm_class_map == {"": pstock.MomentumStrategy}
    assert pstock.StockEngineFactory().apply().algorithm_class_map == {
        "": pstock.RegressionStrategy}
    with pytest.raises(ValueError, match="eval windows"):
        pstock.backtest(pstock.MomentumStrategy(),
                        pstock.DataSourceParams(from_idx=300, until_idx=300),
                        ctx=WorkflowContext("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pstock.backtest(pstock.RegressionStrategy())


@pytest.mark.parametrize("template", ["stock", "regression"])
def test_a_solve_that_did_not_converge_raises_in_the_template(monkeypatch, template):
    def unconverged(A, b):
        res = k21.lstsq(A, b)
        return res._replace(sweeps=torch.full(res.rank.shape, -1, dtype=torch.int32))

    module = pstock if template == "stock" else preg
    monkeypatch.setattr(module, "lstsq", unconverged)
    with pytest.raises(ArithmeticError, match="did not converge"):
        if template == "stock":
            pstock.backtest(pstock.RegressionStrategy(), ctx=WorkflowContext("cpu"))
        else:
            rng = np.random.default_rng(5)
            td = preg.TrainingData(x=rng.standard_normal((50, 3)), y=rng.standard_normal(50))
            preg.OLSAlgorithm().train(torch.device("cpu"), td)


# --- helloworld and SimpleEngine ---


def test_helloworld_through_simple_engine_matches_the_reference(tmp_path):
    csv = tmp_path / "data.csv"
    csv.write_text("Mon,75.5\nTue,80.1\nMon,76.5\nWed,69.0\n\nTue,70.3\n")
    ep = SimpleEngineParams(
        data_source_params=phello.DataSourceParams(filepath=str(csv))).to_engine_params()
    jep = JaxSimpleEngineParams(
        data_source_params=jhello.DataSourceParams(filepath=str(csv))).to_engine_params()
    assert ep.to_json() == jep.to_json()
    engine = phello.helloworld_engine()
    assert isinstance(engine, SimpleEngine)
    ds, prep, [algo], serving = engine.make_components(ep)
    ctx = WorkflowContext("cpu")
    model = algo.train(ctx.device, prep.prepare(ctx.device, ds.read_training(ctx)))
    [want] = jhello.helloworld_engine().train(None, jep, JaxWorkflowParams())
    assert model.temperatures == want.temperatures
    assert str(model) == str(want)
    for day in ("Mon", "Tue", "Wed"):
        q = phello.Query(day=day)
        assert serving.serve(q, [algo.predict(model, q)]) == phello.PredictedResult(
            temperature=want.temperatures[day])
    assert phello.HelloWorldEngineFactory().apply().algorithm_class_map == {"": phello.Algorithm}
