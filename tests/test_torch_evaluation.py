"""Grid evaluation in the port (``run_evaluation``, FastEval, the k-fold
DataSource, Precision@K and the metric family) against the JAX package on
the CPU (``device="cpu"``: every kernel by its plain twin).

The event data is bench config 5's (``bench.py:2034-2052``: 400 users x
300 items, 40 ratings each from seed 29, two clusters), stored in a JAX
memory store; the port reads the columns that store's ``find_columns``
returns, carried across as numpy. Tolerances, stated beforehand:
- metrics, the evaluator's pick and its JSON, the folds: equal (the same
  host arithmetic on the same inputs);
- ``run_evaluation`` against the JAX package's: the same best variant and
  every Precision@10 within 0.02, the reference's own allowance between
  its grid and per-variant paths (tests/test_recommendation_eval.py:113):
  float32 programs that round differently can flip a tie in a top 10.
"""

import dataclasses
import json

import numpy as np
import pytest

from predictionio_tpu.controller import evaluation as jax_evaluation
from predictionio_tpu.controller import metrics as jax_metrics
from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.data import storage as storage_mod
from predictionio_tpu.data.event import DataMap, Event
from predictionio_tpu.data.storage.base import App
from predictionio_tpu.data.store import PEventStore
from predictionio_tpu.models.recommendation import engine as jax_rec
from predictionio_tpu.models.recommendation import evaluation as jax_rec_eval
from predictionio_tpu.workflow.context import WorkflowContext as JaxContext
from predictionio_tpu.workflow.core_workflow import CoreWorkflow as JaxCoreWorkflow
from predictionio_tpu_torch.controller import evaluation as port_evaluation
from predictionio_tpu_torch.controller import metrics as port_metrics
from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.store import EventColumns
from predictionio_tpu_torch.models.recommendation import engine as port_rec
from predictionio_tpu_torch.models.recommendation import evaluation as port_rec_eval
from predictionio_tpu_torch.ops.native import KernelError
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.core_workflow import run_evaluation
from predictionio_tpu_torch.workflow.workflow_params import WorkflowParams

SCORE_ATOL = 0.02


@pytest.fixture(scope="module")
def store():
    """Bench config 5's ratings in a JAX memory store, and the port's
    EventColumns of the same scan."""
    storage = storage_mod.memory_storage()
    app_id = storage.get_meta_data_apps().insert(App(id=0, name="default"))
    events = storage.get_l_events()
    events.init(app_id)
    rng = np.random.default_rng(29)
    n_users, n_items = 400, 300
    for uu in range(n_users):
        lo = 0 if uu % 2 == 0 else n_items // 2
        for it in rng.choice(n_items // 2, size=40, replace=False):
            events.insert(
                Event(
                    event="rate", entity_type="user", entity_id=f"u{uu}",
                    target_entity_type="item", target_entity_id=f"i{lo + it}",
                    properties=DataMap({"rating": float(rng.integers(3, 6))}),
                ),
                app_id,
            )
    cols = PEventStore(storage).find_columns(
        "default", value_spec=jax_rec.RATING_SPEC, entity_type="user",
        target_entity_type="item", event_names=["rate", "buy"],
    )
    port_cols = EventColumns(
        BiMap(cols.entity_index.to_dict()), BiMap(cols.target_index.to_dict()),
        np.asarray(cols.entity_idx), np.asarray(cols.target_idx), np.asarray(cols.values),
    )
    return storage, port_cols


def _ctx(store):
    return WorkflowContext("cpu", {"default": store[1]})


# --- metrics ---


def _eval_set(with_none: bool):
    rng = np.random.default_rng(5)
    out = []
    for fold in range(3):
        qpa = []
        for q in range(7):
            a = None if with_none and (fold + q) % 4 == 0 else float(rng.integers(0, 5))
            qpa.append((q, float(rng.standard_normal()), a))
        out.append(({"fold": fold}, qpa))
    return out


def _point(q, p, a):
    return None if a is None else (p - a) ** 2 + q


@pytest.mark.parametrize("name", [
    "AverageMetric", "OptionAverageMetric", "StdevMetric", "OptionStdevMetric",
    "SumMetric", "ZeroMetric",
])
def test_each_metric_equals_the_reference_metric(name):
    jcls, pcls = getattr(jax_metrics, name), getattr(port_metrics, name)
    option = name.startswith("Option") or name == "ZeroMetric"
    data = _eval_set(with_none=option)
    jm = type("J", (jcls,), {"calculate_point": staticmethod(_point)})()
    pm = type("P", (pcls,), {"calculate_point": staticmethod(_point)})()
    got, want = pm.calculate(None, data), jm.calculate(None, data)
    assert got == want
    assert pm.is_larger_better == jm.is_larger_better
    for a, b in ((got, None), (None, got), (None, None), (got, got + 1.0), (got + 1.0, got)):
        assert pm.compare(a, b) == jm.compare(a, b)
    # an empty set: nan in both (ZeroMetric: 0)
    np.testing.assert_equal(pm.calculate(None, []), jm.calculate(None, []))


def test_precision_at_k_equals_the_reference():
    rng = np.random.default_rng(9)
    jm, pm = jax_rec_eval.PrecisionAtK(k=4), port_rec_eval.PrecisionAtK(k=4)
    assert pm.header == jm.header == "Precision@4"
    for _ in range(50):
        pred = [f"i{j}" for j in rng.choice(20, size=int(rng.integers(0, 8)), replace=False)]
        actual = tuple(f"i{j}" for j in rng.choice(20, size=int(rng.integers(0, 6)), replace=False))
        jp = jax_rec.PredictedResult(item_scores=tuple(jax_rec.ItemScore(i, 1.0) for i in pred))
        pp = port_rec.PredictedResult(item_scores=tuple(port_rec.ItemScore(i, 1.0) for i in pred))
        assert pm.calculate_point(port_rec.Query("u"), pp, port_rec.ActualResult(actual)) == \
            jm.calculate_point(jax_rec.Query("u"), jp, jax_rec.ActualResult(actual))
    with pytest.raises(ValueError):
        port_rec_eval.PrecisionAtK(k=0)


def _engine_params(mod, ep_cls, rank, reg):
    return ep_cls(
        data_source_params=("", mod.DataSourceParams(app_name="default", eval_k=3)),
        algorithm_params_list=(("als", mod.ALSAlgorithmParams(rank=rank, lambda_=reg)),),
    )


def test_metric_evaluator_picks_and_writes_as_the_reference(tmp_path):
    """The same served results through both evaluators: the same scores,
    best variant, one-liner, result JSON and best-variant engine.json."""
    grid = [(8, 0.01), (8, 0.1), (16, 0.01), (16, 0.1)]
    results = {}
    for label, mod, ep_cls, ev in (
        ("jax", jax_rec, JaxEngineParams, jax_evaluation),
        ("port", port_rec, EngineParams, port_evaluation),
    ):
        data_rng = np.random.default_rng(3)
        data = []
        for rank, reg in grid:
            folds = []
            for fold in range(3):
                qpa = []
                for q in range(10):
                    pred = tuple(mod.ItemScore(f"i{j}", 1.0) for j in data_rng.choice(30, 10, replace=False))
                    actual = tuple(f"i{j}" for j in data_rng.choice(30, int(data_rng.integers(0, 5)), replace=False))
                    qpa.append((mod.Query(f"u{q}"), mod.PredictedResult(item_scores=pred),
                                mod.ActualResult(items=actual)))
                folds.append(({"fold": fold}, qpa))
            data.append((_engine_params(mod, ep_cls, rank, reg), folds))
        metric = (jax_rec_eval if label == "jax" else port_rec_eval).PrecisionAtK(k=10)
        path = tmp_path / f"{label}.json"
        evaluator = ev.MetricEvaluator(metric, [metric], output_path=str(path))
        results[label] = (evaluator.evaluate_base(None, None, data, None), json.loads(path.read_text()))
    (jr, jfile), (pr, pfile) = results["jax"], results["port"]
    assert pr.best_idx == jr.best_idx
    assert [ms.score for _, ms in pr.engine_params_scores] == \
        [ms.score for _, ms in jr.engine_params_scores]
    assert pr.to_one_liner() == jr.to_one_liner()
    assert json.loads(pr.to_json()) == json.loads(jr.to_json())
    assert pfile == jfile


# --- the k-fold data source ---


def test_read_eval_folds_equal_the_reference(store):
    storage, _ = store
    params = dict(app_name="default", eval_k=3, eval_query_num=7, seed=11)
    want = jax_rec.DataSource(jax_rec.DataSourceParams(**params)).read_eval(
        JaxContext(mode="evaluation", storage=storage))
    got = port_rec.DataSource(port_rec.DataSourceParams(**params)).read_eval(_ctx(store))
    assert len(got) == len(want) == 3
    for (ptd, pinfo, pqa), (jtd, jinfo, jqa) in zip(got, want):
        assert pinfo == jinfo
        for name in ("user_idx", "item_idx", "ratings"):
            np.testing.assert_array_equal(getattr(ptd, name), getattr(jtd, name))
        assert ptd.user_index.to_dict() == jtd.user_index.to_dict()
        assert ptd.item_index.to_dict() == jtd.item_index.to_dict()
        # the queries in the reference's order, each one's items in its order
        assert [(q.user, q.num, a.items) for q, a in pqa] == \
            [(q.user, q.num, a.items) for q, a in jqa]
    td = port_rec.DataSource(port_rec.DataSourceParams(**params)).read_training(_ctx(store))
    assert len(td.ratings) == store[1].n
    assert port_rec.DataSource(port_rec.DataSourceParams()).read_eval(_ctx(store)) == []


def test_a_context_without_the_apps_columns_raises(store):
    ds = port_rec.DataSource(port_rec.DataSourceParams(app_name="other", eval_k=2))
    with pytest.raises(KeyError, match="item 3"):
        ds.read_eval(_ctx(store))


# --- FastEval and the grid ---


def _spy(monkeypatch, fail=None):
    """Count train_grid and train calls, recording each grid's ranks;
    ``fail`` makes train_grid raise it."""
    calls = {"train_grid": [], "train": 0}
    real_grid = port_rec.ALSAlgorithm.train_grid.__func__
    real_train = port_rec.ALSAlgorithm.train

    def train_grid(cls, device, pd, algos):
        calls["train_grid"].append(tuple(a.params.rank for a in algos))
        if fail is not None:
            raise fail
        return real_grid(cls, device, pd, algos)

    def train(self, device, pd):
        calls["train"] += 1
        return real_train(self, device, pd)

    monkeypatch.setattr(port_rec.ALSAlgorithm, "train_grid", classmethod(train_grid))
    monkeypatch.setattr(port_rec.ALSAlgorithm, "train", train)
    return calls


def _run(store, **wp):
    return run_evaluation(
        port_rec_eval.RecommendationEvaluation(k=10),
        port_rec_eval.ParamsGrid().engine_params_list,
        ctx=_ctx(store), workflow_params=WorkflowParams(**wp),
    )


def test_fast_eval_always_trains_the_grid_two_variants_at_a_time(store, monkeypatch):
    calls = _spy(monkeypatch)
    result = _run(store, grid_train="always")
    # 2 rank groups x 3 folds; no per-variant training; ranks never mixed
    assert sorted(calls["train_grid"]) == [(8, 8)] * 3 + [(16, 16)] * 3
    assert calls["train"] == 0
    assert len(result.engine_params_scores) == 4


def test_fast_eval_auto_on_the_cpu_trains_each_variant(store, monkeypatch):
    calls = _spy(monkeypatch)
    result = _run(store)
    assert calls["train_grid"] == []
    assert calls["train"] == 4 * 3
    assert len(result.engine_params_scores) == 4


def test_a_failed_grid_falls_back_but_a_kernel_error_is_raised(store, monkeypatch, caplog):
    calls = _spy(monkeypatch, fail=RuntimeError("the batched systems do not fit"))
    result = _run(store, grid_train="always")
    assert calls["train"] == 4 * 3
    assert "falling back to per-variant training" in caplog.text
    assert len(result.engine_params_scores) == 4
    _spy(monkeypatch, fail=KernelError("normal_eq_variants kernel launch failed"))
    with pytest.raises(KernelError):
        _run(store, grid_train="always")


def test_run_evaluation_matches_the_reference(store):
    """Bench config 5 end to end: the port's run_evaluation (grid trained
    together) against the JAX package's CoreWorkflow.run_evaluation."""
    storage, _ = store
    want = JaxCoreWorkflow.run_evaluation(
        jax_rec_eval.RecommendationEvaluation(k=10),
        jax_rec_eval.ParamsGrid().engine_params_list,
        ctx=JaxContext(mode="evaluation", storage=storage),
    )
    got = _run(store, grid_train="always")
    assert got.best_idx == want.best_idx
    got_scores = [ms.score for _, ms in got.engine_params_scores]
    want_scores = [ms.score for _, ms in want.engine_params_scores]
    assert got_scores == pytest.approx(want_scores, abs=SCORE_ATOL)
    assert got.metric_header == want.metric_header == "Precision@10"
    assert got.best_engine_params.to_json() == json.loads(json.dumps(
        want.best_engine_params.to_json(), default=str))


def test_fast_eval_off_and_on_give_the_same_scores(store):
    on = _run(store, grid_train="never")
    off = _run(store, fast_eval=False, eval_parallelism=1)
    assert [ms.score for _, ms in on.engine_params_scores] == \
        [ms.score for _, ms in off.engine_params_scores]


def test_similar_product_eval_names_the_event_store():
    from predictionio_tpu_torch.models.similarproduct import engine as psp

    engine = psp.similarproduct_engine()
    ep = EngineParams(algorithm_params_list=(("als", psp.ALSAlgorithmParams()),))
    ctx = WorkflowContext("cpu", {})
    for call in (lambda: engine.eval(ctx, ep, WorkflowParams()),
                 lambda: engine.batch_eval(ctx, [ep, ep], WorkflowParams())):
        with pytest.raises(NotImplementedError, match="item 3"):
            call()


def test_workflow_params_check_grid_train():
    with pytest.raises(ValueError, match="grid_train"):
        WorkflowParams(grid_train="sometimes")
    assert dataclasses.asdict(WorkflowParams())["eval_parallelism"] == 4
