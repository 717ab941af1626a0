"""The regularizer grid on a row-sharded mesh (``train_als_grid(mesh=)``,
K13s) and the templates trained on a workflow's mesh, in the port, on the
CPU (``["cpu"] * S``: every kernel by its plain twin).

- ``train_als_grid(mesh=)`` against JAX's mesh grid
  (``make_mesh({"data": S}, jax.devices()[:S])``, the conftest's 8 virtual
  CPU devices) at rtol 2e-4 / atol 2e-5, the reference's bar for its grid
  on a mesh (tests/test_als.py:420-460), on its data (the synthetic 60 x
  40 ratings with noise 0.1, rank 4, 3 sweeps, four regularizers); and
  against the port's single-device grid bit for bit (each shard sums and
  solves its rows as one device does).
- K13's shard form (K13a on a shard's pack, K13b with ``row0``/``out``)
  against one device's rows, bit for bit.
- ``Engine.train`` of the recommendation, Similar Product and standalone
  templates on ``WorkflowContext(device="cpu", mesh=Mesh(["cpu"] * 4))``:
  every model equals the single-device one bit for bit (DIMSUM stays on
  one device), and the ALS algorithms got the mesh.
- ``run_evaluation`` on that context with ``grid_train="always"``: every
  variant trained by ``train_grid`` on the mesh, none by ``train``, and
  the same Precision@10 as one device, exactly (equal models serve equal
  answers).
"""

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.parallel import make_mesh as jax_make_mesh
from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.controller.base import BaseDataSource
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.store import EventColumns
from predictionio_tpu_torch.models.experimental import standalone_recommendations as psr
from predictionio_tpu_torch.models.recommendation import engine as prec
from predictionio_tpu_torch.models.recommendation import evaluation as prec_eval
from predictionio_tpu_torch.models.similarproduct import engine as psp
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import grid as k13
from predictionio_tpu_torch.parallel import Mesh, make_mesh
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.core_workflow import run_evaluation
from predictionio_tpu_torch.workflow.workflow_params import WorkflowParams

RTOL, ATOL = 2e-4, 2e-5
N_USERS, N_ITEMS = 60, 40
REGS = [0.01, 0.05, 0.1, 1.0]
CPU = torch.device("cpu")


def synthetic(n_users=N_USERS, n_items=N_ITEMS, k=4, density=0.4, seed=1, noise=0.1):
    """The reference's ``tests/test_als.py`` ``synthetic`` ratings."""
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n_users, k)) / np.sqrt(k)
    V = rng.standard_normal((n_items, k)) / np.sqrt(k)
    mask = rng.random((n_users, n_items)) < density
    u, i = np.nonzero(mask)
    r = (U @ V.T + 3.0)[u, i] + noise * rng.standard_normal(len(u))
    return u.astype(np.int32), i.astype(np.int32), r.astype(np.float32)


@pytest.fixture(scope="module")
def ratings():
    return synthetic()


def cpu_mesh(S=4):
    return Mesh(["cpu"] * S, {"data": S})


def assert_bit_equal(a, b):
    for got, want in ((a.user_factors, b.user_factors), (a.item_factors, b.item_factors)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("implicit", [False, True])
def test_mesh_grid_matches_jax_and_one_device(ratings, S, implicit):
    u, i, r = ratings
    cfg = dict(rank=4, iterations=3, implicit_prefs=implicit, alpha=0.5)
    port = port_als.train_als_grid(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**cfg), REGS,
                                   mesh=make_mesh({"data": S}, ["cpu"] * S))
    ref = jax_als.train_als_grid(u, i, r, N_USERS, N_ITEMS, jax_als.ALSConfig(**cfg), REGS,
                                 mesh=jax_make_mesh({"data": S}, jax.devices()[:S]))
    one = port_als.train_als_grid(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**cfg), REGS,
                                  device="cpu")
    assert len(port) == len(ref) == len(REGS)
    for p, j, o in zip(port, ref, one):
        np.testing.assert_allclose(p.user_factors, j.user_factors, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(p.item_factors, j.item_factors, rtol=RTOL, atol=ATOL)
        assert_bit_equal(p, o)


@pytest.mark.parametrize("S", [3, 8])
@pytest.mark.parametrize("implicit", [False, True])
def test_k13_shard_form_equals_the_single_device_rows(ratings, S, implicit):
    u, i, r = ratings
    L, V, k = 8, 3, 4
    R_u, R_i = port_als._padded_rows(N_USERS, S), port_als._padded_rows(N_ITEMS, S)
    R1 = port_als._padded_rows(N_USERS, 1)
    user = port_als.upload_mesh_side(
        *port_als.mesh_pack_side(u, i, r, N_USERS, R_u, L, 64, S)[:2], [CPU] * S, R_u, R_i, R1)
    one = port_als.device_pack(port_als.pack_segments(u, i, r, N_USERS, L), R1, R_i, CPU)
    rng = np.random.default_rng(S)
    Y = torch.from_numpy(np.abs(rng.standard_normal((V, R_i, k))).astype(np.float32))
    X_prev = torch.from_numpy(rng.standard_normal((V, R_u, k)).astype(np.float32))
    lam = torch.from_numpy(rng.random((V, R_u)).astype(np.float32) + 0.1)
    obs = torch.from_numpy(rng.random(R_u) < 0.8)
    obs[N_USERS:] = False
    G = torch.stack([Y[v].T @ Y[v] for v in range(V)]) if implicit else None
    A1, b1 = k13.normal_eq_variants(Y, one, implicit, 0.5)
    X1 = k13.spd_solve_variants(A1, b1, lam[:, :R1].contiguous(), obs[:R1],
                                X_prev[:, :R1].contiguous(), G)
    X = torch.full_like(X_prev, float("nan"))
    for _, _, r0, r1, pack in user.shards():
        A, b = k13.normal_eq_variants(Y, pack, implicit, 0.5)
        n = max(0, min(r1, R1) - r0)
        assert torch.equal(A[:, :n], A1[:, r0 : r0 + n]) and torch.equal(b[:, :n], b1[:, r0 : r0 + n])
        assert k13.spd_solve_variants(A, b, lam, obs, X_prev, G, out=X, row0=r0) is X
    assert torch.equal(X[:, :R1], X1)
    assert torch.equal(X[:, R1:], X_prev[:, R1:])
    with pytest.raises(ValueError, match="need out="):
        k13.spd_solve_variants(A, b, lam, obs, X_prev, G, row0=r0)
    with pytest.raises(ValueError, match="overlap"):
        k13.spd_solve_variants(A, b, lam, obs, X_prev, G, out=X_prev, row0=r0)


# --- the templates on a workflow's mesh ---


def event_columns(n_users=120, n_items=80, n=2400, seed=21):
    rng = np.random.default_rng(seed)
    users = [f"u{n_}" for n_ in range(n_users)]
    items = [f"i{n_}" for n_ in range(n_items)]
    return EventColumns(
        BiMap({name: row for row, name in enumerate(users)}),
        BiMap({name: row for row, name in enumerate(items)}),
        rng.integers(0, n_users, n).astype(np.int32),
        (rng.zipf(1.3, n) % n_items).astype(np.int32),
        rng.integers(1, 11, n).astype(np.float32) / 2,
    )


@pytest.fixture(scope="module")
def columns():
    return event_columns()


def spy_mesh_routes(monkeypatch):
    """Counts of the mesh route's trainings and of grids on several shards."""
    calls = {"train": 0, "grid": 0}
    real_train, real_grid = port_als._train_als_mesh, port_als._run_iterations_grid_mesh

    def train(*a, **kw):
        calls["train"] += 1
        return real_train(*a, **kw)

    def grid(X, Y, user, *a, **kw):
        calls["grid"] += len(user.devices) > 1
        return real_grid(X, Y, user, *a, **kw)

    monkeypatch.setattr(port_als, "_train_als_mesh", train)
    monkeypatch.setattr(port_als, "_run_iterations_grid_mesh", grid)
    return calls


@pytest.mark.parametrize("implicit", [False, True])
def test_the_recommendation_template_trains_on_the_workflow_mesh(columns, monkeypatch, implicit):
    ep = EngineParams(
        data_source_params=("", prec.DataSourceParams(app_name="default")),
        algorithm_params_list=(("als", prec.ALSAlgorithmParams(
            rank=8, num_iterations=4, lambda_=0.05, implicit_prefs=implicit)),),
    )
    engine = prec.recommendation_engine()
    [one] = engine.train(WorkflowContext("cpu", {"default": columns}), ep, WorkflowParams())
    calls = spy_mesh_routes(monkeypatch)
    ctx = WorkflowContext(event_columns={"default": columns}, mesh=cpu_mesh())
    assert ctx.device == CPU  # the mesh's first device
    [got] = engine.train(ctx, ep, WorkflowParams())
    assert calls["train"] == 1
    assert_bit_equal(got.arrays, one.arrays)
    assert got._device == CPU


class _SPSource(BaseDataSource):
    """Users, items with categories, view events with repeats, likes and
    dislikes (the Similar Product template's training data)."""

    def read_training(self, ctx):
        rng = np.random.default_rng(9)
        items = {f"i{n}": psp.Item(categories=(f"c{n % 4}",)) for n in range(50)}
        views = [psp.ViewEvent(user=f"u{a}", item=f"i{b}", t=float(t))
                 for t, (a, b) in enumerate(zip(rng.integers(0, 80, 1500),
                                                rng.zipf(1.4, 1500) % 50))]
        likes = [psp.LikeEvent(user=f"u{a}", item=f"i{b}", t=float(t), like=bool(k))
                 for t, (a, b, k) in enumerate(zip(rng.integers(0, 80, 900),
                                                   rng.integers(0, 50, 900),
                                                   rng.random(900) < 0.7))]
        return psp.TrainingData(users={f"u{n}": {} for n in range(80)}, items=items,
                                view_events=views, like_events=likes)


def test_the_similar_product_template_trains_on_the_workflow_mesh(monkeypatch):
    engine = psp.similarproduct_engine()
    engine.data_source_class_map = {"": _SPSource}
    engine.preparator_class_map = {"": psp.Preparator}
    train = dict(rank=8, num_iterations=5, lambda_=0.01, alpha=1.0, seed=3)
    ep = EngineParams(algorithm_params_list=(
        ("als", psp.ALSAlgorithmParams(**train)),
        ("likealgo", psp.ALSAlgorithmParams(**train)),
        ("dimsum", psp.DIMSUMAlgorithmParams(threshold=0.1)),
    ))
    one = engine.train(WorkflowContext("cpu"), ep, WorkflowParams())
    calls = spy_mesh_routes(monkeypatch)
    got = engine.train(WorkflowContext("cpu", mesh=cpu_mesh()), ep, WorkflowParams())
    assert calls["train"] == 2  # the two ALS algorithms; DIMSUM on one device
    for g, o in zip(got[:2], one[:2]):
        assert np.array_equal(g.item_factors, o.item_factors)
    assert np.array_equal(got[2].similarities, one[2].similarities)


def test_the_standalone_template_trains_on_the_workflow_mesh(tmp_path, monkeypatch):
    rng = np.random.default_rng(8)
    path = tmp_path / "ratings.txt"
    path.write_text("".join(
        f"{a}::{b}::{c}\n" for a, b, c in zip(rng.integers(0, 50, 900), rng.integers(0, 30, 900),
                                              rng.integers(1, 6, 900))))
    engine = psr.standalone_recommendations_engine()
    ep = psr.standalone_engine_params(str(path), rank=6, num_iterations=5, lambda_=0.01)
    [one] = engine.train(WorkflowContext("cpu"), ep, WorkflowParams())
    calls = spy_mesh_routes(monkeypatch)
    [got] = engine.train(WorkflowContext("cpu", mesh=cpu_mesh()), ep, WorkflowParams())
    assert calls["train"] == 1
    assert np.array_equal(got.user_features, one.user_features)
    assert np.array_equal(got.product_features, one.product_features)


def test_run_evaluation_trains_the_grid_on_the_workflow_mesh(columns, monkeypatch):
    seen = []
    real_grid = prec.ALSAlgorithm.train_grid.__func__
    real_train = prec.ALSAlgorithm.train

    def train_grid(cls, device, pd, algos):
        seen.append(("grid", type(device).__name__))
        return real_grid(cls, device, pd, algos)

    def train(self, device, pd):
        seen.append(("train", type(device).__name__))
        return real_train(self, device, pd)

    monkeypatch.setattr(prec.ALSAlgorithm, "train_grid", classmethod(train_grid))
    monkeypatch.setattr(prec.ALSAlgorithm, "train", train)

    def evaluate(ctx):
        return run_evaluation(
            prec_eval.RecommendationEvaluation(k=10), prec_eval.ParamsGrid().engine_params_list,
            ctx=ctx, workflow_params=WorkflowParams(grid_train="always"),
        )

    one = evaluate(WorkflowContext("cpu", {"default": columns}))
    assert seen == [("grid", "device")] * 6
    seen.clear()
    calls = spy_mesh_routes(monkeypatch)
    got = evaluate(WorkflowContext("cpu", {"default": columns}, mesh=cpu_mesh()))
    # 2 ranks x 3 folds, each grid on the mesh; no variant trained alone
    assert seen == [("grid", "Mesh")] * 6 and calls["grid"] == 6
    assert [ms.score for _, ms in got.engine_params_scores] == \
        [ms.score for _, ms in one.engine_params_scores]
    assert got.best_idx == one.best_idx
