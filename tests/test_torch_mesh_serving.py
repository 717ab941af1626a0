"""Serving on a mesh: the port's row-sharded ``ItemRetriever`` (K9s, K10s
and the K9m merge) and both templates prepared on a ``["cpu"] * S`` mesh,
against the JAX package on S of the conftest's 8 virtual CPU devices, on
the CPU (the kernels' twins).

- ``ItemRetriever(mesh)`` against JAX's sharded retriever for float32, bf16
  and int8 x (positive_only, normalize), S in {4, 8}, on a catalog of 150
  items (not a multiple of S: the padding rows), with exclude and include
  lists that name ids of other shards, an empty include list, a global
  ``set_excluded_ids``, and n both below and above the rows per shard.
- The recommendation template (float32 through K3s, int8 through K10s) and
  Similar Product (K9s; its host path after ``release_serving`` through
  K14s) prepared by ``Engine.prepare_deploy`` on a 4-shard mesh and served
  through ``DeployedEngine.serve_batch``, against the JAX templates'
  ``prepare_serving`` on its 4-device mesh and ``batch_predict``.

Tolerance: the same live (finite) slots, dead slots with the same ids,
live scores rtol 1e-5 / atol 1e-6 with ids equal outside near-tie runs
(``check_topn_agreement``), as ``tests/test_torch_retrieval.py`` holds the
single-device retriever; the quantized tiers end in the reference's own
host refinement, so they are held the same way.
"""

import types

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models.recommendation import engine as jrec
from predictionio_tpu.models.similarproduct import engine as jsp
from predictionio_tpu.ops import retrieval as jret
from predictionio_tpu.ops.als import ALSModelArrays as JaxArrays
from predictionio_tpu.parallel import make_mesh as jax_make_mesh
from predictionio_tpu_torch.api.engine_server import DeployedEngine
from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.controller.params import EmptyParams
from predictionio_tpu_torch.models.recommendation import engine as prec_
from predictionio_tpu_torch.models.similarproduct import engine as psp
from predictionio_tpu_torch.ops import masked_topn as ka
from predictionio_tpu_torch.ops import merge_topn as k9m
from predictionio_tpu_torch.ops import rescore as kb
from predictionio_tpu_torch.ops import retrieval as pret
from predictionio_tpu_torch.ops import similarity as k14
from predictionio_tpu_torch.ops import topn as k3
from predictionio_tpu_torch.ops.topn import check_topn_agreement
from predictionio_tpu_torch.parallel import make_mesh

RTOL, ATOL = 1e-5, 1e-6
N_ITEMS, RANK = 150, 8
FLAGS = [(False, False), (True, False), (True, True)]


def catalog(n_items=N_ITEMS, rank=RANK, seed=41):
    """The bench's clustered generator: near-duplicates crowd the top-n
    boundary."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((24, rank)).astype(np.float32)
    return (base[rng.integers(0, 24, n_items)]
            + 0.3 * rng.standard_normal((n_items, rank))).astype(np.float32)


def meshes(S):
    return jax_make_mesh({"data": S}, jax.devices()[:S]), make_mesh({"data": S}, ["cpu"] * S)


def check_answer(ps, pi, js, ji):
    live = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ps), live)
    np.testing.assert_array_equal(np.where(live, 0, pi), np.where(live, 0, ji))
    for r in range(js.shape[0]):
        k = int(live[r].sum())
        if k:
            check_topn_agreement(ps[r:r + 1, :k], pi[r:r + 1, :k], js[r:r + 1, :k],
                                 ji[r:r + 1, :k], RTOL, ATOL)


def batch(rng, B=6):
    """Query rows and id lists: excludes anywhere in the catalog (other
    shards' ids and the padding sentinel's range), includes across shards,
    one empty include (no candidates), one of 3 items (fewer live than n),
    and rows without lists."""
    q = rng.standard_normal((B, RANK)).astype(np.float32)
    exclude = [rng.choice(N_ITEMS, size=w, replace=False) for w in (1, 9, 30, 0, 4, 2)]
    exclude[3] = None
    include = [None, np.sort(rng.choice(N_ITEMS, 70, replace=False)), np.zeros(0, np.int64),
               np.array([2, 77, 149]), None, np.arange(30, 120)]
    return q, exclude, include


@pytest.mark.parametrize("S", [4, 8])
@pytest.mark.parametrize("precision", ["float32", "bf16", "int8"])
def test_sharded_retriever_matches_jax(S, precision):
    jm, pm = meshes(S)
    Y = catalog()
    jr = jret.ItemRetriever(Y, mesh=jm, precision=precision, component=f"m{S}{precision}")
    pr = pret.ItemRetriever(Y, mesh=pm, precision=precision)
    assert pr.mesh is pm and pr._n_pad % S == 0 and len(pr._parts) == S
    assert pr.resident_bytes == jr.resident_bytes
    for r in (jr, pr):
        r.set_excluded_ids(np.array([0, 37, 38, 75, 149, 400]))
    rng = np.random.default_rng(S)
    for t in (ka.LAUNCHES, kb.LAUNCHES, k9m.LAUNCHES):
        t.reset()
    calls = 0
    for po, no in FLAGS:
        # n below and above the rows per shard (38 at S=4, 19 at S=8)
        for n in (7, 45):
            q, exclude, include = batch(rng)
            kw = dict(exclude=exclude, include=include, positive_only=po, normalize=no)
            js, ji = jr.topn(q, n, **kw)
            ps, pi = pr.topn(q, n, **kw)
            check_answer(ps, pi, np.asarray(js), np.asarray(ji))
            calls += 1
    counts = {**ka.LAUNCHES.snapshot(), **kb.LAUNCHES.snapshot(), **k9m.LAUNCHES.snapshot()}
    quant = precision != "float32"
    # one launch per shard per call: a single-device form would run once
    assert counts["candidate_mask_plain"] == S * calls
    assert counts["masked_topn_plain"] == S * calls
    assert counts["rescore_topn_plain"] == (S * calls if quant else 0)
    assert counts["merge_topn_plain"] == calls
    # the first batch was sampled: split and skew recorded as numbers
    assert set(pr.last_split_s) == {"shards", "merge"}
    assert len(pr.shard_candidates) == S and pr.shard_skew["candidates"] >= 1.0
    pr.free()
    assert pr.resident_bytes == 0
    with pytest.raises(RuntimeError, match="freed"):
        pr.topn(q, 3)


def rec_models(precision):
    rng = np.random.default_rng(9)
    n_users = 40
    uf = rng.standard_normal((n_users, RANK)).astype(np.float32)
    uf[5] = 0.0  # a user without ratings: every item ties at 0
    itf = catalog(seed=43)
    users, items = [f"u{r}" for r in range(n_users)], [f"i{r}" for r in range(N_ITEMS)]
    jmodel = jrec.ALSModel(
        arrays=JaxArrays(user_factors=uf, item_factors=itf),
        user_index=JaxBiMap({u: r for r, u in enumerate(users)}),
        item_index=JaxBiMap({i: r for r, i in enumerate(items)}),
    )
    params = prec_.ALSAlgorithmParams(rank=RANK, precision=precision, warm_max_batch=8)
    pmodel = prec_.als_model_from_numpy(uf, itf, users, items, params)
    jalg = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams(rank=RANK, precision=precision))
    return jalg, jmodel, params, pmodel


def deploy(engine, name, params, model, mesh):
    engine_params = EngineParams(data_source_params=("", EmptyParams()),
                                 algorithm_params_list=((name, params),))
    models = engine.prepare_deploy(mesh, engine_params, [model])
    return DeployedEngine(engine, engine_params, models), models[0]


def served(results, index):
    """(scores, ids) rows of one result's item scores."""
    return (np.array([[s.score for s in results.item_scores]]),
            np.array([[index[s.item] for s in results.item_scores]]))


@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_recommendation_on_a_mesh_matches_jax(precision):
    jm, pm = meshes(4)
    jalg, jmodel, params, pmodel = rec_models(precision)
    jmodel = jalg.prepare_serving(types.SimpleNamespace(mesh=jm), jmodel)
    deployed, model = deploy(prec_.recommendation_engine(), "als", params, pmodel, pm)
    if precision == "float32":
        assert model.serving.mesh is pm and model._retriever is None
    else:
        assert model._retriever.mesh is pm
    qs = [("u0", 10), ("u17", 1), ("nobody", 5), ("u39", 16), ("u5", 7), ("u3", 45), ("u8", 150)]
    for t in (k3.LAUNCHES, ka.LAUNCHES, kb.LAUNCHES, k9m.LAUNCHES):
        t.reset()
    got = deployed.serve_batch([prec_.Query(user=u, num=n) for u, n in qs])
    want = dict(jalg.batch_predict(jmodel, [(x, jrec.Query(user=u, num=n))
                                            for x, (u, n) in enumerate(qs)]))
    for x, (u, n) in enumerate(qs):
        assert len(got[x].item_scores) == len(want[x].item_scores)
        if u == "nobody":
            assert got[x].item_scores == ()
            continue
        ps, pi = served(got[x], pmodel.item_index)
        js, ji = served(want[x], pmodel.item_index)
        if u == "u5":
            assert pi[0].tolist() == list(range(n))
        check_topn_agreement(ps, pi, js, ji, RTOL, ATOL)
    if precision == "float32":
        # one K3 launch per distinct device over its shards' table: the
        # four shards of one device are one launch
        assert k3.LAUNCHES.snapshot()["topn_packed_plain"] == 1
        assert k9m.LAUNCHES.snapshot()["merge_topn_plain"] == 0
    else:
        assert k9m.LAUNCHES.snapshot()["merge_topn_plain"] == 1
        assert kb.LAUNCHES.snapshot()["rescore_topn_plain"] == 4
        assert k3.LAUNCHES.snapshot()["topn_packed_plain"] == 0
    assert deployed.release()
    assert model._serving is None and model._retriever is None and model._serving_mesh is None


def sp_models():
    rng = np.random.default_rng(12)
    factors = catalog(seed=47)
    ids = [f"i{r}" for r in range(N_ITEMS)]
    cats = [sorted({f"c{c}" for c in rng.integers(0, 6, rng.integers(1, 3))}) for _ in ids]
    jmodel = jsp.SPModel(
        item_factors=factors, item_index=JaxBiMap({i: r for r, i in enumerate(ids)}),
        items={r: jsp.Item(categories=tuple(c)) for r, c in enumerate(cats)},
    )
    params = psp.ALSAlgorithmParams(rank=RANK, warm_max_batch=8)
    return jmodel, params, psp.sp_model_from_numpy(factors, ids, cats, params)


def sp_queries(module):
    return [
        module.Query(items=("i0", "i3"), num=5),
        module.Query(items=("i1",), num=40, black_list=("i2", "i140", "i77")),
        module.Query(items=("i5", "i99"), num=6, categories=("c1",)),
        module.Query(items=("i4",), num=3, white_list=("i6", "i70", "i148")),
        module.Query(items=("zzz",), num=3),
        module.Query(items=("i8",), num=4, white_list=()),
    ]


def test_similar_product_on_a_mesh_matches_jax():
    jm, pm = meshes(4)
    jmodel, params, pmodel = sp_models()
    jalg = jsp.ALSAlgorithm(jsp.ALSAlgorithmParams(rank=RANK))
    jmodel = jalg.prepare_serving(types.SimpleNamespace(mesh=jm), jmodel)
    deployed, model = deploy(psp.similarproduct_engine(), "als", params, pmodel, pm)
    assert model._retriever.mesh is pm
    k9m.LAUNCHES.reset()
    got = deployed.serve_batch(sp_queries(psp))
    assert k9m.LAUNCHES.snapshot()["merge_topn_plain"] == 1
    want = dict(jalg.batch_predict(jmodel, list(enumerate(sp_queries(jsp)))))
    serving = jsp.Serving()

    def check(p_results, j_results):
        for x, q in enumerate(sp_queries(jsp)):
            j = serving.serve(q, [j_results[x]])
            assert len(p_results[x].item_scores) == len(j.item_scores), q
            if j.item_scores:
                check_topn_agreement(*served(p_results[x], pmodel.item_index),
                                     *served(j, pmodel.item_index), RTOL, ATOL)

    check(got, want)
    # the host path after release: K14s over the sharded scorer
    jalg.release_serving(jmodel)
    assert deployed.release() and model._retriever is None
    k14.LAUNCHES.reset()
    host = [model.similar(q) for q in sp_queries(psp)]
    assert model.scorer.mesh is pm and len(model.scorer._shards) == 4
    assert k14.LAUNCHES.snapshot()["cosine_sum_plain"] == 5  # 5 known queries x 1 device
    check(host, {x: jmodel.similar(q) for x, q in enumerate(sp_queries(jsp))})


@pytest.mark.parametrize("template", ["recommendation float32", "recommendation int8",
                                      "similarproduct"])
def test_a_straggler_after_release_serves_on_the_mesh_first_device(template):
    """A query that arrives after ``release_serving`` rebuilds its serving
    state on the mesh's first device (here the CPU), never on a CUDA
    device the deployment did not name; the answer is the single-device
    one."""
    _, pm = meshes(4)
    cpu = torch.device("cpu")
    if template.startswith("recommendation"):
        _, _, params, model = rec_models(template.split()[1])
        alg = prec_.ALSAlgorithm(params)
        alg.prepare_serving(pm, model)
        assert model._device == cpu
        alg.release_serving(model)
        got = [model.recommend(u, 10) for u in ("u0", "u17", "u39")]
        assert model._serving.mesh is None and model._serving.device == cpu
        ref = rec_models("float32")[3]
        ref.attach_device("cpu")
        assert got == [ref.recommend(u, 10) for u in ("u0", "u17", "u39")]
        return
    _, params, model = sp_models()
    alg = psp.ALSAlgorithm(params)
    alg.prepare_serving(pm, model)
    assert model._device == cpu
    alg.release_serving(model)
    got = [model.similar(q) for q in sp_queries(psp)]
    assert model._device == cpu and model.scorer.mesh is pm
    ref = sp_models()[2]
    ref.attach_device("cpu")
    for g, w in zip(got, [ref.similar(q) for q in sp_queries(psp)]):
        assert len(g.item_scores) == len(w.item_scores)
        if w.item_scores:
            check_topn_agreement(*served(g, model.item_index), *served(w, ref.item_index),
                                 RTOL, ATOL)
