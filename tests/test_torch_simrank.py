"""SimRank friend recommendation in the port
(``models/experimental/friend_recommendation.py`` with K20 in
``ops/simrank.py``) on the CPU, against the JAX package's module on the same
seeded inputs, and the SimRank model file served by ``tools.cli deploy``.

Tolerances:
- the scores of ``SimRankAlgorithm.train(device="cpu")`` (K20a and K20b by
  their plain twins) and of ``simrank_plain`` against JAX's
  ``SimRankAlgorithm.train``: rtol 1e-5 / atol 1e-6 (both are float32 dense
  products of the same P; XLA and PyTorch sum them in different orders);
  against the pairwise float64 SimRank of the reference's semantics, the
  same;
- P's CSR densified against the reference's dense P: bit for bit (the same
  float32 weights, duplicate edges added in the same order);
- the port's train against ``simrank_plain`` on the same P: bit for bit
  (the twins compute the same products in the same association);
- the sampling data sources' edges, the keyword and random predictions:
  equal (host code copied, the same ``default_rng`` calls).
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.models.experimental import friend_recommendation as jfr
from predictionio_tpu_torch.models.experimental import friend_recommendation as pfr
from predictionio_tpu_torch.ops import simrank as k20
from predictionio_tpu_torch.utils.serialize import load_model, save_model

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
DECAY, ITERS = 0.8, 5

# the reference suite's graph: 0 and 1 both point at {2, 3}; 4 points at 3
FIVE = [(0, 2), (0, 3), (1, 2), (1, 3), (4, 3), (2, 4), (3, 4)]


def seeded_edges(n=200, m=1_200, seed=5):
    """A power-law-ish edge list over 0..n-1 with duplicate edges,
    self-loops and vertices of no out-edge (the last tenth never a source);
    vertex n-1 is a target, so the file reads back n vertices."""
    rng = np.random.default_rng(seed)
    n_src = n - n // 10
    src = np.minimum((rng.pareto(1.2, m) * 3).astype(np.int64), n_src - 1)
    dst = rng.integers(0, n, m)
    edges = np.stack([src, dst], 1)
    loops = np.stack([np.arange(0, n_src, 17)] * 2, 1)
    edges = np.concatenate([edges, edges[:150], loops, [[0, n - 1]]])
    return edges[rng.permutation(len(edges))]


def write_edges(path, edges):
    path.write_text("# src dst\n" + "".join(f"{s} {d}\n" for s, d in edges))
    return str(path)


def reference_P(edges, n):
    """The reference's dense P, by its own lines (friend_recommendation.py
    :420-428)."""
    P = np.zeros((n, n), np.float32)
    edges = np.asarray(edges).reshape(-1, 2)
    if len(edges):
        out_deg = np.bincount(edges[:, 0], minlength=n).astype(np.float32)
        w = 1.0 / out_deg[edges[:, 0]]
        np.add.at(P, (edges[:, 0], edges[:, 1]), w)
    return P


def numpy_simrank(out_adj, n, iters, decay):
    """Pair-based SimRank with the reference's out-neighbour semantics, in
    float64 (the JAX suite's oracle, tests/test_experimental_examples.py)."""
    S = np.eye(n)
    for _ in range(iters):
        S2 = np.eye(n)
        for x in range(n):
            for y in range(n):
                if x == y:
                    continue
                ox, oy = out_adj[x], out_adj[y]
                if ox and oy:
                    s = sum(S[a, b] for a in ox for b in oy)
                    S2[x, y] = decay * s / (len(ox) * len(oy))
        S = S2
    return S


def both_trained(path, params=None):
    jtd = jfr.SimRankDataSource(
        jfr.SimRankDataSourceParams(graph_edgelist_path=path)).read_training(None)
    ptd = pfr.SimRankDataSource(
        pfr.SimRankDataSourceParams(graph_edgelist_path=path)).read_training(None)
    assert ptd.n_vertices == jtd.n_vertices
    np.testing.assert_array_equal(ptd.edges, jtd.edges)
    jm = jfr.SimRankAlgorithm(params and jfr.SimRankParams(**params)).train(None, jtd)
    pm = pfr.SimRankAlgorithm(params and pfr.SimRankParams(**params)).train(CPU, ptd)
    return jm, pm, ptd


@pytest.mark.parametrize("graph", ["five", "seeded", "one_vertex"])
def test_train_matches_jax_and_the_pairwise_reference(tmp_path, graph):
    edges = {"five": FIVE, "seeded": seeded_edges(), "one_vertex": [(0, 0)]}[graph]
    path = write_edges(tmp_path / "graph.txt", edges)
    before = k20.LAUNCHES.snapshot()
    jm, pm, td = both_trained(path)
    after = k20.LAUNCHES.snapshot()
    assert pm.scores.dtype == np.float32 and pm.scores.shape == jm.scores.shape
    np.testing.assert_allclose(pm.scores, jm.scores, rtol=RTOL, atol=ATOL)
    # the CPU route is the twins, once each an iteration
    for name in ("simrank_propagate_plain", "simrank_contract_plain"):
        assert after[name] - before[name] == ITERS
    for name in ("simrank_propagate", "simrank_contract"):
        assert after[name] == before[name]
    # the twins in the reference's association: the dense loop, bit for bit
    dense = k20.simrank_plain(torch.from_numpy(reference_P(td.edges, td.n_vertices)),
                              ITERS, DECAY).numpy()
    np.testing.assert_array_equal(pm.scores.view(np.uint32), dense.view(np.uint32))
    if graph != "seeded":
        out_adj = [[] for _ in range(td.n_vertices)]
        for s, d in td.edges:
            out_adj[s].append(int(d))
        expect = numpy_simrank(out_adj, td.n_vertices, ITERS, DECAY)
        np.testing.assert_allclose(pm.scores, expect, rtol=RTOL, atol=ATOL)
    if graph == "five":
        algo = pfr.SimRankAlgorithm()
        assert algo.predict(pm, pfr.SimRankQuery(item1=2, item2=3)) == pytest.approx(0.8, abs=1e-5)
        assert algo.predict(pm, pfr.SimRankQuery(item1=0, item2=1)) == pytest.approx(0.72, abs=1e-5)


def test_seeded_graph_against_float64_pairs_on_a_subgraph(tmp_path):
    """The seeded graph's first 40 vertices (its induced subgraph) against
    the pairwise float64 reference: duplicates, self-loops and vertices of
    no out-edge included."""
    e = seeded_edges()
    e = e[(e < 40).all(1)]
    e = np.concatenate([e, [[39, 39]]])
    path = write_edges(tmp_path / "sub.txt", e)
    jm, pm, td = both_trained(path, {"num_iterations": 4, "decay": 0.6})
    out_adj = [[] for _ in range(td.n_vertices)]
    for s, d in td.edges:
        out_adj[s].append(int(d))
    assert any(not o for o in out_adj) and any(len(set(o)) < len(o) for o in out_adj)
    expect = numpy_simrank(out_adj, td.n_vertices, 4, 0.6)
    np.testing.assert_allclose(pm.scores, expect, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pm.scores, jm.scores, rtol=RTOL, atol=ATOL)


def test_vertices_without_out_edges_score_zero_off_the_diagonal(tmp_path):
    edges = seeded_edges()
    _, pm, td = both_trained(write_edges(tmp_path / "g.txt", edges))
    sinks = np.setdiff1d(np.arange(td.n_vertices), td.edges[:, 0])
    assert len(sinks) >= 10
    S = pm.scores
    off = ~np.eye(td.n_vertices, dtype=bool)
    assert (S[sinks][off[sinks]] == 0).all() and (S[:, sinks][off[:, sinks]] == 0).all()
    assert (np.diag(S) == 1).all()


def test_the_empty_graph(tmp_path):
    path = tmp_path / "empty.txt"
    path.write_text("# no edges\n")
    jm, pm, td = both_trained(str(path))
    assert td.n_vertices == 0 and pm.scores.shape == (0, 0) == jm.scores.shape


@pytest.mark.parametrize("graph", ["five", "seeded", "empty"])
def test_csr_densifies_to_the_reference_P_bit_for_bit(graph):
    edges = {"five": np.asarray(FIVE), "seeded": seeded_edges(),
             "empty": np.zeros((0, 2), np.int64)}[graph]
    n = int(edges.max()) + 1 if len(edges) else 0
    indptr, cols, vals = k20.build_transition_csr(edges, n)
    assert indptr.dtype == cols.dtype == np.int32 and vals.dtype == np.float32
    assert indptr[0] == 0 and indptr[-1] == len(cols) == len(vals)
    for i in range(n):  # columns ascend within a row, each pair once
        row = cols[indptr[i]:indptr[i + 1]]
        assert (np.diff(row) > 0).all()
    P = k20.simrank_csr_to_dense(k20.place_csr(indptr, cols, vals, CPU)).numpy()
    np.testing.assert_array_equal(P.view(np.uint32), reference_P(edges, n).view(np.uint32))


def test_the_csr_rejects_endpoints_outside_the_vertices():
    with pytest.raises(ValueError, match="endpoints"):
        k20.build_transition_csr(np.array([[0, 3]]), 3)


def test_the_kernel_wrappers_check_their_operands():
    csr = k20.place_csr(*k20.build_transition_csr(np.asarray(FIVE), 5), CPU)
    with pytest.raises(ValueError, match="float32"):
        k20.simrank_propagate(torch.eye(4), csr)
    with pytest.raises(ValueError, match="float32"):
        k20.simrank_contract(torch.eye(5, dtype=torch.float64), csr, DECAY)
    S = k20.simrank(csr, 3, 0.5)
    np.testing.assert_array_equal(
        S.numpy(), k20.simrank_plain(k20.simrank_csr_to_dense(csr), 3, 0.5).numpy())


@pytest.mark.parametrize("source", ["node", "forest"])
@pytest.mark.parametrize("fraction", [0.3, 0.5, 1.0])
def test_sampling_data_sources_give_the_reference_edges(tmp_path, source, fraction):
    path = write_edges(tmp_path / "g.txt", seeded_edges())
    if source == "node":
        jds = jfr.NodeSamplingDataSource(jfr.NodeSamplingDSParams(
            graph_edgelist_path=path, sample_fraction=fraction, seed=4))
        pds = pfr.NodeSamplingDataSource(pfr.NodeSamplingDSParams(
            graph_edgelist_path=path, sample_fraction=fraction, seed=4))
    else:
        jds = jfr.ForestFireSamplingDataSource(jfr.ForestFireDSParams(
            graph_edgelist_path=path, sample_fraction=fraction, seed=4))
        pds = pfr.ForestFireSamplingDataSource(pfr.ForestFireDSParams(
            graph_edgelist_path=path, sample_fraction=fraction, seed=4))
    jtd, ptd = jds.read_training(None), pds.read_training(None)
    assert ptd.n_vertices == jtd.n_vertices
    np.testing.assert_array_equal(ptd.edges, jtd.edges)
    if fraction < 1.0:
        assert len(ptd.edges) < len(seeded_edges())
    jm = jfr.SimRankAlgorithm().train(None, jtd)
    pm = pfr.SimRankAlgorithm().train(CPU, ptd)
    np.testing.assert_allclose(pm.scores, jm.scores, rtol=RTOL, atol=ATOL)


@pytest.fixture()
def sns_files(tmp_path):
    """The KDD-2012 file formats (FriendRecommendationDataSource.scala), a
    seeded few hundred lines."""
    rng = np.random.default_rng(17)
    items = [f"{100 + j} 1 " + ";".join(str(t) for t in rng.choice(40, rng.integers(1, 6),
                                                                     replace=False))
             for j in range(30)]
    users = [f"{10 + u} " + ";".join(f"{t}:{rng.uniform(0.1, 2.0):.3f}"
                                      for t in rng.choice(40, rng.integers(1, 8), replace=False))
             for u in range(25)]
    actions = [f"{rng.integers(10, 40)} {rng.integers(10, 40)} {rng.integers(0, 3)} "
               f"{rng.integers(0, 3)} {rng.integers(0, 3)}" for _ in range(80)]
    for name, lines in (("items", items), ("users", users), ("actions", actions)):
        (tmp_path / f"{name}.txt").write_text("\n".join(lines) + "\n")
    return {
        "item_file_path": str(tmp_path / "items.txt"),
        "user_keyword_file_path": str(tmp_path / "users.txt"),
        "user_action_file_path": str(tmp_path / "actions.txt"),
    }


def test_keyword_and_random_predictions_equal_the_reference(sns_files):
    jtd = jfr.FriendRecommendationDataSource(
        jfr.DataSourceParams(**sns_files)).read_training(None)
    ptd = pfr.FriendRecommendationDataSource(
        pfr.DataSourceParams(**sns_files)).read_training(None)
    assert ptd.user_id_map == jtd.user_id_map and ptd.item_id_map == jtd.item_id_map
    assert ptd.user_keyword == jtd.user_keyword and ptd.social_action == jtd.social_action
    queries = [(u, i) for u in range(8, 38, 3) for i in range(98, 132, 4)]
    pairs = (
        (jfr.KeywordSimilarityAlgorithm(), pfr.KeywordSimilarityAlgorithm()),
        (jfr.RandomAlgorithm(jfr.RandomAlgoParams(seed=7)),
         pfr.RandomAlgorithm(pfr.RandomAlgoParams(seed=7))),
    )
    for ja, pa in pairs:
        jm, pm = ja.train(None, jtd), pa.train(CPU, ptd)
        for u, i in queries:
            jp = ja.predict(jm, jfr.Query(user=u, item=i))
            pp = pa.predict(pm, pfr.Query(user=u, item=i))
            assert (pp.confidence, pp.acceptance) == (jp.confidence, jp.acceptance)
    assert any(pfr.KeywordSimilarityAlgorithm().predict(
        pfr.KeywordSimilarityAlgorithm().train(CPU, ptd), pfr.Query(user=u, item=i)).acceptance
        for u, i in queries)


def test_the_engines_and_factories_build():
    for factory in (pfr.KeywordSimilarityEngineFactory, pfr.RandomEngineFactory,
                    pfr.PSimRankEngineFactory):
        engine = factory().apply()
        assert engine.algorithm_class_map
    assert set(pfr.simrank_engine().data_source_class_map) == {"default", "node", "forest"}


def test_a_jax_model_carried_across_and_the_cli_deploy_answer_as_predict(tmp_path):
    from test_torch_engine_server import _deploy_file_in_thread, _free_port, _request

    path = write_edges(tmp_path / "g.txt", seeded_edges(n=60, m=300))
    jm, pm, td = both_trained(path)
    carried = pfr.simrank_model_from_numpy(jm.scores)
    np.testing.assert_array_equal(carried.scores, jm.scores)
    with pytest.raises(ValueError, match=r"\[n, n\]"):
        pfr.simrank_model_from_numpy(np.zeros((2, 3)))
    model_path = tmp_path / "simrank.npz"
    save_model(model_path, pm)
    np.testing.assert_array_equal(load_model(model_path).scores, pm.scores)
    port = _free_port()
    thread, failures = _deploy_file_in_thread(model_path, port)
    try:
        algo = pfr.SimRankAlgorithm()
        rng = np.random.default_rng(2)
        for a, b in rng.integers(0, td.n_vertices, (24, 2)).tolist():
            status, raw = _request(port, "POST", "/queries.json",
                                   json.dumps({"item1": a, "item2": b}).encode())
            assert status == 200
            assert json.loads(raw) == algo.predict(pm, pfr.SimRankQuery(item1=a, item2=b))
        status = json.loads(_request(port, "GET", "/status.json")[1])
        assert status["algorithms"] == ["SimRankAlgorithm"]
        assert _request(port, "GET", "/stop") == (200, b"Shutting down...")
        thread.join(timeout=30)
        assert not thread.is_alive() and not failures
    finally:
        if thread.is_alive():
            urllib.request.urlopen(f"http://127.0.0.1:{port}/stop", timeout=10)
