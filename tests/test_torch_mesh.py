"""The port's device meshes (``parallel/mesh.py``) and the sharded serving
programs' pieces against the JAX package, on the CPU: the port's
``["cpu"] * S`` mesh against JAX's mesh over S of the conftest's 8 virtual
CPU devices (S in {4, 8}).

- ``Mesh``/``make_mesh``/``default_mesh``/``pad_to_multiple``/``shard_batch``
  against ``predictionio_tpu/parallel/mesh.py``: the same shapes, the same
  padded rows per shard, the same size-mismatch error; a mesh of one shard
  collapses to one device and keeps it.
- K9m's twin ``merge_topn_plain`` on the retriever's ``[S, B, 2L]``
  buffer against ``_merge_candidates``: equal scores, ties across shards
  and ``-inf`` slots, ``n_local < n``; ids equal everywhere (both keep the
  lowest position of a tie); the same into a caller's ``out``
  (``tests/test_torch_merge_topn.py`` has the wider cases).
- The row-shard forms of kernels A and B (``id_offset``): offset 0 over a
  whole catalog is the single-device twin bit for bit (a copy of the twins
  as they were before the forms existed); offset ``off`` is that twin on
  the localized id lists with ``off`` added to the ids.
- K3s (``ServingFactors(mesh)``) against JAX's ``ServingFactors(mesh)``
  (ids equal, scores rtol 1e-5 / atol 1e-6: JAX's tolerance against its
  single device in ``tests/test_mesh_kernels.py``, with the port's atol for
  scores near 0, as ``tests/test_torch_retrieval.py`` uses) and against the
  port's single device bit for bit (the shards of one device are one twin
  call over the whole padded batch, as one device's is; on the card K3 is
  position-independent and chip_smoke.py holds K3s bit for bit);
  K14s (``SimilarityScorer(mesh)``) against JAX's at rtol 1e-5 and the
  port's single device at rtol 1e-6, for the same reason; K14's shard
  tables (``CosineTable``: the scorer on ``["cpu"] * S``, uneven and empty
  cuts, offsets into a longer result) bit for bit the single-device twin,
  since the twin runs once over the table's rows in order, and tables past
  64 shards refused.
- ``_mesh_from_device_spec`` and the CLI's serving target.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from predictionio_tpu.ops import als as jals
from predictionio_tpu.ops import retrieval as jret
from predictionio_tpu.ops import similarity as jsim
from predictionio_tpu.parallel import mesh as jmesh
from predictionio_tpu_torch.api.engine_server import ServerConfig, _mesh_from_device_spec
from predictionio_tpu_torch.ops import masked_topn as ka
from predictionio_tpu_torch.ops import merge_topn as k9m
from predictionio_tpu_torch.ops import rescore as kb
from predictionio_tpu_torch.ops.als import ServingFactors
from predictionio_tpu_torch.ops.retrieval import ItemRetriever, quantize_rows_int8
from predictionio_tpu_torch.ops import similarity as k14
from predictionio_tpu_torch.ops.similarity import SimilarityScorer
from predictionio_tpu_torch.ops.topn import pack_topn
from predictionio_tpu_torch.parallel import mesh as pmesh
from predictionio_tpu_torch.tools.cli import serving_target
from predictionio_tpu_torch.workflow.context import WorkflowContext

SHARDS = [4, 8]


@pytest.fixture(scope="module")
def meshes():
    devs = jax.devices()
    return {S: (jmesh.make_mesh({"data": S}, devs[:S]), pmesh.make_mesh({"data": S}, ["cpu"] * S))
            for S in SHARDS}


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("n,batch_dim", [(5, 0), (8, 0), (13, 0), (11, 1)])
def test_mesh_and_shard_batch_match_jax(meshes, S, n, batch_dim):
    jm, pm = meshes[S]
    assert dict(jm.shape) == pm.shape and pm.size == jm.devices.size == S
    assert pm.axis_names == tuple(jm.axis_names)
    arr = np.random.default_rng(n).standard_normal((n, 3) if batch_dim == 0 else (2, n, 3))
    arr = arr.astype(np.float32)
    j_arr, j_n = jmesh.shard_batch(jm, arr, batch_dim=batch_dim)
    p_parts, p_n = pmesh.shard_batch(pm, arr, batch_dim=batch_dim)
    assert p_n == j_n == n
    assert len(p_parts) == S and all(t.device.type == "cpu" for t in p_parts)
    got = torch.cat(p_parts, dim=batch_dim).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_arr))
    assert {tuple(t.shape) for t in p_parts} == {s.data.shape for s in j_arr.addressable_shards}
    for m in (1, S, 7):
        assert pmesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)


def test_mesh_errors_and_defaults_match_jax(meshes):
    devs = jax.devices()
    with pytest.raises(ValueError, match="require 4 devices, have 3") as j_err:
        jmesh.make_mesh({"data": 4}, devs[:3])
    with pytest.raises(ValueError, match="require 4 devices, have 3") as p_err:
        pmesh.make_mesh({"data": 4}, ["cpu"] * 3)
    assert str(p_err.value) == str(j_err.value)
    two = pmesh.make_mesh({"data": 2, "model": 2}, ["cpu"] * 4)
    assert two.shape == dict(jmesh.make_mesh({"data": 2, "model": 2}, devs[:4]).shape)
    assert len(two.shard_devices("data")) == 2 and len(two.shard_devices("model")) == 2
    d = pmesh.default_mesh(devices=["cpu"] * 3)
    assert d.shape == dict(jmesh.default_mesh(devices=devs[:3]).shape) == {"data": 3}
    assert d.distinct_devices() == [torch.device("cpu")]
    ctx = WorkflowContext("cpu")
    assert ctx.mesh.shape == {"data": 1} and ctx.mesh.devices == (torch.device("cpu"),)
    assert WorkflowContext("cpu", mesh=two).mesh is two


def test_one_shard_mesh_collapses_and_keeps_its_device():
    one = pmesh.make_mesh({"data": 1}, ["cpu"])
    Y = np.eye(6, 4, dtype=np.float32)
    r = ItemRetriever(Y, mesh=one)
    assert r.mesh is None and r._device == torch.device("cpu")
    sf = ServingFactors(Y, Y, mesh=one)
    assert sf.mesh is None and sf.device == torch.device("cpu")
    sc = SimilarityScorer(Y, mesh=one)
    assert sc.mesh is None and sc.device == torch.device("cpu")
    s, i = r.topn(np.ones((1, 4), np.float32), 3)
    ref_s, ref_i = jret.naive_topn_reference(Y, np.ones((1, 4), np.float32), 3)
    np.testing.assert_array_equal(i, ref_i)
    with pytest.raises(TypeError, match="Mesh"):
        ServingFactors(Y, Y, mesh=object())


@pytest.mark.parametrize("build", [
    lambda Y, m: ServingFactors(Y, Y, mesh=m),
    lambda Y, m: ItemRetriever(Y, mesh=m),
    lambda Y, m: SimilarityScorer(Y, mesh=m),
], ids=["ServingFactors", "ItemRetriever", "SimilarityScorer"])
def test_serving_takes_a_one_axis_data_mesh_only(build):
    """Serving shards over the ``data`` axis of a 1-D mesh; a mesh with
    other axes is refused rather than served over some of its devices."""
    Y = np.eye(6, 4, dtype=np.float32)
    for axes in ({"data": 2, "model": 2}, {"model": 4}):
        with pytest.raises(ValueError, match="1-D 'data' mesh"):
            build(Y, pmesh.make_mesh(axes, ["cpu"] * 4))


def sorted_shard_lists(rng, B, S, L, ids_per_shard):
    """Packed [B, S, 2, L] candidates: each shard's list sorted descending
    (ties by ascending id), scores drawn from a few values so ties cross
    shards, some -inf slots at each list's end."""
    cand = np.zeros((B, S, 2, L), np.float32)
    for b in range(B):
        for s in range(S):
            sc = rng.choice(np.float32([3.0, 1.5, 1.5, 0.25, -2.0]), L)
            dead = rng.integers(0, L + 1) if rng.random() < 0.4 else 0
            if dead:
                sc[L - dead:] = -np.inf
            ids = s * ids_per_shard + rng.choice(ids_per_shard, L, replace=False)
            order = np.lexsort((ids, -sc))
            cand[b, s, 0] = sc[order]
            cand[b, s, 1] = ids[order].astype(np.int32).view(np.float32)
    return cand


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("L,n", [(4, 4), (3, 10), (6, 16), (1, 1)])
def test_merge_twin_matches_jax(meshes, S, L, n):
    jm, _ = meshes[S]
    rng = np.random.default_rng(L * 31 + n)
    B = 5
    cand = sorted_shard_lists(rng, B, S, L, 50)
    rep = NamedSharding(jm, P(None, None))
    want = np.asarray(jret._merge_candidates(jax.device_put(cand.reshape(B, -1), rep), n, L, rep))
    # the retriever's layout: the [S, B, 2L] buffer as it lies
    buf = torch.from_numpy(np.ascontiguousarray(cand.transpose(1, 0, 2, 3).reshape(S, B, 2 * L)))
    k9m.LAUNCHES.reset()
    got = k9m.merge_topn(buf, n).numpy()
    assert k9m.LAUNCHES.snapshot()["merge_topn_plain"] == 1
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # into a caller's result
    out = torch.full((B, 2 * n), float("nan"))
    assert k9m.merge_topn(buf, n, out=out) is out
    np.testing.assert_array_equal(out.numpy().view(np.uint32), want.view(np.uint32))


def test_merge_refuses_what_the_kernel_refuses():
    cand = torch.zeros((3, 2, 8))  # S = 3, B = 2, L = 4
    with pytest.raises(ValueError, match="n="):
        k9m.merge_topn(cand, 13)
    with pytest.raises(ValueError, match="contiguous"):
        k9m.merge_topn(torch.zeros((2, 3, 8)).transpose(0, 1), 2)
    with pytest.raises(ValueError, match=r"\[S, B, 2L\]"):
        k9m.merge_topn(torch.zeros((2, 3, 2, 4)), 2)
    with pytest.raises(ValueError, match=r"\[S, B, 2L\]"):
        k9m.merge_topn(torch.zeros((2, 3, 7)), 2)
    with pytest.raises(TypeError, match="float32"):
        k9m.merge_topn(cand.double(), 2)
    with pytest.raises(ValueError, match="out must be"):
        k9m.merge_topn(cand, 2, out=torch.zeros((2, 5)))


# --- the twins as they were before the row-shard forms (the guard that
# offset 0 is the single-device kernel) ---

def mask_before(allow0, excl, incl, has_incl):
    B, N = excl.shape[0], allow0.shape[0]
    rows = torch.arange(B)[:, None]

    def scatter(ids):
        hit = torch.zeros((B, N + 1), dtype=torch.bool)
        ids = ids.to(torch.int64)
        ids = torch.where((ids >= 0) & (ids < N), ids, N)
        hit[rows.expand_as(ids), ids] = True
        return hit[:, :N]

    allow = allow0.to(torch.bool)[None, :] & ~scatter(excl)
    allow = allow & (scatter(incl) | ~has_incl.to(torch.bool)[:, None])
    return ka.pack_bits(allow)


def topn_before(q, Y, scale, rn, bits, m, positive_only, normalize):
    scores = ka.approx_scores_plain(q, Y, scale)
    if normalize:
        scores = scores * rn[None, :]
    allow = ka.unpack_bits(bits, Y.shape[0])
    if positive_only:
        allow = allow & (scores > 0)
    scores = torch.where(allow, scores, torch.full_like(scores, float("-inf")))
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return pack_topn(s[:, :m], i[:, :m])


def rescore_before(q, Y, scale, rn, stage1, n_out, positive_only, normalize):
    s1, i1 = kb.split_packed(stage1)
    idx = i1.to(torch.int64)
    rows = Y[idx].to(torch.float32)
    if scale is not None:
        rows = rows * scale[idx][:, :, None]
    rescored = torch.einsum("bk,bck->bc", q, rows)
    if normalize:
        rescored = rescored * rn[idx]
    ninf = torch.full_like(rescored, float("-inf"))
    if positive_only:
        rescored = torch.where(rescored > 0, rescored, ninf)
    rescored = torch.where(s1 == float("-inf"), ninf, rescored)
    s, j = torch.sort(rescored, dim=1, descending=True, stable=True)
    return pack_topn(s[:, :n_out], torch.gather(i1, 1, j[:, :n_out]))


def bits_of(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("precision", ["float32", "bf16", "int8"])
def test_offset_forms_are_the_twins_on_localized_ids(precision):
    rng = np.random.default_rng(3)
    N, k, B, S = 90, 6, 5, 3
    Y = rng.standard_normal((N, k)).astype(np.float32)
    if precision == "int8":
        yq, sc = quantize_rows_int8(Y)
        Yt, scale = torch.from_numpy(yq), torch.from_numpy(sc)
    else:
        Yt = torch.from_numpy(Y).to(torch.bfloat16) if precision == "bf16" else torch.from_numpy(Y)
        scale = None
    q = torch.from_numpy(rng.standard_normal((B, k)).astype(np.float32))
    rn = torch.from_numpy(rng.uniform(0.5, 2.0, N).astype(np.float32))
    allow0 = torch.from_numpy(rng.random(N) < 0.9)
    excl = torch.from_numpy(rng.integers(-3, N + 3, (B, 9)).astype(np.int32))
    incl = torch.from_numpy(rng.integers(0, N + 1, (B, 12)).astype(np.int32))
    has = torch.tensor([False, True, False, True, True])
    for po, no in [(False, False), (True, False), (True, True)]:
        # offset 0 over the whole catalog: the single-device twins
        bits = ka.candidate_mask(allow0, excl, incl, has, id_offset=0)
        np.testing.assert_array_equal(bits_of(bits), bits_of(mask_before(allow0, excl, incl, has)))
        a = ka.masked_topn_packed(q, Yt, scale, rn, bits, 20, po, no, id_offset=0)
        np.testing.assert_array_equal(bits_of(a), bits_of(topn_before(q, Yt, scale, rn, bits, 20, po, no)))
        if precision != "float32":
            b = kb.rescore_topn(q, Yt, scale, rn, a, 7, po, no, id_offset=0)
            np.testing.assert_array_equal(
                bits_of(b), bits_of(rescore_before(q, Yt, scale, rn, a, 7, po, no)))
        # shard s of S: its rows, the global lists, ids + off
        rows = N // S
        for s in range(S):
            off, sl = s * rows, slice(s * rows, (s + 1) * rows)
            loc = lambda g: torch.where((g >= off) & (g < off + rows), g - off, rows).to(torch.int32)
            Ys, ss = Yt[sl].contiguous(), scale[sl].contiguous() if scale is not None else None
            bits_s = ka.candidate_mask(allow0[sl].contiguous(), excl, incl, has, id_offset=off)
            want_bits = mask_before(allow0[sl], loc(excl), loc(incl), has)
            np.testing.assert_array_equal(bits_of(bits_s), bits_of(want_bits))
            m = min(8, rows)
            got = ka.masked_topn_packed(q, Ys, ss, rn[sl].contiguous(), bits_s, m, po, no,
                                        id_offset=off).numpy()
            want = topn_before(q, Ys, ss, rn[sl], bits_s, m, po, no).numpy()
            np.testing.assert_array_equal(got[:, :m].view(np.uint32), want[:, :m].view(np.uint32))
            np.testing.assert_array_equal(got[:, m:].view(np.int32), want[:, m:].view(np.int32) + off)
            if precision != "float32":
                s1 = ka.masked_topn_packed(q, Ys, ss, rn[sl].contiguous(), bits_s, m, po, no,
                                           id_offset=0)
                out = torch.empty((B, 8))
                got_b = kb.rescore_topn(q, Ys, ss, rn[sl].contiguous(), s1, 4, po, no,
                                        id_offset=off, out=out)
                assert got_b is out
                want_b = rescore_before(q, Ys, ss, rn[sl], s1, 4, po, no).numpy()
                np.testing.assert_array_equal(out.numpy()[:, :4].view(np.uint32),
                                              want_b[:, :4].view(np.uint32))
                np.testing.assert_array_equal(out.numpy()[:, 4:].view(np.int32),
                                              want_b[:, 4:].view(np.int32) + off)
    with pytest.raises(ValueError, match="id_offset"):
        ka.candidate_mask(allow0, excl, incl, has, id_offset=-1)
    with pytest.raises(ValueError, match="out must be"):
        ka.masked_topn_packed(q, Yt, scale, rn, bits, 4, out=torch.empty((B, 9)))


@pytest.mark.parametrize("S", SHARDS)
def test_serving_factors_on_a_mesh_match_jax_and_the_single_device(meshes, S):
    jm, pm = meshes[S]
    rng = np.random.default_rng(6 + S)
    uf = rng.standard_normal((67, 8)).astype(np.float32)
    itf = rng.standard_normal((45, 8)).astype(np.float32)
    j_sharded = jals.ServingFactors(uf, itf, mesh=jm)
    sharded = ServingFactors(uf, itf, mesh=pm)
    single = ServingFactors(uf, itf, device="cpu")
    assert sharded.mesh is pm and len(sharded._if_on) == 1  # one upload per device
    for rows, n in [(uf[:5], 7), (uf[:13], 45), (uf[:1], 1)]:
        s1, i1 = sharded.topn_by_rows(rows, n)
        sj, ij = j_sharded.topn_by_rows(rows, n)
        s0, i0 = single.topn_by_rows(rows, n)
        np.testing.assert_array_equal(i1, ij)
        np.testing.assert_allclose(s1, sj, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_array_equal(s1.view(np.uint32), s0.view(np.uint32))
    users = [0, 7, 29, 66]
    s1, i1 = sharded.topn_by_user(users, 5)
    sj, ij = j_sharded.topn_by_user(users, 5)
    np.testing.assert_array_equal(i1, ij)
    np.testing.assert_allclose(s1, sj, rtol=1e-5, atol=1e-6)
    # every shard's block gathered into one result on the first device
    packed = sharded.topn_packed_device(uf[:3], 5)
    assert packed.shape == (8, 10) and packed.device == pm.devices[0]
    assert np.isfinite(sharded.measure_compute_ms(uf[:8], 5, iters=3, reps=1))


@pytest.mark.parametrize("S", SHARDS)
def test_similarity_scorer_on_a_mesh_matches_jax(meshes, S):
    jm, pm = meshes[S]
    rng = np.random.default_rng(5 + S)
    factors = rng.standard_normal((37, 6)).astype(np.float32)
    factors[3] = 0.0
    j_sc = jsim.SimilarityScorer(factors, mesh=jm)
    p_sc = SimilarityScorer(factors, mesh=pm)
    single = SimilarityScorer(factors, device="cpu")
    assert len(p_sc._shards) == S
    for q_rows in (1, 3, 9):
        q = p_sc.normed[rng.integers(0, 37, q_rows)]
        got = p_sc.cosine_sum(q)
        assert got.shape == (37,)
        np.testing.assert_allclose(got, j_sc.cosine_sum(q), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, single.cosine_sum(q), rtol=1e-6, atol=1e-7)
    p_sc.warm(max_q=8)


@pytest.mark.parametrize("S", [3, 4])
@pytest.mark.parametrize("Q", [4, 8, 16])
def test_k14_shard_tables_are_the_single_device_twin_bit_for_bit(S, Q):
    """K14s's shard table on ``["cpu"] * S``: the scorer runs one twin call
    a query (one table: every shard on one device) and its sums are the
    single-device scorer's bit for bit; tables over uneven and empty cuts
    of the catalog, each shard in its block of a longer result, are the
    single-device twin bit for bit and leave the other entries alone."""
    rng = np.random.default_rng(40 + 3 * S + Q)
    factors = rng.standard_normal((53, 6)).astype(np.float32)
    factors[7] = 0.0
    single = SimilarityScorer(factors, device="cpu")
    sc = SimilarityScorer(factors, mesh=pmesh.make_mesh({"data": S}, ["cpu"] * S))
    idx = rng.integers(0, 53, Q)
    k14.LAUNCHES.reset()
    got = sc.cosine_sum(sc.normed[idx])
    assert k14.LAUNCHES.snapshot() == {"cosine_sum": 0, "cosine_sum_plain": 1}
    assert got.shape == (53,) and np.array_equal(got.view(np.uint32),
                                                 single.cosine_sum(single.normed[idx]).view(np.uint32))
    Y = torch.from_numpy(single.normed.astype(np.float32))
    q = Y[idx]
    want = k14.cosine_sum_plain(q, Y)
    cuts = {3: ([0, 0, 30, 53], [0, 17, 17, 53], [0, 53, 53, 53]),
            4: ([0, 5, 5, 41, 53], [0, 0, 0, 0, 53], [0, 1, 2, 52, 53])}[S]
    for cut in cuts:
        table = k14.CosineTable([Y[a:b] for a, b in zip(cut[:-1], cut[1:])],
                                [2 + a for a in cut[:-1]], 57)
        out = torch.full((57,), float("nan"))
        k14.cosine_sum_table(q, table, out=out)
        assert torch.equal(out[2:55].view(torch.int32), want.view(torch.int32)), cut
        assert torch.isnan(out[:2]).all() and torch.isnan(out[55:]).all()


def test_k14_tables_refuse_what_the_kernel_does_not_take():
    Y = torch.zeros((70, 4))
    ok = k14.CosineTable([Y[i:i + 1] for i in range(k14.MAX_SHARDS)],
                         list(range(k14.MAX_SHARDS)), 70)
    assert len(ok.ys) == 64 and ok.rows == 64
    with pytest.raises(ValueError, match="1 to 64 shards"):
        k14.CosineTable([Y[i:i + 1] for i in range(k14.MAX_SHARDS + 1)], list(range(65)), 70)
    with pytest.raises(ValueError, match="leaves the result"):
        k14.CosineTable([Y[:10]], [65], 70)
    with pytest.raises(ValueError, match="float32"):
        k14.CosineTable([Y[:10], torch.zeros((3, 5))], [0, 10], 70)
    table = k14.CosineTable([Y[:10], Y[10:20]], [0, 10], 20)
    with pytest.raises(ValueError, match="Q >= 1"):
        k14.cosine_sum_table(torch.zeros((2, 5)), table)
    with pytest.raises(ValueError, match="out must be"):
        k14.cosine_sum_table(torch.zeros((2, 4)), table, out=torch.zeros(19))


def test_device_spec_and_serving_target(monkeypatch):
    # no CUDA here: every index is refused, and the default target raises
    for spec in ("0", "0,1", ""):
        with pytest.raises(ValueError, match="invalid device indices"):
            _mesh_from_device_spec(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_target(ServerConfig())
    assert serving_target(ServerConfig(), device="cpu") == torch.device("cpu")
    own = pmesh.make_mesh({"data": 2}, ["cpu", "cpu"])
    assert serving_target(ServerConfig(serving_devices="0"), mesh=own) is own
    # two visible cards: indices in range (repeats allowed) make a mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = _mesh_from_device_spec("0,1,1")
    assert mesh.shape == {"data": 3}
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1), torch.device("cuda", 1))
    assert mesh.distinct_devices() == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert serving_target(ServerConfig(serving_devices="1,0")).devices[0] == torch.device("cuda", 1)
    for bad in ("2", "-1", "0,2"):
        with pytest.raises(ValueError, match="have 2 CUDA devices"):
            _mesh_from_device_spec(bad)
