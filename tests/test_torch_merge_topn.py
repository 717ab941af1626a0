"""The mesh serving kernels' twins in the forms the mesh paths call, against
the JAX package, on the CPU:

- K9m (``ops/merge_topn.merge_topn``, on the CPU its twin) on the sharded
  retriever's ``[S, B, 2L]`` buffer as it lies, S in {2, 4, 8}, n below and
  equal to S·L, ties within and across shards, ``-inf`` slots and ids at
  and above 2^24, against ``predictionio_tpu/ops/retrieval.py``
  ``_merge_candidates`` on S of the conftest's virtual devices: bit for bit
  (both keep the lowest position of a tie); into a caller's ``out`` too.
- K3s's shard table (``ops/topn.TopnTable``; ``topn_packed`` and
  ``topn_chain`` with ``table=``): a table whose blocks are out of order,
  the first device's table of an interleaved mesh (``0,1,0,1``: shards 0
  and 2, with gaps between their blocks) and an uneven one with an empty
  shard. Each placed row is held against
  JAX's ``_topn_packed_impl`` (``_topn_packed_chain``) on the whole batch
  through ``check_topn_agreement`` (scores rtol 1e-5 / atol 1e-6, the
  summation orders differ; ids outside near-tie runs), and against the
  port's twin on the whole batch bit for bit; rows outside the blocks keep
  what the caller's ``out`` held.
- Launch counts: ``ServingFactors`` on a ``["cpu"] * S`` mesh (S in {3, 4,
  8}) makes one
  ``topn_packed_plain`` call a batch (one per distinct device) and
  ``measure_compute_ms`` one ``topn_chain_plain`` call a chain; its answers
  are the single device's bit for bit (one twin call over the whole
  padded batch either way).
- What a table refuses: more than 64 shards, a block outside the result or
  over another, an upload of the wrong size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from predictionio_tpu.ops import als as jals
from predictionio_tpu.ops import retrieval as jret
from predictionio_tpu.parallel import mesh as jmesh
from predictionio_tpu_torch.ops import merge_topn as k9m
from predictionio_tpu_torch.ops import topn as k3
from predictionio_tpu_torch.ops.als import ServingFactors, _unpack_indices
from predictionio_tpu_torch.ops.topn import TopnTable, check_topn_agreement
from predictionio_tpu_torch.parallel import mesh as pmesh

RTOL, ATOL = 1e-5, 1e-6


def shard_buffer(rng, S, B, L, id_base):
    """The retriever's [S, B, 2L] candidate buffer: each shard's list sorted
    descending (ties by ascending id), scores from a few values so ties fall
    within and across shards, some -inf slots at a list's end, ids from
    ``id_base`` up (shard s's ids above shard s-1's)."""
    cand = np.zeros((S, B, 2 * L), np.float32)
    per = 3 * L
    for s in range(S):
        for b in range(B):
            sc = rng.choice(np.float32([2.0, 0.5, 0.5, 0.5, -1.0]), L)
            dead = rng.integers(0, L + 1) if rng.random() < 0.4 else 0
            if dead:
                sc[L - dead:] = -np.inf
            ids = id_base + s * per + rng.choice(per, L, replace=False)
            order = np.lexsort((ids, -sc))
            cand[s, b, :L] = sc[order]
            cand[s, b, L:] = ids[order].astype(np.int32).view(np.float32)
    return cand


@pytest.mark.parametrize("id_base", [0, 2**24 - 5, 2**30], ids=["small", "2^24", "2^30"])
@pytest.mark.parametrize("L,n_of", [(4, "below"), (4, "all"), (7, "below"), (1, "all")])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_merge_on_the_retrievers_buffer_is_jax_bit_for_bit(S, L, n_of, id_base):
    rng = np.random.default_rng(S * 100 + L * 7 + id_base % 97)
    B = 6
    n = S * L if n_of == "all" else max(1, S * L // 2 - 1)
    cand = shard_buffer(rng, S, B, L, id_base)
    # JAX's merge takes the candidates as [B, S·2L], each shard's 2L in turn
    jm = jmesh.make_mesh({"data": S}, jax.devices()[:S])
    rep = NamedSharding(jm, P(None, None))
    packed = np.ascontiguousarray(cand.transpose(1, 0, 2).reshape(B, S * 2 * L))
    want = np.asarray(jret._merge_candidates(jax.device_put(packed, rep), n, L, rep))
    k9m.LAUNCHES.reset()
    got = k9m.merge_topn(torch.from_numpy(cand), n).numpy()
    assert k9m.LAUNCHES.snapshot() == {"merge_topn": 0, "merge_topn_plain": 1}
    assert got.shape == (B, 2 * n)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    out = torch.full((B, 2 * n), float("nan"))
    assert k9m.merge_topn(torch.from_numpy(cand), n, out=out) is out
    np.testing.assert_array_equal(out.numpy().view(np.uint32), want.view(np.uint32))


# (rows per shard, out0 per shard, the result's size): shards of 3 rows
TABLES = {
    "out of order": ([3, 3, 3, 3], [6, 0, 9, 3], 12),
    "interleaved first device": ([3, 3], [0, 6], 12),
    "uneven with an empty shard": ([5, 0, 2], [7, 0, 1], 12),
}


def placed_rows(table):
    """(upload row, result row) pairs of a table."""
    pairs, r0 = [], 0
    for r, o in zip(table.rows, table.out0):
        pairs += [(r0 + j, o + j) for j in range(r)]
        r0 += r
    return pairs


@pytest.mark.parametrize("name", list(TABLES))
@pytest.mark.parametrize("n_iters", [0, 3])
def test_shard_table_twin_places_k3s_rows_as_jax_on_the_whole_batch(name, n_iters):
    rows, out0, size = TABLES[name]
    rng = np.random.default_rng(len(name) * 10 + n_iters)
    k, N, n = 8, 300, 16
    Y = rng.standard_normal((N, k)).astype(np.float32)
    Y[7] = Y[11]  # an exact tie
    q = rng.standard_normal((sum(rows), k)).astype(np.float32)
    table = TopnTable("cpu", rows, out0, size)
    out = torch.full((size, 2 * n), float("nan"))
    qt, Yt = torch.from_numpy(q), torch.from_numpy(Y)
    k3.LAUNCHES.reset()
    if n_iters:
        got = k3.topn_chain(qt, Yt, n, n_iters, table=table, out=out)
        whole = k3.topn_chain_plain(qt, Yt, n, n_iters).numpy()
        ref = np.asarray(jals._topn_packed_chain(jnp.asarray(q), jnp.asarray(Y), n,
                                                 jnp.int32(n_iters)))
        counted = {"topn_chain_plain": 1}
    else:
        got = k3.topn_packed(qt, Yt, n, out=out, table=table)
        whole = k3.topn_packed_plain(qt, Yt, n).numpy()
        ref = np.asarray(jals._topn_packed(jnp.asarray(q), jnp.asarray(Y), n))
        counted = {"topn_packed_plain": 1}
    assert got is out
    assert {c: v for c, v in k3.LAUNCHES.snapshot().items() if v} == counted
    res = out.numpy()
    pairs = placed_rows(table)
    src, dst = [p[0] for p in pairs], [p[1] for p in pairs]
    np.testing.assert_array_equal(res[dst].view(np.uint32), whole[src].view(np.uint32))
    check_topn_agreement(res[dst, :n], _unpack_indices(res[dst], n), ref[src, :n],
                         _unpack_indices(ref[src], n), RTOL, ATOL)
    untouched = sorted(set(range(size)) - set(dst))
    assert np.isnan(res[untouched]).all()
    # without an out the result is new and the blocks hold the same rows
    fresh = k3.topn_packed(qt, Yt, n, table=table).numpy() if not n_iters else \
        k3.topn_chain(qt, Yt, n, n_iters, table=table).numpy()
    assert fresh.shape == (size, 2 * n)
    np.testing.assert_array_equal(fresh[dst].view(np.uint32), whole[src].view(np.uint32))


def test_tables_refuse_what_the_kernel_does_not_take():
    ok = TopnTable("cpu", [1] * k3.MAX_SHARDS, list(range(k3.MAX_SHARDS)), 64)
    assert ok.n_rows == 64 and ok.size == 64
    with pytest.raises(ValueError, match="1 to 64 shards"):
        TopnTable("cpu", [1] * 65, list(range(65)), 65)
    with pytest.raises(ValueError, match="1 to 64 shards"):
        TopnTable("cpu", [1, 1], [0], 2)
    with pytest.raises(ValueError, match="overlap no other"):
        TopnTable("cpu", [3, 3], [0, 2], 8)
    with pytest.raises(ValueError, match="inside"):
        TopnTable("cpu", [3, 3], [0, 6], 8)
    with pytest.raises(ValueError, match="inside"):
        TopnTable("cpu", [3, -1], [0, 4], 8)
    table = TopnTable("cpu", [2, 2], [2, 0], 4)
    Y = torch.zeros((10, 4))
    with pytest.raises(ValueError, match="table's upload"):
        k3.topn_packed(torch.zeros((3, 4)), Y, 2, table=table)
    with pytest.raises(ValueError, match="out must be"):
        k3.topn_packed(torch.zeros((4, 4)), Y, 2, table=table, out=torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="table's upload"):
        k3.topn_chain(torch.zeros((5, 4)), Y, 2, 2, table=table)


@pytest.mark.parametrize("S", [3, 4, 8])
def test_mesh_serving_is_one_launch_per_device_and_the_single_device_bit_for_bit(S):
    rng = np.random.default_rng(70 + S)
    uf = rng.standard_normal((50, 8)).astype(np.float32)
    itf = rng.standard_normal((90, 8)).astype(np.float32)
    mesh = pmesh.make_mesh({"data": S}, ["cpu"] * S)
    sharded, single = ServingFactors(uf, itf, mesh=mesh), ServingFactors(uf, itf, device="cpu")
    batches = [(uf[:5], 7), (uf[:13], 90), (uf[:1], 1), (uf[10:42], 16)]
    k3.LAUNCHES.reset()
    for rows, n in batches:
        got = sharded.topn_by_rows(rows, n)
        want = single.topn_by_rows(rows, n)
        np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))
        np.testing.assert_array_equal(got[1], want[1])
    counts = k3.LAUNCHES.snapshot()
    assert counts["topn_packed_plain"] == 2 * len(batches)  # one per batch, each structure
    # one table per padded batch size (8, 16, 8 and 32 rows), its rows per
    # shard the batch's padded to a multiple of S, cut in S
    assert sorted(sharded._tables) == sorted({-(-b // S) for b in (8, 16, 32)})
    for (idx, table, place), in sharded._tables.values():
        assert idx == list(range(S)) and place is None and table.size == S * table.rows[0]
    k3.LAUNCHES.reset()
    ms = sharded.measure_compute_ms(uf[:8], 5, iters=3, reps=2)
    assert np.isfinite(ms)
    # the build's chain, then two chains a sample: one call each
    assert k3.LAUNCHES.snapshot()["topn_chain_plain"] == 1 + 2 * 2
    assert k3.LAUNCHES.snapshot()["topn_packed_plain"] == 0
