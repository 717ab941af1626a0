"""K3 parity: the port's top-N (``predictionio_tpu_torch.ops.topn``; on the
CPU its plain twin) against the JAX package's ``_topn_packed``,
``recommend_batch`` and ``naive_topn_reference`` on the same seeded numpy
inputs.

Tolerance: scores rtol 1e-5, atol 1e-6, because XLA and PyTorch sum the
rank in different orders. Ids are equal except inside runs of near-tied
scores, where the sets agree (``check_topn_agreement``). With exact ties
(integer-valued factors, whose dot products are exact in any order) ids
must be equal, lowest index first.

K3c (``topn_chain``, on the CPU its twin) against the JAX package's
``_topn_packed_chain`` at the same tolerances; each pass's query offset
equals the reference's float32 ``i * 1e-7`` bit for bit, and the chain's
output equals the twin of K3 on the last pass's offset query bit for bit.
``ServingFactors.measure_compute_ms`` is checked for its contract (a
finite median, two chain calls a sample after one warm-up call), not for
a time.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops.retrieval import naive_topn_reference
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops.topn import (
    LAUNCHES,
    LaunchCounts,
    chain_offset,
    check_topn_agreement,
    pack_topn,
    topn_chain,
    topn_packed,
    topn_packed_plain,
)

RTOL, ATOL = 1e-5, 1e-6
N_ITEMS = 40


def _inputs(seed, B, k, N=N_ITEMS):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, k)).astype(np.float32)
    Y = rng.normal(size=(N, k)).astype(np.float32)
    return q, Y


def _port_topn(q, Y, n):
    packed = topn_packed(torch.from_numpy(q), torch.from_numpy(Y), n).numpy()
    return packed[:, :n], port_als._unpack_indices(packed, n)


def _jax_topn(q, Y, n):
    packed = np.asarray(jax_als._topn_packed(jnp.asarray(q), jnp.asarray(Y), n))
    return packed[:, :n], jax_als._unpack_indices(packed, n)


@pytest.mark.parametrize("n", [1, 7, 16, N_ITEMS])
@pytest.mark.parametrize("k", [10, 32])
@pytest.mark.parametrize("B", [1, 5, 8])
def test_plain_twin_matches_jax_topn(B, k, n):
    q, Y = _inputs(B * 100 + k, B, k)
    s, i = _port_topn(q, Y, n)
    assert s.dtype == np.float32 and i.dtype == np.int32
    assert s.shape == i.shape == (B, n)
    js, ji = _jax_topn(q, Y, n)
    check_topn_agreement(s, i, js, ji, RTOL, ATOL, q=q, Y=Y)
    ns, ni = naive_topn_reference(Y, q, n)
    check_topn_agreement(s, i, ns, ni, RTOL, ATOL)


@pytest.mark.parametrize("n", [1, 7, 16, N_ITEMS])
def test_recommend_batch_matches_jax(n):
    q, Y = _inputs(7, 5, 10)
    s, i = port_als.recommend_batch(q, Y, n, device="cpu")
    js, ji = jax_als.recommend_batch(q, Y, n)
    check_topn_agreement(s, i, js, ji, RTOL, ATOL)


@pytest.mark.parametrize("n", [1, 7, 16, 3 * 20])
def test_exact_ties_break_lowest_index_first(n):
    rng = np.random.default_rng(3)
    base = rng.integers(-2, 3, size=(20, 8)).astype(np.float32)
    Y = np.concatenate([base, base, base])  # every item three times
    q = rng.integers(-2, 3, size=(5, 8)).astype(np.float32)
    s, i = _port_topn(q, Y, n)
    js, ji = _jax_topn(q, Y, n)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(s, js)
    ns, ni = naive_topn_reference(Y, q, n)
    np.testing.assert_array_equal(i, ni)
    # within every run of equal scores the ids ascend
    for row in range(len(q)):
        for j in range(1, n):
            if s[row, j] == s[row, j - 1]:
                assert i[row, j] > i[row, j - 1]


def test_id_bits_survive_pack_unpack_above_2_24():
    ids = np.array(
        [[2**24 + 1, 2**24 + 3, 2**31 - 1], [16_777_217, 33_554_433, 0]],
        np.int32,
    )
    scores = np.array([[3.0, 2.0, 1.0], [0.5, -0.5, -1.5]], np.float32)
    packed = pack_topn(torch.from_numpy(scores), torch.from_numpy(ids)).numpy()
    n = ids.shape[1]
    np.testing.assert_array_equal(packed[:, :n], scores)
    np.testing.assert_array_equal(port_als._unpack_indices(packed, n), ids)
    # the same raw bits as the JAX package's bitcast
    jax_bits = np.asarray(
        jax.lax.bitcast_convert_type(jnp.asarray(ids), jnp.float32)
    )
    np.testing.assert_array_equal(
        packed[:, n:].view(np.uint32), jax_bits.view(np.uint32)
    )
    # a float cast would have lost them
    assert np.float32(2**24 + 1) == np.float32(2**24)


def test_cpu_tensors_route_to_plain_twin_and_count():
    q, Y = _inputs(0, 3, 10)
    before = LAUNCHES.snapshot()
    topn_packed(torch.from_numpy(q), torch.from_numpy(Y), 4)
    after = LAUNCHES.snapshot()
    assert after["topn_packed_plain"] == before["topn_packed_plain"] + 1
    assert after["topn_packed"] == before["topn_packed"]


@pytest.mark.parametrize(
    "q_shape, y_shape, dtype, n, exc",
    [
        ((2, 4), (6, 4), torch.float32, 0, ValueError),
        ((2, 4), (6, 4), torch.float32, 7, ValueError),
        ((2, 4), (6, 5), torch.float32, 2, ValueError),
        ((4,), (6, 4), torch.float32, 2, ValueError),
        ((2, 4), (6, 4), torch.float64, 2, TypeError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(q_shape, y_shape, dtype, n, exc):
    with pytest.raises(exc):
        topn_packed(torch.zeros(q_shape, dtype=dtype), torch.zeros(y_shape, dtype=dtype), n)


def test_serving_factors_match_jax():
    rng = np.random.default_rng(11)
    uf = rng.normal(size=(30, 8)).astype(np.float32)
    itf = rng.normal(size=(N_ITEMS, 8)).astype(np.float32)
    users = [3, 0, 29, 7, 7]  # 5 rows, padded to 8 on both sides
    port = port_als.ServingFactors(uf, itf, device="cpu")
    s, i = port.topn_by_user(users, 16)
    js, ji = jax_als.ServingFactors(uf, itf).topn_by_user(users, 16)
    assert s.shape == (5, 16)
    check_topn_agreement(s, i, js, ji, RTOL, ATOL, q=uf[users], Y=itf)


def test_launch_counts_lose_no_update_under_contention():
    counts = LaunchCounts("a", "b")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=lambda: [counts.add("a") for _ in range(2000)])
            for _ in range(16)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counts.snapshot() == {"a": 16 * 2000, "b": 0}
    counts.reset()
    assert counts.snapshot() == {"a": 0, "b": 0}


# --- K3c: the chained passes of measure_compute_ms ---


@pytest.mark.parametrize("n_iters", [1, 3, 17])
def test_chain_twin_matches_jax_chain(n_iters):
    q, Y = _inputs(500 + n_iters, 6, 12, N=300)
    n = 10
    packed = topn_chain(torch.from_numpy(q), torch.from_numpy(Y), n, n_iters).numpy()
    ref = np.asarray(
        jax_als._topn_packed_chain(jnp.asarray(q), jnp.asarray(Y), n, jnp.int32(n_iters))
    )
    check_topn_agreement(
        packed[:, :n], port_als._unpack_indices(packed, n),
        ref[:, :n], jax_als._unpack_indices(ref, n), RTOL, ATOL,
    )
    # the last pass is K3 on the query offset by that pass, bit for bit
    last = topn_packed_plain(
        torch.from_numpy(q + chain_offset(n_iters - 1)), torch.from_numpy(Y), n
    ).numpy()
    np.testing.assert_array_equal(packed.view(np.uint32), last.view(np.uint32))


def test_chain_offsets_round_as_the_reference():
    i = jnp.arange(4096, dtype=jnp.int32)
    ref = np.asarray(jax.jit(lambda i: i.astype(jnp.float32) * 1e-7)(i))
    got = np.array([chain_offset(j) for j in range(4096)], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_chain_counts_one_launch_a_call_and_rejects_no_passes():
    q, Y = _inputs(7, 2, 4)
    before = LAUNCHES.snapshot()
    topn_chain(torch.from_numpy(q), torch.from_numpy(Y), 3, 5)
    after = LAUNCHES.snapshot()
    assert after["topn_chain_plain"] == before["topn_chain_plain"] + 1
    assert after["topn_chain"] == before["topn_chain"]
    with pytest.raises(ValueError):
        topn_chain(torch.from_numpy(q), torch.from_numpy(Y), 3, 0)


def test_measure_compute_ms_times_the_chain():
    rng = np.random.default_rng(3)
    sf = port_als.ServingFactors(
        rng.normal(size=(40, 8)).astype(np.float32),
        rng.normal(size=(200, 8)).astype(np.float32),
        device="cpu",
    )
    before = LAUNCHES.snapshot()["topn_chain_plain"]
    ms = sf.measure_compute_ms(sf.user_factors[:4], 5, iters=3, reps=2)
    assert np.isfinite(ms)
    # one warm-up call, then a t(1) and a t(iters) call per sample
    assert LAUNCHES.snapshot()["topn_chain_plain"] == before + 1 + 2 * 2
    with pytest.raises(ValueError):
        sf.measure_compute_ms(sf.user_factors[:4], 5, iters=1)
