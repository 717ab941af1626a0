"""bfloat16 training in the port, the routes and the grid bit for bit: the
streaming and direct routes, the bfloat16 grid against the serial trainer
per variant, and the resident pack's key, which leaves the dtype out, so a
float32 pack warm-starts a bfloat16 delta round. On the CPU (every kernel
by its plain twin), on the inputs, configs and fixtures of
``tests/test_torch_bf16.py`` (whose tests hold the same bfloat16 programs
against the JAX package), split out so that the two files run on two
workers.

Tolerance: none; each comparison is bit for bit (one program on one
input).
"""

import numpy as np

from predictionio_tpu_torch.data.storage.columnar import ColumnarStream
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import normal_eq as k1
from predictionio_tpu_torch.ops import streaming as port_streaming
from tests.test_torch_bf16 import (  # noqa: F401  (ratings is a fixture)
    BF16,
    CFG,
    MODES,
    N_ITEMS,
    N_USERS,
    SOLVERS,
    _signed,
    ratings,
)
from tests.test_torch_delta import scatterable_delta, seeded_store


def _stream(u, i, r, n_users, batch=900):
    names = np.array([f"u{n}" for n in range(n_users)] + [f"i{n}" for n in range(N_ITEMS)],
                     dtype=object)
    t = (i + np.int32(n_users)).astype(np.int32)
    batches = [(u[s:s + batch], t[s:s + batch], r[s:s + batch]) for s in range(0, len(r), batch)]
    return ColumnarStream(iter(batches), lambda: names)


@SOLVERS
@MODES
def test_streaming_and_direct_routes_are_bit_identical_in_bf16(ratings, implicit, solver):
    u, i, r = ratings
    r = _signed(r, implicit)
    config = port_als.ALSConfig(**dict(CFG, implicit_prefs=implicit, iterations=3, **solver))
    res = port_streaming.train_als_streaming(_stream(u, i, r, N_USERS), config, device="cpu",
                                             cache=False)
    remap_u = np.array([res.user_index.get(f"u{n}", -1) for n in range(N_USERS)], np.int32)
    remap_i = np.array([res.item_index.get(f"i{n}", -1) for n in range(N_ITEMS)], np.int32)
    direct = port_als.train_als(remap_u[u], remap_i[i], r, len(res.user_index),
                                len(res.item_index), config, device="cpu")
    assert np.array_equal(res.arrays.user_factors.view(np.uint32),
                          direct.user_factors.view(np.uint32))
    assert np.array_equal(res.arrays.item_factors.view(np.uint32),
                          direct.item_factors.view(np.uint32))


@MODES
def test_bf16_grid_equals_bf16_train_als_per_variant(ratings, implicit):
    """On ratings sorted by user (the wire's order) each variant of the
    bfloat16 grid equals ``train_als`` in bfloat16 with its regularizer,
    bit for bit, as the float32 grid does."""
    u, i, r = ratings
    r = _signed(r, implicit)
    order = np.argsort(u, kind="stable")
    u, i, r = u[order], i[order], r[order]
    config = port_als.ALSConfig(**dict(CFG, implicit_prefs=implicit, iterations=3))
    regs = (0.01, 0.1)
    grid = port_als.train_als_grid(u, i, r, N_USERS, N_ITEMS, config, regs, device="cpu")
    for reg, got in zip(regs, grid):
        want = port_als.train_als(u, i, r, N_USERS, N_ITEMS,
                                  port_als.ALSConfig(**dict(CFG, implicit_prefs=implicit,
                                                            iterations=3, reg=reg)),
                                  device="cpu")
        assert np.array_equal(got.user_factors.view(np.uint32), want.user_factors.view(np.uint32))
        assert np.array_equal(got.item_factors.view(np.uint32), want.item_factors.view(np.uint32))


def test_a_float32_resident_pack_warm_starts_a_bf16_round():
    """``config_train_key`` leaves the dtype out, as the reference's: a
    pack parked by a float32 round takes a bfloat16 delta round by the
    resident scatter, warm from the float32 factors."""
    port_streaming.pack_cache_clear()
    prev = port_streaming.set_resident_training(True)
    try:
        cfg = dict(rank=4, iterations=2, reg=0.05, seed=3, segment_length=16, chunk_slots=1024)
        store = seeded_store()
        t = {}
        port_streaming.train_als_streaming(store.stream(ColumnarStream), port_als.ALSConfig(**cfg),
                                           device="cpu", timings=t)
        assert t["resident"] == "cold"
        [entry] = list(port_streaming._PACK_CACHE.values())
        scatterable_delta(store, 40, entry.wire.L_u, entry.wire.L_i)
        t = {}
        before = k1.LAUNCHES.snapshot()
        port_streaming.train_als_streaming(
            store.stream(ColumnarStream), port_als.ALSConfig(**dict(cfg, compute_dtype=BF16)),
            device="cpu", timings=t, warm_sweeps=1)
        assert (t["pack_cache"], t["resident"]) == ("fold", "scatter")
        assert k1.LAUNCHES.snapshot()["normal_eq_bf16_plain"] == before["normal_eq_bf16_plain"] + 2
        assert port_als.config_train_key(port_als.ALSConfig(**cfg)) == port_als.config_train_key(
            port_als.ALSConfig(**dict(cfg, compute_dtype=BF16)))
    finally:
        port_streaming.set_resident_training(prev)
        port_streaming.pack_cache_clear()
