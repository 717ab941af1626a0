"""ALS training parity: the port's ``train_als`` on the CPU (K1 and K2 by
their plain twins) against the JAX package's ``train_als`` from the same
seed, both against the float64 MLlib oracle (``ops/als_reference.py``),
one sweep from the same warm factors, determinism, prediction (K7),
implicit feedback and the subspace solver against JAX
(``test_torch_implicit.py`` and ``test_torch_subspace.py`` have the rest),
and the configurations the port does not train yet.

Tolerances, stated beforehand:
- port against JAX after several sweeps: factors within 2e-5 of the
  largest factor entry, telemetry rows rtol 1e-5, RMSE within 1e-5. Both
  take the wire route, so their packed planes are equal bit for bit
  (``test_packed_planes_match_jax_exactly``) and the slots of each row
  come in one order; both are float32 and the twins' einsums sum in
  another order than XLA, and ALS carries each half-step's rounding into
  the next (largest gap seen: 7.3e-6).
- one sweep from the same warm factors: factors within 1e-5 of the
  largest entry.
- against the float64 oracle: rtol 5e-3, atol 5e-4, the JAX package's own
  tolerance (tests/test_mllib_parity.py).
- predictions: rtol 1e-5, atol 1e-6 (a rank-long dot product).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops.als_reference import rmse_reference, train_als_reference
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import predict_pairs as k7

N_USERS, N_ITEMS, RANK = 300, 150, 8
CFG = dict(rank=RANK, iterations=6, reg=0.05, seed=3, segment_length=16, chunk_slots=1024)


@pytest.fixture(scope="module")
def ratings():
    rng = np.random.default_rng(0)
    nnz = 6000
    u = rng.integers(0, N_USERS, nnz).astype(np.int32)
    i = rng.integers(0, N_ITEMS, nnz).astype(np.int32)
    i[:500] = 3  # a long item row: several segments
    u[u == 11] = 12  # a user without ratings
    r = (rng.integers(1, 11, nnz) / 2).astype(np.float32)
    return u, i, r


def _close(a, b, rel):
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())


@pytest.mark.parametrize("reg_mode", ["weighted", "plain"])
def test_train_matches_jax_and_oracle(ratings, reg_mode):
    u, i, r = ratings
    t_port, t_jax = {}, {}
    port = port_als.train_als(
        u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**CFG, reg_mode=reg_mode),
        device="cpu", timings=t_port,
    )
    ref = jax_als.train_als(
        u, i, r, N_USERS, N_ITEMS, jax_als.ALSConfig(**CFG, reg_mode=reg_mode),
        timings=t_jax,
    )
    assert port.user_factors.shape == (N_USERS, RANK)
    assert port.item_factors.shape == (N_ITEMS, RANK)
    _close(port.user_factors, ref.user_factors, 2e-5)
    _close(port.item_factors, ref.item_factors, 2e-5)
    assert not port.user_factors[11].any()  # no ratings: stays at zero
    rows_port = [[s[c] for c in ("dx", "dy", "x_rms", "y_rms")] for s in t_port["sweep_telemetry"]]
    rows_jax = [[s[c] for c in ("dx", "dy", "x_rms", "y_rms")] for s in t_jax["sweep_telemetry"]]
    assert len(rows_port) == CFG["iterations"]
    np.testing.assert_allclose(rows_port, rows_jax, rtol=1e-5)
    for key in ("pack_s", "device_put_s", "device_pack_dispatch_s", "compile_s", "device_loop_s"):
        assert t_port[key] >= 0
    for key in ("padded_slots", "wire_mb"):
        assert t_port[key] == t_jax[key]

    X, Y = train_als_reference(
        u, i, r, N_USERS, N_ITEMS, rank=RANK, iterations=CFG["iterations"],
        reg=0.05, reg_mode=reg_mode, seed=3,
    )
    np.testing.assert_allclose(port.user_factors, X, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(port.item_factors, Y, rtol=5e-3, atol=5e-4)

    rmse_port = port_als.rmse(port, u, i, r, device="cpu")
    assert abs(rmse_port - jax_als.rmse(ref, u, i, r)) < 1e-5
    assert abs(rmse_port - rmse_reference(X, Y, u, i, r)) < 1e-3


def test_packed_planes_match_jax_exactly(ratings):
    """train_als packs as the JAX package's train_als(mesh=None) does: the
    same wire, and the same planes from the device pack, bit for bit."""
    u, i, r = ratings
    wire = port_als.build_host_wire(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**CFG))
    ref_wire = jax_als.build_host_wire(u, i, r, N_USERS, N_ITEMS, jax_als.ALSConfig(**CFG))
    assert wire.identity_bytes() == ref_wire.identity_bytes()
    packs = port_als.device_pack_from_wire(wire, "cpu")
    for pack, ref in zip(packs, jax_als.device_pack_from_wire(ref_wire)):
        for plane, ref_plane in zip((pack.seg_rows, pack.cols, pack.vals, pack.rem), ref):
            ref_plane = np.asarray(ref_plane)
            assert plane.numpy().dtype == ref_plane.dtype
            assert plane.numpy().tobytes() == ref_plane.tobytes()


def test_one_sweep_from_warm_factors_matches_jax(ratings):
    u, i, r = ratings
    rng = np.random.default_rng(5)
    Xw = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    Yw = np.abs(rng.standard_normal((N_ITEMS, RANK))).astype(np.float32)
    port_cfg = port_als.ALSConfig(**CFG)
    jax_cfg = jax_als.ALSConfig(**CFG)
    cu = np.bincount(u, minlength=N_USERS).astype(np.int32)
    ci = np.bincount(i, minlength=N_ITEMS).astype(np.int32)
    us = port_als.pack_segments(u, i, r, N_USERS, 16, 1, 1024)
    its = port_als.pack_segments(i, u, r, N_ITEMS, 16, 1, 1024)

    state = port_als.init_factor_state_single(cu, ci, N_USERS, N_ITEMS, port_cfg, warm=(Xw, Yw), device="cpu")
    R_u, R_i = state[0].shape[0], state[1].shape[0]
    cpu = torch.device("cpu")
    X, Y, _ = port_als._run_iterations(
        *state[:2], port_als.device_pack(us, R_u, R_i, cpu),
        port_als.device_pack(its, R_i, R_u, cpu), *state[2:], 1,
    )
    js = jax_als.init_factor_state_single(cu, ci, N_USERS, N_ITEMS, jax_cfg, warm=(Xw, Yw))
    for a, b in zip(state, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    Xj, Yj, _ = jax_als._run_iterations(
        *js[:2],
        tuple(jnp.asarray(a) for a in (us.seg_rows, us.cols, us.vals, us.rem)),
        tuple(jnp.asarray(a) for a in (its.seg_rows, its.cols, its.vals, its.rem)),
        *js[2:], 1.0, jnp.int32(1),
        implicit=False, compute_dtype="float32", rep_sharding=None, row_sharding=None,
    )
    _close(X.numpy(), np.asarray(Xj), 1e-5)
    _close(Y.numpy(), np.asarray(Yj), 1e-5)


def test_deterministic_given_seed(ratings):
    u, i, r = ratings
    cfg = port_als.ALSConfig(rank=4, iterations=2, seed=42)
    m1 = port_als.train_als(u, i, r, N_USERS, N_ITEMS, cfg, device="cpu")
    m2 = port_als.train_als(u, i, r, N_USERS, N_ITEMS, cfg, device="cpu")
    np.testing.assert_array_equal(m1.user_factors, m2.user_factors)
    np.testing.assert_array_equal(m1.item_factors, m2.item_factors)


def test_zero_iterations_return_the_init():
    cfg = port_als.ALSConfig(rank=5, iterations=0, seed=9)
    one = np.array([0], np.int32)
    model = port_als.train_als(one, one, np.ones(1, np.float32), 3, 17, cfg, device="cpu")
    ref = jax_als.train_als(one, one, np.ones(1, np.float32), 3, 17, jax_als.ALSConfig(rank=5, iterations=0, seed=9))
    np.testing.assert_array_equal(model.item_factors, ref.item_factors)
    assert not model.user_factors.any()


def test_predict_ratings_matches_jax_in_chunks(ratings):
    rng = np.random.default_rng(2)
    model = port_als.ALSModelArrays(
        rng.standard_normal((N_USERS, 12)).astype(np.float32),
        rng.standard_normal((N_ITEMS, 12)).astype(np.float32),
    )
    u, i, _ = ratings
    before = k7.LAUNCHES.snapshot()["predict_pairs_plain"]
    got = port_als.predict_ratings(model, u, i, chunk=1000, device="cpu")
    assert k7.LAUNCHES.snapshot()["predict_pairs_plain"] == before + 6  # 6000 pairs
    ref = jax_als.predict_ratings(jax_als.ALSModelArrays(model.user_factors, model.item_factors), u, i)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="out of range"):
        k7.predict_pairs(
            torch.from_numpy(model.user_factors), torch.from_numpy(model.item_factors),
            torch.tensor([N_USERS], dtype=torch.int32), torch.tensor([0], dtype=torch.int32),
        )


@pytest.mark.parametrize("u, i", [([0, -1], [0, 0]), ([0, 0], [0, N_ITEMS])])
def test_predict_ratings_checks_ids_on_the_host(u, i):
    model = port_als.ALSModelArrays(
        np.zeros((N_USERS, 4), np.float32), np.zeros((N_ITEMS, 4), np.float32)
    )
    before = k7.LAUNCHES.snapshot()["predict_pairs_plain"]
    with pytest.raises(ValueError, match="out of range"):
        port_als.predict_ratings(model, np.array(u), np.array(i), device="cpu")
    assert k7.LAUNCHES.snapshot()["predict_pairs_plain"] == before


@pytest.mark.parametrize(
    "config, kwargs, match",
    [
        ({}, dict(mesh=object()), "mesh"),
    ],
)
def test_configurations_not_ported_raise(ratings, config, kwargs, match):
    """A ``Mesh`` trains since the sharded-training slice
    (``tests/test_torch_mesh_training.py``); anything else given as a mesh
    is still refused, now as the wrong type."""
    u, i, r = ratings
    cfg = port_als.ALSConfig(rank=4, iterations=1, **config)
    with pytest.raises(TypeError, match=match):
        port_als.train_als(u, i, r, N_USERS, N_ITEMS, cfg, device="cpu", **kwargs)


@pytest.mark.parametrize("leg", ["bfloat16", "checkpoint"])
def test_bf16_and_checkpoints_train(ratings, tmp_path, leg):
    """The two configurations that were cases of
    ``test_configurations_not_ported_raise`` now train: bfloat16 compute
    through the twins' bfloat16 forms (``test_torch_bf16.py`` holds them
    against JAX), and a checkpoint directory that receives the run's last
    step and short-circuits a rerun (``test_torch_checkpoint.py`` has the
    rest)."""
    u, i, r = ratings
    bf16 = leg == "bfloat16"
    cfg = port_als.ALSConfig(rank=4, iterations=2, compute_dtype="bfloat16" if bf16 else "float32")
    ckdir = None if bf16 else str(tmp_path / "ckpt")
    t = {}
    model = port_als.train_als(u, i, r, N_USERS, N_ITEMS, cfg, device="cpu", timings=t,
                               checkpoint_dir=ckdir)
    assert np.isfinite(model.user_factors).all() and len(t["sweep_telemetry"]) == 2
    if bf16:
        assert model.user_factors.dtype == np.float32
    else:
        assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_2.npz"]
        again = port_als.train_als(u, i, r, N_USERS, N_ITEMS, cfg, device="cpu",
                                   checkpoint_dir=ckdir)
        assert np.array_equal(again.user_factors, model.user_factors)


@pytest.mark.parametrize("implicit", [True, False])
def test_subspace_train_matches_jax(ratings, implicit):
    """``solver="subspace"`` trains (it raised before K11 was ported):
    explicit and implicit, factors and per-sweep telemetry at this file's
    tolerances against JAX's (``test_torch_subspace.py`` has the rest)."""
    u, i, r = ratings
    cfg = dict(CFG, solver="subspace", block_size=2, implicit_prefs=implicit, alpha=0.5)
    t_port, t_jax = {}, {}
    port = port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**cfg),
                              device="cpu", timings=t_port)
    ref = jax_als.train_als(u, i, r, N_USERS, N_ITEMS, jax_als.ALSConfig(**cfg), timings=t_jax)
    _close(port.user_factors, ref.user_factors, 2e-5)
    _close(port.item_factors, ref.item_factors, 2e-5)
    keys = ("dx", "dy", "x_rms", "y_rms") + (("objective",) if implicit else ())
    np.testing.assert_allclose(
        [[s[c] for c in keys] for s in t_port["sweep_telemetry"]],
        [[s[c] for c in keys] for s in t_jax["sweep_telemetry"]], rtol=1e-5,
    )


def test_implicit_train_matches_jax(ratings):
    """``implicit_prefs=True`` trains: the ratings read as confidences,
    factors and telemetry (the objective column too) at this file's
    tolerances against JAX's."""
    u, i, r = ratings
    t_port, t_jax = {}, {}
    port = port_als.train_als(
        u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**CFG, implicit_prefs=True, alpha=0.5),
        device="cpu", timings=t_port,
    )
    ref = jax_als.train_als(
        u, i, r, N_USERS, N_ITEMS, jax_als.ALSConfig(**CFG, implicit_prefs=True, alpha=0.5),
        timings=t_jax,
    )
    _close(port.user_factors, ref.user_factors, 2e-5)
    _close(port.item_factors, ref.item_factors, 2e-5)
    keys = ("dx", "dy", "x_rms", "y_rms", "objective")
    np.testing.assert_allclose(
        [[s[c] for c in keys] for s in t_port["sweep_telemetry"]],
        [[s[c] for c in keys] for s in t_jax["sweep_telemetry"]], rtol=1e-5,
    )


def test_training_defaults_to_cuda_and_raises_without_it(ratings, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    u, i, r = ratings
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(rank=4, iterations=1))
