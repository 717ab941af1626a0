"""Implicit-feedback ALS in the port against the JAX package on the CPU
(``device="cpu"``: every kernel by its plain twin): K1 with the implicit
weights and K2 with ``+G`` (one half-step, ``_solve_side``), K12a (the
Gramian), K12b (the objective, negative on a store of repeated events),
``train_als(implicit_prefs=True)`` against JAX's ``train_als`` and the
float64 oracle, the streaming route against the direct one, the
recommendation engine's ``implicit_prefs``, and K14 (the cosine sum).

Inputs are made from numpy seeds; one small shape per test, so JAX
compiles few programs. Tolerances, stated beforehand:
- K1 systems: rtol 1e-5 on the row's scale (the largest diagonal entry;
  b's scale sqrt(Σ w_b² · that diagonal)), atol 1e-6: XLA and PyTorch sum
  in different orders in float32 (``test_torch_normal_eq.py``'s rule).
- one half-step: rtol 1e-5, atol 1e-6 (a k-long Cholesky, rounded in
  other places); the Gramian: within 1e-5 of its largest diagonal entry,
  which bounds every Σ|y_i·y_j| (sums of n products in float32, ordered
  differently).
- the objective: rtol 1e-5 of the largest of its three terms' magnitudes:
  each is a float32 sum of at most a few thousand terms, and the value can
  cancel to near zero or below it.
- training after several sweeps: factors within 2e-5 of the largest entry
  (largest gap seen: 6.6e-6 of 1.15), telemetry rows, the objective
  column included, rtol 1e-5; against the float64 oracle a gap < 5e-3,
  the bench's gate (``bench.py:2652``).
- K14: rtol 1e-5, atol 1e-6 (a Q·k-long sum of products of unit rows).
- the streaming and direct routes: bit for bit (one wire, one program).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops import similarity as jax_sim
from predictionio_tpu.ops.als_reference import train_als_reference
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.storage.columnar import ColumnarStream
from predictionio_tpu_torch.models.recommendation import engine as rec
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import gramian as k12
from predictionio_tpu_torch.ops import normal_eq as k1
from predictionio_tpu_torch.ops import similarity as k14
from predictionio_tpu_torch.ops import spd_solve as k2
from predictionio_tpu_torch.ops import streaming as port_streaming

RTOL, ATOL = 1e-5, 1e-6
N_USERS, N_ITEMS, NNZ, RANK = 120, 60, 2400, 6
ALPHA = 2.0
CFG = dict(rank=RANK, iterations=5, reg=0.05, alpha=ALPHA, implicit_prefs=True, seed=3,
           segment_length=16, chunk_slots=512)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def views():
    """View counts 1..5 on zipf-popular items, a tenth of them dislikes
    (-1, LikeAlgorithm's encoding), repeated (user, item) events, and a
    user with no events."""
    rng = np.random.default_rng(0)
    u = rng.integers(0, N_USERS, NNZ).astype(np.int32)
    i = (rng.zipf(1.5, NNZ) % N_ITEMS).astype(np.int32)
    u[u == 9] = 10
    r = rng.integers(1, 6, NNZ).astype(np.float32)
    r[rng.random(NNZ) < 0.1] = -1.0
    u[:12], i[:12], r[:12] = 5, np.arange(12), -1.0  # user 5: dislikes first
    return u, i, r


def _jax_pack(side):
    return tuple(jnp.asarray(a) for a in (side.seg_rows, side.cols, side.vals, side.rem))


def _close(a, b, rel):
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())


def test_k1_implicit_twin_matches_jax_accumulate_systems(views):
    u, i, r = views
    side = port_als.pack_segments(u, i, r, N_USERS, 16, 1, 512)
    assert side.seg_rows.shape[0] > 1  # several chunks
    R, n_cols = port_als._padded_rows(N_USERS, 1), port_als._padded_rows(N_ITEMS, 1)
    Y = np.abs(np.random.default_rng(1).standard_normal((n_cols, RANK))).astype(np.float32)
    pack = port_als.device_pack(side, R, n_cols, CPU)
    before = k1.LAUNCHES.snapshot()["normal_eq_plain"]
    A, b = k1.normal_eq(torch.from_numpy(Y), pack, implicit=True, alpha=ALPHA)
    assert k1.LAUNCHES.snapshot()["normal_eq_plain"] == before + 1
    A_ref, b_ref = (np.asarray(a) for a in jax_als._accumulate_systems(
        jnp.asarray(Y), *_jax_pack(side), ALPHA, R, implicit=True, compute_dtype="float32",
    ))
    A, b = A.numpy(), b.numpy()
    diag = np.abs(np.diagonal(A_ref, axis1=1, axis2=2)).max(axis=1)
    np.testing.assert_array_less(np.abs(A - A_ref).max(axis=(1, 2)), ATOL + RTOL * diag)
    wb = np.where(side.vals > 0, 1 + ALPHA * np.abs(side.vals), 0.0)
    wsq = np.bincount(side.seg_rows.reshape(-1), weights=np.square(wb).sum(-1).reshape(-1),
                      minlength=R)[:R]
    np.testing.assert_array_less(np.abs(b - b_ref).max(axis=1), ATOL + RTOL * np.sqrt(wsq * diag))
    # user 5 (its first 12 events dislikes): A = Σ α|r|·y yᵀ, b = Σ over
    # the likes only of (1 + α|r|)·y, in float64; the user without events
    # and the padding rows hold zeros
    sel = u == 5
    Ys = Y[i[sel]].astype(np.float64)
    conf = ALPHA * np.abs(r[sel]).astype(np.float64)
    np.testing.assert_allclose(A[5], (Ys * conf[:, None]).T @ Ys, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(b[5], ((r[sel] > 0) * (1 + conf)) @ Ys, rtol=RTOL, atol=ATOL)
    assert not A[9].any() and not b[9].any() and not A[N_USERS:].any()
    # the explicit weights are unchanged: implicit=False is the call without them
    A0, b0 = k1.normal_eq(torch.from_numpy(Y), pack)
    A1, b1 = k1.normal_eq(torch.from_numpy(Y), pack, implicit=False, alpha=ALPHA)
    assert torch.equal(A0, A1) and torch.equal(b0, b1)


def test_k2_with_gramian_matches_jax_implicit_solve_side(views):
    u, i, r = views
    rng = np.random.default_rng(2)
    cfg = port_als.ALSConfig(**CFG)
    side = port_als.pack_segments(u, i, r, N_USERS, 16, 1, 512)
    R, n_cols = port_als._padded_rows(N_USERS, 1), port_als._padded_rows(N_ITEMS, 1)
    lam, has_obs = port_als._lam_obs_host(np.bincount(u, minlength=N_USERS), N_USERS, R, cfg)
    Y = np.zeros((n_cols, RANK), np.float32)
    Y[:N_ITEMS] = np.abs(rng.standard_normal((N_ITEMS, RANK)))
    X_prev = rng.standard_normal((R, RANK)).astype(np.float32)
    Yt = torch.from_numpy(Y)
    G = k12.gramian(Yt)
    X = port_als._solve_side(
        torch.from_numpy(X_prev), Yt, port_als.device_pack(side, R, n_cols, CPU),
        torch.from_numpy(lam), torch.from_numpy(has_obs), G=G, implicit=True, alpha=ALPHA,
    ).numpy()
    ref = np.asarray(jax_als._solve_side(
        jnp.asarray(X_prev), jnp.asarray(Y), jax_als._gramian(jnp.asarray(Y)), _jax_pack(side),
        jnp.asarray(lam), jnp.asarray(has_obs), ALPHA, implicit=True, compute_dtype="float32",
    ))
    np.testing.assert_allclose(X, ref, rtol=RTOL, atol=ATOL)
    # rows without observations keep X_prev whatever G is
    np.testing.assert_array_equal(X[9], X_prev[9])
    np.testing.assert_array_equal(X[N_USERS:], X_prev[N_USERS:])
    # G is added to every system before the regularizer, as A + G would be
    A = torch.from_numpy(rng.standard_normal((R, RANK, RANK)).astype(np.float32))
    A = A @ A.transpose(1, 2)
    b = torch.from_numpy(rng.standard_normal((R, RANK)).astype(np.float32))
    args = (torch.from_numpy(lam), torch.from_numpy(has_obs), torch.from_numpy(X_prev))
    with_g = k2.spd_solve(A, b, *args, G=G)
    folded = k2.spd_solve(A + G[None], b, *args)
    assert torch.equal(with_g, folded)
    with pytest.raises(ValueError, match="G must be"):
        k2.spd_solve(A, b, *args, G=G[:-1])


@pytest.mark.parametrize("n", [1, 61, 1000])
def test_gramian_matches_jax(n):
    Y = np.random.default_rng(n).standard_normal((n, RANK)).astype(np.float32)
    Y[n // 2] = 0.0  # a padding row adds nothing
    before = k12.LAUNCHES.snapshot()
    G = k12.gramian(torch.from_numpy(Y)).numpy()
    after = k12.LAUNCHES.snapshot()
    assert after["gramian_plain"] == before["gramian_plain"] + 1
    assert after["gramian"] == before["gramian"]
    ref = np.asarray(jax_als._gramian(jnp.asarray(Y)))
    tol = ATOL + RTOL * np.diag(ref).max()
    np.testing.assert_allclose(G, ref, rtol=0, atol=tol)
    np.testing.assert_allclose(G, Y.astype(np.float64).T @ Y, rtol=0, atol=tol)


def _objective_terms(X, Y, side, user_lam, item_lam):
    """The magnitudes of the objective's three terms, in float64."""
    X, Y = X.astype(np.float64), Y.astype(np.float64)
    rows = np.repeat(side.seg_rows.reshape(-1), side.cols.shape[-1])
    valid = (np.arange(side.cols.shape[-1])[None, :] < side.rem.reshape(-1)[:, None]).reshape(-1)
    s = np.einsum("nk,nk->n", X[rows[valid]], Y[side.cols.reshape(-1)[valid]])
    v = side.vals.reshape(-1)[valid]
    c, p = ALPHA * np.abs(v), (v > 0).astype(np.float64)
    obs = np.abs(c * s * s).sum() + np.abs(2 * (1 + c) * p * s).sum() + ((1 + c) * p).sum()
    reg = (user_lam * (X * X).sum(-1)).sum() + (item_lam * (Y * Y).sum(-1)).sum()
    return obs, np.abs((X.T @ X) * (Y.T @ Y)).sum(), reg


@pytest.mark.parametrize("repeats", [1, 8])
def test_objective_matches_jax_and_goes_negative_on_repeated_events(repeats):
    """With every (user, item) event repeated, each repeat subtracts its
    cell's s² again while ⟨XᵀX, YᵀY⟩ counts it once: at fitted factors the
    value is negative, in the reference as here."""
    rng = np.random.default_rng(repeats)
    n_u, n_i, k = 40, 30, 4
    pu, pi = rng.integers(0, n_u, 150), rng.integers(0, n_i, 150)
    u = np.repeat(pu, repeats).astype(np.int32)
    i = np.repeat(pi, repeats).astype(np.int32)
    r = np.ones(len(u), np.float32)
    cfg = dict(rank=k, iterations=4, reg=0.05, alpha=ALPHA, implicit_prefs=True, seed=3,
               segment_length=8, chunk_slots=256)
    model = port_als.train_als(u, i, r, n_u, n_i, port_als.ALSConfig(**cfg), device="cpu")
    R_u, R_i = port_als._padded_rows(n_u, 1), port_als._padded_rows(n_i, 1)
    X = np.zeros((R_u, k), np.float32)
    X[:n_u] = model.user_factors
    Y = np.zeros((R_i, k), np.float32)
    Y[:n_i] = model.item_factors
    side = port_als.pack_segments(u, i, r, n_u, 8, 1, 256)
    user_lam = rng.uniform(0.1, 1.0, R_u).astype(np.float32)
    item_lam = rng.uniform(0.1, 1.0, R_i).astype(np.float32)
    before = k12.LAUNCHES.snapshot()["implicit_objective_plain"]
    out = torch.zeros(1)
    got = k12.implicit_objective(
        torch.from_numpy(X), torch.from_numpy(Y), port_als.device_pack(side, R_u, R_i, CPU),
        torch.from_numpy(user_lam), torch.from_numpy(item_lam), ALPHA, out=out,
    )
    assert got is out and k12.LAUNCHES.snapshot()["implicit_objective_plain"] == before + 1
    ref = float(jax_als._implicit_objective(
        jnp.asarray(X), jnp.asarray(Y), _jax_pack(side), jnp.asarray(user_lam),
        jnp.asarray(item_lam), ALPHA, compute_dtype="float32",
    ))
    scale = max(_objective_terms(X, Y, side, user_lam, item_lam))
    assert abs(float(out) - ref) <= RTOL * scale
    if repeats > 1:
        assert ref < 0 and float(out) < 0


def test_train_als_implicit_matches_jax_and_the_oracle(views):
    u, i, r = views
    t_port, t_jax = {}, {}
    port = port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**CFG),
                              device="cpu", timings=t_port)
    ref = jax_als.train_als(u, i, r, N_USERS, N_ITEMS, jax_als.ALSConfig(**CFG), timings=t_jax)
    _close(port.user_factors, ref.user_factors, 2e-5)
    _close(port.item_factors, ref.item_factors, 2e-5)
    assert not port.user_factors[9].any()  # no events: stays at zero
    keys = ("dx", "dy", "x_rms", "y_rms", "objective")
    rows_port = [[s[c] for c in keys] for s in t_port["sweep_telemetry"]]
    rows_jax = [[s[c] for c in keys] for s in t_jax["sweep_telemetry"]]
    assert len(rows_port) == CFG["iterations"]
    np.testing.assert_allclose(rows_port, rows_jax, rtol=RTOL)
    X, Y = train_als_reference(
        u, i, r, N_USERS, N_ITEMS, rank=RANK, iterations=CFG["iterations"], reg=CFG["reg"],
        alpha=ALPHA, implicit_prefs=True, reg_mode="weighted", seed=CFG["seed"],
    )
    gap = max(np.abs(port.user_factors - X).max(), np.abs(port.item_factors - Y).max())
    assert gap < 5e-3, gap
    # the launch counts on the CPU: the twins, per sweep one Gramian for
    # each half-step and one objective with its two Gramians
    before = k12.LAUNCHES.snapshot()
    port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**CFG), device="cpu")
    after = k12.LAUNCHES.snapshot()
    assert after["gramian_plain"] - before["gramian_plain"] == 4 * CFG["iterations"]
    assert after["implicit_objective_plain"] - before["implicit_objective_plain"] == CFG["iterations"]
    assert after["gramian"] == before["gramian"]


def test_explicit_telemetry_keeps_four_keys(views):
    u, i, r = views
    t = {}
    cfg = dict(CFG, implicit_prefs=False, iterations=2)
    r_pos = np.abs(r)
    before = k12.LAUNCHES.snapshot()
    port_als.train_als(u, i, r_pos, N_USERS, N_ITEMS, port_als.ALSConfig(**cfg),
                       device="cpu", timings=t)
    assert k12.LAUNCHES.snapshot() == before  # no Gramian, no objective
    assert [sorted(s) for s in t["sweep_telemetry"]] == [sorted(("dx", "dy", "x_rms", "y_rms"))] * 2


def test_implicit_streaming_and_direct_routes_are_bit_identical(views):
    """The wire carries the raw counts and dislikes (int8, no nibbles: a
    rating is negative); the confidences are formed on the device from
    it, so both routes train on the same bytes."""
    u, i, r = views
    names = np.array([f"u{n}" for n in range(N_USERS)] + [f"i{n}" for n in range(N_ITEMS)], object)
    t_codes = (i + N_USERS).astype(np.int32)
    cuts = [0, 500, 1300, NNZ]
    batches = [(u[a:b], t_codes[a:b], r[a:b]) for a, b in zip(cuts, cuts[1:])]
    t = {}
    got = port_streaming.train_als_streaming(
        ColumnarStream(iter(batches), lambda: names), port_als.ALSConfig(**CFG),
        device="cpu", timings=t,
    )
    assert [sorted(s) for s in t["sweep_telemetry"]][0] == sorted(("dx", "dy", "x_rms", "y_rms", "objective"))
    ru = np.array([got.user_index.get(f"u{n}", -1) for n in range(N_USERS)])
    ri = np.array([got.item_index.get(f"i{n}", -1) for n in range(N_ITEMS)])
    wire = port_als.build_host_wire(ru[u], ri[i], r, len(got.user_index), len(got.item_index),
                                    port_als.ALSConfig(**CFG))
    assert wire.vw.dtype == np.int8 and not wire.nibble
    direct = port_als.train_als(ru[u], ri[i], r, len(got.user_index), len(got.item_index),
                                port_als.ALSConfig(**CFG), device="cpu")
    np.testing.assert_array_equal(direct.user_factors, got.arrays.user_factors)
    np.testing.assert_array_equal(direct.item_factors, got.arrays.item_factors)


def test_recommendation_engine_trains_implicit(views):
    u, i, r = views
    users = BiMap({f"u{n}": n for n in range(N_USERS)})
    items = BiMap({f"i{n}": n for n in range(N_ITEMS)})
    td = rec.TrainingData(u, i, r, users, items)
    params = rec.ALSAlgorithmParams(rank=RANK, num_iterations=CFG["iterations"], lambda_=CFG["reg"],
                                    alpha=ALPHA, implicit_prefs=True, seed=CFG["seed"])
    model = rec.ALSAlgorithm(params).train("cpu", rec.Preparator().prepare("cpu", td))
    direct = port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(
        rank=RANK, iterations=CFG["iterations"], reg=CFG["reg"], alpha=ALPHA,
        implicit_prefs=True, seed=CFG["seed"]), device="cpu")
    np.testing.assert_array_equal(model.arrays.item_factors, direct.item_factors)
    # the subspace solver trains through the engine too, as train_als does
    sub = rec.ALSAlgorithm(rec.ALSAlgorithmParams(
        rank=4, num_iterations=2, implicit_prefs=True, solver="subspace", block_size=2,
        seed=CFG["seed"],
    )).train("cpu", rec.Preparator().prepare("cpu", td))
    direct = port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(
        rank=4, iterations=2, reg=0.01, implicit_prefs=True, solver="subspace", block_size=2,
        seed=CFG["seed"]), device="cpu")
    np.testing.assert_array_equal(sub.arrays.user_factors, direct.user_factors)
    np.testing.assert_array_equal(sub.arrays.item_factors, direct.item_factors)


@pytest.mark.parametrize("n_query", [1, 5, 16])
def test_cosine_sum_matches_jax(n_query):
    rng = np.random.default_rng(n_query)
    factors = rng.standard_normal((300, RANK)).astype(np.float32)
    factors[7] = 0.0  # a zero row scores 0
    query_idx = rng.integers(0, 300, n_query)
    scorer = k14.SimilarityScorer(factors, device="cpu")
    ref_scorer = jax_sim.SimilarityScorer(factors)
    np.testing.assert_array_equal(scorer.normed, ref_scorer.normed)
    before = k14.LAUNCHES.snapshot()
    got = scorer.cosine_sum(scorer.normed[query_idx])
    after = k14.LAUNCHES.snapshot()
    assert after["cosine_sum_plain"] == before["cosine_sum_plain"] + 1
    assert after["cosine_sum"] == before["cosine_sum"]
    want = ref_scorer.cosine_sum(ref_scorer.normed[query_idx])
    assert got.shape == want.shape == (300,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[7] == 0.0
    # the kernel's function on the padded query, against JAX's program
    q = np.zeros((max(4, 1 << (n_query - 1).bit_length()), RANK), np.float32)
    q[:n_query] = scorer.normed[query_idx]
    np.testing.assert_allclose(
        k14.cosine_sum(torch.from_numpy(q), torch.from_numpy(scorer.normed)).numpy(),
        np.asarray(jax_sim._cosine_sum(jnp.asarray(q), jnp.asarray(scorer.normed))),
        rtol=RTOL, atol=ATOL,
    )


def test_wrappers_check_their_inputs_and_the_scorer_refuses_a_mesh():
    q, Y = torch.zeros((4, 3)), torch.zeros((5, 3))
    with pytest.raises(ValueError):
        k14.cosine_sum(q, torch.zeros((5, 4)))
    with pytest.raises(TypeError):
        k14.cosine_sum(q.double(), Y)
    # a port Mesh is served (tests/test_torch_mesh.py); any other object is refused
    with pytest.raises(TypeError, match="Mesh"):
        k14.SimilarityScorer(np.zeros((5, 3), np.float32), device="cpu", mesh=object())
    with pytest.raises(ValueError):
        k12.gramian(torch.zeros(5))
