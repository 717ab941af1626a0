"""ALS training on a row-sharded mesh in the port (``train_als(mesh=)``,
K6s) against the JAX package on the CPU: the port's ``["cpu"] * S`` mesh
against JAX's ``train_als(mesh=make_mesh({"data": S}, jax.devices()[:S]))``
on the conftest's 8 virtual CPU devices, S in {2, 4, 8}, on the
reference's own mesh-test data (``tests/test_als.py:231-258``: the
synthetic 64 x 40 ratings, rank 4, 3 sweeps, reg 0.05).

Tolerances, stated beforehand:
- against JAX's mesh run: rtol 1e-4, atol 1e-5 on the factors, the
  reference's own bar for its mesh against its single device
  (tests/test_als.py:240); the subspace solver (rank 8, block 4) at rtol
  2e-4, atol 2e-5 and bfloat16 after one sweep at atol 1e-4 of the largest
  entry, the bars ``tests/test_torch_subspace.py`` and
  ``tests/test_torch_bf16.py`` hold the single device to against JAX;
  telemetry rows at rtol 1e-5 (its RMS divide by the mesh's padded rows,
  as JAX's do: the column that would fail with one device's denominators
  is checked to differ), the objective at rtol 1e-5.
- against the port's own single device: every real row bit for bit. Each
  shard builds and solves its rows exactly as one device does, so only the
  telemetry's cross-shard sums change order: rtol 1e-6 after rescaling to
  the same padded rows.
- the shard forms of K1, K2, K11 and the sharded K12b against the
  single-device twins' rows: bit for bit, and the objective (its sums
  regrouped by shard) at rtol 1e-6.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.parallel import make_mesh as jax_make_mesh
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import gramian as k12
from predictionio_tpu_torch.ops import normal_eq as k1
from predictionio_tpu_torch.ops import spd_solve as k2
from predictionio_tpu_torch.ops import subspace as k11
from predictionio_tpu_torch.parallel import Mesh, make_mesh, split_rows

N_USERS, N_ITEMS = 64, 40
BASE = dict(rank=4, iterations=3, reg=0.05)
SHARDS = [2, 4, 8]
CPU = torch.device("cpu")


def synthetic(n_users=N_USERS, n_items=N_ITEMS, k=4, density=0.4, seed=1):
    """The reference's ``tests/test_als.py`` ``synthetic`` ratings."""
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n_users, k)) / np.sqrt(k)
    V = rng.standard_normal((n_items, k)) / np.sqrt(k)
    mask = rng.random((n_users, n_items)) < density
    u, i = np.nonzero(mask)
    r = (U @ V.T + 3.0)[u, i]
    return u.astype(np.int32), i.astype(np.int32), r.astype(np.float32)


@pytest.fixture(scope="module")
def ratings():
    return synthetic()


def port_mesh(S):
    return make_mesh({"data": S}, ["cpu"] * S)


def train_pair(ratings, S, **cfg):
    """The port on S CPU shards, JAX on S virtual devices, and the port on
    one device, each with its telemetry."""
    u, i, r = ratings
    c = dict(BASE, **cfg)
    t_port, t_jax, t_one = {}, {}, {}
    port = port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**c),
                              mesh=port_mesh(S), timings=t_port)
    ref = jax_als.train_als(u, i, r, N_USERS, N_ITEMS, jax_als.ALSConfig(**c),
                            mesh=jax_make_mesh({"data": S}, jax.devices()[:S]), timings=t_jax)
    one = port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**c),
                             device="cpu", timings=t_one)
    return (port, t_port), (ref, t_jax), (one, t_one)


def rows(t, key="sweep_telemetry"):
    cols = sorted(t[key][0])
    return np.array([[row[c] for c in cols] for row in t[key]], np.float64), cols


def assert_bit_equal(a, b):
    for got, want in ((a.user_factors, b.user_factors), (a.item_factors, b.item_factors)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def assert_rescaled_telemetry(t_mesh, t_one, S):
    """The mesh's RMS columns are one device's over the mesh's padded rows:
    rms_mesh = rms_one · sqrt(R_one / R_mesh), side by side."""
    R = {side: (port_als._padded_rows(n, 1), port_als._padded_rows(n, S))
         for side, n in (("x", N_USERS), ("y", N_ITEMS))}
    for got, want in zip(t_mesh["sweep_telemetry"], t_one["sweep_telemetry"]):
        for col, side in (("dx", "x"), ("x_rms", "x"), ("dy", "y"), ("y_rms", "y")):
            one, mesh = R[side]
            np.testing.assert_allclose(got[col], want[col] * np.sqrt(one / mesh), rtol=1e-6)
        if "objective" in want:
            np.testing.assert_allclose(got["objective"], want["objective"], rtol=1e-6)


FORMS = {
    "explicit": {},
    "implicit": dict(implicit_prefs=True, alpha=1.0),
    "plain_reg": dict(reg_mode="plain"),
}


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("form", sorted(FORMS))
def test_mesh_training_matches_jax_and_one_device(ratings, S, form):
    (port, t_port), (ref, t_jax), (one, t_one) = train_pair(ratings, S, **FORMS[form])
    for got, want in ((port.user_factors, ref.user_factors), (port.item_factors, ref.item_factors)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    got, cols = rows(t_port)
    want, want_cols = rows(t_jax)
    assert cols == want_cols and len(got) == BASE["iterations"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_bit_equal(port, one)
    assert_rescaled_telemetry(t_port, t_one, S)
    if port_als._padded_rows(N_ITEMS, S) != port_als._padded_rows(N_ITEMS, 1):
        # one device's denominators would not give JAX's mesh rows
        assert abs(t_one["sweep_telemetry"][-1]["y_rms"] - t_jax["sweep_telemetry"][-1]["y_rms"]) \
            > 1e-3 * t_jax["sweep_telemetry"][-1]["y_rms"]


@pytest.mark.parametrize("S", [2, 8])
@pytest.mark.parametrize("implicit", [False, True])
def test_subspace_solver_on_a_mesh_matches_jax(ratings, S, implicit):
    (port, t_port), (ref, t_jax), (one, t_one) = train_pair(
        ratings, S, rank=8, solver="subspace", block_size=4, implicit_prefs=implicit)
    for got, want in ((port.user_factors, ref.user_factors), (port.item_factors, ref.item_factors)):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    for key in ("sweep_telemetry", "block_telemetry"):
        got, cols = rows(t_port, key)
        want, want_cols = rows(t_jax, key)
        assert cols == want_cols
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len(t_port["block_telemetry"]) == 3 * 2
    assert_bit_equal(port, one)


@pytest.mark.parametrize("S", [2, 8])
@pytest.mark.parametrize("implicit", [False, True])
def test_bf16_on_a_mesh_matches_jax(ratings, S, implicit):
    (port, _), (ref, _), _ = train_pair(ratings, S, iterations=1, compute_dtype="bfloat16",
                                        implicit_prefs=implicit)
    for got, want in ((port.user_factors, ref.user_factors), (port.item_factors, ref.item_factors)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    u, i, r = ratings
    c = port_als.ALSConfig(**dict(BASE, compute_dtype="bfloat16", implicit_prefs=implicit))
    assert_bit_equal(port_als.train_als(u, i, r, N_USERS, N_ITEMS, c, mesh=port_mesh(S)),
                     port_als.train_als(u, i, r, N_USERS, N_ITEMS, c, device="cpu"))


def test_a_heavy_row_and_an_empty_shard_train_as_one_device():
    """A user with more ratings than a shard's share: the split leaves a
    shard empty rather than cut the row, and every row still equals one
    device's, in both modes, at 2, 3 and 4 shards."""
    rng = np.random.default_rng(4)
    u, i, r = synthetic(n_users=24, n_items=16, seed=5)
    heavy = np.zeros(400, np.int32)
    u = np.concatenate([u, heavy])
    i = np.concatenate([i, rng.integers(0, 16, 400).astype(np.int32)])
    r = np.concatenate([r, rng.integers(1, 6, 400).astype(np.float32)])
    empty_seen = False
    for S in (2, 3, 4):
        for implicit in (False, True):
            c = port_als.ALSConfig(rank=4, iterations=2, reg=0.05, implicit_prefs=implicit,
                                   segment_length=8)
            t = {}
            got = port_als.train_als(u, i, r, 24, 16, c, mesh=port_mesh(S), timings=t)
            assert_bit_equal(got, port_als.train_als(u, i, r, 24, 16, c, device="cpu"))
            empty_seen |= 0 in t["shard_rows"]["user"]
            assert sum(t["shard_rows"]["user"]) == port_als._padded_rows(24, S)
    assert empty_seen


# --- the row split ---


@pytest.mark.parametrize("weights,S", [
    ([1] * 10, 3), ([0, 100, 1, 1, 1], 4), ([0] * 5, 2), ([5, 5, 5, 5], 4),
    ([3, 0, 0, 7, 2, 2, 9, 1], 3), ([1, 2], 5), ([], 2),
])
def test_split_rows_covers_every_row_once_at_row_boundaries(weights, S):
    b = split_rows(weights, S)
    w = np.asarray(weights, np.int64)
    assert len(b) == S + 1 and b[0] == 0 and b[-1] == len(w)
    assert np.all(np.diff(b) >= 0)  # contiguous ranges, in order, none cut
    covered = np.concatenate([np.arange(b[s], b[s + 1]) for s in range(S)] + [np.zeros(0, int)])
    assert np.array_equal(covered, np.arange(len(w)))
    if len(w):
        # each cut lies within one row's weight of its share
        cum = np.concatenate([[0], np.cumsum(w)])
        for j in range(1, S):
            assert abs(cum[b[j]] - j * cum[-1] / S) <= max(w.max(), 0) / 1.0 + 1e-9


def test_split_rows_balances_slots_and_leaves_a_shard_empty_for_a_heavy_row():
    assert split_rows([0, 100, 1, 1, 1], 4).tolist() == [0, 1, 2, 2, 5]
    b = split_rows(np.full(1000, 3), 4)
    assert b.tolist() == [0, 250, 500, 750, 1000]
    with pytest.raises(ValueError):
        split_rows([1, -1], 2)
    with pytest.raises(ValueError):
        split_rows([1], 0)


# --- routes, mesh shapes, checkpoints ---


def test_a_one_shard_mesh_takes_the_single_device_route(ratings):
    u, i, r = ratings
    t = {}
    got = port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**BASE),
                             mesh=port_mesh(1), timings=t)
    assert "wire_mb" in t and "shard_rows" not in t  # the wire route
    assert_bit_equal(got, port_als.train_als(u, i, r, N_USERS, N_ITEMS,
                                             port_als.ALSConfig(**BASE), device="cpu"))


def test_a_mesh_with_a_model_axis_raises(ratings):
    u, i, r = ratings
    mesh = Mesh(["cpu"] * 4, {"data": 2, "model": 2})
    with pytest.raises(ValueError, match="1-D 'data' mesh"):
        port_als.train_als(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**BASE), mesh=mesh)
    with pytest.raises(ValueError, match="1-D 'data' mesh"):
        port_als.train_als_grid(u, i, r, N_USERS, N_ITEMS, port_als.ALSConfig(**BASE),
                                [0.1], mesh=mesh)


def test_a_mesh_checkpoint_resumes_bit_for_bit_and_one_device_ignores_it(ratings, tmp_path):
    u, i, r = ratings
    cfg = port_als.ALSConfig(**dict(BASE, iterations=6, implicit_prefs=True))
    mesh = port_mesh(4)
    whole = port_als.train_als(u, i, r, N_USERS, N_ITEMS, cfg, mesh=mesh)
    d = str(tmp_path / "ckpt")
    port_als.train_als(u, i, r, N_USERS, N_ITEMS, dataclasses.replace(cfg, iterations=3),
                       mesh=mesh, checkpoint_dir=d, checkpoint_every=3)
    t = {}
    resumed = port_als.train_als(u, i, r, N_USERS, N_ITEMS, cfg, mesh=mesh, checkpoint_dir=d,
                                 checkpoint_every=3, timings=t)
    assert t["checkpoint_resumed_at"] == 3
    assert_bit_equal(resumed, whole)
    t = {}
    port_als.train_als(u, i, r, N_USERS, N_ITEMS, cfg, device="cpu", checkpoint_dir=d,
                       checkpoint_every=3, timings=t)
    assert t["checkpoint_resumed_at"] == 0  # a different run: the shard count differs
    # and the reverse: the directory's latest save is now one device's
    t = {}
    port_als.train_als(u, i, r, N_USERS, N_ITEMS, cfg, mesh=mesh, checkpoint_dir=d,
                       checkpoint_every=3, timings=t)
    assert t["checkpoint_resumed_at"] == 0


# --- the shard forms of the kernels' twins ---


def mesh_sides(ratings, S, L=8):
    """Both sides cut for S shards, as train_als's mesh route cuts them,
    and one device's packs from the wire route."""
    u, i, r = ratings
    order = np.argsort(u, kind="stable")
    us, is_, rs = u[order], i[order], r[order]
    R_u, R_i = port_als._padded_rows(N_USERS, S), port_als._padded_rows(N_ITEMS, S)
    user = port_als.upload_mesh_side(
        *port_als.mesh_pack_side(us, is_, rs, N_USERS, R_u, L, 96, S)[:2], [CPU] * S, R_u, R_i,
        port_als._padded_rows(N_USERS, 1))
    item = port_als.upload_mesh_side(
        *port_als.mesh_pack_side(is_, us, rs, N_ITEMS, R_i, L, 96, S)[:2], [CPU] * S, R_i, R_u,
        port_als._padded_rows(N_ITEMS, 1))
    wire = port_als.build_host_wire(u, i, r, N_USERS, N_ITEMS,
                                    port_als.ALSConfig(**BASE, segment_length=L))
    up, ip = port_als.device_pack_from_wire(wire, CPU)
    return user, item, up, ip, R_u, R_i


def factors(rng, rows_, k):
    return torch.from_numpy(np.abs(rng.standard_normal((rows_, k))).astype(np.float32))


@pytest.mark.parametrize("S", [3, 8])
@pytest.mark.parametrize("implicit", [False, True])
def test_k1_and_k2_shard_forms_equal_the_single_device_rows(ratings, S, implicit):
    user, item, up, ip, R_u, R_i = mesh_sides(ratings, S)
    rng = np.random.default_rng(S)
    Y = factors(rng, R_i, 4)
    X_prev = factors(rng, R_u, 4)
    lam = torch.from_numpy(rng.random(R_u).astype(np.float32) + 0.1)
    obs = torch.from_numpy(rng.random(R_u) < 0.8)
    obs[N_USERS:] = False  # padding rows observe nothing
    G = k12.gramian(Y[: port_als._padded_rows(N_ITEMS, 1)]) if implicit else None
    A1, b1 = k1.normal_eq(Y, up, implicit, 0.5)
    R1 = up.n_sys_rows
    X1 = k2.spd_solve(A1, b1, lam[:R1], obs[:R1], X_prev[:R1], G=G)
    X_next = torch.full((R_u, 4), float("nan"))
    assert any(r1 - r0 for _, _, r0, r1, _ in user.shards())
    for _, _, r0, r1, pack in user.shards():
        A, b = k1.normal_eq(Y, pack, implicit, 0.5)
        n = max(0, min(r1, R1) - r0)  # the rows one device has too
        assert torch.equal(A[:n], A1[r0 : r0 + n]) and torch.equal(b[:n], b1[r0 : r0 + n])
        k2.spd_solve(A, b, lam[r0:r1], obs[r0:r1], X_prev[r0:r1], G=G, out=X_next[r0:r1])
    assert torch.equal(X_next[:R1], X1)
    assert torch.equal(X_next[R1:], X_prev[R1:])  # padding rows keep their factors
    with pytest.raises(ValueError, match="overlap"):
        k2.spd_solve(A1, b1, lam[:R1], obs[:R1], X_prev[:R1], out=X_prev[:R1])


@pytest.mark.parametrize("S", [2, 8])
def test_k11_shard_form_equals_the_single_device_rows(ratings, S):
    user, item, up, ip, R_u, R_i = mesh_sides(ratings, S)
    rng = np.random.default_rng(11)
    Y, X0 = factors(rng, R_i, 8), factors(rng, R_u, 8)
    lam = torch.from_numpy(rng.random(R_u).astype(np.float32) + 0.1)
    obs = torch.from_numpy(rng.random(R_u) < 0.8)
    obs[N_USERS:] = False
    R1 = up.n_sys_rows
    X1 = X0[:R1].clone()
    X = X0.clone()
    for s0 in (0, 4):  # both column blocks, in order
        A1, r1_ = k11.subspace_accumulate(Y, X1, up, s0, 4, True, 0.5)
        k11.subspace_block_solve(A1, r1_, X1, lam[:R1], obs[:R1], s0)
        for _, _, r0, r1, pack in user.shards():
            A, rv = k11.subspace_accumulate(Y, X[r0:r1], pack, s0, 4, True, 0.5)
            n = max(0, min(r1, R1) - r0)
            assert torch.equal(A[:n], A1[r0 : r0 + n]) and torch.equal(rv[:n], r1_[r0 : r0 + n])
            k11.subspace_block_solve(A, rv, X[r0:r1], lam[r0:r1], obs[r0:r1], s0)
    assert torch.equal(X[:R1], X1)


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_k12b_shards_equal_the_single_device_objective(ratings, S, cdt):
    user, item, up, ip, R_u, R_i = mesh_sides(ratings, S)
    rng = np.random.default_rng(12)
    X, Y = factors(rng, R_u, 4), factors(rng, R_i, 4)
    X[port_als._padded_rows(N_USERS, 1):] = 0  # the padding rows are zero
    Y[port_als._padded_rows(N_ITEMS, 1):] = 0
    lam_u = torch.from_numpy(rng.random(R_u).astype(np.float32))
    lam_i = torch.from_numpy(rng.random(R_i).astype(np.float32))
    R1u, R1i = up.n_sys_rows, ip.n_sys_rows
    want = k12.implicit_objective(X[:R1u], Y[:R1i], up, lam_u[:R1u], lam_i[:R1i], 0.5,
                                  compute_dtype=cdt)
    parts = []
    for s in range(S):
        r0, r1 = user.bounds[s : s + 2]
        i0, i1 = item.bounds[s : s + 2]
        parts.append((X[r0:r1], Y, user.packs[s], lam_u[r0:r1], Y[i0:i1], lam_i[i0:i1]))
    k12.LAUNCHES.reset()
    got = torch.zeros(1)
    k12.implicit_objective_shards(parts, k12.gramian(X[:R1u]), k12.gramian(Y[:R1i]), 0.5, got,
                                  compute_dtype=cdt)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)
    counts = k12.LAUNCHES.snapshot()
    name = "implicit_objective_shard_bf16_plain" if cdt == "bfloat16" else "implicit_objective_shard_plain"
    assert counts[name] == S and counts["implicit_objective_finish_plain"] == 1
