#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``predictionio_tpu_torch``) on
one NVIDIA GPU: the quickest proof that the port builds, trains and serves
there.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero:

1. Header: the card's name and power limit (nvidia-smi), the torch/CUDA
   versions, and the build of every kernel from ``csrc/`` (one nvcc per
   source, all started together).
2. K3 (``ops/topn.py``, ``csrc/topn.cu``) against its plain twin on the
   card, at the full-width serving shape (N=26,744 items, rank 32, B in
   {8, 32, 128}, n=16) and at edge shapes (n=1, n=N, n > the tile, ragged
   catalogs, rank above the staging chunk, exact ties from duplicated item
   rows). Scores agree to rtol 1e-5 / atol 1e-6 (the two sum in different
   orders); ids are equal except inside near-tie runs, where the id sets
   agree; with exact ties ids and scores are equal. Times: the kernel, the
   plain twin, and one library call for the same function
   (``torch.topk(q @ Y.T, n)``, a yardstick the port never calls), each by
   CUDA events over many calls, beside the bound.
3. Training (slice 2) on ML-20M-shaped ratings (138,493 users x 26,744
   items, 20,000,000 ratings from a copy of the bench's generator), rank
   32, 10 sweeps, reg 0.05 weighted, float32:
   a. K1 (``ops/normal_eq.py``) and K2 (``ops/spd_solve.py``) against their
      twins on the real packed sides: the first half-step, then both
      half-steps of sweep 4; K1 also on random packs and K2 on random SPD
      batches at k in {1, 7, 32, 33, 64 or 70}, both forms of each (K2 also
      against float64 numpy). Tolerances: K1 within
      1e-4 of its row's scale (a row sums up to 1.09M products in float32,
      the two forms in different orders); K2 within 1e-4 of the row's
      largest entry (one algorithm, rounded in different places).
   b. ``ALSAlgorithm.train(device)`` on the card, the main path, with every
      launch count set to 0 just before and read just after, then RMSE on
      the training ratings through K7: K1 = K2 = 2 x sweeps, K7 = one per
      1,048,576-pair chunk, every twin 0.
   c. ``train_als`` once more, with timings: the factors must be
      bit-identical to (b)'s.
   d. The same 10 sweeps with the twins, driven by this script: factors
      within 2e-3 of the largest entry and telemetry rows within rtol 2e-3
      of the kernels' (float32 rounding carried through 20 half-steps).
   e. K7 against its twin on all 20M pairs (within 1e-5 of Σ|x·y|).
   f. Times: each kernel and twin at the main path's shapes by CUDA events,
      each kernel's device time, the library call for
      K2 (``torch.cholesky_solve`` after ``torch.linalg.cholesky``), bounds,
      and the loop's device busy share (its time on the card alone over
      its wall time). Device times are CUDA-event times of calls queued
      behind a spin kernel, so the card runs them with no wait for the
      host (``device_ms``).
4. Serving: the model just trained is saved with ``save_model`` and served
   by ``tools.cli deploy --device cuda`` (max_batch 128, 2 ms window). 32
   concurrent clients on keep-alive connections send 320
   ``POST /queries.json`` (mostly num=10, some num 1..40, 4 unknown users,
   8 users without ratings, whose zero factors tie every item at 0); then
   unknown users are sent one at a time. Every answer is held against the
   plain twin on the card; users without ratings must get items 0..num-1.
   K3 must launch once per served batch that held a known user, never for
   a batch of unknown users only, and the plain twin's count must stay 0.
   Latency, qps and batch fill are printed for the record, beside the
   card; the clients share the server's interpreter, so they are a floor
   of what the server can do.
5. The ``kernels`` JSON line, the card line, then the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import http.client
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

ML20M_USERS, ML20M_ITEMS, RANK = 138_493, 26_744, 32
RTOL, ATOL = 1e-5, 1e-6


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean time per call on the current stream, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# about 50 ms at the H100's boost clock: longer than the host takes to
# enqueue any timed batch of calls here
SPIN_CYCLES = 100_000_000


def device_ms(fn, calls: int = 20) -> float:
    """Time per call on the card alone, by CUDA events: a spin kernel holds
    the stream while the host enqueues the ``calls`` calls, so they run
    back to back with no wait for the host. Raises if the spin ended
    before the host had enqueued them all. torch.profiler is not used for
    device times: on the chip machine its traces lose kernel records (the
    first of a session, more as the process ages, torch's own cuBLAS
    kernels as much as the port's)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    caught_up = start.query()
    torch.cuda.synchronize()
    if caught_up:
        raise AssertionError("the card caught up with the host: the spin is too short")
    return start.elapsed_time(end) / calls


def roofline(nbytes: float, flops: float):
    """(bound_ms, bound_by): bytes over the memory rate vs fp32 operations
    over the fp32 peak, whichever takes longer."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def bound(B: int, N: int, k: int, n: int):
    """K3's (bound_ms, bound_by): q, Y and the packed output each moved
    once vs the product's 2·B·N·k fp32 operations."""
    return roofline(4 * (B * k + N * k + B * 2 * n), 2 * B * N * k)


def kernel_phase(rng, device):
    """K3 against its plain twin on the card; returns (max_abs_err,
    per-shape timing rows)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops.als import _unpack_indices
    from predictionio_tpu_torch.ops.topn import (
        check_topn_agreement,
        topn_packed,
        topn_packed_plain,
    )

    def unpack(packed, n):
        p = packed.cpu().numpy()
        return p[:, :n], _unpack_indices(p, n)

    def compare(name, q_np, Y_np, n, exact=False):
        q = torch.from_numpy(q_np).to(device)
        Y = torch.from_numpy(Y_np).to(device)
        got = topn_packed(q, Y, n)
        ref = topn_packed_plain(q, Y, n)
        torch.cuda.synchronize()
        gs, gi = unpack(got, n)
        rs, ri = unpack(ref, n)
        if exact:
            if not (np.array_equal(gi, ri) and np.array_equal(gs, rs)):
                raise AssertionError(f"{name}: exact-tie case differs from the plain twin")
            err = 0.0
        else:
            err = check_topn_agreement(gs, gi, rs, ri, RTOL, ATOL, q=q_np, Y=Y_np)
        print(f"  {name}: B={q_np.shape[0]} N={Y_np.shape[0]} "
              f"k={Y_np.shape[1]} n={n} max_abs_err={err:.3g} ok", flush=True)
        return err

    def normal(*shape, k):
        return rng.normal(0.0, 1.0 / np.sqrt(k), size=shape).astype(np.float32)

    Y_full = normal(ML20M_ITEMS, RANK, k=RANK)
    errs = []
    for B in (8, 32, 128):
        errs.append(compare(f"full width B={B}", normal(B, RANK, k=RANK), Y_full, 16))
    errs.append(compare("n=1", normal(8, RANK, k=RANK), Y_full, 1))
    errs.append(compare("n=64 (num up to 40)", normal(128, RANK, k=RANK), Y_full, 64))
    errs.append(compare("n > tile", normal(8, RANK, k=RANK), Y_full, 1000))
    small = normal(1000, 10, k=10)
    errs.append(compare("n=N, ragged N", normal(8, 10, k=10), small, 1000))
    errs.append(compare("N < tile, B not pow2", normal(5, 10, k=10), small[:100], 100))
    errs.append(compare("rank above chunk", normal(16, 100, k=100), normal(5000, 100, k=100), 32))
    ties = rng.integers(-3, 4, size=(1000, 8)).astype(np.float32)
    ties = np.concatenate([ties, ties, ties[:300]])  # every row repeated
    q_ties = rng.integers(-3, 4, size=(16, 8)).astype(np.float32)
    for n in (16, 300, len(ties)):
        errs.append(compare(f"exact ties n={n}", q_ties, ties, n, exact=True))

    rows = []
    Yd = torch.from_numpy(Y_full).to(device)
    for B, n in ((8, 16), (32, 16), (128, 16), (128, 64)):
        q = torch.from_numpy(normal(B, RANK, k=RANK)).to(device)
        k_ms = time_ms(lambda: topn_packed(q, Yd, n))
        p_ms = time_ms(lambda: topn_packed_plain(q, Yd, n))
        l_ms = time_ms(lambda: torch.topk(q @ Yd.T, n))
        k_ms2 = time_ms(lambda: topn_packed(q, Yd, n))
        dev_ms = device_ms(lambda: topn_packed(q, Yd, n), calls=200)
        b_ms, b_by = bound(B, ML20M_ITEMS, RANK, n)
        rows.append({
            "B": B, "N": ML20M_ITEMS, "k": RANK, "n": n,
            "ms": (k_ms + k_ms2) / 2, "ms_runs": [k_ms, k_ms2],
            "device_ms": dev_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": b_ms, "bound_by": b_by,
        })
    print("k3_timing " + json.dumps(rows), flush=True)
    return max(errs), rows


ML20M_RATINGS, SWEEPS, REG = 20_000_000, 10, 0.05
PAIR_CHUNK = 1_048_576
K1_RTOL = 1e-4  # of the row's scale; a row sums up to 1.09M products
K2_RTOL = 1e-4  # of the row's largest entry
TRAIN_RTOL = 2e-3  # kernels' vs twins' 10 sweeps, of the largest entry
K7_RTOL = 1e-5  # of Σ|x·y|


def synth_ml20m(n_users, n_items, n_ratings, seed=41):
    """MovieLens-20M-shaped synthetic ratings, a copy of the bench's
    generator (``bench.py synth_ml20m``): low-rank-plus-noise scores on a
    lognormal-activity x zipf-popularity long tail, snapped to ML-20M's
    0.5-step 0.5..5.0 rating scale."""
    import numpy as np

    rng = np.random.default_rng(seed)
    k0 = 12
    U = (rng.standard_normal((n_users, k0)) / np.sqrt(k0)).astype(np.float32)
    V = (rng.standard_normal((n_items, k0)) / np.sqrt(k0)).astype(np.float32)
    u_p = rng.lognormal(0, 1.1, n_users)
    u_p /= u_p.sum()
    i_p = 1.0 / np.arange(1, n_items + 1) ** 0.9
    i_p /= i_p.sum()
    u = rng.choice(n_users, size=n_ratings, p=u_p).astype(np.int32)
    i = rng.choice(n_items, size=n_ratings, p=i_p).astype(np.int32)
    raw = np.empty(n_ratings, np.float32)
    for s in range(0, n_ratings, 4_000_000):  # chunk the 20M-row gather
        e = min(s + 4_000_000, n_ratings)
        raw[s:e] = np.einsum("nk,nk->n", U[u[s:e]], V[i[s:e]])
    scores = 3.0 + 1.3 * raw + 0.5 * rng.standard_normal(n_ratings)
    r = np.clip(np.round(scores * 2.0) / 2.0, 0.5, 5.0).astype(np.float32)
    return u, i, r


def k1_bound(pack, n_ratings: int, Y_rows: int, k: int):
    """K1's (bound_ms, bound_by) for one side: the packed planes, Y, A and
    b each moved once vs the k(k+1)/2 + k FMAs per rating that the
    symmetric A and b need (2 operations each)."""
    R = pack.n_sys_rows
    nbytes = (
        pack.cols.numel() * 8 + pack.rem.numel() * 8 + Y_rows * k * 4
        + R * (k * k + k) * 4
    )
    return roofline(nbytes, 2 * n_ratings * (k * (k + 1) // 2 + k))


def lower_triangle_bytes(k: int) -> int:
    """Bytes the card reads for the lower triangle of one row-major float32
    k x k matrix: the 32-byte sectors that hold any of its entries (exact
    when the matrix starts on a sector, as every matrix of a [R, k, k]
    batch does for k a multiple of 4)."""
    return 32 * len({
        s for i in range(k) for s in range(4 * i * k // 32, (4 * (i * k + i) + 3) // 32 + 1)
    })


def k2_bound(R: int, R_obs: int, k: int):
    """K2's (bound_ms, bound_by): lam, has_obs, X_prev and X for every row,
    the lower triangle of A (all that Cholesky reads) and b for the rows it
    solves, vs k³/3 + 2k² operations per solve."""
    nbytes = R * (4 + 1 + 8 * k) + R_obs * (lower_triangle_bytes(k) + 4 * k)
    return roofline(nbytes, R_obs * (k ** 3 / 3 + 2 * k * k))


def k7_bound(P: int, n_users: int, n_items: int, k: int):
    """K7's (bound_ms, bound_by): two ids and one result per pair and both
    factor matrices once vs 2·k operations per pair."""
    return roofline(12 * P + 4 * k * (n_users + n_items), 2 * k * P)


def check_k1(A, b, A2, b2, pack, label, errs):
    """Hold K1's A, b against the twin's A2, b2 at K1_RTOL of each row's
    scale: the largest diagonal bounds every Σ|y_i y_j| of the row,
    sqrt(Σ v² · it) every Σ|v y_i| (Cauchy-Schwarz). Returns the largest
    differences."""
    import torch

    R = pack.n_sys_rows
    diag = A2.diagonal(dim1=1, dim2=2).amax(dim=1)
    vsq = torch.zeros(R, dtype=torch.float32, device=A.device).index_add_(
        0, pack.seg_rows.reshape(-1).long(), pack.vals.square().sum(-1).reshape(-1)
    )
    ea = (A - A2).abs().amax(dim=(1, 2))
    eb = (b - b2).abs().amax(dim=1)
    if not bool((ea <= 1e-6 + K1_RTOL * diag).all()) or not bool(
        (eb <= 1e-6 + K1_RTOL * (vsq * diag).sqrt()).all()
    ):
        raise AssertionError(
            f"K1 {label}: differs from its twin (max |dA| {ea.max().item()}, "
            f"|db| {eb.max().item()})"
        )
    ea, eb = ea.max().item(), eb.max().item()
    errs["normal_eq"] = max(errs.get("normal_eq", 0.0), ea, eb)
    return ea, eb


def check_half_step(X_prev, Y, pack, lam, has_obs, label, errs):
    """K1 and K2 against their twins on one real half-step."""
    import torch

    from predictionio_tpu_torch.ops import normal_eq as k1
    from predictionio_tpu_torch.ops import spd_solve as k2

    R = pack.n_sys_rows
    A, b = k1.normal_eq(Y, pack)
    A2, b2 = k1.normal_eq_plain(Y, pack.seg_rows, pack.cols, pack.vals, pack.rem, R)
    ea, eb = check_k1(A, b, A2, b2, pack, label, errs)

    s1 = torch.zeros(2, dtype=torch.float32, device=Y.device)
    X1 = k2.spd_solve(A, b, lam, has_obs, X_prev, s1)
    X2, s2 = k2.spd_solve_plain(A, b, lam, has_obs, X_prev)
    ex = (X1 - X2).abs().amax(dim=1)
    if not bool((ex <= 1e-6 + K2_RTOL * X2.abs().amax(dim=1)).all()):
        raise AssertionError(f"K2 {label}: differs from its twin (max |dx| {ex.max().item()})")
    # Σ X² bounds both sums' rounding (the delta sum can be ~0)
    if not torch.allclose(s1, s2, rtol=K2_RTOL, atol=K2_RTOL * s2[1].item()):
        raise AssertionError(f"K2 {label}: telemetry sums {s1.tolist()} vs {s2.tolist()}")
    errs["spd_solve"] = max(errs.get("spd_solve", 0.0), ex.max().item())
    print(f"  {label}: K1 max |dA| {ea:.3g} |db| {eb:.3g}, "
          f"K2 max |dx| {ex.max().item():.3g} ok", flush=True)


def check_k1_sizes(rng, device, errs):
    """K1 on random packs at edge ranks (both of its forms: k <= 32 and
    above), with a row of many segments and an empty row, against its
    twin."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import normal_eq as k1

    for k in (1, 7, 32, 33, 70):
        n_rows, n_cols, nnz = 300, 200, 60_000
        u = rng.integers(0, n_rows, nnz).astype(np.int32)
        u[: nnz // 3] = 2  # many segments: partials and a combine
        u[u == 5] = 6  # an empty row
        i = rng.integers(0, n_cols, nnz).astype(np.int32)
        r = (rng.integers(1, 11, nnz) / 2).astype(np.float32)
        side = als.pack_segments(u, i, r, n_rows, 64, 1, 65_536)
        R, n_y = als._padded_rows(n_rows, 1), als._padded_rows(n_cols, 1)
        pack = als.device_pack(side, R, n_y, device)
        Y = torch.from_numpy(rng.normal(size=(n_y, k)).astype(np.float32)).to(device)
        A, b = k1.normal_eq(Y, pack)
        A2, b2 = k1.normal_eq_plain(Y, pack.seg_rows, pack.cols, pack.vals, pack.rem, R)
        ea, eb = check_k1(A, b, A2, b2, pack, f"k={k}", errs)
        if A[5].any() or b[5].any():
            raise AssertionError(f"K1 k={k}: an empty row is not zero")
        print(f"  K1 k={k}: {pack.plan.n_partials} partials, max |dA| {ea:.3g} "
              f"|db| {eb:.3g} ok", flush=True)


def check_k2_sizes(rng, device, errs):
    """K2 on random SPD batches at edge ranks, against its twin and float64."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import spd_solve as k2

    for k in (1, 7, 32, 33, 64):
        R = 4096
        M = rng.standard_normal((R, k, k)).astype(np.float32)
        A = np.einsum("rij,rkj->rik", M, M)
        b = rng.standard_normal((R, k)).astype(np.float32)
        lam = rng.uniform(0.5, 2.5, R).astype(np.float32)
        obs = rng.random(R) < 0.9
        Xp = rng.standard_normal((R, k)).astype(np.float32)
        t = [torch.from_numpy(a).to(device) for a in (A, b, lam, obs, Xp)]
        X1 = k2.spd_solve(*t)
        X2, _ = k2.spd_solve_plain(*t)
        x1 = X1.cpu().numpy()
        exact = np.linalg.solve(
            A.astype(np.float64) + lam[:, None, None] * np.eye(k), b[..., None].astype(np.float64)
        )[..., 0]
        exact = np.where(obs[:, None], exact, Xp)
        ex = (X1 - X2).abs().amax(dim=1)
        if not bool((ex <= 1e-6 + K2_RTOL * X2.abs().amax(dim=1)).all()):
            raise AssertionError(f"K2 k={k}: differs from its twin ({ex.max().item()})")
        np.testing.assert_allclose(x1, exact, rtol=2e-3, atol=2e-4)
        errs["spd_solve"] = max(errs.get("spd_solve", 0.0), ex.max().item())
        print(f"  K2 k={k}: max |dx| twin {ex.max().item():.3g}, "
              f"float64 {np.abs(x1 - exact).max():.3g} ok", flush=True)


def train_phase(rng, device):
    """Train the ML-20M-shaped model through the main path, check every
    kernel on it, and time them. Returns (trained ALSModel, kernel rows,
    training stats)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.models.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        Preparator,
        TrainingData,
    )
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import normal_eq as k1
    from predictionio_tpu_torch.ops import predict_pairs as k7
    from predictionio_tpu_torch.ops import spd_solve as k2
    from predictionio_tpu_torch.ops import topn as k3

    t0 = time.perf_counter()
    n_users, n_items, k = ML20M_USERS, ML20M_ITEMS, RANK
    u, i, r = synth_ml20m(n_users, n_items, ML20M_RATINGS)
    print(f"  ratings: {len(r)} in {time.perf_counter() - t0:.2f} s", flush=True)
    params = ALSAlgorithmParams(rank=k, num_iterations=SWEEPS, lambda_=REG)
    config = als.ALSConfig(rank=k, iterations=SWEEPS, reg=REG, seed=params.seed)

    # the packed sides and the start, as train_als builds them
    counts_u = np.bincount(u, minlength=n_users).astype(np.int32)
    counts_i = np.bincount(i, minlength=n_items).astype(np.int32)
    L_u = als.auto_segment_length(None, n_users, config.segment_length, counts=counts_u)
    L_i = als.auto_segment_length(None, n_items, config.segment_length, counts=counts_i)
    R_u, R_i = als._padded_rows(n_users, 1), als._padded_rows(n_items, 1)
    user_side = als.pack_segments(u, i, r, n_users, L_u, 1, config.chunk_slots)
    item_side = als.pack_segments(i, u, r, n_items, L_i, 1, config.chunk_slots)
    up = als.device_pack(user_side, R_u, R_i, device)
    ip = als.device_pack(item_side, R_i, R_u, device)
    state = als.init_factor_state_single(counts_u, counts_i, n_users, n_items, config, device=device)
    X0, Y0, lam_u, lam_i, obs_u, obs_i = state
    print(f"  packed: users L={L_u} grid {tuple(user_side.cols.shape)} groups "
          f"{up.plan.groups.shape[1]} partials {up.plan.n_partials}; items L={L_i} "
          f"grid {tuple(item_side.cols.shape)} groups {ip.plan.groups.shape[1]} "
          f"partials {ip.plan.n_partials}; heaviest item {int(counts_i.max())} ratings", flush=True)

    # a. K1 and K2 against their twins on the real sides
    errs = {}
    check_half_step(X0, Y0, up, lam_u, obs_u, "user side, first half-step", errs)
    X3, Y3, _ = als._run_iterations(X0, Y0, up, ip, lam_u, lam_i, obs_u, obs_i, 3)
    check_half_step(X3, Y3, up, lam_u, obs_u, "user side of sweep 4", errs)
    X4 = als._solve_side(X3, Y3, up, lam_u, obs_u)
    check_half_step(Y3, X4, ip, lam_i, obs_i, "item side of sweep 4", errs)
    check_k1_sizes(rng, device, errs)
    check_k2_sizes(rng, device, errs)

    # b. the main path, counted
    user_index = BiMap.int_index(f"u{n}" for n in range(n_users))
    item_index = BiMap.int_index(f"i{n}" for n in range(n_items))
    td = TrainingData(u, i, r, user_index, item_index)
    td.sanity_check()
    alg = ALSAlgorithm(params)
    pd = Preparator().prepare(device, td)
    counters = (k1.LAUNCHES, k2.LAUNCHES, k7.LAUNCHES, k3.LAUNCHES)
    for c in counters:
        c.reset()
    t = time.perf_counter()
    model = alg.train(device, pd)
    train_s = time.perf_counter() - t
    t = time.perf_counter()
    rmse = als.rmse(model.arrays, u, i, r, device=device)
    rmse_s = time.perf_counter() - t
    counts = {}
    for c in counters:
        counts.update(c.snapshot())
    n_chunks = -(-len(r) // PAIR_CHUNK)
    want = {"normal_eq": 2 * SWEEPS, "spd_solve": 2 * SWEEPS, "predict_pairs": n_chunks}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name} launched {counts[name]} times on the main path, not {n}")
    if any(counts[f"{name}_plain"] for name in ("normal_eq", "spd_solve", "predict_pairs", "topn_packed")):
        raise AssertionError(f"a plain twin ran on the main path: {counts}")
    if not (np.isfinite(model.arrays.user_factors).all() and np.isfinite(model.arrays.item_factors).all()):
        raise AssertionError("trained factors are not finite")
    if model.arrays.user_factors.shape != (n_users, k) or model.arrays.item_factors.shape != (n_items, k):
        raise AssertionError("trained factors have the wrong shape")
    if not (0.0 < rmse < 1.5):
        raise AssertionError(f"training RMSE {rmse} out of range")
    print(f"  ALSAlgorithm.train: {train_s:.2f} s, RMSE {rmse:.6f}, launches {counts}", flush=True)

    # c. again, with timings: bit-identical factors
    timings = {}
    again = als.train_als(u, i, r, n_users, n_items, config, device=device, timings=timings)
    for a, b_ in ((again.user_factors, model.arrays.user_factors), (again.item_factors, model.arrays.item_factors)):
        if not np.array_equal(a.view(np.uint32), b_.view(np.uint32)):
            raise AssertionError("two trainings from one seed differ")
    print("  second training: bit-identical factors", flush=True)

    # d. the same sweeps with the twins
    X, Y = X0, Y0
    tel = np.zeros((SWEEPS, 4), np.float64)
    t = time.perf_counter()
    for it in range(SWEEPS):
        A, b = k1.normal_eq_plain(Y, up.seg_rows, up.cols, up.vals, up.rem, R_u)
        X, sx = k2.spd_solve_plain(A, b, lam_u, obs_u, X)
        A, b = k1.normal_eq_plain(X, ip.seg_rows, ip.cols, ip.vals, ip.rem, R_i)
        Y, sy = k2.spd_solve_plain(A, b, lam_i, obs_i, Y)
        sx, sy = sx.cpu().numpy(), sy.cpu().numpy()
        tel[it] = [np.sqrt(sx[0] / X.numel()), np.sqrt(sy[0] / Y.numel()),
                   np.sqrt(sx[1] / X.numel()), np.sqrt(sy[1] / Y.numel())]
    twin_loop_s = time.perf_counter() - t
    Xt, Yt = X[:n_users].cpu().numpy(), Y[:n_items].cpu().numpy()
    dX = np.abs(Xt - model.arrays.user_factors).max()
    dY = np.abs(Yt - model.arrays.item_factors).max()
    if dX > TRAIN_RTOL * np.abs(Xt).max() or dY > TRAIN_RTOL * np.abs(Yt).max():
        raise AssertionError(f"twin training differs: max |dX| {dX}, |dY| {dY}")
    rows = np.array([[s["dx"], s["dy"], s["x_rms"], s["y_rms"]] for s in timings["sweep_telemetry"]])
    np.testing.assert_allclose(rows, tel, rtol=TRAIN_RTOL)
    print(f"  twin-driven training ({twin_loop_s:.2f} s): max |dX| {dX:.3g}, |dY| {dY:.3g}, "
          f"telemetry max rel diff {np.abs(rows / tel - 1).max():.3g} ok", flush=True)

    # e. K7 on every training pair
    Xd = torch.from_numpy(model.arrays.user_factors).to(device)
    Yd = torch.from_numpy(model.arrays.item_factors).to(device)
    ud = torch.from_numpy(u).to(device)
    idd = torch.from_numpy(i).to(device)
    k7_err = 0.0
    for s in range(0, len(u), PAIR_CHUNK):
        uc, ic = ud[s:s + PAIR_CHUNK], idd[s:s + PAIR_CHUNK]
        got = k7.predict_pairs(Xd, Yd, uc, ic)
        ref = k7.predict_pairs_plain(Xd, Yd, uc, ic)
        scale = k7.predict_pairs_plain(Xd.abs(), Yd.abs(), uc, ic)
        e = (got - ref).abs()
        if not bool((e <= 1e-6 + K7_RTOL * scale).all()):
            raise AssertionError(f"K7 differs from its twin at chunk {s // PAIR_CHUNK}")
        k7_err = max(k7_err, e.max().item())
    errs["predict_pairs"] = k7_err
    print(f"  K7 on {len(u)} pairs: max |d| {k7_err:.3g} ok", flush=True)

    # f. times at the main path's shapes, K2 with its telemetry sums
    A_u, b_u = k1.normal_eq(Y3, up)
    A_i, b_i = k1.normal_eq(X3, ip)
    A_reg = A_u + lam_u[:, None, None] * torch.eye(k, device=device)
    sums = torch.zeros(2, dtype=torch.float32, device=device)
    uc, ic = ud[:PAIR_CHUNK], idd[:PAIR_CHUNK]
    calls = {
        "normal_eq": {"user": lambda: k1.normal_eq(Y3, up), "item": lambda: k1.normal_eq(X3, ip)},
        "spd_solve": {
            "user": lambda: k2.spd_solve(A_u, b_u, lam_u, obs_u, X3, sums),
            "item": lambda: k2.spd_solve(A_i, b_i, lam_i, obs_i, Y3, sums),
        },
    }
    t_k = {n: {side: time_ms(f, iters=20, warmup=2) for side, f in c.items()} for n, c in calls.items()}
    dev = {n: {side: device_ms(f, calls=10) for side, f in c.items()} for n, c in calls.items()}
    t_k1_plain = time_ms(lambda: k1.normal_eq_plain(Y3, up.seg_rows, up.cols, up.vals, up.rem, R_u), iters=3, warmup=1)
    t_k2_plain = time_ms(lambda: k2.spd_solve_plain(A_u, b_u, lam_u, obs_u, X3), iters=3, warmup=1)
    t_k2_lib = time_ms(lambda: torch.cholesky_solve(b_u[..., None], torch.linalg.cholesky(A_reg)), iters=5, warmup=1)
    # as predict_ratings calls it: the ids checked once on the host
    def k7_call():
        return k7.predict_pairs(Xd, Yd, uc, ic, check_ids=False)

    t_k["predict_pairs"] = time_ms(k7_call, iters=50, warmup=5)
    dev["predict_pairs"] = device_ms(k7_call, calls=50)
    t_k7_plain = time_ms(lambda: k7.predict_pairs_plain(Xd, Yd, uc, ic), iters=50, warmup=5)
    bounds = {
        "normal_eq": {"user": k1_bound(up, len(r), R_i, k), "item": k1_bound(ip, len(r), R_u, k)},
        "spd_solve": {
            "user": k2_bound(R_u, int(obs_u.sum()), k),
            "item": k2_bound(R_i, int(obs_i.sum()), k),
        },
        "predict_pairs": k7_bound(PAIR_CHUNK, n_users, n_items, k),
    }

    # the loop's device busy share: its time on the card alone over its
    # wall time when the host launches it onto an idle card, as training does
    def loop():
        return als._run_iterations(X0, Y0, up, ip, lam_u, lam_i, obs_u, obs_i, SWEEPS)

    loop()
    torch.cuda.synchronize()
    t = time.perf_counter()
    loop()
    torch.cuda.synchronize()
    loop_wall_ms = (time.perf_counter() - t) * 1e3
    loop_device_ms = device_ms(loop, calls=1)
    stats = {
        "card": card_line(),
        "pack_s": timings["pack_s"], "device_put_s": timings["device_put_s"],
        "compile_s": timings["compile_s"], "device_loop_s": timings["device_loop_s"],
        "ms_per_sweep": timings["device_loop_s"] * 1e3 / SWEEPS,
        "padded_slots": timings["padded_slots"], "train_s": train_s,
        "rmse": rmse, "rmse_s": rmse_s, "telemetry": timings["sweep_telemetry"],
        "launches": counts,
        "loop_wall_ms": loop_wall_ms,
        "loop_device_ms": loop_device_ms,
        "device_busy_share": loop_device_ms / loop_wall_ms,
        "kernel_ms": t_k,
        "plain_ms": {"normal_eq_user": t_k1_plain, "spd_solve_user": t_k2_plain, "predict_pairs_chunk": t_k7_plain},
        "library_ms": {"spd_solve_user": t_k2_lib},
        "device_ms": dev, "bound": bounds,
        "bound_ms_per_sweep": sum(bounds[n][side][0] for n in ("normal_eq", "spd_solve") for side in ("user", "item")),
        "twin_loop_s": twin_loop_s,
    }
    print("training " + json.dumps(stats), flush=True)

    def row(name, source, replaces, ms, plain_ms, bnd, lib):
        return {
            "name": name, "route": "cuda", "source": f"predictionio_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": counts[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": lib,
        }

    kernels = [
        row("normal_eq", "normal_eq.cu", "predictionio_tpu/ops/als.py:481",
            t_k["normal_eq"]["user"], t_k1_plain, bounds["normal_eq"]["user"], None),
        row("spd_solve", "spd_solve.cu", "predictionio_tpu/ops/als.py:549",
            t_k["spd_solve"]["user"], t_k2_plain, bounds["spd_solve"]["user"], t_k2_lib),
        row("predict_pairs", "predict_pairs.cu", "predictionio_tpu/ops/als.py:2330",
            t_k["predict_pairs"], t_k7_plain, bounds["predict_pairs"], None),
    ]
    return model, kernels, stats


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_json(url, body=None, timeout=60.0):
    req = urllib.request.Request(
        url, data=body, method="POST" if body is not None else "GET",
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read()
    try:
        return json.loads(raw)
    except ValueError:
        return raw.decode()


def slice_phase(rng, device, workdir, model):
    """Serve the trained model through the CLI; returns (K3 launches on
    the main path, serving stats)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops.topn import (
        LAUNCHES,
        check_topn_agreement,
        topn_packed_plain,
    )
    from predictionio_tpu_torch.tools import cli
    from predictionio_tpu_torch.utils.serialize import save_model

    uf, itf = model.arrays.user_factors, model.arrays.item_factors
    unrated = np.flatnonzero(~uf.any(axis=1))
    path = os.path.join(workdir, "ml20m_trained.npz")
    save_model(path, model)

    port = free_port()
    base = f"http://127.0.0.1:{port}"
    failure = []

    def serve():
        try:
            cli.main([
                "deploy", "--model", path, "--ip", "127.0.0.1",
                "--port", str(port), "--device", str(device),
                "--max-batch", "128", "--batch-window-ms", "2.0",
            ])
        except BaseException as e:  # reported by the main thread
            failure.append(e)

    t0 = time.perf_counter()
    server_thread = threading.Thread(target=serve, daemon=True)
    server_thread.start()
    deadline = time.monotonic() + 300
    while True:
        if failure:
            raise RuntimeError("deploy failed") from failure[0]
        try:
            http_json(base + "/status.json", timeout=5)
            break
        except (urllib.error.URLError, ConnectionError):
            if time.monotonic() > deadline:
                raise RuntimeError("server did not come up within 300 s")
            time.sleep(0.2)
    print(f"  deploy (load, upload, warm, bind): {time.perf_counter() - t0:.2f} s", flush=True)

    try:
        # the main path: counts start at 0 here, after deploy's warm-up
        LAUNCHES.reset()
        n_queries, n_clients = 320, 32
        users = [f"u{u}" for u in rng.integers(0, ML20M_USERS, size=n_queries)]
        nums = np.where(rng.random(n_queries) < 0.85, 10, rng.integers(1, 41, size=n_queries))
        picked = rng.choice(n_queries, size=12, replace=False).tolist()
        unknown_at = set(picked[:4])
        for i in unknown_at:
            users[i] = f"nobody{i}"
        # users without ratings: zero factors, every item ties at 0
        unrated_at = set(picked[4:4 + min(8, len(unrated))])
        for i, row in zip(sorted(unrated_at), unrated):
            users[i] = f"u{row}"

        def client(c):
            # one keep-alive connection per client, its queries in turn
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            out = []
            try:
                for i in range(c, n_queries, n_clients):
                    body = json.dumps({"user": users[i], "num": int(nums[i])})
                    t = time.perf_counter()
                    conn.request("POST", "/queries.json", body,
                                 {"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    raw = resp.read()
                    if resp.status != 200:
                        raise AssertionError(f"query {i}: HTTP {resp.status} {raw!r}")
                    out.append((i, time.perf_counter() - t, json.loads(raw)))
            finally:
                conn.close()
            return out

        t_start = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(n_clients) as pool:
            answers = [a for part in pool.map(client, range(n_clients)) for a in part]
        wall = time.perf_counter() - t_start
        status = http_json(base + "/status.json")
        counts = LAUNCHES.snapshot()
        # one launch per served batch, except a batch of unknown users only
        # (at most one such batch per unknown query)
        batches = status["batches"]
        if not batches - len(unknown_at) <= counts["topn_packed"] <= batches or batches < 1:
            raise AssertionError(
                f"K3 launched {counts['topn_packed']} times for {batches} "
                f"served batches ({len(unknown_at)} unknown-user queries)"
            )
        launches, fill = counts["topn_packed"], status["batchFillMean"]
        server_avg_ms = status["avgServingSec"] * 1e3

        # unknown users one at a time: each is a batch of its own, which
        # must not launch K3
        unknown = ["nobody", "u-1", f"u{ML20M_USERS}", "i0"]
        for u in unknown:
            res = http_json(base + "/queries.json", json.dumps({"user": u, "num": 10}).encode())
            if res.get("itemScores") != []:
                raise AssertionError(f"unknown user {u!r} got {res}")
        status = http_json(base + "/status.json")
        counts = LAUNCHES.snapshot()
        if counts["topn_packed"] != launches:
            raise AssertionError("a batch of unknown users launched K3")
        if status["batches"] != batches + len(unknown):
            raise AssertionError(f"unexpected batch count {status['batches']}")
        if counts["topn_packed_plain"] != 0:
            raise AssertionError("the plain twin ran on the serving path")
    finally:
        try:
            http_json(base + "/stop")
        except (urllib.error.URLError, ConnectionError):
            pass
    server_thread.join(timeout=60)
    if server_thread.is_alive():
        raise RuntimeError("server did not stop after GET /stop")
    if failure:
        raise RuntimeError("server failed") from failure[0]

    # every answer against the plain twin on the card
    Yd = torch.from_numpy(itf).to(device)
    rows = [0 if i in unknown_at else int(users[i][1:]) for i in range(n_queries)]
    q_np = uf[rows]
    ref = topn_packed_plain(torch.from_numpy(q_np).to(device), Yd, 40).cpu().numpy()
    ref_s, ref_i = ref[:, :40], ref[:, 40:].copy().view(np.int32)
    for i, _, res in answers:
        num = int(nums[i])
        if res.get("modelVersion") != "ml20m_trained":
            raise AssertionError(f"modelVersion {res.get('modelVersion')!r}")
        items = res["itemScores"]
        if i in unknown_at:
            if items != []:
                raise AssertionError(f"unknown user {users[i]!r} got {items}")
            continue
        if len(items) != num:
            raise AssertionError(f"query {i}: {len(items)} items for num={num}")
        got_i = np.array([[int(x["item"][1:]) for x in items]])
        got_s = np.array([[x["score"] for x in items]])
        if i in unrated_at and got_i[0].tolist() != list(range(num)):
            raise AssertionError(f"user without ratings {users[i]!r} got {got_i[0]}")
        check_topn_agreement(got_s, got_i, ref_s[i:i + 1, :num], ref_i[i:i + 1, :num],
                             RTOL, ATOL, q=q_np[i:i + 1], Y=itf)
    lat = np.sort([a[1] for a in answers]) * 1e3
    stats = {
        "queries": n_queries, "clients": n_clients,
        "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
        "qps": n_queries / wall, "batches": batches,
        "batch_fill_mean": fill, "server_avg_ms": server_avg_ms,
        "unrated_queries": len(unrated_at),
        "k3_launches": counts["topn_packed"],
        "plain_launches": counts["topn_packed_plain"],
        "card": card_line(),
    }
    print("serving " + json.dumps(stats), flush=True)
    return counts["topn_packed"], stats


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np

    from predictionio_tpu_torch.device import resolve_device
    from predictionio_tpu_torch.ops import native, normal_eq, predict_pairs, spd_solve, topn

    # the reference holds parity in full f32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} nvcc {native.nvcc_path()}", flush=True)
    t0 = time.perf_counter()
    kernel_modules = (topn, normal_eq, spd_solve, predict_pairs)
    sources = [m.SOURCE for m in kernel_modules]
    native.build_sources(sources)
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for {sources}", flush=True)
    for s in sources:
        for line in native.build_log(s).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas[{s}]: {line.strip()}", flush=True)
    for m in kernel_modules:
        m.load_library()

    rng = np.random.default_rng(args.seed)
    print("phase kernels", flush=True)
    max_err, rows = kernel_phase(rng, device)
    print("phase train", flush=True)
    model, kernels, _ = train_phase(rng, device)
    print("phase slice", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        launches, _ = slice_phase(rng, device, workdir, model)

    full = rows[2]  # B=128, n=16: the full-width batch at num=10
    kernels += [{
        "name": "topn_packed",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/topn.cu",
        "replaces": "predictionio_tpu/ops/als.py:2354",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": full["ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": full["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
