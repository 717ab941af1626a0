"""Host time of the K14, K15, K3 and K9m wrappers of two checkouts of the port, part by part; K13a's, K13b's and K2's times and bits; K11a's times by block; K1's and K1-bf16's times, A and b at rank 32.

    python3 compare_wrappers.py OLD_ROOT NEW_ROOT [--out FILE]

Each root is a checkout of this repository (for example one unpacked by
``git archive``). The measurement of a checkout runs in a process of its
own that imports ``predictionio_tpu_torch`` from that root, in the order
old, new, new, old, so a drift of the card's clocks or of the host's load
shows as a gap between the two runs of one checkout. Each run times seven
calls on one card with ``chip_smoke.py``'s ``host_breakdown`` (the host
side of 100 calls queued behind a spin kernel, the whole call and then
each part: allocation, device switch, stream lookup, library lookup, the
ctypes call, the error check and launch counter, the plan) and its CUDA
event times (``time_ms``, ``device_ms``):

- K14 at R3's shape (the 26,744 x 32 catalog, Q = 16) through the Similar
  Product host path's launch (``SimilarityScorer.sums``; a checkout without
  shard tables: the free ``cosine_sum`` the scorer called);
- K14s on a 4-shard mesh of the card at Q = 8 (``SimilarityScorer.sums``;
  without shard tables: ``cosine_sum`` once per shard into its block);
- K15a at 3n's shape (50,000 x 3, C = 4, ``naive_bayes_fit``);
- K15s's fit of the same rows on that mesh (``naive_bayes_fit_shards``);
- K3 at the serving shape (B = 128, n = 16, the 26,744 x 32 catalog,
  ``topn_packed``);
- K3s at that shape on the 4-shard mesh, the query rows uploaded before:
  the launch ``ServingFactors(mesh)`` makes per batch (a checkout without
  shard tables: ``topn_packed`` once per shard into its block of one
  result, as its ``topn_packed_device`` did);
- K9m at S = 4, L = n = 64 (the int8 mesh deployment's shape), B = 128, on
  the retriever's ``[S, B, 2L]`` buffer as the retriever calls it (into
  its ``out``; a checkout without ``out``: through the ``[B, S, 2, L]``
  view the retriever built a batch);
- K15b at 3n's model (50,000 x 3, C = 4) on B = 2,048 and B = 64 rows
  already on the card (``naive_bayes_scores``);
- K15s's scores of the 2,048 rows on the 4-shard mesh, the rows uploaded
  before: the launch ``predict_naive_bayes(mesh=)`` makes per batch (a
  checkout without shard tables: ``naive_bayes_scores`` once per shard
  into its block of one result, as its ``predict_naive_bayes`` did).

Then K13a (``normal_eq_variants``, V = 2) at ranks 8 and 16 and K1
(``normal_eq``) at k = 8, 16 and 32 on the user side of 3e's fold 0
itself: ``chip_smoke.py``'s ML-20M-shaped ratings as its ``EventColumns``,
fold 0's training ratings drawn as ``DataSource.read_eval`` draws them
(made once by this process, in a scratch directory, and packed by each
checkout), the counter side the seeded initial factors of that rank. Each
gives its CUDA event time and device time and a digest of A's lower
triangle and of b, and a digest of b alone. On the first run's systems
(V = 2 at k = 8, 16 and 32, saved by that run and read by the others, so
every run solves the same systems), K13b (``spd_solve_variants``) and K2
(``spd_solve`` on variant 0, with the telemetry sums), each explicit and
with a Gramian G: times and a digest of X (and of K2's sums). The
comparison fails where the two checkouts' digests differ, except A at
k = 32 (K1's warp-MMA form), where b's digest is compared and A's distance
is measured on phase 3's sides (below).

Then K1 and K1-bf16 (``normal_eq``) on phase 3's user and item sides
(``chip_smoke.py``'s ML-20M-shaped ratings through ``build_host_wire`` and
``device_pack_from_wire``, made once by this process and packed by each
checkout) at rank 32, explicit and implicit (alpha 1), against seeded
standard-normal factors over sqrt(32): device time, a digest of b, and A's
largest distance from the first run's A over the row's scale (its largest
diagonal entry). The comparison fails where b's digest differs from the
first run's, or where A lies outside chip_smoke.py's K1_RTOL (1e-4 of the
row's scale, plus 1e-6) of the first run's in any row.

Last, K11a (``subspace_accumulate``) at 3p's shape: the user side of
``chip_smoke.py``'s ML-20M-shaped ratings (made once by this process),
rank 64, b = 8, implicit, seeded factors. Its time at block 0, block 1 and
the last block (a checkout that carries the score forms d over all k
columns at block 0 and carries it after; one that does not forms it in
every block), the mean a launch over the half-step, and one whole
half-step of K11a and K11b (``_solve_side_subspace``), whose factors every
run saves; the comparison fails where a run's factors are not within the
CPU tests' tolerance (rtol 1e-5, atol 1e-6) of the first run's.

Needs one CUDA card. Prints one JSON line a run and the card's name and
power limit; ``--out`` also writes every run to a JSON file.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def load_chip_smoke():
    """This checkout's chip_smoke.py (the measuring code), whatever root
    the port is imported from."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def measure(root: str, fold0: str) -> dict:
    """The wrappers' host breakdowns and times, and K13a's and K1's times
    and digests on ``fold0`` (an ``.npz`` of fold 0's training ratings), on
    the port at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import merge_topn as k9m
    from predictionio_tpu_torch.ops import naive_bayes as k15
    from predictionio_tpu_torch.ops import similarity as k14
    from predictionio_tpu_torch.ops import topn as k3
    from predictionio_tpu_torch.ops.als import ServingFactors
    from predictionio_tpu_torch.parallel.mesh import Mesh, cut_rows

    cs = load_chip_smoke()
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    factors = rng.standard_normal((cs.ML20M_ITEMS, cs.RANK)).astype(np.float32)
    mesh = Mesh([device] * 4, {"data": 4})
    sc1 = k14.SimilarityScorer(factors, device=device)
    scS = k14.SimilarityScorer(factors, mesh=mesh)
    q16 = torch.from_numpy(sc1.normed[rng.integers(0, cs.ML20M_ITEMS, 16)]).to(device)
    q8 = q16[:8].contiguous()
    if hasattr(scS, "sums"):  # shard tables: the scorer's device part
        k14_one, k14_mesh = (lambda: sc1.sums(q16)), (lambda: scS.sums(q8))
    else:  # before shard tables: one cosine_sum a shard
        rows = scS._shards[0].shape[0]

        def k14_one():
            return k14.cosine_sum(q16, sc1._shards[0])

        def k14_mesh():
            sums = torch.empty(rows * 4, dtype=torch.float32, device=device)
            for s, y in enumerate(scS._shards):
                k14.cosine_sum(q8, y, out=sums[s * rows:(s + 1) * rows])
    labels, features = cs.bench_classification_data()
    X = torch.from_numpy(features).to(device)
    y = torch.from_numpy(labels.astype(np.int32)).to(device)
    bounds = k15.fit_shard_bounds(cs.CLS_N, cs.CLS_C, cs.CLS_F, 4)
    Xs, ys = cut_rows(mesh, features, bounds), cut_rows(mesh, labels.astype(np.int32), bounds)
    k3_one, k3_mesh = k3_calls(cs, rng, device, mesh, factors, k3, ServingFactors)
    k9m_call = k9m_of(rng, device, k9m)
    k15b_2048, k15b_64, k15s_scores = k15b_calls(cs, device, X, y, k15)
    calls = {
        "K14, the host path's launch, Q = 16": (k14, k14_one),
        "K14s device part, 4 shards, Q = 8": (k14, k14_mesh),
        "K15a naive_bayes_fit": (k15, lambda: k15.naive_bayes_fit(X, y, cs.CLS_C, 1.0)),
        "K15s naive_bayes_fit_shards, 4 shards": (
            k15, lambda: k15.naive_bayes_fit_shards(Xs, ys, cs.CLS_C, 1.0, device)),
        "K3 topn_packed, B = 128": (k3, k3_one),
        "K3s device part, 4 shards, B = 128": (k3, k3_mesh),
        "K9m merge_topn, S = 4, L = n = 64, B = 128": (k9m, k9m_call),
        "K15b naive_bayes_scores, B = 2,048": (k15, k15b_2048),
        "K15b naive_bayes_scores, B = 64": (k15, k15b_64),
        "K15s scores device part, 4 shards, B = 2,048": (k15, k15s_scores),
    }
    out = {}
    for name, (module, fn) in calls.items():
        # the parts this checkout has (an older one may lack a helper)
        parts = [p for p in cs.wrapper_parts(module) if hasattr(p[1], p[2])]
        out[name] = {"host_us": cs.host_breakdown(fn, parts), "ms": cs.time_ms(fn),
                     "device_ms": cs.device_ms(fn, calls=50)}
    data_dir = os.path.dirname(fold0)
    return {"root": os.path.abspath(root), "package": k14.__file__, "card": cs.card_line(),
            "calls": out, "fold0_users": k13a_fold0(cs, device, fold0),
            "k11a_3p_users": k11a_3p(cs, device, data_dir),
            "k1_phase3_rank32": k1_phase3(cs, device, data_dir)}


def k15b_calls(cs, device, X, y, k15):
    """K15b at B = 2,048 and 64 under 3n's model, and the device part of
    K15s's scores of the 2,048 rows on 4 shards of the card."""
    import numpy as np
    import torch

    fit = k15.naive_bayes_fit(X, y, cs.CLS_C, 1.0)
    pi, theta = fit.pi.contiguous(), fit.theta.contiguous()
    Q = X[:cs.CLS_QUERIES].contiguous()
    Q64 = X[:64].contiguous()
    bounds = np.linspace(0, cs.CLS_QUERIES, 5).astype(int)
    out = torch.empty(cs.CLS_QUERIES, dtype=torch.int32, device=device)
    if hasattr(k15, "naive_bayes_scores_table"):  # one launch over the shard table
        table = [k15.ScoresShard(Q[a:b], out[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]

        def shards():
            k15.naive_bayes_scores_table(table, pi, theta)
    else:  # before shard tables: one launch a shard
        parts = [(Q[a:b], out[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]

        def shards():
            for Qi, oi in parts:
                k15.naive_bayes_scores(Qi, pi, theta, out=oi)
    return (lambda: k15.naive_bayes_scores(Q, pi, theta)), \
        (lambda: k15.naive_bayes_scores(Q64, pi, theta)), shards


def fold0_ratings(cs, path: str) -> None:
    """Fold 0's training ratings of 3e (``chip_smoke.ml20m_event_columns``,
    split as ``DataSource.read_eval`` splits them) into ``path``."""
    import numpy as np

    cols = cs.ml20m_event_columns()
    fold_of = np.random.default_rng(cs.EVAL_SEED).integers(0, cs.EVAL_K, size=cols.n)
    train = fold_of != 0
    np.savez(path, user_idx=cols.entity_idx[train], item_idx=cols.target_idx[train],
             ratings=cols.values[train], n_users=len(cols.entity_index),
             n_items=len(cols.target_index))


def digest(*tensors) -> str:
    """A digest of the tensors' bytes, in order."""
    h = hashlib.blake2b(digest_size=16)
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def k13a_fold0(cs, device, fold0: str) -> dict:
    """K13a (V = 2) at ranks 8 and 16 and K1 at k = 8, 16 and 32 on fold 0's
    user side: times, digests of A's lower triangle and b, and of b."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import grid as k13
    from predictionio_tpu_torch.ops import normal_eq as k1

    with np.load(fold0) as z:
        u, i, r = z["user_idx"], z["item_idx"], z["ratings"]
        n_u, n_i = int(z["n_users"]), int(z["n_items"])
    side = als.pack_segments(u, i, r, n_u, als.auto_segment_length(u, n_u, 128))
    R_u, R_i = als._padded_rows(n_u, 1), als._padded_rows(n_i, 1)
    up = als.device_pack(side, R_u, R_i, device)
    out = {"ratings": int(len(r)), "segment_length": int(up.cols.shape[-1])}
    for k in (8, 16, 32):
        _, Y0 = als._factor_init_host(n_u, n_i, als.ALSConfig(rank=k, seed=cs.EVAL_SEED), 1)
        low = torch.tril_indices(k, k, device=device)
        Y1 = torch.from_numpy(Y0).to(device)
        calls = {f"K1 normal_eq, k = {k}": lambda Y1=Y1: k1.normal_eq(Y1, up)}
        if k < 32:
            Y = torch.from_numpy(np.stack([Y0, Y0 * np.float32(0.5)])).to(device)
            calls[f"K13a normal_eq_variants, rank {k}, V = 2"] = lambda Y=Y: k13.normal_eq_variants(
                Y, up)
        for name, fn in calls.items():
            A, b = fn()
            torch.cuda.synchronize()
            out[name] = {"ms": cs.time_ms(fn, iters=20, warmup=2),
                         "device_ms": cs.device_ms(fn, calls=10),
                         "digest": digest(A[..., low[0], low[1]], b), "b_digest": digest(b)}
            del A, b
        out.update(solve_fold0(cs, device, k, Y0, up, side, n_u, R_u, os.path.dirname(fold0)))
    return out


def solve_fold0(cs, device, k, Y0, up, side, n_u, R_u, data_dir):
    """K13b (V = 2) and K2 (variant 0, with its telemetry sums) on fold 0's
    user systems at rank k, explicit and with each variant's Gramian:
    times and digests of X. The systems are the first run's K13a systems
    (saved in ``data_dir``), so every run solves the same ones."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import grid as k13
    from predictionio_tpu_torch.ops import spd_solve as k2

    Yv = np.stack([Y0, Y0 * np.float32(0.5)])
    systems = os.path.join(data_dir, f"fold0_systems_k{k}.npz")
    if not os.path.exists(systems):
        A, b = k13.normal_eq_variants(torch.from_numpy(Yv).to(device), up)
        np.savez(systems, A=A.cpu().numpy(), b=b.cpu().numpy())
    with np.load(systems) as z:
        A, b = torch.from_numpy(z["A"]).to(device), torch.from_numpy(z["b"]).to(device)
    lam = torch.from_numpy(np.stack([
        als._lam_obs_host(side.counts, n_u, R_u, als.ALSConfig(reg=reg))[0] for reg in (0.05, 0.5)
    ])).to(device)
    obs = torch.from_numpy(als._lam_obs_host(side.counts, n_u, R_u, als.ALSConfig())[1]).to(device)
    X0 = torch.from_numpy(np.random.default_rng(k).standard_normal((2, R_u, k)).astype(np.float32)
                          * np.float32(0.1)).to(device)
    G = torch.from_numpy(np.einsum("vnk,vnj->vkj", Yv.astype(np.float64), Yv)
                         .astype(np.float32)).to(device)
    sums = torch.zeros(2, dtype=torch.float32, device=device)
    out = {}
    for form, Gv in (("", None), (", with G", G)):
        calls = {
            f"K13b spd_solve_variants, k = {k}, V = 2{form}": (
                lambda Gv=Gv: k13.spd_solve_variants(A, b, lam, obs, X0, Gv)),
            f"K2 spd_solve, k = {k}{form}": (
                lambda Gv=Gv: k2.spd_solve(A[0], b[0], lam[0], obs, X0[0], sums,
                                           None if Gv is None else Gv[0])),
        }
        for name, fn in calls.items():
            X = fn()
            torch.cuda.synchronize()
            parts = (X, sums) if name.startswith("K2") else (X,)
            out[name] = {"ms": cs.time_ms(fn, iters=20, warmup=2),
                         "device_ms": cs.device_ms(fn, calls=10), "digest": digest(*parts)}
    return out


def ml20m_user_ratings(cs, path: str) -> None:
    """``chip_smoke.py``'s ML-20M-shaped ratings into ``path``."""
    import numpy as np

    u, i, r = cs.ml20m_ratings()
    np.savez(path, u=u, i=i, r=r)


def k11a_3p(cs, device, data_dir: str) -> dict:
    """K11a at 3p's shape (the user side, rank 64, b = 8, implicit) by block,
    the mean a launch over the half-step, and one half-step of K11a and
    K11b, whose factors go to a file in ``data_dir`` (named in the result)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import subspace as k11

    with np.load(os.path.join(data_dir, "ml20m.npz")) as z:
        u, i, r = z["u"], z["i"], z["r"]
    k, b = cs.SUB_RANK, cs.SUB_BLOCK
    nb = k // b
    side = als.pack_segments(u, i, r, cs.ML20M_USERS, als.auto_segment_length(u, cs.ML20M_USERS, 128))
    R_u, R_i = als._padded_rows(cs.ML20M_USERS, 1), als._padded_rows(cs.ML20M_ITEMS, 1)
    up = als.device_pack(side, R_u, R_i, device)
    g = np.random.default_rng(64)
    Y = torch.from_numpy((np.abs(g.standard_normal((R_i, k))) / np.sqrt(k)).astype(np.float32)).to(device)
    X = torch.from_numpy((g.standard_normal((R_u, k)) / np.sqrt(k)).astype(np.float32)).to(device)
    cfg = als.ALSConfig(rank=k, reg=cs.REG, implicit_prefs=True, solver="subspace", block_size=b)
    lam, obs = (torch.from_numpy(a).to(device) for a in als._lam_obs_host(
        side.counts, cs.ML20M_USERS, R_u, cfg))
    Yh = Y.cpu().numpy().astype(np.float64)
    G = torch.from_numpy((Yh.T @ Yh).astype(np.float32)).to(device)
    if hasattr(k11, "CarryBuffers"):  # block 0 forms the score, later blocks carry it
        score, delta = k11.CarryBuffers([up], b).views(up)
        Xs = X.clone()
        k11.subspace_block_solve(*k11.subspace_accumulate(Y, Xs, up, 0, b, True, cs.ALPHA,
                                                          "float32", score),
                                 Xs, lam, obs, 0, G, delta=delta)
        calls = {
            "block0": lambda: k11.subspace_accumulate(Y, X, up, 0, b, True, cs.ALPHA, "float32",
                                                      score),
            "block1": lambda: k11.subspace_accumulate(Y, Xs, up, b, b, True, cs.ALPHA, "float32",
                                                      score, delta),
            "last": lambda: k11.subspace_accumulate(Y, Xs, up, k - b, b, True, cs.ALPHA, "float32",
                                                    score, delta),
        }
    else:  # every block forms d over all k columns
        calls = {name: (lambda s0=s0: k11.subspace_accumulate(Y, X, up, s0, b, True, cs.ALPHA))
                 for name, s0 in (("block0", 0), ("block1", b), ("last", k - b))}
    out = {name: {"ms": cs.time_ms(fn, iters=20, warmup=2), "device_ms": cs.device_ms(fn, calls=10)}
           for name, fn in calls.items()}
    out["mean"] = {key: (out["block0"][key] + (nb - 2) * out["block1"][key] + out["last"][key]) / nb
                   for key in ("ms", "device_ms")}

    def half_step():
        return als._solve_side_subspace(X.clone(), Y, G, up, lam, obs, cs.ALPHA, True, b)

    factors = half_step().cpu().numpy()
    out["half_step"] = {"ms": cs.time_ms(half_step, iters=5, warmup=1)}
    path = os.path.join(data_dir, f"half_step_{os.getpid()}.npy")
    np.save(path, factors)
    out["factors"] = path
    return out


def k1_phase3(cs, device, data_dir: str) -> dict:
    """K1 and K1-bf16 at rank 32 on phase 3's user and item sides (the
    ratings of ``ml20m.npz`` in ``data_dir``), explicit and implicit: device
    ms, b's digest, and A's distance from the first run's A (saved in
    ``data_dir`` by that run)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import normal_eq as k1

    with np.load(os.path.join(data_dir, "ml20m.npz")) as z:
        u, i, r = z["u"], z["i"], z["r"]
    k = cs.RANK
    config = als.ALSConfig(rank=k, iterations=cs.SWEEPS, reg=cs.REG)
    wire = als.build_host_wire(u, i, r, cs.ML20M_USERS, cs.ML20M_ITEMS, config)
    up, ip = als.device_pack_from_wire(wire, device)
    g = np.random.default_rng(32)
    X = torch.from_numpy((g.standard_normal((up.n_sys_rows, k)) / np.sqrt(k)).astype(np.float32)).to(device)
    Y = torch.from_numpy((g.standard_normal((ip.n_sys_rows, k)) / np.sqrt(k)).astype(np.float32)).to(device)
    low = torch.tril_indices(k, k, device=device)
    out = {"segment_length": {"user": int(up.cols.shape[-1]), "item": int(ip.cols.shape[-1])}}
    for side, factors, pack in (("user", Y, up), ("item", X, ip)):
        for compute_dtype in ("float32", "bfloat16"):
            for implicit in (False, True):
                name = f"{side} {compute_dtype} {'implicit' if implicit else 'explicit'}"

                def fn(factors=factors, pack=pack, implicit=implicit, compute_dtype=compute_dtype):
                    return k1.normal_eq(factors, pack, implicit, cs.ALPHA, compute_dtype)

                A, b = fn()
                torch.cuda.synchronize()
                entry = {"device_ms": cs.device_ms(fn, calls=10), "b_digest": digest(b)}
                lower = A[:, low[0], low[1]]
                first = os.path.join(data_dir, f"phase3_A_{name.replace(' ', '_')}.npy")
                if not os.path.exists(first):
                    np.save(first, lower.cpu().numpy())
                A0 = torch.from_numpy(np.load(first)).to(device)
                diag = A0[:, (low[0] == low[1]).nonzero()[:, 0]].amax(dim=1)
                dA = (lower - A0).abs().amax(dim=1)
                entry["max_dA_over_row_scale"] = (dA / diag.clamp_min(1e-30)).max().item()
                entry["max_dA_over_limit"] = (dA / (1e-6 + cs.K1_RTOL * diag)).max().item()
                out[name] = entry
                del A, b, lower, A0
    return out


def k3_calls(cs, rng, device, mesh, factors, k3, ServingFactors):
    """K3's and K3s's calls at B = 128, n = 16, the query rows uploaded."""
    import numpy as np
    import torch

    users = rng.standard_normal((128, cs.RANK)).astype(np.float32)
    one = ServingFactors(users, factors, device=device)
    sharded = ServingFactors(users, factors, mesh=mesh)
    qd = torch.from_numpy(users).to(device)
    if hasattr(sharded, "_place"):  # shard tables: one launch per device
        placed = sharded._place(users)
        return (lambda: k3.topn_packed(qd, one._if_dev, 16)), (lambda: sharded._launch(placed, 16))
    shards = [qd[s * 32:(s + 1) * 32].contiguous() for s in range(4)]

    def per_shard():
        packed = torch.empty((128, 32), dtype=torch.float32, device=device)
        for s, qs in enumerate(shards):
            k3.topn_packed(qs, sharded._if_dev, 16, out=packed[s * 32:(s + 1) * 32])
        return packed

    return (lambda: k3.topn_packed(qd, one._if_dev, 16)), per_shard


def k9m_of(rng, device, k9m):
    """K9m's call at S = 4, L = n = 64, B = 128 on a [S, B, 2L] buffer of
    sorted candidate lists, as the retriever makes it."""
    import inspect

    import numpy as np
    import torch

    S, B, L = 4, 128, 64
    scores = -np.sort(-rng.standard_normal((S, B, L)).astype(np.float32), axis=2)
    ids = (np.arange(S)[:, None, None] * 10_000 + rng.integers(0, 10_000, (S, B, L))).astype(np.int32)
    cand = torch.from_numpy(np.concatenate([scores, ids.view(np.float32)], axis=2)).to(device)
    if "out" in inspect.signature(k9m.merge_topn).parameters:
        out = torch.empty((B, 2 * L), dtype=torch.float32, device=device)
        return lambda: k9m.merge_topn(cand, L, out=out)
    return lambda: k9m.merge_topn(cand.permute(1, 0, 2).unflatten(2, (2, L)), L)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="*", help="OLD_ROOT NEW_ROOT")
    parser.add_argument("--out", help="write every run to this JSON file")
    parser.add_argument("--measure", help=argparse.SUPPRESS)  # one run, in its own process
    parser.add_argument("--fold0", help=argparse.SUPPRESS)  # the runs' fold 0 ratings
    args = parser.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure, args.fold0)), flush=True)
        return 0
    if len(args.roots) != 2:
        parser.error("give OLD_ROOT and NEW_ROOT")
    old, new = args.roots
    runs = []
    with tempfile.TemporaryDirectory() as scratch:
        fold0 = os.path.join(scratch, "fold0.npz")
        cs = load_chip_smoke()
        fold0_ratings(cs, fold0)
        ml20m_user_ratings(cs, os.path.join(scratch, "ml20m.npz"))
        for label, root in (("old", old), ("new", new), ("new", new), ("old", old)):
            done = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root,
                                   "--fold0", fold0], capture_output=True, text=True, timeout=900)
            if done.returncode != 0:
                sys.stderr.write(done.stdout + done.stderr)
                raise SystemExit(f"compare_wrappers: the run of {root} failed ({done.returncode})")
            run = json.loads(done.stdout.strip().splitlines()[-1])
            run["label"] = label
            runs.append(run)
            print(f"{label} " + json.dumps(run), flush=True)
        # the half-step's factors of every run against the first run's, at
        # the CPU tests' tolerance (tests/test_torch_subspace.py)
        import numpy as np

        first = np.load(runs[0]["k11a_3p_users"]["factors"])
        for run in runs:
            got = np.load(run["k11a_3p_users"]["factors"])
            ratio = float(np.max(np.abs(got - first) / (1e-6 + 1e-5 * np.abs(first))))
            run["k11a_3p_users"]["factors_vs_first_run"] = ratio
            if ratio > 1.0:
                raise SystemExit(f"compare_wrappers: the {run['label']} run's half-step factors are "
                                 f"{ratio:.3g}x the tolerance from the first run's")
        print("K11a's half-step at 3p's shape: every run's factors within rtol 1e-5, atol 1e-6 of "
              "the first run's (largest share of the tolerance "
              f"{max(run['k11a_3p_users']['factors_vs_first_run'] for run in runs):.3g})", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    print(runs[-1]["card"], flush=True)
    # K13a's and K1's bits: every run's digests must be the same, but for A
    # at rank 32 (K1's warp-MMA form), held to K1_RTOL of the first run's
    rank32 = [name for name in runs[0]["fold0_users"] if name.startswith("K1 normal_eq, k = 32")]
    differ = [name for name, got in runs[0]["fold0_users"].items() if isinstance(got, dict) and
              name not in rank32 and
              len({run["fold0_users"][name]["digest"] for run in runs}) != 1]
    differ += [name for name in rank32
               if len({run["fold0_users"][name]["b_digest"] for run in runs}) != 1]
    if differ:
        raise SystemExit(f"compare_wrappers: A's lower triangle, b or X differ between the runs: "
                         f"{differ}")
    print("K13a and K1 on fold 0's user side: A's lower triangle and b bit for bit in every run "
          "(K1 at k = 32: b); K13b's and K2's X (and K2's sums) too", flush=True)
    phase3 = [name for name in runs[0]["k1_phase3_rank32"] if name != "segment_length"]
    b_differ = [name for name in phase3
                if len({run["k1_phase3_rank32"][name]["b_digest"] for run in runs}) != 1]
    outside = [(run["label"], name, run["k1_phase3_rank32"][name]["max_dA_over_limit"])
               for run in runs for name in phase3
               if run["k1_phase3_rank32"][name]["max_dA_over_limit"] > 1.0]
    if b_differ or outside:
        raise SystemExit(f"compare_wrappers: K1 at rank 32 on phase 3's sides: b differs in "
                         f"{b_differ}; A outside K1_RTOL of the first run's: {outside}")
    print("K1 and K1-bf16 at rank 32 on phase 3's sides: b bit for bit in every run; A within "
          "K1_RTOL of the first run's (largest share of the limit "
          f"{max(run['k1_phase3_rank32'][n]['max_dA_over_limit'] for run in runs for n in phase3):.3g})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
