#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``predictionio_tpu_torch``) on
one NVIDIA GPU: the quickest proof that the port builds and serves there.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero:

1. Header: the card's name and power limit (nvidia-smi), the torch/CUDA
   versions, and the build of every kernel from ``csrc/`` (one nvcc per
   source, all started together).
2. Kernels: K3 (``ops/topn.py``, ``csrc/topn.cu``) against its plain twin
   on the card, at the full-width serving shape (N=26,744 items, rank 32,
   B in {8, 32, 128}, n=16) and at edge shapes (n=1, n=N, n > the tile,
   ragged catalogs, rank above the staging chunk, exact ties from
   duplicated item rows). Scores agree to rtol 1e-5 / atol 1e-6 (the two
   sum in different orders); ids are equal except inside near-tie runs,
   where the id sets agree; with exact ties (integer-valued factors, whose
   sums are exact in any order) ids and scores are equal. Times: the
   kernel, the plain twin, and one library call for the same function
   (``torch.topk(q @ Y.T, n)``, a yardstick the port never calls), each
   by CUDA events over many calls, beside the bound.
3. Slice: an ML-20M-shaped model (138,493 users x 26,744 items, rank 32,
   random factors from ``--seed``) is saved with ``save_model`` and served
   by ``tools.cli deploy --device cuda`` (max_batch 128, 2 ms window). 32
   concurrent clients on keep-alive connections send 320
   ``POST /queries.json`` (mostly num=10, some num 1..40, 4 unknown
   users); then unknown users are sent one at a time. Every answer is held
   against the plain twin on the card. K3 must launch once per served
   batch that held a known user, never for a batch of unknown users only,
   and the plain twin's count must stay 0. Latency, qps and batch fill are
   printed for the record, beside the card; the clients share the
   server's interpreter, so they are a floor of what the server can do.
4. The ``kernels`` JSON line, the card line, then the last line
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


def kernel_device_ms(fn, calls: int = 50):
    """Device time per call of each of K3's two CUDA kernels, from
    torch.profiler ({} when the profiler records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for name in ("tile_topm", "merge_lists"):
            if name in ev.key:
                us = getattr(ev, "device_time_total", None)
                us = us if us is not None else ev.cuda_time_total
                out[name] = out.get(name, 0.0) + us / 1000.0 / calls
    return out


def bound(B: int, N: int, k: int, n: int):
    """(bound_ms, bound_by): bytes each read or written once over the
    memory rate vs the product's fp32 operations over the fp32 peak."""
    nbytes = 4 * (B * k + N * k + B * 2 * n)
    flops = 2 * B * N * k
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


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
        dev_ms = kernel_device_ms(lambda: topn_packed(q, Yd, n))
        b_ms, b_by = bound(B, ML20M_ITEMS, RANK, n)
        rows.append({
            "B": B, "N": ML20M_ITEMS, "k": RANK, "n": n,
            "ms": (k_ms + k_ms2) / 2, "ms_runs": [k_ms, k_ms2],
            "device_ms": sum(dev_ms.values()) if dev_ms else None,
            "device_ms_by_kernel": dev_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": b_ms, "bound_by": b_by,
        })
    print("k3_timing " + json.dumps(rows), flush=True)
    return max(errs), rows


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


def slice_phase(rng, device, workdir):
    """Serve the ML-20M-shaped model through the CLI; returns (K3
    launches on the main path, serving stats)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models.recommendation.engine import (
        ALSAlgorithmParams,
        als_model_from_numpy,
    )
    from predictionio_tpu_torch.ops.topn import (
        LAUNCHES,
        check_topn_agreement,
        topn_packed_plain,
    )
    from predictionio_tpu_torch.tools import cli
    from predictionio_tpu_torch.utils.serialize import save_model

    scale = 1.0 / np.sqrt(RANK)
    uf = rng.normal(0.0, scale, size=(ML20M_USERS, RANK)).astype(np.float32)
    itf = rng.normal(0.0, scale, size=(ML20M_ITEMS, RANK)).astype(np.float32)
    model = als_model_from_numpy(
        uf, itf,
        [f"u{i}" for i in range(ML20M_USERS)],
        [f"i{j}" for j in range(ML20M_ITEMS)],
        ALSAlgorithmParams(rank=RANK),
    )
    path = os.path.join(workdir, "ml20m_shape.npz")
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
        unknown_at = set(rng.choice(n_queries, size=4, replace=False).tolist())
        for i in unknown_at:
            users[i] = f"nobody{i}"

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
        if res.get("modelVersion") != "ml20m_shape":
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
        check_topn_agreement(got_s, got_i, ref_s[i:i + 1, :num], ref_i[i:i + 1, :num],
                             RTOL, ATOL, q=q_np[i:i + 1], Y=itf)
    lat = np.sort([a[1] for a in answers]) * 1e3
    stats = {
        "queries": n_queries, "clients": n_clients,
        "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
        "qps": n_queries / wall, "batches": batches,
        "batch_fill_mean": fill, "server_avg_ms": server_avg_ms,
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
    from predictionio_tpu_torch.ops import native, topn

    # the reference holds parity in full f32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} nvcc {native.nvcc_path()}", flush=True)
    t0 = time.perf_counter()
    sources = [topn.SOURCE]
    native.build_sources(sources)
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for {sources}", flush=True)
    for s in sources:
        for line in native.build_log(s).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas[{s}]: {line.strip()}", flush=True)
    topn.load_library()

    rng = np.random.default_rng(args.seed)
    print("phase kernels", flush=True)
    max_err, rows = kernel_phase(rng, device)
    print("phase slice", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        launches, _ = slice_phase(rng, device, workdir)

    full = rows[2]  # B=128, n=16: the full-width batch at num=10
    kernels = [{
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
