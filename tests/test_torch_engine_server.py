"""The port's engine server (``device="cpu"``, both transports) against the
JAX package's: concurrent ``POST /queries.json`` give the JAX model's
``itemScores`` (scores to rtol 1e-5 / atol 1e-6, the two frameworks summing
in different orders; item lists equal except inside near-tie runs),
malformed queries and unknown routes give the JAX server's status codes,
and ``GET /stop`` shuts the server down. The micro-batching executor keeps
every query under thread contention and isolates a failing one."""

import concurrent.futures
import json
import sys
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.api import engine_server as jax_server
from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models.recommendation import engine as jax_engine
from predictionio_tpu.ops.als import ALSModelArrays
from predictionio_tpu_torch.api.engine_server import (
    DeployedEngine,
    EngineServer,
    ServerConfig,
    _BatchingExecutor,
)
from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.models.recommendation import engine as port_engine
from predictionio_tpu_torch.ops.topn import check_topn_agreement

RTOL, ATOL = 1e-5, 1e-6
N_USERS, N_ITEMS, RANK = 50, 120, 8
QUERIES = [
    {"user": f"u{u}", "num": n}
    for u, n in [(0, 10), (7, 3), (49, 16), (12, 40), (3, 1), (21, 10),
                 (33, 25), (8, 10)]
] + [{"user": "nobody", "num": 10}, {"user": "u7"}]
BAD_REQUESTS = [
    ("POST", "/queries.json", b"{not json"),
    ("POST", "/queries.json", b'{"usr": "u1"}'),
    ("POST", "/queries.json", b'{"num": 3}'),
    ("POST", "/queries.json", b"[1, 2]"),
    ("GET", "/queries.json", None),
    ("GET", "/no/such/route", None),
    ("POST", "/status.json", b"{}"),
]


@pytest.fixture(scope="module")
def factors():
    rng = np.random.default_rng(5)
    return (
        rng.normal(size=(N_USERS, RANK)).astype(np.float32),
        rng.normal(size=(N_ITEMS, RANK)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def jax_api(factors):
    uf, itf = factors
    model = jax_engine.ALSModel(
        arrays=ALSModelArrays(user_factors=uf, item_factors=itf),
        user_index=JaxBiMap({f"u{r}": r for r in range(N_USERS)}),
        item_index=JaxBiMap({f"i{r}": r for r in range(N_ITEMS)}),
    )
    params = jax_engine.ALSAlgorithmParams(rank=RANK, warm_max_batch=8)
    dep = jax_server.DeployedEngine(
        jax_engine.recommendation_engine(),
        JaxEngineParams(algorithm_params_list=(("als", params),)),
        types.SimpleNamespace(id="v1", engine_factory="recommendation"),
        [model],
    )
    api = jax_server.QueryAPI(
        dep, jax_server.ServerConfig(upgrade_check_interval_s=0)
    )
    yield api
    api.close()


def _port_server(factors, transport):
    uf, itf = factors
    model = port_engine.als_model_from_numpy(
        uf, itf, [f"u{r}" for r in range(N_USERS)],
        [f"i{r}" for r in range(N_ITEMS)],
    )
    engine = port_engine.recommendation_engine()
    params = port_engine.ALSAlgorithmParams(rank=RANK, warm_max_batch=8)
    ep = EngineParams(algorithm_params_list=(("als", params),))
    models = engine.prepare_deploy("cpu", ep, [model])
    dep = DeployedEngine(engine, ep, models, version="v1")
    config = ServerConfig(
        ip="127.0.0.1", port=0, transport=transport, batch_window_ms=20.0
    )
    return EngineServer(dep, config).start()


def _request(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method=method
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("transport", ["async", "threaded"])
def test_queries_statuses_and_stop_match_jax_server(factors, jax_api, transport):
    server = _port_server(factors, transport)
    port = server.port
    try:
        with concurrent.futures.ThreadPoolExecutor(len(QUERIES)) as pool:
            answers = list(pool.map(
                lambda q: _request(port, "POST", "/queries.json", json.dumps(q).encode()),
                QUERIES,
            ))
        for q, (status, raw) in zip(QUERIES, answers):
            jstatus, jpayload, _ = jax_api.handle(
                "POST", "/queries.json", body=json.dumps(q).encode()
            )
            payload = json.loads(raw)
            assert status == jstatus == 200
            assert payload["modelVersion"] == jpayload["modelVersion"] == "v1"
            got, ref = payload["itemScores"], jpayload["itemScores"]
            assert len(got) == len(ref)
            if ref:
                check_topn_agreement(
                    np.array([[x["score"] for x in got]]),
                    np.array([[int(x["item"][1:]) for x in got]]),
                    np.array([[x["score"] for x in ref]]),
                    np.array([[int(x["item"][1:]) for x in ref]]),
                    RTOL, ATOL,
                )
        status = json.loads(_request(port, "GET", "/status.json")[1])
        assert status["requestCount"] == len(QUERIES)
        assert 1 <= status["batches"] <= len(QUERIES)
        assert _request(port, "GET", "/")[0] == 200
        for method, path, body in BAD_REQUESTS:
            jstatus = jax_api.handle(method, path, body=body)[0]
            assert _request(port, method, path, body)[0] == jstatus, (method, path, body)
            assert jstatus in (400, 404)
        assert _request(port, "GET", "/stop") == (200, b"Shutting down...")
        assert server.wait_stopped(timeout=15)
        with pytest.raises(urllib.error.URLError):
            _request(port, "GET", "/status.json")
    finally:
        if not server.wait_stopped(timeout=0):
            server.shutdown()


class _Doubler:
    """A deployed-engine stand-in: serves each query as twice its value and
    fails a whole batch that holds a negative query."""

    def serve_batch(self, queries):
        if any(q < 0 for q in queries):
            raise ValueError("poison query")
        return [2 * q for q in queries]


def test_batching_executor_serves_every_query_under_contention():
    executor = _BatchingExecutor(_Doubler(), window_ms=1.0, max_batch=16, pipeline_depth=2)
    n = 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(64) as pool:
            futs = [pool.submit(executor.submit_nowait, i) for i in range(n)]
            results = [f.result(timeout=60).result(timeout=60) for f in futs]
    finally:
        sys.setswitchinterval(old)
        executor.close()
    assert results == [2 * i for i in range(n)]
    stats = executor.stats()
    assert stats["queries"] == n
    assert n / 16 <= stats["batches"] <= n


def test_batching_executor_isolates_a_poison_query():
    executor = _BatchingExecutor(_Doubler(), window_ms=50.0, max_batch=8)
    try:
        futs = [executor.submit_nowait(q) for q in [1, 2, -1, 3, 4]]
        outcomes = []
        for f in futs:
            try:
                outcomes.append(f.result(timeout=30))
            except ValueError:
                outcomes.append("error")
    finally:
        executor.close()
    assert outcomes == [2, 4, "error", 6, 8]
    with pytest.raises(RuntimeError, match="shutting down"):
        executor.submit_nowait(5)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _deploy_file_in_thread(path, port):
    """``tools.cli deploy --model path --device cpu`` on a thread; returns
    (thread, failures)."""
    import threading
    import time

    from predictionio_tpu_torch.tools import cli

    failures = []

    def serve():
        try:
            cli.main(["deploy", "--model", str(path), "--ip", "127.0.0.1",
                      "--port", str(port), "--device", "cpu",
                      "--batch-window-ms", "20"])
        except BaseException as e:  # reported by the test thread
            failures.append(e)

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    deadline = time.monotonic() + 60
    while True:
        assert not failures, failures
        try:
            _request(port, "GET", "/status.json")
            return thread, failures
        except urllib.error.URLError:
            assert time.monotonic() < deadline, "server did not come up"
            time.sleep(0.1)


@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_similarproduct_model_file_deploys_over_http(tmp_path, precision):
    """A Similar Product model file, deployed by the CLI on the CPU, answers
    as the JAX package's prepared SPModel does, and status.json reports its
    servingPrecision."""
    from predictionio_tpu.models.similarproduct import engine as jax_sp
    from predictionio_tpu_torch.models.similarproduct import engine as port_sp
    from predictionio_tpu_torch.utils.serialize import save_model

    rng = np.random.default_rng(8)
    n_items = 300
    factors = rng.normal(size=(n_items, RANK)).astype(np.float32)
    cats = [[f"c{c}" for c in rng.integers(0, 6, rng.integers(1, 4))] for _ in range(n_items)]
    ids = [f"i{r}" for r in range(n_items)]
    params = port_sp.ALSAlgorithmParams(rank=RANK, precision=precision, warm_max_batch=8)
    path = tmp_path / "sp_model.npz"
    save_model(path, port_sp.sp_model_from_numpy(factors, ids, cats, params))

    jax_alg = jax_sp.ALSAlgorithm(jax_sp.ALSAlgorithmParams(rank=RANK, precision=precision))
    jax_model = jax_alg.prepare_serving(None, jax_sp.SPModel(
        item_factors=factors, item_index=JaxBiMap({i: r for r, i in enumerate(ids)}),
        items={r: jax_sp.Item(categories=tuple(c)) for r, c in enumerate(cats)},
    ))
    queries = [
        {"items": ["i1", "i7"], "num": 10},
        {"items": ["i3"], "num": 4, "categories": ["c1", "c2"]},
        {"items": ["i5", "i9", "i11"], "num": 20, "white_list": [f"i{r}" for r in range(0, 300, 3)]},
        {"items": ["i2"], "num": 6, "black_list": ["i4", "i8", "zzz"]},
        {"items": ["nothing-known"], "num": 3},
    ]
    port = _free_port()
    thread, failures = _deploy_file_in_thread(path, port)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(queries)) as pool:
            answers = list(pool.map(
                lambda q: _request(port, "POST", "/queries.json", json.dumps(q).encode()),
                queries,
            ))
        for q, (status, raw) in zip(queries, answers):
            assert status == 200
            payload = json.loads(raw)
            assert payload["modelVersion"] == "sp_model"
            ref = jax_sp.Serving().serve(
                jax_sp.Query(**q), [jax_model.similar(jax_sp.Query(**q))])
            got = payload["itemScores"]
            assert len(got) == len(ref.item_scores)
            if got:
                check_topn_agreement(
                    np.array([[x["score"] for x in got]]),
                    np.array([[int(x["item"][1:]) for x in got]]),
                    np.array([[s.score for s in ref.item_scores]]),
                    np.array([[int(s.item[1:]) for s in ref.item_scores]]),
                    RTOL, ATOL,
                )
        status = json.loads(_request(port, "GET", "/status.json")[1])
        assert status["servingPrecision"] == [precision]
        assert status["algorithms"] == ["ALSAlgorithm"]
        assert _request(port, "GET", "/stop") == (200, b"Shutting down...")
        thread.join(timeout=30)
        assert not thread.is_alive() and not failures
    finally:
        jax_alg.release_serving(jax_model)
        if thread.is_alive():
            _request(port, "GET", "/stop")


def test_quantized_recommendation_reports_its_precision(factors):
    """status.json's servingPrecision, one entry per algorithm: the JAX
    server's field (api/engine_server.py)."""
    uf, itf = factors
    model = port_engine.als_model_from_numpy(
        uf, itf, [f"u{r}" for r in range(N_USERS)], [f"i{r}" for r in range(N_ITEMS)])
    engine = port_engine.recommendation_engine()
    for precision in ("float32", "bf16"):
        params = port_engine.ALSAlgorithmParams(rank=RANK, warm_max_batch=8, precision=precision)
        ep = EngineParams(algorithm_params_list=(("als", params),))
        dep = DeployedEngine(engine, ep, engine.prepare_deploy("cpu", ep, [model]), version="v1")
        server = EngineServer(dep, ServerConfig(ip="127.0.0.1", port=0)).start()
        try:
            status = json.loads(_request(server.port, "GET", "/status.json")[1])
            assert status["servingPrecision"] == [precision]
        finally:
            server.shutdown()
