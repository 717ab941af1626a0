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
