"""The engine (query) server for one deployed model: the serving subset of
``predictionio_tpu/api/engine_server.py`` (reference
core/src/main/scala/io/prediction/workflow/CreateServer.scala):

  GET  /               -> HTML status page           (:444-471)
  GET  /status.json    -> the same data as JSON
  POST /queries.json   -> the serving hot path        (:473-624)
  GET  /stop           -> undeploy                    (:634-642)

Concurrent queries flow through a micro-batching executor: they are
coalesced for up to ``batch_window_ms`` (at most ``max_batch``) and served
as ONE batched device predict (``BaseAlgorithm.batch_predict``; for the
recommendation engine one K3 launch). Malformed queries answer 400 and
unknown routes 404, as the reference server does.
``ServerConfig.serving_devices`` names the CUDA devices the prepared
serving state shards over (``_mesh_from_device_spec``; ``tools/cli.py``
builds the mesh and prepares the model on it). The port's server has no
``/reload`` yet, so there is no model swap to reuse the mesh for.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import datetime as _dt
import html
import json
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from predictionio_tpu_torch.api.aio_http import TRANSPORTS, make_http_server
from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ServerConfig:
    """Reference ServerConfig (CreateServer.scala:80-96), serving subset."""

    ip: str = "localhost"
    port: int = 8000
    # micro-batching: the collection window after a batch's first query,
    # and the most queries one device batch takes
    batch_window_ms: float = 2.0
    max_batch: int = 128
    # batches in flight at once. Depth > 1 runs serve_batch concurrently
    # on the deployed engine, which the packaged engine allows (its
    # predict-time state is immutable); 1 serves strictly serially, the
    # reference's contract
    pipeline_depth: int = 1
    # "async": the event-loop frontend (api/aio_http.py); "threaded": the
    # stdlib thread-per-connection frontend (api/http.py)
    transport: str = "async"
    # bind with SO_REUSEPORT so several server processes share one port
    reuse_port: bool = False
    # comma-separated CUDA device indices the prepared serving state shards
    # over (e.g. "0" for one card, "0,1" for a 2-device mesh; an index may
    # repeat: "0,0,0,0" is four row shards on one card). None = every
    # visible CUDA device (tools/cli.py deploy)
    serving_devices: Optional[str] = None

    def __post_init__(self):
        if self.transport not in TRANSPORTS:
            raise ValueError(
                f"unknown transport {self.transport!r} "
                f"(expected one of {TRANSPORTS})"
            )
        if self.max_batch < 1 or self.pipeline_depth < 1:
            raise ValueError("max_batch and pipeline_depth must be >= 1")


def _mesh_from_device_spec(spec: str) -> Mesh:
    """A 1-D ``data`` mesh over the named CUDA device indices ("0" or
    "0,2,3"; repeats name logical shards of one card), the reference's
    :176-192. Raises ``ValueError`` on an empty list or an index that is no
    visible CUDA device (every index when none is present)."""
    idxs = [int(p) for p in str(spec).split(",") if p.strip() != ""]
    count = torch.cuda.device_count()
    bad = [i for i in idxs if not 0 <= i < count]
    if not idxs or bad:
        raise ValueError(
            f"serving_devices {spec!r} names invalid device indices "
            f"{bad} (have {count} CUDA devices)"
        )
    return make_mesh({DATA_AXIS: len(idxs)}, [torch.device("cuda", i) for i in idxs])


class DeployedEngine:
    """Serving state for one deployed model: the engine's algorithms and
    serving, and the models prepared for serving. Construction warms every
    algorithm, so the device is ready before the server takes traffic."""

    def __init__(
        self,
        engine: Engine,
        engine_params: EngineParams,
        models: List[Any],
        version: str = "unknown",
    ):
        self.engine = engine
        self.engine_params = engine_params
        self.version = version
        _, _, self.algorithms, self.serving = engine.make_components(engine_params)
        self.models = models
        if len(self.models) != len(self.algorithms):
            raise ValueError(
                f"{len(self.models)} models for {len(self.algorithms)} algorithms"
            )
        for algo, model in zip(self.algorithms, self.models):
            algo.warm(model)
        # in-flight batches: release() waits for them before it frees the
        # device-resident serving state
        self._inflight = 0
        self._inflight_cond = threading.Condition()
        self._released = False

    def serve_batch(self, queries: Sequence[Any]) -> List[Any]:
        """supplement each -> ONE batch_predict per algorithm -> serve each
        with its original query (reference Engine.scala:769-810)."""
        with self._inflight_cond:
            self._inflight += 1
        try:
            supplemented = [self.serving.supplement(q) for q in queries]
            indexed = list(enumerate(supplemented))
            per_algo: List[Dict[int, Any]] = [
                dict(algo.batch_predict(model, indexed))
                for algo, model in zip(self.algorithms, self.models)
            ]
            return [
                self.serving.serve(q, [pa[i] for pa in per_algo])
                for i, q in enumerate(queries)
            ]
        finally:
            with self._inflight_cond:
                self._inflight -= 1
                self._inflight_cond.notify_all()

    def release(self, timeout_s: float = 0.0) -> bool:
        """Free each algorithm's device serving state once nothing is in
        flight (waiting up to ``timeout_s``); return whether it did."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._inflight_cond:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_cond.wait(min(0.2, remaining))
            if not self._released:
                self._released = True
                for algo, model in zip(self.algorithms, self.models):
                    algo.release_serving(model)
        return True


class _BatchingExecutor:
    """Coalesces concurrent queries into device-sized batches.

    Queries enqueue (query, future); one collector thread drains the queue
    — waiting up to window_ms after the first arrival, for at most
    max_batch queries — and hands each batch to a serve pool holding up to
    ``pipeline_depth`` batches in flight. ``submit_nowait`` returns the
    future itself, which the event-loop frontend awaits and the threaded
    frontend waits on.
    """

    _STOP = object()  # collector-thread shutdown sentinel

    def __init__(
        self,
        deployed: DeployedEngine,
        window_ms: float,
        max_batch: int,
        pipeline_depth: int = 1,
    ):
        self.deployed = deployed
        self.window_ms = window_ms
        self.max_batch = max_batch
        self.pipeline_depth = max(1, pipeline_depth)
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._closed = False
        self._inflight = threading.Semaphore(self.pipeline_depth)
        self._serve_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.pipeline_depth, thread_name_prefix="serve"
        )
        self._batches = 0
        self._queries = 0

    def submit_nowait(self, query: Any) -> "concurrent.futures.Future":
        """Enqueue one query; the future resolves to its prediction (or
        raises its per-query error) once its micro-batch is served."""
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        # the closed-check and the enqueue share the lock with close()'s
        # sentinel post, so a query can never land behind _STOP
        with self._lock:
            if self._closed:
                raise RuntimeError("server is shutting down")
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(target=self._run, daemon=True)
                self._worker.start()
            self._queue.put((query, fut))
        return fut

    def stats(self) -> Dict[str, Any]:
        """Served batches and queries, and the mean batch fill."""
        with self._lock:
            batches, queries = self._batches, self._queries
        return {
            "batches": batches,
            "queries": queries,
            "batch_fill_mean": queries / batches if batches else 0.0,
        }

    def close(self) -> None:
        """Stop the collector and release the serve pool. In-flight
        batches finish; later submits fail."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            worker = self._worker
            self._queue.put(self._STOP)
        if worker is not None and worker.is_alive():
            worker.join(timeout=10.0)
        # wait=False: a wedged serve_batch must not hang close()
        self._serve_pool.shutdown(wait=False)

    def _run(self) -> None:
        while True:
            first = self._queue.get()
            if first is self._STOP:
                return
            batch = [first]
            deadline = time.monotonic() + self.window_ms / 1000.0
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is self._STOP:
                    self._queue.put(item)  # re-post for the outer loop
                    break
                batch.append(item)
            # a future the transport cancelled (client gone before its
            # batch formed) is dropped; the rest are pinned RUNNING
            items = [it for it in batch if it[1].set_running_or_notify_cancel()]
            if not items:
                continue
            with self._lock:
                self._batches += 1
                self._queries += len(items)
            # blocks while pipeline_depth batches are in flight; the next
            # batch keeps accumulating in self._queue meanwhile
            self._inflight.acquire()
            try:
                self._serve_pool.submit(self._serve_and_release, items)
            except RuntimeError as e:
                # pool shut down mid-close: fail these futures instead of
                # leaving their waiters pending forever
                self._inflight.release()
                for _, f in items:
                    f.set_exception(RuntimeError(f"server is shutting down: {e}"))

    def _serve_and_release(self, items) -> None:
        outcomes: List[tuple] = []
        try:
            self._serve_isolating(items, outcomes)
        finally:
            self._inflight.release()
            for f, exc, result in outcomes:
                if exc is not None:
                    f.set_exception(exc)
                else:
                    f.set_result(result)

    def _serve_isolating(self, items, outcomes: List[tuple]) -> None:
        """Serve a batch; on failure bisect it, so a poison query is found
        in O(log n) batched calls and its batchmates are still served."""
        try:
            results = self.deployed.serve_batch([q for q, _ in items])
            for (_, f), r in zip(items, results):
                outcomes.append((f, None, r))
        except Exception as e:
            if len(items) == 1:
                outcomes.append((items[0][1], e, None))
                return
            mid = len(items) // 2
            self._serve_isolating(items[:mid], outcomes)
            self._serve_isolating(items[mid:], outcomes)


class QueryAPI:
    """Transport-independent request core for the engine server."""

    def __init__(
        self,
        deployed: DeployedEngine,
        config: Optional[ServerConfig] = None,
        stop_fn=None,
    ):
        self.deployed = deployed
        self.config = config or ServerConfig()
        self._stop_fn = stop_fn
        self._executor = _BatchingExecutor(
            deployed,
            self.config.batch_window_ms,
            self.config.max_batch,
            self.config.pipeline_depth,
        )
        self.server_start_time = _dt.datetime.now(_dt.timezone.utc)
        self._stats_lock = threading.Lock()
        self._requests = 0
        self._serving_sec_total = 0.0
        self._last_serving_sec = 0.0

    def close(self) -> None:
        """Stop the batching executor's threads."""
        self._executor.close()

    def handle(
        self,
        method: str,
        path: str,
        query: Optional[Dict[str, str]] = None,
        body: Optional[bytes] = None,
    ) -> Tuple[int, Any, str]:
        """Blocking dispatch (the threaded frontend): (status, payload,
        content_type)."""
        result = self.handle_nowait(method, path, query, body)
        if isinstance(result, concurrent.futures.Future):
            return result.result()
        return result

    def handle_nowait(
        self,
        method: str,
        path: str,
        query: Optional[Dict[str, str]] = None,
        body: Optional[bytes] = None,
    ) -> Union[Tuple[int, Any, str], "concurrent.futures.Future"]:
        """Dispatch for the event-loop frontend: the query route returns a
        future resolving to (status, payload, content_type); every other
        route is cheap and answers inline."""
        try:
            return self._route(method, path, body)
        except Exception as e:
            logger.exception("internal error handling %s %s", method, path)
            return 500, {"message": str(e)}, "application/json"

    def _route(self, method, path, body):
        if path == "/queries.json" and method == "POST":
            return self._handle_query_nowait(body)
        if path.strip("/") == "" and method == "GET":
            return 200, self._status_html(), "text/html"
        if path == "/status.json" and method == "GET":
            return 200, self._status_json(), "application/json"
        if path == "/stop" and method == "GET":
            if self._stop_fn is not None:
                # after a grace, so this response still goes out
                t = threading.Timer(1.0, self._stop_fn)
                t.daemon = True
                t.start()
            return 200, "Shutting down...", "text/plain"
        return 404, {"message": "Not Found"}, "application/json"

    def _handle_query_nowait(self, body: Optional[bytes]):
        """Parse and enqueue; the returned future completes when the
        query's micro-batch is served. Parse errors answer inline."""
        serving_start = time.perf_counter()
        deployed = self.deployed
        try:
            query_json = json.loads((body or b"").decode("utf-8"))
            query = deployed.algorithms[0].query_from_json(query_json)
        except Exception as e:
            logger.error("query %r is invalid: %s", body, e)
            return 400, {"message": str(e)}, "application/json"

        prediction_fut = self._executor.submit_nowait(query)
        out: "concurrent.futures.Future" = concurrent.futures.Future()

        def _finish(f: "concurrent.futures.Future") -> None:
            try:
                result = self._finish_query(deployed, f.result(), serving_start)
            except concurrent.futures.CancelledError:
                return  # cancelled before its batch formed
            except Exception as e:
                logger.exception("internal error handling POST /queries.json")
                result = (500, {"message": str(e)}, "application/json")
            try:
                out.set_result(result)
            except concurrent.futures.InvalidStateError:
                pass  # the transport cancelled the request (client gone)

        prediction_fut.add_done_callback(_finish)

        def _propagate_cancel(f: "concurrent.futures.Future") -> None:
            if f.cancelled():
                # client went away: drop the query from the collector if
                # it has not been picked up into a batch yet
                prediction_fut.cancel()

        out.add_done_callback(_propagate_cancel)
        return out

    def _finish_query(
        self, deployed: DeployedEngine, prediction, serving_start: float
    ) -> Tuple[int, Any, str]:
        """The response body of the reference's _finish_query: the
        algorithm's JSON plus ``modelVersion``."""
        prediction_json = deployed.algorithms[0].result_to_json(prediction)
        if isinstance(prediction_json, dict):
            prediction_json = dict(prediction_json, modelVersion=deployed.version)
        elapsed = time.perf_counter() - serving_start
        with self._stats_lock:
            self._requests += 1
            self._serving_sec_total += elapsed
            self._last_serving_sec = elapsed
        return 200, prediction_json, "application/json"

    def _status_json(self) -> dict:
        dep = self.deployed
        batch_stats = self._executor.stats()
        with self._stats_lock:
            requests = self._requests
            total = self._serving_sec_total
            last = self._last_serving_sec
        return {
            "status": "alive",
            "modelVersion": dep.version,
            "startTime": self.server_start_time.isoformat(),
            "algorithms": [type(a).__name__ for a in dep.algorithms],
            "algorithmsParams": [repr(a.params) for a in dep.algorithms],
            # the residency precision each algorithm serves with
            "servingPrecision": [
                a.serving_precision(m) for a, m in zip(dep.algorithms, dep.models)
            ],
            "serving": type(dep.serving).__name__,
            "requestCount": requests,
            "avgServingSec": total / requests if requests else 0.0,
            "lastServingSec": last,
            "batches": batch_stats["batches"],
            "batchFillMean": batch_stats["batch_fill_mean"],
        }

    def _status_html(self) -> str:
        s = self._status_json()
        rows = "".join(
            f"<tr><th>{html.escape(str(k))}</th>"
            f"<td>{html.escape(json.dumps(v))}</td></tr>"
            for k, v in s.items()
        )
        return (
            "<!DOCTYPE html><html><head><title>"
            f"Engine Server at {self.config.ip}:{self.config.port}"
            "</title></head><body><h1>PredictionIO Engine Server</h1>"
            f"<table>{rows}</table></body></html>"
        )


class EngineServer:
    """Binds the HTTP frontend (event loop by default, thread per
    connection with ``transport='threaded'``) around a QueryAPI, and
    undeploys on /stop (reference CreateServer.scala:262-384)."""

    def __init__(
        self, deployed: DeployedEngine, config: Optional[ServerConfig] = None
    ):
        self.config = config or ServerConfig()
        self.api = QueryAPI(deployed, self.config, stop_fn=self.shutdown)

        def handle(method, path, query, body, form=None):
            return self.api.handle(method, path, query, body)

        def handle_nowait(method, path, query, body, form=None):
            return self.api.handle_nowait(method, path, query, body)

        # the event loop awaits the query route's future; the threaded
        # frontend cannot await, so it gets the blocking dispatch
        fn = handle_nowait if self.config.transport == "async" else handle
        self._http = make_http_server(
            fn, self.config.ip, self.config.port, "Engine Server",
            reuse_port=self.config.reuse_port,
            transport=self.config.transport,
        )
        self._stopped = threading.Event()

    @property
    def port(self) -> int:
        return self._http.port

    def start(self) -> "EngineServer":
        self._http.start()
        return self

    def serve_forever(self) -> None:
        self._http.serve_forever()

    def shutdown(self) -> None:
        """Stop serving, stop the executor, free the device state."""
        self._http.shutdown()
        self.api.close()
        self.api.deployed.release(timeout_s=1.0)
        self._stopped.set()

    def wait_stopped(self, timeout: Optional[float] = None) -> bool:
        """Block until shutdown() has finished (e.g. after GET /stop)."""
        return self._stopped.wait(timeout)


def create_server(
    deployed: DeployedEngine, config: Optional[ServerConfig] = None
) -> EngineServer:
    """Reference CreateServer.main (CreateServer.scala:110-195), for one
    deployed model."""
    return EngineServer(deployed, config)
