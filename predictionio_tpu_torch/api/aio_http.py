"""Event-loop HTTP/1.1 frontend for the engine server: the port's copy of
``predictionio_tpu/api/aio_http.py`` without its metrics and tracing
hooks.

A single-threaded ``asyncio`` loop serves every connection, so thousands
of keep-alive connections cost file descriptors, not threads, and an
in-flight query is a pending ``concurrent.futures.Future`` the loop
awaits; the micro-batch collector can then fill ``max_batch``-sized
device batches under load. The request core decides the handoff shape
via its return value:

  * a ``(status, payload[, content_type])`` tuple — answered inline;
  * a ``concurrent.futures.Future`` resolving to that tuple — awaited
    without a thread (the engine server's query route).

Per connection, a reader coroutine parses pipelined requests (HTTP/1.1
Content-Length framing; chunked is refused exactly like the threaded
frontend) and a writer coroutine sends the responses strictly in request
order, so several requests from ONE connection can ride the same device
micro-batch. Keep-alive, TCP_NODELAY, bind retries and SO_REUSEPORT match
``JsonHTTPServer``, the threaded alternative (``transport="threaded"``).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import logging
import socket
import threading
import urllib.parse
from http.client import responses as _REASONS
from typing import Optional, Tuple

from predictionio_tpu_torch.api.http import (
    MAX_BODY_BYTES,
    HandleFn,
    JsonHTTPServer,
    ReusePortUnavailable,
    bind_with_retries,
)

logger = logging.getLogger(__name__)

# the transports make_http_server accepts; ServerConfig validates
# against this same tuple
TRANSPORTS = ("async", "threaded")

# headers beyond this are a 431; it is also the StreamReader buffer limit,
# so a missing \r\n\r\n cannot grow the buffer without bound
MAX_HEADER_BYTES = 65536

# pipelined requests in flight per connection before the reader stops
# parsing (backpressure: responses go out strictly in request order, so
# unbounded read-ahead would buffer unbounded response state)
PIPELINE_DEPTH = 16

_CLOSE = object()  # writer sentinel: flush nothing further, close


class AsyncJsonHTTPServer:
    """Single-threaded asyncio HTTP/1.1 server around a request core.

    Interface parity with ``JsonHTTPServer``: ``start()`` serves from a
    daemon thread, ``serve_forever()`` serves in the caller's thread,
    ``shutdown()`` is thread-safe and may be called from a handler-side
    thread (the /stop route does), ``port`` reports the bound port.
    Bind retries and their tunables are shared with the threaded
    frontend (``JsonHTTPServer.BIND_RETRIES``) so operational overrides
    cover both transports.
    """

    def __init__(
        self,
        handle_fn: HandleFn,
        ip: str,
        port: int,
        name: str,
        reuse_port: bool = False,
    ):
        self.name = name
        self.ip = ip
        self.handle_fn = handle_fn
        # bind synchronously so construction fails loudly (port conflict,
        # missing SO_REUSEPORT) and .port is known before the loop spins
        self._sock = self._bind(ip, port, reuse_port)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_event: Optional[asyncio.Event] = None
        self._started = threading.Event()
        self._finished = threading.Event()
        self._shutdown_lock = threading.Lock()
        self._shutdown_requested = False
        self._conn_tasks: set = set()

    # --- bind (retry policy shared with the threaded frontend) ---

    def _bind(self, ip: str, port: int, reuse_port: bool) -> socket.socket:
        def attempt() -> socket.socket:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                if reuse_port:
                    try:
                        sock.setsockopt(
                            socket.SOL_SOCKET, socket.SO_REUSEPORT, 1
                        )
                    except (AttributeError, OSError) as e:
                        raise ReusePortUnavailable(
                            "SO_REUSEPORT is unavailable on this platform; "
                            "multi-worker port sharing cannot work"
                        ) from e
                sock.bind((ip, port))
                # listen NOW (parity with TCPServer.server_activate):
                # a second bind of the same port must fail at
                # construction, not when the loop later starts serving
                sock.listen(128)
                sock.setblocking(False)
                return sock
            except BaseException:
                sock.close()
                raise

        return bind_with_retries(attempt, self.name, ip, port)

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    # --- lifecycle ---

    def start(self) -> "AsyncJsonHTTPServer":
        self._thread = threading.Thread(target=self._run_loop, daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10) and not self._thread.is_alive():
            raise RuntimeError(f"{self.name} event loop failed to start")
        logger.info("%s listening on %s:%d", self.name, self.ip, self.port)
        return self

    def serve_forever(self) -> None:
        logger.info("%s listening on %s:%d", self.name, self.ip, self.port)
        self._run_loop()

    def shutdown(self) -> None:
        """Stop accepting, give in-flight responses a short grace, close.
        Callable from any thread, including threads spawned by handlers
        (the /stop timer); idempotent."""
        with self._shutdown_lock:
            if self._shutdown_requested:
                already = True
            else:
                self._shutdown_requested = True
                already = False
            loop = self._loop
        if not already and loop is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(self._signal_stop)
            except RuntimeError:
                pass  # loop finished between the check and the call
        if self._thread and self._thread is not threading.current_thread():
            self._thread.join(timeout=10)
        elif self._thread is None and loop is not None:
            # serve_forever caller owns the loop thread; wait for it to
            # unwind so the port is released when we return (loop None
            # means the server was never started: nothing to wait for,
            # just release the bound socket below)
            self._finished.wait(timeout=10)
        if self._sock.fileno() != -1:
            self._sock.close()

    def _signal_stop(self) -> None:
        if self._stop_event is not None:
            self._stop_event.set()

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        try:
            loop.run_until_complete(self._serve())
        finally:
            # cancel any straggler tasks so loop.close() is clean
            for task in asyncio.all_tasks(loop):
                task.cancel()
            try:
                loop.run_until_complete(loop.shutdown_asyncgens())
            except Exception:
                pass
            loop.close()
            self._finished.set()

    async def _serve(self) -> None:
        self._stop_event = asyncio.Event()
        with self._shutdown_lock:
            if self._shutdown_requested:  # shutdown raced start
                self._stop_event.set()
        server = await asyncio.start_server(
            self._on_connection,
            sock=self._sock,
            backlog=128,  # parity with _Server.request_queue_size
            limit=MAX_HEADER_BYTES,
        )
        self._started.set()
        try:
            await self._stop_event.wait()
        finally:
            server.close()
            await server.wait_closed()
            live = [t for t in self._conn_tasks if not t.done()]
            if live:
                # grace for in-flight responses (their backing futures
                # resolve as soon as the executor drains), then cancel
                await asyncio.wait(live, timeout=2.0)
                for t in live:
                    t.cancel()
                await asyncio.wait(live, timeout=2.0)

    # --- per-connection pipeline ---

    async def _on_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
        sock = writer.get_extra_info("socket")
        if sock is not None:
            try:
                # small keep-alive request/response pairs stall tens of
                # ms under Nagle + delayed ACK (same rationale as the
                # threaded frontend's disable_nagle_algorithm)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
        # responses leave strictly in request order: the reader enqueues
        # one entry per parsed request, the writer awaits/serializes each
        pending: asyncio.Queue = asyncio.Queue(maxsize=PIPELINE_DEPTH)
        writer_task = asyncio.ensure_future(
            self._write_responses(pending, writer)
        )
        cancelled = False
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:  # clean EOF between requests
                    break
                if req[0] == "error":
                    _, status, message = req
                    await pending.put(((status, {"message": message}), False))
                    break
                _, method, path, query, body, form, keep_alive = req
                try:
                    result = self.handle_fn(method, path, query, body, form)
                except Exception as e:
                    logger.exception(
                        "internal error handling %s %s", method, path
                    )
                    result = (500, {"message": str(e)})
                await pending.put((result, keep_alive))
                if not keep_alive:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # peer went away mid-request
        except asyncio.CancelledError:
            cancelled = True
            raise
        finally:
            if cancelled:
                writer_task.cancel()
            else:
                # the writer consumes every entry up to _CLOSE even on a
                # dead peer (discard mode), so this put cannot park
                await pending.put(_CLOSE)
                try:
                    await writer_task
                except asyncio.CancelledError:
                    pass
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError, asyncio.CancelledError):
                pass
            if task is not None:
                self._conn_tasks.discard(task)

    async def _read_request(self, reader: asyncio.StreamReader):
        """Parse one framed request. Returns None on clean EOF,
        ``("error", status, message)`` on an unrecoverable framing
        problem (the connection closes after the error response), else
        ``("request", method, path, query, body, form, keep_alive)``."""
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as e:
            if not e.partial:
                return None
            return ("error", 400, "truncated request")
        except asyncio.LimitOverrunError:
            return ("error", 431, "request headers too large")
        try:
            lines = head.decode("latin-1").split("\r\n")
            method, target, version = lines[0].split()
        except ValueError:
            return ("error", 400, "malformed request line")
        if not version.startswith("HTTP/1."):
            return ("error", 505, "HTTP version not supported")
        headers = {}
        for line in lines[1:]:
            if not line:
                continue
            key, sep, value = line.partition(":")
            if not sep or line[0] in " \t":  # no obs-fold support
                return ("error", 400, "malformed header line")
            headers[key.strip().lower()] = value.strip()
        # under keep-alive an unread body would be parsed as the NEXT
        # request — refuse framings we can't read (threaded-frontend
        # parity: chunked is 501)
        if "chunked" in headers.get("transfer-encoding", "").lower():
            return ("error", 501, "chunked transfer encoding not supported")
        try:
            length = int(headers.get("content-length") or 0)
        except ValueError:
            return ("error", 400, "invalid Content-Length")
        if length < 0:
            return ("error", 400, "invalid Content-Length")
        if length > MAX_BODY_BYTES:
            # refuse BEFORE reading: a hostile Content-Length must not
            # make the loop buffer gigabytes
            return ("error", 413, "request body too large")
        body = await reader.readexactly(length) if length > 0 else b""
        parsed = urllib.parse.urlsplit(target)
        query = dict(urllib.parse.parse_qsl(parsed.query))
        form = None
        ctype = headers.get("content-type", "").split(";")[0].strip()
        if ctype == "application/x-www-form-urlencoded":
            try:
                form = dict(
                    urllib.parse.parse_qsl(body.decode("utf-8"))
                )
            except UnicodeDecodeError:
                form = {}
        connection = headers.get("connection", "").lower()
        if version == "HTTP/1.1":
            keep_alive = "close" not in connection
        else:  # HTTP/1.0 defaults to one request per connection
            keep_alive = "keep-alive" in connection
        return ("request", method, parsed.path, query, body, form, keep_alive)

    async def _write_responses(
        self, pending: asyncio.Queue, writer: asyncio.StreamWriter
    ) -> None:
        # NEVER return before _CLOSE: the queue is bounded, so a writer
        # that stopped consuming would park the reader (and its
        # finally-clause _CLOSE put) forever on a full queue — leaking
        # the connection task and socket. After a write failure (or a
        # Connection: close response) we switch to discarding: remaining
        # entries are drained, their deferred work cancelled if possible.
        discarding = False
        while True:
            item = await pending.get()
            if item is _CLOSE:
                return
            result, keep_alive = item
            if discarding:
                if isinstance(result, concurrent.futures.Future):
                    # best effort: an uncollected query still queued in
                    # the batching executor is dropped from its batch
                    result.cancel()
                continue
            try:
                if isinstance(result, concurrent.futures.Future):
                    # the future-based handoff: the in-flight request is
                    # this queue entry, not a parked OS thread
                    result = await asyncio.wrap_future(result)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.exception("deferred handler failed")
                result = (500, {"message": str(e)})
            try:
                # rendering is inside the invariant too: a payload
                # json.dumps can't encode (or a malformed handler tuple)
                # must produce a 500, not kill the writer and wedge the
                # reader on the bounded queue
                head, data = self._render(result, keep_alive)
            except Exception as e:
                logger.exception("unrenderable handler result %r", result)
                head, data = self._render(
                    (500, {"message": str(e)}), keep_alive
                )
            try:
                writer.write(head + data)
                await writer.drain()
            except (ConnectionError, OSError):
                discarding = True  # peer went away; drain to _CLOSE
            if not keep_alive:
                discarding = True  # discard pipelined leftovers

    @staticmethod
    def _render(result, keep_alive: bool) -> Tuple[bytes, bytes]:
        status, payload = result[0], result[1]
        out_type = result[2] if len(result) > 2 else "application/json"
        if out_type == "application/json" and not isinstance(payload, str):
            data = json.dumps(payload).encode("utf-8")
        else:
            # str payloads go verbatim (pre-rendered JSON, HTML, text)
            data = str(payload).encode("utf-8")
        reason = _REASONS.get(status, "Unknown")
        conn_header = "" if keep_alive else "Connection: close\r\n"
        head = (
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {out_type}; charset=utf-8\r\n"
            f"Content-Length: {len(data)}\r\n"
            f"{conn_header}\r\n"
        ).encode("latin-1")
        return head, data


def make_http_server(
    handle_fn: HandleFn,
    ip: str,
    port: int,
    name: str,
    reuse_port: bool = False,
    transport: str = "async",
):
    """Transport selector shared by the REST servers: ``async`` is the
    event-loop frontend above, ``threaded`` the stdlib thread-per-
    connection fallback. The caller supplies a transport-appropriate
    ``handle_fn`` (the threaded frontend cannot await a Future)."""
    if transport == "async":
        return AsyncJsonHTTPServer(
            handle_fn, ip, port, name, reuse_port=reuse_port
        )
    if transport == "threaded":
        return JsonHTTPServer(
            handle_fn, ip, port, name, reuse_port=reuse_port
        )
    raise ValueError(
        f"unknown transport {transport!r} (expected one of {TRANSPORTS})"
    )
