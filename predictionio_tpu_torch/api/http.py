"""Threaded JSON-over-HTTP server adapter: the port's copy of
``predictionio_tpu/api/http.py`` without its metrics and tracing hooks.

The engine server is a pure request core — ``handle(method, path, query,
body, form)`` returning ``(status, payload)`` or ``(status, payload,
content_type)`` — wrapped by this stdlib ThreadingHTTPServer adapter. The
adapter owns transport concerns: URL/query parsing, Content-Length body
reads, form decoding, JSON rendering, the background serve thread, and
shutdown (including shutdown initiated from a handler thread, as /stop
does).
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple

logger = logging.getLogger(__name__)

# (method, path, query, body, form) -> (status, payload[, content_type])
HandleFn = Callable[..., Tuple]


# request-body ceiling shared by both transports (threaded here, the
# event loop in api/aio_http.py): a hostile Content-Length must not make
# a frontend buffer gigabytes.
MAX_BODY_BYTES = 16 * 1024 * 1024


class _Server(ThreadingHTTPServer):
    # the stdlib default backlog (5) drops connections under concurrent
    # load — a burst of clients gets RSTs before threads even spawn
    request_queue_size = 128


class ReusePortUnavailable(OSError):
    """SO_REUSEPORT missing on this platform — permanent, never retried
    (a plain bind OSError is treated as a transient port conflict)."""


class _ReusePortServer(_Server):
    allow_reuse_port = True  # honored on Python 3.11+

    def server_bind(self):
        import socket as _socket

        try:
            self.socket.setsockopt(
                _socket.SOL_SOCKET, _socket.SO_REUSEPORT, 1
            )
        except (AttributeError, OSError) as e:
            raise ReusePortUnavailable(
                "SO_REUSEPORT is unavailable on this platform; "
                "multi-worker port sharing cannot work"
            ) from e
        super().server_bind()


class _Handler(BaseHTTPRequestHandler):
    handle_fn: HandleFn  # bound by JsonHTTPServer

    # HTTP/1.1 keep-alive: every response carries Content-Length, so
    # persistent connections are safe and spare concurrent clients a
    # TCP handshake per request
    protocol_version = "HTTP/1.1"
    # small request/response pairs on persistent connections stall for
    # tens of ms under Nagle + delayed ACK; serving latency is the product
    disable_nagle_algorithm = True

    def _dispatch(self, method: str) -> None:
        parsed = urllib.parse.urlsplit(self.path)
        query = dict(urllib.parse.parse_qsl(parsed.query))
        # under keep-alive, any request body we fail to consume would be
        # parsed as the NEXT request on the connection — refuse framings
        # we can't read and drop the connection when length is unknowable
        if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
            self.close_connection = True
            self.send_error(501, "chunked transfer encoding not supported")
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            self.close_connection = True
            self.send_error(400, "invalid Content-Length")
            return
        if length > MAX_BODY_BYTES:
            # refuse BEFORE reading (the async frontend does the same)
            self.close_connection = True
            self.send_error(413, "request body too large")
            return
        body = self.rfile.read(length) if length > 0 else b""
        # form-encoded bodies are parsed as a convenience, but the raw body
        # is kept too: clients (curl -d) often post JSON without setting
        # Content-Type, which defaults to form-urlencoded
        form = None
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype == "application/x-www-form-urlencoded":
            try:
                form = dict(urllib.parse.parse_qsl(body.decode("utf-8")))
            except UnicodeDecodeError:
                form = {}
        try:
            result = self.handle_fn(method, parsed.path, query, body, form)
        except Exception as e:
            # request cores catch internally; this is the transport-layer
            # backstop so a raising core still answers instead of
            # silently dropping the connection
            logger.exception(
                "internal error handling %s %s", method, parsed.path
            )
            result = (500, {"message": str(e)})
        status, payload = result[0], result[1]
        out_type = result[2] if len(result) > 2 else "application/json"
        if out_type == "application/json" and not isinstance(payload, str):
            data = json.dumps(payload).encode("utf-8")
        else:
            # str payloads are sent verbatim (pre-rendered JSON, HTML, text)
            data = str(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", f"{out_type}; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def do_DELETE(self):  # noqa: N802
        self._dispatch("DELETE")

    def log_message(self, fmt, *args):  # route access logs through logging
        logger.debug("%s - %s", self.address_string(), fmt % args)


def bind_with_retries(attempt_fn: Callable, name: str, ip: str, port: int):
    """Shared bind policy for BOTH transports (this threaded server and
    the event-loop frontend in api/aio_http.py): run ``attempt_fn``
    (which binds and returns a server or socket) up to
    ``JsonHTTPServer.BIND_RETRIES`` times, ``BIND_RETRY_DELAY_S`` apart
    (reference CreateServer.scala:347-357 retries the spray bind 3x,
    1s apart — covers the undeploy-then-redeploy race where the old
    server's port lingers in TIME_WAIT). ``ReusePortUnavailable`` is
    permanent and never retried; a plain OSError is treated as a
    transient port conflict. The tunables stay class attributes on
    JsonHTTPServer (read at call time) so operational overrides cover
    both transports."""
    last_error: Optional[OSError] = None
    for attempt in range(JsonHTTPServer.BIND_RETRIES):
        try:
            return attempt_fn()
        except ReusePortUnavailable:
            raise  # permanent: retrying cannot make the option appear
        except OSError as e:
            last_error = e
            logger.warning(
                "%s bind to %s:%d failed (%s); retry %d/%d",
                name, ip, port, e, attempt + 1,
                JsonHTTPServer.BIND_RETRIES,
            )
            time.sleep(JsonHTTPServer.BIND_RETRY_DELAY_S)
    raise last_error


class JsonHTTPServer:
    """Threaded HTTP server around a request-core callable.

    Binding retries via ``bind_with_retries`` above.
    """

    BIND_RETRIES = 3
    BIND_RETRY_DELAY_S = 1.0

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
        handler = type(
            "BoundHandler",
            (_Handler,),
            {"handle_fn": staticmethod(handle_fn)},
        )
        # SO_REUSEPORT (``reuse_port``): several server PROCESSES bind the
        # same port and the kernel load-balances accepted connections.
        # Fail LOUDLY where the platform lacks the option — a worker that
        # silently bound without it would steal the port from its
        # siblings.
        server_cls = _ReusePortServer if reuse_port else _Server
        self.httpd = bind_with_retries(
            lambda: server_cls((ip, port), handler), name, ip, port
        )
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "JsonHTTPServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        logger.info("%s listening on %s:%d", self.name, self.ip, self.port)
        return self

    def serve_forever(self) -> None:
        logger.info("%s listening on %s:%d", self.name, self.ip, self.port)
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread and self._thread is not threading.current_thread():
            self._thread.join(timeout=5)
