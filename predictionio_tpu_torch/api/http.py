"""Stdlib HTTP wrapper around the handler cores.

Parity: the spray-can ``Http.Bind`` layer of ``data/api/EventServer.scala``
and ``core/workflow/CreateServer.scala``. A small threading HTTP server is
all the transport the framework needs — handler logic lives in the
transport-agnostic service objects, matching the reference's actor/route
split and keeping tests in-process.
"""

from __future__ import annotations

import json
import logging
import os
import ssl
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import TYPE_CHECKING, Callable, Mapping

__all__ = [
    "serve",
    "start_background",
    "make_ssl_context",
    "ssl_context_from_env",
]

logger = logging.getLogger(__name__)


def make_ssl_context(
    cert_path: str, key_path: str, key_password: str | None = None
) -> ssl.SSLContext:
    """Server-side TLS context from a PEM cert/key pair.

    Parity: ``common/.../configuration/SSLConfiguration.scala`` — the
    reference reads a JKS keystore via typesafe-config and hands an
    ``SSLContext`` to both spray servers; here the PEM pair comes from
    CLI flags or ``PIO_SSL_CERT``/``PIO_SSL_KEY`` env vars and wraps the
    listening socket of any framework server."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path, password=key_password)
    return ctx


def ssl_context_from_env() -> ssl.SSLContext | None:
    """TLS context from ``PIO_SSL_CERT``/``PIO_SSL_KEY`` (+ optional
    ``PIO_SSL_KEY_PASSWORD``), or None when unset — the deployment-env
    layer of the config triad (SURVEY.md section 6.6)."""
    cert = os.environ.get("PIO_SSL_CERT")
    key = os.environ.get("PIO_SSL_KEY")
    if not cert and not key:
        return None
    if bool(cert) != bool(key):
        # refuse to silently serve plaintext when the operator set half
        # the pair — same contract as the --cert/--key flags
        raise ValueError(
            "PIO_SSL_CERT and PIO_SSL_KEY must be set together"
        )
    return make_ssl_context(cert, key, os.environ.get("PIO_SSL_KEY_PASSWORD"))

#: signature shared with EventService.dispatch / QueryService.dispatch
Dispatcher = Callable[..., "object"]


class _LengthReader:
    """Bounded raw-body reader (``Content-Length`` requests) handed to
    streaming routes — ``read(n)`` returns at most ``n`` bytes, ``b""``
    at end of body."""

    def __init__(self, rfile, length: int):
        self._r = rfile
        self._left = max(0, length)

    def read(self, n: int = 65536) -> bytes:
        if self._left <= 0:
            return b""
        data = self._r.read(min(n, self._left))
        if not data:
            self._left = 0
            return b""
        self._left -= len(data)
        return data

    @property
    def exhausted(self) -> bool:
        return self._left <= 0


class _ChunkedReader:
    """Incremental ``Transfer-Encoding: chunked`` request-body decoder
    (http.server does not decode chunked uploads itself). Same
    ``read(n)``/``exhausted`` contract as :class:`_LengthReader`;
    malformed framing raises ``ValueError`` (the consuming route turns
    it into a clean stream-level error)."""

    def __init__(self, rfile):
        self._r = rfile
        self._left = 0
        self._done = False
        self._broken = False

    def _torn(self, what: str) -> ValueError:
        """Malformed or truncated framing: unknown bytes may remain on
        the wire — the connection must NOT be reused (exhausted stays
        False so the handler hangs up) and the consuming route must see
        an ERROR, never a clean end-of-body (a truncated upload acked
        ok would silently lose the un-sent half)."""
        self._done = True
        self._broken = True
        return ValueError(what)

    def read(self, n: int = 65536) -> bytes:
        if self._done:
            return b""
        if self._left == 0:
            line = self._r.readline(1024)
            if not line:
                raise self._torn(
                    "connection closed before the terminating chunk"
                )
            try:
                size = int(line.split(b";")[0].strip() or b"0", 16)
            except ValueError:
                raise self._torn(f"bad chunk size line {line[:32]!r}")
            if size == 0:
                while True:  # consume optional trailers up to blank line
                    t = self._r.readline(1024)
                    if not t or t in (b"\r\n", b"\n"):
                        break
                self._done = True
                return b""
            self._left = size
        data = self._r.read(min(n, self._left))
        if not data:
            raise self._torn("connection closed mid-chunk")
        self._left -= len(data)
        if self._left == 0:
            self._r.read(2)  # CRLF closing the chunk
        return data

    @property
    def exhausted(self) -> bool:
        return self._done and not self._broken

#: readiness hook: () -> {"ready": bool, "checks": {...}} — served at
#: GET /readyz (see _make_handler)
ReadinessHook = Callable[[], Mapping]

if TYPE_CHECKING:
    from predictionio_tpu_torch.api.lifecycle import DrainManager


def _resolve_readiness(
    dispatch: Dispatcher, readiness: ReadinessHook | None
) -> ReadinessHook | None:
    """An explicit hook wins; otherwise a service object's ``readiness``
    method is discovered from a bound ``dispatch`` — so every framework
    server (event/query/admin/dashboard/storage) gets ``/readyz`` for
    free the moment its service class defines one."""
    if readiness is not None:
        return readiness
    owner = getattr(dispatch, "__self__", None)
    hook = getattr(owner, "readiness", None)
    return hook if callable(hook) else None


def _make_handler(
    dispatch: Dispatcher,
    readiness: ReadinessHook | None = None,
    lifecycle: "DrainManager | None" = None,
):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        #: per-connection socket timeout — bounds stalled clients (incl.
        #: the lazy TLS handshake, which runs on first I/O in this
        #: worker thread; see _make_server)
        timeout = 60
        #: keep-alive clients otherwise stall ~40 ms per request on the
        #: Nagle/delayed-ACK interaction: headers and body would go out as
        #: two segments, the second waiting on the client's delayed ACK
        disable_nagle_algorithm = True
        #: buffer the response so status+headers+body leave in one send
        #: (handle_one_request flushes wfile after each request)
        wbufsize = 64 * 1024

        def log_message(self, fmt, *args):  # route through logging, not stderr
            logger.debug("%s - %s", self.address_string(), fmt % args)

        def _respond(self):
            parsed = urllib.parse.urlparse(self.path)
            # health probes are transport-level (docs/operations.md):
            # answered before service dispatch so every server exposes
            # them uniformly and a wedged service layer cannot take the
            # liveness probe down with it
            if self.command == "GET" and parsed.path == "/healthz":
                self._send(200, b'{"status": "ok"}')
                return
            if self.command == "GET" and parsed.path == "/readyz":
                self._ready_probe()
                return
            if lifecycle is not None:
                # graceful drain (docs/operations.md): once draining, new
                # work is refused with a clean 503 + Retry-After while
                # requests already admitted run to completion. Admission
                # and the in-flight count are one atomic step, so the
                # drain's idle-wait can never miss a racing request.
                if not lifecycle.try_begin_request():
                    # Connection: close (send_header flips close_connection
                    # too): the rejection never reads the request body, so
                    # a kept-alive connection would desync on the unread
                    # bytes — and a draining listener is going away anyway
                    self._send(
                        503,
                        b'{"message": "Server is draining; retry elsewhere."}',
                        extra_headers={
                            "Retry-After": str(lifecycle.retry_after_s()),
                            "Connection": "close",
                        },
                    )
                    return
                try:
                    self._dispatch_and_send(parsed)
                finally:
                    lifecycle.end_request()
                return
            self._dispatch_and_send(parsed)

        def _dispatch_and_send(self, parsed):
            params = {
                k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()
            }
            # streaming routes (the bulk-ingest endpoint): the service
            # gets the raw body reader instead of a parsed JSON body, so
            # the payload is consumed incrementally — never materialized
            owner = getattr(dispatch, "__self__", None)
            stream_routes = getattr(owner, "stream_routes", None)
            if stream_routes and (self.command, parsed.path) in stream_routes:
                self._dispatch_stream(parsed, params)
                return
            body = None
            form: Mapping[str, str] | None = None
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b""
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
            if raw:
                # Tolerant parse: clients (e.g. bare `curl -d`) often send
                # JSON under a form-encoded default content type. Try JSON
                # first for any body; fall back to form fields only when
                # the payload isn't JSON and the content type says form.
                try:
                    body = json.loads(raw)
                except json.JSONDecodeError:
                    if ctype == "application/x-www-form-urlencoded":
                        form = {
                            k: v[0]
                            for k, v in urllib.parse.parse_qs(raw.decode()).items()
                        }
                    else:
                        self._send(400, b'{"message": "Malformed JSON."}')
                        return
            try:
                resp = dispatch(
                    method=self.command,
                    path=parsed.path,
                    params=params,
                    body=body,
                    headers=dict(self.headers),
                    form=form,
                )
            except Exception:
                logger.exception("Unhandled error for %s %s", self.command, parsed.path)
                self._send(500, b'{"message": "Internal Server Error"}')
                return
            self._send(
                resp.status,
                resp.json_bytes(),
                getattr(resp, "content_type", "application/json; charset=UTF-8"),
                getattr(resp, "headers", None),
            )

        def _dispatch_stream(self, parsed, params):
            te = (self.headers.get("Transfer-Encoding") or "").lower()
            if "chunked" in te:
                reader = _ChunkedReader(self.rfile)
            else:
                reader = _LengthReader(
                    self.rfile, int(self.headers.get("Content-Length") or 0)
                )
            try:
                resp = dispatch(
                    method=self.command,
                    path=parsed.path,
                    params=params,
                    body=None,
                    headers=dict(self.headers),
                    form=None,
                    stream=reader,
                )
            except Exception:
                logger.exception(
                    "Unhandled error for %s %s", self.command, parsed.path
                )
                self._send(500, b'{"message": "Internal Server Error"}')
                self.close_connection = True
                return
            chunks = getattr(resp, "chunks", None)
            if chunks is None:
                # plain Response (auth / validation errors before the
                # body was touched)
                self._send(
                    resp.status,
                    resp.json_bytes(),
                    getattr(resp, "content_type", "application/json; charset=UTF-8"),
                    getattr(resp, "headers", None),
                )
            else:
                self._send_stream(resp, chunks)
            if not reader.exhausted:
                # unread request bytes would desync a kept-alive
                # connection — hang up instead
                self.close_connection = True

        def _send_stream(self, resp, chunks):
            """Chunked-transfer response: each piece goes out (and is
            flushed) the moment the service yields it."""
            self.send_response(resp.status)
            self.send_header(
                "Content-Type",
                getattr(resp, "content_type", "application/x-ndjson"),
            )
            self.send_header("Transfer-Encoding", "chunked")
            for k, v in (getattr(resp, "headers", None) or {}).items():
                self.send_header(k, v)
            self.end_headers()
            try:
                for piece in chunks:
                    if not piece:
                        continue
                    self.wfile.write(
                        f"{len(piece):X}\r\n".encode("ascii") + piece + b"\r\n"
                    )
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            except Exception:
                # mid-stream failure after a 200 status: the truncated
                # chunked framing is the client's error signal
                logger.exception("streaming response aborted")
                self.close_connection = True

        def _ready_probe(self):
            """GET /readyz: 200 when the service's readiness hook says
            every dependency check passed, 503 otherwise. Servers without
            a hook are ready whenever they are alive. A draining server
            is never ready — the balancer must stop routing here before
            the listener goes away."""
            if lifecycle is not None and lifecycle.draining:
                self._send(503, b'{"ready": false, "draining": true}')
                return
            if readiness is None:
                self._send(200, b'{"ready": true, "checks": {}}')
                return
            try:
                report = dict(readiness())
            except Exception as e:
                logger.exception("readiness hook failed")
                report = {"ready": False, "error": str(e)[:200]}
            status = 200 if report.get("ready") else 503
            self._send(status, json.dumps(report, default=str).encode())

        def _send(
            self,
            status: int,
            payload: bytes,
            content_type: str = "application/json; charset=UTF-8",
            extra_headers: Mapping[str, str] | None = None,
        ):
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(payload)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)

        do_GET = do_POST = do_DELETE = do_PUT = _respond

    return Handler


class _Server(ThreadingHTTPServer):
    #: listen(2) backlog. http.server's default of 5 overflows the SYN
    #: queue the moment a few dozen clients connect at once (measured:
    #: 1 s / 3 s latency cliffs from kernel SYN retransmission plus
    #: outright connection resets at concurrency 32); serving millions
    #: of users means absorbing connect storms at the accept queue.
    request_queue_size = 128


def _resolve_drain_hook(dispatch: Dispatcher) -> Callable[[], None] | None:
    """A service object's ``drain`` method, discovered from a bound
    ``dispatch`` the same way readiness is — so the query server's
    micro-batcher close (``QueryService.drain``) runs in the drain
    sequence without per-server wiring."""
    owner = getattr(dispatch, "__self__", None)
    hook = getattr(owner, "drain", None)
    return hook if callable(hook) else None


def _make_server(
    dispatch: Dispatcher,
    host: str,
    port: int,
    ssl_context: ssl.SSLContext | None,
    readiness: ReadinessHook | None = None,
    lifecycle: "DrainManager | None" = None,
) -> ThreadingHTTPServer:
    handler = _make_handler(
        dispatch, _resolve_readiness(dispatch, readiness), lifecycle
    )
    server = _Server((host, port), handler)
    if lifecycle is not None:
        lifecycle.attach_server(server)
        drain_hook = _resolve_drain_hook(dispatch)
        if drain_hook is not None:
            # ahead of any process-level hooks (storage flush): the
            # service must release its own machinery first
            lifecycle.add_drain_hook(drain_hook, first=True)
    if ssl_context is not None:
        # defer the handshake to the per-connection worker thread: with
        # do_handshake_on_connect=True it would run inside accept() on
        # the serve_forever thread, letting ONE stalled client block the
        # whole server. Lazily it runs on first read under the handler's
        # socket timeout instead.
        server.socket = ssl_context.wrap_socket(
            server.socket, server_side=True, do_handshake_on_connect=False
        )
    return server


def serve(
    dispatch: Dispatcher,
    host: str = "0.0.0.0",
    port: int = 7070,
    ssl_context: ssl.SSLContext | None = None,
    ready_callback: Callable[[ThreadingHTTPServer], None] | None = None,
    readiness: ReadinessHook | None = None,
    lifecycle: "DrainManager | None" = None,
) -> None:
    """Blocking serve-forever (used by ``pio eventserver`` / ``pio deploy``).

    ``ready_callback`` receives the bound server before requests flow —
    deploy uses it to wire the ``GET /stop`` shutdown hook. ``readiness``
    backs ``GET /readyz`` (defaults to the service's own ``readiness``
    method when ``dispatch`` is a bound method). ``lifecycle`` (opt-in,
    ``--drain-deadline-s``) enables graceful signal-driven drain; without
    it signal behavior is the historical immediate exit."""
    server = _make_server(dispatch, host, port, ssl_context, readiness, lifecycle)
    logger.info(
        "Listening on %s://%s:%d",
        "https" if ssl_context else "http", host, port,
    )
    if ready_callback is not None:
        ready_callback(server)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def start_background(
    dispatch: Dispatcher,
    host: str = "127.0.0.1",
    port: int = 0,
    ssl_context: ssl.SSLContext | None = None,
    readiness: ReadinessHook | None = None,
    lifecycle: "DrainManager | None" = None,
) -> tuple[ThreadingHTTPServer, threading.Thread]:
    """Start on a daemon thread; returns (server, thread). ``port=0`` picks
    a free port (``server.server_address[1]``). Used by tests and the
    feedback loop."""
    server = _make_server(dispatch, host, port, ssl_context, readiness, lifecycle)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread
