"""API server.

Reference parity: ``internal/server/server.go`` — an HTTP mux where services
``register(endpoint, name, description, handler)`` themselves; an HTML
landing page listing registered endpoints (:109-131); graceful shutdown with
a 5 s bound (:158-165). TLS and basic auth mirror the reference's
exporter-toolkit web config (``server.go:136-156``): cert/key paths plus an
authenticator from ``kepler_tpu_torch.server.webconfig``.

Handlers return ``(status, headers, body_bytes)`` — kept framework-free so
tests can call them directly.
"""

from __future__ import annotations

import html
import logging
import ssl
import threading
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from kepler_tpu_torch.server.health import HealthRegistry
from kepler_tpu_torch.service.lifecycle import CancelContext

log = logging.getLogger("kepler.server")

Handler = Callable[[BaseHTTPRequestHandler], tuple[int, dict[str, str], bytes]]


# keplint: sanitizes — request paths/headers go into log lines; control
# bytes (an encoded %00, a smuggled ESC sequence) would forge log records
# or corrupt terminals, so log fields are filtered to printable ASCII
def printable(value: str, cap: int = 256) -> str:
    return "".join(c for c in str(value)[:cap] if " " <= c <= "\x7e")


@dataclass
class Endpoint:
    path: str
    name: str
    description: str
    handler: Handler
    # largest POST body accepted; bigger requests get 413 without the body
    # ever being buffered (and the connection closes, since the unread
    # bytes would desync keep-alive)
    max_body: int = 1 << 20


_OVERFLOW_BODY = b"connection cap reached\n"
_OVERFLOW_RESPONSE = (b"HTTP/1.1 503 Service Unavailable\r\n"
                      b"Content-Type: text/plain\r\n"
                      b"Content-Length: "
                      + str(len(_OVERFLOW_BODY)).encode() + b"\r\n"
                      b"Retry-After: 1\r\n"
                      b"Connection: close\r\n"
                      b"\r\n"
                      + _OVERFLOW_BODY)


class _CappedThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a bound on concurrent connections.

    The stock mixin spawns one handler thread per accepted connection,
    unboundedly — a connection storm (thundering herd after a replica
    kill, a misbehaving client) grows threads and their stacks without
    limit. With ``max_connections`` set, an accept over the cap is
    answered ``503 + Connection: close`` IMMEDIATELY on the accepting
    thread and closed — no handler thread is ever spawned for it — and
    the client retries against a replica with headroom (or the same one,
    later). 0 keeps the unbounded stock behavior."""

    daemon_threads = True

    def __init__(self, server_address, handler_cls,
                 max_connections: int = 0) -> None:
        super().__init__(server_address, handler_cls)
        self._conn_sema = (threading.BoundedSemaphore(max_connections)
                           if max_connections > 0 else None)
        self.max_connections = max_connections
        self._conn_lock = threading.Lock()
        self.active_connections = 0  # keplint: guarded-by=_conn_lock
        self.rejected_connections_total = 0  # keplint: guarded-by=_conn_lock

    def process_request(self, request, client_address):
        if self._conn_sema is not None \
                and not self._conn_sema.acquire(blocking=False):
            with self._conn_lock:
                self.rejected_connections_total += 1
            try:
                # best-effort: over TLS the handshake may not have run,
                # so the bytes can be unreadable to the client — the
                # close alone still sheds the connection without a thread
                request.sendall(_OVERFLOW_RESPONSE)
            except OSError:
                pass
            self.shutdown_request(request)
            return
        with self._conn_lock:
            self.active_connections += 1
        super().process_request(request, client_address)

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            with self._conn_lock:
                self.active_connections -= 1
            if self._conn_sema is not None:
                self._conn_sema.release()


class APIServer:
    def __init__(
        self,
        listen_addresses: list[str] | None = None,
        tls_cert: str = "",
        tls_key: str = "",
        basic_auth_check: Callable[[str | None], bool] | None = None,
        max_connections: int = 0,
    ) -> None:
        self._addresses = listen_addresses or [":28282"]
        self._tls_cert = tls_cert
        self._tls_key = tls_key
        self._auth_check = basic_auth_check
        # concurrent-connection cap shared across all listen addresses'
        # servers is deliberately NOT pooled: each listener gets the
        # full cap (operators size per listener; 0 = unbounded)
        self._max_connections = max(0, int(max_connections))
        self._endpoints: dict[str, Endpoint] = {}
        self._servers: list[_CappedThreadingHTTPServer] = []
        self._threads: list[threading.Thread] = []
        # flipped by shutdown(): established keep-alive connections get
        # one 503 + close instead of being served forever by their
        # handler threads (stopping the listener alone leaves a
        # "stopped" server happily answering persistent clients — a
        # killed ingest replica must actually go dark)
        self._draining = False
        # probe plane: services register health/readiness callables here
        # (fleet agent breaker, monitor watchdog, aggregator quarantine)
        self.health = HealthRegistry()

    def name(self) -> str:
        return "api-server"

    # keplint: role-registrar=http-handler — every callable registered
    # here runs on a ThreadingHTTPServer worker thread; keplint roots the
    # http-handler thread role at the registered handler (KTL112/KTL113)
    def register(self, path: str, name: str, description: str,
                 handler: Handler, max_body: int = 1 << 20) -> None:
        """Add an endpoint to the catalog (reference Register :167)."""
        self._endpoints[path] = Endpoint(path, name, description, handler,
                                         max_body)

    # -- lifecycle ---------------------------------------------------------

    def init(self) -> None:
        outer = self

        # keplint: thread-role=http-handler
        class RequestHandler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route into our logger
                log.debug("http: " + fmt, *args)

            def _dispatch(self):
                if outer._draining:
                    # shutting down: refuse (retryable) and sever the
                    # keep-alive so the client reconnects elsewhere
                    self.close_connection = True
                    self._respond(503, {"Content-Type": "text/plain"},
                                  b"shutting down\n")
                    return
                if outer._auth_check is not None and not outer._auth_check(
                        self.headers.get("Authorization")):
                    # body (if any) was never read — drop the connection so
                    # keep-alive can't desync
                    self.close_connection = True
                    self._respond(
                        401,
                        {"Content-Type": "text/plain",
                         "WWW-Authenticate": 'Basic realm="kepler-tpu"'},
                        b"unauthorized\n")
                    return
                path = self.path.split("?", 1)[0]
                endpoint = outer._match(path)
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    length = -1
                cap = endpoint.max_body if endpoint else 0
                if length < 0 or length > cap:
                    # don't buffer or trust the remainder of the stream
                    self.close_connection = True
                    if endpoint is not None:
                        self._respond(413, {"Content-Type": "text/plain"},
                                      b"payload too large\n")
                        return
                elif length:
                    # pre-read so keep-alive connections never desync on
                    # handlers that ignore the body
                    self.body = self.rfile.read(length)
                else:
                    self.body = b""
                if endpoint is None:
                    self._respond(404, {"Content-Type": "text/plain"},
                                  b"not found\n")
                    return
                try:
                    status, headers, body = endpoint.handler(self)
                except Exception:
                    log.exception("handler %s failed", printable(path))
                    self._respond(500, {"Content-Type": "text/plain"},
                                  b"internal error\n")
                    return
                self._respond(status, headers, body)

            def do_GET(self):  # noqa: N802 (stdlib casing)
                self._dispatch()

            def do_POST(self):  # noqa: N802
                # handlers see request.command and the pre-read request.body
                self._dispatch()

            def _respond(self, status, headers, body):
                try:
                    self.send_response(status)
                    for k, v in headers.items():
                        self.send_header(k, v)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    # client gave up (e.g. agent timeout) — not our error
                    log.debug("client disconnected before response: %s",
                              printable(self.path))

        self._handler_cls = RequestHandler
        self.register("/", "Home", "Landing page", self._landing_page)
        self.register("/healthz", "Health",
                      "degradation probe (503 while degraded; includes "
                      "external dependencies — not a kubelet livenessProbe)",
                      self.health.handle_healthz)
        self.register("/readyz", "Readiness",
                      "readiness probe (503 until components are ready)",
                      self.health.handle_readyz)
        for addr in self._addresses:
            host, _, port = addr.rpartition(":")
            server = _CappedThreadingHTTPServer(
                (host or "0.0.0.0", int(port)), RequestHandler,
                max_connections=self._max_connections)
            if self._tls_cert and self._tls_key:
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                ctx.load_cert_chain(self._tls_cert, self._tls_key)
                server.socket = ctx.wrap_socket(server.socket,
                                                server_side=True)
            self._servers.append(server)
        log.info("api server listening on %s",
                 [s.server_address for s in self._servers])

    def run(self, ctx: CancelContext) -> None:
        for server in self._servers:
            t = threading.Thread(target=server.serve_forever,
                                 name="http-serve", daemon=True)
            t.start()
            self._threads.append(t)
        ctx.wait(None)

    def shutdown(self) -> None:
        """Graceful shutdown, 5 s bound (reference :158-165)."""
        self._draining = True
        for server in self._servers:
            server.shutdown()
            server.server_close()
        for t in self._threads:
            t.join(timeout=5.0)

    # -- internals ---------------------------------------------------------

    def _match(self, path: str) -> Endpoint | None:
        if path in self._endpoints:
            return self._endpoints[path]
        # prefix match for subtree handlers (e.g. /debug/...)
        best = None
        for ep_path, ep in self._endpoints.items():
            if ep_path != "/" and path.startswith(ep_path.rstrip("/") + "/"):
                if best is None or len(ep_path) > len(best.path):
                    best = ep
        return best

    def _landing_page(self, _request) -> tuple[int, dict[str, str], bytes]:
        rows = "".join(
            f'<li><a href="{html.escape(e.path)}">{html.escape(e.name)}</a>'
            f" — {html.escape(e.description)}</li>"
            for e in sorted(self._endpoints.values(), key=lambda e: e.path)
            if e.path != "/"
        )
        body = (
            "<html><head><title>kepler-tpu</title></head><body>"
            "<h1>kepler-tpu</h1><ul>" + rows + "</ul></body></html>"
        ).encode()
        return 200, {"Content-Type": "text/html; charset=utf-8"}, body

    def connection_stats(self) -> dict:
        """Connection-cap accounting across listeners (operator/test
        introspection; ``rejected_total`` counts accepts answered 503
        at the cap without ever spawning a handler thread)."""
        active = rejected = 0
        for s in self._servers:
            with s._conn_lock:
                active += s.active_connections
                rejected += s.rejected_connections_total
        return {"max_connections": self._max_connections,
                "active_connections": active,
                "rejected_total": rejected}

    @property
    def addresses(self) -> list[tuple[str, int]]:
        """Actual bound (host, port) pairs — ports resolve 0 → ephemeral."""
        return [s.server_address for s in self._servers]
