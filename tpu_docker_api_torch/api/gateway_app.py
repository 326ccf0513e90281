"""L7 gateway listener: the thin HTTP front of service/gateway.py.

A separate ThreadingHTTPServer from the control-plane API on purpose —
the gateway is stateless, N instances are allowed, and serving traffic
must not contend with control mutations for listener threads. Routes:

- ``GET /healthz``  — gateway liveness + routing-table summary
- ``GET /metrics``  — this instance's Prometheus registry
- ``*   /v1/{service}/<rest>`` — proxied to a replica of ``service``
  (e.g. ``POST /v1/llm/generate`` → replica ``POST /generate``), with
  retry/hedge/breaker/drain semantics applied by the Gateway engine.

Streaming upstream replies (the replica's chunked ndjson token stream)
are relayed chunk-for-chunk; a mid-stream upstream death arrives as one
final typed ``{"gatewayTruncated": true, ...}`` line, never a silent
EOF. Typed sheds (429/503) carry Retry-After so well-behaved clients
back off instead of hammering a saturated fleet.

The port's copy of ``tpu_docker_api/api/gateway_app.py``, whole."""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.service.gateway import Gateway, GatewayResponse
from tpu_docker_api_torch.telemetry import trace

log = logging.getLogger(__name__)

#: bytes of request body to inspect for an affinity key ("prefixId")
_AFFINITY_SCAN_BYTES = 64 * 1024
#: seconds a shed client should wait before retrying
_RETRY_AFTER_S = "1"


def _affinity_key(headers, body: bytes) -> str | None:
    """The prompt-prefix affinity key: an explicit ``X-Prefix-Key``
    header wins; otherwise a bounded peek at the JSON body for the
    replica protocol's ``prefixId`` field (serve/__main__.py). No key ⇒
    least-loaded routing."""
    explicit = headers.get("X-Prefix-Key")
    if explicit:
        return explicit[:256]
    if not body or len(body) > _AFFINITY_SCAN_BYTES:
        return None
    try:
        parsed = json.loads(body)
    except (ValueError, UnicodeDecodeError):
        return None
    if isinstance(parsed, dict):
        pid = parsed.get("prefixId")
        if isinstance(pid, str) and pid:
            return pid[:256]
    return None


def build_gateway_handler(gw: Gateway):
    registry = gw.registry

    class GatewayHandler(BaseHTTPRequestHandler):
        server_version = "tpu-docker-gateway"
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug("gateway http: " + fmt, *args)

        # -- framing helpers -------------------------------------------------------

        def _send_json(self, status: int, obj: dict,
                       extra: list[tuple[str, str]] | None = None,
                       req_id: str = "", span=None) -> None:
            payload = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            if req_id:
                self.send_header("X-Request-Id", req_id)
            if span is not None:
                tp_out = trace.format_traceparent(span)
                if tp_out:
                    self.send_header("traceparent", tp_out)
            for k, v in extra or []:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _chunk(self, data: bytes) -> None:
            self.wfile.write(f"{len(data):x}\r\n".encode())
            self.wfile.write(data)
            self.wfile.write(b"\r\n")

        # -- dispatch --------------------------------------------------------------

        def _handle(self, method: str) -> None:
            path, _, _query = self.path.partition("?")
            if method == "GET" and path == "/metrics":
                body = registry.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if method == "GET" and path == "/healthz":
                self._send_json(200, {"status": "ok",
                                      "gateway": gw.status_view()})
                return
            parts = [p for p in path.split("/") if p]
            if len(parts) < 2 or parts[0] != "v1":
                self._send_json(404, {"code": 404,
                                      "msg": f"no gateway route for "
                                             f"{method} {path}"})
                return
            service = parts[1]
            upstream_path = "/" + "/".join(parts[2:])
            self._proxy(method, service, upstream_path)

        def _proxy(self, method: str, service: str,
                   upstream_path: str) -> None:
            tp = trace.parse_traceparent(self.headers.get("traceparent"))
            raw_id = self.headers.get("X-Request-Id") or ""
            req_id = ("".join(c for c in raw_id
                              if c.isprintable() and c not in "\r\n")[:128]
                      or (tp[0] if tp else uuid.uuid4().hex[:12]))
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            headers = {k: v for k, v in self.headers.items()}
            prefix_key = _affinity_key(self.headers, body)
            t0 = time.perf_counter()
            tracer = gw.tracer
            # the gateway span joins the control-plane trace model: the
            # client's traceparent continues here, and format_traceparent
            # of THIS span rides upstream so the replica's own spans (and
            # any control-plane calls it makes) nest under the gateway hop
            span_scope = (tracer.span(
                f"gateway:{method} /v1/{service}",
                trace_id=(tp[0] if tp else req_id),
                parent_id=(tp[1] if tp else ""),
                root=True,
                attrs={"method": method, "service": service,
                       "requestId": req_id})
                if tracer is not None else trace.NOOP)
            with span_scope as span:
                tp_up = (trace.format_traceparent(span)
                         if span is not None else None) \
                    or self.headers.get("traceparent")
                try:
                    resp = gw.request(service, method, upstream_path,
                                      headers, body,
                                      prefix_key=prefix_key,
                                      traceparent=tp_up)
                except errors.ApiError as e:
                    if span is not None:
                        span.status = "error"
                        span.attrs["code"] = e.code
                    self._send_json(
                        e.http_status or 503,
                        {"code": e.code, "msg": str(e)},
                        extra=[("Retry-After", _RETRY_AFTER_S)],
                        req_id=req_id, span=span)
                    return
                except Exception as e:  # noqa: BLE001 — envelope it
                    log.exception("gateway proxy failure %s %s",
                                  method, self.path)
                    if span is not None:
                        span.status = "error"
                    self._send_json(502, {"code": 502, "msg": str(e)},
                                    req_id=req_id, span=span)
                    return
                if span is not None:
                    span.attrs.update({"endpoint": resp.endpoint,
                                       "attempts": resp.attempts,
                                       "hedged": resp.hedged,
                                       "status": resp.status})
                self._relay(resp, req_id, span)
            registry.observe(
                "gateway_request_ms", (time.perf_counter() - t0) * 1e3,
                {"service": service, "method": method},
                buckets=(1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500,
                         5000, 10000, 30000),
                help="Gateway end-to-end request wall time (ms)")

        def _relay(self, resp: GatewayResponse, req_id: str, span) -> None:
            self.send_response(resp.status)
            for k, v in resp.headers:
                self.send_header(k, v)
            self.send_header("X-Request-Id", req_id)
            self.send_header("X-Gateway-Endpoint", resp.endpoint)
            self.send_header("X-Gateway-Attempts", str(resp.attempts))
            if span is not None:
                tp_out = trace.format_traceparent(span)
                if tp_out:
                    self.send_header("traceparent", tp_out)
            if resp.stream is None:
                payload = resp.body or b""
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for chunk in resp.stream:
                    if chunk:
                        self._chunk(chunk)
                self._chunk(b"")
            except (BrokenPipeError, ConnectionResetError):
                # CLIENT went away mid-stream: the generator's finally
                # clause closes the upstream side un-pooled
                resp.stream.close()
                self.close_connection = True

        def do_GET(self):  # noqa: N802
            self._handle("GET")

        def do_POST(self):  # noqa: N802
            self._handle("POST")

        def do_DELETE(self):  # noqa: N802
            self._handle("DELETE")

        def do_PATCH(self):  # noqa: N802
            self._handle("PATCH")

        def do_PUT(self):  # noqa: N802
            self._handle("PUT")

    return GatewayHandler


class GatewayServer:
    """Bind/serve/close wrapper, same shape as api.app.ApiServer."""

    def __init__(self, gw: Gateway, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.gateway = gw
        self._httpd = ThreadingHTTPServer((host, port),
                                          build_gateway_handler(gw))
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        self.gateway.advertise = \
            f"{self._httpd.server_address[0]}:{self.port}"
        self.gateway.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="gateway-serve",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join()
            self._thread = None
        self.gateway.close()
