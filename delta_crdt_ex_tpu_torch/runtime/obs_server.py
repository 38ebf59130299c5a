"""Per-process HTTP observability endpoint — the PyTorch port's own copy
of ``delta_crdt_ex_tpu/runtime/obs_server.py``.

Stdlib-only (``http.server``) export of the metrics plane built in
:mod:`delta_crdt_ex_tpu_torch.runtime.metrics`:

- ``GET /metrics`` — Prometheus text exposition 0.0.4 of the plane's
  registry (bridge-fed event metrics + scrape-time collector gauges);
- ``GET /healthz`` — liveness/readiness JSON: every registered health
  check (replica event loop responsive, WAL writable, neighbours
  reachable via the existing monitor/heartbeat state; fleet tick
  freshness; a serving front door not shedding). HTTP 200 when every
  check passes, 503 otherwise — the k8s-style probe contract;
- ``GET /varz`` — one JSON snapshot unifying ``Replica.stats()`` /
  ``Fleet.stats()`` / WAL stats under a single schema (each source is
  ``{"kind": ..., "stats": ...}``; the underlying dicts are unchanged).

One :class:`ObsServer` per process is the expected shape (Prometheus
scrapes processes); ``port=0`` binds an ephemeral port for tests. The
server runs on daemon threads (``ThreadingHTTPServer``) and every
handler builds its whole response before writing, holding no runtime
lock across socket I/O.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

logger = logging.getLogger("delta_crdt_ex_tpu_torch")


def _jsonable(obj):
    """Best-effort JSON coercion for stats payloads: addresses may be
    tuples (TCP ``(name, (host, port))``), numpy scalars or one-element
    tensors may leak in — none must 500 the page."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(obj)


class _Handler(BaseHTTPRequestHandler):
    server_version = "crdt-obs/1"
    #: set per server class (see ObsServer.start)
    obs = None

    def _reply(self, code: int, content_type: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 - stdlib handler contract
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = self.obs.registry.render().encode()
                self._reply(
                    200, "text/plain; version=0.0.4; charset=utf-8", body
                )
            elif path == "/healthz":
                ok, checks = self.obs.health()
                body = json.dumps(
                    {"status": "ok" if ok else "unhealthy",
                     "checks": _jsonable(checks)},
                    indent=2,
                ).encode()
                self._reply(200 if ok else 503, "application/json", body)
            elif path == "/varz":
                snap = self.obs.varz()
                snap["metrics_families"] = self.obs.registry.families()
                body = json.dumps(_jsonable(snap), indent=2).encode()
                self._reply(200, "application/json", body)
            elif path == "/":
                body = (
                    b"crdt observability endpoint: /metrics /healthz /varz\n"
                )
                self._reply(200, "text/plain; charset=utf-8", body)
            else:
                self._reply(404, "text/plain; charset=utf-8", b"not found\n")
        except Exception:  # a scrape must never take the process down
            logger.exception("obs endpoint %s failed", path)
            try:
                self._reply(
                    500, "text/plain; charset=utf-8", b"internal error\n"
                )
            except OSError:
                pass

    def log_message(self, fmt, *args) -> None:  # scrapes are not log news
        logger.debug("obs http: " + fmt, *args)


class ObsServer:
    """The per-process ``/metrics`` + ``/healthz`` + ``/varz`` endpoint
    for one :class:`~delta_crdt_ex_tpu_torch.runtime.metrics.Observability`
    plane. ``port=0`` binds an ephemeral port (tests / several planes
    per host); :attr:`url` names the bound address."""

    def __init__(self, obs, *, host: str = "127.0.0.1", port: int = 0):
        self.obs = obs
        self._host = host
        self._port = int(port)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple:
        if self._httpd is None:
            raise RuntimeError("obs server not started")
        return self._httpd.server_address

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "ObsServer":
        if self._httpd is not None:
            return self
        handler = type("ObsHandler", (_Handler,), {"obs": self.obs})
        httpd = ThreadingHTTPServer((self._host, self._port), handler)
        httpd.daemon_threads = True
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever,
            name=f"crdt-obs-{httpd.server_address[1]}",
            daemon=True,
        )
        self._thread.start()
        logger.info("observability endpoint at %s", self.url)
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


__all__ = ["ObsServer"]
