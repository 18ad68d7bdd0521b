"""Live scrape surface for the serving engine: a stdlib ``http.server``
thread exposing the telemetry this process already keeps.

The port of :mod:`repro.obs.http`, whole, over the port's registry and
recorder.

Endpoints (GET):

* ``/metrics``  — the registry as Prometheus text exposition
  (:func:`repro_torch.obs.metrics.prometheus_text`), byte-identical to
  ``launch.stats snapshot --prom`` over the same registry state.
* ``/requests`` — in-flight serving requests as JSON: current phase,
  phase age, total age (from :func:`repro_torch.obs.tracing.active_requests`).
* ``/trace``    — the request-lifecycle buffer as Chrome trace-event JSON
  (:func:`repro_torch.obs.tracing.chrome_trace`); save and load in Perfetto.

The server is a daemon thread (it never blocks interpreter exit) bound to
localhost by default — this is an operator scrape port, not a public API.
``launch/serve.py`` starts one when ``REPRO_METRICS_PORT`` is set
(:func:`maybe_serve_from_env`); anything else can call
:func:`serve_metrics` directly (port 0 picks an ephemeral port, read it
back from ``server.port``).
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import metrics as _m
from . import tracing as _tracing

__all__ = [
    "MetricsServer",
    "current_server",
    "maybe_serve_from_env",
    "serve_metrics",
    "shutdown",
]

_ENV_VAR = "REPRO_METRICS_PORT"

_INDEX = (
    "repro_torch.obs scrape surface\n"
    "  /metrics   Prometheus text exposition\n"
    "  /requests  in-flight request states (JSON)\n"
    "  /trace     Chrome trace-event JSON (load in Perfetto)\n"
)


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args) -> None:  # no per-request stderr chatter
        pass

    def do_GET(self) -> None:
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = _m.prometheus_text().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/requests":
            body = json.dumps(_tracing.active_requests()).encode()
            ctype = "application/json"
        elif path == "/trace":
            body = json.dumps(_tracing.chrome_trace()).encode()
            ctype = "application/json"
        elif path in ("/", "/healthz"):
            body = _INDEX.encode()
            ctype = "text/plain; charset=utf-8"
        else:
            self.send_error(404, "unknown endpoint")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class MetricsServer:
    """One scrape server: ``ThreadingHTTPServer`` + daemon accept thread."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1") -> None:
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="repro-torch-metrics-http",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


_server: Optional[MetricsServer] = None
_lock = threading.Lock()


def serve_metrics(port: int = 0, host: str = "127.0.0.1") -> MetricsServer:
    """Start (or return the already-running) scrape server."""
    global _server
    with _lock:
        if _server is None:
            _server = MetricsServer(port=port, host=host)
        return _server


def current_server() -> Optional[MetricsServer]:
    return _server


def shutdown() -> None:
    """Stop the scrape server if one is running (idempotent)."""
    global _server
    with _lock:
        if _server is not None:
            _server.stop()
            _server = None


def maybe_serve_from_env() -> Optional[MetricsServer]:
    """Start the server iff ``REPRO_METRICS_PORT`` is set (non-empty).
    ``REPRO_METRICS_PORT=0`` binds an ephemeral port (useful in tests/CI —
    read it back from the returned server)."""
    env = os.environ.get(_ENV_VAR, "")
    if not env:
        return None
    return serve_metrics(port=int(env))
