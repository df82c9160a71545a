"""Stdlib HTTP exporter: ``/metrics`` (Prometheus text) + ``/healthz``.

A copy of ``lance_distributed_training_tpu/obs/http.py`` for the port. The
port has no compile tracker (XLA compiles have no counterpart yet), so
:func:`build_info` lists the leak and wire sanitizers only; the JAX module
imports all three in one ``try``.

One tiny ``ThreadingHTTPServer`` on a daemon thread, serving a
:class:`~.registry.MetricsRegistry` — the scrape surface for the
``DataService`` (``ldt serve-data --metrics_port``) and the trainer
(``ldt train --metrics_port``). No dependencies beyond the stdlib, no
framework: two GET routes and a 404.

* ``GET /metrics`` — Prometheus text exposition (version 0.0.4) of every
  counter/gauge/histogram in the registry.
* ``GET /healthz`` — JSON liveness: ``{"status": "ok", ...}`` merged with
  the owner's ``healthz_fn()`` extras (queue depths, client liveness, …).
  Any ``status`` other than ``"ok"`` (including a raising ``healthz_fn``,
  reported as ``"degraded"`` with the error) serves HTTP 503 so
  status-code-keyed probes can act on it — always as a fast, well-formed
  JSON body, never an unhandled 500 into a scraper's timeout path.

:func:`build_info` is the shared "what is this process" block the
``/healthz`` owners (DataService, Coordinator) merge in: package version,
spoken protocol range, which opt-in runtime sanitizers are active, and
uptime — the answer to "which build/config is the thing I'm scraping".
"""

from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from .registry import MetricsRegistry, default_registry

__all__ = ["MetricsHTTPServer", "build_info"]

_PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Process-start anchor for uptime (module import ≈ process start for every
# CLI entry; a duration, so monotonic — LDT601).
_START_MONO = time.monotonic()


def build_info() -> dict:
    """Identify this running process: the ``/healthz`` build-info block.

    Imports are lazy (and failure-tolerant) so a scrape can never break
    on a partially-present build, and so this module keeps its
    no-service-deps posture at import time."""
    out: dict = {"uptime_s": round(time.monotonic() - _START_MONO, 1)}
    try:
        from .. import __version__

        out["version"] = __version__
    except Exception:  # noqa: BLE001 — health must not 500
        out["version"] = "unknown"
    try:
        from ..service import protocol as P

        out["protocol_versions"] = [
            P.MIN_PROTOCOL_VERSION, P.PROTOCOL_VERSION
        ]
    except Exception:  # noqa: BLE001
        pass
    sanitizers = []
    try:
        from ..utils import compiletrack, leaktrack, wiretrack

        for name, mod in (("leak", leaktrack), ("wire", wiretrack),
                          ("compile", compiletrack)):
            if mod.enabled():
                sanitizers.append(name)
    except Exception:  # noqa: BLE001
        pass
    out["sanitizers_active"] = sanitizers
    return out


class MetricsHTTPServer:
    """Serve a registry over HTTP until :meth:`stop`.

    ``port=0`` binds an ephemeral port (the bound one is ``self.port`` after
    :meth:`start` — tests and the CI smoke use this). ``host`` defaults to
    loopback: ``/healthz`` exposes dataset paths, peer addresses, and
    cursors with no auth, so serving beyond the host is an explicit opt-in
    (``--metrics_host 0.0.0.0`` on a fleet box behind its scrape network).
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        port: int = 0,
        host: str = "127.0.0.1",
        healthz_fn: Optional[Callable[[], dict]] = None,
    ):
        self.registry = registry if registry is not None else default_registry()
        self.host = host
        self.requested_port = port
        self.healthz_fn = healthz_fn
        self.port: Optional[int] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsHTTPServer":
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:  # scrapes are not news
                pass

            def _respond(self, status: int, content_type: str,
                         body: bytes) -> None:
                try:
                    self.send_response(status)
                    self.send_header("Content-Type", content_type)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    # Scrape timeout aborted the connection mid-write: the
                    # scraper is gone, a per-interval stderr traceback
                    # (socketserver's default handle_error) is just noise.
                    self.close_connection = True

            def do_GET(self) -> None:
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = exporter.registry.render_prometheus().encode()
                    self._respond(200, _PROM_CONTENT_TYPE, body)
                elif path == "/healthz":
                    payload = {"status": "ok"}
                    if exporter.healthz_fn is not None:
                        try:
                            payload.update(exporter.healthz_fn())
                        except Exception as exc:  # health must not 500
                            payload = {"status": "degraded",
                                       "error": repr(exc)}
                    # Status-code-keyed probes (k8s httpGet, LB checks) need
                    # a non-2xx to act on; 503 is still a fast, well-formed
                    # response — only an unhandled exception could hang a
                    # scraper, and that path is caught above.
                    status = 200 if payload.get("status") == "ok" else 503
                    self._respond(
                        status, "application/json",
                        json.dumps(payload).encode(),
                    )
                else:
                    self._respond(404, "text/plain", b"not found\n")

        class Server(ThreadingHTTPServer):
            daemon_threads = True  # a slow scraper never pins exit

            def handle_error(self, request, client_address) -> None:
                # Covers the disconnect raised at finish()/flush time, past
                # _respond's own guard — same rationale.
                exc = sys.exc_info()[1]
                if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
                    return
                super().handle_error(request, client_address)

        self._httpd = Server((self.host, self.requested_port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="ldt-metrics-http",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "MetricsHTTPServer":
        return self.start() if self._httpd is None else self

    def __exit__(self, *exc) -> None:
        self.stop()
