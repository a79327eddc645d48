"""Admin HTTP endpoint: /metrics, /healthz and /statusz, with a / index.

Port of paddle_tpu's `observability/admin.py` `AdminServer`: a stdlib
``http.server`` front-end the decode daemon mounts on ``--metrics-port``
/ ``PADDLE_TPU_METRICS_PORT`` — off by default, loopback by default like
the data-plane socket. All routes are GET:

  * ``/``         — index: every endpoint this server mounts, as links.
  * ``/metrics``  — Prometheus text exposition 0.0.4 from the registry
    (Content-Type ``text/plain; version=0.0.4``).
  * ``/healthz``  — liveness: 200 ``{"status": "ok"}`` while the supplied
    ``health_fn`` reports healthy, 503 with the reasons list otherwise.
  * ``/statusz``  — one JSON snapshot from ``status_fn`` plus uptime.

Any other path, the JAX package's ``/tracez``, ``/profilez``, ``/memz``,
``/varz`` and ``/alertz`` among them (not ported yet), answers 404 with
the list of mounted endpoints. Handlers never run model code, so a scrape
cannot perturb the request path beyond a registry read.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple

from . import metrics as _metrics

__all__ = ["AdminServer", "CONTENT_TYPE_METRICS"]

CONTENT_TYPE_METRICS = "text/plain; version=0.0.4; charset=utf-8"


class AdminServer:
    """Serves the observability surface for one process.

    ``health_fn() -> (healthy, reasons)``: reasons is a list of strings
    explaining an unhealthy verdict (empty when healthy). ``status_fn()
    -> dict`` supplies the /statusz body. Both default to trivial
    implementations, so the server is usable standalone."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 health_fn: Optional[
                     Callable[[], Tuple[bool, list]]] = None,
                 status_fn: Optional[Callable[[], dict]] = None):
        self.registry = registry or _metrics.REGISTRY
        self.health_fn = health_fn or (lambda: (True, []))
        self.status_fn = status_fn
        self._t0 = time.monotonic()
        admin = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):     # stdout belongs to the daemon
                pass

            def _reply(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        body = admin.registry.render().encode()
                        self._reply(200, body, CONTENT_TYPE_METRICS)
                    elif path == "/healthz":
                        ok, reasons = admin._health()
                        body = json.dumps(
                            {"status": "ok" if ok else "unhealthy",
                             "reasons": list(reasons)}).encode()
                        self._reply(200 if ok else 503, body,
                                    "application/json")
                    elif path == "/statusz":
                        body = json.dumps(admin._status(),
                                          default=str).encode()
                        self._reply(200, body, "application/json")
                    elif path == "/":
                        self._reply(200, admin._index().encode(),
                                    "text/html; charset=utf-8")
                    else:
                        self._reply(
                            404,
                            json.dumps({"error": "unknown path",
                                        "endpoints": sorted(
                                            admin.endpoints())}).encode(),
                            "application/json")
                except BrokenPipeError:
                    pass
                except Exception as e:   # a handler bug must not 500 raw
                    try:
                        self._reply(
                            500,
                            json.dumps({"error": repr(e)}).encode(),
                            "application/json")
                    except OSError:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.25},
                                        daemon=True,
                                        name=f"admin-http-{self.port}")
        self._thread.start()

    @staticmethod
    def endpoints() -> dict:
        """path -> one-line description for every mounted route."""
        return {
            "/metrics": "Prometheus text exposition (registry scrape)",
            "/healthz": "liveness verdict (200 ok / 503 + reasons)",
            "/statusz": "one-shot JSON status snapshot",
        }

    def _index(self) -> str:
        rows = "\n".join(
            f'  <li><a href="{p}"><code>{p}</code></a> — {desc}</li>'
            for p, desc in sorted(self.endpoints().items()))
        return ("<!DOCTYPE html>\n<html><head>"
                "<title>paddle_tpu_torch admin</title></head>\n"
                f"<body><h1>paddle_tpu_torch admin :{self.port}</h1>\n"
                f"<ul>\n{rows}\n</ul></body></html>\n")

    # a raising callback degrades to "unhealthy, reason" / a minimal
    # status body instead of a 500
    def _health(self) -> Tuple[bool, list]:
        try:
            ok, reasons = self.health_fn()
            return bool(ok), list(reasons or [])
        except Exception as e:
            return False, [f"health check raised: {e!r}"]

    def _status(self) -> dict:
        base = {"uptime_s": round(time.monotonic() - self._t0, 3)}
        if self.status_fn is not None:
            try:
                base.update(self.status_fn())
            except Exception as e:
                base["status_error"] = repr(e)
        return base

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
