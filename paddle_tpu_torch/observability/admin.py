"""Admin HTTP endpoint: /metrics, /healthz, /statusz, /varz, /alertz,
/tracez, /profilez, /memz, with a / index.

Port of paddle_tpu's `observability/admin.py`: a stdlib ``http.server``
front-end (no new dependencies) the decode daemon exposes on
``--metrics-port`` / ``PADDLE_TPU_METRICS_PORT`` — off by default;
loopback by default, like the data-plane socket. All routes are GET:

  * ``/``         — index: every endpoint this server mounts, as links.
  * ``/metrics``  — Prometheus text exposition 0.0.4 from the registry
    (Content-Type ``text/plain; version=0.0.4``), scrape-ready.
  * ``/healthz``  — liveness: 200 ``{"status": "ok"}`` while the
    supplied ``health_fn`` reports healthy, 503 with the reasons list
    otherwise (a load balancer or k8s probe points here).
  * ``/statusz``  — one JSON snapshot: serve stats, engine state,
    warmup, per-device memory, the memory plane, uptime, config.
  * ``/varz``     — bounded windowed history (``varz_fn``, normally
    :meth:`..timeseries.TimeSeriesStore.varz`); 404 when not mounted.
  * ``/alertz``   — SLO verdicts (``alertz_fn``, normally
    :meth:`..slo.SLOEngine.alertz`); 404 when not mounted.
  * ``/tracez``   — the event ring as Chrome trace-event JSON (open in
    ui.perfetto.dev). Defaults to this process's ring; a router mounts
    a merged fleet view instead.
  * ``/profilez`` — per-executable continuous-profiler summary, top-N
    by total block time.
  * ``/memz``     — the memory plane: every registered page pool's
    per-owner attribution, fragmentation map and ghost-page audit;
    ``/memz?oom=1`` serves the retained OOM forensic dumps. Defaults
    to this process's pools; a router mounts a merged fleet view.

Handlers never execute model code, so a scrape can never trigger a
kernel launch or perturb the request path beyond a registry/ring read.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple

from . import memz as _memz
from . import metrics as _metrics
from . import profilez as _profilez
from . import tracez as _tracez

__all__ = ["AdminServer", "CONTENT_TYPE_METRICS"]

CONTENT_TYPE_METRICS = "text/plain; version=0.0.4; charset=utf-8"


class AdminServer:
    """Serves the observability surface for one process.

    ``health_fn() -> (healthy, reasons)``: reasons is a list of strings
    explaining an unhealthy verdict (empty when healthy). ``status_fn()
    -> dict`` supplies the /statusz body; both default to trivial
    always-healthy implementations so the server is usable standalone.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 health_fn: Optional[
                     Callable[[], Tuple[bool, list]]] = None,
                 status_fn: Optional[Callable[[], dict]] = None,
                 varz_fn: Optional[Callable[[], dict]] = None,
                 alertz_fn: Optional[Callable[[], dict]] = None,
                 tracez_fn: Optional[Callable[[], dict]] = None,
                 profilez_fn: Optional[Callable[[], dict]] = None,
                 memz_fn: Optional[Callable[..., dict]] = None):
        self.registry = registry or _metrics.REGISTRY
        self.health_fn = health_fn or (lambda: (True, []))
        self.status_fn = status_fn
        self.varz_fn = varz_fn
        self.alertz_fn = alertz_fn
        # tracez/profilez default to the process-global ring/profiler so
        # every admin server ships the execution timeline; a router
        # passes its own tracez_fn to serve a merged fleet view
        self.tracez_fn = tracez_fn or (lambda: _tracez.RING.chrome_trace())
        self.profilez_fn = profilez_fn or \
            (lambda: _profilez.PROFILER.profilez())
        # memz defaults to the process pool registry; a router passes a
        # memz_fn serving the merged fleet view. Called as
        # memz_fn(oom=<bool>) from the ?oom=1 query.
        self.memz_fn = memz_fn or _memz.snapshot
        self._t0 = time.monotonic()
        admin = self

        class _Handler(BaseHTTPRequestHandler):
            # one admin request must not block the next: ThreadingHTTPServer
            # already threads per connection; keep them short-lived
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):     # stdout belongs to SERVE_STATS
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
                    elif path == "/varz" and admin.varz_fn is not None:
                        body = json.dumps(admin.varz_fn(),
                                          default=str).encode()
                        self._reply(200, body, "application/json")
                    elif path == "/alertz" and \
                            admin.alertz_fn is not None:
                        body = json.dumps(admin.alertz_fn(),
                                          default=str).encode()
                        self._reply(200, body, "application/json")
                    elif path == "/tracez":
                        body = json.dumps(admin.tracez_fn(),
                                          default=str).encode()
                        self._reply(200, body, "application/json")
                    elif path == "/profilez":
                        body = json.dumps(admin.profilez_fn(),
                                          default=str).encode()
                        self._reply(200, body, "application/json")
                    elif path == "/memz":
                        from urllib.parse import parse_qs, urlsplit
                        q = parse_qs(urlsplit(self.path).query)
                        oom = (q.get("oom") or ["0"])[0] \
                            not in ("", "0", "false")
                        body = json.dumps(admin.memz_fn(oom=oom),
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

    def endpoints(self) -> dict:
        """path -> one-line description for every mounted route."""
        out = {
            "/metrics": "Prometheus text exposition (registry scrape)",
            "/healthz": "liveness verdict (200 ok / 503 + reasons)",
            "/statusz": "one-shot JSON status snapshot",
            "/tracez": "event ring as Chrome trace-event JSON "
                       "(open in ui.perfetto.dev)",
            "/profilez": "per-executable profiler, top-N by block time",
            "/memz": "page-pool owner attribution + ghost audit "
                     "(?oom=1 = retained OOM forensic dumps)",
        }
        if self.varz_fn is not None:
            out["/varz"] = "windowed time-series history"
        if self.alertz_fn is not None:
            out["/alertz"] = "SLO burn-rate verdicts"
        return out

    def _index(self) -> str:
        """The / index page: mounted endpoints as links, so operators
        stop guessing paths."""
        rows = "\n".join(
            f'  <li><a href="{p}"><code>{p}</code></a> — {desc}</li>'
            for p, desc in sorted(self.endpoints().items()))
        return ("<!DOCTYPE html>\n<html><head>"
                "<title>paddle_tpu_torch admin</title></head>\n"
                f"<body><h1>paddle_tpu_torch admin :{self.port}</h1>\n"
                f"<ul>\n{rows}\n</ul></body></html>\n")

    # wrapped so a raising callback degrades to "unhealthy, reason" /
    # a minimal status body instead of a 500
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
