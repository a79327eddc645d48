"""Observability for the port: the metrics registry and the admin plane.

  * :mod:`.metrics` — thread-safe, label-aware Counter / Gauge / Histogram
    families with Prometheus text exposition; the decode engine's
    ``paddle_tpu_decode_*`` families live in the global :data:`REGISTRY`.
  * :mod:`.admin` — stdlib-HTTP ``/metrics`` + ``/healthz`` + ``/statusz``
    server the decode daemon mounts on ``--metrics-port``.

The JAX package's spans, flight recorder, tracez, profilez, memz, varz
and SLO engine are not ported yet.
"""
from __future__ import annotations

from .admin import AdminServer
from .metrics import (DEFAULT_BUCKETS, REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry, counter, gauge, histogram)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "counter", "gauge", "histogram", "DEFAULT_BUCKETS",
           "AdminServer"]
