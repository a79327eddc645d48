"""Observability for the port: the metrics registry, the admin plane,
request spans, tracez, profilez, memz, varz / SLO and the stall flight
recorder — paddle_tpu's `observability` package, module for module.

  * :mod:`.metrics` — thread-safe, label-aware Counter / Gauge /
    Histogram families with Prometheus text exposition; the global
    :data:`REGISTRY` is what ``core.monitor`` stat shims, the
    ``profiler`` serve/step/compile aggregates, the decode engine's
    families and the span histograms all write into.
  * :mod:`.admin` — stdlib-HTTP ``/metrics`` + ``/healthz`` +
    ``/statusz`` + ``/varz`` + ``/alertz`` + ``/tracez`` + ``/profilez``
    + ``/memz`` server the decode daemon mounts on ``--metrics-port``.
  * :mod:`.spans` — per-request span breakdowns + sampled JSONL traces
    (``PADDLE_TPU_TRACE_SAMPLE``).
  * :mod:`.flight_recorder` — the stall watchdog
    (``PADDLE_TPU_STALL_DUMP``): all-thread stack dumps when a busy
    pipeline stops making progress.
  * :mod:`.tracez` — the always-on bounded event ring + Chrome
    trace-event exporter (``/tracez``, Perfetto-loadable, merged
    across processes via wall-clock anchoring).
  * :mod:`.profilez` — the continuous per-entry-point profiler fed by
    the decode engines' dispatch hook (``paddle_tpu_exec_*``,
    ``/profilez``).
  * :mod:`.memz` — the memory plane: page-level owner attribution over
    registered page pools, the bounded allocation event ring, OOM
    forensic dumps, and the ghost-page audit (``paddle_tpu_mem_*``,
    ``/memz``).
  * :mod:`.timeseries` / :mod:`.slo` — windowed history of the registry
    (``/varz``) and burn-rate verdicts over it (``/alertz``).
"""
from __future__ import annotations

import time as _time

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      REGISTRY, counter, gauge, histogram,
                      DEFAULT_BUCKETS)
from .admin import AdminServer
from .spans import (SpanRecorder, next_request_id, request_id_base,
                    trace_sample_rate)
from .flight_recorder import (FlightRecorder, capture_thread_stacks,
                              stall_dump_dir, stall_timeout)
from .timeseries import TimeSeriesStore, varz_interval, varz_capacity
from .slo import (Objective, SLOEngine, slo_windows, slo_burn_factors,
                  serve_objectives, router_objectives)
from .tracez import (TraceRing, RING, ring_capacity, merge_traces,
                     fetch_trace, load_trace)
from .profilez import ExecProfiler, PROFILER
from .memz import (MemRing, RING as MEM_RING, register_pool,
                   capture_oom, oom_dumps, merge_memz, fetch_memz)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "counter", "gauge", "histogram", "DEFAULT_BUCKETS",
           "AdminServer", "SpanRecorder", "next_request_id",
           "request_id_base", "trace_sample_rate", "FlightRecorder",
           "capture_thread_stacks", "stall_dump_dir", "stall_timeout",
           "TimeSeriesStore", "varz_interval", "varz_capacity",
           "Objective", "SLOEngine", "slo_windows", "slo_burn_factors",
           "serve_objectives", "router_objectives",
           "TraceRing", "RING", "ring_capacity", "merge_traces",
           "fetch_trace", "load_trace", "ExecProfiler", "PROFILER",
           "MemRing", "MEM_RING", "register_pool", "capture_oom",
           "oom_dumps", "merge_memz", "fetch_memz",
           "install_default_collectors"]

_PROC_T0 = _time.monotonic()
_collectors_installed = False

_UPTIME = gauge("paddle_tpu_uptime_seconds",
                "Seconds since the observability layer was imported "
                "into this process.")
_HBM_IN_USE = gauge("paddle_tpu_hbm_bytes_in_use",
                    "Per-device HBM bytes in use (torch.cuda.memory_stats).",
                    labelnames=("device",))
_HBM_PEAK = gauge("paddle_tpu_hbm_peak_bytes_in_use",
                  "Per-device peak HBM bytes in use.",
                  labelnames=("device",))
_HBM_LIMIT = gauge("paddle_tpu_hbm_bytes_limit",
                   "Per-device HBM capacity reported by the runtime.",
                   labelnames=("device",))


def _collect_uptime():
    _UPTIME.set(_time.monotonic() - _PROC_T0)


def _collect_hbm():
    # lazy import: the registry itself must stay importable without torch
    from ..core import monitor as _monitor
    for dev, st in _monitor.all_device_memory_stats().items():
        if not st:
            continue
        _HBM_IN_USE.labels(device=dev).set(st.get("bytes_in_use", 0))
        _HBM_PEAK.labels(device=dev).set(st.get("peak_bytes_in_use", 0))
        _HBM_LIMIT.labels(device=dev).set(st.get("bytes_limit", 0))


def install_default_collectors(registry: MetricsRegistry = REGISTRY):
    """Register the uptime + per-device memory collectors (idempotent).

    Explicit rather than import-time because the memory collector
    initializes CUDA at scrape time — the serve daemon opts in; a unit
    test importing the registry does not pay for it. The families keep
    the JAX package's ``paddle_tpu_hbm_*`` names (the card's device
    memory is HBM too)."""
    global _collectors_installed
    registry.add_collector(_collect_uptime)
    registry.add_collector(_collect_hbm)
    _collectors_installed = True
