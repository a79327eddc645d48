"""Profiler: host event annotation + aggregated tables + device tracing.

Port of paddle_tpu's `profiler` (reference: RAII RecordEvent pushed at
every op, platform/profiler.h:127; EnableProfiler/DisableProfiler building
aggregated tables and a chrome trace, profiler.h:210; the CUPTI
DeviceTracer correlating kernel timestamps, device_tracer.h:43; python
surface fluid/profiler.py).

On the GPU, device-side timing belongs to CUPTI through
``torch.profiler``: `start_trace` / `stop_trace` / `trace` run
``torch.profiler.profile`` with the CPU activity and, when a card is
visible, the CUDA activity, and write a Chrome trace
(``trace_<pid>_<n>.json``) into the log directory, where the kernels'
own rows sit next to the host's. Host-side `RecordEvent` keeps the
reference's annotation API: it feeds BOTH the in-process aggregation
table (`summary`) and ``torch.profiler.record_function``, so host spans
land on the trace's timeline next to the device rows. Per-op rows come
from the port's dispatch choke point, ``amp.maybe_cast_inputs`` (every
library op reaches it through ``ops._dispatch.cast_in``, every
functional directly), under the dispatch names the JAX package's tape
records; an op row's time runs from its dispatch to the calling thread's
next profiler event (the next op's dispatch, a `RecordEvent` boundary or
`stop_profiler`), since the choke point sees an op start and not its
end.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional

from ..observability import metrics as _metrics

__all__ = ["RecordEvent", "start_profiler", "stop_profiler", "profiler",
           "start_trace", "stop_trace", "is_profiling", "summary",
           "record_compile", "compile_events", "reset_compile_events",
           "record_step", "step_timeline", "reset_step_timeline",
           "step_timeline_summary",
           "record_serve_batch", "record_serve_request",
           "record_serve_requests", "record_serve_error",
           "serve_stats", "reset_serve_stats"]

_lock = threading.Lock()
_events: List[tuple] = []      # (name, start, dur, thread_id)
_compiles: List[dict] = []     # {label, compile_s, cache}
_steps: List[dict] = []        # per-step timeline segments
_STEP_CAP = 100_000            # bound memory on very long runs
_enabled = False

# ---------------------------------------------------------------------------
# registry-backed aggregates: the observability registry is the single
# store for every scalar counter below (docs/observability.md catalog);
# this module keeps only the list-shaped views (event table, compile
# labels, step timeline) plus the reqs/s timestamp window.
# ---------------------------------------------------------------------------
_SRV_REQS = _metrics.counter(
    "paddle_tpu_serve_requests_total",
    "Requests answered successfully by the serving engine.")
_SRV_ERRS = _metrics.counter(
    "paddle_tpu_serve_errors_total",
    "Requests that resolved with an error.")
_SRV_BATCHES = _metrics.counter(
    "paddle_tpu_serve_batches_total",
    "Batches dispatched by the DynamicBatcher.")
_SRV_ROWS = _metrics.counter(
    "paddle_tpu_serve_batch_rows_total",
    "Real request rows packed into dispatched batches.")
_SRV_CAP = _metrics.counter(
    "paddle_tpu_serve_batch_capacity_rows_total",
    "Bucket-capacity rows dispatched (rows/capacity = occupancy).")
_SRV_REAL = _metrics.counter(
    "paddle_tpu_serve_real_elements_total",
    "Tensor elements dispatched before shape-bucket padding.")
_SRV_PADDED = _metrics.counter(
    "paddle_tpu_serve_padded_elements_total",
    "Tensor elements dispatched after shape-bucket padding "
    "(1 - real/padded = padding waste).")
_SRV_QDEPTH = _metrics.gauge(
    "paddle_tpu_serve_queue_depth",
    "Request queue depth observed at the most recent dispatch.")
_SRV_QMAX = _metrics.gauge(
    "paddle_tpu_serve_queue_depth_max",
    "Deepest the request queue has been since the last stats reset.")
_SRV_LAT = _metrics.histogram(
    "paddle_tpu_serve_request_latency_seconds",
    "Enqueue-to-result wall clock per successfully answered request.",
    sample_cap=100_000)        # reservoir: exact p50/p95/p99 below
_COMPILE_N = _metrics.counter(
    "paddle_tpu_compile_total",
    "Explicit compiles recorded via profiler.record_compile.")
_COMPILE_S = _metrics.counter(
    "paddle_tpu_compile_seconds_total",
    "Seconds spent in explicit compiles.")
_STEP_N = _metrics.counter(
    "paddle_tpu_train_steps_total",
    "Train steps retired through the async step pipeline.")
_STEP_BLOCKED_S = _metrics.counter(
    "paddle_tpu_train_host_blocked_seconds_total",
    "Host wall clock blocked waiting on device step results.")
_STEP_INFLIGHT = _metrics.gauge(
    "paddle_tpu_train_steps_in_flight",
    "Dispatched-but-unfetched steps at the last retirement.")


def is_profiling() -> bool:
    with _lock:
        return _enabled


class RecordEvent:
    """RAII/contextmanager/decorator annotation (profiler.h:127 analog).

        with profiler.RecordEvent("data_load"):
            ...
    Active even when only the device trace is on
    (``torch.profiler.record_function``); the table row is recorded only
    while the host profiler is enabled."""

    def __init__(self, name: str):
        self.name = name
        self._ann = None
        self._t0 = None

    def __enter__(self):
        _close_op(time.perf_counter())
        import torch
        self._ann = torch.profiler.record_function(self.name)
        self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        now = time.perf_counter()
        dur = now - self._t0
        self._ann.__exit__(*exc)
        # read _enabled INSIDE the lock: stop_profiler() flips it under
        # the same lock, so an exit racing a disable either lands in the
        # table or cleanly doesn't — never appends to a list summary()
        # is snapshotting
        with _lock:
            if _enabled:
                _close_op_locked(threading.get_ident(), now)
                _events.append((self.name, self._t0, dur,
                                threading.get_ident()))
        return False

    def __call__(self, fn):
        def wrapped(*a, **k):
            with RecordEvent(self.name):
                return fn(*a, **k)
        return wrapped


# per-thread open op row: (name, start); closed by the thread's next
# profiler event or by stop_profiler
_open_ops: Dict[int, tuple] = {}


def _close_op_locked(tid: int, now: float):
    ev = _open_ops.pop(tid, None)
    if ev is not None and _enabled:
        _events.append((ev[0], ev[1], now - ev[1], tid))


def _close_op(now: float):
    with _lock:
        _close_op_locked(threading.get_ident(), now)


def _op_hook(op_name):
    """Dispatch hook (``amp.maybe_cast_inputs``): one ``op::<name>`` row
    per dispatch while profiling."""
    if not _enabled:
        return
    now = time.perf_counter()
    tid = threading.get_ident()
    with _lock:
        if _enabled:
            _close_op_locked(tid, now)
            _open_ops[tid] = (f"op::{op_name}", now)


from .. import amp as _amp_mod  # noqa: E402

_amp_mod._profiler_hook[0] = _op_hook


def record_compile(label: str, seconds: float, cache: str = "off"):
    """Record one compile (the JAX package's AOT compile feeds this; the
    port has no compile step of its own yet).

    Always collected — compiles are rare and the bench needs them even
    with the host profiler off; also lands in the event table when the
    profiler IS on."""
    with _lock:
        _compiles.append({"label": label, "compile_s": float(seconds),
                          "cache": cache})
        if _enabled:
            _events.append((f"compile::{label}",
                            time.perf_counter() - seconds, seconds,
                            threading.get_ident()))
    _COMPILE_N.inc()
    _COMPILE_S.inc(max(float(seconds), 0.0))


def compile_events() -> List[dict]:
    """Compiles recorded so far: [{label, compile_s, cache}, ...]."""
    with _lock:
        return [dict(e) for e in _compiles]


def reset_compile_events():
    with _lock:
        _compiles.clear()


def record_step(step: int, **segments):
    """Record one train step's host/device timeline segments.

    Fed by the JAX package's async step pipeline (a later slice of the
    port) at ticket-retire time with
    ``collate_s`` (host wait on the input iterator), ``dispatch_s``
    (host time spent launching the step), ``compute_s`` (submit-to-ready
    device latency) and ``fetch_s`` (host wall-clock actually *blocked*
    waiting for the result), plus ``in_flight``.  Overlap is proven when
    ``collate_s + dispatch_s + fetch_s`` (the dispatch gap the host pays)
    is well under ``compute_s`` (the device step time).  Always
    collected, like compiles."""
    with _lock:
        _steps.append({"step": int(step), **segments})
        if len(_steps) > _STEP_CAP:
            del _steps[: len(_steps) - _STEP_CAP]
        if _enabled:
            now = time.perf_counter()
            for seg in ("collate_s", "dispatch_s", "compute_s", "fetch_s"):
                if segments.get(seg):
                    _events.append((f"step::{seg[:-2]}", now,
                                    float(segments[seg]),
                                    threading.get_ident()))
    _STEP_N.inc()
    _STEP_BLOCKED_S.inc(max(float(segments.get("fetch_s", 0.0) or 0.0),
                            0.0))
    if segments.get("in_flight") is not None:
        _STEP_INFLIGHT.set(int(segments["in_flight"]))


def step_timeline() -> List[dict]:
    """Per-step timeline recorded so far:
    [{step, collate_s, dispatch_s, compute_s, fetch_s, in_flight}, ...]"""
    with _lock:
        return [dict(e) for e in _steps]


def reset_step_timeline():
    with _lock:
        _steps.clear()


def step_timeline_summary() -> dict:
    """Aggregate of the step timeline for bench/report JSON."""
    tl = step_timeline()
    if not tl:
        return {"steps": 0, "host_blocked_s": 0.0, "steps_in_flight": 0,
                "dispatch_gap_s": 0.0, "device_step_s": 0.0}
    n = len(tl)
    host_blocked = sum(e.get("fetch_s", 0.0) for e in tl)
    gap = sum(e.get("collate_s", 0.0) + e.get("dispatch_s", 0.0)
              + e.get("fetch_s", 0.0) for e in tl)
    dev = sum(e.get("compute_s", 0.0) for e in tl)
    return {
        "steps": n,
        "host_blocked_s": round(host_blocked, 6),
        "steps_in_flight": max(int(e.get("in_flight", 1)) for e in tl),
        # mean host-paid gap per step vs mean device step time: overlap
        # is working when dispatch_gap_s < device_step_s
        "dispatch_gap_s": round(gap / n, 6),
        "device_step_s": round(dev / n, 6),
    }


# ---------------------------------------------------------------------------
# serving counters (the JAX package's DynamicBatcher feeds these; the
# port's batcher is a later slice)
# ---------------------------------------------------------------------------

# first/last resolution timestamps bounding the reqs/s window
_serve_t = {"t0": None, "t1": None}


def record_serve_batch(rows: int, capacity: int, real_elems: int,
                       padded_elems: int, queue_depth: int = 0):
    """Record one dispatched inference batch: ``rows`` real request rows
    packed into a ``capacity``-row bucket, ``real_elems``/``padded_elems``
    element counts before/after shape-bucket padding, and the request
    queue depth observed at dispatch. Always collected (like compiles):
    the serve stats line reads these with the host profiler off."""
    _SRV_BATCHES.inc()
    _SRV_ROWS.inc(int(rows))
    _SRV_CAP.inc(int(capacity))
    _SRV_REAL.inc(int(real_elems))
    _SRV_PADDED.inc(int(padded_elems))
    _SRV_QDEPTH.set(int(queue_depth))
    _SRV_QMAX.set_max(int(queue_depth))


def record_serve_request(latency_s: float):
    """Record one successfully answered request (enqueue-to-result wall
    clock). Timestamps of the first/last resolution bound the reqs/s
    window in :func:`serve_stats`."""
    record_serve_requests((latency_s,))


def record_serve_requests(latencies_s):
    """Batch form of :func:`record_serve_request` — one dispatched
    batch's resolutions in one call."""
    latencies_s = list(latencies_s)
    now = time.perf_counter()
    _SRV_REQS.inc(len(latencies_s))
    for v in latencies_s:
        _SRV_LAT.observe(float(v))
    with _lock:
        if _serve_t["t0"] is None:
            _serve_t["t0"] = now
        _serve_t["t1"] = now


def record_serve_error():
    """Record one request that resolved with an error (its latency is not
    mixed into the percentiles)."""
    _SRV_ERRS.inc()


def serve_stats() -> dict:
    """Aggregate serving counters (read from the observability registry,
    the single backing store): request/batch totals, reqs_per_s,
    batch_occupancy (real rows / padded bucket rows), padding_waste
    (fraction of dispatched elements that were padding), queue_depth_max,
    compile_count (all compiles recorded via record_compile) and
    p50/p95/p99 request latency in ms."""
    with _lock:
        n_compiles = len(_compiles)
        t0, t1 = _serve_t["t0"], _serve_t["t1"]
    requests = int(_SRV_REQS.get())
    rows, cap = _SRV_ROWS.get(), _SRV_CAP.get()
    real, padded = _SRV_REAL.get(), _SRV_PADDED.get()
    # reqs/s window: first-to-last resolution; a single resolution (or
    # one batch) collapses the window to zero, so fall back to
    # time-since-first-resolution — and report null (never a misleading
    # 0.0) if even that is degenerate
    rate = 0.0 if requests == 0 else None
    if t0 is not None and requests:
        dur = t1 - t0
        if dur <= 0:
            dur = time.perf_counter() - t0
        if dur > 0:
            rate = round(requests / dur, 2)
    return {
        "requests": requests,
        "errors": int(_SRV_ERRS.get()),
        "batches": int(_SRV_BATCHES.get()),
        "reqs_per_s": rate,
        "batch_occupancy": round(rows / cap, 4) if cap else 0.0,
        "padding_waste": round(1.0 - real / padded, 4) if padded else 0.0,
        "queue_depth_max": int(_SRV_QMAX.get()),
        "compile_count": n_compiles,
        "p50_latency_ms": round(_SRV_LAT.percentile(0.50) * 1e3, 3),
        "p95_latency_ms": round(_SRV_LAT.percentile(0.95) * 1e3, 3),
        "p99_latency_ms": round(_SRV_LAT.percentile(0.99) * 1e3, 3),
    }


def reset_serve_stats():
    for inst in (_SRV_REQS, _SRV_ERRS, _SRV_BATCHES, _SRV_ROWS, _SRV_CAP,
                 _SRV_REAL, _SRV_PADDED, _SRV_QDEPTH, _SRV_QMAX,
                 _SRV_LAT):
        inst.reset()
    with _lock:
        _serve_t["t0"] = _serve_t["t1"] = None


def start_profiler(state: str = "All", tracer_option: str = "Default"):
    """fluid/profiler.py surface; `state`/`tracer_option` kept for parity
    (host events always; device events come from start_trace). The
    enable flip happens under the event-table lock so recorders racing
    the transition see a consistent (flag, table) pair."""
    global _enabled
    with _lock:
        _events.clear()
        _open_ops.clear()
        _enabled = True


def stop_profiler(sorted_key: str = "total", profile_path: Optional[str] = None,
                  print_table: bool = True):
    global _enabled
    now = time.perf_counter()
    with _lock:
        for tid in list(_open_ops):
            _close_op_locked(tid, now)
        _enabled = False
    table = summary(sorted_key)
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(table)
    if print_table:
        print(table)
    return table


def summary(sorted_key: str = "total") -> str:
    """Aggregated event table (EnableProfiler table analog)."""
    with _lock:
        events = list(_events)
    agg: Dict[str, List[float]] = {}
    for name, _, dur, _ in events:
        agg.setdefault(name, []).append(dur)
    keyfn = {"total": lambda kv: -sum(kv[1]),
             "max": lambda kv: -max(kv[1]),
             "min": lambda kv: -min(kv[1]),
             "calls": lambda kv: -len(kv[1])}.get(
        sorted_key, lambda kv: -sum(kv[1]))
    rows = sorted(agg.items(), key=keyfn)
    total_all = sum(sum(v) for v in agg.values()) or 1e-12
    lines = [f"{'Event':<40s} {'Calls':>7s} {'Total(ms)':>10s} "
             f"{'Avg(ms)':>9s} {'Min(ms)':>9s} {'Max(ms)':>9s} {'Ratio':>7s}"]
    for name, durs in rows:
        t = sum(durs)
        lines.append(
            f"{name[:40]:<40s} {len(durs):>7d} {t * 1e3:>10.3f} "
            f"{t / len(durs) * 1e3:>9.3f} {min(durs) * 1e3:>9.3f} "
            f"{max(durs) * 1e3:>9.3f} {t / total_all:>6.1%}")
    return "\n".join(lines)


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total",
             profile_path: Optional[str] = None):
    """`with profiler.profiler(...):` — fluid/profiler.py parity."""
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


# ---------------------------------------------------------------------------
# device tracing (torch.profiler: CUPTI on the GPU; a Chrome trace per run)
# ---------------------------------------------------------------------------

_trace = {"prof": None, "dir": None, "n": 0}


# Probe kernels `start_trace` runs once the CUDA activity is on. The
# device tracer can leave out the rows of the first launches it sees: on
# an H100 (torch 2.11, CUDA 12.8), late in a whole chip_smoke.py run,
# each of three traces lost the first 27 (phase 19(c)'s message), over
# 4 ms that began 50 ms after the trace did; short runs of
# tools/trace_kernel_loss.py lost none. So a trace opens on these.
_DEVICE_TRACER_PROBES = 256


def start_trace(log_dir: str):
    """DeviceTracer analog: ``torch.profiler.profile`` over the CPU and,
    when a card is visible, the CUDA activity; `stop_trace` writes the
    Chrome trace into `log_dir`. With the CUDA activity on it returns
    after `_DEVICE_TRACER_PROBES` probe kernels have run, so that the
    caller's first launches get their device rows."""
    import torch
    with _lock:
        if _trace["prof"] is not None:
            raise RuntimeError("profiler.start_trace: a trace is already "
                               "running")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        _trace.update(prof=prof, dir=str(log_dir))
    if len(acts) > 1:
        probe = torch.zeros(1, device="cuda")
        for _ in range(_DEVICE_TRACER_PROBES):
            probe.add_(1)
        torch.cuda.synchronize()


def stop_trace() -> Optional[str]:
    """Stop the running trace and write it as
    ``<log_dir>/trace_<pid>_<n>.json``; returns that path."""
    with _lock:
        prof, log_dir = _trace["prof"], _trace["dir"]
        _trace.update(prof=None, dir=None)
        if prof is None:
            return None
        _trace["n"] += 1
        n = _trace["n"]
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()
