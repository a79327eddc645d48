"""Request-scoped spans: per-stage histograms + sampled JSONL traces.

Port of paddle_tpu's `observability/spans.py`; the decode engine records
its queue / prefill / decode stages through it as the JAX engine does.

Every request through the serving engine gets a monotonically increasing
id and a span breakdown — ``queue_wait_s`` (enqueue to batch formation),
``pad_s`` (bucket assembly), ``execute_s`` (predictor run) and
``unpad_s`` (slice-back) — recorded into the stage-labeled
``paddle_tpu_serve_span_seconds`` histogram. A sampled fraction of
requests (``PADDLE_TPU_TRACE_SAMPLE``, 0..1, default 0) is additionally
emitted as one JSONL line per request to ``PADDLE_TPU_TRACE_FILE``
(default stderr), so a production incident can be traced without a
profiler attach. Sampling is deterministic in the request id (a hashed
rate gate), which keeps traces reproducible under replay.

Trace-line ``ts`` values come from the recorder's wall-clock anchor —
one ``(time.time(), time.perf_counter())`` pair captured at recorder
construction, the same anchoring :mod:`.tracez` uses for its event ring
— so timestamps from different processes sit on one skew-corrected
timeline (and an NTP step mid-run cannot tear a trace apart). The JSONL
file rotates at ``PADDLE_TPU_TRACE_MAX_BYTES`` (keep-last-2: the live
file plus ``<path>.1``), bounding what an always-sampled incident
window can write.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from typing import Dict, Optional

from ..core import flags as _flags
from . import metrics as _metrics

__all__ = ["SpanRecorder", "next_request_id", "request_id_base",
           "trace_sample_rate", "trace_max_bytes"]

SPAN_STAGES = ("queue_wait", "pad", "execute", "unpad")


def _mint_id_base() -> int:
    # Fleet-unique prefix in the high bits: pid (recycled slowly) XOR a
    # nanosecond salt (breaks pid reuse across restarts), occupying bits
    # 32..61 so `base + counter` stays a positive 62-bit int — exactly
    # representable in JSON/float64 and in the C client's int64_t.
    salt = ((os.getpid() & 0x3FFF) << 16) | (time.time_ns() & 0xFFFF)
    return (salt & 0x3FFFFFFF) << 32


_ID_BASE = _mint_id_base()

# process-wide request id stream: ids stay unique across batcher
# restarts so a JSONL trace never aliases two requests; the high-bit
# prefix keeps them unique across PROCESSES too, so a --fleet N run's
# merged traces never alias two backends' requests
_req_ids = itertools.count(1)


def request_id_base() -> int:
    """This process's id prefix (high 30 bits of every minted id)."""
    return _ID_BASE


def next_request_id() -> int:
    """Monotonic within the process, globally unique across a fleet."""
    return _ID_BASE + next(_req_ids)


def trace_sample_rate(env: Optional[str] = None) -> float:
    """``PADDLE_TPU_TRACE_SAMPLE`` clamped to [0, 1]; 0 disables."""
    raw = (_flags.env_raw("PADDLE_TPU_TRACE_SAMPLE") or "") \
        if env is None else env
    try:
        rate = float(raw) if str(raw).strip() else 0.0
    except ValueError:
        return 0.0
    return min(max(rate, 0.0), 1.0)


def trace_max_bytes() -> int:
    """``PADDLE_TPU_TRACE_MAX_BYTES``; <= 0 disables rotation."""
    try:
        return int(_flags.env_value("PADDLE_TPU_TRACE_MAX_BYTES"))
    except (ValueError, TypeError):
        return 0


class SpanRecorder:
    """Feeds span breakdowns into the registry and (sampled) a JSONL sink.

    One instance per batcher; instrument registration is idempotent, so
    multiple recorders share the same histogram family."""

    def __init__(self, component: str = "serve",
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 sample: Optional[float] = None,
                 path: Optional[str] = None,
                 metric: str = "paddle_tpu_serve_span_seconds",
                 help: str = "Per-request span breakdown by stage "
                             "(queue_wait, pad, execute, unpad), "
                             "seconds."):
        reg = registry or _metrics.REGISTRY
        self.component = component
        self._hist = reg.histogram(metric, help, labelnames=("stage",))
        self.sample = trace_sample_rate() if sample is None \
            else min(max(float(sample), 0.0), 1.0)
        self.path = _flags.env_value("PADDLE_TPU_TRACE_FILE") \
            if path is None else path
        self.max_bytes = trace_max_bytes()
        # wall anchor (see module docstring): ts = anchor_wall + elapsed
        # monotonic, matching tracez.TraceRing's clock model exactly
        self._anchor_wall = time.time()
        self._anchor_mono = time.perf_counter()
        self._lock = threading.Lock()
        self._file = None
        self._bytes = 0

    def sampled(self, req_id: int) -> bool:
        if self.sample <= 0.0:
            return False
        if self.sample >= 1.0:
            return True
        # Knuth multiplicative hash of the id -> uniform [0, 1) gate;
        # deterministic per id, no RNG state
        h = (int(req_id) * 2654435761) & 0xFFFFFFFF
        return (h / 2 ** 32) < self.sample

    def observe_stage(self, stage: str, dur: float):
        """Feed one extra stage observation into the histogram only —
        for stages that overlap the spans passed to :meth:`record`
        (e.g. a router's view of the backend's breakdown) and so must
        not be double-counted into the trace line's ``total_s``."""
        self._hist.labels(stage=stage).observe(max(float(dur), 0.0))

    def record(self, req_id: int, spans: Dict[str, float],
               extra: Optional[dict] = None,
               force: Optional[bool] = None):
        """Record one request's breakdown; ``spans`` maps stage name
        (without the ``_s`` suffix) to seconds. ``force`` overrides the
        sampling gate for the JSONL line (True: always emit, e.g. a
        propagated trace context; False: histogram only)."""
        for stage, dur in spans.items():
            self._hist.labels(stage=stage).observe(max(float(dur), 0.0))
        emit = self.sampled(req_id) if force is None else bool(force)
        if not emit:
            return
        line = {"ts": round(self._anchor_wall +
                            (time.perf_counter() - self._anchor_mono), 6),
                "component": self.component,
                "request_id": int(req_id)}
        line.update({f"{k}_s": round(float(v), 6)
                     for k, v in spans.items()})
        line["total_s"] = round(sum(float(v) for v in spans.values()), 6)
        if extra:
            line.update(extra)
        self._emit(json.dumps(line))

    def _emit(self, text: str):
        data = text + "\n"
        with self._lock:
            try:
                if self.path:
                    if self._file is None:
                        self._file = open(self.path, "a")
                        try:
                            self._bytes = os.fstat(
                                self._file.fileno()).st_size
                        except OSError:
                            self._bytes = 0
                    if self.max_bytes > 0 and self._bytes > 0 and \
                            self._bytes + len(data) > self.max_bytes:
                        self._rotate_locked()
                    self._file.write(data)
                    self._file.flush()
                    self._bytes += len(data)
                else:
                    sys.stderr.write("SPAN " + data)
            except OSError:
                pass            # tracing must never fail a request

    def _rotate_locked(self):
        # keep-last-2: the live file plus one predecessor (<path>.1,
        # overwritten each rotation). A single line larger than the cap
        # still lands whole — the cap bounds growth, it never truncates
        # a trace line.
        try:
            self._file.close()
        except OSError:
            pass
        self._file = None
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass
        self._file = open(self.path, "a")
        self._bytes = 0

    def close(self):
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                finally:
                    self._file = None
