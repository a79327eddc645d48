"""Stall flight recorder: turn a wedged pipeline into a diagnosis.

Port of paddle_tpu's `observability/flight_recorder.py`. In the JAX
package its users are the dynamic batcher and the router, which later
slices of the port wire to it.

A wedged predictor (deadlocked worker, hung collective, a device call
that never returns) historically produced *silence*: requests time out,
the daemon looks alive, and the on-call engineer has nothing to bisect.
The flight recorder is a watchdog thread armed by ``PADDLE_TPU_STALL_DUMP``
(the directory dumps are written to; unset = disabled). The instrumented
component calls :meth:`FlightRecorder.beat` every time it makes progress
(a batch dispatched, a step retired); when the component reports itself
busy (`busy_fn`) but no beat lands for ``PADDLE_TPU_STALL_TIMEOUT``
seconds (default 60), the recorder writes ONE timestamped JSON dump:

  * every live thread's stack (``sys._current_frames``), keyed by thread
    name — the "where is everyone stuck" snapshot;
  * the component's context (`context_fn`: queue depth, oldest request
    age, in-flight tickets...);
  * the tail of the tracez event ring (last ~200 events per thread) —
    what each thread was *doing* before it parked, not just where;
  * the full metrics registry snapshot.

It re-arms only after progress resumes, so a single stall produces a
single dump, not a dump per poll tick.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

from ..core import flags as _flags
from . import metrics as _metrics

__all__ = ["FlightRecorder", "stall_dump_dir", "stall_timeout",
           "capture_thread_stacks"]

_DUMPS = _metrics.counter(
    "paddle_tpu_stall_dumps_total",
    "Flight-recorder stall dumps written (PADDLE_TPU_STALL_DUMP).")


def stall_dump_dir(env: Optional[str] = None) -> str:
    """Dump directory from ``PADDLE_TPU_STALL_DUMP``; '' = disabled."""
    return (_flags.env_raw("PADDLE_TPU_STALL_DUMP") or "") \
        if env is None else env


def stall_timeout(default: float = 60.0) -> float:
    raw = _flags.env_raw("PADDLE_TPU_STALL_TIMEOUT")
    try:
        return float(raw) if raw is not None else float(default)
    except ValueError:
        return default


def _event_ring_tail(per_thread: int = 200) -> dict:
    """Last ~200 trace-ring events per thread (tracez.TraceRing.tail);
    degrades to an error marker rather than spoiling a dump."""
    try:
        from . import tracez as _tracez
        return _tracez.RING.tail(per_thread=per_thread)
    except Exception as e:   # the dump must land even if the ring can't
        return {"events_error": repr(e)}


def _memz_block() -> dict:
    """Compact memory-plane summary (memz.status_block): top holders +
    fragmentation per registered pool, so a wedged-batcher dump also
    explains memory state; degrades like the event-ring tail."""
    try:
        from . import memz as _memz
        return _memz.status_block()
    except Exception as e:   # the dump must land even if memz can't
        return {"memz_error": repr(e)}


def capture_thread_stacks() -> dict:
    """{thread_name (id): [stack lines, innermost last]} for every live
    thread — the core of the dump, usable standalone."""
    names = {t.ident: f"{t.name} ({t.ident})"
             for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        key = names.get(ident, f"unknown ({ident})")
        out[key] = [ln.rstrip("\n")
                    for ln in traceback.format_stack(frame)]
    return out


class FlightRecorder:
    """Watchdog over one producer/consumer component.

    ``busy_fn() -> bool`` must be cheap and lock-light: True when there
    is outstanding work that SHOULD be progressing (queued requests,
    in-flight tickets). ``context_fn() -> dict`` (optional) is only
    called at dump time. Disabled entirely (no thread spawned) unless a
    dump directory is configured, so the hot path cost when off is one
    attribute check."""

    def __init__(self, label: str, busy_fn: Callable[[], bool],
                 context_fn: Optional[Callable[[], dict]] = None,
                 threshold_s: Optional[float] = None,
                 dump_dir: Optional[str] = None,
                 poll_s: Optional[float] = None,
                 registry: Optional[_metrics.MetricsRegistry] = None):
        self.label = label
        self._busy_fn = busy_fn
        self._context_fn = context_fn
        self.dump_dir = stall_dump_dir() if dump_dir is None else dump_dir
        self.threshold_s = stall_timeout() if threshold_s is None \
            else float(threshold_s)
        self.enabled = bool(self.dump_dir) and self.threshold_s > 0
        self._registry = registry or _metrics.REGISTRY
        self._last_beat = time.monotonic()
        self._armed = True
        self._stop = threading.Event()
        self._thread = None
        self.dumps = []          # paths written (newest last)
        if self.enabled:
            self._poll_s = poll_s if poll_s is not None \
                else min(max(self.threshold_s / 4.0, 0.05), 5.0)
            self._thread = threading.Thread(
                target=self._watch_loop, daemon=True,
                name=f"stall-recorder-{label}")
            self._thread.start()

    def beat(self):
        """Mark progress (called by the instrumented component)."""
        self._last_beat = time.monotonic()
        self._armed = True

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    # -- watchdog ---------------------------------------------------------

    def _watch_loop(self):
        while not self._stop.wait(self._poll_s):
            try:
                self._check(time.monotonic())
            except Exception:
                pass     # the watchdog must never take the daemon down

    def _check(self, now: float):
        try:
            busy = bool(self._busy_fn())
        except Exception:
            busy = False
        if not busy:
            # idle is not a stall; restart the clock so a burst after a
            # quiet hour is not instantly "stalled"
            self._last_beat = now
            self._armed = True
            return
        stalled_for = now - self._last_beat
        if stalled_for >= self.threshold_s and self._armed:
            self._armed = False      # one dump per stall
            self.dump(reason=f"no progress for {stalled_for:.1f}s "
                             f"with work outstanding",
                      stalled_for_s=stalled_for)

    # -- dumping ----------------------------------------------------------

    def dump(self, reason: str = "manual",
             stalled_for_s: float = 0.0) -> Optional[str]:
        """Write one dump file; returns its path (None when no dump dir
        is configured — the payload is still returned via ``self.last``)."""
        context = {}
        if self._context_fn is not None:
            try:
                context = dict(self._context_fn())
            except Exception as e:
                context = {"context_error": repr(e)}
        payload = {
            "kind": "paddle_tpu_stall_dump",
            "label": self.label,
            "reason": reason,
            "stalled_for_s": round(float(stalled_for_s), 3),
            "threshold_s": self.threshold_s,
            "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "pid": os.getpid(),
            "context": context,
            "threads": capture_thread_stacks(),
            # the event-ring tail: stacks say where each thread is
            # parked, the tail says what it was doing on the way there
            "events": _event_ring_tail(),
            # the memory plane: who held which pages while it wedged
            "memz": _memz_block(),
            "metrics": self._registry.flat(),
        }
        self.last = payload
        _DUMPS.inc()
        if not self.dump_dir:
            return None
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            fname = (f"stall_{self.label}_"
                     f"{time.strftime('%Y%m%d_%H%M%S')}_"
                     f"{os.getpid()}_{len(self.dumps)}.json")
            path = os.path.join(self.dump_dir, fname)
            with open(path, "w") as f:
                json.dump(payload, f, indent=1)
            self.dumps.append(path)
            sys.stderr.write(
                f"paddle_tpu: stall detected in {self.label!r} "
                f"({reason}); flight-recorder dump -> {path}\n")
            return path
        except OSError:
            return None
