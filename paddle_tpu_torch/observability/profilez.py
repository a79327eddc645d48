"""profilez: continuous per-entry-point profiler over the dispatch hook.

Port of paddle_tpu's `observability/profilez.py`. The JAX package feeds
it from its AOT cache's executable wrapper; the port has no AOT cache, so
each device entry point of the decode engines (prefill, decode step, page
write / copy-on-write / gather, draft prefill and rollout, verify) is
called through the engine's own dispatch hook
(`inference.decode.DecodeEngine._timed`), under the JAX package's
labels. Every dispatch reports

  * **wall** — how long the Python call took (kernel launches are
    asynchronous on a GPU, so this is host-side launch cost);
  * **block** — the call's span on the device's clock: the time between
    CUDA timing events recorded before and after it on its stream (its
    kernels, plus any gaps while the device waits for the host to
    launch them, so a launch-bound call reads about its wall), read once
    the scheduler next waits on that stream — no added synchronization;
    0 on the CPU, where the call is synchronous;
  * **donated bytes** — the bytes of the pool tensors the call updates
    in place (the JAX package's donated input buffers).

Observations land in the ``paddle_tpu_exec_*`` metric families (labeled
by entry point) and in a process-global :class:`ExecProfiler` whose
:meth:`top` ranks entry points by total block time — served live as the
AdminServer's ``/profilez``.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from . import metrics as _metrics

__all__ = ["ExecProfiler", "PROFILER"]

# decode steps sit in the 100 µs..10 ms band; the default serve buckets
# start too coarse to separate them
EXEC_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


class ExecProfiler:
    """Per-executable dispatch aggregates + the /profilez summary.

    One instance per process (:data:`PROFILER`); metric registration is
    idempotent so tests may build their own against a private registry.
    """

    def __init__(self, registry: Optional[_metrics.MetricsRegistry] = None):
        reg = registry or _metrics.REGISTRY
        self._wall = reg.histogram(
            "paddle_tpu_exec_wall_seconds",
            "Per-executable dispatch wall time (the Python call; async "
            "under JAX, so host-side cost).",
            labelnames=("exe",), buckets=EXEC_BUCKETS, sample_cap=512)
        self._block = reg.histogram(
            "paddle_tpu_exec_block_seconds",
            "Per-executable block_until_ready time (device execution "
            "and transfer).",
            labelnames=("exe",), buckets=EXEC_BUCKETS, sample_cap=512)
        self._calls = reg.counter(
            "paddle_tpu_exec_calls_total",
            "Dispatches per AOT executable.", labelnames=("exe",))
        self._donated = reg.gauge(
            "paddle_tpu_exec_donated_bytes",
            "Input bytes donated to XLA by the last dispatch of each "
            "executable.", labelnames=("exe",))
        self._compiles = reg.counter(
            "paddle_tpu_exec_compiles_total",
            "AOT compiles per executable family (steady state should "
            "add zero).", labelnames=("exe",))
        self._lock = threading.Lock()
        # exe -> [calls, wall_sum, block_sum, donated_sum, compiles]
        self._stats: Dict[str, list] = {}

    # -- feed (the engines' dispatch hook calls these) --------------------

    def observe(self, exe: str, wall_s: float, block_s: float,
                donated_bytes: int = 0):
        self._wall.labels(exe=exe).observe(wall_s)
        self._block.labels(exe=exe).observe(block_s)
        self._calls.labels(exe=exe).inc()
        if donated_bytes:
            self._donated.labels(exe=exe).set(donated_bytes)
        with self._lock:
            st = self._stats.get(exe)
            if st is None:
                st = self._stats[exe] = [0, 0.0, 0.0, 0, 0]
            st[0] += 1
            st[1] += wall_s
            st[2] += block_s
            st[3] += donated_bytes

    def record_compile(self, exe: str, compile_s: float):
        self._compiles.labels(exe=exe).inc()
        with self._lock:
            st = self._stats.get(exe)
            if st is None:
                st = self._stats[exe] = [0, 0.0, 0.0, 0, 0]
            st[4] += 1

    # -- reads ------------------------------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        """exe -> {calls, wall_s, block_s, donated_bytes, compiles}."""
        with self._lock:
            return {exe: {"calls": st[0],
                          "wall_s": round(st[1], 6),
                          "block_s": round(st[2], 6),
                          "donated_bytes": st[3],
                          "compiles": st[4]}
                    for exe, st in self._stats.items()}

    def top(self, n: int = 5) -> list:
        """Executables ranked by total block time (the device-side cost
        an optimization PR should chase first)."""
        rows = []
        for exe, st in self.snapshot().items():
            row = dict(st, exe=exe)
            try:
                row["block_p50_ms"] = round(
                    self._block.labels(exe=exe).percentile(0.50) * 1e3, 3)
                row["block_p99_ms"] = round(
                    self._block.labels(exe=exe).percentile(0.99) * 1e3, 3)
            except Exception:
                pass
            rows.append(row)
        rows.sort(key=lambda r: r["block_s"], reverse=True)
        return rows[:max(int(n), 0)]

    def profilez(self, n: int = 10) -> dict:
        """The /profilez body."""
        snap = self.snapshot()
        return {"executables": len(snap),
                "total_calls": sum(s["calls"] for s in snap.values()),
                "total_block_s": round(
                    sum(s["block_s"] for s in snap.values()), 6),
                "top": self.top(n)}


PROFILER = ExecProfiler()
