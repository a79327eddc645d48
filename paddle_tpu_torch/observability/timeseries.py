"""Bounded time-series history over the metrics registry.

Port of paddle_tpu's `observability/timeseries.py`.

The registry answers "what is the value NOW"; this module answers "what
happened over the last minute / five minutes / hour" without an
external Prometheus. A :class:`TimeSeriesStore` snapshots every scalar
sample (counters, gauges, histogram sums/counts) *and* every
histogram's cumulative bucket counts into a fixed-capacity ring buffer
on a background thread, then derives windowed views on demand:

  * ``rate(name, window)`` / ``delta(name, window)`` — counter movement
    between the two snapshots bracketing the window;
  * ``quantile(hist, q, window)`` — Prometheus-style
    ``histogram_quantile`` over the window's bucket-count delta
    (linear interpolation inside the winning bucket), i.e. the p99 *of
    the window*, not of all time;
  * ``varz()`` — one bounded JSON document (the ``/varz`` admin route)
    with per-window rates and latency trends for every family.

Memory is capped by construction: ``capacity`` snapshots of a
fixed-size sample set — the ring never grows, and a scrape only reads
what the sampler thread already wrote (no compile, no model code).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..core import flags as _flags

from . import metrics as _metrics

__all__ = ["TimeSeriesStore", "varz_interval", "varz_capacity"]

#: the windows /varz reports, label -> seconds
DEFAULT_WINDOWS = (("1m", 60.0), ("5m", 300.0), ("1h", 3600.0))


def varz_interval(default: float = 10.0) -> float:
    """``PADDLE_TPU_VARZ_INTERVAL`` seconds (sampler period)."""
    raw = _flags.env_raw("PADDLE_TPU_VARZ_INTERVAL") or ""
    try:
        v = float(raw) if raw.strip() else default
    except ValueError:
        return default
    return max(v, 0.05)


def varz_capacity(default: int = 400) -> int:
    """``PADDLE_TPU_VARZ_CAPACITY`` ring size (snapshot count)."""
    raw = _flags.env_raw("PADDLE_TPU_VARZ_CAPACITY") or ""
    try:
        v = int(raw) if raw.strip() else default
    except ValueError:
        return default
    return max(v, 8)


class _Snap:
    """One ring entry: timestamp + scalar map + histogram states."""

    __slots__ = ("ts", "scalars", "hists")

    def __init__(self, ts: float, scalars: Dict[str, float],
                 hists: Dict[str, Tuple[list, float, int]]):
        self.ts = ts
        self.scalars = scalars     # flat sample name -> value
        self.hists = hists         # key -> (bucket_counts, sum, count)


class TimeSeriesStore:
    """Fixed-capacity ring of registry snapshots + windowed queries."""

    def __init__(self,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 interval_s: Optional[float] = None,
                 capacity: Optional[int] = None,
                 prefix: str = "paddle_tpu_"):
        self.registry = registry or _metrics.REGISTRY
        self.interval_s = varz_interval() if interval_s is None \
            else max(float(interval_s), 0.05)
        cap = varz_capacity() if capacity is None else int(capacity)
        self.capacity = max(cap, 8)
        self.prefix = prefix
        self._ring: deque = deque(maxlen=self.capacity)
        self._bounds: Dict[str, Tuple[float, ...]] = {}   # hist family
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.time()

    # -- sampling ---------------------------------------------------------

    def sample(self, now: Optional[float] = None):
        """Take one snapshot (the background thread calls this; tests
        call it directly with a synthetic clock)."""
        ts = time.time() if now is None else float(now)
        scalars: Dict[str, float] = {}
        hists: Dict[str, Tuple[list, float, int]] = {}
        self.registry.collect()
        for m in self.registry.metrics():
            if self.prefix and not m.name.startswith(self.prefix):
                continue
            if isinstance(m, _metrics.Histogram):
                self._bounds.setdefault(m.name, tuple(m.buckets))
                if m.labelnames:
                    for labels, child in m.samples():
                        key = m.name + _metrics._label_str(
                            m.labelnames,
                            [labels[n] for n in m.labelnames])
                        hists[key] = child.state()
                else:
                    hists[m.name] = m._direct.state()
            else:
                if m.labelnames:
                    for labels, child in m.samples():
                        key = m.name + _metrics._label_str(
                            m.labelnames,
                            [labels[n] for n in m.labelnames])
                        scalars[key] = child.get()
                else:
                    scalars[m.name] = m._direct.get()
        with self._lock:
            self._ring.append(_Snap(ts, scalars, hists))

    def start(self):
        """Start the background sampler (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample()
                except Exception:
                    pass        # history must never take the server down

        self._thread = threading.Thread(
            target=loop, daemon=True, name="varz-sampler")
        self._thread.start()

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)
            self._thread = None

    # -- window selection -------------------------------------------------

    def _window(self, window_s: float,
                now: Optional[float] = None) -> Tuple[Optional[_Snap],
                                                      Optional[_Snap]]:
        """(oldest snapshot inside the window, newest snapshot). The
        baseline is the *last* snapshot at or before ``now - window_s``
        when one exists, so a delta covers the full window rather than
        only the part the ring happens to hold."""
        with self._lock:
            snaps = list(self._ring)
        if not snaps:
            return None, None
        newest = snaps[-1]
        t_lo = (newest.ts if now is None else float(now)) - float(window_s)
        base = None
        for s in snaps:
            if s.ts <= t_lo:
                base = s        # latest snapshot before the window opens
            else:
                break
        if base is None:
            base = snaps[0]     # ring shorter than the window: best effort
        return base, newest

    def samples_len(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- queries ----------------------------------------------------------

    def latest(self, name: str) -> Optional[float]:
        with self._lock:
            if not self._ring:
                return None
            return self._ring[-1].scalars.get(name)

    def delta(self, name: str, window_s: float,
              now: Optional[float] = None) -> float:
        """Counter movement across the window (clamped at 0 so a
        restart's counter reset reads as no traffic, not negative)."""
        base, newest = self._window(window_s, now)
        if base is None or base is newest:
            return 0.0
        return max(newest.scalars.get(name, 0.0)
                   - base.scalars.get(name, 0.0), 0.0)

    def rate(self, name: str, window_s: float,
             now: Optional[float] = None) -> float:
        base, newest = self._window(window_s, now)
        if base is None or base is newest:
            return 0.0
        dt = newest.ts - base.ts
        if dt <= 0:
            return 0.0
        return max(newest.scalars.get(name, 0.0)
                   - base.scalars.get(name, 0.0), 0.0) / dt

    def hist_delta(self, key: str, window_s: float,
                   now: Optional[float] = None
                   ) -> Tuple[List[float], float, int]:
        """(bucket_count_deltas, sum_delta, count_delta) for one
        histogram child across the window."""
        base, newest = self._window(window_s, now)
        if base is None or base is newest:
            return [], 0.0, 0
        new = newest.hists.get(key)
        if new is None:
            return [], 0.0, 0
        old = base.hists.get(key)
        counts_n, sum_n, count_n = new
        if old is None:
            return list(counts_n), sum_n, count_n
        counts_o, sum_o, count_o = old
        dc = [max(a - b, 0) for a, b in zip(counts_n, counts_o)]
        return dc, max(sum_n - sum_o, 0.0), max(count_n - count_o, 0)

    def quantile(self, key: str, q: float, window_s: float,
                 now: Optional[float] = None) -> float:
        """``histogram_quantile(q)`` over the window's bucket deltas.
        ``key`` is the flat child key (family name + label string);
        0.0 when the window saw no observations."""
        family = key.split("{", 1)[0]
        bounds = self._bounds.get(family)
        if not bounds:
            return 0.0
        counts, _, total = self.hist_delta(key, window_s, now)
        if not counts or total <= 0:
            return 0.0
        rank = q * total
        prev_cum, prev_bound = 0, 0.0
        for bound, cum in zip(bounds, counts):
            if cum >= rank:
                in_bucket = cum - prev_cum
                if in_bucket <= 0 or bound == float("inf"):
                    return prev_bound
                frac = (rank - prev_cum) / in_bucket
                return prev_bound + (bound - prev_bound) * frac
            prev_cum, prev_bound = cum, bound
        return prev_bound

    def frac_over(self, key: str, threshold_s: float, window_s: float,
                  now: Optional[float] = None) -> Tuple[float, int]:
        """(fraction of the window's observations above ``threshold_s``,
        window observation count) — the latency-SLO "bad event" rate.
        Interpolates inside the bucket containing the threshold."""
        family = key.split("{", 1)[0]
        bounds = self._bounds.get(family)
        counts, _, total = self.hist_delta(key, window_s, now)
        if not bounds or not counts or total <= 0:
            return 0.0, 0
        prev_cum, prev_bound = 0, 0.0
        le = float(total)
        for bound, cum in zip(bounds, counts):
            if threshold_s <= bound:
                if bound == float("inf") or bound == prev_bound:
                    le = float(cum)
                else:
                    frac = (threshold_s - prev_bound) / (bound - prev_bound)
                    le = prev_cum + (cum - prev_cum) * frac
                break
            prev_cum, prev_bound = cum, bound
        bad = max(float(total) - le, 0.0)
        return bad / float(total), int(total)

    # -- the /varz document ----------------------------------------------

    def varz(self) -> dict:
        """Bounded JSON: per-window rate/delta for every counter,
        last/min/max for every gauge, windowed p50/p99 + throughput for
        every histogram. Size is O(families x windows), independent of
        uptime."""
        with self._lock:
            snaps = list(self._ring)
        out = {
            "now": round(time.time(), 3),
            "interval_s": self.interval_s,
            "ring": {"capacity": self.capacity, "samples": len(snaps),
                     "oldest_ts": round(snaps[0].ts, 3) if snaps else None,
                     "newest_ts": round(snaps[-1].ts, 3) if snaps else None},
            "windows": {},
        }
        if not snaps:
            return out
        newest = snaps[-1]
        for label, w in DEFAULT_WINDOWS:
            sec: Dict[str, dict] = {}
            base, _ = self._window(w)
            covered = (newest.ts - base.ts) if base is not None else 0.0
            for name in sorted(newest.scalars):
                if name.endswith("_sum") or name.endswith("_count"):
                    continue       # folded into the histogram entry
                d = self.delta(name, w)
                entry = {"last": round(newest.scalars[name], 6)}
                if d or self.rate(name, w):
                    entry["delta"] = round(d, 6)
                    entry["rate_per_s"] = round(self.rate(name, w), 6)
                sec[name] = entry
            for key in sorted(newest.hists):
                _, sum_d, count_d = self.hist_delta(key, w)
                entry = {"count_delta": count_d,
                         "sum_delta_s": round(sum_d, 6)}
                if count_d:
                    entry["mean_s"] = round(sum_d / count_d, 6)
                    entry["p50_s"] = round(self.quantile(key, 0.50, w), 6)
                    entry["p99_s"] = round(self.quantile(key, 0.99, w), 6)
                sec[key] = entry
            out["windows"][label] = {
                "window_s": w, "covered_s": round(covered, 3),
                "series": sec}
        return out
