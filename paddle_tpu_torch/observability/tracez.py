"""tracez: always-on bounded event ring + Chrome trace-event exporter.

Port of paddle_tpu's `observability/tracez.py`, plain Python, with the
same event tuples, clock model and Chrome JSON.

The fleet already answers "how much" (metrics, /varz) and "how bad"
(/alertz, stall dumps); tracez answers "what happened, in order".  Every
process keeps one :data:`RING` — a fixed-capacity, overwrite-on-wrap
event ring the hot paths write begin/end/instant/counter events into:
the decode engine's tick phases, every device entry point of the decode engines (via the
engine's dispatch hook, ``exec:<label>``), the host KV tier's
``page.spill`` / ``page.refetch`` batches and the server's
``serve.request``.  Recording one event is a tuple build plus one slot
assignment under a lock — no I/O, no allocation beyond the tuple, no
device work — so the ring can stay armed in production
(``PADDLE_TPU_TRACEZ_CAPACITY=0`` turns it into a no-op).

**Clock model.** Events carry ``time.perf_counter()`` timestamps
(monotonic, immune to NTP steps); each ring records a *wall-clock
anchor* — one ``(time.time(), time.perf_counter())`` pair captured at
ring creation — and the exporter maps every monotonic timestamp through
it.  Two processes' monotonic epochs are unrelated, but their anchored
wall clocks agree to NTP precision, so merging a router ring with its
backends' rings yields one skew-corrected timeline where a request's
spans nest across processes.  ``observability.spans`` uses the same
anchoring for its JSONL ``ts`` field, so span lines and ring events
correlate.

**Export.** :meth:`TraceRing.chrome_trace` renders the ring as Chrome
trace-event JSON (``{"traceEvents": [...]}``, timestamps in µs) loadable
directly in ui.perfetto.dev or chrome://tracing.  The AdminServer serves
it as ``/tracez``; ``python -m paddle_tpu_torch.observability.tracez merge``
assembles one file from several rings (local files or live ``/tracez``
URLs) for offline fleet-wide timelines.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

from ..core import flags as _flags
from . import metrics as _metrics

__all__ = ["TraceRing", "RING", "ring_capacity", "merge_traces",
           "fetch_trace", "load_trace", "main"]

DEFAULT_CAPACITY = 65536


def ring_capacity() -> int:
    """``PADDLE_TPU_TRACEZ_CAPACITY``; 0 disables the ring entirely."""
    try:
        return max(int(_flags.env_value("PADDLE_TPU_TRACEZ_CAPACITY")), 0)
    except Exception:
        return DEFAULT_CAPACITY


class TraceRing:
    """Bounded in-process event ring with a wall-clock anchor.

    Events are tuples ``(ph, name, ts, dur, tid, args)`` where ``ph`` is
    the Chrome trace-event phase ("X" complete, "B"/"E" begin/end, "i"
    instant, "C" counter), ``ts``/``dur`` are ``perf_counter`` seconds,
    and ``args`` is an optional small dict.  The ring never grows and
    never blocks its writer beyond one uncontended lock: when full, the
    oldest event is overwritten (``dropped`` counts the losses).
    """

    def __init__(self, capacity: Optional[int] = None,
                 component: str = "paddle_tpu",
                 pid: Optional[int] = None):
        self.capacity = ring_capacity() if capacity is None \
            else max(int(capacity), 0)
        self.component = component
        self.pid = os.getpid() if pid is None else int(pid)
        # Wall-clock anchor: captured ONCE so every export of this ring
        # uses the same mapping — re-anchoring per export would let NTP
        # slew tear spans recorded minutes apart.
        self.anchor_wall = time.time()
        self.anchor_mono = time.perf_counter()
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._n = 0
        self._lock = threading.Lock()

    # -- hot path ---------------------------------------------------------

    def record(self, ph: str, name: str, ts: float, dur: float = 0.0,
               args: Optional[dict] = None, tid: Optional[int] = None):
        """Append one raw event; the ring's only write path."""
        cap = self.capacity
        if cap == 0:
            return
        evt = (ph, name, ts, dur,
               threading.get_ident() if tid is None else tid, args)
        with self._lock:
            self._buf[self._n % cap] = evt
            self._n += 1

    def begin(self, name: str, args: Optional[dict] = None) -> float:
        """Open a span on the calling thread; returns the begin time so
        the caller can also feed a duration elsewhere."""
        t = time.perf_counter()
        self.record("B", name, t, 0.0, args)
        return t

    def end(self, name: str):
        self.record("E", name, time.perf_counter())

    def complete(self, name: str, t0: float, t1: float,
                 args: Optional[dict] = None):
        """One finished span as a single "X" event (cheaper than B+E and
        immune to a lost half when the ring wraps mid-span)."""
        self.record("X", name, t0, t1 - t0, args)

    def instant(self, name: str, args: Optional[dict] = None):
        self.record("i", name, time.perf_counter(), 0.0, args)

    def counter(self, name: str, value: float):
        # the value rides in the dur slot: no dict allocation on the
        # hot path; the exporter moves it into args
        self.record("C", name, time.perf_counter(), float(value))

    @contextmanager
    def span(self, name: str, args: Optional[dict] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.complete(name, t0, time.perf_counter(), args)

    # -- reads ------------------------------------------------------------

    @property
    def total(self) -> int:
        """Events recorded since creation (including overwritten ones)."""
        return self._n

    @property
    def dropped(self) -> int:
        return max(self._n - self.capacity, 0)

    def wall(self, ts: float) -> float:
        """Map a perf_counter timestamp onto the anchored wall clock."""
        return self.anchor_wall + (ts - self.anchor_mono)

    def snapshot(self) -> Tuple[List[tuple], int]:
        """(events oldest->newest, total recorded). O(capacity), taken
        under the ring lock — a pure list copy, no rendering."""
        with self._lock:
            n, cap = self._n, self.capacity
            if cap == 0 or n == 0:
                return [], n
            if n <= cap:
                return list(self._buf[:n]), n
            i = n % cap
            return self._buf[i:] + self._buf[:i], n

    def clear(self):
        with self._lock:
            self._buf = [None] * self.capacity
            self._n = 0

    # -- rendering --------------------------------------------------------

    def _thread_names(self) -> Dict[int, str]:
        return {t.ident: t.name for t in threading.enumerate()
                if t.ident is not None}

    def tail(self, per_thread: int = 200) -> Dict[str, list]:
        """Last ``per_thread`` events per thread, rendered human-readable
        — what the flight recorder embeds in stall dumps so a wedged
        dispatcher's dump shows what it was *doing*, not just where it
        is parked."""
        names = self._thread_names()
        events, _ = self.snapshot()
        by_thread: Dict[str, list] = {}
        for ph, name, ts, dur, tid, args in events:
            key = f"{names.get(tid, 'unknown')} ({tid})"
            row = {"t": round(self.wall(ts), 6), "ph": ph, "name": name}
            if ph in ("X", "B") and dur:
                row["dur_ms"] = round(dur * 1e3, 3)
            if ph == "C":
                row["value"] = dur
            if args:
                row["args"] = args
            by_thread.setdefault(key, []).append(row)
        for key in by_thread:
            by_thread[key] = by_thread[key][-per_thread:]
        return by_thread

    def chrome_trace(self) -> dict:
        """Render as Chrome trace-event JSON (ts/dur in microseconds,
        anchored wall clock) — the /tracez body."""
        events, total = self.snapshot()
        names = self._thread_names()
        out = [{"ph": "M", "pid": self.pid, "tid": 0,
                "name": "process_name",
                "args": {"name": f"{self.component}/{self.pid}"}}]
        seen_tids = set()
        rows = []
        for ph, name, ts, dur, tid, args in events:
            seen_tids.add(tid)
            e: Dict[str, Any] = {
                "ph": ph, "name": name, "cat": self.component,
                "pid": self.pid, "tid": tid,
                "ts": round(self.wall(ts) * 1e6, 3)}
            if ph == "X":
                e["dur"] = round(dur * 1e6, 3)
            elif ph == "C":
                e["args"] = {"value": dur}
            elif ph == "i":
                e["s"] = "t"
            if args:
                e.setdefault("args", {}).update(args)
            rows.append(e)
        for tid in sorted(seen_tids):
            out.append({"ph": "M", "pid": self.pid, "tid": tid,
                        "name": "thread_name",
                        "args": {"name": names.get(tid, f"tid-{tid}")}})
        out.extend(rows)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "metadata": {"component": self.component, "pid": self.pid,
                             "anchor_wall": self.anchor_wall,
                             "capacity": self.capacity,
                             "events": len(events),
                             "events_recorded": total,
                             "events_dropped": self.dropped}}


# ---------------------------------------------------------------------------
# process-default ring + registry gauges
# ---------------------------------------------------------------------------

RING = TraceRing()

_EVENTS = _metrics.gauge(
    "paddle_tpu_tracez_events",
    "Events recorded into the default trace ring since process start "
    "(overwritten events included).")
_DROPPED = _metrics.gauge(
    "paddle_tpu_tracez_dropped",
    "Events lost to ring wrap in the default trace ring.")
_CAPACITY = _metrics.gauge(
    "paddle_tpu_tracez_capacity",
    "Configured default trace-ring capacity "
    "(PADDLE_TPU_TRACEZ_CAPACITY; 0 disables recording).")


def _collect_ring():
    _EVENTS.set(RING.total)
    _DROPPED.set(RING.dropped)
    _CAPACITY.set(RING.capacity)


_metrics.REGISTRY.add_collector(_collect_ring)


# ---------------------------------------------------------------------------
# merge: several rings -> one fleet timeline
# ---------------------------------------------------------------------------

def fetch_trace(url: str, timeout: float = 5.0) -> dict:
    """GET a live ``/tracez`` body (Chrome trace JSON) from an admin
    endpoint."""
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def load_trace(src: str, timeout: float = 5.0) -> dict:
    """A merge source: an ``http(s)://.../tracez`` URL or a JSON file."""
    if src.startswith("http://") or src.startswith("https://"):
        return fetch_trace(src, timeout=timeout)
    with open(src) as f:
        return json.load(f)


def merge_traces(traces) -> dict:
    """Merge Chrome trace dicts into one timeline.

    Because every ring exports anchored wall-clock microseconds, merging
    is concatenation: no per-process offset fitting.  Metadata ("M")
    events lead, the rest are sorted by timestamp so the merged stream
    is monotonic."""
    meta, rows, procs = [], [], []
    for t in traces:
        if not t:
            continue
        for e in t.get("traceEvents", []):
            (meta if e.get("ph") == "M" else rows).append(e)
        md = t.get("metadata")
        if md:
            # an already-merged input (a router's fleet /tracez) carries
            # per-process anchors under "processes": flatten, don't nest
            procs.extend(md.get("processes") or [md])
    rows.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": meta + rows, "displayTimeUnit": "ms",
            "metadata": {"merged": len(procs), "processes": procs}}


def main(argv: Optional[list] = None) -> int:
    """``python -m paddle_tpu_torch.observability.tracez merge`` CLI."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.tracez",
        description="Assemble per-process /tracez rings into one "
                    "Perfetto-loadable timeline.")
    sub = p.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("merge", help="merge trace files and/or live "
                                     "/tracez URLs")
    m.add_argument("sources", nargs="+",
                   help="trace JSON files or http://host:port/tracez URLs")
    m.add_argument("-o", "--out", default="-",
                   help="output path ('-' = stdout)")
    m.add_argument("--timeout", type=float, default=5.0,
                   help="per-URL fetch timeout, seconds")
    args = p.parse_args(argv)

    traces = []
    for src in args.sources:
        try:
            traces.append(load_trace(src, timeout=args.timeout))
        except Exception as e:
            sys.stderr.write(f"tracez merge: skipping {src!r}: {e!r}\n")
    merged = merge_traces(traces)
    text = json.dumps(merged)
    if args.out == "-":
        sys.stdout.write(text + "\n")
    else:
        with open(args.out, "w") as f:
            f.write(text)
        sys.stderr.write(
            f"tracez merge: {len(traces)}/{len(args.sources)} sources, "
            f"{len(merged['traceEvents'])} events -> {args.out}\n")
    return 0 if traces else 1


if __name__ == "__main__":
    sys.exit(main())
