"""Thread-safe, label-aware metrics registry with Prometheus exposition.

Port of paddle_tpu's `observability/metrics.py`, plain Python with no
import of either package's array library. It is the port's single
backing store: `core.monitor` stat shims, the `profiler` serve / step /
compile aggregates, the decode engine's ``paddle_tpu_decode_*`` families
and the span, tracez, profilez and memz families all register here, so
one `REGISTRY.render()` call is the process's scrape surface
(`observability.admin` serves it at ``/metrics``).

Design points, as in the JAX package:
  * One family per metric name; labeled children are created on demand
    (`family.labels(stage="pad").observe(...)`). Registration is
    idempotent for an identical (type, labelnames) signature — module
    reloads and multiple recorders share the same instrument — and
    raises on a conflicting re-registration.
  * Every value operation takes the family lock; increments are exact
    under concurrency.
  * Histograms keep cumulative Prometheus buckets (+Inf implicit) and,
    optionally, a bounded reservoir of raw samples so exact percentiles
    (`profiler.serve_stats` p50/p95/p99, profilez's block p50/p99) read
    from the same store the scrape surface does.
  * Pre-scrape collectors (uptime, per-device memory, the tracez and memz
    gauges) run before every `render()` / `snapshot()`.
  * `render()` emits text exposition format 0.0.4: HELP/TYPE per family,
    escaped help and label values, labels in declaration order, buckets
    cumulative with `le="+Inf"` equal to `_count`, families in
    sorted-name order — byte for byte the JAX package's text for the same
    operations.
"""
from __future__ import annotations

import math
import re
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "counter", "gauge", "histogram", "DEFAULT_BUCKETS"]

_NAME_RE = re.compile(r"^[a-z_:][a-z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

# latency-oriented default ladder (seconds): sub-ms dispatch up to
# multi-second compile-class events
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _fmt(v: float) -> str:
    """Exposition value formatting: integral floats render as ints."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(names: Sequence[str], values: Sequence[str],
               extra: str = "") -> str:
    parts = [f'{n}="{_escape_label(str(v))}"'
             for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    """One metric family: a name, a help string, label names, and a map
    of label-value tuples to children. With no labels the family itself
    is the single sample."""

    typename = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        if not help or not str(help).strip():
            raise ValueError(f"metric {name} needs a non-empty help string")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.help = str(help)
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    # -- labeled children -------------------------------------------------

    def _child_key(self, kwargs) -> Tuple[str, ...]:
        if set(kwargs) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(kwargs)}")
        return tuple(str(kwargs[n]) for n in self.labelnames)

    def labels(self, **kwargs):
        key = self._child_key(kwargs)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def remove(self, **kwargs):
        """Drop one labeled child (no-op if absent)."""
        key = self._child_key(kwargs)
        with self._lock:
            self._children.pop(key, None)

    def clear(self):
        """Drop every labeled child and zero the direct value."""
        with self._lock:
            self._children.clear()
            self._reset_direct()

    reset = clear

    def samples(self) -> List[Tuple[Dict[str, str], object]]:
        """[(labels_dict, child_or_direct_state), ...] — stable order."""
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, key)), child)
                for key, child in items]

    # subclass hooks
    def _make_child(self):
        raise NotImplementedError

    def _reset_direct(self):
        pass

    def render(self) -> List[str]:
        raise NotImplementedError

    def _header(self) -> List[str]:
        return [f"# HELP {self.name} {_escape_help(self.help)}",
                f"# TYPE {self.name} {self.typename}"]


class _Value:
    """A single scalar sample (counter/gauge child)."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def get(self) -> float:
        with self._lock:
            return self._value

    def _inc(self, v: float) -> float:
        with self._lock:
            self._value += v
            return self._value

    def _set(self, v: float) -> float:
        with self._lock:
            self._value = float(v)
            return self._value

    def _set_max(self, v: float) -> float:
        with self._lock:
            if v > self._value:
                self._value = float(v)
            return self._value


class _CounterValue(_Value):
    def inc(self, value: float = 1) -> float:
        if value < 0:
            raise ValueError("counters can only increase")
        return self._inc(float(value))


class _GaugeValue(_Value):
    def inc(self, value: float = 1) -> float:
        return self._inc(float(value))

    def dec(self, value: float = 1) -> float:
        return self._inc(-float(value))

    def set(self, value: float) -> float:
        return self._set(value)

    def set_max(self, value: float) -> float:
        """Monotonic high-water mark (queue_depth_max class of gauge)."""
        return self._set_max(float(value))


class _ScalarFamily(_Metric):
    """Counter/Gauge family: delegates direct (label-less) operations to
    an embedded value so `registry.counter(...).inc()` works without a
    labels() hop."""

    _value_cls = _Value

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._direct = self._value_cls()

    def _make_child(self):
        return self._value_cls()

    def _reset_direct(self):
        self._direct = self._value_cls()

    def _no_labels(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; "
                f"use .labels(...)")
        return self._direct

    def get(self) -> float:
        return self._no_labels().get()

    def inc(self, value: float = 1) -> float:
        return self._no_labels().inc(value)

    def value(self, **kwargs) -> Optional[float]:
        """Read one labeled sample without creating it; None if absent."""
        key = self._child_key(kwargs)
        with self._lock:
            child = self._children.get(key)
        return child.get() if child is not None else None

    def render(self) -> List[str]:
        lines = self._header()
        if self.labelnames:
            for labels, child in self.samples():
                ls = _label_str(self.labelnames,
                                [labels[n] for n in self.labelnames])
                lines.append(f"{self.name}{ls} {_fmt(child.get())}")
        else:
            lines.append(f"{self.name} {_fmt(self._direct.get())}")
        return lines


class Counter(_ScalarFamily):
    typename = "counter"
    _value_cls = _CounterValue


class Gauge(_ScalarFamily):
    typename = "gauge"
    _value_cls = _GaugeValue

    def dec(self, value: float = 1) -> float:
        return self._no_labels().dec(value)

    def set(self, value: float) -> float:
        return self._no_labels().set(value)

    def set_max(self, value: float) -> float:
        return self._no_labels().set_max(value)


class _HistogramValue:
    """One histogram sample set: cumulative bucket counts + sum + count,
    plus an optional bounded reservoir of raw observations for exact
    percentiles."""

    __slots__ = ("_bounds", "_counts", "_sum", "_count", "_samples",
                 "_lock")

    def __init__(self, bounds: Sequence[float], sample_cap: int = 0):
        self._bounds = tuple(bounds)
        self._counts = [0] * len(self._bounds)
        self._sum = 0.0
        self._count = 0
        self._samples = deque(maxlen=sample_cap) if sample_cap else None
        self._lock = threading.Lock()

    def observe(self, value: float):
        v = float(value)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self._bounds):
                if v <= b:
                    self._counts[i] += 1
            if self._samples is not None:
                self._samples.append(v)

    def state(self):
        with self._lock:
            return (list(self._counts), self._sum, self._count)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Exact percentile over the reservoir (ceil-rank, matching the
        historical profiler convention); 0.0 with no samples or no
        reservoir."""
        with self._lock:
            vals = sorted(self._samples) if self._samples else []
        if not vals:
            return 0.0
        k = max(0, min(len(vals) - 1, int(math.ceil(q * len(vals))) - 1))
        return vals[k]


class Histogram(_Metric):
    typename = "histogram"

    def __init__(self, name, help, labelnames=(), buckets=None,
                 sample_cap: int = 0):
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(buckets if buckets is not None
                              else DEFAULT_BUCKETS))
        if not bounds:
            raise ValueError(f"{name}: histogram needs >= 1 bucket")
        self.buckets = bounds
        self.sample_cap = int(sample_cap)
        self._direct = _HistogramValue(bounds, self.sample_cap)

    def _make_child(self):
        return _HistogramValue(self.buckets, self.sample_cap)

    def _reset_direct(self):
        self._direct = _HistogramValue(self.buckets, self.sample_cap)

    def _no_labels(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; "
                f"use .labels(...)")
        return self._direct

    def observe(self, value: float):
        self._no_labels().observe(value)

    def percentile(self, q: float) -> float:
        return self._no_labels().percentile(q)

    @property
    def count(self) -> int:
        return self._no_labels().count

    @property
    def sum(self) -> float:
        return self._no_labels().sum

    def _render_one(self, labels: Dict[str, str],
                    child: _HistogramValue) -> List[str]:
        counts, total, count = child.state()
        values = [labels[n] for n in self.labelnames]
        lines = []
        # counts[i] holds observations <= bounds[i] (cumulative by
        # construction in observe)
        for b, c in zip(self.buckets, counts):
            ls = _label_str(self.labelnames, values,
                            extra=f'le="{_fmt(b)}"')
            lines.append(f"{self.name}_bucket{ls} {c}")
        ls_inf = _label_str(self.labelnames, values, extra='le="+Inf"')
        lines.append(f"{self.name}_bucket{ls_inf} {count}")
        ls = _label_str(self.labelnames, values)
        lines.append(f"{self.name}_sum{ls} {_fmt(total)}")
        lines.append(f"{self.name}_count{ls} {count}")
        return lines

    def render(self) -> List[str]:
        lines = self._header()
        if self.labelnames:
            for labels, child in self.samples():
                lines.extend(self._render_one(labels, child))
        else:
            lines.extend(self._render_one({}, self._direct))
        return lines


class MetricsRegistry:
    """Name -> family map plus pre-scrape collectors.

    Collectors are zero-arg callables run (best-effort) before every
    `render()`/`snapshot()`; they refresh gauges whose truth lives
    elsewhere (uptime, per-device HBM, queue depth)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[[], None]] = []

    # -- registration -----------------------------------------------------

    def _register(self, cls, name, help, labelnames, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name} already registered as "
                        f"{type(existing).__name__}"
                        f"{existing.labelnames}")
                return existing
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help, labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name, help, labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name, help, labelnames=(), buckets=None,
                  sample_cap: int = 0) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets, sample_cap=sample_cap)

    def unregister(self, name: str):
        with self._lock:
            self._metrics.pop(name, None)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    # -- collectors -------------------------------------------------------

    def add_collector(self, fn: Callable[[], None]):
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def remove_collector(self, fn):
        with self._lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    def collect(self):
        with self._lock:
            fns = list(self._collectors)
        for fn in fns:
            try:
                fn()
            except Exception:
                pass            # a broken collector must not break scrapes

    # -- output -----------------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition 0.0.4 over every family, collectors
        first, families in sorted-name order."""
        self.collect()
        lines: List[str] = []
        for m in self.metrics():
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Structured JSON-able snapshot (statusz / bench)."""
        self.collect()
        out = {}
        for m in self.metrics():
            entry = {"type": m.typename, "help": m.help}
            if isinstance(m, Histogram):
                def hstate(child):
                    counts, total, count = child.state()
                    return {"sum": total, "count": count}
                if m.labelnames:
                    entry["samples"] = [
                        {"labels": labels, **hstate(child)}
                        for labels, child in m.samples()]
                else:
                    entry.update(hstate(m._direct))
            else:
                if m.labelnames:
                    entry["samples"] = [
                        {"labels": labels, "value": child.get()}
                        for labels, child in m.samples()]
                else:
                    entry["value"] = m._direct.get()
            out[m.name] = entry
        return out

    def flat(self, prefix: str = "") -> Dict[str, float]:
        """Compact {exposition_sample_name: value} map of every scalar
        sample (histograms contribute _sum/_count) — the bench JSON's
        `metrics` section."""
        self.collect()
        out: Dict[str, float] = {}
        for m in self.metrics():
            if prefix and not m.name.startswith(prefix):
                continue
            if isinstance(m, Histogram):
                if m.labelnames:
                    for labels, child in m.samples():
                        ls = _label_str(
                            m.labelnames,
                            [labels[n] for n in m.labelnames])
                        _, total, count = child.state()
                        out[f"{m.name}_sum{ls}"] = total
                        out[f"{m.name}_count{ls}"] = count
                else:
                    out[f"{m.name}_sum"] = m.sum
                    out[f"{m.name}_count"] = m.count
            else:
                if m.labelnames:
                    for labels, child in m.samples():
                        ls = _label_str(
                            m.labelnames,
                            [labels[n] for n in m.labelnames])
                        out[f"{m.name}{ls}"] = child.get()
                else:
                    out[m.name] = m._direct.get()
        return out


#: process-global default registry — the framework's scrape surface
REGISTRY = MetricsRegistry()


def counter(name, help, labelnames=()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help, labelnames=()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help, labelnames=(), buckets=None,
              sample_cap: int = 0) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets,
                              sample_cap=sample_cap)
