"""Thread-safe, label-aware metrics registry with Prometheus exposition.

Port of paddle_tpu's `observability/metrics.py`, plain Python with no
import of either package's array library: the decode engine's
``paddle_tpu_decode_*`` families register here, and one
`REGISTRY.render()` call is the process's scrape surface
(`observability.admin` serves it at ``/metrics``).

Design points, as in the JAX package:
  * One family per metric name; labeled children are created on demand
    (`family.labels(reason="eos").inc()`). Registration is idempotent for
    an identical (type, labelnames) signature — several engines in one
    process share the same instrument — and raises on a conflicting
    re-registration.
  * Every value operation takes a lock; increments are exact under
    concurrency.
  * Histograms keep cumulative Prometheus buckets (+Inf implicit).
  * `render()` emits text exposition format 0.0.4: HELP/TYPE per family,
    escaped help and label values, labels in declaration order, buckets
    cumulative with `le="+Inf"` equal to `_count`, families in sorted-name
    order — byte for byte the JAX package's text for the same operations.

Left out, because no caller of the port uses them: gauge increments, the
histogram sample reservoir and its percentiles, pre-scrape collectors,
family removal, and the `snapshot()` / `flat()` / `names()` views.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "counter", "gauge", "histogram", "DEFAULT_BUCKETS"]

_NAME_RE = re.compile(r"^[a-z_:][a-z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

# latency-oriented default ladder (seconds): sub-ms dispatch up to
# multi-second events
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

    def samples(self) -> List[Tuple[Dict[str, str], object]]:
        """[(labels_dict, child), ...] in creation order."""
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, key)), child)
                for key, child in items]

    def _no_labels(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; "
                f"use .labels(...)")
        return self._direct

    def _make_child(self):
        raise NotImplementedError

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


class _CounterValue(_Value):
    def inc(self, value: float = 1) -> float:
        if value < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += float(value)
            return self._value


class _GaugeValue(_Value):
    def set(self, value: float) -> float:
        with self._lock:
            self._value = float(value)
            return self._value


class _ScalarFamily(_Metric):
    """Counter/Gauge family: delegates direct (label-less) operations to
    an embedded value so `counter(...).inc()` works without a labels()
    hop."""

    _value_cls = _Value

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._direct = self._value_cls()

    def _make_child(self):
        return self._value_cls()

    def get(self) -> float:
        return self._no_labels().get()

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

    def inc(self, value: float = 1) -> float:
        return self._no_labels().inc(value)


class Gauge(_ScalarFamily):
    typename = "gauge"
    _value_cls = _GaugeValue

    def set(self, value: float) -> float:
        return self._no_labels().set(value)


class _HistogramValue:
    """One histogram sample set: cumulative bucket counts + sum + count."""

    __slots__ = ("_bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, bounds: Sequence[float]):
        self._bounds = tuple(bounds)
        self._counts = [0] * len(self._bounds)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float):
        v = float(value)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self._bounds):
                if v <= b:
                    self._counts[i] += 1

    def state(self):
        with self._lock:
            return (list(self._counts), self._sum, self._count)


class Histogram(_Metric):
    typename = "histogram"

    def __init__(self, name, help, labelnames=(), buckets=None):
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(buckets if buckets is not None
                              else DEFAULT_BUCKETS))
        if not bounds:
            raise ValueError(f"{name}: histogram needs >= 1 bucket")
        self.buckets = bounds
        self._direct = _HistogramValue(bounds)

    def _make_child(self):
        return _HistogramValue(self.buckets)

    def observe(self, value: float):
        self._no_labels().observe(value)

    @property
    def count(self) -> int:
        return self._no_labels().state()[2]

    @property
    def sum(self) -> float:
        return self._no_labels().state()[1]

    def _render_one(self, labels: Dict[str, str],
                    child: _HistogramValue) -> List[str]:
        counts, total, count = child.state()
        values = [labels[n] for n in self.labelnames]
        lines = []
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
    """Name -> family map."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

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

    def histogram(self, name, help, labelnames=(),
                  buckets=None) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def render(self) -> str:
        """Prometheus text exposition 0.0.4 over every family, in
        sorted-name order."""
        lines: List[str] = []
        for m in self.metrics():
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


#: process-global default registry — the port's scrape surface
REGISTRY = MetricsRegistry()


def counter(name, help, labelnames=()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help, labelnames=()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help, labelnames=(), buckets=None) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)
