"""Declarative SLOs evaluated as multi-window burn rates over /varz.

Port of paddle_tpu's `observability/slo.py` (the router's objectives are
ported with it; the router itself is a later slice of the port).

An :class:`Objective` states a target the fleet can be judged against —
"99.9 % of requests succeed" (availability) or "99 % of requests finish
under 250 ms" (latency) — against counters / histograms already in the
registry. The :class:`SLOEngine` turns the :class:`TimeSeriesStore`
history into *burn rates*: the ratio of the observed bad-event rate to
the rate the error budget allows. Burn rate 1.0 spends the budget
exactly at the target; 10x spends a month's budget in three days.

Alerting follows the SRE multi-window recipe: a state trips only when
the burn exceeds the factor over BOTH the long window (meaningful
spend) and the short window (still happening right now), which is what
keeps a recovered incident from paging for an hour:

    state = firing   if burn(long) >= firing_factor and
                        burn(short) >= firing_factor
          = warning  if burn(long) >= warn_factor and
                        burn(short) >= warn_factor
          = ok       otherwise

``/alertz`` (admin route) serves the verdicts as JSON; the serve
daemon mounts a default availability objective (plus a latency one when
``PADDLE_TPU_SLO_P99_MS`` is set), and the router both serves its own
``/alertz`` and *consumes* each backend's — a firing backend is demoted
in the routing score, closing the loop from observability back into
routing.

Env knobs (all optional):

  * ``PADDLE_TPU_SLO_AVAILABILITY``  target success fraction
    (default 0.999; ``0``/``off`` disables the availability objective)
  * ``PADDLE_TPU_SLO_P99_MS``        latency threshold in ms (default
    off); ``PADDLE_TPU_SLO_LATENCY_TARGET`` fraction of requests that
    must beat it (default 0.99)
  * ``PADDLE_TPU_SLO_TENANTS``       ``tenant[:target]`` comma list:
    one extra availability objective per named tenant over the
    ``paddle_tpu_tenant_*`` counters (default off)
  * ``PADDLE_TPU_SLO_WINDOWS``       ``short,long`` seconds
    (default ``60,300``)
  * ``PADDLE_TPU_SLO_BURN``          ``warn,firing`` factors
    (default ``2,10``)
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..core import flags as _flags
from . import metrics as _metrics
from .timeseries import TimeSeriesStore

__all__ = ["Objective", "SLOEngine", "slo_windows", "slo_burn_factors",
           "serve_objectives", "router_objectives", "tenant_objectives"]


def _env_float(name: str, default: float) -> float:
    raw = (_flags.env_raw(name) or "").strip().lower()
    if not raw:
        return default
    if raw == "off":
        return 0.0              # explicit opt-out, not "use the default"
    try:
        return float(raw)
    except ValueError:
        return default


def _env_pair(name: str, default: Tuple[float, float]
              ) -> Tuple[float, float]:
    raw = (_flags.env_raw(name) or "").strip()
    if raw:
        try:
            a, b = (float(x) for x in raw.split(",", 1))
            if a > 0 and b > 0:
                return a, b
        except ValueError:
            pass
    return default


def slo_windows() -> Tuple[float, float]:
    """(short_s, long_s) evaluation windows."""
    short, long_ = _env_pair("PADDLE_TPU_SLO_WINDOWS", (60.0, 300.0))
    return (min(short, long_), max(short, long_))


def slo_burn_factors() -> Tuple[float, float]:
    """(warn_factor, firing_factor)."""
    warn, fire = _env_pair("PADDLE_TPU_SLO_BURN", (2.0, 10.0))
    return (min(warn, fire), max(warn, fire))


class Objective:
    """One declarative objective over registry series.

    ``kind="availability"``: ``bad_keys`` / ``total_keys`` are flat
    counter sample keys (a trailing ``*`` prefix-matches, for labeled
    families); target is the success fraction.

    ``kind="latency"``: ``hist_key`` is a histogram child key;
    ``threshold_s`` the latency bound; target the fraction of requests
    that must land under it.
    """

    def __init__(self, name: str, kind: str, target: float,
                 total_keys: Sequence[str] = (),
                 bad_keys: Sequence[str] = (),
                 hist_key: str = "",
                 threshold_s: float = 0.0):
        if kind not in ("availability", "latency"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if not 0.0 < float(target) < 1.0:
            raise ValueError(
                f"SLO {name}: target must be in (0, 1), got {target}")
        self.name = name
        self.kind = kind
        self.target = float(target)
        self.total_keys = tuple(total_keys)
        self.bad_keys = tuple(bad_keys)
        self.hist_key = hist_key
        self.threshold_s = float(threshold_s)

    @property
    def budget(self) -> float:
        """Allowed bad-event fraction (1 - target)."""
        return 1.0 - self.target

    def describe(self) -> dict:
        d = {"name": self.name, "kind": self.kind, "target": self.target}
        if self.kind == "latency":
            d["threshold_s"] = self.threshold_s
        return d


def _sum_keys(store: TimeSeriesStore, keys: Sequence[str],
              window_s: float, now: Optional[float]) -> float:
    total = 0.0
    for k in keys:
        if k.endswith("*"):
            prefix = k[:-1]
            latest = store._ring[-1].scalars if store._ring else {}
            for name in latest:
                if name.startswith(prefix):
                    total += store.delta(name, window_s, now)
        else:
            total += store.delta(k, window_s, now)
    return total


class SLOEngine:
    """Evaluates objectives against a TimeSeriesStore on demand.

    Evaluation is a pure read over the ring (no locks beyond the
    store's), so serving ``/alertz`` is as cheap as serving ``/varz``.
    State gauges (`paddle_tpu_slo_state`, 0 ok / 1 warning / 2 firing,
    and `paddle_tpu_slo_burn_rate`, the long-window burn) make the
    verdicts scrapeable alongside everything else.
    """

    _STATES = ("ok", "warning", "firing")

    def __init__(self, store: TimeSeriesStore,
                 objectives: Sequence[Objective],
                 windows: Optional[Tuple[float, float]] = None,
                 burn_factors: Optional[Tuple[float, float]] = None,
                 registry: Optional[_metrics.MetricsRegistry] = None):
        self.store = store
        self.objectives = list(objectives)
        self.short_s, self.long_s = windows or slo_windows()
        self.warn_factor, self.firing_factor = \
            burn_factors or slo_burn_factors()
        reg = registry or _metrics.REGISTRY
        self._state_g = reg.gauge(
            "paddle_tpu_slo_state",
            "Objective alert state: 0 ok, 1 warning, 2 firing.",
            labelnames=("slo",))
        self._burn_g = reg.gauge(
            "paddle_tpu_slo_burn_rate",
            "Long-window error-budget burn rate per objective "
            "(1.0 = spending exactly the budget).",
            labelnames=("slo",))

    # -- burn math --------------------------------------------------------

    def _bad_fraction(self, obj: Objective, window_s: float,
                      now: Optional[float]) -> Tuple[float, float]:
        """(bad fraction of events in window, event count)."""
        if obj.kind == "availability":
            total = _sum_keys(self.store, obj.total_keys, window_s, now)
            if total <= 0:
                return 0.0, 0.0
            bad = _sum_keys(self.store, obj.bad_keys, window_s, now)
            return min(bad / total, 1.0), total
        frac, count = self.store.frac_over(
            obj.hist_key, obj.threshold_s, window_s, now)
        return frac, float(count)

    def _burn(self, obj: Objective, window_s: float,
              now: Optional[float]) -> Tuple[float, float]:
        """(burn rate over the window, events seen)."""
        frac, n = self._bad_fraction(obj, window_s, now)
        return frac / obj.budget, n

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One verdict dict per objective (also refreshes the gauges)."""
        out = []
        for obj in self.objectives:
            burn_s, n_s = self._burn(obj, self.short_s, now)
            burn_l, n_l = self._burn(obj, self.long_s, now)
            state = "ok"
            reasons: List[str] = []
            if burn_l >= self.firing_factor and \
                    burn_s >= self.firing_factor:
                state = "firing"
            elif burn_l >= self.warn_factor and \
                    burn_s >= self.warn_factor:
                state = "warning"
            if state != "ok":
                reasons.append(
                    f"burn {burn_l:.1f}x over {self.long_s:g}s and "
                    f"{burn_s:.1f}x over {self.short_s:g}s "
                    f"(budget {obj.budget:g}"
                    + (f", threshold {obj.threshold_s:g}s"
                       if obj.kind == "latency" else "")
                    + ")")
            verdict = {
                **obj.describe(),
                "state": state,
                "reasons": reasons,
                "burn": {"short_s": self.short_s,
                         "long_s": self.long_s,
                         "short": round(burn_s, 3),
                         "long": round(burn_l, 3),
                         "events_short": n_s,
                         "events_long": n_l},
            }
            out.append(verdict)
            self._state_g.labels(slo=obj.name).set(
                self._STATES.index(state))
            self._burn_g.labels(slo=obj.name).set(burn_l)
        return out

    def alertz(self) -> dict:
        """The /alertz body: worst state first, plus config echo."""
        verdicts = self.evaluate()
        worst = "ok"
        for v in verdicts:
            if self._STATES.index(v["state"]) > self._STATES.index(worst):
                worst = v["state"]
        return {
            "state": worst,
            "ts": round(time.time(), 3),
            "windows_s": [self.short_s, self.long_s],
            "burn_factors": [self.warn_factor, self.firing_factor],
            "slos": verdicts,
        }


# -- default objective sets ------------------------------------------------

def serve_objectives() -> List[Objective]:
    """The serve daemon's defaults: availability over the request
    counters, latency-p99 only when a threshold is configured."""
    objs: List[Objective] = []
    avail = _env_float("PADDLE_TPU_SLO_AVAILABILITY", 0.999)
    if 0.0 < avail < 1.0:
        objs.append(Objective(
            "serve_availability", "availability", avail,
            total_keys=("paddle_tpu_serve_requests_total",
                        "paddle_tpu_serve_errors_total"),
            bad_keys=("paddle_tpu_serve_errors_total",)))
    p99_ms = _env_float("PADDLE_TPU_SLO_P99_MS", 0.0)
    if p99_ms > 0:
        target = _env_float("PADDLE_TPU_SLO_LATENCY_TARGET", 0.99)
        target = min(max(target, 0.5), 0.9999)
        objs.append(Objective(
            "serve_latency", "latency", target,
            hist_key="paddle_tpu_serve_request_latency_seconds",
            threshold_s=p99_ms / 1000.0))
    objs.extend(tenant_objectives())
    return objs


def tenant_objectives() -> List[Objective]:
    """Per-tenant availability objectives from ``PADDLE_TPU_SLO_TENANTS``
    (a ``tenant[:target]`` comma list; target defaults to the fleet
    availability target) over the per-tenant serve counters. Each tenant
    burns its own error budget on ``/alertz``, so one tenant melting
    down cannot trip another tenant's — or the fleet's — alert."""
    raw = (_flags.env_raw("PADDLE_TPU_SLO_TENANTS") or "").strip()
    if not raw:
        return []
    default = _env_float("PADDLE_TPU_SLO_AVAILABILITY", 0.999)
    if not 0.0 < default < 1.0:
        default = 0.999
    objs: List[Objective] = []
    for part in raw.replace(";", ",").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, val = part.partition(":")
        name = name.strip()
        if not name:
            continue
        try:
            target = float(val) if val.strip() else default
        except ValueError:
            target = default
        if not 0.0 < target < 1.0:
            continue
        objs.append(Objective(
            f"tenant_availability:{name}", "availability", target,
            total_keys=(
                f'paddle_tpu_tenant_requests_total{{tenant="{name}"}}',),
            bad_keys=(
                f'paddle_tpu_tenant_errors_total{{tenant="{name}"}}',)))
    return objs


def router_objectives() -> List[Objective]:
    """The router judges the fleet as one service: availability over
    request outcomes (shed/unavailable spend budget, relayed model
    errors do not — the backend answered), same optional latency
    objective."""
    objs: List[Objective] = []
    avail = _env_float("PADDLE_TPU_SLO_AVAILABILITY", 0.999)
    if 0.0 < avail < 1.0:
        objs.append(Objective(
            "router_availability", "availability", avail,
            total_keys=("paddle_tpu_router_requests_total*",),
            bad_keys=(
                'paddle_tpu_router_requests_total{outcome="shed"}',
                'paddle_tpu_router_requests_total{outcome="unavailable"}',
            )))
    p99_ms = _env_float("PADDLE_TPU_SLO_P99_MS", 0.0)
    if p99_ms > 0:
        target = _env_float("PADDLE_TPU_SLO_LATENCY_TARGET", 0.99)
        target = min(max(target, 0.5), 0.9999)
        objs.append(Objective(
            "router_latency", "latency", target,
            hist_key="paddle_tpu_router_request_latency_seconds",
            threshold_s=p99_ms / 1000.0))
    return objs
