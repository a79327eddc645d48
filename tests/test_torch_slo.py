"""paddle_tpu_torch varz (`observability.timeseries`) and SLO engine
(`observability.slo`) against the JAX package's.

The same scripted counter, gauge and histogram traffic, drawn from a
seeded numpy generator, goes into a private registry of each package;
both stores sample on the same synthetic clock (`sample(now=)`), so every
windowed read — delta, rate, histogram delta, quantile, the fraction over
a threshold and the whole /varz document — must be equal. The SLO engines
then walk the same ok -> warning -> firing -> recovery script and must
give the same verdict (state, burns, reasons) at every evaluation; the
default objective sets and the env knobs parse the same. No sleeps: the
clock is the argument."""
import numpy as np
import pytest

pytest.importorskip("torch")

from paddle_tpu.observability import metrics as jmetrics  # noqa: E402
from paddle_tpu.observability import slo as jslo  # noqa: E402
from paddle_tpu.observability import timeseries as jts  # noqa: E402
from paddle_tpu_torch.observability import metrics as tmetrics  # noqa: E402
from paddle_tpu_torch.observability import slo as tslo  # noqa: E402
from paddle_tpu_torch.observability import timeseries as tts  # noqa: E402

BUCKETS = (0.005, 0.01, 0.05, 0.1, 0.25, 1.0)
PACKAGES = ((jmetrics, jts, jslo), (tmetrics, tts, tslo))


def _twin(interval=5.0, capacity=64):
    """(registry, instruments, store) per package."""
    out = []
    for metrics, ts, _ in PACKAGES:
        reg = metrics.MetricsRegistry()
        inst = {
            "req": reg.counter("paddle_tpu_q_total", "Q."),
            "bad": reg.counter("paddle_tpu_qbad_total", "B."),
            "ten": reg.counter("paddle_tpu_tenant_requests_total", "T.",
                               labelnames=("tenant",)),
            "depth": reg.gauge("paddle_tpu_depth", "D."),
            "lat": reg.histogram("paddle_tpu_l_seconds", "L.",
                                 buckets=BUCKETS),
            "stage": reg.histogram("paddle_tpu_s_seconds", "S.",
                                   labelnames=("stage",), buckets=BUCKETS),
        }
        reg.gauge("other_family", "not under the prefix").set(3)
        out.append((reg, inst, ts.TimeSeriesStore(
            registry=reg, interval_s=interval, capacity=capacity)))
    return out


def _traffic(twins, rng, t, n_ticks, bad_frac=0.0, slow_frac=0.0):
    """`n_ticks` ticks of 5 s of the same seeded traffic into both
    packages, sampling after each; returns the clock."""
    for _ in range(n_ticks):
        t += 5.0
        n = int(rng.integers(50, 150))
        n_bad = int(round(n * bad_frac))
        lats = rng.exponential(0.02, n)
        slow = rng.random(n) < slow_frac
        lats = np.where(slow, 0.2 + lats, lats)
        tenants = rng.choice(["a", "b"], n)
        depth = float(rng.integers(0, 40))
        for _, inst, store in twins:
            inst["req"].inc(n)
            inst["bad"].inc(n_bad)
            inst["depth"].set(depth)
            for ten in ("a", "b"):
                inst["ten"].labels(tenant=ten).inc(int((tenants == ten)
                                                      .sum()))
            for v in lats:
                inst["lat"].observe(float(v))
                inst["stage"].labels(stage="execute").observe(float(v) / 2)
            store.sample(now=t)
    return t


@pytest.mark.parametrize("window", [10.0, 30.0, 60.0, 600.0])
def test_windowed_reads_match_jax(window):
    twins = _twin()
    rng = np.random.default_rng(3)
    for _, _, store in twins:
        store.sample(now=0.0)
    t = _traffic(twins, rng, 0.0, 14, bad_frac=0.01, slow_frac=0.1)
    (_, _, js), (_, _, ts) = twins
    keys = ["paddle_tpu_q_total", "paddle_tpu_qbad_total",
            'paddle_tpu_tenant_requests_total{tenant="a"}',
            "paddle_tpu_depth"]
    for k in keys:
        assert ts.delta(k, window, t) == js.delta(k, window, t), k
        assert ts.rate(k, window, t) == js.rate(k, window, t), k
        assert ts.latest(k) == js.latest(k), k
    for hk in ("paddle_tpu_l_seconds",
               'paddle_tpu_s_seconds{stage="execute"}'):
        assert ts.hist_delta(hk, window, t) == js.hist_delta(hk, window, t)
        for q in (0.5, 0.9, 0.99):
            assert ts.quantile(hk, q, window, t) == \
                js.quantile(hk, q, window, t)
        for thr in (0.01, 0.05, 0.3):
            assert ts.frac_over(hk, thr, window, t) == \
                js.frac_over(hk, thr, window, t)
    assert ts.samples_len() == js.samples_len() == 15
    assert ts.delta("paddle_tpu_q_total", window, t) > 0


def test_varz_document_matches_jax():
    twins = _twin(capacity=8)
    rng = np.random.default_rng(4)
    t = _traffic(twins, rng, 0.0, 12, bad_frac=0.02)   # wraps the ring
    (_, _, js), (_, _, ts) = twins
    jv, tv = js.varz(), ts.varz()
    jv.pop("now"), tv.pop("now")
    assert tv == jv
    assert tv["ring"] == {"capacity": 8, "samples": 8, "oldest_ts": t - 35,
                          "newest_ts": t}
    assert "other_family" not in tv["windows"]["1m"]["series"]


def _engines(twins, objectives):
    return [slo.SLOEngine(store, objectives(slo), windows=(10.0, 30.0),
                          burn_factors=(2.0, 10.0), registry=reg)
            for (_, _, slo), (reg, _, store) in zip(PACKAGES, twins)]


def _avail(slo):
    return [slo.Objective("avail", "availability", 0.99,
                          total_keys=("paddle_tpu_q_total",),
                          bad_keys=("paddle_tpu_qbad_total",)),
            slo.Objective("tenants", "availability", 0.999,
                          total_keys=("paddle_tpu_tenant_requests_total*",),
                          bad_keys=("paddle_tpu_qbad_total",))]


def test_slo_states_ok_warning_firing_recovery_match_jax():
    twins = _twin()
    jeng, teng = _engines(twins, _avail)
    rng = np.random.default_rng(5)
    for _, _, store in twins:
        store.sample(now=0.0)
    t, states = 0.0, []
    for n, bad in ((6, 0.0), (6, 0.05), (6, 0.5), (8, 0.0)):
        t = _traffic(twins, rng, t, n, bad_frac=bad)
        jv, tv = jeng.evaluate(now=t), teng.evaluate(now=t)
        assert tv == jv
        states.append(tv[0]["state"])
        for (reg, _, _), v in zip(twins, (jv, tv)):
            assert reg.flat()['paddle_tpu_slo_state{slo="avail"}'] == \
                ("ok", "warning", "firing").index(v[0]["state"])
    assert states == ["ok", "warning", "firing", "ok"]
    ja, ta = jeng.alertz(), teng.alertz()
    ja.pop("ts"), ta.pop("ts")
    assert ta == ja


def test_slo_latency_objective_matches_jax():
    def lat(slo):
        return [slo.Objective("lat", "latency", 0.99,
                              hist_key="paddle_tpu_l_seconds",
                              threshold_s=0.05)]
    twins = _twin()
    jeng, teng = _engines(twins, lat)
    rng = np.random.default_rng(6)
    for _, _, store in twins:
        store.sample(now=0.0)
    t = _traffic(twins, rng, 0.0, 6)
    assert teng.evaluate(now=t) == jeng.evaluate(now=t)
    t = _traffic(twins, rng, t, 6, slow_frac=0.4)
    (v,) = teng.evaluate(now=t)
    assert [v] == jeng.evaluate(now=t) and v["state"] == "firing"
    assert v["threshold_s"] == pytest.approx(0.05)


@pytest.mark.parametrize("env", [
    {},
    {"PADDLE_TPU_SLO_P99_MS": "250", "PADDLE_TPU_SLO_AVAILABILITY": "0.99"},
    {"PADDLE_TPU_SLO_AVAILABILITY": "off", "PADDLE_TPU_SLO_P99_MS": "80",
     "PADDLE_TPU_SLO_LATENCY_TARGET": "0.9"},
    {"PADDLE_TPU_SLO_TENANTS": "prod:0.9999, bulk;x:2",
     "PADDLE_TPU_SLO_WINDOWS": "600,30", "PADDLE_TPU_SLO_BURN": "14,3"},
    {"PADDLE_TPU_SLO_WINDOWS": "bad", "PADDLE_TPU_SLO_BURN": "0,1"},
], ids=["defaults", "latency", "avail-off", "tenants", "garbage"])
def test_objective_sets_and_env_knobs_match_jax(monkeypatch, env):
    for k in ("PADDLE_TPU_SLO_AVAILABILITY", "PADDLE_TPU_SLO_P99_MS",
              "PADDLE_TPU_SLO_LATENCY_TARGET", "PADDLE_TPU_SLO_TENANTS",
              "PADDLE_TPU_SLO_WINDOWS", "PADDLE_TPU_SLO_BURN"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def described(slo):
        return {f: [(o.describe(), o.total_keys, o.bad_keys, o.hist_key)
                    for o in getattr(slo, f)()]
                for f in ("serve_objectives", "router_objectives",
                          "tenant_objectives")}
    assert described(tslo) == described(jslo)
    assert tslo.slo_windows() == jslo.slo_windows()
    assert tslo.slo_burn_factors() == jslo.slo_burn_factors()
    assert tts.varz_interval() == jts.varz_interval()
    assert tts.varz_capacity() == jts.varz_capacity()


def test_no_traffic_is_ok_and_sampler_thread_stops():
    twins = _twin()
    jeng, teng = _engines(twins, _avail)
    assert teng.evaluate(now=100.0) == jeng.evaluate(now=100.0)
    assert teng.evaluate(now=100.0)[0]["state"] == "ok"
    _, _, store = twins[1]
    store.start()
    store.start()                       # idempotent
    thread = store._thread
    store.stop()
    assert not thread.is_alive() and store._thread is None
