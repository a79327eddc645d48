"""paddle_tpu_torch metrics registry, engine counters and admin plane
against the JAX package.

  * the same operations on a fresh JAX `MetricsRegistry` and a fresh port
    one render byte-identical 0.0.4 text (labels in declaration order,
    escaped help and label values, default and custom buckets, float and
    integral values), and registration conflicts raise in both;
  * every family the port's decode engine registers has the JAX
    `_decode_metrics()` family's name, type, help and label names; what
    JAX has beyond them is exactly the tenant and preemption families
    (not ported yet);
  * the same serial requests (a prefix hit, a fully cached prompt's
    copy-on-write, an eos) on the port's plain engine and the JAX engine
    move every counter by the same amount;
  * the admin plane: `serve --device cpu --metrics-port 0` prints
    ``METRICS <port>``; `/metrics` serves ``text/plain; version=0.0.4``
    with the decode families and the request's tokens, `/healthz` 200,
    `/statusz` the engine's stats, `/` the index, and unknown paths
    (`/tracez` among them) 404 with the endpoint list; a failing health
    check answers 503 with its reason.
"""
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import framework  # noqa: E402
from paddle_tpu.inference import decode as jdecode  # noqa: E402
from paddle_tpu.models.gpt import GPT, gpt_tiny  # noqa: E402
from paddle_tpu.observability import metrics as jmetrics  # noqa: E402
from paddle_tpu_torch.inference import decode as tdecode  # noqa: E402
from paddle_tpu_torch.inference.serve import decode_request  # noqa: E402
from paddle_tpu_torch.models.gpt import (GPTConfig,  # noqa: E402
                                         params_from_numpy)
from paddle_tpu_torch.observability import AdminServer  # noqa: E402
from paddle_tpu_torch.observability import metrics as tmetrics  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PT = 4
TIMEOUT = 120
# JAX families the port does not register yet (queue 1 items 5.3, 5.5)
UNPORTED = {"tenant_tokens", "tenant_admissions", "tenant_shed",
            "tenant_quota_deferred", "preemptions", "preempt_resumes",
            "preempted_tokens", "preempted_waiting"}


def _exercise(m):
    """The same operations on a package's metrics module."""
    reg = m.MetricsRegistry()
    c = reg.counter("demo_requests_total", 'Requests "served"\nby \\path',
                    labelnames=("route", "code"))
    c.labels(route="/a", code="200").inc()
    c.labels(route='/b"x\\y\nz', code="500").inc(2.5)
    c.labels(route="/a", code="200").inc(3)
    reg.counter("demo_plain_total", "A label-less counter").inc(7)
    g = reg.gauge("demo_ratio", "A gauge")
    g.set(7)
    g.set(0.1 + 0.2)
    reg.gauge("demo_big", "Big integral").set(2.0 ** 40)
    reg.gauge("demo_neg", "Negative").set(-float("inf"))
    h = reg.histogram("demo_latency_seconds", "Latency")
    for v in (0.0004, 0.003, 0.003, 0.7, 100.0):
        h.observe(v)
    hl = reg.histogram("demo_sizes", "Sizes", labelnames=("kind",),
                       buckets=(10, 1, 100.5))
    hl.labels(kind="a").observe(5)
    hl.labels(kind="b").observe(1000)
    with pytest.raises(ValueError):
        reg.gauge("demo_plain_total", "same name, other type")
    with pytest.raises(ValueError):
        reg.counter("demo_requests_total", "other labels", ("route",))
    with pytest.raises(ValueError):
        c.inc()                     # a labeled family needs labels()
    with pytest.raises(ValueError):
        c.labels(route="/a").inc()
    with pytest.raises(ValueError):
        c.labels(route="/a", code="200").inc(-1)
    assert reg.counter("demo_requests_total", "again",
                       ("route", "code")) is c
    return (reg.render(), h.count, h.sum, g.get(),
            c.value(route="/a", code="200"), c.value(route="/c", code="1"))


def test_registry_renders_the_jax_text():
    got = _exercise(tmetrics)
    assert got == _exercise(jmetrics)
    assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
    assert 'route="/b\\"x\\\\y\\nz"' in got[0]


def test_decode_families_match_jax():
    jm, tm = jdecode._decode_metrics(), tdecode._decode_metrics()
    assert set(jm) - set(tm) == UNPORTED and set(tm) <= set(jm)
    for key, fam in tm.items():
        want = jm[key]
        assert (fam.name, fam.typename, fam.help, fam.labelnames) \
            == (want.name, want.typename, want.help, want.labelnames), key
        assert tmetrics.REGISTRY.get(fam.name) is fam
        assert fam.name.startswith("paddle_tpu_decode_")
        assert fam.name.endswith("_total") == (fam.typename == "counter")


_COUNTERS = ("tokens", "steps", "prefills", "prefix_hits", "prefix_misses",
             "prefix_hit_tokens", "prefix_lookup_tokens", "cow",
             "page_allocs", "page_alloc_failures", "prefix_evictions")


def _deltas(eng, m, prompts, eos):
    before = {k: m[k].get() for k in _COUNTERS}
    hist = {k: m[k].count for k in ("ttft", "prefill_latency",
                                    "step_latency")}
    ev = {r: m["evictions"].value(reason=r) or 0 for r in ("eos", "length")}
    outs = [eng.submit(p, max_new_tokens=6, eos_id=e).result(timeout=TIMEOUT)
            for p, e in zip(prompts, eos)]
    out = {k: m[k].get() - before[k] for k in _COUNTERS}
    out.update({k: m[k].count - v for k, v in hist.items()})
    out.update({f"evictions_{r}": (m["evictions"].value(reason=r) or 0) - v
                for r, v in ev.items()})
    gauges = {k: m[k].get() for k in ("kv_page_bytes", "kv_quantized",
                                      "page_pool_size", "active",
                                      "page_in_use", "prefix_cached_pages")}
    return outs, out, gauges


def test_engine_counter_deltas_match_jax():
    paddle.seed(7)
    model = GPT(gpt_tiny())
    arrays = {k: np.asarray(v)
              for k, v in framework.param_arrays(model).items()}
    rng = np.random.default_rng(5)
    head = [int(t) for t in rng.integers(0, 512, 2 * PT)]
    prompts = [head + [11, 12, 13], head, [3, 1, 4, 1, 5]]
    jeng = jdecode.DecodeEngine(cfg=model.cfg, params=arrays, eps=1e-5,
                                max_slots=2, page_tokens=PT)
    try:
        jouts, _, _ = _deltas(jeng, jdecode._decode_metrics(), prompts,
                              [None] * 3)
        eos = [None, None, jouts[2][2]]      # cut the last stream early
        jouts, jd, jg = _deltas(jeng, jdecode._decode_metrics(), prompts,
                                eos)
    finally:
        jeng.stop()
    cfg = GPTConfig(**dataclasses.asdict(model.cfg))
    eng = tdecode.DecodeEngine(cfg=cfg,
                               params=params_from_numpy(cfg, arrays, "cpu"),
                               eps=1e-5, max_slots=2, page_tokens=PT,
                               device="cpu")
    try:
        _deltas(eng, tdecode._decode_metrics(), prompts, [None] * 3)
        outs, td, tg = _deltas(eng, tdecode._decode_metrics(), prompts,
                               eos)
    finally:
        eng.stop()
    assert outs == jouts
    assert td == jd
    assert tg == jg
    assert td["prefix_hits"] >= 2 and td["cow"] >= 1
    assert td["evictions_eos"] == 1 and td["evictions_length"] == 2


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def test_serve_metrics_port_exposes_the_decode_families(tmp_path):
    cfg = gpt_tiny()
    paddle.seed(3)
    prefix = str(tmp_path / "gpt")
    jdecode.save_for_decode(GPT(cfg), prefix)
    env = dict(os.environ,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""),
               PADDLE_TPU_DECODE_PAGE_TOKENS=str(PT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.serve", prefix,
         "--decode", "--device", "cpu", "--port", "0", "--decode-slots",
         "2", "--metrics-port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        first = proc.stdout.readline().split()
        second = proc.stdout.readline().split()
        assert first[0] == "METRICS" and second[0] == "SERVING", \
            (first, second)
        base = f"http://127.0.0.1:{int(first[1])}"
        with socket.create_connection(("127.0.0.1", int(second[1])),
                                      timeout=TIMEOUT) as s:
            toks = decode_request(s, [1, 2, 3, 4, 5],
                                  opts={"max_new_tokens": 5})
        code, ctype, body = _get(base + "/metrics")
        assert code == 200 and ctype.startswith("text/plain; version=0.0.4")
        for key, fam in tdecode._decode_metrics().items():
            assert f"# TYPE {fam.name} {fam.typename}" in body, key
        assert "paddle_tpu_decode_tokens_total 5" in body.splitlines()
        assert 'paddle_tpu_decode_cache_evictions_total{reason="length"} 1' \
            in body.splitlines()
        code, _, body = _get(base + "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        code, _, body = _get(base + "/statusz")
        st = json.loads(body)
        assert code == 200 and st["decode"]["tokens"] == len(toks) == 5
        code, _, body = _get(base + "/")
        assert code == 200 and all(p in body for p in
                                   ("/metrics", "/healthz", "/statusz"))
        for path in ("/tracez", "/memz", "/nope"):
            code, _, body = _get(base + path)
            assert code == 404
            assert json.loads(body)["endpoints"] == \
                ["/healthz", "/metrics", "/statusz"]
        proc.send_signal(signal.SIGTERM)
        rest = proc.stdout.read()
        assert proc.wait(timeout=60) == 0 and "DRAINED ok=True" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_admin_server_verdicts():
    reg = tmetrics.MetricsRegistry()
    reg.counter("x_total", "x").inc()

    def boom():
        raise RuntimeError("status down")

    with AdminServer(registry=reg, health_fn=lambda: (False, ["draining"]),
                     status_fn=boom) as adm:
        base = f"http://127.0.0.1:{adm.port}"
        code, _, body = _get(base + "/healthz")
        assert code == 503 and json.loads(body)["reasons"] == ["draining"]
        code, _, body = _get(base + "/statusz")
        assert code == 200 and "status down" in json.loads(body)[
            "status_error"]
        assert _get(base + "/metrics")[2] == reg.render()
    with AdminServer(registry=reg, health_fn=boom) as adm:
        code, _, body = _get(f"http://127.0.0.1:{adm.port}/healthz")
        assert code == 503 and "status down" in body
