"""paddle_tpu_torch spans, the stall flight recorder, the admin plane,
`core.monitor` and the metrics registry's full surface against the JAX
package's.

  * `SpanRecorder`'s deterministic sampling picks the same request ids at
    every rate; the JSONL line has the JAX schema (keys and values, the
    wall-anchored ``ts`` aside), rotates at PADDLE_TPU_TRACE_MAX_BYTES
    keep-last-2, and `next_request_id` is monotonic under a per-process
    high-bit base;
  * `FlightRecorder`, driven by its watchdog check on an injected clock:
    one dump per stall, idle is no stall, the dump has the JAX payload's
    keys with the tracez tail and memz's status block embedded; the env
    knobs parse the same;
  * `AdminServer` mounts the JAX endpoint set (with and without varz /
    alertz) and serves each one; `serve --device cpu --metrics-port 0`
    answers all eight on a live decode daemon, and the tracez merge CLI
    reads its live ``/tracez``;
  * `core.monitor`: the stat shims match JAX's, the memory probes return
    empty and never raise on the CPU or when CUDA raises, and read the
    JAX keys from torch.cuda when a card is visible;
  * the registry's percentiles, gauge ops, collectors, flat / snapshot
    views and family removal give the JAX values.
No sleeps (a live daemon is polled only for its own startup line)."""
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
from paddle_tpu.core import monitor as jmonitor  # noqa: E402
from paddle_tpu.inference import decode as jdecode  # noqa: E402
from paddle_tpu.models.gpt import GPT, gpt_tiny  # noqa: E402
from paddle_tpu.observability import admin as jadmin  # noqa: E402
from paddle_tpu.observability import flight_recorder as jfr  # noqa: E402
from paddle_tpu.observability import metrics as jmetrics  # noqa: E402
from paddle_tpu.observability import spans as jspans  # noqa: E402
from paddle_tpu_torch import observability as tobs  # noqa: E402
from paddle_tpu_torch.core import monitor as tmonitor  # noqa: E402
from paddle_tpu_torch.inference.serve import decode_request  # noqa: E402
from paddle_tpu_torch.observability import admin as tadmin  # noqa: E402
from paddle_tpu_torch.observability import flight_recorder as tfr  # noqa
from paddle_tpu_torch.observability import memz as tmemz  # noqa: E402
from paddle_tpu_torch.observability import metrics as tmetrics  # noqa: E402
from paddle_tpu_torch.observability import spans as tspans  # noqa: E402
from paddle_tpu_torch.observability import tracez as ttracez  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


# -- spans -------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.9, 1.0])
def test_span_sampling_matches_jax(rate):
    ids = np.random.default_rng(int(rate * 10)).integers(1, 1 << 40, 2000)
    j = jspans.SpanRecorder(component="t", sample=rate,
                            registry=jmetrics.MetricsRegistry())
    t = tspans.SpanRecorder(component="t", sample=rate,
                            registry=tmetrics.MetricsRegistry())
    picks = [t.sampled(int(i)) for i in ids]
    assert picks == [j.sampled(int(i)) for i in ids]
    if 0.0 < rate < 1.0:
        assert abs(sum(picks) / len(ids) - rate) < 0.05


def test_span_jsonl_schema_and_rotation_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TRACE_MAX_BYTES", "600")
    lines = {}
    for name, mod, metrics in (("jax", jspans, jmetrics),
                               ("port", tspans, tmetrics)):
        path = tmp_path / f"{name}.jsonl"
        reg = metrics.MetricsRegistry()
        rec = mod.SpanRecorder(component="decode", sample=1.0,
                               path=str(path), registry=reg,
                               metric="paddle_tpu_decode_span_seconds")
        assert rec.max_bytes == 600
        for i in range(30):
            rec.record(1000 + i, {"queue": 0.001 * i, "prefill": 0.002,
                                  "decode": 0.01},
                       extra={"tokens": i, "prompt_len": 7})
        rec.record(5, {"queue": 0.5}, force=False)   # histogram only
        rec.close()
        assert (tmp_path / f"{name}.jsonl.1").exists()
        assert not (tmp_path / f"{name}.jsonl.2").exists()
        rows = [json.loads(ln) for p in (f"{name}.jsonl.1", f"{name}.jsonl")
                for ln in (tmp_path / p).read_text().splitlines()]
        for r in rows:
            r.pop("ts")
        lines[name] = (rows, reg.render())
    assert lines["port"] == lines["jax"]
    rows = lines["port"][0]
    assert set(rows[-1]) == {"component", "request_id", "queue_s",
                             "prefill_s", "decode_s", "total_s", "tokens",
                             "prompt_len"}


def test_request_ids_and_sample_env_match_jax(monkeypatch):
    ids = [tspans.next_request_id() for _ in range(100)]
    assert ids == sorted(set(ids))
    base = tspans.request_id_base()
    assert base > 0 and base % (1 << 32) == 0
    assert all(i - base < (1 << 32) for i in ids)
    for raw in ("", "0.25", "7", "-1", "junk"):
        monkeypatch.setenv("PADDLE_TPU_TRACE_SAMPLE", raw)
        assert tspans.trace_sample_rate() == jspans.trace_sample_rate()
        assert tspans.trace_sample_rate(raw) == jspans.trace_sample_rate(raw)


# -- the flight recorder ------------------------------------------------------

def _recorder(mod, tmp_path, busy):
    # a poll far longer than the test: the watchdog thread never runs a
    # check on its own; the test drives `_check` with its own clock
    return mod.FlightRecorder("unit", busy_fn=lambda: busy[0],
                              context_fn=lambda: {"queue_depth": 3},
                              threshold_s=5.0, dump_dir=str(tmp_path),
                              poll_s=3600.0)


def test_flight_recorder_stall_cycle_matches_jax(tmp_path):
    payloads = []
    for name, mod in (("jax", jfr), ("port", tfr)):
        busy = [True]
        fr = _recorder(mod, tmp_path / name, busy)
        try:
            t0 = fr._last_beat
            fr._check(t0 + 1.0)              # busy, under the threshold
            assert fr.dumps == []
            fr._check(t0 + 6.0)              # stalled: one dump
            fr._check(t0 + 9.0)              # still stalled: no second
            assert len(fr.dumps) == 1
            fr.beat()                        # progress re-arms
            busy[0] = False
            fr._check(fr._last_beat + 60.0)  # idle is not a stall
            busy[0] = True
            fr._check(fr._last_beat + 6.0)   # a new stall: a new dump
            assert len(fr.dumps) == 2
        finally:
            fr.stop()
        payloads.append(json.loads(open(fr.dumps[0]).read()))
    jp, tp = payloads
    assert set(tp) == set(jp)
    for key in ("kind", "label", "reason", "threshold_s", "context"):
        assert tp[key] == jp[key], key
    assert tp["stalled_for_s"] == pytest.approx(6.0, abs=0.01)
    assert tp["threads"] and "pools" in tp["memz"]
    assert isinstance(tp["events"], dict)
    assert any(k.startswith("paddle_tpu_") for k in tp["metrics"])


def test_flight_recorder_env_and_disabled_match_jax(monkeypatch, tmp_path):
    for raw in (None, "", "2.5", "x"):
        if raw is None:
            monkeypatch.delenv("PADDLE_TPU_STALL_TIMEOUT", raising=False)
        else:
            monkeypatch.setenv("PADDLE_TPU_STALL_TIMEOUT", raw)
        try:
            want = jfr.stall_timeout()
        except ValueError:
            want = None
        got = tfr.stall_timeout() if want is not None else None
        assert got == want
    monkeypatch.delenv("PADDLE_TPU_STALL_DUMP", raising=False)
    assert tfr.stall_dump_dir() == jfr.stall_dump_dir() == ""
    fr = tfr.FlightRecorder("off", busy_fn=lambda: True)
    assert not fr.enabled and fr._thread is None
    assert fr.dump("manual") is None and fr.last["label"] == "off"
    fr.stop()
    stacks = tfr.capture_thread_stacks()
    assert any("capture_thread_stacks" in ln or "test_flight" in ln
               for v in stacks.values() for ln in v)


# -- the admin plane -----------------------------------------------------------

@pytest.mark.parametrize("mounted", [False, True])
def test_admin_endpoints_match_jax(mounted):
    kw = {"varz_fn": lambda: {"windows": {}}, "alertz_fn":
          lambda: {"state": "ok", "slos": []}} if mounted else {}
    with jadmin.AdminServer(port=0, registry=jmetrics.MetricsRegistry(),
                            **kw) as j, \
            tadmin.AdminServer(port=0, registry=tmetrics.MetricsRegistry(),
                               **kw) as t:
        assert t.endpoints() == j.endpoints()
        base = f"http://127.0.0.1:{t.port}"
        for path in t.endpoints():
            code, _, body = _get(base + path)
            assert code == 200, path
        code, ctype, html = _get(base + "/")
        assert code == 200 and ctype.startswith("text/html")
        for path in t.endpoints():
            assert f'href="{path}"' in html
        code, _, body = _get(base + "/memz?oom=1")
        assert code == 200 and "oom_dumps" in json.loads(body)
        code, _, body = _get(base + "/nope")
        assert code == 404
        assert json.loads(body)["endpoints"] == sorted(j.endpoints())
        for path in ("/varz", "/alertz"):
            assert (_get(base + path)[0] == 200) == mounted


def test_serve_answers_every_endpoint(tmp_path):
    """The decode daemon with --metrics-port 0: after one stream, every
    endpoint answers, /tracez holds its serve.request span, /profilez its
    dispatches, /memz its pool, /statusz the JAX status keys, /alertz the
    serve objectives; the merge CLI reads the live /tracez."""
    paddle.seed(3)
    prefix = str(tmp_path / "gpt")
    jdecode.save_for_decode(GPT(gpt_tiny()), prefix)
    env = dict(os.environ,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""),
               PADDLE_TPU_DECODE_PAGE_TOKENS="4")
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
        mport = int(first[1])
        base = f"http://127.0.0.1:{mport}"
        with socket.create_connection(("127.0.0.1", int(second[1])),
                                      timeout=TIMEOUT) as s:
            toks = decode_request(s, [1, 2, 3, 4, 5],
                                  opts={"max_new_tokens": 4})
        assert len(toks) == 4
        bodies = {}
        for path in ("/metrics", "/healthz", "/statusz", "/varz",
                     "/alertz", "/tracez", "/profilez", "/memz",
                     "/memz?oom=1"):
            code, _, body = _get(base + path)
            assert code == 200, path
            bodies[path] = body
        names = [e["name"] for e in json.loads(bodies["/tracez"])
                 ["traceEvents"] if e["ph"] != "M"]
        assert names.count("serve.request") == 1
        assert names.count("decode.step") == 3
        top = {r["exe"]: r["calls"]
               for r in json.loads(bodies["/profilez"])["top"]}
        assert top == {"decode.prefill": 1, "decode.pstep": 3}
        st = json.loads(bodies["/statusz"])
        assert {"compiles", "serve", "device_memory", "memory",
                "uptime_s"} <= set(st)
        assert st["device_memory"] == {}         # a CPU daemon
        assert st["memory"]["pools"]["kv"]["ghost_pages"] == 0
        assert [v["name"] for v in json.loads(bodies["/alertz"])["slos"]] \
            == [o.name for o in tobs.serve_objectives()]
        assert "paddle_tpu_uptime_seconds" in bodies["/metrics"]
        assert "paddle_tpu_exec_calls_total" in bodies["/metrics"]
        assert "paddle_tpu_tracez_events" in bodies["/metrics"]
        out = tmp_path / "merged.json"
        assert ttracez.main(["merge", base + "/tracez", "-o",
                             str(out)]) == 0
        merged = json.loads(out.read_text())
        assert merged["metadata"]["merged"] == 1
        assert "serve.request" in {e["name"] for e in merged["traceEvents"]}
        proc.send_signal(signal.SIGTERM)
        rest = proc.stdout.read()
        assert proc.wait(timeout=60) == 0 and "DRAINED ok=True" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_server_status_and_stats_line_in_process(tmp_path):
    """An in-process CPU server's /statusz body carries the JAX status
    keys and the memory plane's block, and `stats_line` is the
    SERVE_STATS line of `profiler.serve_stats` (the decode path feeds no
    serve_* counter, as in JAX)."""
    from paddle_tpu_torch import profiler as tprof
    from paddle_tpu_torch.inference.serve import InferenceServer
    paddle.seed(4)
    prefix = str(tmp_path / "gpt")
    jdecode.save_for_decode(GPT(gpt_tiny()), prefix)
    srv = InferenceServer(prefix, port=0, decode=True, decode_slots=2,
                          device="cpu", metrics_port=0)
    try:
        st = srv._status()
        assert {"engine", "uptime_s", "compiles", "serve", "device_memory",
                "memory", "decode"} <= set(st)
        assert st["memory"]["pools"]["kv"]["pages_used"] == 0
        tag, body = srv.stats_line().split(" ", 1)
        stats = json.loads(body)
        assert tag == "SERVE_STATS" and "ts_monotonic" in stats
        stats.pop("ts_monotonic")
        assert stats == tprof.serve_stats()
    finally:
        srv.stop()


# -- core.monitor ----------------------------------------------------------------

def test_stat_shims_match_jax():
    out = []
    for mon, metrics in ((jmonitor, jmetrics), (tmonitor, tmetrics)):
        mon.stat_reset()
        assert mon.stat_inc("obs_steps", 5) == 5
        mon.stat_inc("obs_steps")
        mon.stat_set("obs_epoch", 2)
        got = (mon.stat_get("obs_steps"), mon.all_stats(),
               mon.stat_get("missing", default=-1))
        assert 'paddle_tpu_monitor_stat{name="obs_steps"} 6' in \
            metrics.REGISTRY.render()
        mon.stat_reset("obs_steps")
        out.append(got + (mon.stat_get("obs_steps", default=-1),))
        mon.stat_reset()
    assert out[1] == out[0] == (6, {"obs_steps": 6, "obs_epoch": 2}, -1, -1)


def test_memory_probes_on_the_cpu_and_a_failing_card(monkeypatch):
    """A CPU process gets empty probes (the JAX contract); a visible card
    whose probe fails raises from `device_memory_stats` and reads empty
    in the scrape's `all_device_memory_stats`, as a JAX device does."""
    assert tmonitor.device_memory_stats("cpu") == {}
    assert tmonitor.hbm_usage("cpu") == (0, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmonitor.device_memory_stats() == {}
    assert tmonitor.all_device_memory_stats() == {}

    def boom(*a, **k):
        raise RuntimeError("driver exploded")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", boom)
    assert tmonitor.device_memory_stats("cpu") == {}
    with pytest.raises(RuntimeError, match="driver exploded"):
        tmonitor.device_memory_stats()
    with pytest.raises(RuntimeError, match="driver exploded"):
        tmonitor.hbm_usage("cuda:1")
    assert tmonitor.all_device_memory_stats() == {"cuda:0": {}, "cuda:1": {}}
    monkeypatch.setattr(torch.cuda, "device_count", boom)
    assert tmonitor.all_device_memory_stats() == {}


def test_memory_probes_read_the_jax_keys(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 123,
        "allocated_bytes.all.peak": 456})
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: (1000, 80 << 30))
    want = {"bytes_in_use": 123, "peak_bytes_in_use": 456,
            "bytes_limit": 80 << 30}
    assert tmonitor.device_memory_stats() == want
    assert tmonitor.device_memory_stats("cuda:0") == want
    assert tmonitor.all_device_memory_stats() == {"cuda:0": want}
    assert tmonitor.hbm_usage() == (123, 80 << 30)
    reg = tmetrics.MetricsRegistry()
    tobs.install_default_collectors(reg)
    reg.collect()           # the collectors refresh the global families
    flat = tmetrics.REGISTRY.flat()
    assert flat['paddle_tpu_hbm_bytes_in_use{device="cuda:0"}'] == 123
    assert flat['paddle_tpu_hbm_bytes_limit{device="cuda:0"}'] == 80 << 30
    assert flat["paddle_tpu_uptime_seconds"] > 0


# -- the registry's full surface ------------------------------------------------

def test_registry_surface_matches_jax():
    out = []
    for metrics in (jmetrics, tmetrics):
        reg = metrics.MetricsRegistry()
        h = reg.histogram("paddle_tpu_h_seconds", "H.", labelnames=("k",),
                          sample_cap=64)
        for v in np.random.default_rng(1).exponential(0.01, 200):
            h.labels(k="a").observe(float(v))
        g = reg.gauge("paddle_tpu_g", "G.")
        g.set(3)
        g.inc(2)
        g.dec(1)
        g.set_max(2)
        g.set_max(9)
        c = reg.counter("paddle_tpu_c_total", "C.", labelnames=("x",))
        c.labels(x="1").inc(4)
        c.labels(x="2").inc()
        c.remove(x="2")
        calls = []
        reg.add_collector(lambda: calls.append(1))
        reg.add_collector(lambda: 1 / 0)       # isolated, never breaks
        text = reg.render()
        out.append((text, reg.flat(), reg.names(),
                    [h.labels(k="a").percentile(q) for q in (0.5, 0.99)],
                    h.labels(k="a").count, len(calls)))
    assert out[1] == out[0]
    assert out[1][5] == 2              # render and flat each collect
    assert tmemz.RING.capacity >= 0
