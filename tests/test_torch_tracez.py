"""paddle_tpu_torch tracez (`observability.tracez`) and profilez
(`observability.profilez`) against the JAX package's, and the port's
decode engine's dispatch accounting against the JAX engine's.

  * the same scripted events (times, threads and args from a seeded
    generator) recorded into a JAX and a port `TraceRing` with the same
    anchor give the same Chrome trace JSON, wrapped or not, and merge into
    the same fleet timeline; the merge CLI writes the same file;
  * scripted `observe` / `record_compile` calls give the same profilez
    `snapshot`, `top` and `/profilez` body;
  * on the same prompts (gpt_tiny weights carried across), the port's
    DecodeEngine gives the JAX engine's per-label dispatch counts and the
    same tracez event names. One structural difference: the JAX engine's
    prefill returns the prompt's K/V and a second executable
    (``decode.pwrite``) scatters them into the pages, where the port's
    prefill writes its pages itself, so the port has no ``decode.pwrite``
    and the JAX engine has one per prefill. The port's tier spans
    (``page.spill`` / ``page.refetch``) equal the tier's batches.
No sleeps and no overhead bounds."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import framework  # noqa: E402
from paddle_tpu.inference import decode as jdecode  # noqa: E402
from paddle_tpu.models.gpt import GPT, gpt_tiny  # noqa: E402
from paddle_tpu.observability import metrics as jmetrics  # noqa: E402
from paddle_tpu.observability import profilez as jprofilez  # noqa: E402
from paddle_tpu.observability import tracez as jtracez  # noqa: E402
from paddle_tpu_torch.inference import decode as tdecode  # noqa: E402
from paddle_tpu_torch.models.gpt import (  # noqa: E402
    GPTConfig, params_from_numpy)
from paddle_tpu_torch.observability import metrics as tmetrics  # noqa: E402
from paddle_tpu_torch.observability import profilez as tprofilez  # noqa
from paddle_tpu_torch.observability import tracez as ttracez  # noqa: E402

TIMEOUT = 180
PHASES = ("X", "B", "E", "i", "C")


def _script(seed, n):
    """n raw events (ph, name, ts, dur, tid, args) from a seeded rng;
    tids are this thread's and two made-up ones."""
    import threading
    rng = np.random.default_rng(seed)
    tids = [threading.get_ident(), 4242, 777]
    out, t = [], 1000.0
    for i in range(n):
        t += float(rng.exponential(0.002))
        ph = PHASES[int(rng.integers(0, len(PHASES)))]
        args = None if rng.random() < 0.5 else \
            {"req": int(rng.integers(0, 99)), "k": i}
        out.append((ph, f"ev{int(rng.integers(0, 6))}", t,
                    float(rng.exponential(0.001)),
                    tids[int(rng.integers(0, 3))], args))
    return out


def _rings(capacity, component="decode", pid=11, wall=1.7e9,
           mono=1000.0):
    rings = []
    for mod in (jtracez, ttracez):
        r = mod.TraceRing(capacity=capacity, component=component, pid=pid)
        r.anchor_wall, r.anchor_mono = wall, mono
        rings.append(r)
    return rings


@pytest.mark.parametrize("capacity,n", [(64, 40), (16, 40), (0, 5)],
                         ids=["fits", "wraps", "disabled"])
def test_chrome_trace_matches_jax(capacity, n):
    jr, tr = _rings(capacity)
    for ev in _script(capacity + n, n):
        ph, name, ts, dur, tid, args = ev
        jr.record(ph, name, ts, dur, args, tid=tid)
        tr.record(ph, name, ts, dur, args, tid=tid)
    assert tr.chrome_trace() == jr.chrome_trace()
    assert tr.snapshot() == jr.snapshot()
    assert (tr.total, tr.dropped) == (jr.total, jr.dropped) \
        == (n if capacity else 0, max(n - capacity, 0) if capacity else 0)
    assert tr.tail(per_thread=5) == jr.tail(per_thread=5)
    json.dumps(tr.chrome_trace())


def test_span_helpers_match_jax():
    jr, tr = _rings(32, component="serve", pid=3)
    for r in (jr, tr):
        with r.span("work", {"k": 1}):
            pass
        r.instant("mark", {"m": 2})
        r.counter("depth", 5.0)
        r.begin("open")
        r.end("open")
        r.complete("fixed", 1000.5, 1000.75, {"a": 1})
    rows = [[e for e in r.chrome_trace()["traceEvents"] if e["ph"] != "M"]
            for r in (jr, tr)]
    assert [(e["ph"], e["name"], e.get("args")) for e in rows[1]] == \
        [(e["ph"], e["name"], e.get("args")) for e in rows[0]] == [
            ("X", "work", {"k": 1}), ("i", "mark", {"m": 2}),
            ("C", "depth", {"value": 5.0}), ("B", "open", None),
            ("E", "open", None), ("X", "fixed", {"a": 1})]
    assert rows[1][-1]["ts"] == rows[0][-1]["ts"] == round(
        (1.7e9 + 0.5) * 1e6, 3)
    assert rows[1][-1]["dur"] == rows[0][-1]["dur"] == 250000.0


def _merge_inputs(mod, wall):
    """A router ring and two backend rings whose monotonic epochs differ
    (different process boots), one exported through a nested merge."""
    out = []
    for pid, mono, comp in ((1, 100.0, "router"), (2, 1334.5, "serve"),
                            (3, 7.25, "serve")):
        r = mod.TraceRing(capacity=64, component=comp, pid=pid)
        r.anchor_wall, r.anchor_mono = wall, mono
        for ev in _script(pid, 12):
            ph, name, ts, dur, tid, args = ev
            r.record(ph, name, ts - 1000.0 + mono + 5.0, dur, args,
                     tid=tid)
        out.append(r.chrome_trace())
    return [out[0], mod.merge_traces(out[1:])]


def test_merge_matches_jax():
    jm = jtracez.merge_traces(_merge_inputs(jtracez, 1.7e9))
    tm = ttracez.merge_traces(_merge_inputs(ttracez, 1.7e9))
    assert tm == jm
    rows = [e for e in tm["traceEvents"] if e["ph"] != "M"]
    assert [e["ts"] for e in rows] == sorted(e["ts"] for e in rows)
    assert tm["metadata"]["merged"] == 3
    assert {p["pid"] for p in tm["metadata"]["processes"]} == {1, 2, 3}


def test_merge_cli_matches_jax(tmp_path):
    srcs = []
    for i, t in enumerate(_merge_inputs(ttracez, 1.7e9)):
        p = tmp_path / f"r{i}.json"
        p.write_text(json.dumps(t))
        srcs.append(str(p))
    outs = {}
    for name, mod in (("jax", jtracez), ("port", ttracez)):
        out = tmp_path / f"{name}.json"
        assert mod.main(["merge", *srcs, str(tmp_path / "missing.json"),
                         "-o", str(out)]) == 0
        outs[name] = json.loads(out.read_text())
    assert outs["port"] == outs["jax"]
    assert ttracez.main(["merge", str(tmp_path / "missing.json"),
                         "-o", str(tmp_path / "none.json")]) == 1


def test_ring_capacity_env_and_gauges(monkeypatch):
    for raw in ("0", "128", "oops"):
        monkeypatch.setenv("PADDLE_TPU_TRACEZ_CAPACITY", raw)
        assert ttracez.ring_capacity() == jtracez.ring_capacity()
    monkeypatch.setenv("PADDLE_TPU_TRACEZ_CAPACITY", "0")
    r = ttracez.TraceRing()
    r.instant("dropped on the floor")
    assert r.total == 0 and r.chrome_trace()["metadata"]["events"] == 0
    ttracez.RING.instant("gauge.marker")
    flat = tmetrics.REGISTRY.flat()
    assert flat["paddle_tpu_tracez_events"] == ttracez.RING.total
    assert flat["paddle_tpu_tracez_dropped"] == ttracez.RING.dropped
    assert flat["paddle_tpu_tracez_capacity"] == ttracez.RING.capacity


def test_profilez_matches_jax():
    rng = np.random.default_rng(9)
    profs = [mod.ExecProfiler(registry=metrics.MetricsRegistry())
             for mod, metrics in ((jprofilez, jmetrics),
                                  (tprofilez, tmetrics))]
    labels = ["decode.pstep", "decode.prefill", "decode.pcow",
              "decode.pgather"]
    for _ in range(200):
        exe = labels[int(rng.integers(0, 4))]
        wall, block = (float(x) for x in rng.exponential(0.002, 2))
        donated = int(rng.integers(0, 3)) * 4096
        for p in profs:
            p.observe(exe, wall, block, donated)
    for p in profs:
        p.record_compile("decode.pstep", 0.5)
    jp, tp = profs
    assert tp.snapshot() == jp.snapshot()
    assert tp.top(3) == jp.top(3)
    assert tp.profilez() == jp.profilez()
    blocks = [r["block_s"] for r in tp.top(10)]
    assert blocks == sorted(blocks, reverse=True)
    assert sum(r["calls"] for r in tp.top(10)) == 200


# -- the decode engines ------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    paddle.seed(7)
    model = GPT(gpt_tiny())
    arrays = {k: np.asarray(v)
              for k, v in framework.param_arrays(model).items()}
    return model, arrays


def _run(eng, snapshot, ring, prompts, again, n):
    """Serve `prompts` as one wave (queued under the engine's lock, so
    both packages admit them in the same tick), then `again` (a fully
    cached page-aligned prompt: a prefix hit whose last mapped page is
    shared, hence a copy-on-write); returns the per-label dispatch
    deltas, the ring's event names and the engine's steps."""
    ring.clear()
    before = {k: v["calls"] for k, v in snapshot().items()}
    try:
        with eng._cond:
            streams = [eng.submit(p, max_new_tokens=n) for p in prompts]
        for s in streams:
            s.result(timeout=TIMEOUT)
        eng.submit(again, max_new_tokens=n).result(timeout=TIMEOUT)
        steps = eng.stats()["steps"]
    finally:
        eng.stop()
    calls = {k: v["calls"] - before.get(k, 0)
             for k, v in snapshot().items()}
    names = {e[1] for e in ring.snapshot()[0]}
    return {k: v for k, v in calls.items() if v}, names, steps


def test_engine_dispatch_counts_and_event_names_match_jax(tiny):
    model, arrays = tiny
    rng = np.random.default_rng(23)
    head = [int(t) for t in rng.integers(0, 512, 8)]
    prompts = [head + [5, 6, 7], head + [9],
               [int(t) for t in rng.integers(0, 512, 6)]]
    jcalls, jnames, jsteps = _run(
        jdecode.DecodeEngine(model, max_slots=3, page_tokens=4,
                             prefix_cache=True),
        jprofilez.PROFILER.snapshot, jtracez.RING, prompts, head, 6)
    cfg = GPTConfig(**dataclasses.asdict(model.cfg))
    tcalls, tnames, tsteps = _run(
        tdecode.DecodeEngine(cfg=cfg, params=params_from_numpy(
            cfg, arrays, device="cpu"), eps=1e-5, max_slots=3,
            page_tokens=4, prefix_cache=True, device="cpu"),
        tprofilez.PROFILER.snapshot, ttracez.RING, prompts, head, 6)
    # the JAX prefill's separate page scatter (see the module docstring)
    assert jcalls.pop("decode.pwrite") == jcalls["decode.prefill"]
    assert tcalls == jcalls
    assert tcalls["decode.pstep"] == tsteps == jsteps
    assert tcalls["decode.pcow"] >= 1
    jnames = {n for n in jnames if not n.startswith("compile:")}
    jnames.discard("exec:decode.pwrite")
    assert tnames == jnames
    assert {"decode.step", "decode.sample", "decode.admit", "decode.emit",
            "decode.cow", "exec:decode.pstep", "exec:decode.prefill",
            "exec:decode.pcow"} <= tnames


def test_tier_spans_equal_the_tier_batches(tiny):
    """A tiered port engine whose device pool cannot hold the prefixes:
    one page.spill span per spill ticket the engine submitted (and one
    exec:decode.pgather snapshot for each), one page.refetch span per
    landed refetch the scheduler restored (and one exec:decode.ptier
    scatter for each), the spans' pages summing to the tier's page
    totals."""
    model, arrays = tiny
    cfg = GPTConfig(**dataclasses.asdict(model.cfg))
    eng = tdecode.DecodeEngine(
        cfg=cfg, params=params_from_numpy(cfg, arrays, device="cpu"),
        eps=1e-5, max_slots=2, page_tokens=4, num_pages=13, host_pages=40,
        device="cpu")
    eng.warmup()
    rng = np.random.default_rng(29)
    prompts = [[int(t) for t in rng.integers(0, 512, 9)] for _ in range(6)]
    ttracez.RING.clear()
    before = {k: v["calls"] for k, v in tprofilez.PROFILER.snapshot()
              .items()}
    spill_done, restored = [], []
    spill, restore = eng._migrate.spill, eng._tier_restore

    def spill_rec(chunk, handles, count, on_done=None):
        def done(t):
            if on_done is not None:
                on_done(t)
            spill_done.append(t)
        return spill(chunk, handles, count, on_done=done)

    def restore_rec(t, req, pinned):
        restored.append(restore(t, req, pinned))
        return restored[-1]
    eng._migrate.spill = spill_rec
    eng._tier_restore = restore_rec
    try:
        outs = [eng.submit(p, max_new_tokens=5).result(timeout=TIMEOUT)
                for p in prompts]
        for p, o in zip(prompts[:3], outs):
            eng.submit(p + o + [1, 2], max_new_tokens=4).result(
                timeout=TIMEOUT)
        for t in spill_done:
            t.wait(timeout=TIMEOUT)
    finally:
        eng.stop()
    tier = eng.stats()["kv_tier"]
    events = ttracez.RING.snapshot()[0]
    names = [e[1] for e in events]
    pages = {k: sum(e[-1]["pages"] for e in events if e[1] == k)
             for k in ("page.spill", "page.refetch")}
    calls = {k: v["calls"] - before.get(k, 0)
             for k, v in tprofilez.PROFILER.snapshot().items()}
    assert len(spill_done) >= 1 and len(restored) >= 1 and all(restored)
    assert names.count("page.spill") == len(spill_done) \
        == calls["decode.pgather"]
    assert names.count("page.refetch") == len(restored) \
        == calls["decode.ptier"] == names.count("exec:decode.ptier")
    assert pages == {"page.spill": tier["spill_pages"],
                     "page.refetch": tier["refetch_pages"]}


@pytest.mark.parametrize("spec", [False, True])
def test_stopped_engine_is_freed_without_the_cyclic_collector(tiny, spec):
    """The dispatch hook keeps no reference to its engine: a stopped
    engine that its caller drops is freed by reference counting, on the
    dropping thread, with the cyclic collector off (left to the
    collector, its teardown could run on any thread, a CUDA worker's
    among them)."""
    import gc
    import weakref
    model, arrays = tiny
    cfg = GPTConfig(**dataclasses.asdict(model.cfg))
    params = params_from_numpy(cfg, arrays, device="cpu")
    kw = dict(cfg=cfg, params=params, eps=1e-5, max_slots=2, page_tokens=4,
              prefix_cache=True, device="cpu")
    if spec:
        kw.update(draft_cfg=cfg, draft_params=params, draft_eps=1e-5,
                  speculate_k=2)
    head = [5, 6, 7, 8, 9, 10, 11, 12]
    gc.collect()
    gc.disable()
    try:
        eng = (tdecode.SpecDecodeEngine if spec else tdecode.DecodeEngine)(
            **kw)
        eng.warmup()
        for _ in range(2):      # a prefill, then a full hit's copy-on-write
            eng.submit(head, max_new_tokens=4).result(timeout=TIMEOUT)
        assert eng.stats()["cow_copies"] >= 1
        eng.stop()
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_spec_engine_dispatch_counts_and_event_names_match_jax(tiny):
    """The speculative engines on the same prompts, the model drafting
    for itself: the same per-label dispatch counts (draft prefill,
    rollout, verify, both copy-on-writes) and the same tracez event
    names, the JAX prefill's page scatter aside."""
    model, arrays = tiny
    rng = np.random.default_rng(31)
    head = [int(t) for t in rng.integers(0, 512, 8)]
    prompts = [head + [3, 4], [int(t) for t in rng.integers(0, 512, 5)]]
    kw = dict(max_slots=2, page_tokens=4, prefix_cache=True,
              speculate_k=2)
    jcalls, jnames, jsteps = _run(
        jdecode.SpecDecodeEngine(model, draft_model=model, **kw),
        jprofilez.PROFILER.snapshot, jtracez.RING, prompts, head, 6)
    cfg = GPTConfig(**dataclasses.asdict(model.cfg))
    params = params_from_numpy(cfg, arrays, device="cpu")
    tcalls, tnames, tsteps = _run(
        tdecode.SpecDecodeEngine(cfg=cfg, params=params, eps=1e-5,
                                 draft_cfg=cfg, draft_params=params,
                                 draft_eps=1e-5, device="cpu", **kw),
        tprofilez.PROFILER.snapshot, ttracez.RING, prompts, head, 6)
    assert jcalls.pop("decode.pwrite") == jcalls["decode.prefill"]
    assert tcalls == jcalls
    assert tcalls["decode.verify"] == tcalls["decode.droll"] == tsteps \
        == jsteps
    assert tcalls["decode.pcow"] == tcalls["decode.dcow"] >= 1
    jnames = {n for n in jnames if not n.startswith("compile:")}
    jnames.discard("exec:decode.pwrite")
    assert tnames == jnames
    assert {"decode.draft", "decode.verify", "decode.accept",
            "exec:decode.dprefill", "exec:decode.droll",
            "exec:decode.verify", "exec:decode.dcow"} <= tnames
