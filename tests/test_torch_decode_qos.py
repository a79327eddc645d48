"""Multi-tenant QoS in paddle_tpu_torch's decode engine against the JAX
package's engine.

The same weights (the JAX gpt_tiny and the 1-layer draft of
tests/test_decode_qos.py, carried across as numpy) go through the port's
engines on the CPU and the JAX engine (its plain XLA attention). The
scheduler is held deterministically, with no sleeps and no wall-clock
bound: a preemption is provoked by pausing the victim's scheduler after
its third token until the high-priority request is queued, a backlog is
queued whole under the engine's lock before the first admission, and the
quota bucket runs on an injected clock.

  * preempt to host and resume: greedy, seeded and speculative streams
    equal the JAX engine's unpreempted streams token for token, and the
    client's stream is gapless across the preemption;
  * a chaos-abandoned preemption leaves the victim unharmed;
  * weighted-fair admission: the admission order equals the JAX
    engine's on the same backlog, and the 4x-weighted tenant takes the
    majority of the early slots;
  * quota deferral: every request completes with the JAX tokens, and the
    capped tenant's deferrals are counted;
  * a flood past its weighted share is shed while another tenant admits.
"""
import dataclasses
import itertools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import framework  # noqa: E402
from paddle_tpu.inference import decode as jdecode  # noqa: E402
from paddle_tpu.models.gpt import GPT, GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models.gpt import gpt_tiny  # noqa: E402
from paddle_tpu_torch.inference import decode as tdecode  # noqa: E402
from paddle_tpu_torch.inference.errors import (  # noqa: E402
    ERR_RESOURCE_EXHAUSTED, TypedServeError)
from paddle_tpu_torch.models.gpt import (  # noqa: E402
    GPTConfig, params_from_numpy)
from paddle_tpu_torch.observability import REGISTRY  # noqa: E402
from paddle_tpu_torch.testing import chaos  # noqa: E402

TIMEOUT = 120
PT = 4


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    tiny = GPT(gpt_tiny())
    draft = GPT(JGPTConfig(vocab_size=512, max_seq_len=128, hidden=32,
                           layers=1, heads=2, scan_layers=False))
    arrays = {k: np.asarray(v)
              for k, v in framework.param_arrays(tiny).items()}
    darrays = {k: np.asarray(v)
               for k, v in framework.param_arrays(draft).items()}
    return {"tiny": tiny, "draft": draft, "arrays": arrays,
            "darrays": darrays}


def _cfg(jcfg):
    return GPTConfig(**dataclasses.asdict(jcfg))


def _port(m, **kw):
    cfg = _cfg(m["tiny"].cfg)
    return tdecode.DecodeEngine(
        cfg=cfg, params=params_from_numpy(cfg, m["arrays"], "cpu"),
        eps=1e-5, device="cpu", **kw)


def _port_spec(m, **kw):
    cfg, dcfg = _cfg(m["tiny"].cfg), _cfg(m["draft"].cfg)
    return tdecode.SpecDecodeEngine(
        cfg=cfg, params=params_from_numpy(cfg, m["arrays"], "cpu"),
        eps=1e-5, draft_cfg=dcfg,
        draft_params=params_from_numpy(dcfg, m["darrays"], "cpu"),
        draft_eps=1e-5, device="cpu", **kw)


def _flat(name, **labels):
    """One sample of a port metric family (0 before it exists)."""
    m = REGISTRY.get(name)
    v = None if m is None else (m.value(**labels) if labels else m.get())
    return v or 0.0


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX engine's unpreempted streams for every prompt below, from
    one engine (one compile of each rung)."""
    rng = np.random.RandomState(41)
    cases = {
        "vic": (rng.randint(0, 512, size=9), 16, {}),
        "hi": (rng.randint(0, 512, size=7), 6, {}),
        "vic_seeded": (rng.randint(0, 512, size=8), 14,
                       {"temperature": 0.8, "seed": 123}),
        "spec_vic": (rng.randint(0, 512, size=8), 12, {}),
        "spec_hi": (rng.randint(0, 512, size=6), 5, {}),
    }
    for i in range(5):
        cases[f"quota{i}"] = (rng.randint(0, 512, size=6), 4, {})
    eng = jdecode.DecodeEngine(cfg=models["tiny"].cfg,
                               params=models["arrays"], eps=1e-5,
                               max_slots=1, max_new_tokens=16,
                               page_tokens=PT, preempt=False)
    try:
        out = {k: ([int(t) for t in p],
                   eng.submit(p, max_new_tokens=n, **o)
                   .result(timeout=TIMEOUT), o)
               for k, (p, n, o) in cases.items()}
    finally:
        eng.stop()
    return out


def _gate_after(eng, holder, n_tokens):
    """Pause `eng`'s scheduler after the step that gives
    ``holder["vic"]`` its `n_tokens`-th token, until the returned event is
    set (the test queues its high-priority request meanwhile)."""
    go = threading.Event()
    step = eng._step_once

    def gated():
        step()
        s = holder.get("vic")
        if s is not None and len(s.tokens) >= n_tokens:
            go.wait(TIMEOUT)
    eng._step_once = gated
    return go


def _preempt_run(eng, vic_case, hi_case, n_tokens=3):
    """Run the victim, queue the high-priority request after its
    `n_tokens`-th token, and collect both streams event by event."""
    holder = {}
    go = _gate_after(eng, holder, n_tokens)
    (pv, nv, ov), (ph, nh, oh) = vic_case, hi_case
    with eng._cond:                   # no admission before `holder` is set
        holder["vic"] = eng.submit(pv, max_new_tokens=nv, **ov)
    vic = holder["vic"]
    early = [vic.next_event(timeout=TIMEOUT)[1] for _ in range(n_tokens)]
    hi = eng.submit(ph, max_new_tokens=nh, priority=5, **oh)
    go.set()
    hi_out = hi.result(timeout=TIMEOUT)
    streamed = [ev[1] for ev in vic.events(timeout=TIMEOUT)]
    return early, streamed, list(vic.tokens), hi_out


@pytest.mark.parametrize("kind", ["greedy", "seeded"])
def test_preempt_resume_equals_jax(models, jax_streams, kind):
    """A preempted-then-resumed stream equals the JAX engine's
    unpreempted stream, and the client's stream is gapless: the events
    before and after the preemption are exactly the final tokens."""
    vic_key = "vic" if kind == "greedy" else "vic_seeded"
    p, want, opts = jax_streams[vic_key]
    ph, want_hi, _ = jax_streams["hi"]
    eng = _port(models, max_slots=1, max_new_tokens=16, page_tokens=PT,
                preempt=True)
    try:
        p0 = _flat("paddle_tpu_decode_preemptions_total")
        r0 = _flat("paddle_tpu_decode_preempt_resumes_total")
        early, streamed, done, hi_out = _preempt_run(
            eng, (p, len(want), opts), (ph, len(want_hi), {}))
        st = eng.stats()
    finally:
        eng.stop()
    assert hi_out == want_hi
    assert done == want, "resumed stream diverged from the JAX stream"
    assert early + streamed == done, "tokens re-emitted or dropped"
    assert st["preemptions"] == 1 and st["preempt_resumes"] == 1, st
    assert _flat("paddle_tpu_decode_preemptions_total") == p0 + 1
    assert _flat("paddle_tpu_decode_preempt_resumes_total") == r0 + 1


def test_preempt_resume_speculative_equals_jax(models, jax_streams):
    """Preemption composes with draft-and-verify: a preempted speculative
    stream resumes over prompt + generated and equals the JAX stream."""
    p, want, _ = jax_streams["spec_vic"]
    ph, want_hi, _ = jax_streams["spec_hi"]
    eng = _port_spec(models, speculate_k=4, max_slots=1, max_new_tokens=16,
                     page_tokens=PT, preempt=True)
    try:
        _, _, done, hi_out = _preempt_run(
            eng, (p, len(want), {}), (ph, len(want_hi), {}), n_tokens=2)
        st = eng.stats()
    finally:
        eng.stop()
    assert hi_out == want_hi
    assert done == want
    assert st["preemptions"] == 1, st


def test_chaos_abandoned_preemption_leaves_victim_unharmed(models,
                                                          jax_streams):
    """Chaos at decode.preempt abandons every eviction: the victim keeps
    its slot and decodes to the JAX stream, the high-priority request is
    requeued and served after it, and no preemption is counted."""
    p, want, _ = jax_streams["vic"]
    ph, want_hi, _ = jax_streams["hi"]
    eng = _port(models, max_slots=1, max_new_tokens=16, page_tokens=PT,
                preempt=True)
    try:
        p0 = _flat("paddle_tpu_decode_preemptions_total")
        with chaos.inject("decode.preempt:1+:RuntimeError") as sched:
            early, streamed, done, hi_out = _preempt_run(
                eng, (p, len(want), {}), (ph, len(want_hi), {}))
        st = eng.stats()
    finally:
        eng.stop()
    assert sched.fired and sched.fired[0][0] == "decode.preempt"
    assert done == want and early + streamed == want
    assert hi_out == want_hi
    assert st["preemptions"] == 0
    assert _flat("paddle_tpu_decode_preemptions_total") == p0


def _admission_order(eng, submit_all):
    """Queue a whole backlog under the engine's lock (nothing is admitted
    before all of it is queued) and record the tenant of every admission
    in order; returns (streams, order)."""
    order = []
    admit = eng._admit

    def recording(req):
        order.append(req.tenant)
        return admit(req)
    eng._admit = recording
    with eng._cond:
        streams = submit_all(eng)
    for s in streams:
        s.result(timeout=TIMEOUT)
    return order


def test_weighted_fair_admission_matches_jax(models):
    """Both tenants backlogged behind one slot, the light tenant queued
    first: the port admits in the JAX engine's order, and the 4x-weighted
    tenant wins the majority of the first ten slots after the blocker."""
    rng = np.random.RandomState(59)
    blocker = rng.randint(0, 512, size=6)
    light = [rng.randint(0, 512, size=5) for _ in range(10)]
    heavy = [rng.randint(0, 512, size=5) for _ in range(10)]

    def submit_all(eng):
        out = [eng.submit(blocker, max_new_tokens=8)]
        out += [eng.submit(p, max_new_tokens=2, tenant="light")
                for p in light]
        out += [eng.submit(p, max_new_tokens=2, tenant="heavy")
                for p in heavy]
        return out

    kw = dict(max_slots=1, max_new_tokens=8, max_pending=64,
              tenant_weights="heavy:4,light:1")
    eng = _port(models, page_tokens=PT, **kw)
    try:
        order = _admission_order(eng, submit_all)
        st = eng.stats()
    finally:
        eng.stop()
    jeng = jdecode.DecodeEngine(cfg=models["tiny"].cfg,
                                params=models["arrays"], eps=1e-5,
                                page_tokens=PT, **kw)
    try:
        jorder = _admission_order(jeng, submit_all)
    finally:
        jeng.stop()
    assert order == jorder
    assert order[0] == "default"
    assert order[1:11].count("heavy") >= 6, order
    assert st["tenant_admissions"] == {"default": 1, "heavy": 10,
                                       "light": 10}
    assert st["tenants"]["heavy"] == pytest.approx(20 / 4)


def test_quota_deferral_on_injected_clock(models, jax_streams,
                                          monkeypatch):
    """A tenant past its token-rate quota is deferred (queued), never
    shed: on a clock that advances 50 ms a scheduler tick, every request
    completes with the JAX tokens, the free tenant is never deferred, and
    each capped request is counted at most once."""
    ticks = itertools.count()
    monkeypatch.setattr(tdecode, "_quota_clock",
                        lambda: 1000.0 + 0.05 * next(ticks))
    cases = [jax_streams[f"quota{i}"] for i in range(5)]
    eng = _port(models, max_slots=2, max_new_tokens=8, max_pending=64,
                page_tokens=PT, tenant_quota="capped:8")
    key = "paddle_tpu_tenant_quota_deferred_total"
    try:
        c0, f0 = _flat(key, tenant="capped"), _flat(key, tenant="free")
        streams = [eng.submit(p, max_new_tokens=len(w), tenant="capped")
                   for p, w, _ in cases]
        free = eng.submit(cases[0][0], max_new_tokens=4, tenant="free")
        assert free.result(timeout=TIMEOUT) == cases[0][1]
        for s, (_, want, _) in zip(streams, cases):
            assert s.result(timeout=TIMEOUT) == want
    finally:
        eng.stop()
    deferred = _flat(key, tenant="capped") - c0
    assert 1 <= deferred <= len(cases), deferred
    assert _flat(key, tenant="free") == f0


def test_tenant_share_shed_spares_other_tenants(models):
    """A flood filling its weighted share of the pending queue is shed
    with a typed RESOURCE_EXHAUSTED, counted per tenant, while another
    tenant's submit still admits and every queued stream completes."""
    rng = np.random.RandomState(67)
    eng = _port(models, max_slots=1, max_new_tokens=8, max_pending=8,
                page_tokens=PT, tenant_weights="good:4,flood:1")
    key = "paddle_tpu_tenant_shed_total"
    try:
        s0 = _flat(key, tenant="flood")
        with eng._cond:      # everything queued before the first admission
            blocker = eng.submit(rng.randint(0, 512, size=6),
                                 max_new_tokens=8)
            flood, sheds = [], 0
            for _ in range(16):
                try:
                    flood.append(eng.submit(rng.randint(0, 512, size=5),
                                            max_new_tokens=2,
                                            tenant="flood"))
                except TypedServeError as e:
                    assert e.code == ERR_RESOURCE_EXHAUSTED
                    sheds += 1
            good = eng.submit(rng.randint(0, 512, size=5),
                              max_new_tokens=2, tenant="good")
        assert len(flood) == 4 and sheds == 12       # share round(8 / 2)
        assert len(blocker.result(timeout=TIMEOUT)) == 8
        assert len(good.result(timeout=TIMEOUT)) == 2
        for s in flood:
            assert len(s.result(timeout=TIMEOUT)) == 2
    finally:
        eng.stop()
    assert _flat(key, tenant="flood") == s0 + sheds
