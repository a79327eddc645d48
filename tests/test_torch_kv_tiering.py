"""Host-RAM KV tiering in paddle_tpu_torch (memory.migration and the
decode engine's tier) against the JAX package's engine.

The allocator's handle lifecycle, the host arena, the migration engine
(content exact, chaos failing only its batch) and the trie's leaf-first
eviction are checked on their own; then the tiered engine on the CPU
against the JAX engine's streams over the same weights (the SMALL config,
gpt_tiny and the 1-layer draft of tests/test_kv_tiering.py, as numpy):
more resident conversations than the device pool holds, preempt-to-host
whose stash spills and refetches (greedy, seeded, speculative), a failed
refetch degrading to a re-prefill, a hung one stalling only its stream,
and a clean stop with a refetch parked. No sleeps: migrations are awaited
on their tickets, and a chaos hang waits on an event the test sets.
"""
import dataclasses
import threading
import types

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
    ERR_UNAVAILABLE, TypedServeError)
from paddle_tpu_torch.memory.migration import (  # noqa: E402
    HostPageStore, MigrationEngine, Residency, TieredPageAllocator)
from paddle_tpu_torch.memory.page_allocator import PageAllocator  # noqa: E402
from paddle_tpu_torch.models.gpt import (  # noqa: E402
    GPTConfig, params_from_numpy)
from paddle_tpu_torch.observability import REGISTRY  # noqa: E402
from paddle_tpu_torch.testing import chaos  # noqa: E402

TIMEOUT = 120
SMALL = JGPTConfig(vocab_size=256, max_seq_len=96, hidden=32, layers=2,
                   heads=2, scan_layers=False)
DRAFT = JGPTConfig(vocab_size=512, max_seq_len=128, hidden=32, layers=1,
                   heads=2, scan_layers=False)


def _arrays(model):
    return {k: np.asarray(v)
            for k, v in framework.param_arrays(model).items()}


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    small = GPT(SMALL)
    paddle.seed(7)
    tiny = GPT(gpt_tiny())
    draft = GPT(DRAFT)
    return {"small": (small.cfg, _arrays(small)),
            "tiny": (tiny.cfg, _arrays(tiny)),
            "draft": (draft.cfg, _arrays(draft))}


def _port(model, draft=None, **kw):
    jcfg, arrays = model
    cfg = GPTConfig(**dataclasses.asdict(jcfg))
    params = params_from_numpy(cfg, arrays, "cpu")
    if draft is None:
        return tdecode.DecodeEngine(cfg=cfg, params=params, eps=1e-5,
                                    device="cpu", **kw)
    dcfg = GPTConfig(**dataclasses.asdict(draft[0]))
    return tdecode.SpecDecodeEngine(
        cfg=cfg, params=params, eps=1e-5, draft_cfg=dcfg,
        draft_params=params_from_numpy(dcfg, draft[1], "cpu"),
        draft_eps=1e-5, device="cpu", **kw)


def _jax_streams(model, requests, **kw):
    """The JAX engine's streams for [(prompt, max_new, opts)], served one
    by one by one engine."""
    jcfg, arrays = model
    eng = jdecode.DecodeEngine(cfg=jcfg, params=arrays, eps=1e-5,
                               max_slots=1, max_new_tokens=16,
                               page_tokens=4, **kw)
    try:
        return [eng.submit(p, max_new_tokens=n, **o).result(timeout=TIMEOUT)
                for p, n, o in requests]
    finally:
        eng.stop()


def _flat(name, **labels):
    m = REGISTRY.get(name)
    v = None if m is None else (m.value(**labels) if labels else m.get())
    return v or 0.0


def _track_spills(eng):
    """Start `eng`'s tier and return the list that collects one event per
    spill batch, set once its bookkeeping has run (committed or
    dropped)."""
    eng.warmup()
    done, spill = [], eng._migrate.spill

    def tracked(chunk, handles, count, on_done=None):
        ev = threading.Event()
        done.append(ev)

        def cb(t):
            if on_done is not None:
                on_done(t)
            ev.set()
        return spill(chunk, handles, count, on_done=cb)
    eng._migrate.spill = tracked
    return done


def _await(events):
    for ev in list(events):
        assert ev.wait(TIMEOUT), "a migration batch never retired"


# -- TieredPageAllocator: handle lifecycle --------------------------------

def test_tiered_allocator_handle_lifecycle_and_bounded_spill_begin():
    a = TieredPageAllocator(8, host_pages=4)
    hs = a.spill_begin(2)
    assert len(hs) == 2 and all(h < 0 for h in hs)
    assert {a.handle_slot(h) for h in hs} <= set(range(4))
    assert all(a.residency(h) == Residency.IN_FLIGHT for h in hs)
    assert a.host_used() == 2
    a.spill_commit(hs[0])
    assert a.residency(hs[0]) == Residency.HOST
    with pytest.raises(ValueError):
        a.spill_commit(hs[0])            # already committed
    with pytest.raises(ValueError):
        a.refetch_begin(hs[1])           # still IN_FLIGHT, not HOST
    a.refetch_begin(hs[0])
    with pytest.raises(ValueError):
        a.refetch_begin(hs[0])           # pinned handles stay pinned
    a.refetch_commit(hs[0])
    assert a.residency(hs[0]) is None    # slot freed
    a.host_drop(hs[1])
    a.host_drop(hs[1])                   # idempotent
    st = a.stats()
    assert st["host_pages_total"] == 4 and st["host_pages_used"] == 0
    assert st["spilled_total"] == 1 and st["refetched_total"] == 1
    (p,) = a.alloc(1)
    assert a.residency(p) == Residency.DEVICE
    a.release(p)
    assert a.residency(p) is None

    b = TieredPageAllocator(8, host_pages=3)
    hs = b.spill_begin(10)               # capped at capacity, not an error
    assert len(hs) == 3 and b.spill_begin(1) == []
    b.host_drop(hs[0])
    assert len(b.spill_begin(5)) == 1
    with pytest.raises(ValueError):
        TieredPageAllocator(8, host_pages=0)


# -- HostPageStore and MigrationEngine ------------------------------------

def test_host_store_round_trip_and_padding():
    template = (torch.zeros(2, 5, 3), (torch.zeros(2, 5, 3, 4,
                                                    dtype=torch.int8),
                                       torch.zeros(2, 5, 3)))
    store = HostPageStore(template, capacity=3)
    assert store.nbytes() == 3 * (2 * 3 * 4 + 2 * 3 * 4 + 2 * 3 * 4)
    g = torch.Generator().manual_seed(0)
    chunk = [torch.rand(2, 2, 3, generator=g),
             torch.randint(-128, 127, (2, 2, 3, 4), generator=g,
                           dtype=torch.int8),
             torch.rand(2, 2, 3, generator=g)]
    store.put(0, chunk, 0)
    store.put(2, chunk, 1)
    rows = store.assemble([2, 0], rung=4)
    leaves = [rows[0], rows[1][0], rows[1][1]]
    for leaf, src in zip(leaves, chunk):
        assert leaf.shape == (2, 4) + tuple(src.shape[2:])
        assert leaf.dtype == src.dtype
        assert torch.equal(leaf[:, 0], src[:, 1])
        assert torch.equal(leaf[:, 1], src[:, 0])
        assert not leaf[:, 2:].any()     # rung padding stays zero


def test_migration_round_trip_exact_and_chaos_fails_only_its_batch():
    alloc = TieredPageAllocator(4, host_pages=4)
    store = HostPageStore((torch.zeros(2, 4, 3),), capacity=4)
    eng = MigrationEngine(store, window=2)
    try:
        hs = alloc.spill_begin(2)
        src = torch.arange(12, dtype=torch.float32).reshape(2, 2, 3)

        def commit(t):
            for h in t.handles:
                alloc.spill_commit(h)
        t = eng.spill((src,), hs, 2, on_done=commit)
        assert t.wait(timeout=TIMEOUT) == "ok" and t.error is None
        assert t.chunk is None           # the snapshot is dropped
        assert all(alloc.residency(h) == Residency.HOST for h in hs)
        for h in hs:
            alloc.refetch_begin(h)
        t2 = eng.refetch(hs, rung=4)
        assert t2.wait(timeout=TIMEOUT) == "ok"
        (rows,) = t2.rows
        assert torch.equal(rows[:, :2], src) and not rows[:, 2:].any()
        st = eng.stats()
        assert st["window"] == 2 and st["inflight"] == 0
        assert st["host_arena_bytes"] == store.nbytes()
        assert st["spill_pages"] == 2 and st["refetch_pages"] == 2

        h1, h2 = alloc.spill_begin(1), alloc.spill_begin(1)
        with chaos.inject("page.migrate:1:RuntimeError") as sched:
            t1 = eng.spill((src[:, :1],), h1, 1)
            assert t1.wait(timeout=TIMEOUT) == "failed"
            assert isinstance(t1.error, RuntimeError)
            t3 = eng.spill((src[:, 1:],), h2, 1)   # batch 2 is untouched
            assert t3.wait(timeout=TIMEOUT) == "ok"
        assert sched.fired and sched.fired[0][0] == "page.migrate"
        assert torch.equal(store._arenas[0][alloc.handle_slot(h2[0])],
                           src[:, 1])
    finally:
        eng.stop()
    with pytest.raises(RuntimeError):
        eng.spill((src,), [], 0)         # stopped engine refuses work


# -- _PrefixCache: leaf-first LRU and orphan accounting -------------------

def test_prefix_evict_leaf_first_and_orphans():
    alloc = PageAllocator(8)
    pc = tdecode._PrefixCache(alloc, page_tokens=2)
    prompt = [1, 2, 3, 4, 5, 6]
    pages = alloc.alloc(3)
    pc.insert(prompt, pages)
    for p in pages:                      # the trie holds its own refs
        alloc.release(p)
    hit, _ = pc.lookup(prompt[:2])       # touch the root: MRU
    for p in hit:
        alloc.release(p)
    assert pc.evict(1) == 1              # the tip, not the oldest entry
    st = pc.stats()
    assert st["cached_pages"] == 2 and st["orphaned"] == 0
    hit, tokens = pc.lookup(prompt)
    assert tokens == 4                   # the rest of the chain reachable
    for p in hit:
        alloc.release(p)
    assert pc.evict(5) == 2 and pc.stats()["orphaned"] == 0
    assert alloc.stats()["pages_used"] == 0

    talloc = TieredPageAllocator(8, host_pages=2)
    pc = tdecode._PrefixCache(talloc, page_tokens=2)
    prompt = [9, 8, 7, 6]
    pages = talloc.alloc(2)
    pc.insert(prompt, pages)
    for p in pages:
        talloc.release(p)
    (h,) = talloc.spill_begin(1)
    assert pc.mark_spilled(pc._digests(prompt)[1], pages[1], h)
    talloc.spill_commit(h)
    assert pc.stats()["host_entries"] == 1
    assert pc.evict(1) == 1              # the root is the only device entry
    st = pc.stats()
    assert st["orphaned"] == 1 and st["cached_pages"] == 1
    assert pc.lookup(prompt)[1] == 0     # the stranded child: unreachable
    assert pc.drop_host_lru(1) == 1 and talloc.host_used() == 0
    assert talloc.stats()["pages_used"] == 0


# -- the tiered engine ----------------------------------------------------

def test_tiered_engine_4x_resident_streams_equal_jax(models):
    """8 two-turn conversations over a device pool that holds the cached
    chains of 2: every turn-2 prompt finds its turn-1 KV on the device or
    in the host tier, nothing is shed or destructively evicted, and every
    stream equals the JAX engine's."""
    n, gen = 8, 4
    prompts = [[(7 * i + j) % 256 for j in range(12)] for i in range(n)]
    follows = [[(3 * i + j + 50) % 256 for j in range(4)]
               for i in range(n)]
    ref1 = _jax_streams(models["small"], [(p, gen, {}) for p in prompts])
    turn2 = [p + r + f for p, r, f in zip(prompts, ref1, follows)]
    ref2 = _jax_streams(models["small"], [(p, gen, {}) for p in turn2])
    eng = _port(models["small"], max_slots=1, max_new_tokens=gen,
                page_tokens=4, num_pages=7, host_pages=64)
    try:
        spills = _track_spills(eng)
        f0 = _flat("paddle_tpu_decode_page_alloc_failures_total")
        e0 = _flat("paddle_tpu_decode_prefix_evictions_total")
        out1 = [eng.submit(p, max_new_tokens=gen).result(timeout=TIMEOUT)
                for p in prompts]
        assert out1 == ref1, "turn-1 tokens diverged under tiering"
        _await(spills)
        st = eng.stats()
        assert st["kv_tier"]["spilled_total"] > 0
        # all 8 chains (3 full pages each) stay resident: 4x the pool
        assert st["prefix_cache"]["cached_pages"] >= n * 3
        assert st["prefix_cache"]["host_entries"] > 0
        out2 = [eng.submit(p, max_new_tokens=gen).result(timeout=TIMEOUT)
                for p in turn2]
        assert out2 == ref2, "turn-2 tokens diverged under tiering"
        _await(spills)
        st = eng.stats()
        assert st["kv_tier"]["refetched_total"] > 0
        assert st["prefix_cache"]["hits"] == n     # every turn 2 hit
        assert _flat("paddle_tpu_decode_page_alloc_failures_total") == f0
        assert _flat("paddle_tpu_decode_prefix_evictions_total") == e0
        assert _flat("paddle_tpu_kv_tier_resident_pages", tier="host") \
            == st["pages"]["host_pages_used"]
        assert st["kv_tier"]["host_arena_pinned"] is False   # the CPU
    finally:
        eng.stop()


def _preempt_spill_run(eng, vic, hi, n_tokens):
    """Preempt `vic` by `hi` (priority 5) after its `n_tokens`-th token,
    the scheduler paused meanwhile; returns (victim tokens, hi tokens)."""
    go, holder, step = threading.Event(), {}, eng._step_once

    def gated():
        step()
        s = holder.get("vic")
        if s is not None and len(s.tokens) >= n_tokens:
            go.wait(TIMEOUT)
    eng._step_once = gated
    with eng._cond:
        holder["vic"] = eng.submit(vic[0], max_new_tokens=vic[1], **vic[2])
    for _ in range(n_tokens):
        holder["vic"].next_event(timeout=TIMEOUT)
    h = eng.submit(hi[0], max_new_tokens=hi[1], priority=5)
    go.set()
    return holder["vic"].result(timeout=TIMEOUT), h.result(timeout=TIMEOUT)


# (rng seed, contender prompt length, device pages) by kind: the contender
# outgrows what the pool holds beside the victim's stash (3 prompt pages,
# 2 for the speculative engine, which stashes its prompt region only)
PREEMPT_CASES = {"greedy": (41, 14, 7), "seeded": (43, 14, 7),
                 "speculative": (47, 26, 10)}


@pytest.mark.parametrize("kind", sorted(PREEMPT_CASES))
def test_preempt_spill_restore_equals_jax(models, kind):
    """With a device pool too small for the victim's stash plus the
    contender, the stash spills to host RAM and the resumed victim
    refetches it: its stream equals the JAX engine's unpreempted one."""
    seed, hi_len, num_pages = PREEMPT_CASES[kind]
    rng = np.random.RandomState(seed)
    vic = ([int(t) for t in rng.randint(0, 512, size=9)], 16,
           {"temperature": 0.8, "seed": 123} if kind == "seeded" else {})
    hi = ([int(t) for t in rng.randint(0, 512, size=hi_len)], 6, {})
    ref_vic, ref_hi = _jax_streams(models["tiny"], [vic, hi])
    draft = models["draft"] if kind == "speculative" else None
    kw = {"speculate_k": 4} if draft is not None else {}
    eng = _port(models["tiny"], draft, max_slots=1, max_new_tokens=16,
                page_tokens=4, num_pages=num_pages, host_pages=64,
                preempt=True, **kw)
    try:
        got_vic, got_hi = _preempt_spill_run(eng, vic, hi, n_tokens=4)
        st = eng.stats()
    finally:
        eng.stop()
    assert got_hi == ref_hi
    assert got_vic == ref_vic, f"{kind} spill/restore resume diverged"
    assert st["preemptions"] == 1, st
    assert st["kv_tier"]["spilled_total"] > 0, st["kv_tier"]
    assert st["kv_tier"]["refetched_total"] > 0, st["kv_tier"]


def _populate_spilled(eng, n_convos=3, gen=4):
    """Conversations through a 6-usable-page engine until the earliest
    chains are host-resident; returns (prompts, outputs)."""
    spills = _track_spills(eng)
    prompts = [[(7 * i + j) % 256 for j in range(8)]
               for i in range(n_convos)]
    outs = [eng.submit(p, max_new_tokens=gen).result(timeout=TIMEOUT)
            for p in prompts]
    _await(spills)
    assert eng.stats()["kv_tier"]["spilled_total"] > 0
    return prompts, outs


def _tiered_small(models):
    return _port(models["small"], max_slots=1, max_new_tokens=4,
                 page_tokens=4, num_pages=7, host_pages=64)


def _watch_parks(eng):
    """An event set once `eng` has parked a request on a refetch."""
    parked, fetch = threading.Event(), eng._tier_fetch

    def watched(req, chain):
        ok = fetch(req, chain)
        if ok:
            parked.set()
        return ok
    eng._tier_fetch = watched
    return parked


def test_chaos_migrate_fail_degrades_to_reprefill(models):
    """A failed refetch drops the spilled entries and the stream falls
    back to what is left on the device (here the chain's root page, the
    rest re-fed through the step): slower, never wrong."""
    eng = _tiered_small(models)
    try:
        prompts, outs = _populate_spilled(eng)
        toks = prompts[0] + outs[0] + [99, 98, 97, 96]
        (ref,) = _jax_streams(models["small"], [(toks, 4, {})])
        parked = _watch_parks(eng)
        st0 = eng.stats()
        with chaos.inject("page.migrate:1+:RuntimeError") as sched:
            assert eng.submit(toks, max_new_tokens=4) \
                .result(timeout=TIMEOUT) == ref
        assert parked.is_set() and sched.fired, \
            "no refetch was parked and failed"
        st = eng.stats()
        assert st["kv_tier"]["refetched_total"] \
            == st0["kv_tier"]["refetched_total"]  # nothing landed
        assert st["prefix_cache"]["host_entries"] \
            < st0["prefix_cache"]["host_entries"]  # the entry dropped
        assert st["kv_tier"]["parked_refetches"] == 0
        assert eng.submit(toks, max_new_tokens=4) \
            .result(timeout=TIMEOUT) == ref      # healthy afterwards
    finally:
        eng.stop()


def test_chaos_migrate_hang_stalls_only_parked_stream(models, monkeypatch):
    """A hung refetch parks only the stream waiting on those pages: an
    unrelated stream admitted later finishes first, and the parked one
    resumes with the right tokens once the migration moves."""
    release = threading.Event()
    monkeypatch.setattr(chaos, "time", types.SimpleNamespace(
        sleep=lambda s: release.wait(TIMEOUT)))
    eng = _tiered_small(models)
    try:
        prompts, outs = _populate_spilled(eng)
        a_toks = prompts[0] + outs[0] + [99, 98, 97, 96]
        b_toks = [(5 * j + 1) % 256 for j in range(6)]
        ref_a, ref_b = _jax_streams(models["small"],
                                    [(a_toks, 4, {}), (b_toks, 4, {})])
        parked = _watch_parks(eng)
        with chaos.inject("page.migrate:1:Hang@60") as sched:
            a = eng.submit(a_toks, max_new_tokens=4)
            assert parked.wait(TIMEOUT), "the stream never parked"
            b = eng.submit(b_toks, max_new_tokens=4)
            assert b.result(timeout=TIMEOUT) == ref_b
            assert a.poll() is None, \
                "the parked stream emitted while its refetch hung"
            assert eng.stats()["kv_tier"]["parked_refetches"] == 1
            release.set()
            assert a.result(timeout=TIMEOUT) == ref_a
        assert any(f[0] == "page.migrate" and f[2].startswith("Hang")
                   for f in sched.fired)
    finally:
        release.set()
        eng.stop()


def test_stop_with_parked_refetch_is_clean(models, monkeypatch):
    """Stopping the engine while a stream is parked on a hung refetch
    fails that stream with typed UNAVAILABLE, joins the migration worker
    and leaves no host slot held."""
    release = threading.Event()
    monkeypatch.setattr(chaos, "time", types.SimpleNamespace(
        sleep=lambda s: release.wait(TIMEOUT)))
    eng = _tiered_small(models)
    prompts, outs = _populate_spilled(eng)
    parked = _watch_parks(eng)
    stop = eng._migrate.stop

    def stop_after_release(timeout=30.0):
        release.set()                    # the hang ends while stopping
        stop(timeout)
    eng._migrate.stop = stop_after_release
    with chaos.inject("page.migrate:1:Hang@60"):
        a = eng.submit(prompts[0] + outs[0] + [1, 2, 3, 4],
                       max_new_tokens=4)
        assert parked.wait(TIMEOUT)
        eng.stop()
    with pytest.raises(TypedServeError) as ei:
        a.result(timeout=5)
    assert ei.value.code == ERR_UNAVAILABLE
    assert not eng._migrate._thread.is_alive()
    assert not eng._thread.is_alive()
    assert eng.stats()["pages"]["host_pages_used"] == 0
