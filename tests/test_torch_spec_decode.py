"""paddle_tpu_torch speculative decoding against the JAX package.

  * `PageAllocator.release_range`: one op sequence on both packages'
    allocators gives the same returns, refcounts and free list, and the
    same ValueError before any refcount moves;
  * `spec_k_ladder` for k = 1..17 and `DecodeStream`'s batched events
    (`_push_tokens` unbatched into one event per token by `next_event` /
    `poll`);
  * `gpt_paged_verify_fns` and `gpt_paged_rollout_fns` against JAX's on
    the same numpy weights, pools and tokens: the scan-stacked gpt_tiny
    and the 3-layer unrolled config of tests/test_decode_spec.py, fp32
    and int8 weights, fp32 and int8 pools, window rows past max_seq_len
    (null-page writes). Logits and pools within 1e-5 (dequantized int8
    pools: 1e-4); argmax and drafts equal;
  * `SpecDecodeEngine` on the JAX test's rig (speculate_k=4, 2 slots,
    4-token pages, prefix cache on; a rejection-heavy 1-layer draft and a
    self-draft), requests one at a time: greedy and seeded-temperature
    streams equal the JAX SpecDecodeEngine's and the port's plain
    engine's token for token, with equal drafted / accepted totals and
    equal per-request counter deltas (tokens, steps, prefills, prefix
    hits and misses, COW, the spec counters);
  * `load_for_decode` of JAX `save_for_decode` artifacts (opt-in
    speculation, `draft_quant`, the env flags, the vocab and max_seq_len
    errors) and JAX's prefix-cache / shared-allocator stress on the
    port's trie and allocator.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import framework  # noqa: E402
from paddle_tpu import quant as jquant  # noqa: E402
from paddle_tpu.inference import decode as jdecode  # noqa: E402
from paddle_tpu.memory import page_allocator as jpa  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch import quant as tquant  # noqa: E402
from paddle_tpu_torch.inference import decode as tdecode  # noqa: E402
from paddle_tpu_torch.inference.errors import (  # noqa: E402
    ERR_UNAVAILABLE, TypedServeError)
from paddle_tpu_torch.memory import page_allocator as tpa  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402

PT = 4
TOL = 1e-5          # logits and fp32 pools
INT8_POOL_TOL = 1e-4
TIMEOUT = 180

_CFGS = {
    "tiny-scan": jgpt.gpt_tiny(),                       # scan-stacked
    "small-unrolled": jgpt.GPTConfig(vocab_size=256, max_seq_len=64,
                                     hidden=32, layers=3, heads=2,
                                     scan_layers=False),
}
# the rejection-heavy draft of tests/test_decode_spec.py for tiny-scan;
# small-unrolled drafts with the target itself (acceptance-heavy)
_TINY_DRAFT_CFG = jgpt.GPTConfig(vocab_size=512, max_seq_len=128, hidden=32,
                                 layers=1, heads=2, scan_layers=False)


def _pcfg(cfg):
    return tgpt.GPTConfig(**dataclasses.asdict(cfg))


def _arrays(model):
    return {k: np.asarray(v)
            for k, v in framework.param_arrays(model).items()}


@pytest.fixture(scope="module")
def rig():
    paddle.seed(7)
    models = {name: jgpt.GPT(cfg) for name, cfg in _CFGS.items()}
    drafts = {"tiny-scan": jgpt.GPT(_TINY_DRAFT_CFG),
              "small-unrolled": models["small-unrolled"]}
    return models, drafts


# ------------------------------------------------------- release_range

def _alloc_ops(pa):
    """One op sequence (alloc, retain, release, release_range incl. a
    shared page, an empty tail, a negative start and a bad id) on a
    package's allocator; returns every observable result."""
    a = pa.PageAllocator(12)
    out = []
    p = a.alloc(7)
    a.retain(p[3])
    a.retain(p[5])
    out.append(a.release_range(p, 2))
    out.append([a.refcount(x) for x in range(12)])
    out.append(a.release_range(p, 7))
    q = a.alloc(3)
    a.release(q[1])
    before = [a.refcount(x) for x in range(12)]
    with pytest.raises(ValueError, match="unallocated"):
        a.release_range([q[0], q[1], q[2]], 0)      # q[1] is free
    out.append([a.refcount(x) for x in range(12)] == before)
    out.append(a.release_range([q[0], q[2], p[3], p[5]], -3))
    out.append(a.release_range(p[:2], 0))
    st = a.stats()
    out.append({k: st[k] for k in ("pages_free", "pages_used",
                                   "pages_shared", "refs_total",
                                   "fragmentation", "allocs_total")})
    out.append(list(a._free))
    return out


def test_release_range_matches_jax():
    assert _alloc_ops(tpa) == _alloc_ops(jpa)


def test_spec_k_ladder_matches_jax():
    for k in range(1, 18):
        assert tdecode.spec_k_ladder(k) == jdecode.spec_k_ladder(k), k


def _events(stream_cls, err_cls):
    s = stream_cls(1, [1, 2])
    s._push_tokens([5, 6, 7], eos=False)
    s._push_token(8, eos=False)
    s._push_tokens([9, 10], eos=True)
    s._push_done()
    evs = [s.poll() for _ in range(7)] + [s.poll(), list(s.tokens)]
    s2 = stream_cls(2, [1])
    s2._push_tokens([3, 4], eos=False)
    evs.append(s2.next_event())
    s2._push_error(err_cls(ERR_UNAVAILABLE, "boom"))
    evs.append(s2.poll())       # the unbatched rest drains first
    with pytest.raises(err_cls):
        s2.poll()
    return evs


def test_stream_batched_events_match_jax():
    from paddle_tpu.inference.errors import TypedServeError as JErr
    got = _events(tdecode.DecodeStream, TypedServeError)
    assert got == _events(jdecode.DecodeStream, JErr)
    assert got[:7] == [("token", 5, False), ("token", 6, False),
                       ("token", 7, False), ("token", 8, False),
                       ("token", 9, False), ("token", 10, True),
                       ("done", [5, 6, 7, 8, 9, 10])]


# -------------------------------------------- verify and rollout vs JAX

def _pool_pair(rng, shape, int8):
    """The same pool in both packages: fp32 normals, or their int8
    (data, scale) quantization by the JAX package."""
    k = rng.standard_normal(shape).astype(np.float32)
    if not int8:
        return jnp.asarray(k), torch.from_numpy(k.copy())
    q = jquant.quantize_kv(jnp.asarray(k))
    return q, tuple(torch.from_numpy(np.array(t)) for t in q)


def _pool_err(tpool, jpool):
    """Largest difference of two pools (an int8 pair dequantized), the
    null page (don't-care padding writes) left out."""
    if isinstance(tpool, tuple):
        got = tquant.dequantize_kv(*tpool).numpy()
        want = np.asarray(jquant.dequantize_kv(*jpool))
    else:
        got, want = tpool.numpy(), np.asarray(jpool)
    return float(np.abs(got[:, 1:] - want[:, 1:]).max())


@pytest.mark.parametrize("name,wq,kv8", [
    ("tiny-scan", False, False), ("tiny-scan", True, True),
    ("small-unrolled", False, True), ("small-unrolled", True, False)])
def test_verify_and_rollout_match_jax(rig, name, wq, kv8):
    cfg = _CFGS[name]
    arrays = _arrays(rig[0][name])
    if wq:
        arrays = jquant.quantize_params(arrays)
    pcfg = _pcfg(cfg)
    params = tgpt.params_from_numpy(pcfg, arrays, device="cpu")
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    rng = np.random.default_rng(0)
    P, W, B, K1 = 40, 6, 3, 5
    shape = (cfg.layers, P, PT, cfg.heads, cfg.head_dim)
    tables = np.zeros((B, W), np.int32)            # row 2: all-null table
    perm = rng.permutation(np.arange(1, P))
    tables[0, :5] = perm[:5]
    tables[1, :6] = perm[5:11]
    # row 1's window runs past max_seq_len: those rows go to page 0
    clen = np.asarray([9, cfg.max_seq_len - 2, 0], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (B, K1)).astype(np.int32)
    forced = np.full((B, K1 - 1), -1, np.int32)    # catch-up then chain
    forced[:, 0] = toks[:, 0]
    forced[0, 1] = toks[0, 1]
    tol = INT8_POOL_TOL if kv8 else TOL

    jk, tk = _pool_pair(rng, shape, kv8)
    jv, tv = _pool_pair(rng, shape, kv8)
    jl, ja, jk2, jv2 = jgpt.gpt_paged_verify_fns(cfg, page_tokens=PT)(
        jparams, jk, jv, jnp.asarray(tables), jnp.asarray(toks),
        jnp.asarray(clen))
    tl, ta, tk2, tv2 = tgpt.gpt_paged_verify_fns(pcfg, page_tokens=PT)(
        params, tk, tv, torch.from_numpy(tables), torch.from_numpy(toks),
        torch.from_numpy(clen))
    assert tk2 is tk and tv2 is tv                 # written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert _pool_err(tk2, jk2) <= tol and _pool_err(tv2, jv2) <= tol

    jk, tk = _pool_pair(rng, shape, kv8)
    jv, tv = _pool_pair(rng, shape, kv8)
    jd, jk3, jv3 = jgpt.gpt_paged_rollout_fns(cfg, page_tokens=PT)(
        jparams, jk, jv, jnp.asarray(tables), jnp.asarray(forced),
        jnp.asarray(clen))
    td, tk3, tv3 = tgpt.gpt_paged_rollout_fns(pcfg, page_tokens=PT)(
        params, tk, tv, torch.from_numpy(tables), torch.from_numpy(forced),
        torch.from_numpy(clen))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert _pool_err(tk3, jk3) <= tol and _pool_err(tv3, jv3) <= tol


# ------------------------------------------------------ the engine

_COUNTERS = ("tokens", "steps", "prefills", "prefix_hits", "prefix_misses",
             "prefix_hit_tokens", "prefix_lookup_tokens", "cow",
             "page_allocs", "spec_draft_steps", "spec_accepted",
             "spec_rejected", "page_rollback_released")


def _prompts():
    base = [[1, 2, 3], [5, 4, 3, 2, 1, 8, 9], [7] * 9, [11, 3, 11, 3, 11]]
    shared = [9, 8, 7, 6, 5, 4, 3, 2]
    # a page-aligned prefix hit, then the fully cached prompt again: its
    # first write lands in a shared page (copy-on-write)
    return base + [shared, shared + [1, 2], shared]


def _serve(eng, metrics):
    """Every prompt greedy, then three seeded temperature streams, one
    request at a time; returns (outputs, counter deltas)."""
    before = {k: metrics[k].get() for k in _COUNTERS}
    outs = [eng.submit(p, max_new_tokens=12).result(timeout=TIMEOUT)
            for p in _prompts()]
    outs += [eng.submit(p, max_new_tokens=10, temperature=0.9, top_k=16,
                        seed=40 + i).result(timeout=TIMEOUT)
             for i, p in enumerate(_prompts()[:3])]
    return outs, {k: metrics[k].get() - before[k] for k in _COUNTERS}


@pytest.mark.parametrize("name", list(_CFGS))
def test_spec_engine_matches_jax_and_the_plain_engine(rig, name):
    models, drafts = rig
    model, draft = models[name], drafts[name]
    kw = dict(max_slots=2, max_new_tokens=24, page_tokens=PT,
              prefix_cache=True)
    jeng = jdecode.SpecDecodeEngine(model, draft_model=draft,
                                    speculate_k=4, **kw)
    try:
        jouts, jdelta = _serve(jeng, jdecode._decode_metrics())
        jspec = jeng.stats()["speculate"]
    finally:
        jeng.stop()

    pcfg, dcfg = _pcfg(model.cfg), _pcfg(draft.cfg)
    eng = tdecode.SpecDecodeEngine(
        cfg=pcfg, params=tgpt.params_from_numpy(pcfg, _arrays(model), "cpu"),
        eps=1e-5, draft_cfg=dcfg, draft_eps=1e-5,
        draft_params=tgpt.params_from_numpy(dcfg, _arrays(draft), "cpu"),
        speculate_k=4, device="cpu", **kw)
    try:
        outs, delta = _serve(eng, tdecode._decode_metrics())
        st = eng.stats()
    finally:
        eng.stop()
    plain = tdecode.DecodeEngine(
        cfg=pcfg, params=tgpt.params_from_numpy(pcfg, _arrays(model), "cpu"),
        eps=1e-5, device="cpu", **kw)
    try:
        pouts, _ = _serve(plain, tdecode._decode_metrics())
    finally:
        plain.stop()

    assert outs == jouts
    assert outs == pouts
    sp = st["speculate"]
    assert (sp["drafted"], sp["accepted"], sp["k_ladder"]) \
        == (jspec["drafted"], jspec["accepted"], jspec["k_ladder"])
    assert sp["acceptance_rate"] == jspec["acceptance_rate"]
    assert delta == jdelta
    assert delta["prefix_hits"] >= 1 and delta["cow"] >= 1
    assert sp["draft_steps"] == delta["spec_draft_steps"]
    assert sp["rollback_released"] == delta["page_rollback_released"]
    if name == "tiny-scan":          # the draft misses: rollbacks happen
        assert delta["spec_rejected"] > 0
        assert delta["page_rollback_released"] > 0
    else:                            # the self-draft is accepted
        assert sp["accepted"] / sp["drafted"] > 0.5
    # no leak: only the prefix cache's pins are left
    assert st["pages"]["pages_used"] == st["prefix_cache"]["cached_pages"]


def test_long_prompt_tail_streams_equal_the_plain_engines(rig):
    """A prefix hit whose uncached tail is longer than k + 1 feeds the
    tail through several verifies; one that ends inside the prompt must
    emit nothing. The port's speculative streams equal its plain
    engine's and the JAX plain engine's. (The JAX SpecDecodeEngine emits
    a token after such a verify and so differs here: ROADMAP queue 3.)"""
    model = rig[0]["tiny-scan"]
    pcfg = _pcfg(model.cfg)
    head = list(range(1, 9))                        # two 4-token pages
    tail = [int(t) for t in np.random.default_rng(0).integers(0, 512, 20)]
    prompts = [head + [40, 41], head + tail, head + tail[:7]]
    kw = dict(max_slots=2, page_tokens=PT, prefix_cache=True)
    arrays = _arrays(model)

    def serve(eng):
        try:
            return [eng.submit(p, max_new_tokens=8).result(timeout=TIMEOUT)
                    for p in prompts]
        finally:
            eng.stop()

    spec = serve(tdecode.SpecDecodeEngine(
        cfg=pcfg, params=tgpt.params_from_numpy(pcfg, arrays, "cpu"),
        draft_cfg=pcfg, draft_params=tgpt.params_from_numpy(pcfg, arrays,
                                                            "cpu"),
        speculate_k=4, device="cpu", **kw))
    plain = serve(tdecode.DecodeEngine(
        cfg=pcfg, params=tgpt.params_from_numpy(pcfg, arrays, "cpu"),
        device="cpu", **kw))
    jplain = serve(jdecode.DecodeEngine(cfg=model.cfg, params=arrays,
                                        eps=1e-5, **kw))
    assert spec == plain == jplain


def test_spec_warmup_keeps_the_k_ladder(rig):
    """Warmup runs each k rung once at the largest shapes and leaves the
    adaptive-k ladder whole, so a warmed engine streams what a cold one
    does, with the same drafted / accepted totals."""
    model, draft = rig[0]["tiny-scan"], rig[1]["tiny-scan"]
    pcfg, dcfg = _pcfg(model.cfg), _pcfg(draft.cfg)
    kw = dict(max_slots=8, page_tokens=PT, prefix_cache=False)

    def serve(warm):
        eng = tdecode.SpecDecodeEngine(
            cfg=pcfg, params=tgpt.params_from_numpy(pcfg, _arrays(model),
                                                    "cpu"),
            draft_cfg=dcfg, draft_params=tgpt.params_from_numpy(
                dcfg, _arrays(draft), "cpu"),
            speculate_k=4, device="cpu", **kw)
        try:
            n = eng.warmup() if warm else 0
            outs = [eng.submit(p, max_new_tokens=8).result(timeout=TIMEOUT)
                    for p in _prompts()[:3]]
            sp = eng.stats()["speculate"]
            return n, outs, (sp["k_ladder"], sp["drafted"], sp["accepted"])
        finally:
            eng.stop()

    n, warm, warm_sp = serve(True)
    _, cold, cold_sp = serve(False)
    assert warm_sp[0] == tdecode.spec_k_ladder(4) == [1, 2, 4]
    assert (warm, warm_sp) == (cold, cold_sp)
    assert n > 2 * len(warm_sp[0])


def test_load_for_decode_spec_artifacts(rig, tmp_path, monkeypatch):
    models, drafts = rig
    target = models["small-unrolled"]
    paddle.seed(11)
    draft = jgpt.GPT(jgpt.GPTConfig(vocab_size=256, max_seq_len=64,
                                    hidden=32, layers=1, heads=2,
                                    scan_layers=False))
    tp, dp = str(tmp_path / "target"), str(tmp_path / "draft")
    jdecode.save_for_decode(target, tp)
    jdecode.save_for_decode(draft, dp)
    kw = dict(device="cpu", max_slots=2, page_tokens=8)

    eng = tdecode.load_for_decode(tp, **kw)
    eng.stop()
    assert type(eng) is tdecode.DecodeEngine        # speculation is opt-in

    prompt = [3, 1, 4, 1, 5, 9]
    eng = tdecode.load_for_decode(tp, draft_prefix=dp, speculate_k=2,
                                  draft_quant=True, **kw)
    try:
        assert isinstance(eng, tdecode.SpecDecodeEngine)
        assert eng.k_ladder == [1, 2]
        assert eng._draft_params["blocks.0.fc1.weight"].dtype == torch.int8
        assert eng.params["blocks.0.fc1.weight"].dtype == torch.float32
        got = eng.submit(prompt, max_new_tokens=8).result(timeout=TIMEOUT)
    finally:
        eng.stop()
    jeng = jdecode.load_for_decode(tp, draft_prefix=dp, speculate_k=2,
                                   draft_quant=True, max_slots=2,
                                   page_tokens=8)
    try:
        assert got == jeng.submit(prompt, max_new_tokens=8).result(
            timeout=TIMEOUT)
    finally:
        jeng.stop()

    monkeypatch.setenv("PADDLE_TPU_DECODE_DRAFT_MODEL", dp)
    monkeypatch.setenv("PADDLE_TPU_DECODE_SPECULATE", "4")
    monkeypatch.setenv("PADDLE_TPU_DECODE_DRAFT_QUANT", "1")
    eng = tdecode.load_for_decode(tp, **kw)
    try:
        assert isinstance(eng, tdecode.SpecDecodeEngine)
        assert eng.k_ladder == [1, 2, 4]
        assert eng._draft_params["blocks.0.fc1.weight"].dtype == torch.int8
    finally:
        eng.stop()
    monkeypatch.delenv("PADDLE_TPU_DECODE_DRAFT_MODEL")

    # the draft / target contract is checked before threads start
    for bad_cfg, match in (
            (jgpt.GPTConfig(vocab_size=128, max_seq_len=64, hidden=32,
                            layers=1, heads=2, scan_layers=False), "vocab"),
            (jgpt.GPTConfig(vocab_size=256, max_seq_len=32, hidden=32,
                            layers=1, heads=2, scan_layers=False),
             "max_seq_len")):
        bp = str(tmp_path / f"bad_{match}")
        jdecode.save_for_decode(jgpt.GPT(bad_cfg), bp)
        with pytest.raises(ValueError, match=match):
            tdecode.load_for_decode(tp, draft_prefix=bp, speculate_k=2,
                                    **kw)
    with pytest.raises(ValueError, match="speculate_k"):
        tdecode.SpecDecodeEngine(cfg=_pcfg(target.cfg), params={},
                                 draft_cfg=_pcfg(draft.cfg),
                                 draft_params={}, speculate_k=0,
                                 device="cpu")


def test_prefix_cow_shared_allocator_stress():
    """JAX's stress on the port: the prefix trie and draft/target block
    tables hammer ONE PageAllocator from four threads (lookup / insert /
    evict racing alloc / retain / release_range rollbacks); refcounts
    must balance exactly, with no error and no leak."""
    alloc = tpa.PageAllocator(257)
    cache = tdecode._PrefixCache(alloc, 4)
    stop = threading.Event()
    errors = []

    def hammer_cache(seed):
        rng = np.random.default_rng(seed)
        for _ in range(300):
            if stop.is_set():
                break
            plen = int(rng.integers(1, 5)) * 4
            prompt = [int(t) for t in rng.integers(0, 16, plen)]
            pages, _hit = cache.lookup(prompt)      # retained for us
            need = plen // 4 - len(pages)
            try:
                fresh = alloc.alloc(need) if need else []
            except tpa.PageExhausted:
                for p in pages:
                    alloc.release(p)
                cache.evict(8)
                continue
            table = pages + fresh
            cache.insert(prompt, table)             # cache takes its refs
            alloc.release_range(table, 0)           # drop all of ours

    def hammer_tables(seed):
        rng = np.random.default_rng(seed)
        for _ in range(300):
            if stop.is_set():
                break
            n = int(rng.integers(2, 9))
            try:
                pages = alloc.alloc(n)
            except tpa.PageExhausted:
                continue
            for p in pages:                         # draft shares the ids
                alloc.retain(p)
            cut = int(rng.integers(0, n + 1))
            alloc.release_range(pages, cut)         # speculative rollback
            for p in pages[cut:]:
                alloc.release(p)
            for p in pages[:cut]:
                alloc.release(p)
                alloc.release(p)

    def run(fn, seed):
        def wrapped():
            try:
                fn(seed)
            except Exception as exc:  # noqa: BLE001 - surfaced below
                errors.append(exc)
                stop.set()
        t = threading.Thread(target=wrapped, daemon=True)
        t.start()
        return t

    threads = [run(hammer_cache, 1), run(hammer_cache, 2),
               run(hammer_tables, 3), run(hammer_tables, 4)]
    for t in threads:
        t.join(timeout=60.0)
    assert not errors, errors
    cache.clear()
    st = alloc.stats()
    assert st["pages_used"] == 0, f"leaked refs: {st}"
