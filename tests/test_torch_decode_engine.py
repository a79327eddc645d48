"""paddle_tpu_torch DecodeEngine against the JAX package's DecodeEngine.

The same weights (a JAX gpt_tiny, carried across as numpy) and prompts go
through the port's engine on the CPU and the JAX engine with its Pallas
paged-attention kernel (interpret mode). The prompts share a page-aligned
head, so the port's prefix cache hits and a fully cached prompt forces a
copy-on-write.

  * greedy streams are checked teacher-forced: every port token is the
    argmax of the JAX full forward over the port's own sequence, or
    within 1e-4 of its max (robust to near-ties; the two frameworks' fp32
    sums differ in the last bits);
  * seeded temperature sampling (per-(seed, position) numpy generator on
    both sides) gives identical tokens;
  * a JAX `save_for_decode` artifact loads through the port's
    `load_for_decode`;
  * pool exhaustion is a typed RESOURCE_EXHAUSTED on the victim only.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import framework  # noqa: E402
from paddle_tpu.inference import decode as jdecode  # noqa: E402
from paddle_tpu.models.gpt import GPT, gpt_tiny  # noqa: E402
from paddle_tpu_torch.inference import decode as tdecode  # noqa: E402
from paddle_tpu_torch.inference.errors import (  # noqa: E402
    ERR_INVALID_ARGUMENT, ERR_RESOURCE_EXHAUSTED, TypedServeError)
from paddle_tpu_torch.models.gpt import (  # noqa: E402
    GPTConfig, GPTDecoder, params_from_numpy)

PT = 4
LOGIT_TOL = 1e-4
TIMEOUT = 180


@pytest.fixture(scope="module")
def tiny():
    paddle.seed(7)
    model = GPT(gpt_tiny())
    arrays = {k: np.asarray(v)
              for k, v in framework.param_arrays(model).items()}
    return model, arrays


def _port_engine(model, arrays, **kw):
    cfg = GPTConfig(**dataclasses.asdict(model.cfg))
    kw.setdefault("max_slots", 3)
    kw.setdefault("page_tokens", PT)
    return tdecode.DecodeEngine(
        cfg=cfg, params=params_from_numpy(cfg, arrays, device="cpu"),
        eps=1e-5, device="cpu", **kw)


def _prompts():
    rng = np.random.default_rng(5)
    head = [int(t) for t in rng.integers(0, 512, 2 * PT)]    # 2 pages
    first = [head + [11, 12, 13], head + [21, 22],
             [int(t) for t in rng.integers(0, 512, 5)]]
    return first, head


def _teacher_forced_gap(model, prompt, out):
    seq = np.asarray([list(prompt) + list(out)], np.int64)
    logits = model(paddle.to_tensor(seq)).numpy()[0]
    rows = logits[len(prompt) - 1:len(prompt) - 1 + len(out)]
    return float((rows.max(-1) - rows[np.arange(len(out)), out]).max())


def _serve(eng, first, head, n, **kw):
    """Serve the first wave together, then the page-aligned head alone
    (fully cached by then: a prefix hit whose last mapped page is shared,
    hence a copy-on-write)."""
    streams = [eng.submit(p, max_new_tokens=n, **kw) for p in first]
    outs = [s.result(timeout=TIMEOUT) for s in streams]
    outs.append(eng.submit(head, max_new_tokens=n, **kw)
                .result(timeout=TIMEOUT))
    return outs


def test_engine_greedy_and_seeded_sampling_match_jax(tiny, monkeypatch):
    model, arrays = tiny
    first, head = _prompts()
    prompts = first + [head]
    eng = _port_engine(model, arrays)
    try:
        greedy = _serve(eng, first, head, 6)
        sampled = [eng.submit(p, max_new_tokens=6, temperature=0.8,
                              top_k=20, seed=100 + i).result(timeout=TIMEOUT)
                   for i, p in enumerate(prompts)]
        st = eng.stats()
    finally:
        eng.stop()
    for p, out in zip(prompts, greedy):
        assert len(out) == 6
        assert _teacher_forced_gap(model, p, out) <= LOGIT_TOL
    assert st["prefix_cache"]["hits"] >= 2, st
    assert st["cow_copies"] >= 1, st
    assert st["steps"] > 0 and st["pages"]["pages_used"] \
        == st["prefix_cache"]["cached_pages"]      # streams freed theirs

    monkeypatch.setenv("PADDLE_TPU_DECODE_KERNEL", "pallas")
    jeng = jdecode.DecodeEngine(cfg=model.cfg, params=arrays, eps=1e-5,
                                max_slots=3, page_tokens=PT)
    try:
        jsampled = [jeng.submit(p, max_new_tokens=6, temperature=0.8,
                                top_k=20, seed=100 + i)
                    .result(timeout=TIMEOUT)
                    for i, p in enumerate(prompts)]
    finally:
        jeng.stop()
    assert sampled == jsampled


def test_jax_artifact_loads_in_the_port(tiny, tmp_path):
    model, arrays = tiny
    prefix = str(tmp_path / "gpt")
    jdecode.save_for_decode(model, prefix)
    prompt = _prompts()[0][2]
    eng = tdecode.load_for_decode(prefix, device="cpu", max_slots=2,
                                  page_tokens=PT)
    try:
        assert eng.cfg.vocab_size == 512 and eng.eps == 1e-5
        got = eng.submit(prompt, max_new_tokens=5).result(timeout=TIMEOUT)
    finally:
        eng.stop()
    assert _teacher_forced_gap(model, prompt, got) <= LOGIT_TOL
    ref = _port_engine(model, arrays)
    try:
        assert ref.submit(prompt, max_new_tokens=5).result(
            timeout=TIMEOUT) == got
    finally:
        ref.stop()
    # the port writes the same artifact format back
    pfx2 = str(tmp_path / "gpt2")
    tdecode.save_for_decode(arrays, eng.cfg, 1e-5, pfx2)
    cfg2, arrays2, eps2 = jdecode._load_decode_artifact(pfx2)
    assert cfg2 == model.cfg and eps2 == 1e-5 and set(arrays2) == set(arrays)


def test_pool_exhaustion_fails_only_the_victim(tiny):
    """4 allocatable pages at pt=4 and two 8-token prompts admitted in
    the same round: each holds 2 pages, so the first one to cross a page
    boundary (the first admitted) finds the pool empty and gets a typed
    RESOURCE_EXHAUSTED; its pages go back and the other stream
    finishes."""
    model, arrays = tiny
    rng = np.random.default_rng(13)
    p1 = [int(t) for t in rng.integers(0, 512, 8)]
    p2 = [int(t) for t in rng.integers(0, 512, 8)]
    cfg = GPTConfig(**dataclasses.asdict(model.cfg))
    dec = GPTDecoder(cfg, device="cpu")             # the model= entry
    dec.load_state_dict(params_from_numpy(cfg, arrays, device="cpu"))
    eng = tdecode.DecodeEngine(dec, max_slots=2, page_tokens=PT,
                               num_pages=5, prefix_cache=False,
                               device="cpu")
    try:
        with eng._cond:            # hold the scheduler: one admission round
            s1 = eng.submit(p1, max_new_tokens=6)
            s2 = eng.submit(p2, max_new_tokens=6)
        with pytest.raises(TypedServeError) as ei:
            s1.result(timeout=TIMEOUT)
        assert ei.value.code == ERR_RESOURCE_EXHAUSTED
        assert "requested 1 pages" in str(ei.value), str(ei.value)
        out2 = s2.result(timeout=TIMEOUT)
        assert _teacher_forced_gap(model, p2, out2) <= LOGIT_TOL
        # pool drained -> the victim's prompt now succeeds
        assert len(eng.submit(p1, max_new_tokens=6).result(
            timeout=TIMEOUT)) == 6
        assert eng.stats()["pages"]["pages_used"] == 0
    finally:
        eng.stop()
    with pytest.raises(TypedServeError):
        eng.submit(p1)                     # stopped engine refuses


def test_submit_validates_prompts(tiny):
    model, arrays = tiny
    eng = _port_engine(model, arrays)
    try:
        for bad in ([], [512], [1] * model.cfg.max_seq_len):
            with pytest.raises(TypedServeError) as ei:
                eng.submit(bad)
            assert ei.value.code == ERR_INVALID_ARGUMENT
    finally:
        eng.stop()


def test_ladders_and_sizes_match_jax(tiny):
    model, _ = tiny
    cfg = GPTConfig(**dataclasses.asdict(model.cfg))
    for n, floor in ((128, None), (128, 4), (128, 32), (8, 16)):
        assert tdecode.kv_capacity_ladder(n, floor) \
            == jdecode.kv_capacity_ladder(n, floor)
    assert tdecode.kv_page_bytes(cfg, 16) \
        == jdecode.kv_page_bytes(model.cfg, 16)
    assert tdecode.kv_slot_bytes(cfg) == jdecode.kv_slot_bytes(model.cfg)
    assert tdecode.default_slot_count(cfg, device="cpu") \
        == tdecode.DEFAULT_MAX_SLOTS
    from paddle_tpu.inference import batching as jb
    from paddle_tpu_torch.inference import batching as tb
    for m, env in ((8, ""), (5, ""), (8, "1 3,6")):
        assert tb.bucket_ladder(m, env) == jb.bucket_ladder(m, env)
    for n in (1, 3, 9, 40):
        assert tb.next_bucket(n, [1, 2, 4, 8]) \
            == jb.next_bucket(n, [1, 2, 4, 8])
