"""paddle_tpu_torch int8 serving (int8 weights + int8 KV pages) against the
JAX package.

  * `params_from_numpy` keeps a quantized artifact's weights int8 in both
    JAX layouts and refuses every way of reading them as floats;
  * gpt_tiny with int8 weights: prefill logits and K/V panels, the fused
    prefill into int8 pages, and three batched paged steps match JAX.
    Logits use the fp32 tolerance of tests/test_torch_gpt_decode.py (atol
    2e-4, rtol 1e-4). The K/V rows each package computes differ in the
    last bits (fp32 sums in another order), so a row quantized by each may
    land one int8 code apart in an element now and then: written pages
    may differ by at most one code in at most MAX_CODE_DIFFS elements per
    pool, and every step starts both packages from the SAME int8 pools
    (JAX's), so the differences never compound;
  * the int8 engine's greedy streams are token-identical to the JAX int8
    engine's on the mild rig of tests/test_quant.py (block weights scaled
    by 0.1, so int8 error sits far below every argmax margin), through
    prefix hits and a copy-on-write;
  * a JAX ``save_for_decode(quant="int8")`` artifact loads in the port
    with int8 weights, and the port writes the same artifact;
  * ``serve --kv-dtype int8 --device cpu`` answers with the engine's
    tokens.
"""
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import framework  # noqa: E402
from paddle_tpu import quant as jquant  # noqa: E402
from paddle_tpu.inference import decode as jdecode  # noqa: E402
from paddle_tpu.inference import serve as jserve  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch import quant as tquant  # noqa: E402
from paddle_tpu_torch.inference import decode as tdecode  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 2e-4, 1e-4
PT = 4
MAX_CODE_DIFFS = 4     # per pool, of 6144 (tiny) or 1536 (small) codes
TIMEOUT = 180
MATMULS = ("attn.qkv.weight", "attn.proj.weight", "fc1.weight",
           "fc2.weight")

_CFGS = [
    ("tiny-scan", jgpt.gpt_tiny()),
    ("small-unrolled", jgpt.GPTConfig(vocab_size=256, max_seq_len=64,
                                      hidden=32, layers=3, heads=2,
                                      scan_layers=False)),
]


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    out = {}
    for name, cfg in _CFGS:
        arrays = {k: np.asarray(v) for k, v in
                  framework.param_arrays(jgpt.GPT(cfg)).items()}
        out[name] = (cfg, arrays, jquant.quantize_params(arrays))
    return out


def _pcfg(cfg):
    return tgpt.GPTConfig(**dataclasses.asdict(cfg))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _pools_agree(tpool, jpool):
    """Two int8 pools written from each package's own K/V rows: codes at
    most one apart in at most MAX_CODE_DIFFS elements, scales within fp32
    noise. Page 0 (the null page) holds don't-care padding rows and is
    left out."""
    tq, ts = (t.numpy()[:, 1:] for t in tpool)
    jq, js = (np.asarray(a)[:, 1:] for a in jpool)
    diff = np.abs(tq.astype(np.int32) - jq.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).sum() <= MAX_CODE_DIFFS, \
        (diff.max(), int((diff > 0).sum()))
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("name", [n for n, _ in _CFGS])
def test_params_from_numpy_keeps_int8_weights(models, name):
    cfg, arrays, q = models[name]
    pcfg = _pcfg(cfg)
    params = tgpt.params_from_numpy(pcfg, q, device="cpu")
    assert set(params) == set(tgpt.param_shapes(pcfg, "int8"))
    stacked = cfg.scan_layers is not False
    for i in range(cfg.layers):
        for rel in MATMULS:
            w = params[f"blocks.{i}.{rel}"]
            s = params[f"blocks.{i}.{rel}::scale"]
            assert w.dtype == torch.int8 and s.dtype == torch.float32
            src = q[f"blocks.{rel}"][i] if stacked \
                else q[f"blocks.{i}.{rel}"]
            np.testing.assert_array_equal(w.numpy(), src)
            assert s.shape == (w.shape[1],)
        assert params[f"blocks.{i}.ln1.weight"].dtype == torch.float32
    assert params["wte.weight"].dtype == torch.float32
    # the fp32 module refuses the int8 dict (unexpected ::scale keys)
    # rather than casting the codes to float
    with pytest.raises(RuntimeError):
        tgpt.GPTDecoder(pcfg, device="cpu").load_state_dict(params)
    w0 = "blocks.attn.qkv.weight" if stacked else "blocks.0.attn.qkv.weight"
    bad = dict(q, **{w0: q[w0].astype(np.float32)})     # codes as floats
    with pytest.raises(TypeError, match="int8"):
        tgpt.params_from_numpy(pcfg, bad, device="cpu")
    bad = {k: v for k, v in q.items() if k != w0 + "::scale"}
    with pytest.raises(KeyError, match="missing"):      # one scale lost
        tgpt.params_from_numpy(pcfg, bad, device="cpu")
    bad = {k: v for k, v in q.items() if not k.endswith("::scale")}
    with pytest.raises(TypeError, match="float"):       # every scale lost
        tgpt.params_from_numpy(pcfg, bad, device="cpu")
    bad = dict(q, **{"ln_f.weight::scale": np.ones(cfg.hidden, np.float32)})
    with pytest.raises(KeyError, match="no quantizable"):
        tgpt.params_from_numpy(pcfg, bad, device="cpu")


@pytest.mark.parametrize("name", [n for n, _ in _CFGS])
def test_int8_prefill_and_paged_steps_match_jax(models, name):
    cfg, _, q = models[name]
    pcfg = _pcfg(cfg)
    params = tgpt.params_from_numpy(pcfg, q, device="cpu")
    jparams = {k: jnp.asarray(v) for k, v in q.items()}
    L, nh, D = cfg.layers, cfg.heads, cfg.head_dim
    rng = np.random.default_rng(1)

    # prefill through the int8-weight matmuls: logits and K/V panels
    toks = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    lens = np.asarray([11, 6], np.int32)
    jprefill, jstep = jgpt.gpt_paged_decode_fns(cfg, page_tokens=PT)
    tprefill, tstep = tgpt.gpt_paged_decode_fns(pcfg, page_tokens=PT)
    jl, jk, jv = jprefill(jparams, jnp.asarray(toks), jnp.asarray(lens))
    tl, tk, tv = tprefill(params, torch.from_numpy(toks),
                          torch.from_numpy(lens))
    _close(tl.numpy(), jl)
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)

    # two sequences prefilled into int8 pages
    P, W = 12, 5
    shape = (L, P, PT, nh, D)
    tables = np.zeros((3, W), np.int32)
    tables[0, :4] = [3, 7, 1, 9]
    tables[1, :4] = [2, 5, 8, 11]
    jpaged = jgpt.gpt_paged_prefill_fns(cfg, page_tokens=PT)
    tpaged = tgpt.gpt_paged_prefill_fns(pcfg, page_tokens=PT)
    jk_pool = jquant.kv_pool_zeros(shape, "int8")
    jv_pool = jquant.kv_pool_zeros(shape, "int8")
    tk_pool = tquant.kv_pool_zeros(shape, "int8", "cpu")
    tv_pool = tquant.kv_pool_zeros(shape, "int8", "cpu")
    last = []
    for b, n in enumerate([7, 10]):
        row = np.zeros((1, 12), np.int32)
        row[0, :n] = rng.integers(0, cfg.vocab_size, n)
        tb = tables[b:b + 1, :3]
        jl, jk_pool, jv_pool = jpaged(jparams, jk_pool, jv_pool,
                                      jnp.asarray(row), jnp.asarray(tb),
                                      jnp.asarray([n], np.int32))
        tl, _, _ = tpaged(params, tk_pool, tv_pool, torch.from_numpy(row),
                          torch.from_numpy(tb), torch.tensor([n]))
        _close(tl.numpy(), jl)
        last.append(int(np.argmax(np.asarray(jl)[0])))
        # the pages hold the (dequantized) prefill panel
        got = tgpt._kv_pool_take(tk_pool, torch.from_numpy(tb))
        want = jgpt._kv_pool_take(jk_pool, jnp.asarray(tb), axis=1)
        _close(got.reshape(L, -1, nh, D)[:, :n].numpy(),
               np.asarray(want).reshape(L, -1, nh, D)[:, :n])
    _pools_agree(tk_pool, jk_pool)
    _pools_agree(tv_pool, jv_pool)

    # three batched steps (third row padded: all-null table), each from
    # the same int8 pools in both packages
    ltok = np.asarray(last + [0], np.int32)
    clen = np.asarray([7, 10, 0], np.int32)
    for _ in range(3):
        tk_pool = tuple(torch.from_numpy(np.array(a)) for a in jk_pool)
        tv_pool = tuple(torch.from_numpy(np.array(a)) for a in jv_pool)
        jl, jk_pool, jv_pool = jstep(jparams, jk_pool, jv_pool,
                                     jnp.asarray(tables), jnp.asarray(ltok),
                                     jnp.asarray(clen))
        tl, tk_pool, tv_pool = tstep(params, tk_pool, tv_pool,
                                     torch.from_numpy(tables),
                                     torch.from_numpy(ltok),
                                     torch.from_numpy(clen))
        _close(tl.numpy(), jl)
        _pools_agree(tk_pool, jk_pool)
        _pools_agree(tv_pool, jv_pool)
        ltok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        ltok[2] = 0
        clen = clen + np.asarray([1, 1, 0], np.int32)


@pytest.fixture(scope="module")
def mild():
    """tests/test_quant.py's mild rig: gpt_tiny with its block weights
    scaled by 0.1, quantized."""
    paddle.seed(21)
    model = jgpt.GPT(jgpt.gpt_tiny())
    params = {k: np.asarray(v) * (0.1 if k.startswith("blocks.") else 1.0)
              for k, v in framework.param_arrays(model).items()}
    return model.cfg, jquant.quantize_params(params)


def test_int8_engine_streams_match_the_jax_int8_engine(mild):
    cfg, q = mild
    pcfg = _pcfg(cfg)
    rng = np.random.default_rng(9)
    head = [int(t) for t in rng.integers(0, cfg.vocab_size, 2 * PT)]
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n))
               for n in rng.integers(3, 10, size=5)]
    prompts += [np.asarray(head + [5, 6, 7]), np.asarray(head + [9])]
    gens = [int(g) for g in rng.integers(4, 12, size=len(prompts))]
    kw = dict(max_slots=2, max_new_tokens=16, page_tokens=PT,
              kv_dtype="int8")
    jeng = jdecode.DecodeEngine(cfg=cfg, params=q, **kw)
    teng = tdecode.DecodeEngine(
        cfg=pcfg, params=tgpt.params_from_numpy(pcfg, q, device="cpu"),
        eps=1e-5, device="cpu", **kw)
    try:
        assert teng.params["blocks.0.fc1.weight"].dtype == torch.int8
        tst, jst = teng.stats(), jeng.stats()
        assert tst["kv_dtype"] == jst["kv_dtype"] == "int8"
        assert tst["kv_page_bytes"] == jst["kv_page_bytes"]
        for _wave in range(2):        # the head is cached by wave 2
            want = [jeng.submit(p, max_new_tokens=g)
                    for p, g in zip(prompts, gens)]
            got = [teng.submit(p, max_new_tokens=g)
                   for p, g in zip(prompts, gens)]
            for w, g in zip(want, got):
                assert g.result(timeout=TIMEOUT) == w.result(timeout=TIMEOUT)
        # the fully cached head alone: a prefix hit on a shared last page
        assert teng.submit(head, max_new_tokens=6).result(timeout=TIMEOUT) \
            == jeng.submit(head, max_new_tokens=6).result(timeout=TIMEOUT)
        st = teng.stats()
    finally:
        jeng.stop()
        teng.stop()
    assert st["prefix_cache"]["hits"] >= 2 and st["cow_copies"] >= 1, st
    assert isinstance(teng._kpool, tuple) \
        and teng._kpool[0].dtype == torch.int8


def _mild_scan_model():
    paddle.seed(29)
    model = jgpt.GPT(jgpt.GPTConfig(vocab_size=256, max_seq_len=64,
                                    hidden=32, layers=2, heads=2,
                                    scan_layers=True))
    for n, p in model.named_parameters():
        if n.startswith("blocks."):
            p._data = p._data * 0.1
    return model


def test_jax_int8_artifact_loads_in_the_port(tmp_path):
    model = _mild_scan_model()
    prefix = str(tmp_path / "int8")
    jdecode.save_for_decode(model, prefix, quant="int8")
    kw = dict(max_slots=2, page_tokens=PT, kv_dtype="int8")
    teng = tdecode.load_for_decode(prefix, device="cpu", **kw)
    jeng = jdecode.load_for_decode(prefix, **kw)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n) for n in (5, 11)]
    try:
        for i in range(model.cfg.layers):
            for rel in MATMULS:
                assert teng.params[f"blocks.{i}.{rel}"].dtype == torch.int8
                assert teng.params[f"blocks.{i}.{rel}::scale"].dtype \
                    == torch.float32
        for p in prompts:
            assert teng.submit(p, max_new_tokens=6).result(timeout=TIMEOUT) \
                == jeng.submit(p, max_new_tokens=6).result(timeout=TIMEOUT)
    finally:
        teng.stop()
        jeng.stop()

    # the port writes the same int8 artifact from the fp32 weights
    arrays = {k: np.asarray(v)
              for k, v in framework.param_arrays(model).items()}
    cfg = teng.cfg
    pfx2 = str(tmp_path / "port_int8")
    tdecode.save_for_decode(arrays, cfg, 1e-5, pfx2, quant="int8")
    with open(pfx2 + ".decode.json") as f:
        assert json.load(f)["quant"] == "int8"
    _, got, _ = jdecode._load_decode_artifact(pfx2)
    _, want, _ = jdecode._load_decode_artifact(prefix)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="quant="):
        tdecode.save_for_decode(arrays, cfg, 1e-5, pfx2, quant="int4")
    with pytest.raises(ValueError, match="scale"):
        tdecode.save_for_decode(want, cfg, 1e-5, pfx2)
    # a manifest that disagrees with its weights is refused
    fp = str(tmp_path / "fp32")
    tdecode.save_for_decode(arrays, cfg, 1e-5, fp)
    with open(fp + ".decode.json") as f:
        meta = json.load(f)
    assert "quant" not in meta
    meta["quant"] = "int8"
    with open(fp + ".decode.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="manifest"):
        tdecode.load_for_decode(fp, device="cpu")


def test_serve_kv_dtype_int8_answers_with_the_engines_tokens(tmp_path):
    prefix = str(tmp_path / "int8")
    jdecode.save_for_decode(_mild_scan_model(), prefix, quant="int8")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (4, 13)]
    eng = tdecode.load_for_decode(prefix, device="cpu", max_slots=2,
                                  kv_dtype="int8")
    try:
        want = [eng.submit(p, max_new_tokens=5).result(timeout=TIMEOUT)
                for p in prompts]
    finally:
        eng.stop()
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("PADDLE_TPU_DECODE_KV_DTYPE", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.serve", prefix,
         "--decode", "--decode-slots", "2", "--decode-max-new", "5",
         "--kv-dtype", "int8", "--port", "0", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line.strip())
            if line.startswith("SERVING "):
                break
        assert lines and lines[-1].startswith("SERVING "), lines
        port = int(lines[-1].split()[1])
        for p, w in zip(prompts, want):       # one at a time, as in-process
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=120) as s:
                assert jserve.decode_request(
                    s, p, opts={"max_new_tokens": 5,
                                "temperature": 0.0}) == w
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
        assert "DRAINED ok=True" in rest and proc.returncode == 0, rest
        stats = [ln for ln in rest.splitlines()
                 if ln.startswith("DECODE STATS ")]
        assert len(stats) == 1, rest
        kv = dict(f.split("=", 1) for f in stats[0].split()[2:])
        assert kv["device"] == "cpu" and kv["kv_dtype"] == "int8", kv
        assert int(kv["tokens"]) == 10, kv
        # on the CPU the plain versions serve: no kernel launched
        for key in ("paged_decode_attention_launches",
                    "paged_decode_attention_int8_launches",
                    "int8_weight_matmul_launches"):
            assert int(kv[key]) == 0, kv
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_int8_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from paddle_tpu_torch.inference import serve as tserve
    cfg = tgpt.gpt_tiny()
    arrays = tgpt.init_params_numpy(cfg, seed=0)
    prefix = str(tmp_path / "int8")
    tdecode.save_for_decode(arrays, cfg, 1e-5, prefix, quant="int8")
    q = tquant.quantize_params(arrays)
    calls = [
        lambda: tgpt.params_from_numpy(cfg, q),
        lambda: tdecode.DecodeEngine(
            cfg=cfg, params=tgpt.params_from_numpy(cfg, q, "cpu"),
            kv_dtype="int8"),
        lambda: tdecode.load_for_decode(prefix, kv_dtype="int8"),
        lambda: tserve.InferenceServer(prefix, port=0, kv_dtype="int8"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    eng = tdecode.load_for_decode(prefix, device="cpu", kv_dtype="int8",
                                  max_slots=1)
    try:
        assert eng.stats()["kv_dtype"] == "int8"
        assert len(eng.submit(np.arange(4), max_new_tokens=2)
                   .result(timeout=TIMEOUT)) == 2
    finally:
        eng.stop()
