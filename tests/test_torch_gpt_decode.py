"""paddle_tpu_torch GPT decode forward against the JAX package.

Both configurations of tests/test_decode_paged.py: a scan-stacked
gpt_tiny (params ``blocks.<name>`` with a leading [layers] axis) and an
unrolled ``scan_layers=False`` config (``blocks.<i>.<name>``), so
`params_from_numpy` is exercised on both JAX layouts. The same numpy
weights and tokens go through JAX `gpt_paged_decode_fns` /
`gpt_paged_prefill_fns` and the port's.

Tolerance: atol 2e-4, rtol 1e-4. The two frameworks sum fp32 matmuls in
different orders, and this XLA build evaluates exp, tanh and erf with
TPU-profile approximations on the CPU (about 3e-5 each); both compound
through the layers into logits of magnitude ~1-10.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import framework  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402

ATOL, RTOL = 2e-4, 1e-4
PT = 4

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
        model = jgpt.GPT(cfg)
        arrays = {k: np.asarray(v)
                  for k, v in framework.param_arrays(model).items()}
        out[name] = (model, cfg, arrays)
    return out


def _port(cfg, arrays):
    pcfg = tgpt.GPTConfig(**dataclasses.asdict(cfg))
    return pcfg, tgpt.params_from_numpy(pcfg, arrays, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", [n for n, _ in _CFGS])
def test_params_from_numpy_accepts_the_layout(models, name):
    model, cfg, arrays = models[name]
    pcfg, params = _port(cfg, arrays)
    dec = tgpt.GPTDecoder(pcfg, device="cpu")
    dec.load_state_dict(params)
    assert list(dec.state_dict()) == list(tgpt.param_shapes(pcfg))
    if cfg.scan_layers is False:             # indexed layout: same keys
        assert set(dec.state_dict()) == set(arrays)
    else:                                    # stacked: layer i = slice i
        np.testing.assert_array_equal(
            dec.state_dict()["blocks.1.attn.qkv.weight"].numpy(),
            arrays["blocks.attn.qkv.weight"][1])
    # the full forward (the teacher-forcing oracle) matches JAX's
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9))
    want = model(paddle.to_tensor(toks.astype(np.int64))).numpy()
    _close(dec(torch.from_numpy(toks)).numpy(), want)
    bad = dict(arrays)
    bad.pop("ln_f.bias")
    with pytest.raises(KeyError):
        tgpt.params_from_numpy(pcfg, bad, device="cpu")
    bad = dict(arrays, **{"ln_f.bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError):
        tgpt.params_from_numpy(pcfg, bad, device="cpu")


@pytest.mark.parametrize("name", [n for n, _ in _CFGS])
def test_prefill_and_paged_steps_match_jax(models, name):
    _, cfg, arrays = models[name]
    pcfg, params = _port(cfg, arrays)
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    L, nh, D = cfg.layers, cfg.heads, cfg.head_dim
    rng = np.random.default_rng(1)

    # prefill: logits at lens-1 and the K/V panels
    toks = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    lens = np.asarray([11, 6], np.int32)
    jprefill, jstep = jgpt.gpt_paged_decode_fns(cfg, page_tokens=PT)
    tprefill, tstep = tgpt.gpt_paged_decode_fns(pcfg, page_tokens=PT)
    jl, jk, jv = jprefill(jparams, jnp.asarray(toks), jnp.asarray(lens))
    tl, tk, tv = tprefill(params, torch.from_numpy(toks),
                          torch.from_numpy(lens))
    assert tk.shape == (L, 2, 11, nh, D)
    _close(tl.numpy(), jl)
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)

    # two sequences prefilled into pages, then three batched steps with a
    # padded third row (all-null table, like the engine's batch padding)
    P, W = 12, 5
    plens = [7, 10]
    tables = np.zeros((3, W), np.int32)
    tables[0, :4] = [3, 7, 1, 9]
    tables[1, :4] = [2, 5, 8, 11]
    jpaged = jgpt.gpt_paged_prefill_fns(cfg, page_tokens=PT)
    tpaged = tgpt.gpt_paged_prefill_fns(pcfg, page_tokens=PT)
    jk_pool = jnp.zeros((L, P, PT, nh, D), jnp.float32)
    jv_pool = jnp.zeros_like(jk_pool)
    tk_pool = torch.zeros((L, P, PT, nh, D))
    tv_pool = torch.zeros_like(tk_pool)
    last = []
    for b, n in enumerate(plens):
        row = np.zeros((1, 12), np.int32)       # padded past n
        row[0, :n] = rng.integers(0, cfg.vocab_size, n)
        tb = tables[b:b + 1, :-(-12 // PT)]
        jl, jk_pool, jv_pool = jpaged(jparams, jk_pool, jv_pool,
                                      jnp.asarray(row), jnp.asarray(tb),
                                      jnp.asarray([n], np.int32))
        tl, _, _ = tpaged(params, tk_pool, tv_pool, torch.from_numpy(row),
                          torch.from_numpy(tb), torch.tensor([n]))
        _close(tl.numpy(), jl)
        last.append(int(np.argmax(np.asarray(jl)[0])))
        # the pages hold the prefill panel; padding rows went to page 0
        got = tgpt._kv_pool_take(tk_pool, torch.from_numpy(tb))
        _close(got.reshape(L, -1, nh, D)[:, :n].numpy(),
               np.asarray(jk_pool)[:, tb[0]].reshape(L, -1, nh, D)[:, :n])
    _close(tk_pool.numpy(), jk_pool)
    _close(tv_pool.numpy(), jv_pool)

    ltok = np.asarray(last + [0], np.int32)
    clen = np.asarray(plens + [0], np.int32)
    for _ in range(3):
        jl, jk_pool, jv_pool = jstep(jparams, jk_pool, jv_pool,
                                     jnp.asarray(tables), jnp.asarray(ltok),
                                     jnp.asarray(clen))
        tl, tk_pool, tv_pool = tstep(params, tk_pool, tv_pool,
                                     torch.from_numpy(tables),
                                     torch.from_numpy(ltok),
                                     torch.from_numpy(clen))
        _close(tl.numpy(), jl)
        _close(tk_pool.numpy(), jk_pool)
        _close(tv_pool.numpy(), jv_pool)
        ltok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        ltok[2] = 0
        clen = clen + np.asarray([1, 1, 0], np.int32)


def test_pool_ops_write_copy_gather():
    from paddle_tpu_torch.memory.page_allocator import (copy_page,
                                                        gather_pages,
                                                        write_pages)
    pool = torch.zeros(2, 4, 3, 2)                      # [L, P, pt, D]
    rows = torch.arange(2 * 2 * 3 * 2, dtype=torch.float32).reshape(2, 2, 3, 2)
    out = write_pages(pool, rows, torch.tensor([2, 1]))
    assert out is pool                                   # in place
    torch.testing.assert_close(pool[:, 2], rows[:, 0])
    torch.testing.assert_close(pool[:, 1], rows[:, 1])
    assert float(pool[:, 3].abs().sum()) == 0.0
    copy_page(pool, 2, 3)
    torch.testing.assert_close(pool[:, 3], pool[:, 2])
    got = gather_pages(pool, torch.tensor([3, 1]))
    torch.testing.assert_close(got, torch.stack([pool[:, 3], pool[:, 1]], 1))
    got.zero_()                                          # independent copy
    assert float(pool[:, 3].abs().sum()) > 0.0
    # a [B, W] block table gathers to [L, B, W, pt, D]
    table = torch.tensor([[3, 1], [0, 2]])
    got = gather_pages(pool, table)
    assert got.shape == (2, 2, 2, 3, 2)
    torch.testing.assert_close(got[:, 1, 1], pool[:, 2])
    # single rows of one layer: pool[1, pages, offsets] = rows
    row = torch.full((2, 2), 7.0)
    write_pages(pool, row, torch.tensor([1, 3]), offset=torch.tensor([0, 2]),
                layer=1)
    assert (pool[1, 1, 0] == 7).all() and (pool[1, 3, 2] == 7).all()
    assert not (pool[0, 1, 0] == 7).all()


def test_init_params_numpy_and_moe_rejection():
    cfg = tgpt.gpt_tiny()
    a = tgpt.init_params_numpy(cfg, seed=3)
    b = tgpt.init_params_numpy(cfg, seed=3)
    assert set(a) == set(tgpt.param_shapes(cfg))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == np.float32
    assert abs(float(a["wte.weight"].std()) - 0.02) < 2e-3
    assert (a["ln_f.weight"] == 1).all() and (a["blocks.0.fc1.bias"] == 0).all()
    assert tgpt.gpt2_124m().head_dim == 64 and tgpt.gpt2_345m().layers == 24
    assert tgpt.gpt3_1p3b().max_seq_len == 2048
    moe = tgpt.GPTConfig(moe_experts=4)
    with pytest.raises(NotImplementedError):
        tgpt.gpt_paged_decode_fns(moe)
    with pytest.raises(NotImplementedError):
        tgpt.GPTDecoder(moe, device="cpu")
