"""paddle_tpu_torch's transformer layers against the JAX package on the CPU
at narrow widths, from the same numpy weights: `MultiHeadAttention`
without a mask and with a bool or a float mask (on the composition, and
without a mask also on the flash route with `pallas_attention_min_seq`
lowered in both packages), with `Cache` and `StaticCache`; encoder stacks
pre-LN and post-LN with relu and gelu, their inputs' and every
parameter's gradient; `TransformerDecoder` and `Transformer` with
`generate_square_subsequent_mask`, and incremental decoding from
`gen_cache` against the full forward; every activation the layers can
name, with its AMP cast; `Dropout`'s modes against the JAX `F.dropout`;
and `ops.basic.concat` / `zeros` under AMP."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

import paddle_tpu as paddle                                   # noqa: E402
import paddle_tpu.amp as jamp                                 # noqa: E402
import paddle_tpu.nn as jnn                                   # noqa: E402
import paddle_tpu.nn.functional as JF                         # noqa: E402
from paddle_tpu.framework import functional_call, param_arrays  # noqa: E402
from paddle_tpu.ops import manipulation as JM                 # noqa: E402

import paddle_tpu_torch as ptt                                # noqa: E402
import paddle_tpu_torch.amp as tamp                           # noqa: E402
import paddle_tpu_torch.nn as tnn                             # noqa: E402
import paddle_tpu_torch.nn.functional as TF                   # noqa: E402
from paddle_tpu_torch.core import device as tdevice           # noqa: E402
from paddle_tpu_torch.ops import basic as tops                # noqa: E402

# fp32 through two frameworks: summation order only, ~1e-7 relative per op
OUT_TOL = 1e-5
GRAD_REL = 1e-4          # each gradient, as a fraction of its largest
E, H, FF = 32, 4, 64     # width, heads (of 8), feed-forward width


@pytest.fixture(autouse=True)
def _cpu_and_flags(monkeypatch):
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])
    old_j = paddle.get_flags("pallas_attention_min_seq")
    old_t = ptt.get_flags("pallas_attention_min_seq")
    yield
    paddle.set_flags({"pallas_attention_min_seq": old_j})
    ptt.set_flags({"pallas_attention_min_seq": old_t})


def _min_seq(n):
    paddle.set_flags({"pallas_attention_min_seq": n})
    ptt.set_flags({"pallas_attention_min_seq": n})


def _pair(name, *args, seed=0, **kw):
    """(JAX layer, port layer) of class `name` built with the same
    arguments, the port's loaded from the JAX layer's state_dict."""
    paddle.seed(seed)
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(tnn, name)(*args, **kw)
    missing, unexpected = tl.set_state_dict(
        {k: np.asarray(v._data) for k, v in jl.state_dict().items()})
    assert not missing and not unexpected, (missing, unexpected)
    jl.eval()
    tl.eval()
    return jl, tl


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _j(out):
    return np.asarray(getattr(out, "_data", out))


def _t(out):
    return out.detach().numpy()


def _close(t_out, j_out, tol=OUT_TOL):
    np.testing.assert_allclose(_t(t_out), _j(j_out), atol=tol, rtol=tol)


def _jax_value_and_grads(jl, args, g):
    """sum(out * g) of the JAX layer and its gradient in every parameter
    and in the first argument."""
    params = param_arrays(jl)

    rest = [None if a is None else jnp.asarray(a) for a in args[1:]]

    def f(p, x0):
        out, _ = functional_call(jl, p, {}, x0, *rest)
        return jnp.sum(out * g)

    return jax.grad(f, argnums=(0, 1))(params, jnp.asarray(args[0]))


def _check_grads(jl, tl, args, targs, seed=7):
    """Every parameter's gradient and the first input's of sum(out * g)
    within GRAD_REL of its largest (a gradient that is zero in exact
    arithmetic, k_proj.bias's, within GRAD_REL of the largest of all)."""
    out = tl(*targs)
    g = _x(*out.shape, seed=seed)
    (out * torch.tensor(g)).sum().backward()
    jgrads, jdx = _jax_value_and_grads(jl, args, jnp.asarray(g))
    top = max(float(np.abs(np.asarray(v)).max()) for v in jgrads.values())
    stacked = {k for k in jgrads if k.startswith("layers.")
               and not k.split(".")[1].isdigit()}
    pairs = [(targs[0].grad, jdx, "input")]
    for name, p in tl.named_parameters():
        if name in jgrads:
            want = jgrads[name]
        else:                      # JAX scan layout: layers.<rel>[i]
            _, i, rel = name.split(".", 2)
            assert f"layers.{rel}" in stacked
            want = jgrads[f"layers.{rel}"][int(i)]
        pairs.append((p.grad, want, name))
    for got, want, name in pairs:
        want = np.asarray(want)
        scale = top if name.endswith("k_proj.bias") \
            else max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= GRAD_REL * scale, (name, err, scale)


def _leaf(a):
    return torch.tensor(a, requires_grad=True)


# ------------------------------------------------------ MultiHeadAttention

def _masks(kind, B, S, T, seed=3):
    if kind is None:
        return None, None
    rng = np.random.default_rng(seed)
    if kind == "bool":
        m = rng.random((B, 1, S, T)) > 0.3
        m[..., 0] = True                       # every row keeps a key
    else:
        m = np.where(rng.random((B, 1, S, T)) > 0.3, 0.0, -1e9) \
            .astype(np.float32) + rng.standard_normal((B, 1, S, T)) \
            .astype(np.float32)
    return paddle.to_tensor(m), torch.tensor(m)


@pytest.mark.parametrize("mask,flash", [(None, False), (None, True),
                                        ("bool", False), ("float", False)])
def test_multi_head_attention_matches_jax(mask, flash):
    """Self-attention of [B, S, E] on the composition (and without a mask
    on the flash route); any mask takes the composition in both."""
    B, S = 2, 64
    if flash:
        _min_seq(S)
    jl, tl = _pair("MultiHeadAttention", E, H)
    x = _x(B, S, E)
    jm, tm = _masks(mask, B, S, S)
    _close(tl(torch.tensor(x), attn_mask=tm),
           jl(paddle.to_tensor(x), attn_mask=jm))


def test_multi_head_attention_cross_kdim_vdim_and_weights():
    """Cross-attention with kdim / vdim and keys of another length; with
    need_weights a None stands for the weights, as in the JAX package."""
    jl, tl = _pair("MultiHeadAttention", E, H, kdim=24, vdim=16,
                   need_weights=True)
    q, k, v = _x(2, 5, E), _x(2, 9, 24, seed=2), _x(2, 9, 16, seed=4)
    jo, jw = jl(paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v))
    to, tw = tl(torch.tensor(q), torch.tensor(k), torch.tensor(v))
    assert jw is None and tw is None
    _close(to, jo)


def test_cross_attention_of_another_length_takes_the_composition():
    """With the flash threshold reached by the queries but keys of
    another length the port takes the composition (the kernels take one
    length); the JAX package's composition gives the same result."""
    jl, tl = _pair("MultiHeadAttention", E, H)
    q, mem = _x(2, 16, E), _x(2, 11, E, seed=2)
    want = jl(paddle.to_tensor(q), paddle.to_tensor(mem))
    _min_seq(16)
    _close(tl(torch.tensor(q), torch.tensor(mem)), want)


def test_multi_head_attention_caches_match_jax():
    """An empty Cache grown one token at a time (outputs and cached k, v
    each step), and a StaticCache of a memory, against the JAX layer."""
    jl, tl = _pair("MultiHeadAttention", E, H)
    B, S = 2, 6
    x = _x(B, S, E)
    jc, tc = jl.gen_cache(paddle.to_tensor(x)), tl.gen_cache(torch.tensor(x))
    assert tuple(tc.k.shape) == (B, 0, H, E // H) == tuple(jc.k.shape)
    for i in range(S):
        jo, jc = jl(paddle.to_tensor(x[:, i:i + 1]), cache=jc)
        to, tc = tl(torch.tensor(x[:, i:i + 1]), cache=tc)
        assert isinstance(tc, tnn.MultiHeadAttention.Cache)
        _close(to, jo)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
    assert tuple(tc.k.shape) == (B, S, H, E // H)
    mem = _x(B, 9, E, seed=5)
    js = jl.gen_cache(paddle.to_tensor(mem), type=jnn.MultiHeadAttention
                      .StaticCache)
    ts = tl.gen_cache(torch.tensor(mem),
                      type=tnn.MultiHeadAttention.StaticCache)
    jo, js2 = jl(paddle.to_tensor(x), cache=js)
    to, ts2 = tl(torch.tensor(x), cache=ts)
    assert ts2 is ts
    _close(to, jo)
    _close(ts.k, js.k)


# --------------------------------------------------------------- encoders

@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_encoder_matches_jax(normalize_before, activation):
    """Two encoder layers (the second a fresh copy of the first's
    configuration) and a final LayerNorm: output, the input's gradient and
    every parameter's."""
    B, S = 2, 16
    paddle.seed(0)
    jlayer = jnn.TransformerEncoderLayer(E, H, FF, dropout=0.0,
                                         activation=activation,
                                         normalize_before=normalize_before)
    jl = jnn.TransformerEncoder(jlayer, 2, norm=jnn.LayerNorm(E))
    tlayer = tnn.TransformerEncoderLayer(E, H, FF, dropout=0.0,
                                         activation=activation,
                                         normalize_before=normalize_before)
    tl = tnn.TransformerEncoder(tlayer, 2, norm=tnn.LayerNorm(E))
    assert tl.layers[1].activation is getattr(TF, activation)
    assert tl.set_state_dict({k: np.asarray(v._data)
                              for k, v in jl.state_dict().items()}) \
        == ([], [])
    x = _x(B, S, E)
    _close(tl(torch.tensor(x)), jl(paddle.to_tensor(x)))
    _check_grads(jl, tl, [x], [_leaf(x)])


@pytest.mark.parametrize("flash", [False, True])
def test_scanned_encoder_matches_jax_on_both_routes(flash):
    """The JAX encoder scanned (ScanBlockStack, stacked parameters) and
    the port's loop from its expanded state_dict, on the composition and
    the flash route; a src_mask takes the composition in both."""
    B, S = 2, 64
    if flash:
        _min_seq(S)
    paddle.seed(1)
    jl = jnn.TransformerEncoder(
        jnn.TransformerEncoderLayer(E, H, FF, dropout=0.0,
                                    activation="gelu",
                                    normalize_before=True), 3,
        scan_layers=True)
    tl = tnn.TransformerEncoder(
        tnn.TransformerEncoderLayer(E, H, FF, dropout=0.0,
                                    activation="gelu",
                                    normalize_before=True), 3,
        scan_layers=True)
    assert tl.set_state_dict({k: np.asarray(v._data)
                              for k, v in jl.state_dict().items()}) \
        == ([], [])
    x = _x(B, S, E)
    _close(tl(torch.tensor(x)), jl(paddle.to_tensor(x)))
    _check_grads(jl, tl, [x], [_leaf(x)])
    jm, tm = _masks("bool", B, S, S)
    _close(tl(torch.tensor(x), tm), jl(paddle.to_tensor(x), jm))
    for f in (lambda m: m.gen_cache(x), lambda m: m(x, None, [None] * 3)):
        with pytest.raises(NotImplementedError, match="scan_layers=False"):
            f(jl)
        with pytest.raises(NotImplementedError, match="scan_layers=False"):
            f(tl)


def test_encoder_incremental_cache_matches_jax():
    """An unscanned encoder run token by token through its gen_cache."""
    B, S = 2, 5
    paddle.seed(2)
    jl = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(
        E, H, FF, dropout=0.0), 2)
    tl = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        E, H, FF, dropout=0.0), 2)
    tl.set_state_dict({k: np.asarray(v._data)
                       for k, v in jl.state_dict().items()})
    x = _x(B, S, E)
    jc, tc = jl.gen_cache(paddle.to_tensor(x)), tl.gen_cache(torch.tensor(x))
    for i in range(S):
        jo, jc = jl(paddle.to_tensor(x[:, i:i + 1]), None, jc)
        to, tc = tl(torch.tensor(x[:, i:i + 1]), None, tc)
        _close(to, jo)
    for (tk, tv), (jk, jv) in zip(tc, jc):
        _close(tk, jk)
        _close(tv, jv)


def test_clone_drops_weight_and_bias_attr_as_jax_does():
    """A stack built from a layer with bias_attr=False has biases in every
    layer but the first, in both packages (their _clone_layer passes
    neither attr on)."""
    paddle.seed(3)
    jl = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(
        E, H, FF, dropout=0.0, bias_attr=False), 2)
    tl = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        E, H, FF, dropout=0.0, bias_attr=False), 2)
    names = sorted(n for n, _ in tl.named_parameters())
    assert names == sorted(jl.state_dict())
    assert "layers.0.linear1.bias" not in names
    assert "layers.1.linear1.bias" in names


# --------------------------------------------------------------- decoders

@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_matches_jax(normalize_before):
    """Transformer(src, tgt) with the causal tgt_mask of
    generate_square_subsequent_mask and a bool memory_mask: the mask, the
    output and every gradient."""
    B, S, T = 2, 7, 5
    jl, tl = _pair("Transformer", d_model=E, nhead=H, num_encoder_layers=2,
                   num_decoder_layers=2, dim_feedforward=FF, dropout=0.0,
                   normalize_before=normalize_before)
    jmask = jl.generate_square_subsequent_mask(T)
    tmask = tl.generate_square_subsequent_mask(T)
    assert tmask.dtype == torch.float32
    np.testing.assert_array_equal(tmask.numpy(), _j(jmask))
    src, tgt = _x(B, S, E), _x(B, T, E, seed=2)
    jmem, tmem = _masks("bool", B, T, S)
    want = jl(paddle.to_tensor(src), paddle.to_tensor(tgt), None, jmask,
              jmem)
    _close(tl(torch.tensor(src), torch.tensor(tgt), None, tmask, tmem),
           want)
    _check_grads(jl, tl, [src, tgt, None, _j(jmask), _j(jmem)],
                 [_leaf(src), torch.tensor(tgt), None, tmask, tmem])


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_incremental_decode_equals_full_forward(normalize_before):
    """TransformerDecoder from gen_cache, one target token a step: each
    step's output equals the full forward's row under the causal mask,
    and the JAX decoder's step; with do_zip the caches come per kind."""
    B, S, T = 2, 6, 5
    paddle.seed(4)
    jlayer = jnn.TransformerDecoderLayer(E, H, FF, dropout=0.0,
                                         normalize_before=normalize_before)
    tlayer = tnn.TransformerDecoderLayer(E, H, FF, dropout=0.0,
                                         normalize_before=normalize_before)
    jl = jnn.TransformerDecoder(jlayer, 2, norm=jnn.LayerNorm(E))
    tl = tnn.TransformerDecoder(tlayer, 2, norm=tnn.LayerNorm(E))
    tl.set_state_dict({k: np.asarray(v._data)
                       for k, v in jl.state_dict().items()})
    mem, tgt = _x(B, S, E), _x(B, T, E, seed=2)
    causal = tnn.Transformer(E, H, 1, 1, FF) \
        .generate_square_subsequent_mask(T)
    full = tl(torch.tensor(tgt), torch.tensor(mem), causal)
    jc = jl.gen_cache(paddle.to_tensor(mem))
    tc = tl.gen_cache(torch.tensor(mem))
    for i in range(T):
        jo, jc = jl(paddle.to_tensor(tgt[:, i:i + 1]), paddle.to_tensor(mem),
                    cache=jc)
        to, tc = tl(torch.tensor(tgt[:, i:i + 1]), torch.tensor(mem),
                    cache=tc)
        _close(to, jo)
        np.testing.assert_allclose(_t(to)[:, 0], _t(full)[:, i],
                                   atol=OUT_TOL, rtol=OUT_TOL)
    zipped = tl.gen_cache(torch.tensor(mem), do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2
    assert isinstance(zipped[1][0], tnn.MultiHeadAttention.StaticCache)


# ------------------------------------------------------------ activations

_ACTS = sorted(set(TF.activation.__all__) - {"rrelu", "gumbel_softmax"})


@pytest.mark.parametrize("name", _ACTS)
def test_activation_matches_jax_and_casts_as_jax(name):
    """Each activation a layer can name: the values in fp32, and the
    output dtype under O1 and O2 for fp32 and bf16 inputs."""
    x = _x(3, 8) * 3.0
    _close(getattr(TF, name)(torch.tensor(x)),
           getattr(JF, name)(paddle.to_tensor(x)), tol=2e-6)
    for level in ("O1", "O2"):
        for dt in ("float32", "bfloat16"):
            tx = torch.tensor(x).to(getattr(torch, dt))
            jx = paddle.to_tensor(x).astype(dt)
            with tamp.auto_cast(level=level, dtype="bfloat16"):
                got = getattr(TF, name)(tx)
            with jamp.auto_cast(level=level, dtype="bfloat16"):
                want = getattr(JF, name)(jx)
            assert str(got.dtype).replace("torch.", "") == str(
                _j(want).dtype), (level, dt)


def test_random_activations():
    """rrelu's eval slope is the JAX package's mean slope; in training
    its negative slopes lie in [lower, upper]. gumbel_softmax sums to 1
    and its hard form is one-hot."""
    x = _x(4, 16)
    _close(TF.rrelu(torch.tensor(x), training=False),
           JF.rrelu(paddle.to_tensor(x), training=False))
    y = TF.rrelu(torch.tensor(x)).numpy()
    neg = x < 0
    assert np.all(y[~neg] == x[~neg])
    slope = y[neg] / x[neg]
    assert slope.min() >= 1 / 8 - 1e-6 and slope.max() <= 1 / 3 + 1e-6
    soft = TF.gumbel_softmax(torch.tensor(x))
    np.testing.assert_allclose(soft.sum(-1).numpy(), 1.0, rtol=1e-5)
    hard = TF.gumbel_softmax(torch.tensor(x), hard=True).detach().numpy()
    assert set(np.unique(np.round(hard))) == {0.0, 1.0}
    np.testing.assert_allclose(hard, np.round(hard), atol=1e-6)
    np.testing.assert_array_equal(np.round(hard).sum(-1), 1.0)


# ---------------------------------------------------------------- dropout

@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_modes_match_jax(mode):
    """Eval: the identity (upscale) or x * (1 - p) (downscale), as JAX's
    F.dropout. Training: every element is dropped or kept, kept ones
    scaled by 1 / (1 - p) (upscale) or not (downscale), in both packages;
    `axis` shares one draw along the other dims; p = 0 and p = 1."""
    p = 0.4
    x = np.abs(_x(64, 32)) + 0.5
    tl, jl = tnn.Dropout(p, mode=mode), jnn.Dropout(p, mode=mode)
    tl.eval()
    jl.eval()
    _close(tl(torch.tensor(x)), jl(paddle.to_tensor(x)))
    scale = 1.0 / (1.0 - p) if mode == "upscale_in_train" else 1.0
    for out in (_t(TF.dropout(torch.tensor(x), p, mode=mode)),
                _j(JF.dropout(paddle.to_tensor(x), p, mode=mode))):
        kept = out != 0
        np.testing.assert_allclose(out[kept], x[kept] * scale, rtol=1e-6)
        assert 0.45 < kept.mean() < 0.75
    for out in (_t(TF.dropout(torch.tensor(x), p, axis=1, mode=mode)),
                _j(JF.dropout(paddle.to_tensor(x), p, axis=1, mode=mode)),
                _t(TF.dropout(torch.tensor(x), p, axis=-1, mode=mode))):
        col = (out != 0).all(0) | (out == 0).all(0)
        assert col.all()                  # one draw per column
    # the JAX package compares axis=-1 with each dim's index, matches
    # none and draws once for the whole tensor (ROADMAP queue 3)
    out = _j(JF.dropout(paddle.to_tensor(x), p, axis=-1, mode=mode))
    assert (out != 0).all() or (out == 0).all()
    for q, want in ((0.0, x), (1.0, np.zeros_like(x))):
        _close(TF.dropout(torch.tensor(x), q, mode=mode), want)
    with tamp.auto_cast(level="O2"):
        got = TF.dropout(torch.tensor(x), p, mode=mode)
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        want = JF.dropout(paddle.to_tensor(x), p, mode=mode)
    assert got.dtype == torch.bfloat16 and str(_j(want).dtype) == "bfloat16"
    with pytest.raises(ValueError, match="mode"):
        TF.dropout(torch.tensor(x), p, mode="upscale")


# ----------------------------------------------------------- ops.basic

@pytest.mark.parametrize("level", [None, "O1", "O2"])
def test_concat_and_zeros_cast_as_jax(level):
    """concat's dtype for mixed fp32 / bf16 inputs (the gray rule) and
    zeros' (a creation op, never cast), as the JAX package's."""
    a = np.ones((1, 2), np.float32)
    ta, tb = torch.tensor(a), torch.tensor(a).bfloat16()
    ja, jb = paddle.to_tensor(a), paddle.to_tensor(a).astype("bfloat16")
    tctx = tamp.auto_cast(enable=level is not None, level=level or "O1")
    jctx = jamp.auto_cast(enable=level is not None, level=level or "O1",
                          dtype="bfloat16")
    with tctx:
        tc = tops.concat([ta, tb], axis=1)
        tz = tops.zeros([2, 0, 3])
    with jctx:
        jc = JM.concat([ja, jb], axis=1)
        from paddle_tpu.ops.creation import zeros as jzeros
        jz = jzeros([2, 0, 3])
    assert str(tc.dtype).replace("torch.", "") == str(_j(jc).dtype)
    assert tuple(tc.shape) == (1, 4)
    assert tz.dtype == torch.float32 and str(_j(jz).dtype) == "float32"
    assert tops.zeros([2], dtype="int64").dtype == torch.int64
