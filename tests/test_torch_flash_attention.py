"""paddle_tpu_torch flash attention (plain versions, on the CPU) against
the JAX package's Pallas flash-attention kernels run in interpret mode,
as tests/test_pallas_kernels.py runs them (conftest sets
jax_default_matmul_precision="highest", so the kernels' operands stay
fp32); and the sdpa routing of both packages below and at
pallas_attention_min_seq.

Tolerances are the JAX package's own kernel contract
(tests/test_pallas_kernels.py): 2e-5 for the forward, 5e-4 for the
gradients."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

import paddle_tpu as paddle                                   # noqa: E402
import paddle_tpu.nn.functional as JF                         # noqa: E402
from paddle_tpu.ops.pallas import flash_attention as jfa      # noqa: E402

import paddle_tpu_torch as ptt                                # noqa: E402
from paddle_tpu_torch.nn import functional as TF              # noqa: E402
from paddle_tpu_torch.nn.functional import attention as tattn  # noqa: E402
from paddle_tpu_torch.ops.kernels import flash_attention as tfa  # noqa: E402

FWD_TOL = 2e-5
BWD_TOL = 5e-4


@pytest.fixture(autouse=True)
def _restore_flags():
    old_j = paddle.get_flags("pallas_attention_min_seq")
    old_t = ptt.get_flags("pallas_attention_min_seq")
    yield
    paddle.set_flags({"pallas_attention_min_seq": old_j})
    ptt.set_flags({"pallas_attention_min_seq": old_t})


def _qkv_do(seed, B, T, H, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(4)]


def _jax_forward_and_grads(q, k, v, do, causal, scale):
    """JAX flash O, lse ([BH, T], lane 0 of the TPU layout) and the
    gradients of sum(O * dO) w.r.t. q, k, v."""
    B, T, H, D = q.shape

    def to3(x):
        return jnp.transpose(jnp.asarray(x), (0, 2, 1, 3)).reshape(B * H,
                                                                    T, D)
    o3, lse = jfa._fwd(to3(q), to3(k), to3(v), scale, causal)

    def f(a, b, c):
        return (jfa.flash_attention(a, b, c, causal=causal, scale=scale)
                * jnp.asarray(do)).sum()
    grads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))
    o = np.asarray(o3).reshape(B, H, T, D).transpose(0, 2, 1, 3)
    return o, np.asarray(lse)[:, :, 0], [np.asarray(g) for g in grads]


def _torch_forward_and_grads(q, k, v, do, causal, scale):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=causal, scale=scale)
    (o * torch.tensor(do)).sum().backward()
    _, lse = tfa.flash_attention_forward(tq.detach(), tk.detach(),
                                         tv.detach(), causal, scale)
    return (o.detach().numpy(), lse.numpy(),
            [t.grad.numpy() for t in (tq, tk, tv)])


def _compare(q, k, v, do, causal):
    scale = 1.0 / math.sqrt(q.shape[-1])
    jo, jlse, jg = _jax_forward_and_grads(q, k, v, do, causal, scale)
    to, tlse, tg = _torch_forward_and_grads(q, k, v, do, causal, scale)
    np.testing.assert_allclose(to, jo, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(tlse, jlse, atol=FWD_TOL, rtol=FWD_TOL)
    for a, b, name in zip(tg, jg, "qkv"):
        np.testing.assert_allclose(a, b, atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [128, 256])
def test_plain_flash_matches_jax_pallas(T, causal):
    """One-block grids (the JAX package's fused backward: nk == 1)."""
    _compare(*_qkv_do(T + causal, 2, T, 2, 32), causal)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_flash_matches_jax_pallas_multi_block(monkeypatch, causal):
    """(128, 128) blocks at T=256: a 2 x 2 grid, the online softmax across
    k blocks and the JAX package's two-pass backward (dq pass + dk/dv
    pass)."""
    monkeypatch.setenv("PT_FLASH_FWD_BLOCKS", "128,128")
    monkeypatch.setenv("PT_FLASH_BWD_BLOCKS", "128,128")
    _compare(*_qkv_do(7 + causal, 1, 256, 2, 32), causal)


def test_plain_flash_bf16_rounds_operands_like_the_kernels():
    """bf16 inputs: the plain forward rounds the scaled q and P to bf16 and
    returns bf16; against an fp32 computation from the same bf16 inputs it
    stays within bf16 rounding (2^-8 of the output's scale)."""
    q, k, v, _ = _qkv_do(3, 1, 128, 2, 64)
    qb, kb, vb = (torch.tensor(a).bfloat16() for a in (q, k, v))
    o, lse = tfa.flash_attention_forward(qb, kb, vb, causal=True)
    o32, lse32 = tfa.flash_attention_forward(qb.float(), kb.float(),
                                             vb.float(), causal=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert (o.float() - o32).abs().max() <= 2 ** -8 * o32.abs().max() * 4
    assert (lse - lse32).abs().max() <= 2 ** -8 * lse32.abs().max()


def test_dispatch_plain_on_cpu_and_reference_only_by_request():
    q, k, v, _ = _qkv_do(4, 1, 64, 1, 16)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    before = (tfa.fwd_launches, tfa.dq_launches, tfa.bwd_launches)
    a = tfa.flash_attention(tq, tk, tv, causal=True)
    b = tfa.flash_attention(tq, tk, tv, causal=True, kernel="reference")
    assert torch.equal(a, b)
    assert (tfa.fwd_launches, tfa.dq_launches, tfa.bwd_launches) == before
    with pytest.raises(ValueError, match="kernel="):
        tfa.flash_attention(tq, tk, tv, kernel="cuda")
    meta = tq.to("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tfa.flash_attention(meta, meta, meta)


def test_kernel_contract_checks():
    """What the CUDA kernels do not take raises before any launch: an
    unsupported dtype, a head over 128 wide, mismatched shapes."""
    t = torch.zeros(1, 8, 1, 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._check(t.half(), t.half(), t.half())
    wide = torch.zeros(1, 8, 1, 160)
    with pytest.raises(ValueError, match="head_dim"):
        tfa._check(wide, wide, wide)
    with pytest.raises(ValueError, match="does not match"):
        tfa._check(t, torch.zeros(1, 9, 1, 16), t)
    # chunks of one fused qkv tensor share strides: no copy is made
    qkv = torch.zeros(2, 8, 3 * 32)
    q, k, v = (c.reshape(2, 8, 2, 16) for c in qkv.chunk(3, dim=-1))
    cq, ck, cv = tfa._check(q, k, v)
    assert cq.data_ptr() == q.data_ptr() and not cq.is_contiguous()
    # the backward kernels' per-row operands: [B*H, T] on q's device
    with pytest.raises(ValueError, match=r"want \(4, 8\)"):
        tfa._bwd_operands(q, k, v, (q,), (torch.zeros(4, 7),))
    with pytest.raises(ValueError, match="on meta"):
        tfa._bwd_operands(q, k, v, (q,), (torch.zeros(4, 8).to("meta"),))
    *_, (lse,), shape = tfa._bwd_operands(q, k, v, (q,),
                                          (torch.zeros(4, 8).double(),))
    assert lse.dtype == torch.float32 and shape[:4] == (2, 8, 2, 16)


@pytest.mark.parametrize("T", [64, 128])
def test_sdpa_routing_matches_jax_below_and_at_min_seq(monkeypatch, T):
    """Both packages route sdpa to flash attention exactly when
    T >= pallas_attention_min_seq (128 here) and agree on the output
    either way."""
    paddle.set_flags({"pallas_attention_min_seq": 128})
    ptt.set_flags({"pallas_attention_min_seq": 128})
    routed = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **k: routed.append(1) or real(*a, **k))
    q, k, v, _ = _qkv_do(5 + T, 2, T, 2, 32)
    jo = JF.scaled_dot_product_attention(paddle.to_tensor(q),
                                         paddle.to_tensor(k),
                                         paddle.to_tensor(v), is_causal=True)
    to = TF.scaled_dot_product_attention(torch.tensor(q), torch.tensor(k),
                                         torch.tensor(v), is_causal=True)
    assert bool(routed) == (T >= 128)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo._data),
                               atol=FWD_TOL, rtol=FWD_TOL)


def test_sdpa_with_mask_takes_the_composition_like_jax():
    """A mask (or dropout) keeps sdpa off the flash kernels in both
    packages; a boolean mask and an additive one agree with JAX."""
    ptt.set_flags({"pallas_attention_min_seq": 16})
    q, k, v, _ = _qkv_do(9, 1, 32, 2, 16)
    rng = np.random.default_rng(10)
    bmask = rng.random((1, 2, 32, 32)) > 0.3
    bmask[..., 0] = True
    amask = rng.standard_normal((1, 2, 32, 32)).astype(np.float32)
    for mask in (bmask, amask):
        jo = JF.scaled_dot_product_attention(
            paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
            attn_mask=paddle.to_tensor(mask))
        to = TF.scaled_dot_product_attention(
            torch.tensor(q), torch.tensor(k), torch.tensor(v),
            attn_mask=torch.tensor(mask))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo._data),
                                   atol=FWD_TOL, rtol=FWD_TOL)
    with pytest.raises(NotImplementedError):
        TF.seq_parallel_scope(None, "sp")
