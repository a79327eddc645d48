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
# bf16: the worst row's RMS error within 2^-6 of that row's RMS, the gate
# chip_smoke.py holds the bf16 kernels to (FLASH_BF16_ROW_REL)
BF16_ROW_REL = 2.0 ** -6
LOG2E = 1.4426950408889634


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

    # the bf16 route: D padded with zeros to a multiple of 8 (q, k, v and
    # the contiguous operands), aligned chunks of a fused qkv kept in place,
    # a misaligned operand copied to an aligned one
    qkv = torch.zeros(2, 8, 3 * 2 * 13, dtype=torch.bfloat16)
    q, k, v = (c.reshape(2, 8, 2, 13) for c in qkv.chunk(3, dim=-1))
    pq, pk, pv, (po,) = tfa._tc_layout(q, k, v, [q.contiguous()])
    assert all(t.shape == (2, 8, 2, 16) and tfa._aligned(t)
               for t in (pq, pk, pv, po))
    assert torch.equal(pq[..., :13], q) and not pq[..., 13:].any()
    *_, shape = tfa._bwd_operands(q, k, v, (q,), (torch.zeros(4, 8),))
    assert shape[3] == 16 and shape[4:] == pq.stride()[:3]
    qkv = torch.zeros(2, 8, 3 * 32, dtype=torch.bfloat16)
    q, k, v = (c.reshape(2, 8, 2, 16) for c in qkv.chunk(3, dim=-1))
    cq, ck, cv, _ = tfa._tc_layout(q, k, v)
    assert cq.data_ptr() == q.data_ptr() and not cq.is_contiguous()
    buf = torch.zeros(2 * 8 * 2 * 16 + 1, dtype=torch.bfloat16)
    odd = buf[1:].view(2, 8, 2, 16)             # 2 bytes off alignment
    assert not tfa._aligned(odd)
    cq, ck, cv, (co,) = tfa._tc_layout(odd, odd, odd, [odd])
    assert all(tfa._aligned(t) and t.is_contiguous() and torch.equal(t, odd)
               for t in (cq, ck, cv, co))
    # fp32 keeps its layout: the SIMT kernels take any D
    f = torch.zeros(1, 8, 1, 13)
    assert tfa._check(f, f, f)[0].shape[-1] == 13
    # what neither route takes still raises
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._check(odd.half(), odd.half(), odd.half())
    wide = torch.zeros(1, 8, 1, 136, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa._check(wide, wide, wide)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_zero_padded_head_is_the_same_function(causal):
    """The bf16 route's zero padding is exact: the plain version on the
    padded operands, with the real D's scale, cut back to D, equals the
    plain version on the originals (forward, lse and every gradient)."""
    q, k, v, do = (torch.tensor(a).bfloat16()
                   for a in _qkv_do(11 + causal, 2, 70, 2, 13))
    scale = 1.0 / math.sqrt(13)
    o, lse = tfa.flash_attention_forward(q, k, v, causal, scale,
                                         kernel="reference")
    grads = tfa.flash_attention_backward(q, k, v, o, lse, do, causal, scale,
                                         kernel="reference")
    pq, pk, pv, (po, pdo) = tfa._tc_layout(q, k, v, [o, do])
    assert pq.shape[-1] == 16
    po2, plse = tfa.flash_attention_forward(pq, pk, pv, causal, scale,
                                            kernel="reference")
    pgrads = tfa.flash_attention_backward(pq, pk, pv, po, lse, pdo, causal,
                                          scale, kernel="reference")
    # zero columns add exact zeros; only fp32 summation order may differ,
    # which can move a bf16 output by one rounding step
    for got, want in zip((po2, *pgrads), (o, *grads)):
        assert not got[..., 13:].float().any()
        torch.testing.assert_close(tfa._cut_d(got, 13), want, rtol=2 ** -7,
                                   atol=2 ** -7 * want.float().abs().max())
    torch.testing.assert_close(plse, lse, rtol=1e-6, atol=1e-6)


def _row_rel_err(got, want):
    """chip_smoke.py's bf16 gate: the worst row's RMS error over that
    row's RMS (rows below 2^-10 of the tensor's RMS use that floor)."""
    err = (got.float() - want.float()).pow(2).mean(-1)
    ref = want.float().pow(2).mean(-1)
    ref = ref.clamp_min(ref.mean().item() * 2.0 ** -20)
    return (err / ref).max().sqrt().item()


def _tc_emulation(q, k, v, do, causal, scale, tile=64, skip=None):
    """The bf16 tensor-core kernels' arithmetic in PyTorch: the forward's
    online softmax over `tile`-key tiles with P = exp2(s log2(e) - m
    log2(e)) rounded to bf16 against the running max, and the backward's
    P = exp2(s log2(e) - lse log2(e)); products of bf16 operands summed in
    fp32. `skip` leaves one key tile out of the forward."""
    bf = torch.bfloat16
    B, T, H, D = q.shape
    qs = (q.float() * scale).to(bf).float().transpose(1, 2)
    kf, vf, dof = (t.float().transpose(1, 2) for t in (k, v, do))
    rows = torch.arange(T)[:, None]
    m = torch.full((B, H, T), -1e30)
    l = torch.zeros(B, H, T)
    acc = torch.zeros(B, H, T, D)
    for k0 in range(0, T, tile):
        if k0 == skip:
            continue
        s = qs @ kf[:, :, k0:k0 + tile].transpose(-1, -2)
        if causal:
            s = s.masked_fill(torch.arange(k0, k0 + s.shape[-1]) > rows,
                              -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2(s * LOG2E - (m_new * LOG2E)[..., None])
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(bf).float() @ vf[:, :, k0:k0 + tile]
        m = m_new
    lc = l.clamp_min(1e-30)
    o = (acc / lc[..., None]).to(bf)
    lse = m + torch.log(lc)
    s = qs @ kf.transpose(-1, -2)
    p = torch.exp2(s * LOG2E - (lse * LOG2E)[..., None])
    if causal:
        p = p.masked_fill(torch.arange(T) > rows, 0.0)
    delta = (dof * o.float()).sum(-1)
    ds = (p * (dof @ vf.transpose(-1, -2) - delta[..., None])).to(bf).float()
    dq = (ds @ kf) * scale
    dk = ds.transpose(-1, -2) @ qs
    dv = p.to(bf).float().transpose(-1, -2) @ dof
    out = [o.transpose(1, 2), lse.reshape(B * H, T)]
    return out + [g.transpose(1, 2).to(bf) for g in (dq, dk, dv)]


@pytest.mark.parametrize("T", [1024, 2048])
def test_tensor_core_softmax_emulation_within_the_bf16_row_gate(T):
    """Rounding P per 64-key tile (exp2 with log2(e) folded in, as the
    tensor-core kernels do per tile), emulated in PyTorch on bf16 inputs,
    keeps the worst row of O, dq, dk and dv within 2^-6 of the plain
    version's row RMS (lse within the fp32 2e-5), while the same emulation
    with one key tile left out fails that gate."""
    q, k, v, do = (torch.tensor(a).bfloat16()
                   for a in _qkv_do(T, 1, T, 2, 64))
    scale = 1.0 / math.sqrt(64)
    o, lse = tfa.flash_attention_forward(q, k, v, True, scale,
                                         kernel="reference")
    want = [o, lse, *tfa.flash_attention_backward(
        q, k, v, o, lse, do, True, scale, kernel="reference")]
    got = _tc_emulation(q, k, v, do, True, scale)
    assert (got[1] - lse).abs().max().item() <= FWD_TOL
    for name, a, b in zip(("o", "dq", "dk", "dv"), got[:1] + got[2:],
                          want[:1] + want[2:]):
        assert a.dtype == b.dtype == torch.bfloat16
        assert _row_rel_err(a, b) <= BF16_ROW_REL, name
    cut = _tc_emulation(q, k, v, do, True, scale, skip=0)[0]
    assert _row_rel_err(cut, o) > BF16_ROW_REL


def _wgmma_emulation(q, k, v, do, causal, scale, q_s, tile=128, q_tile=64,
                     skip=None, skip_q=None):
    """The bf16 wgmma kernels' arithmetic in PyTorch, tile by tile: the
    forward's online softmax over `tile`-key tiles (`_tc_emulation`); dq
    summed over the same key tiles in order, dq = (dS . K) * scale; dk and
    dv summed over `q_tile`-row tiles of q in order, dk = dSᵀ . q_s, dv =
    Pᵀ . dO, where q_s [B, T, H, D] is the scaled q that the dq kernel
    writes and the dk/dv kernel reads. `skip` leaves one key tile out of
    the forward, `skip_q` one q tile out of dk and dv."""
    bf = torch.bfloat16
    B, T, H, D = q.shape
    o, lse = _tc_emulation(q, k, v, do, causal, scale, tile, skip)[:2]
    qs = q_s.float().transpose(1, 2)
    kf, vf, dof = (t.float().transpose(1, 2) for t in (k, v, do))
    lse4 = lse.reshape(B, H, T)[..., None]
    delta = (dof * o.float().transpose(1, 2)).sum(-1)[..., None]
    rows = torch.arange(T)[:, None]

    def grads(qr, kr):             # P and dS of q rows qr, keys kr
        s = qs[:, :, qr] @ kf[:, :, kr].transpose(-1, -2)
        p = torch.exp2(s * LOG2E - lse4[:, :, qr] * LOG2E)
        if causal:
            p = p.masked_fill(torch.arange(T)[kr] > rows[qr], 0.0)
        dp = dof[:, :, qr] @ vf[:, :, kr].transpose(-1, -2)
        return p, (p * (dp - delta[:, :, qr])).to(bf).float()

    dq = torch.zeros(B, H, T, D)
    for k0 in range(0, T, tile):
        kr = slice(k0, k0 + tile)
        dq = dq + grads(slice(0, T), kr)[1] @ kf[:, :, kr]
    dk = torch.zeros(B, H, T, D)
    dv = torch.zeros(B, H, T, D)
    for t0 in range(0, T, q_tile):
        if t0 == skip_q:
            continue
        qr = slice(t0, t0 + q_tile)
        p, ds = grads(qr, slice(0, T))
        dv = dv + p.to(bf).float().transpose(-1, -2) @ dof[:, :, qr]
        dk = dk + ds.transpose(-1, -2) @ qs[:, :, qr]
    return [o, lse] + [g.transpose(1, 2).to(bf) for g in (dq * scale, dk, dv)]


def _bf16_case(seed, T, D, H=2):
    q, k, v, do = (torch.tensor(a).bfloat16()
                   for a in _qkv_do(seed, 1, T, H, D))
    scale = 1.0 / math.sqrt(D)
    q_s = (q.float() * scale).to(torch.bfloat16)
    assert torch.equal(q_s.float(), tfa._scaled_q(q, scale))
    return q, k, v, do, scale, q_s


@pytest.mark.parametrize("T,D", [(1024, 64), (1024, 128), (2048, 128)])
def test_wgmma_tile_emulation_within_the_bf16_row_gate(T, D):
    """The wgmma kernels' tiles (128 keys in the forward and dq, 64 q rows
    in dk/dv, the backward reading the precomputed q_s), emulated in
    PyTorch on bf16 inputs, keep the worst row of O, dq, dk and dv within
    2^-6 of the plain version's row RMS (lse within the fp32 2e-5); the
    same emulation with one key tile left out of the forward, or one q
    tile out of dk and dv, fails that gate."""
    q, k, v, do, scale, q_s = _bf16_case(T + D, T, D)
    o, lse = tfa.flash_attention_forward(q, k, v, True, scale,
                                         kernel="reference")
    want = [o, lse, *tfa.flash_attention_backward(
        q, k, v, o, lse, do, True, scale, kernel="reference")]
    got = _wgmma_emulation(q, k, v, do, True, scale, q_s)
    assert (got[1] - lse).abs().max().item() <= FWD_TOL
    for name, a, b in zip(("o", "dq", "dk", "dv"), got[:1] + got[2:],
                          want[:1] + want[2:]):
        assert a.dtype == b.dtype == torch.bfloat16
        assert _row_rel_err(a, b) <= BF16_ROW_REL, name
    cut = _wgmma_emulation(q, k, v, do, True, scale, q_s, skip=0)[0]
    assert _row_rel_err(cut, o) > BF16_ROW_REL
    cut_dv = _wgmma_emulation(q, k, v, do, True, scale, q_s,
                              skip_q=T - 64)[4]
    assert _row_rel_err(cut_dv, want[4]) > BF16_ROW_REL


@pytest.mark.parametrize("causal", [False, True])
def test_wgmma_tile_emulation_matches_jax_pallas(causal):
    """The same emulation against the JAX package's Pallas kernels in
    interpret mode (run as test_plain_flash_matches_jax_pallas runs them,
    in fp32 on the bf16-rounded inputs) at T=256, D=64: O and every
    gradient within the bf16 row gate."""
    q, k, v, do, scale, q_s = _bf16_case(31 + causal, 256, 64)
    jo, _, jg = _jax_forward_and_grads(*(t.float().numpy()
                                         for t in (q, k, v, do)),
                                       causal, scale)
    got = _wgmma_emulation(q, k, v, do, causal, scale, q_s)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got[:1] + got[2:],
                          [jo] + jg):
        assert _row_rel_err(a, torch.tensor(b)) <= BF16_ROW_REL, name


def test_bf16_dkv_needs_the_dq_kernels_q_s():
    """The bf16 dk/dv kernel streams the q_s that the dq kernel wrote: its
    launcher raises before any build or launch when q_s is missing or of
    another shape, and the backward's per-row operands come out 16-byte
    aligned."""
    q, k, v, do = (torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
                   for _ in range(4))
    lse = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="q_s"):
        tfa._launch_bwd_dkv(q, k, v, do, lse, lse, True, 0.25, None)
    with pytest.raises(ValueError, match="q_s"):
        tfa._launch_bwd_dkv(q, k, v, do, lse, lse, True, 0.25, q[:, :4])
    odd = torch.zeros(2 * 8 + 1)[1:].view(2, 8)    # 4 bytes off alignment
    *_, (lse2,), _ = tfa._bwd_operands(q, k, v, (do,), (odd,))
    assert lse2.data_ptr() % 16 == 0 and torch.equal(lse2, odd)
    # the plain versions take no q_s and the dq entry returns none
    dq, delta, none = tfa.flash_attention_bwd_dq(q, k, v, q, do, lse, True)
    assert none is None and dq.shape == q.shape and delta.shape == (2, 8)


def test_missing_nvcc_raises_on_launch(monkeypatch):
    """The flash wrappers' build step raises without the CUDA toolkit (the
    C entry points: forward with 6 pointers, dq and dk/dv with 9): no quiet
    fallback to the plain versions."""
    from paddle_tpu_torch.ops.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(tfa, "_FNS", {})
    monkeypatch.setattr(_build, "_LIBS", {})
    for lib, name, n_ptr in (
            ("flash_attention_fwd", "flash_attention_fwd", 6),
            ("flash_attention_bwd", "flash_attention_bwd_dq", 9),
            ("flash_attention_bwd", "flash_attention_bwd_dkv", 9)):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tfa._kernel_fn(lib, name, n_ptr)
    assert {"flash_attention_fwd", "flash_attention_bwd"} <= \
        set(_build.sources())


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
