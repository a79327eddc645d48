"""paddle_tpu_torch's fused linear cross-entropy against the JAX package, on
the CPU: the plain versions of the three kernels (`ops/kernels/fused_ce.py`)
against the JAX package's Pallas kernels (`ops/pallas/fused_ce.py`) run in
interpret mode with `_pallas_ok` forced on, as tests/test_pallas_kernels.py
runs them, at the JAX tests' tolerances (rtol 1e-4 / atol 1e-4 for loss,
lse and lab; rtol 2e-3 / atol 1e-5 for dx and dW); ragged shapes against
a float64 numpy reference; `linear_cross_entropy`'s routing (fused=
True / None / False, the V >= 65536 rule, the CPU, a device with no
kernel); and the bf16 tensor-core backward's arithmetic (rank-ordered
partial logits, exp2, 64-row tiles) emulated in PyTorch within the bf16
row gate, with its zero-padded H and copied misaligned operands."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from paddle_tpu.ops.pallas import fused_ce as jce             # noqa: E402

from paddle_tpu_torch.nn import functional as TF              # noqa: E402
from paddle_tpu_torch.nn.functional import loss as tloss      # noqa: E402
from paddle_tpu_torch.ops.kernels import fused_ce as tce      # noqa: E402

LOSS_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_pallas_kernels.py:199
GRAD_TOL = dict(rtol=2e-3, atol=1e-5)     # tests/test_pallas_kernels.py:206
# chip_smoke.py holds the bf16 backward kernels to (CE_BF16_ROW_REL)
BF16_ROW_REL = 2.0 ** -6
LOG2E = 1.4426950408889634


def _inputs(N, H, V, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, H)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((V, H)) * 0.1).astype(np.float32)
    lab = rng.integers(0, V, N).astype(np.int64)
    g = rng.standard_normal(N).astype(np.float32)
    return x, w, lab, g


def _jax_kernels(x, w, lab, g, monkeypatch):
    """(loss, lse, lab, dx, dW) of the JAX package's Pallas kernels, in
    interpret mode: the forward's residual lse, and the vjp of the loss
    rows against the cotangent g."""
    monkeypatch.setattr(jce, "_pallas_ok", lambda N, H: True)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    jl = jnp.asarray(lab.astype(np.int32))
    loss, (_, _, _, lse) = jce._lce_pallas_fwd(jx, jw, jl)
    rows, vjp = jax.vjp(
        lambda a, b: jce.linear_cross_entropy(a, b, jl, fused=True), jx, jw)
    dx, dw = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(np.asarray(rows), np.asarray(loss))
    lse = np.asarray(lse)
    return (np.asarray(loss), lse, lse - np.asarray(loss), np.asarray(dx),
            np.asarray(dw))


def _port_plain(x, w, lab, g):
    tx, tw, tl = torch.tensor(x), torch.tensor(w), torch.tensor(lab)
    lse, lb = tce.fused_ce_fwd_reference(tx, tw, tl)
    tg = torch.tensor(g)
    dx = tce.fused_ce_bwd_dx_reference(tx, tw, tl, lse, tg)
    dw = tce.fused_ce_bwd_dw_reference(tx, tw, tl, lse, tg)
    return [t.numpy() for t in ((lse - lb), lse, lb, dx, dw)]


@pytest.mark.parametrize("N,H,V", [(128, 128, 700), (256, 256, 1000)])
def test_plain_versions_match_jax_pallas_kernels(N, H, V, monkeypatch):
    """V=700 and 1000 are padded to the TPU's vocab block inside the JAX
    kernels (masked columns); the port's plain versions never pad."""
    x, w, lab, g = _inputs(N, H, V, seed=N + V)
    want = _jax_kernels(x, w, lab, g, monkeypatch)
    got = _port_plain(x, w, lab, g)
    for name, a, b in zip(("loss", "lse", "lab"), got[:3], want[:3]):
        np.testing.assert_allclose(a, b, err_msg=name, **LOSS_TOL)
    for name, a, b in zip(("dx", "dw"), got[3:], want[3:]):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


def _numpy_reference(x, w, lab, g):
    """float64 loss rows, dx, dW of the tied head."""
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    lg = x64 @ w64.T
    m = lg.max(1, keepdims=True)
    lse = (m + np.log(np.exp(lg - m).sum(1, keepdims=True)))[:, 0]
    rows = lse - lg[np.arange(len(lab)), lab]
    p = np.exp(lg - lse[:, None])
    p[np.arange(len(lab)), lab] -= 1.0
    dlg = p * g.astype(np.float64)[:, None]
    return rows, dlg @ w64, dlg.T @ x64


@pytest.mark.parametrize("N,H,V", [(200, 96, 700), (37, 100, 333),
                                   (5, 8, 3)])
def test_ragged_shapes_match_float64(N, H, V):
    """Shapes no TPU tile divides (the JAX package would take its XLA
    path): the plain versions through `linear_cross_entropy(fused=True)`
    and its autograd against float64 numpy."""
    x, w, lab, g = _inputs(N, H, V, seed=N)
    want = _numpy_reference(x, w, lab, g)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    rows = TF.linear_cross_entropy(tx, tw, torch.tensor(lab), fused=True,
                                   reduction="none")
    (rows * torch.tensor(g)).sum().backward()
    for name, a, b in zip(("loss", "dx", "dw"),
                          (rows.detach(), tx.grad, tw.grad), want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_bf16_plain_versions_round_dlg_and_outputs():
    """bf16 operands: logits and lse in fp32 from the exact bf16 values,
    dlg rounded to bf16 before its products, dx and dW in bf16 — the
    fp32 plain versions on the same (bf16-valued) inputs with dlg rounded
    the same way give the same numbers up to the final rounding."""
    x, w, lab, g = _inputs(64, 32, 300, seed=7)
    xb = torch.tensor(x).bfloat16()
    wb = torch.tensor(w).bfloat16()
    tl, tg = torch.tensor(lab), torch.tensor(g)
    lse, lb = tce.fused_ce_fwd_reference(xb, wb, tl)
    lse32, lb32 = tce.fused_ce_fwd_reference(xb.float(), wb.float(), tl)
    assert lse.dtype == lb.dtype == torch.float32
    assert torch.equal(lse, lse32) and torch.equal(lb, lb32)
    dx = tce.fused_ce_bwd_dx_reference(xb, wb, tl, lse, tg)
    dw = tce.fused_ce_bwd_dw_reference(xb, wb, tl, lse, tg)
    assert dx.dtype == dw.dtype == torch.bfloat16
    dlg = tce.dlogits_reference(xb, wb, tl, lse, tg)
    assert dlg.dtype == torch.bfloat16
    assert torch.equal(dx, (dlg.float() @ wb.float()).bfloat16())
    assert torch.equal(dw, (dlg.float().t() @ xb.float()).bfloat16())


# --------------------------------------------------------------- routing

@pytest.mark.parametrize("fused", [True, None])
def test_fused_routes_agree_with_unfused_on_cpu(fused):
    x, w, lab, g = _inputs(48, 16, 200, seed=3)
    out = {}
    for route in (fused, False):
        tx = torch.tensor(x, requires_grad=True)
        tw = torch.tensor(w, requires_grad=True)
        loss = TF.linear_cross_entropy(tx, tw, torch.tensor(lab),
                                       fused=route)
        loss.backward()
        out[route] = (loss.detach(), tx.grad, tw.grad)
    for a, b in zip(out[fused], out[False]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("V", [65535, 65536])
@pytest.mark.parametrize("fused", [None, True, False])
def test_fused_none_picks_the_jax_route(V, fused, monkeypatch):
    """With the TPU's tile rule satisfied (`_pallas_ok` forced on, N and H
    multiples of 128), the JAX package and the port take the fused route
    for the same (V, fused): at fused=None from V = 65536 on."""
    calls = []
    monkeypatch.setattr(jce, "_pallas_ok", lambda N, H: True)
    monkeypatch.setattr(jce, "_lce_pallas",
                        lambda *a: calls.append("jax fused") or a[0][:, 0])
    monkeypatch.setattr(jce, "_lce_xla",
                        lambda *a: calls.append("jax unfused") or a[0][:, 0])
    monkeypatch.setattr(
        tloss, "fused_linear_cross_entropy",
        lambda *a: calls.append("port fused") or a[0][:, 0])
    monkeypatch.setattr(
        tloss._LinearCrossEntropy, "apply",
        lambda *a: calls.append("port unfused") or a[0][:, 0])
    N, H = 128, 128
    jce.linear_cross_entropy(jnp.zeros((N, H)), jnp.zeros((V, H)),
                             jnp.zeros(N, jnp.int32), fused=fused)
    TF.linear_cross_entropy(torch.zeros(N, H), torch.zeros(V, H),
                            torch.zeros(N, dtype=torch.long), fused=fused)
    j, t = calls
    assert j.split()[1] == t.split()[1], calls
    assert (t == "port fused") == (fused is True or (
        fused is None and V >= tloss.FUSED_MIN_VOCAB))


# ------------------------------------------------------- kernel wrappers

def test_wrappers_check_the_kernel_contract():
    """What the CUDA wrappers refuse before any launch (checked on CPU
    tensors, where no kernel is needed to reach the checks)."""
    x, w = torch.zeros(4, 8), torch.zeros(16, 8)
    lab = torch.zeros(4, dtype=torch.long)
    with pytest.raises(TypeError, match="both float32 or"):
        tce._check(x.half(), w.half(), lab)
    with pytest.raises(TypeError, match="both float32 or"):
        tce._check(x.bfloat16(), w, lab)
    with pytest.raises(ValueError, match="want x"):
        tce._check(x, torch.zeros(16, 4), lab)
    big = tce.max_hidden(torch.bfloat16) + 8
    with pytest.raises(ValueError, match="shared-memory limit"):
        tce._check(torch.zeros(1, big).bfloat16(),
                   torch.zeros(1, big).bfloat16(), lab[:1])
    with pytest.raises(ValueError, match="per-row operand"):
        tce._check(x, w, lab, (torch.zeros(3),))
    xc, wc, lc, (lse,) = tce._check(x.t().contiguous().t(), w,
                                    lab.int(), (torch.zeros(4).double(),))
    assert xc.is_contiguous() and lc.dtype == torch.long \
        and lse.dtype == torch.float32
    assert tce.max_hidden(torch.bfloat16) == 4096
    assert tce.max_hidden(torch.float32) == 3616
    with pytest.raises(ValueError, match="kernel="):
        tce.fused_ce_forward(x, w, lab, kernel="cuda")


def test_missing_nvcc_raises_on_launch(monkeypatch):
    """The wrapper's build step raises without the CUDA toolkit: no quiet
    fallback to the plain versions."""
    from paddle_tpu_torch.ops.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(tce, "_FNS", {})
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tce._kernel_fn("fused_linear_ce_fwd", "fused_linear_ce_fwd", 6)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tce._fwd_scratch_fn()
    assert "fused_linear_ce_fwd" in _build.sources()
    assert "fused_linear_ce_bwd" in _build.sources()


# --------------------------------------- the bf16 tensor-core backward

def _row_rel_err(got, want):
    """chip_smoke.py's bf16 gate: the worst row's RMS error over that
    row's RMS (rows below 2^-10 of the tensor's RMS use that floor)."""
    err = (got.float() - want.float()).pow(2).mean(-1)
    ref = want.float().pow(2).mean(-1)
    ref = ref.clamp_min(ref.mean().item() * 2.0 ** -20)
    return (err / ref).max().sqrt().item()


def _tc_emulation(x, w, lab, lse, g, which, tile=64, skip=None):
    """The bf16 backward kernels' arithmetic (csrc/fused_linear_ce_bwd.cu
    `lce_bwd_mma_kernel`) in PyTorch: per tile of `tile` streamed rows (W
    for dx, x for dW), each cluster rank's partial logits over its 512
    columns of H as two 256-column halves summed (half 0 + half 1), the
    ranks' partials summed in rank order, p = exp2((logit - lse) log2 e),
    dlg = (p - onehot) g in fp32 rounded to bf16, and acc += dlg . tile in
    fp32, tile after tile. `skip` leaves the tile at that row out."""
    xf, wf = x.float(), w.float()
    H = x.shape[1]
    res, streamed = (wf, xf) if which == "dw" else (xf, wf)
    acc = torch.zeros(res.shape[0], H)
    for s0 in range(0, streamed.shape[0], tile):
        if s0 == skip:
            continue
        st = streamed[s0:s0 + tile]
        logits = 0.0
        for c0 in range(0, H, 512):
            lo, hi = (slice(a, a + 256) for a in (c0, c0 + 256))
            logits = logits + (res[:, lo] @ st[:, lo].t()
                               + res[:, hi] @ st[:, hi].t())
        cols = torch.arange(s0, s0 + st.shape[0])
        if which == "dx":           # rows: x rows; columns: vocab
            hot = (cols[None, :] == lab[:, None]).float()
            p = torch.exp2((logits - lse[:, None]) * LOG2E)
            d = (p - hot) * g[:, None]
        else:                       # rows: vocab; columns: x rows
            rows = torch.arange(res.shape[0])
            hot = (rows[:, None] == lab[None, s0:s0 + tile]).float()
            p = torch.exp2((logits - lse[None, s0:s0 + tile]) * LOG2E)
            d = (p - hot) * g[None, s0:s0 + tile]
        acc += d.to(torch.bfloat16).float() @ st
    return acc.to(torch.bfloat16)


def _bf16_head(N, H, V, seed):
    """chip_smoke.py's inputs: x ~ N(0, 1), W ~ N(0, 0.02), g ~ N(0, 1),
    in bf16, with the plain forward's lse."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((N, H)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((V, H)) * 0.02, dtype=torch.float32)
    lab = torch.tensor(rng.integers(0, V, N))
    g = torch.tensor(rng.standard_normal(N), dtype=torch.float32)
    x, w = x.bfloat16(), w.bfloat16()
    lse, _ = tce.fused_ce_fwd_reference(x, w, lab)
    return x, w, lab, lse, g


@pytest.mark.parametrize("which", ["dx", "dw"])
def test_tensor_core_backward_emulation_within_the_bf16_row_gate(which):
    """At the slice's width (H = 2048: four ranks of 512 columns), the
    tensor-core kernels' order of sums and exp2, emulated on bf16 inputs,
    keeps the worst row of dx and dW within 2^-6 of the plain version's row
    RMS, while the same emulation with one 64-row tile left out fails it."""
    x, w, lab, lse, g = _bf16_head(256, 2048, 4096, seed=5)
    ref = (tce.fused_ce_bwd_dx_reference if which == "dx"
           else tce.fused_ce_bwd_dw_reference)(x, w, lab, lse, g)
    got = _tc_emulation(x, w, lab, lse, g, which)
    assert got.dtype == ref.dtype == torch.bfloat16
    assert _row_rel_err(got, ref) <= BF16_ROW_REL
    skip = int(lab[0]) // 64 * 64 if which == "dx" else 0
    cut = _tc_emulation(x, w, lab, lse, g, which, skip=skip)
    assert _row_rel_err(cut, ref) > BF16_ROW_REL


def test_tensor_core_operands_pad_h_and_copy_misaligned():
    """The bf16 kernels' operands: H zero-padded to a multiple of 8,
    aligned operands kept in place, a misaligned one copied."""
    x, w = torch.randn(5, 13).bfloat16(), torch.randn(7, 13).bfloat16()
    px, pw = tce._tc_operands(x, w)
    assert px.shape == (5, 16) and pw.shape == (7, 16)
    assert torch.equal(px[:, :13], x) and not px[:, 13:].any()
    assert torch.equal(pw[:, :13], w) and not pw[:, 13:].any()
    x, w = torch.randn(5, 16).bfloat16(), torch.randn(7, 16).bfloat16()
    kx, kw = tce._tc_operands(x, w)
    assert kx.data_ptr() == x.data_ptr() and kw.data_ptr() == w.data_ptr()
    buf = torch.zeros(5 * 16 + 1, dtype=torch.bfloat16)
    odd = buf[1:].view(5, 16)                   # 2 bytes off alignment
    assert odd.data_ptr() % 16 and odd.is_contiguous()
    kx, kw = tce._tc_operands(odd, w)
    assert kx.data_ptr() % 16 == 0 and torch.equal(kx, odd)
    assert kw.data_ptr() == w.data_ptr()


@pytest.mark.parametrize("which", ["dx", "dw"])
def test_zero_padded_hidden_is_the_same_function(which):
    """The bf16 route's zero padding of H is exact: the plain backward on
    the padded operands, cut back to H, equals it on the originals."""
    x, w, lab, lse, g = _bf16_head(40, 13, 90, seed=9)
    fn = (tce.fused_ce_bwd_dx_reference if which == "dx"
          else tce.fused_ce_bwd_dw_reference)
    px, pw = tce._tc_operands(x, w)
    plse, _ = tce.fused_ce_fwd_reference(px, pw, lab)
    assert torch.equal(plse, lse)
    got = fn(px, pw, lab, lse, g)
    assert not got[:, 13:].any()
    assert torch.equal(got[:, :13], fn(x, w, lab, lse, g))


# ---------------------------------------- the bf16 tensor-core forward

def _fwd_chunks(N, V, sms=132):
    """The forward kernel's vocabulary chunks on a card of `sms` SMs
    (`fwd_chunks`): one 128-row x 256-column CTA per SM, at most one chunk
    per tile."""
    return min(-(-V // 256), max(sms // -(-N // 128), 1))


def _fwd_tc_emulation(x, w, lab, chunks, skip=None):
    """The bf16 forward kernels' arithmetic (csrc/fused_linear_ce_fwd.cu
    `lce_fwd_mma_kernel`, `lce_fwd_combine_kernel`) in PyTorch: the vocab
    in `chunks` runs of 256-column tiles (as the kernel divides them); per
    tile the fp32 logits of the bf16 operands, columns >= V at -1e30, lab
    = the label column's logit, m_new = max(m, max(tile)), l = l 2^((m -
    m_new) log2 e) + sum 2^((tile - m_new) log2 e); the chunks' (m, l,
    lab) combined in chunk order, lse = m + log(max(l, 1e-30)). `skip`
    leaves out the tile that starts at that column."""
    N, V = x.shape[0], w.shape[0]
    T = -(-V // 256)
    logits = x.float() @ w.float().t()
    rows = torch.arange(N)
    parts = []
    for c in range(chunks):
        m = torch.full((N,), -1e30)
        l = torch.zeros(N)
        lb = torch.zeros(N)
        for t in range(c * T // chunks, (c + 1) * T // chunks):
            v0 = 256 * t
            if v0 == skip:
                continue
            tile = logits[:, v0:v0 + 256]
            hit = (lab >= v0) & (lab < v0 + tile.shape[1])
            lb = torch.where(hit, tile[rows, (lab - v0).clamp(0, tile.shape[1]
                                                                - 1)], lb)
            mn = torch.maximum(m, tile.amax(1))
            l = (l * torch.exp2((m - mn) * LOG2E)
                 + torch.exp2((tile - mn[:, None]) * LOG2E).sum(1))
            m = mn
        parts.append((m, l, lb))
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = sum(p[1] * torch.exp2((p[0] - m) * LOG2E) for p in parts)
    lse = m + torch.log(l.clamp_min(1e-30))
    return lse, sum(p[2] for p in parts)


@pytest.mark.parametrize("chunks", [1, 3, "kernel"])
def test_tensor_core_forward_emulation_matches_plain_and_jax(chunks,
                                                            monkeypatch):
    """At the slice's width (H = 2048) on bf16 inputs, the tensor-core
    forward's tile, chunk and combine order with exp2 keeps loss, lse and
    lab within the JAX tolerance of the plain forward and of JAX's Pallas
    forward (interpret mode); the same emulation with row 0's label tile
    left out does not."""
    N, H, V = 256, 2048, 4100
    x, w, lab, lse, _ = _bf16_head(N, H, V, seed=11)
    n = _fwd_chunks(N, V) if chunks == "kernel" else chunks
    got_lse, got_lab = _fwd_tc_emulation(x, w, lab, n)
    _, want_lab = tce.fused_ce_fwd_reference(x, w, lab)
    monkeypatch.setattr(jce, "_pallas_ok", lambda N, H: True)
    jloss, (_, _, _, jlse) = jce._lce_pallas_fwd(
        jnp.asarray(x.float().numpy(), jnp.bfloat16),
        jnp.asarray(w.float().numpy(), jnp.bfloat16),
        jnp.asarray(lab.numpy().astype(np.int32)))
    jlse = np.asarray(jlse)
    for a, b in ((got_lse, lse), (got_lab, want_lab),
                 (got_lse - got_lab, lse - want_lab),
                 (got_lse, jlse), (got_lse - got_lab, np.asarray(jloss))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **LOSS_TOL)
    cut_lse, cut_lab = _fwd_tc_emulation(x, w, lab, n,
                                         skip=int(lab[0]) // 256 * 256)
    assert not np.allclose((cut_lse - cut_lab).numpy(),
                           (lse - want_lab).numpy(), **LOSS_TOL)
