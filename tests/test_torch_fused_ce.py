"""paddle_tpu_torch's fused linear cross-entropy against the JAX package, on
the CPU: the plain versions of the three kernels (`ops/kernels/fused_ce.py`)
against the JAX package's Pallas kernels (`ops/pallas/fused_ce.py`) run in
interpret mode with `_pallas_ok` forced on, as tests/test_pallas_kernels.py
runs them, at the JAX tests' tolerances (rtol 1e-4 / atol 1e-4 for loss,
lse and lab; rtol 2e-3 / atol 1e-5 for dx and dW); ragged shapes against
a float64 numpy reference; and `linear_cross_entropy`'s routing (fused=
True / None / False, the V >= 65536 rule, the CPU, a device with no
kernel)."""
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
    assert tce.max_hidden(torch.bfloat16) == 2400
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
        tce._kernel_fn("fused_linear_ce_fwd", "fused_linear_ce_fwd", 5)
    assert "fused_linear_ce_fwd" in _build.sources()
    assert "fused_linear_ce_bwd" in _build.sources()
