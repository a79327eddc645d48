"""benchmarks/run.py config 5's single-chip training path, ported, against
the JAX package on the CPU at a narrow size: `Momentum` (plain and
Nesterov, fp32 and bf16) against the JAX `Momentum`; `compile_train_step`
with the JAX call (`loss_method`, `mesh`, `_put_data`); `Layer.astype` /
`bfloat16()` / `float()`; and the whole sequence of run.py:240-294 —
`GPT(cfg(fused_head_ce=True))[.bfloat16()]`, `eval()`, `strategy.recompute
= True`, `Momentum`, `compile_train_step(model, mom, s,
loss_method="loss")`, `prog._put_data(ids)`, then `prog.step(ids, ids)`
three times — in both packages from the same numpy weights: hidden 128, 2
layers, 2 heads of 64, V=700, T=128 with `pallas_attention_min_seq`
lowered to 128 (flash attention on both sides: the JAX Pallas kernels in
interpret mode, the port's plain versions), B=2, with the JAX fused-CE
Pallas kernels forced on (`_pallas_ok`) as config 5 runs them on a TPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

import paddle_tpu as paddle                                   # noqa: E402
import paddle_tpu.optimizer as jopt                           # noqa: E402
from paddle_tpu.distributed.fleet.compiler import \
    compile_train_step as jcompile                            # noqa: E402
from paddle_tpu.distributed.fleet.strategy import \
    DistributedStrategy as JStrategy                          # noqa: E402
from paddle_tpu.models import GPT as JGPT                     # noqa: E402
from paddle_tpu.models.gpt import GPTConfig as JConfig        # noqa: E402
from paddle_tpu.ops.pallas import fused_ce as jce             # noqa: E402

import paddle_tpu_torch as ptt                                # noqa: E402
import paddle_tpu_torch.nn as tnn                             # noqa: E402
import paddle_tpu_torch.optimizer as topt                     # noqa: E402
from paddle_tpu_torch.core import device as tdevice           # noqa: E402
from paddle_tpu_torch.distributed.fleet.compiler import \
    compile_train_step                                        # noqa: E402
from paddle_tpu_torch.distributed.fleet.strategy import \
    DistributedStrategy                                       # noqa: E402
from paddle_tpu_torch.models import GPT, gpt3_1p3b            # noqa: E402
from paddle_tpu_torch.models.gpt import GPTConfig             # noqa: E402

NARROW = dict(vocab_size=700, max_seq_len=128, hidden=128, layers=2, heads=2,
              fused_head_ce=True)
B, T, LR = 2, 128, 1e-2

# fp32: the two packages differ by summation order only (~1e-6 relative
# per op), so after three steps the losses agree within 1e-5 and every
# parameter within 1e-5 of its largest value
F32_TOL = 1e-5
# bf16: the JAX CPU tests run at matmul precision "highest", where its
# Pallas kernels (flash attention, fused CE) keep P, dS and dlg in fp32;
# the port rounds them to bf16 as the TPU does at its default precision,
# and XLA may keep bf16 elementwise chains (gelu, residual adds) in fp32
# where each torch op rounds. Each such rounding is 2^-9 relative. The
# fp32 losses (near 6.5) were measured 6.2e-5, 2.1e-4 and 0 apart over the
# three steps; the gate is 2^-8 absolute, ~18x the worst. A gradient is a
# sum over the batch's 256 rows of such terms, so the two packages'
# gradients differ by about 2^-7 of their scale; a weight, dominated by
# its initial value, moved by under 2^-9 of its largest value (measured
# 3e-4 to 3e-3), but a bias, zero at the start, is three lr-scaled updates
# of its gradient and carries that difference (measured up to 1.6e-2 of
# its largest value): every parameter within 2^-5 of its largest value.
BF16_LOSS_TOL = 2.0 ** -8
BF16_PARAM_REL = 2.0 ** -5


@pytest.fixture(autouse=True)
def _cpu_and_flags(monkeypatch):
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])
    old_j = paddle.get_flags("pallas_attention_min_seq")
    old_t = ptt.get_flags("pallas_attention_min_seq")
    yield
    paddle.set_flags({"pallas_attention_min_seq": old_j})
    ptt.set_flags({"pallas_attention_min_seq": old_t})


# ------------------------------------------------------------- Momentum

def _grads(shapes, step, dtype):
    rng = np.random.default_rng(100 + step)
    return [(rng.standard_normal(s) * 0.5).astype(np.float32).astype(dtype)
            for s in shapes]


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_momentum_matches_jax(nesterov, dtype):
    """Three steps, the JAX side through `functional_update` with an fp32
    lr as its compiled step passes it. JAX returns the parameter of a bf16
    model as fp32 (its fp32 lr promotes `p - lr v`); the port updates the
    bf16 parameter in place, so the test rounds the JAX parameter back to
    bf16 after each step, as the port stores it."""
    shapes = [(7, 5), (11,)]
    rng = np.random.default_rng(1)
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jparams = {str(i): jnp.asarray(a).astype(jdt) for i, a in enumerate(init)}
    jm = jopt.Momentum(learning_rate=LR, momentum=0.9,
                       use_nesterov=nesterov)
    jstate = jm.functional_init(jparams)
    tparams = [torch.nn.Parameter(torch.tensor(a).to(tdt)) for a in init]
    tm = topt.Momentum(learning_rate=LR, momentum=0.9, parameters=tparams,
                       use_nesterov=nesterov)
    for step in range(3):
        gs = _grads(shapes, step, np.float32)
        jg = {str(i): jnp.asarray(g).astype(jdt) for i, g in enumerate(gs)}
        jparams, jstate = jm.functional_update(jparams, jg, jstate,
                                               lr=jnp.asarray(LR, jnp.float32))
        jparams = {k: v.astype(jdt) for k, v in jparams.items()}
        for p, g in zip(tparams, gs):
            p.grad = torch.tensor(g).to(tdt)
        tm.step()
    for i, p in enumerate(tparams):
        v = tm.state(p)["velocity"]
        assert p.dtype == v.dtype == tdt
        assert jstate[str(i)]["velocity"].dtype == jdt
        for got, want in ((p.detach(), jparams[str(i)]),
                          (v, jstate[str(i)]["velocity"])):
            want = np.asarray(want.astype(jnp.float32))
            got = got.float().numpy()
            if dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
            else:
                # XLA's CPU backend may keep a bf16 chain (`m v + g`,
                # Nesterov's `g + m v`) in fp32 where each torch op
                # rounds: under one bf16 ulp a step, which three steps
                # carry to at most two ulps, 2^-6 of a value just above a
                # power of two
                np.testing.assert_allclose(got, want, rtol=2.0 ** -6,
                                           atol=0)


def test_momentum_unported_options_raise(tmp_path):
    """Momentum's own options (multi_precision, weight_decay, grad_clip)
    are ported and held to the JAX package in tests/test_torch_lifecycle.py;
    what still raises around it is saving its state encrypted and
    restoring its slots onto a mesh."""
    from paddle_tpu_torch.framework import save as tsave
    from paddle_tpu_torch.io import checkpoint as tckpt
    p = [torch.nn.Parameter(torch.zeros(2))]
    p[0].grad = torch.ones(2)
    mom = topt.Momentum(parameters=p, multi_precision=True,
                        weight_decay=0.01)
    mom.step()
    with pytest.raises(NotImplementedError):
        tsave(mom.state_dict(), str(tmp_path / "m.pdopt"),
              cipher_key=b"k" * 32)
    tckpt.save_checkpoint(str(tmp_path / "step_0"), {"w": p[0]},
                          {"w": mom.state(p[0])})
    with pytest.raises(NotImplementedError):
        tckpt.load_checkpoint(str(tmp_path / "step_0"), mesh=object())


# -------------------------------------------------- compile_train_step

class _Net(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.lin = tnn.Linear(4, 3)
        self.register_buffer("scale", torch.ones(3))

    def forward(self, x):
        return (self.lin(x) * self.scale).sum()

    def objective(self, x):
        return self.forward(x) * 2


def test_compile_train_step_takes_the_jax_call():
    net = _Net()
    mom = topt.Momentum(1e-3, parameters=net.parameters())
    s = DistributedStrategy()
    with pytest.raises(NotImplementedError, match="mesh"):
        compile_train_step(net, mom, s, loss_method="loss", mesh=object())
    prog = compile_train_step(net, mom, s, loss_method="objective")
    assert prog.device == torch.device("cpu")     # where the params are
    x = prog._put_data(np.ones((2, 4), np.float32))
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    want = float(net.objective(x).detach())
    assert float(prog.step(x)) == pytest.approx(want)
    # loss_method=None: the layer itself is the loss
    prog = compile_train_step(net, mom, s, None, None, "cpu")
    want = float(net(x).detach())
    assert float(prog.step(x)) == pytest.approx(want, rel=1e-6)
    assert not hasattr(prog, "_put")


def test_gpt3_1p3b_is_config5s_model():
    """`from paddle_tpu_torch.models import GPT, gpt3_1p3b`, as run.py
    imports it: the JAX package's widths and parameter count (no weights
    are built: the count comes from the parameter shapes)."""
    from paddle_tpu.models import gpt3_1p3b as jgpt3_1p3b
    from paddle_tpu_torch.models.gpt import param_shapes
    cfg = gpt3_1p3b(fused_head_ce=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jgpt3_1p3b(fused_head_ce=True))
    n = sum(int(np.prod(s)) for s in param_shapes(cfg).values())
    assert n == 1_315_819_520
    assert 6 * n + 12 * cfg.layers * cfg.hidden * 2048 == 9_102_876_672


def test_layer_casts_follow_jax():
    """astype / bfloat16 / float cast every floating parameter and buffer
    in place and return the layer itself."""
    net = _Net()
    params = net.parameters()
    assert net.bfloat16() is net
    assert {t.dtype for t in list(net.parameters()) + list(net.buffers())} \
        == {torch.bfloat16}
    assert all(a is b for a, b in zip(params, net.parameters()))
    assert net.astype("float32") is net
    assert {t.dtype for t in list(net.parameters()) + list(net.buffers())} \
        == {torch.float32}
    assert net.astype(torch.bfloat16).float() is net
    assert net.lin.weight.dtype == torch.float32
    with pytest.raises(ValueError, match="float8"):
        net.astype("float8")


# ------------------------------------------------------------ the slice

def _jax_param(params, name):
    """A port parameter name's value in the JAX step's params (scan-stacked
    blocks.<rel> with a leading layer axis)."""
    if name in params:
        return params[name]
    _, i, rel = name.split(".", 2)
    return params[f"blocks.{rel}"][int(i)]


def _run_jax(arrays, ids, bf16, monkeypatch):
    """run.py:240-294 in the JAX package, with a one-device mesh (the
    tests' 8 virtual CPU devices would otherwise shard the batch)."""
    monkeypatch.setattr(jce, "_pallas_ok", lambda N, H: True)
    model = JGPT(JConfig(**NARROW))
    model.set_state_dict(arrays)
    if bf16:
        model = model.bfloat16()
    model.eval()
    s = JStrategy()
    s.recompute = True
    mom = jopt.Momentum(learning_rate=LR, momentum=0.9,
                        parameters=list(model.parameters()))
    prog = jcompile(model, mom, s, loss_method="loss",
                    mesh=s.build_mesh(jax.devices()[:1]))
    jids = prog._put_data(ids)
    losses = []
    for _ in range(3):
        losses.append(float(prog.step(jids, jids)))
        if bf16:     # see test_momentum_matches_jax
            prog.params = {k: v.astype(jnp.bfloat16)
                           for k, v in prog.params.items()}
    return losses, {k: np.asarray(v.astype(jnp.float32))
                    for k, v in prog.params.items()}


def _run_port(arrays, ids, bf16):
    """run.py:240-294 verbatim against paddle_tpu_torch."""
    model = GPT(GPTConfig(**NARROW)).load_numpy(arrays)
    if bf16:
        model = model.bfloat16()
    model.eval()
    s = DistributedStrategy()
    s.recompute = True
    mom = topt.Momentum(learning_rate=LR, momentum=0.9,
                        parameters=list(model.parameters()))
    prog = compile_train_step(model, mom, s, loss_method="loss")
    tids = prog._put_data(ids)
    losses = [float(prog.step(tids, tids)) for _ in range(3)]
    return losses, model, mom


@pytest.mark.parametrize("bf16", [False, True])
def test_config5_sequence_tracks_jax(bf16, monkeypatch):
    paddle.set_flags({"pallas_attention_min_seq": T})
    ptt.set_flags({"pallas_attention_min_seq": T})
    paddle.seed(0)
    jsrc = JGPT(JConfig(**NARROW))
    arrays = {k: np.asarray(v._data) for k, v in jsrc.state_dict().items()}
    ids = np.random.default_rng(0).integers(
        0, NARROW["vocab_size"], (B, T)).astype(np.int64)
    jl, jparams = _run_jax(arrays, ids, bf16, monkeypatch)
    tl, model, mom = _run_port(arrays, ids, bf16)
    want = torch.bfloat16 if bf16 else torch.float32
    assert {p.dtype for p in model.parameters()} == {want}
    assert {p.grad.dtype for p in model.parameters()} == {want}
    assert {mom.state(p)["velocity"].dtype for p in model.parameters()} \
        == {want}
    assert not model._recompute_blocks
    assert tl[-1] < tl[0]
    loss_tol = BF16_LOSS_TOL if bf16 else F32_TOL
    np.testing.assert_allclose(tl, jl, atol=loss_tol, rtol=0)
    rel = BF16_PARAM_REL if bf16 else F32_TOL
    for name, p in model.named_parameters():
        ref = _jax_param(jparams, name)
        scale = max(float(np.abs(ref).max()), 1e-6)
        err = float(np.abs(p.detach().float().numpy() - ref).max())
        assert err <= rel * scale, (name, err, scale)
