"""paddle_tpu_torch's per-block recompute on the CPU: a narrow GPT's loss
and every gradient with recompute equal those without, bit for bit, under
both ported policies, in fp32, pure bf16 and AMP O2; the flash forward
runs again in the backward while, under "dots_saveable", the matrix
products do not; the per-block flag never leaks out of a step; layers
without the per-block protocol recompute their whole forward; unported
policies raise."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode    # noqa: E402

import paddle_tpu_torch as ptt                                # noqa: E402
import paddle_tpu_torch.amp as tamp                           # noqa: E402
import paddle_tpu_torch.nn as tnn                             # noqa: E402
import paddle_tpu_torch.optimizer as topt                     # noqa: E402
from paddle_tpu_torch.core import device as tdevice           # noqa: E402
from paddle_tpu_torch.distributed.fleet import (              # noqa: E402
    DistributedStrategy, compile_train_step)
from paddle_tpu_torch.distributed.fleet.utils import (        # noqa: E402
    RECOMPUTE_POLICIES, recompute)
from paddle_tpu_torch.hapi import Model                       # noqa: E402
from paddle_tpu_torch.io import TensorDataset                 # noqa: E402
from paddle_tpu_torch.models.gpt import (GPT, GPTConfig,      # noqa: E402
                                         init_params_numpy)
from paddle_tpu_torch.ops.kernels import flash_attention as tfa  # noqa: E402

CFG = GPTConfig(vocab_size=300, max_seq_len=64, hidden=64, layers=2,
                heads=2)
OFF = "off"


@pytest.fixture(autouse=True)
def _cpu_and_flags(monkeypatch):
    """The CPU as the default device, and T=64 at or above the flash
    threshold, so attention takes the flash path (its plain versions)."""
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])
    old = ptt.get_flags("pallas_attention_min_seq")
    ptt.set_flags({"pallas_attention_min_seq": 64})
    yield
    ptt.set_flags({"pallas_attention_min_seq": old})


def _model(dtype=torch.float32, fused=None):
    cfg = dataclasses.replace(CFG, fused_head_ce=fused)
    return GPT(cfg).load_numpy(init_params_numpy(cfg, seed=2)).to(dtype)


def _batch(B=2, T=64, seed=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG.vocab_size, (B, T))
    return ids, np.roll(ids, -1, axis=1)


def _loss_and_grads(model, ids, labels, policy, level=None):
    if policy != OFF:
        model.enable_block_recompute(True, policy)
    try:
        with tamp.auto_cast(enable=level is not None, level=level or "O1",
                            dtype="bfloat16"):
            loss = model.loss(ids, labels)
        loss.backward()
    finally:
        model.enable_block_recompute(False)
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", ["dots_saveable", "nothing_saveable",
                                    None])
@pytest.mark.parametrize("mode", ["fp32", "bf16", "O2"])
def test_recompute_is_bit_exact(policy, mode):
    """The recomputed forward repeats the original op for op (the port's
    AMP state and the RNG state are restored for it), so the loss and
    every gradient are equal, not close."""
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    level = "O2" if mode == "O2" else None
    fused = True if mode == "bf16" else None
    ids, labels = _batch()
    base_loss, base = _loss_and_grads(_model(dtype, fused), ids, labels, OFF,
                                      level)
    loss, grads = _loss_and_grads(_model(dtype, fused), ids, labels, policy,
                                  level)
    assert torch.equal(loss, base_loss)
    assert grads.keys() == base.keys()
    for name, g in grads.items():
        assert g.dtype == base[name].dtype, name
        assert torch.equal(g, base[name]), name


class _CountDots(TorchDispatchMode):
    """Counts the matrix-product ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.dots = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm,
                                   torch.ops.aten.bmm):
            self.dots += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["dots_saveable", "nothing_saveable"])
def test_what_the_backward_recomputes(policy, monkeypatch):
    """Both policies run the flash forward again in the backward, once per
    block (the JAX package's `jax.checkpoint` recomputes its pallas_call);
    "dots_saveable" keeps every matrix product's output, so the backward
    runs exactly the products it runs without recompute, while
    "nothing_saveable" runs the blocks' forward products again."""
    calls = {"fwd": 0, "dq": 0}
    real_fwd, real_dq = tfa.flash_attention_forward, tfa.flash_attention_bwd_dq

    def fwd(*a, **k):
        calls["fwd"] += 1
        return real_fwd(*a, **k)

    def dq(*a, **k):
        calls["dq"] += 1
        return real_dq(*a, **k)

    monkeypatch.setattr(tfa, "flash_attention_forward", fwd)
    monkeypatch.setattr(tfa, "flash_attention_bwd_dq", dq)
    ids, labels = _batch()
    dots = {}
    for pol in (OFF, policy):
        model = _model()
        if pol != OFF:
            model.enable_block_recompute(True, pol)
        loss = model.loss(ids, labels)
        model.enable_block_recompute(False)
        calls.update(fwd=0, dq=0)
        with _CountDots() as counter:
            loss.backward()
        dots[pol] = counter.dots
        assert calls == {"fwd": 0 if pol == OFF else CFG.layers,
                         "dq": CFG.layers}, (pol, calls)
    if policy == "dots_saveable":
        assert dots[policy] == dots[OFF]
    else:
        assert dots[policy] > dots[OFF]


def _strategy(recompute=True, policy="dots_saveable"):
    s = DistributedStrategy()
    s.recompute = recompute
    s.recompute_configs.policy = policy
    return s


def test_compiled_step_sets_the_flag_around_its_forward_only(monkeypatch):
    """compile_train_step turns per-block recompute on for its own forward
    and restores the layer's flag after it, also when the forward
    raises; eager use of the layer never recomputes."""
    model = _model()
    seen = []
    real = model.loss

    def spy(*a):
        seen.append((model._recompute_blocks, model._recompute_policy))
        return real(*a)

    monkeypatch.setattr(model, "loss", spy)
    mom = topt.Momentum(1e-3, 0.9, parameters=model.parameters())
    prog = compile_train_step(model, mom, _strategy(), loss_method="loss")
    ids, labels = _batch()
    prog.step(ids, labels)
    assert seen == [(True, "dots_saveable")]
    assert not model._recompute_blocks and model._recompute_policy is None

    def boom(*a):
        raise KeyError("forward failed")

    monkeypatch.setattr(model, "loss", boom)
    model.enable_block_recompute(True, "nothing_saveable")
    prog = compile_train_step(model, mom, _strategy(), loss_method="loss")
    with pytest.raises(KeyError):
        prog.step(ids, labels)
    assert model._recompute_blocks and \
        model._recompute_policy == "nothing_saveable"


@pytest.mark.parametrize("policy", ["dots_saveable", "nothing_saveable"])
def test_compiled_steps_with_recompute_equal_steps_without(policy):
    """Three Momentum steps of the compiled step: losses and parameters
    equal bit for bit with and without recompute."""
    ids, labels = _batch(seed=9)
    out = []
    for rc in (False, True):
        model = _model()
        mom = topt.Momentum(1e-2, 0.9, parameters=model.parameters())
        prog = compile_train_step(model, mom, _strategy(rc, policy))
        losses = [prog.step(ids, labels) for _ in range(3)]
        out.append((losses, [p.detach() for p in model.parameters()]))
    (l0, p0), (l1, p1) = out
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert l0[-1] < l0[0]


class _LMLoss(tnn.Layer):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, ids, labels):
        return self.m.loss(ids, labels)


def test_hapi_fit_recomputes_the_whole_forward():
    """A layer without `enable_block_recompute` (hapi's loss adapter)
    recomputes its whole forward; the losses equal those without."""
    ids, labels = _batch(B=4, seed=11)
    losses = []
    for rc in (False, True):
        net = _LMLoss(_model())
        model = Model(net)
        model.prepare(topt.Momentum(1e-2, 0.9,
                                    parameters=model.parameters()),
                      strategy=_strategy(rc, "nothing_saveable"))
        out = [model.train_batch([ids[:2], labels[:2]])[0],
               model.train_batch([ids[2:], labels[2:]])[0]]
        losses.append(out)
    assert losses[0] == losses[1]


def test_unported_policies_raise():
    with pytest.raises(NotImplementedError, match="checkpoint_policy"):
        recompute(lambda t: t, torch.ones(1), checkpoint_policy="offload")
    assert RECOMPUTE_POLICIES == ("dots_saveable", "nothing_saveable", None)
    model = _model()
    mom = topt.Momentum(parameters=model.parameters())
    for policy in ("everything_saveable", "checkpoint_dots"):
        with pytest.raises(NotImplementedError, match="policy"):
            compile_train_step(model, mom, _strategy(True, policy))
    # the policy of a strategy without recompute is never read
    compile_train_step(model, mom, _strategy(False, "everything_saveable"))
