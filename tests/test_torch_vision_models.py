"""paddle_tpu_torch's vision models (benchmarks/run.py configs 1 and 2)
against the JAX package on the CPU, from one state_dict: LeNet and
ResNet-18 (B=4; 28x28 and 32x32): logits, loss, every gradient, then
three Momentum steps (the parameters, the batch-norm buffers, the losses)
and the eval-mode logits after them; NHWC against NCHW from the same
weights; resnet50()'s parameter and buffer names and count (no forward);
`.pdparams` crossing both ways with the batch-norm buffers; AMP O2
`compile_train_step` steps of a narrow ResNet against the JAX compiled
step; run.py's own `config1_lenet` and `config2_resnet50` bodies, in
smoke mode, run against the port.

The JAX models are built with a zero global initializer (no random
draws to compile) and loaded from the port's seeded weights."""
import importlib.util
import inspect
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

import paddle_tpu.nn as jnn                                   # noqa: E402
import paddle_tpu.nn.functional as JF                         # noqa: E402
import paddle_tpu.nn.initializer as JI                        # noqa: E402
import paddle_tpu.optimizer as jopt                           # noqa: E402
from paddle_tpu.core import random as jrandom                 # noqa: E402
from paddle_tpu.distributed.fleet.compiler import \
    compile_train_step as jcompile                            # noqa: E402
from paddle_tpu.distributed.fleet.strategy import \
    DistributedStrategy as JStrategy                          # noqa: E402
from paddle_tpu.framework import MethodAdapter, functional_call  # noqa: E402
from paddle_tpu.hapi import Model as JModel                   # noqa: E402
from paddle_tpu.vision import models as jmodels               # noqa: E402
from paddle_tpu.vision.models import resnet as jresnet        # noqa: E402

import paddle_tpu_torch as tp                                 # noqa: E402
import paddle_tpu_torch.nn as tnn                             # noqa: E402
import paddle_tpu_torch.nn.functional as TF                   # noqa: E402
import paddle_tpu_torch.optimizer as topt                     # noqa: E402
from paddle_tpu_torch import ops as tops                      # noqa: E402
from paddle_tpu_torch.core import device as tdevice           # noqa: E402
from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,  # noqa: E402
                                                compile_train_step)
from paddle_tpu_torch.hapi import Model as TModel             # noqa: E402
from paddle_tpu_torch.vision import models as tmodels         # noqa: E402
from paddle_tpu_torch.vision.models import resnet as tresnet  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fp32 through two frameworks: summation order only. LeNet holds to the
# tolerances of tests/test_torch_vision_ops.py.
OUT_REL = 1e-5
GRAD_REL = 1e-4
# ResNet-18 at B=4, 32x32 normalizes layer4's 1x1 maps over 4 values,
# and fp32 rounding is amplified there: against a float64 evaluation (a
# float64 batch norm), the JAX package's own gradients are more than
# GRAD_REL of a leaf's largest off (2.4e-4, layer4.0.conv1.weight; its
# logits 1.4e-5), the port's as far (2.6e-4; 9.7e-6): `_hold_to_float64`
# checks both. The two packages hold each other to these tolerances,
# with room for the sum of both errors.
RESNET_OUT_REL = 5e-5
RESNET_GRAD_REL = 1e-3
# three Momentum steps at MOM_LR[model] (the losses fall at each step):
# each parameter's update p - p0 against JAX's by norm, and the
# batch-norm buffers and eval logits as a fraction of their largest
# value. ResNet-18 at B=4 takes its loss from ~2 to ~0.3 in three steps
# even at lr 1e-4 and carries rounding forward: the card against the CPU
# (chip_smoke.py phase 14, NHWC), rounding apart only, differ by 8.3e-3,
# 8.0e-4 and 4.2e-4 of these.
MOM_LR = {"lenet": 1e-3, "resnet18": 1e-4}
STEP_REL = 0.05
BUFFER_REL = 1e-2
EVAL_REL = 1e-2
# AMP O2: each leaf's update by norm, 1/10 of it (tests/test_torch_bert.py)
O2_LR = 0.02
O2_STEPS = 3
O2_UPDATE_REL = 0.1


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])


class _Zeros:
    """A global initializer for the JAX models: zeros as numpy arrays,
    so that building a model compiles no random draws (the weights are
    then loaded from the port's)."""

    def __call__(self, shape, dtype):
        return np.zeros(shape, np.float32)


def _jax_model(ctor, state):
    JI.set_global_initializer(_Zeros(), _Zeros())
    try:
        model = ctor(jnn, jmodels)
    finally:
        JI.set_global_initializer(None, None)
    model.set_state_dict(state)
    return model


def _pair(ctor, seed=0):
    """(JAX model, port model, the state_dict they share as numpy): the
    port's seeded weights loaded into both."""
    tp.seed(seed)
    tm = ctor(tnn, tmodels)
    sd = {k: v.detach().numpy().copy() for k, v in tm.state_dict().items()}
    jm = _jax_model(ctor, sd)
    assert sorted(jm.state_dict()) == sorted(sd)
    return jm, tm, sd


def _with_loss(nn, F, net):
    """`net` with `loss(x, y)` (the CE of its logits) and `both(x, y)`
    (loss and logits), as a layer whose parameters are net.*"""
    class WithLoss(nn.Layer):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, x):
            return self.net(x)

        def loss(self, x, y):
            return F.cross_entropy(self.net(x), y)

        def both(self, x, y):
            logits = self.net(x)
            return F.cross_entropy(logits, y), logits
    return WithLoss()


def _close(t, j, rel, what):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    err = float(np.abs(t - j).max())
    scale = max(float(np.abs(j).max()), 1e-30)
    assert err <= rel * scale, (what, err, scale)


def _jax_grads(jw, x, y):
    """(loss, logits, {name: grad}) of the JAX layer `jw` (a _with_loss)
    in training mode, by jax.grad around functional_call."""
    params = {n: p._data for n, p in jw.named_parameters()}
    state = {n: b._data for n, b in jw.named_buffers()}

    def f(p):
        (loss, logits), _ = functional_call(MethodAdapter(jw, "both"), p,
                                            state, jnp.asarray(x),
                                            jnp.asarray(y))
        return loss, logits
    jw.train()
    (loss, logits), g = jax.value_and_grad(f, has_aux=True)(params)
    return float(loss), np.asarray(logits), \
        {n: np.asarray(v) for n, v in g.items()}


def _jax_momentum_steps(jw, x, y, steps, lr):
    """`steps` steps of the JAX compiled train step (fp32, Momentum at
    `lr`, one-device mesh): (losses, params, buffers, eval logits)."""
    s = JStrategy()
    prog = jcompile(jw, jopt.Momentum(learning_rate=lr,
                                      parameters=list(jw.parameters())), s,
                    mesh=s.build_mesh(jax.devices()[:1]))
    jx, jy = prog._put_data(x), prog._put_data(y)
    losses = [float(prog.step(jx, jy)) for _ in range(steps)]
    jw.eval()
    logits, _ = jax.jit(lambda p, st, a: functional_call(jw, p, st, a))(
        prog.params, prog.state, jnp.asarray(x))
    return (losses, {k: np.asarray(v) for k, v in prog.params.items()},
            {k: np.asarray(v) for k, v in prog.state.items()},
            np.asarray(logits))


def _bn64(x, running_mean, running_var, weight=None, bias=None,
          training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
          use_global_stats=None):
    """Training-mode batch norm in the input's dtype (float64 here): the
    reference of `_hold_to_float64`; the buffers are left alone."""
    dims = [0, 2, 3]
    mean, var = x.mean(dims), x.var(dims, unbiased=False)
    shape = [1, -1, 1, 1]
    return (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + epsilon) \
        * weight.view(shape) + bias.view(shape)


def _hold_to_float64(ctor, sd, x, y, jlogits, jg, tlogits, tg):
    """Why ResNet-18 holds RESNET_OUT_REL / RESNET_GRAD_REL: the same
    network in float64 (a float64 batch norm) puts the JAX package's own
    fp32 gradients more than GRAD_REL of a leaf's largest off somewhere,
    while both packages stay within the ResNet tolerances of it."""
    import paddle_tpu_torch.nn.functional as fmod
    real = fmod.batch_norm
    fmod.batch_norm = _bn64
    try:
        net = _with_loss(tnn, TF, ctor(tnn, tmodels))
        net.net.set_state_dict(sd)
        net.double().train()
        loss, logits = net.both(torch.from_numpy(x).double(),
                                torch.from_numpy(y))
        loss.backward()
    finally:
        fmod.batch_norm = real
    ref = {n: p.grad.numpy() for n, p in net.named_parameters()}
    logits = logits.detach().numpy()
    for got in (jlogits, tlogits.detach().numpy()):
        _close(got, logits, RESNET_OUT_REL, "logits vs float64")
    worst = {}
    for pkg, grads in (("jax", jg), ("port", tg)):
        worst[pkg] = 0.0
        for n, g in ref.items():
            _close(grads[n], g, RESNET_GRAD_REL, f"{pkg} {n} vs float64")
            err = float(np.abs(grads[n] - g).max() / np.abs(g).max())
            worst[pkg] = max(worst[pkg], err)
    assert worst["jax"] > GRAD_REL, worst


def _lenet(nn, models):
    return models.LeNet()


def _resnet18(nn, models, data_format="NCHW"):
    return models.resnet18(num_classes=10, data_format=data_format)


def _data(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32), \
        rng.integers(0, 10, (shape[0], 1)).astype(np.int64)


@pytest.mark.parametrize("name", ["lenet", "resnet18"])
def test_model_matches_jax_and_three_momentum_steps(name):
    """Logits, loss and every gradient of one training forward; then
    three Momentum steps of each package's compiled step from the same
    weights: the losses (falling), each parameter's update, the
    batch-norm buffers, and the eval-mode logits after the steps."""
    ctor, shape = {"lenet": (_lenet, (4, 1, 28, 28)),
                   "resnet18": (_resnet18, (4, 3, 32, 32))}[name]
    out_rel, grad_rel = (OUT_REL, GRAD_REL) if name == "lenet" \
        else (RESNET_OUT_REL, RESNET_GRAD_REL)
    jm, tm, sd = _pair(ctor)
    x, y = _data(shape)
    jw, tw = _with_loss(jnn, JF, jm), _with_loss(tnn, TF, tm)

    jl, jlogits, jg = _jax_grads(jw, x, y)
    tw.train()
    tl, tlogits = tw.both(torch.from_numpy(x), torch.from_numpy(y))
    tl.backward()
    assert abs(float(tl.detach()) - jl) <= out_rel * abs(jl), (tl, jl)
    _close(tlogits.detach().numpy(), jlogits, out_rel, "logits")
    tg = {n: p.grad.numpy() for n, p in tw.named_parameters()}
    assert sorted(tg) == sorted(jg)
    for n in jg:
        _close(tg[n], jg[n], grad_rel, n)
    if name == "resnet18":
        _hold_to_float64(ctor, sd, x, y, jlogits, jg, tlogits, tg)

    # three steps from the same weights and buffers (functional_call
    # left the JAX model's own as they were)
    jlosses, jparams, jbufs, jeval = _jax_momentum_steps(jw, x, y, 3,
                                                         MOM_LR[name])
    tm.set_state_dict(sd)
    p0 = {n: p.detach().numpy().copy() for n, p in tw.named_parameters()}
    prog = compile_train_step(tw, topt.Momentum(
        learning_rate=MOM_LR[name], parameters=list(tw.parameters())),
        DistributedStrategy())
    tlosses = [float(prog.step(x, y)) for _ in range(3)]
    assert all(b < a for a, b in zip(tlosses, tlosses[1:])), tlosses
    np.testing.assert_allclose(tlosses, jlosses, rtol=STEP_REL)
    for n, p in tw.named_parameters():
        dj = jparams[n] - p0[n]
        err = np.linalg.norm(p.detach().numpy() - p0[n] - dj)
        assert err <= STEP_REL * np.linalg.norm(dj), (n, err)
    bufs = dict(tw.named_buffers())
    assert sorted(bufs) == sorted(jbufs)
    for n, b in bufs.items():
        _close(b.numpy(), jbufs[n], BUFFER_REL, n)
        if n.endswith("_variance"):      # the three updates moved it
            assert np.abs(b.numpy() - 1.0).max() > 1e-2, n
    tw.eval()
    with torch.no_grad():
        teval = tw(torch.from_numpy(x)).numpy()
    _close(teval, jeval, EVAL_REL, "eval logits")


def test_nhwc_equals_nchw():
    """ResNet-18 in NHWC from the NCHW model's state_dict (the same
    arrays): logits, loss, every gradient and the batch-norm buffers
    after the call equal the NCHW model's on the transposed input."""
    tp.seed(1)
    nchw = _resnet18(tnn, tmodels)
    nhwc = _resnet18(tnn, tmodels, data_format="NHWC")
    assert nhwc.set_state_dict(nchw.state_dict()) == ([], [])
    x, y = _data((4, 3, 32, 32), seed=3)
    res = []
    for m, a in ((nchw, x), (nhwc, x.transpose(0, 2, 3, 1).copy())):
        m.train()
        logits = m(torch.from_numpy(a))
        loss = TF.cross_entropy(logits, torch.from_numpy(y))
        loss.backward()
        res.append((float(loss), logits.detach().numpy(),
                    {n: p.grad.numpy() for n, p in m.named_parameters()},
                    {n: b.numpy() for n, b in m.named_buffers()}))
    (l0, o0, g0, b0), (l1, o1, g1, b1) = res
    assert abs(l1 - l0) <= RESNET_OUT_REL * abs(l0)
    _close(o1, o0, RESNET_OUT_REL, "logits")
    for n in g0:
        _close(g1[n], g0[n], RESNET_GRAD_REL, n)
    for n in b0:
        _close(b1[n], b0[n], OUT_REL, n)


def test_resnet50_names_and_count():
    """resnet50()'s parameter and buffer names, shapes and parameter
    count equal the JAX package's (no forward pass); pretrained raises
    in both."""
    JI.set_global_initializer(_Zeros(), _Zeros())
    try:
        jm = jmodels.resnet50()
    finally:
        JI.set_global_initializer(None, None)
    tm = tmodels.resnet50()
    js = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    ts = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert ts == js
    jn = sum(int(np.prod(p.shape)) for p in jm.parameters())
    tn = sum(p.numel() for p in tm.parameters())
    assert tn == jn == 25_557_032
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert [n for n, _ in tm.named_buffers()] == \
        [n for n, _ in jm.named_buffers()]
    for mod in (jmodels, tmodels):
        with pytest.raises(NotImplementedError, match="pretrained"):
            mod.resnet18(pretrained=True)
    assert isinstance(tm.layer1[0], tresnet.BottleneckBlock)
    assert isinstance(tmodels.resnet34().layer1[0], tresnet.BasicBlock)


def _narrow(nn, res, F, flatten):
    """A narrow ResNet of the zoo's blocks (a BasicBlock, then a strided
    BottleneckBlock with a downsample), with `loss(x, y)`."""
    class Narrow(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2D(3, 8, 3, padding=1, bias_attr=False)
            self.bn1 = nn.BatchNorm2D(8)
            self.relu = nn.ReLU()
            self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
            ds = nn.Sequential(nn.Conv2D(8, 16, 1, stride=2,
                                         bias_attr=False),
                               nn.BatchNorm2D(16))
            self.layer1 = nn.Sequential(
                res.BasicBlock(8, 8),
                res.BottleneckBlock(8, 4, stride=2, downsample=ds))
            self.avgpool = nn.AdaptiveAvgPool2D(1)
            self.fc = nn.Linear(16, 10)

        def forward(self, x):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            return self.fc(flatten(self.avgpool(self.layer1(x))))

        def loss(self, x, y):
            return F.cross_entropy(self(x), y)
    return Narrow()


def _o2(strategy):
    strategy.amp = True
    strategy.amp_configs.use_pure_bf16 = True
    return strategy


def test_o2_compiled_step_tracks_jax():
    """O2_STEPS AMP O2 (pure bf16) steps of compile_train_step(net,
    Momentum, strategy) in both packages from one set of weights: the
    losses fall in both, each leaf's update p - p0 is within 1/10 of
    JAX's by norm, and the batch-norm buffers within 1/10 of JAX's
    change.

    The JAX step is its own compiled function, compiled with XLA's
    xla_allow_excess_precision off: by default XLA:CPU drops the bf16
    roundings between the ops it fuses, so its compiled O2 step is not
    its eager O2 step (which rounds at every op, as the port does), and
    on this batch-norm net the two differ by more than this test's
    tolerance."""
    tp.seed(2)
    tm = _narrow(tnn, tresnet, TF, lambda t: tops.flatten(t, 1))
    sd = {k: v.detach().numpy().copy() for k, v in tm.state_dict().items()}
    jm = _jax_model(lambda nn, _: _narrow(nn, jresnet, JF,
                                          lambda t: t.flatten(1)), sd)
    x, y = _data((8, 3, 16, 16), seed=4)
    y = y[:, 0]

    s = _o2(JStrategy())
    jprog = jcompile(jm, jopt.Momentum(learning_rate=O2_LR,
                                       parameters=list(jm.parameters())), s,
                     mesh=s.build_mesh(jax.devices()[:1]))
    data = (jprog._put_data(x), jprog._put_data(y))
    args = (jprog.params, jprog.state, jprog.opt_state,
            jrandom.next_key(), jnp.asarray(O2_LR, jnp.float32), data)
    jprog._aot = jprog._step.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    jl = [float(jprog.step(*data)) for _ in range(O2_STEPS)]
    jparams = {k: np.asarray(v.astype(jnp.float32))
               for k, v in jprog.params.items()}
    jbufs = {k: np.asarray(v) for k, v in jprog.state.items()}

    p0 = {n: p.detach().numpy().copy() for n, p in tm.named_parameters()}
    prog = compile_train_step(tm, topt.Momentum(
        learning_rate=O2_LR, parameters=list(tm.parameters())),
        _o2(DistributedStrategy()))
    raw = [prog.step(x, y) for _ in range(O2_STEPS)]
    tl = [float(r) for r in raw]
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    assert all(b < a for a, b in zip(tl, tl[1:])), tl
    assert all(b < a for a, b in zip(jl, jl[1:])), jl
    for n, p in tm.named_parameters():
        dj = jparams[n] - p0[n]
        dt = p.detach().numpy() - p0[n]
        err, size = float(np.linalg.norm(dt - dj)), float(np.linalg.norm(dj))
        assert err <= O2_UPDATE_REL * size, (n, err, size)
    for n, b in tm.named_buffers():
        b0 = sd[n]
        err = float(np.linalg.norm(b.numpy() - jbufs[n]))
        size = float(np.linalg.norm(jbufs[n] - b0))
        assert err <= O2_UPDATE_REL * size, (n, err, size)


def test_pdparams_cross_both_ways(tmp_path):
    """A ResNet-18 `.pdparams` written by either package's Model.save
    loads into the other's Model.load: parameters and the batch-norm
    buffers, bit for bit."""
    jm, tm, sd = _pair(_resnet18, seed=5)
    # give the buffers values of their own
    rng = np.random.default_rng(6)
    bufs = {n: rng.uniform(0.5, 2.0, b.shape).astype(np.float32)
            for n, b in tm.named_buffers()}
    tm.set_state_dict(bufs)
    TModel(tm).save(str(tmp_path / "port"))
    jm2 = _jax_model(_resnet18, {k: np.zeros_like(v) for k, v in sd.items()})
    JModel(jm2).load(str(tmp_path / "port"))
    for k, v in jm2.state_dict().items():
        np.testing.assert_array_equal(np.asarray(v.numpy()),
                                      {**sd, **bufs}[k], err_msg=k)
    jm.set_state_dict({k: v[::-1].copy() if v.ndim == 1 else v
                       for k, v in bufs.items()})
    JModel(jm).save(str(tmp_path / "jax"))
    tp.seed(9)
    tm2 = tmodels.resnet18(num_classes=10)
    TModel(tm2).load(str(tmp_path / "jax"))
    want = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    got = {k: v.numpy() for k, v in tm2.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------- run.py's own bodies

def _run_py_body(name, n_paddle, n_import_jax, n_devices):
    """benchmarks/run.py's `name` function with the JAX package's
    imports pointed at paddle_tpu_torch, `import jax` dropped and
    `jax.devices()` replaced by the port's devices, nothing else changed,
    defined in run.py's own module namespace (its _timed_steps, _emit)."""
    spec = importlib.util.spec_from_file_location(
        "_run_py", os.path.join(ROOT, "benchmarks", "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    src = inspect.getsource(getattr(run, name))
    body, n = re.subn(r"\bpaddle_tpu\b", "paddle_tpu_torch", src)
    assert n == n_paddle, n
    body, n = re.subn(r"^\s*import jax\n", "", body, flags=re.M)
    assert n == n_import_jax, n
    body, n = re.subn(r"\bjax\.devices\(\)", "port_devices()", body)
    assert n == n_devices, n
    assert not re.search(r"\bjax\b", body)
    ns = dict(vars(run))
    ns["port_devices"] = lambda: [tdevice.default_device()]
    exec(compile(body, f"run.py:{name}", "exec"), ns)
    return ns[name]


def _record(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_run_py_config1_body_runs_against_the_port(capsys):
    """run.py config 1 in smoke mode (LeNet, n=256, B=64): Model(LeNet())
    + Adam + CrossEntropyLoss, two `fit` epochs of TensorDataset([x, y])
    with [n, 1] int64 labels, and its samples/s record."""
    _run_py_body("config1_lenet", 6, 0, 0)(True)
    rec = _record(capsys)
    assert rec["config"] == "1_mnist_lenet_fit" and rec["unit"] == \
        "samples/s" and rec["value"] > 0


def test_run_py_config2_body_runs_against_the_port(capsys):
    """run.py config 2 in smoke mode (resnet18 at B=4, 32x32, fp32): the
    Wrap layer's loss, Momentum(0.1), compile_train_step over
    `s.build_mesh(devices=...)` of the port's device, `prog._put_data`
    and run.py's `_timed_steps`, and its images/s record."""
    _run_py_body("config2_resnet50", 7, 1, 1)(True)
    rec = _record(capsys)
    assert rec["config"] == "2_resnet18_smoke" and rec["unit"] == \
        "images/s" and rec["value"] > 0
    assert rec["data_format"] == "NCHW" and rec["batch"] == 4
