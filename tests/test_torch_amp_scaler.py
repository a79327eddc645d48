"""paddle_tpu_torch's dynamic loss scaling (`amp.GradScaler`) and pure
fp16 decoration (`amp.decorate`) against the JAX package's on the CPU:
tests/test_amp_io_metric.py's scaler tests replayed on the port; a
LeNet float16 O2 run through `decorate` + `GradScaler` in both packages
from one set of numpy weights (the same overflow sequence, the same
scales, parameters within a tolerance below a step's update); the
update rule, `state_dict`, `decorate`'s return forms, `minimize` after
a `backward` refused in both packages; and the `Parameter` / `Tensor`
method split that loss scaling's users meet (`torch.nn.init` on a
`Parameter`)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp                                       # noqa: E402
import paddle_tpu.amp as jamp                                 # noqa: E402
import paddle_tpu.nn as jnn                                   # noqa: E402
import paddle_tpu.nn.functional as JF                         # noqa: E402
import paddle_tpu.nn.initializer as JI                        # noqa: E402
import paddle_tpu.optimizer as jopt                           # noqa: E402
from paddle_tpu.vision import models as jmodels               # noqa: E402

import paddle_tpu_torch as tp                                 # noqa: E402
import paddle_tpu_torch.amp as tamp                           # noqa: E402
import paddle_tpu_torch.nn as tnn                             # noqa: E402
import paddle_tpu_torch.nn.functional as TF                   # noqa: E402
import paddle_tpu_torch.optimizer as topt                     # noqa: E402
from paddle_tpu_torch.core import device as tdevice           # noqa: E402
from paddle_tpu_torch.vision import models as tmodels         # noqa: E402

# The LeNet parity run. From 2^24 the scale must fall below LeNet's
# fp16 overflow point (2^17 for these weights and inputs, in both
# packages) inside six iterations, so it backs off by 1/8 after each
# overflow (paddle's default 1/2 would need nine): 2^24, 2^21 and 2^18
# overflow, 2^15 does not, which leaves one exponent of margin on each
# side of the overflow point.
SEED, X_SCALE, LR, ITERS = 1, 0.25, 0.1, 6
SCALER = dict(init_loss_scaling=2.0 ** 24, decr_ratio=0.125,
              decr_every_n_nan_or_inf=1)
# The two packages' fp16 convolutions and products round differently
# (a few fp16 ulps of a parameter, 2.4e-4 at 0.5, after three updates);
# the smallest update of a parameter in a step that was not skipped is
# 6.9e-3 (checked below, from the JAX run), so this tolerance tells a
# skipped or a wrong step from a taken one.
PARAM_TOL = 2e-3


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])


# -- tests/test_amp_io_metric.py's scaler tests on the port --------------------

def test_grad_scaler_scales_and_unscales():
    w = tp.to_tensor(np.ones(2, np.float32), stop_gradient=False)
    w.persistable = True
    sgd = topt.SGD(learning_rate=0.1, parameters=[w])
    scaler = tamp.GradScaler(init_loss_scaling=128.0,
                             use_dynamic_loss_scaling=False)
    loss = tp.sum(w * 2.0)
    scaler.scale(loss).backward()
    np.testing.assert_allclose(w.grad.numpy(), [256.0, 256.0])
    scaler.step(sgd)
    # after unscale, true grad 2.0 -> w = 1 - 0.2
    np.testing.assert_allclose(w.numpy(), [0.8, 0.8], rtol=1e-6)


def test_grad_scaler_skips_on_inf():
    w = tp.to_tensor(np.ones(1, np.float32), stop_gradient=False)
    w.persistable = True
    sgd = topt.SGD(learning_rate=0.1, parameters=[w])
    scaler = tamp.GradScaler(init_loss_scaling=4.0,
                             decr_every_n_nan_or_inf=1)
    loss = tp.sum(w * float("inf"))
    scaler.scale(loss).backward()
    scaler.step(sgd)
    scaler.update()
    np.testing.assert_allclose(w.numpy(), [1.0])  # update skipped
    assert scaler.get_loss_scaling() < 4.0        # scale backed off


def test_fused_unscale_single_sync(monkeypatch):
    """unscale_ reads one flag from the device for the whole parameter
    set (counted: every Tensor.item in the call), and flags inf."""
    tp.seed(0)
    lin = tnn.Linear(4, 4)
    sgd = topt.SGD(learning_rate=0.1, parameters=list(lin.parameters()))
    scaler = tamp.GradScaler(init_loss_scaling=4.0)
    x = tp.to_tensor(np.ones((2, 4), np.float32))
    loss = scaler.scale(lin(x).mean())
    loss.backward()
    reads = []
    item = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda t, *a: reads.append(1) or item(t, *a))
    scaler.unscale_(sgd)
    assert scaler._found_inf is False and len(reads) == 1
    g = lin.weight.grad.numpy()
    assert np.all(np.isfinite(g))

    # poison one grad -> found_inf with the same single-read path
    lin.weight.grad.fill_(float("inf"))
    scaler._unscaled.clear()
    scaler.unscale_(sgd)
    assert scaler._found_inf is True and len(reads) == 2


# -- the port against the JAX package -----------------------------------------

class _Zeros:
    def __call__(self, shape, dtype):
        return np.zeros(shape, np.float32)


def _lenets():
    """(JAX LeNet, port LeNet, their shared numpy state_dict)."""
    tp.seed(SEED)
    tm = tmodels.LeNet()
    sd = {k: v.detach().numpy().copy() for k, v in tm.state_dict().items()}
    JI.set_global_initializer(_Zeros(), _Zeros())
    try:
        jm = jmodels.LeNet()
    finally:
        JI.set_global_initializer(None, None)
    jm.set_state_dict(sd)
    return jm, tm, sd


def _o2_run(P, F, amp, opt, model, x, y):
    """paddle's float16 O2 loop for ITERS iterations: found_inf after each
    step, the scale after each update, the parameters (float64) after
    each iteration, the losses, and the decorated model and optimizer."""
    o = opt.Momentum(learning_rate=LR, parameters=model.parameters())
    model, o = amp.decorate(model, o, level="O2", dtype="float16")
    scaler = amp.GradScaler(**SCALER)
    xs, ys = P.to_tensor(x), P.to_tensor(y)
    found, scales, params, losses = [], [], [], []
    for _ in range(ITERS):
        with amp.auto_cast(level="O2", dtype="float16"):
            loss = F.cross_entropy(model(xs), ys)
        scaler.scale(loss).backward()
        scaler.step(o)
        found.append(bool(scaler._found_inf))
        scaler.update()
        scales.append(scaler.get_loss_scaling())
        o.clear_grad()
        losses.append(float(np.asarray(loss.numpy())))
        params.append({k: np.asarray(v.numpy(), np.float64)
                       for k, v in model.named_parameters()})
    return found, scales, params, losses, model, o


def _rule(found, init, incr, decr, incr_every, decr_every):
    """The scale after each update, from the found_inf sequence alone."""
    scale, good, bad, out = init, 0, 0, []
    for f in found:
        if f:
            bad, good = bad + 1, 0
            if bad >= decr_every:
                scale, bad = max(scale * decr, 1.0), 0
        else:
            good, bad = good + 1, 0
            if good >= incr_every:
                scale, good = scale * incr, 0
        out.append(scale)
    return out


def test_lenet_float16_o2_matches_jax():
    jm, tm, sd = _lenets()
    rng = np.random.default_rng(3)
    x = (X_SCALE * rng.standard_normal((8, 1, 28, 28))).astype(np.float32)
    y = rng.integers(0, 10, (8, 1)).astype(np.int64)
    jf, js, jps, jl, _, _ = _o2_run(jp, JF, jamp, jopt, jm, x, y)
    tf, ts, tps, tl, tm, topt_ = _o2_run(tp, TF, tamp, topt, tm, x, y)
    assert tf == jf == [True, True, True, False, False, False]
    assert ts == js == _rule(jf, 2.0 ** 24, 2.0, 0.125, 1000, 1)
    # decorate: every parameter float16 (the same objects the optimizer
    # holds), fp32 masters in the optimizer
    assert {p.dtype for p in tm.parameters()} == {torch.float16}
    assert [id(p) for p in topt_._parameter_list] == \
        [id(p) for p in tm.parameters()]
    assert {m.dtype for m in topt_._master.values()} == {torch.float32}
    assert len(topt_._master) == len(sd)
    start = {k: v.astype(np.float16).astype(np.float64)
             for k, v in sd.items()}
    smallest = np.inf
    for i, skipped in enumerate(jf):
        before = jps[i - 1] if i else start
        for k in sd:
            change = np.abs(jps[i][k] - before[k]).max()
            if skipped:
                # a skipped step leaves the parameters bit-equal
                assert change == 0.0 and np.array_equal(
                    tps[i][k], (tps[i - 1] if i else start)[k]), (i, k)
            else:
                smallest = min(smallest, change)
            err = np.abs(tps[i][k] - jps[i][k]).max()
            assert err <= PARAM_TOL, (i, k, err)
    assert PARAM_TOL < smallest, smallest
    assert tl[-1] < tl[0] and jl[-1] < jl[0]
    np.testing.assert_allclose(tl, jl, rtol=2e-3)


def test_scaler_update_rule_and_state_dict():
    """Growth after incr_every_n_steps good steps, back-off floored at 1,
    a disabled scaler passing the loss through; state_dict keys and
    load_state_dict as in the JAX package."""
    for amp in (jamp, tamp):
        s = amp.GradScaler(init_loss_scaling=4.0, incr_every_n_steps=2,
                           decr_every_n_nan_or_inf=1, decr_ratio=0.1)
        seq = [False, False, True, True, False]
        got = []
        for f in seq:
            s._found_inf = f
            s.update()
            got.append(s.get_loss_scaling())
        assert got == _rule(seq, 4.0, 2.0, 0.1, 2, 1) == \
            [4.0, 8.0, 1.0, 1.0, 1.0]
        state = s.state_dict()
        fresh = amp.GradScaler()
        fresh.load_state_dict(state)
        assert fresh.state_dict() == dict(state, incr_ratio=2.0,
                                          decr_ratio=0.5,
                                          incr_every_n_steps=1000,
                                          decr_every_n_nan_or_inf=2)
        off = amp.GradScaler(enable=False)
        assert off.scale(3.0) == 3.0 and not off.is_enable()
    assert sorted(jamp.GradScaler().state_dict()) == \
        sorted(tamp.GradScaler().state_dict())
    assert jamp.GradScaler().state_dict() == tamp.GradScaler().state_dict()


def test_unscale_twice_is_one_unscale():
    """step() after a user's unscale_ (unscale, clip, step) divides by the
    scale once; the next scale() starts a new iteration."""
    w = tp.to_tensor(np.ones(2, np.float32), stop_gradient=False)
    sgd = topt.SGD(learning_rate=1.0, parameters=[w])
    s = tamp.GradScaler(init_loss_scaling=8.0)
    s.scale(tp.sum(w * 3.0)).backward()
    s.unscale_(sgd)
    s.unscale_(sgd)
    np.testing.assert_allclose(w.grad.numpy(), [3.0, 3.0])
    s.step(sgd)
    np.testing.assert_allclose(w.numpy(), [-2.0, -2.0])
    s.update()
    assert s.get_loss_scaling() == 8.0


def _decorate_forms(P, nn, amp, opt):
    def net():
        return nn.Linear(3, 2)

    def sgd(m):
        return opt.SGD(learning_rate=0.1, parameters=m.parameters())
    m = net()
    o = sgd(m)
    pair = amp.decorate(m, o, level="O2", dtype="float16")
    m2, m3 = net(), net()
    o2, o3 = sgd(m2), sgd(m3)
    lists = amp.decorate([m2, m3], [o2, o3], dtype="float16")
    only_m = amp.decorate(net(), dtype="float16")
    o4 = sgd(net())
    only_o = amp.decorate(None, o4, dtype="float16")
    return (pair[0] is m and pair[1] is o, isinstance(lists[0], list)
            and lists[0][1] is m3 and lists[1][0] is o2,
            isinstance(only_m, nn.Linear), only_o is o4,
            o._multi_precision and o2._multi_precision
            and o4._multi_precision)


def test_decorate_return_forms_match_jax():
    assert _decorate_forms(jp, jnn, jamp, jopt) == \
        _decorate_forms(tp, tnn, tamp, topt) == (True,) * 5


def test_decorate_casts_parameters_in_place_not_buffers():
    """Every floating parameter in the AMP dtype (the `amp_dtype` flag by
    default), each the same object; buffers untouched."""
    tp.seed(0)
    net = tmodels.resnet18(num_classes=4)
    params = {k: p for k, p in net.named_parameters()}
    buffers = {k: b.dtype for k, b in net.named_buffers()}
    o = topt.Momentum(learning_rate=0.1, parameters=net.parameters())
    net, o = tamp.decorate(net, o)
    assert {p.dtype for p in net.parameters()} == {torch.bfloat16}
    assert all(params[k] is p for k, p in net.named_parameters())
    assert {k: b.dtype for k, b in net.named_buffers()} == buffers
    assert torch.float32 in set(buffers.values())


def test_minimize_after_backward_raises_in_both():
    """minimize(opt, scaled) runs scaled.backward() itself: a loss whose
    graph a backward() already freed is refused, in both packages."""
    for P, nn, amp, opt in ((jp, jnn, jamp, jopt), (tp, tnn, tamp, topt)):
        P.seed(0)
        lin = nn.Linear(3, 2)
        o = opt.SGD(learning_rate=0.1, parameters=lin.parameters())
        s = amp.GradScaler(init_loss_scaling=2.0)
        x = P.to_tensor(np.ones((2, 3), np.float32))
        scaled = s.scale(P.mean(lin(x) * lin(x)))
        scaled.backward()
        with pytest.raises(RuntimeError, match="second time"):
            s.minimize(o, scaled)
        fresh = s.scale(P.mean(lin(x)))
        s.minimize(o, fresh)          # one backward: fine


def test_parameter_keeps_torch_methods():
    """A `Parameter` keeps torch's `uniform_`, `sort` and `norm` (which
    torch.nn.init and torch's own code call); a paddle `Tensor` gets
    paddle's."""
    p = tp.Parameter(torch.zeros(3, 4))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        p.uniform_(-2.0, 2.0, generator=g)    # torch's signature
    assert float(p.detach().abs().max()) <= 2.0 and p.detach().std() > 0
    vals, idx = p.sort(dim=1, descending=True)
    assert type(vals) is torch.Tensor and idx.dtype == torch.int64
    assert torch.allclose(p.norm(), torch.linalg.vector_norm(p))
    torch.nn.init.kaiming_uniform_(p, a=5 ** 0.5, generator=g)
    torch.nn.init.normal_(p, 0.0, 0.02)
    torch.nn.init.trunc_normal_(p, std=0.02)
    assert p.dtype == torch.float32 and torch.isfinite(p).all()
    t = tp.to_tensor(np.array([[3.0, 1.0, 2.0]], np.float32))
    assert isinstance(t.sort(), tp.Tensor)
    np.testing.assert_array_equal(t.sort(descending=True).numpy(),
                                  [[3.0, 2.0, 1.0]])
    np.testing.assert_allclose(float(t.norm(p=1)), 6.0)
    assert t.uniform_(min=0.0, max=1.0) is t
    assert 0.0 <= float(t.min()) and float(t.max()) < 1.0
    np.testing.assert_array_equal(t.argmax(-1).numpy(), [int(
        t.numpy().argmax())])
