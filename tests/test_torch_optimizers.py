"""The port's Lamb, Lars, RMSProp, Adagrad, Adadelta and Adamax against the
JAX package's: three eager `step()`s and three `functional_update`s of
the JAX optimizer on the same seeded parameters and gradients, in fp32
(and Lars in bf16 with fp32 masters); `.pdopt` files of Lamb and Lars in
both directions; the JAX faults the port reproduces; no host read in an
update."""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

import paddle_tpu.nn as jnn                                   # noqa: E402
import paddle_tpu.optimizer as jopt                           # noqa: E402
import paddle_tpu.regularizer as jreg                         # noqa: E402
from paddle_tpu.core.tensor import Tensor as JTensor          # noqa: E402
from paddle_tpu.framework import Parameter as JParameter      # noqa: E402
from paddle_tpu.hapi import Model as JModel                   # noqa: E402

import paddle_tpu_torch.nn as tnn                             # noqa: E402
import paddle_tpu_torch.optimizer as topt                     # noqa: E402
import paddle_tpu_torch.regularizer as treg                   # noqa: E402
from paddle_tpu_torch.core import device as tdevice           # noqa: E402
from paddle_tpu_torch.hapi import Model as TModel             # noqa: E402

# the same fp32 ops in the same order: the packages differ by an ulp or
# so an element (the per-tensor norms sum in another order)
OPT_RTOL = 1e-6
# bf16 parameters: with fp32 masters the masters are held as fp32
# (OPT_RTOL) and the parameters are their bf16 rounding, within one bf16
# ulp; pure bf16 Lamb and Lars round as the JAX ops do, so their bf16
# values and slots differ by at most that ulp too
BF16_RTOL = 2.0 ** -7

_SHAPES = {"w": (8, 6), "b": (6,), "e": (5, 6), "z": (4,)}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    out = {k: (rng.standard_normal(s) * scale).astype(np.float32)
           for k, s in _SHAPES.items()}
    return out


def _params0():
    """The starting parameters: "z" is all zeros, so Lamb's and Lars's
    norm of it is 0 and its trust ratio / local lr is 1."""
    p = _arrays(0)
    p["z"][:] = 0.0
    return p


class _NS:
    def __init__(self, **kw):
        self.__dict__.update(kw)


_J = _NS(opt=jopt, nn=jnn, reg=jreg)
_T = _NS(opt=topt, nn=tnn, reg=treg)


def _cases():
    """name -> (build(pkg, params), dtype)."""
    return {
        "lamb": (lambda m, P: m.opt.Lamb(
            2e-2, lamb_weight_decay=0.01, parameters=P), "float32"),
        "lamb_clip_l2param": (lambda m, P: m.opt.Lamb(
            1e-2, lamb_weight_decay=0.05, beta2=0.95, parameters=P,
            grad_clip=m.nn.ClipGradByGlobalNorm(0.5)), "float32"),
        # the JAX Lamb stores the function and never calls it: every
        # tensor decays (ROADMAP queue 3, reproduced)
        "lamb_exclude_fn_unused": (lambda m, P: m.opt.Lamb(
            1e-2, lamb_weight_decay=0.1, parameters=P,
            exclude_from_weight_decay_fn=lambda n: True), "float32"),
        "lars": (lambda m, P: m.opt.Lars(
            0.1, momentum=0.9, lars_coeff=0.001, lars_weight_decay=5e-4,
            parameters=P), "float32"),
        # the JAX Lars never stores the exclusion list (ROADMAP queue 3)
        "lars_exclude_unused": (lambda m, P: m.opt.Lars(
            0.5, lars_coeff=0.01, lars_weight_decay=0.05, parameters=P,
            exclude_from_weight_decay=["b", "e"]), "float32"),
        # pure bf16 (no masters): the norms as `jnp.linalg.norm` takes
        # them in bf16, the hyperparameters rounded to bf16 as JAX's weak
        # typing rounds them
        "lamb_bf16": (lambda m, P: m.opt.Lamb(
            2e-2, lamb_weight_decay=0.01, parameters=P), "bfloat16"),
        "lars_bf16": (lambda m, P: m.opt.Lars(
            0.1, lars_coeff=0.01, lars_weight_decay=5e-4, parameters=P),
            "bfloat16"),
        "lars_multi_precision_bf16": (lambda m, P: m.opt.Lars(
            0.1, lars_coeff=0.01, lars_weight_decay=5e-4, parameters=P,
            multi_precision=True), "bfloat16"),
        "rmsprop_wd": (lambda m, P: m.opt.RMSProp(
            1e-2, rho=0.9, momentum=0.5, parameters=P, weight_decay=0.01),
            "float32"),
        "rmsprop_centered_l2": (lambda m, P: m.opt.RMSProp(
            1e-2, centered=True, parameters=P,
            weight_decay=m.reg.L2Decay(0.02)), "float32"),
        "adagrad_wd": (lambda m, P: m.opt.Adagrad(
            0.1, parameters=P, weight_decay=0.01,
            initial_accumulator_value=0.1), "float32"),
        "adagrad_l1": (lambda m, P: m.opt.Adagrad(
            0.1, parameters=P, weight_decay=m.reg.L1Decay(0.01)),
            "float32"),
        "adadelta_wd": (lambda m, P: m.opt.Adadelta(
            1.0, rho=0.9, parameters=P, weight_decay=0.01), "float32"),
        "adadelta_clip_value": (lambda m, P: m.opt.Adadelta(
            1.0, parameters=P, grad_clip=m.nn.ClipGradByValue(0.3)),
            "float32"),
        "adamax_wd": (lambda m, P: m.opt.Adamax(
            1e-2, parameters=P, weight_decay=0.01), "float32"),
        "adamax_l2": (lambda m, P: m.opt.Adamax(
            1e-2, beta2=0.99, parameters=P,
            weight_decay=m.reg.L2Decay(0.02)), "float32"),
    }


def _jax_params(arrays, dtype):
    return {k: JParameter(jnp.asarray(v).astype(dtype))
            for k, v in arrays.items()}


def _port_params(arrays, dtype):
    return {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(
        getattr(torch, dtype))) for k, v in arrays.items()}


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what, rtol=OPT_RTOL):
    got, want = _np32(got), _np32(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _grads(step, dtype):
    g = _arrays(10 + step, scale=0.7)
    return g, {k: jnp.asarray(v).astype(dtype) for k, v in g.items()}


def _run_both(case, steps=3):
    build, dtype = _cases()[case]
    init = _params0()
    jp, tp = _jax_params(init, dtype), _port_params(init, dtype)
    jo = build(_J, list(jp.values()))
    to = build(_T, list(tp.values()))
    for s in range(steps):
        g, jg = _grads(s, dtype)
        for k in init:
            jp[k].grad = JTensor(jg[k])
            tp[k].grad = torch.from_numpy(g[k].copy()).to(
                getattr(torch, dtype))
        jo.step()
        to.step()
    return init, dtype, jp, tp, jo, to


def _slot(v):
    return v if isinstance(v, torch.Tensor) else \
        torch.as_tensor(np.asarray(v, np.float32))


@pytest.mark.parametrize("case", sorted(_cases()))
def test_three_steps_match_jax_eager(case):
    init, dtype, jp, tp, jo, to = _run_both(case)
    rtol = BF16_RTOL if dtype == "bfloat16" else OPT_RTOL
    for k in init:
        assert tp[k].dtype == getattr(torch, dtype)
        _close(tp[k], jp[k]._data, f"{case} param {k}", rtol)
        jst, tst = jo._state[id(jp[k])], to.state(tp[k])
        assert set(tst) == set(jst), (set(tst), set(jst))
        for slot in jst:
            _close(_slot(tst[slot]), jst[slot], f"{case} {k} {slot}",
                   rtol if getattr(tst[slot], "dtype", None)
                   == torch.bfloat16 else OPT_RTOL)
        if id(jp[k]) in jo._master:
            _close(to._master[id(tp[k])], jo._master[id(jp[k])],
                   f"{case} master {k}")
    if case.startswith(("lamb", "lars")):
        moved = float(np.abs(_np32(tp["z"])).max())
        assert moved > 0.0     # the zero tensor took its trust-1 update


@pytest.mark.parametrize("case", sorted(c for c, (_, dt) in _cases().items()
                                        if dt == "float32"))
def test_three_steps_match_jax_functional_update(case):
    """The JAX compiled step's path: `functional_update` on dicts."""
    build, dtype = _cases()[case]
    init = _params0()
    jo = build(_J, None)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = jo.functional_init(params)
    tp = _port_params(init, dtype)
    to = build(_T, list(tp.values()))
    for s in range(3):
        g, jg = _grads(s, dtype)
        params, state = jo.functional_update(params, jg, state, jo.get_lr())
        for k in init:
            tp[k].grad = torch.from_numpy(g[k].copy())
        to.step()
    for k in init:
        _close(tp[k], params[k], f"{case} param {k}")
        for slot, v in state[k].items():
            _close(_slot(to.state(tp[k])[slot]), v, f"{case} {k} {slot}")


@pytest.mark.parametrize("case", ["lamb_exclude_fn_unused",
                                  "lars_exclude_unused"])
def test_exclusions_are_ignored_as_in_jax(case):
    """The exclusion argument changes nothing in either package: the
    parameters equal those of a run without it (every tensor decays)."""
    _, _, jp, tp, _, _ = _run_both(case)
    plain = case.split("_exclude")[0]
    build = {"lamb": lambda m, P: m.opt.Lamb(1e-2, lamb_weight_decay=0.1,
                                             parameters=P),
             "lars": lambda m, P: m.opt.Lars(
                 0.5, lars_coeff=0.01, lars_weight_decay=0.05,
                 parameters=P)}[plain]
    init = _params0()
    tp2 = _port_params(init, "float32")
    to2 = build(_T, list(tp2.values()))
    for s in range(3):
        g, _ = _grads(s, "float32")
        for k in init:
            tp2[k].grad = torch.from_numpy(g[k].copy())
        to2.step()
    for k in init:
        assert torch.equal(tp[k].detach(), tp2[k].detach()), k


def test_no_host_read_in_an_update(monkeypatch):
    """Lamb's trust ratio and Lars's local lr stay tensors: an update that
    read one back (`item`, `float`, `bool`, `tolist`) would raise here."""
    def boom(*a, **k):
        raise AssertionError("host read in an optimizer update")

    for build in (lambda P: topt.Lamb(1e-2, parameters=P),
                  lambda P: topt.Lars(0.1, parameters=P, lars_coeff=0.01),
                  lambda P: topt.RMSProp(1e-2, parameters=P, centered=True),
                  lambda P: topt.Adagrad(0.1, parameters=P),
                  lambda P: topt.Adadelta(1.0, parameters=P),
                  lambda P: topt.Adamax(1e-2, parameters=P)):
        tp = _port_params(_params0(), "float32")
        opt = build(list(tp.values()))
        for k, g in _arrays(5).items():
            tp[k].grad = torch.from_numpy(g)
        with monkeypatch.context() as m:
            for name in ("item", "__float__", "__bool__", "tolist",
                         "__int__"):
                m.setattr(torch.Tensor, name, boom)
            opt.step()


class _Net(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(6, 3)

    def forward(self, x):
        return self.fc(x)


def _jax_net(init):
    import paddle_tpu.nn as jnn_

    class Net(jnn_.Layer):
        def __init__(self):
            super().__init__()
            self.fc = jnn_.Linear(6, 3)

        def forward(self, x):
            return self.fc(x)

    net = Net()
    net.set_state_dict({k: JTensor(jnp.asarray(v)) for k, v in init.items()})
    return net


@pytest.mark.parametrize("name", ["Lamb", "Lars"])
def test_pdopt_crosses_both_ways(tmp_path, name):
    """`Model.save` of either package loads into the other's `Model`: the
    slots by qualified name, bit for bit, and one more step from the
    loaded state matches the step of the package that saved it."""
    rng = np.random.default_rng(4)
    init = {"fc.weight": rng.standard_normal((6, 3)).astype(np.float32),
            "fc.bias": rng.standard_normal(3).astype(np.float32)}
    x = rng.standard_normal((8, 6)).astype(np.float32)
    y = rng.standard_normal((8, 3)).astype(np.float32)
    kw = {"Lamb": {"lamb_weight_decay": 0.01},
          "Lars": {"lars_coeff": 0.01}}[name]
    slots = {"Lamb": {"moment1", "moment2", "beta1_pow", "beta2_pow"},
             "Lars": {"velocity"}}[name]

    def port_model():
        net = _Net()
        net.set_state_dict(init)
        m = TModel(net)
        m.prepare(getattr(topt, name)(1e-2, parameters=net.parameters(),
                                      **kw), loss=_mse)
        return m

    def jax_model():
        net = _jax_net(init)
        m = JModel(net)
        m.prepare(getattr(jopt, name)(1e-2, parameters=net.parameters(),
                                      **kw), loss=_mse)
        return m

    def saved(prefix):
        with open(prefix + ".pdopt", "rb") as f:
            return pickle.load(f)["functional_state"]

    # port -> JAX
    tm = port_model()
    tm.train_batch([x], [y])
    tm.save(str(tmp_path / "port"))
    tsaved = saved(str(tmp_path / "port"))
    assert set(tsaved) == set(init)
    assert all(set(v) == slots for v in tsaved.values())
    jm = jax_model()
    jm.load(str(tmp_path / "port"))
    for n, sl in tsaved.items():
        for slot, v in sl.items():
            np.testing.assert_array_equal(
                np.asarray(jm._restored_opt_state[n][slot]), np.asarray(v))
    tm.train_batch([x], [y])
    jm.train_batch([x], [y])
    for n, p in tm.network.named_parameters():
        _close(p, jm._params[n],
               f"{name} {n} after a step from the port's file", 1e-5)

    # JAX -> port
    jm.save(str(tmp_path / "jax"))
    jsaved = saved(str(tmp_path / "jax"))
    tm2 = port_model()
    tm2.load(str(tmp_path / "jax"))
    got = tm2._optimizer.functional_state(tm2.network.named_parameters())
    assert set(got) == set(jsaved)
    for n, sl in jsaved.items():
        assert set(sl) == slots
        for slot, v in sl.items():
            np.testing.assert_array_equal(np.asarray(got[n][slot]),
                                          np.asarray(v), err_msg=(n, slot))


def _mse(out, y):
    return ((out - y) ** 2).mean()
