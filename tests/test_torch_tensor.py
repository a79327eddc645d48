"""paddle_tpu_torch's core against the JAX package's: `Tensor` and
`to_tensor` (dtype rules, methods, stop_gradient), autograd (`backward`,
`paddle.grad`, hooks, the grad switches), dtypes, places and
`get_device` / `set_device`, the RNG state, the port's layers fed
`to_tensor` inputs, parameters, and run.py's `_timed_steps` on a port
`CompiledTrainStep` (ROADMAP queue 3 fault 2). tests/test_tensor.py's
cases run on both packages."""
import copy
import importlib.util
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp                                          # noqa: E402
import paddle_tpu_torch as tp                                    # noqa: E402
from paddle_tpu.core import dtype as jdtype                      # noqa: E402
from paddle_tpu.core.errors import InvalidArgumentError as JIAE  # noqa: E402
from paddle_tpu_torch.core import device as tdevice             # noqa: E402
from paddle_tpu_torch.core import dtype as tdtype               # noqa: E402
from paddle_tpu_torch.core.errors import InvalidArgumentError as TIAE  # noqa: E402

from torch_op_cases import FP32                                 # noqa: E402
from torch_op_parity import check_same, cpu_default              # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = pytest.mark.parametrize("P", [jp, tp], ids=["jax", "port"])


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    cpu_default(monkeypatch)


# -- to_tensor and dtypes ------------------------------------------------------

_DATA = [
    ("float_list", [[1.0, 2.0], [3.0, 4.0]], None),
    ("int_list", [1, 2, 3], None),
    ("bool_list", [True, False], None),
    ("float_scalar", 2.5, None),
    ("int_scalar", 7, None),
    ("bool_scalar", True, None),
    ("np_float64", np.arange(3.0), None),
    ("np_int32", np.arange(3, dtype=np.int32), None),
    ("np_float16", np.arange(3, dtype=np.float16), None),
    ("np_complex", np.arange(2) + 1j, None),
    ("dtype_name", [1, 2], "float64"),
    ("dtype_bf16", [1.5, 2.0], "bfloat16"),
    ("dtype_obj", [1.0, 2.0], np.int32),
]


@pytest.mark.parametrize("data,dtype", [(d, t) for _, d, t in _DATA],
                         ids=[n for n, _, _ in _DATA])
def test_to_tensor_dtypes_and_values_match_jax(data, dtype):
    j = jp.to_tensor(data, dtype=dtype)
    t = tp.to_tensor(data, dtype=dtype)
    check_same(j, t, FP32)
    assert j.stop_gradient and t.stop_gradient


def test_to_tensor_of_a_tensor_copies():
    src = tp.to_tensor([1.0, 2.0])
    t = tp.to_tensor(src, stop_gradient=False)
    t.set_value(np.zeros(2, np.float32))
    np.testing.assert_array_equal(src.numpy(), [1.0, 2.0])
    assert not t.stop_gradient and src.stop_gradient


@pytest.mark.parametrize("name", ["bool", "uint8", "int8", "int16", "int32",
                                  "int64", "float16", "bfloat16", "float32",
                                  "float64", "complex64", "complex128",
                                  "fp16", "bf16", "fp32", "fp64"])
def test_dtype_names_match_jax(name):
    jd, td = jdtype.convert_dtype(name), tdtype.convert_dtype(name)
    assert jdtype.dtype_name(jd) == tdtype.dtype_name(td)
    for f in ("is_floating_point", "is_integer", "is_complex"):
        assert getattr(jdtype, f)(jd) == getattr(tdtype, f)(td), f
    with pytest.raises(ValueError):
        tdtype.convert_dtype("float8")


def test_top_level_dtypes_are_torch_dtypes():
    for n in ("bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
              "bfloat16", "float32", "float64", "complex64", "complex128"):
        assert isinstance(getattr(tp, n), torch.dtype)
        assert tdtype.dtype_name(getattr(tp, n)) == \
            jdtype.dtype_name(getattr(jp, n))
    assert tp.float32 is torch.float32


def test_default_dtype_round_trip():
    for P in (jp, tp):
        P.set_default_dtype("float64")
        try:
            assert P.to_tensor([1.5]).numpy().dtype == np.float64
            assert P.arange(0.0, 1.0, 0.5).numpy().dtype == np.float64
        finally:
            P.set_default_dtype("float32")
        with pytest.raises(TypeError):
            P.set_default_dtype("int32")
    assert tp.get_default_dtype() is torch.float32


# -- Tensor's own methods -------------------------------------------------------

@BOTH
def test_tensor_properties(P):
    x = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert x.shape == [2, 3] and isinstance(x.shape, list)
    assert x.ndim == 2 and x.dim() == 2 and x.rank() == 2
    assert x.size == 6 and x.numel() == 6 and x.element_size() == 4
    assert x.place == P.CPUPlace()
    assert x.is_leaf and x.stop_gradient
    assert x.astype("int64").dtype == P.int64
    assert x.cast("float64").dtype == P.float64
    assert x.item(4) == 4.0 and x.tolist()[1] == [3.0, 4.0, 5.0]
    assert np.asarray(x).shape == (2, 3)
    assert len(x) == 2 and [r.shape for r in x] == [[3], [3]]
    assert float(x[1, 2]) == 5.0 and int(x[0, 1]) == 1 and bool(x[0, 1])
    assert f"{x[1, 1]:.2f}" == "4.00"
    assert x.cpu().place == P.CPUPlace()
    assert x.to(dtype="float64").dtype == P.float64
    assert x.detach().stop_gradient
    y = x.clone()
    y.fill_(3.0)
    np.testing.assert_array_equal(x.numpy()[0], [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(y.numpy(), np.full((2, 3), 3.0))
    x.copy_(np.ones((2, 3), np.float32))
    np.testing.assert_array_equal(x.numpy(), np.ones((2, 3)))
    with pytest.raises(ValueError):
        x.set_value(np.ones(3, np.float32))


def test_tensor_repr_matches_jax():
    for data, sg in [([[1.0, 2.5]], True), ([3, 4], True), ([1.0], False)]:
        j = jp.to_tensor(data, stop_gradient=sg)
        t = tp.to_tensor(data, stop_gradient=sg)
        assert repr(t) == repr(j)


def test_shape_is_a_list_torch_can_read():
    """`shape` equals the list (paddle) and the tuple / torch.Size
    (torch); it slices and concatenates as a list and with tuples."""
    t = tp.to_tensor(np.zeros((2, 3, 4), np.float32))
    assert t.shape == [2, 3, 4] and t.shape == (2, 3, 4)
    assert t.shape == torch.Size([2, 3, 4])
    assert torch.Size([2, 3, 4]) == t.shape
    assert t.shape[:-1] + [5] == [2, 3, 5]
    assert t.shape[:-1] + (5,) == (2, 3, 5)
    assert (1,) + t.shape == [1, 2, 3, 4]
    assert t.shape != [2, 3]
    assert {t.shape: 1}[(2, 3, 4)] == 1
    assert torch.zeros(t.shape).shape == (2, 3, 4)
    assert t.size == 24 and t.size() == (2, 3, 4) and t.size(1) == 3
    assert torch.empty(t.size(0)).shape == (2,)


def test_copies_and_pickles_keep_the_class():
    t = tp.to_tensor([1.0, 2.0], stop_gradient=False)
    for c in (copy.deepcopy(t), pickle.loads(pickle.dumps(t))):
        assert isinstance(c, tp.Tensor) and not c.stop_gradient
        np.testing.assert_array_equal(c.numpy(), [1.0, 2.0])


@BOTH
def test_getitem_setitem_as_test_tensor(P):
    x = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_allclose(x[1].numpy(), [3, 4, 5])
    x[0] = 7.0
    np.testing.assert_allclose(x.numpy()[0], [7, 7, 7])
    x[1, P.to_tensor(np.array([0, 2]))] = P.to_tensor([9.0, 8.0])
    np.testing.assert_allclose(x.numpy()[1], [9, 4, 8])
    assert x[:, 1:].shape == [2, 2]


@BOTH
def test_inplace_value_ops_as_test_tensor(P):
    x = P.to_tensor([1.0, 2.0])
    x.scale_(2.0)
    np.testing.assert_allclose(x.numpy(), [2, 4])
    x.zero_()
    np.testing.assert_allclose(x.numpy(), [0, 0])
    x = P.to_tensor([[5.0]])
    assert x.item() == 5.0
    assert P.numel(x).item() == 1


# -- autograd --------------------------------------------------------------------

@BOTH
def test_backward_as_test_tensor(P):
    x = P.to_tensor([2.0, 3.0], stop_gradient=False)
    P.sum(x * x).backward()
    np.testing.assert_allclose(x.grad.numpy(), [4.0, 6.0])
    np.testing.assert_allclose(x.gradient, [4.0, 6.0])
    x = P.to_tensor([1.0], stop_gradient=False)
    (x * 2).backward()
    (x * 3).backward()
    np.testing.assert_allclose(x.grad.numpy(), [5.0])
    x.clear_grad()
    assert x.grad is None
    x = P.to_tensor([1.0], stop_gradient=True)
    w = P.to_tensor([3.0], stop_gradient=False)
    (x * w).backward()
    assert x.grad is None
    np.testing.assert_allclose(w.grad.numpy(), [1.0])


@BOTH
def test_backward_of_a_non_scalar_seeds_ones(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * 3.0).backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0])
    y = P.to_tensor([1.0, 2.0], stop_gradient=False)
    (y * y).backward(P.to_tensor([1.0, 0.5]))
    np.testing.assert_allclose(y.grad.numpy(), [2.0, 2.0])


@BOTH
def test_no_grad_and_switches(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    with P.no_grad():
        y = x * 2
    assert y.stop_gradient
    with P.no_grad():
        with P.enable_grad():
            z = x * 2
    assert not z.stop_gradient

    @P.no_grad()
    def f(a):
        return a * 2
    assert f(x).stop_gradient
    P.set_grad_enabled(False)
    try:
        assert (x * 2).stop_gradient
    finally:
        P.set_grad_enabled(True)
    assert not (x * 2).stop_gradient


@BOTH
def test_stop_gradient_flows_as_jax(P):
    a = P.to_tensor([1.0, 2.0])
    b = P.to_tensor([3.0, 4.0], stop_gradient=False)
    assert (a + a).stop_gradient and not (a + b).stop_gradient
    assert not P.concat([a, b]).stop_gradient
    assert P.zeros_like(a).stop_gradient
    assert not P.zeros_like(b).stop_gradient
    c = P.to_tensor([1.0])
    c.stop_gradient = False
    assert not c.stop_gradient and c.is_leaf
    i = P.to_tensor([1, 2], stop_gradient=False)
    assert i.stop_gradient is False


@BOTH
def test_register_hook_as_test_tensor(P):
    x = P.to_tensor([1.0, 1.0], stop_gradient=False)
    h = x.register_hook(lambda g: g * 2)
    P.sum(x * 3).backward()
    np.testing.assert_allclose(x.grad.numpy(), [6.0, 6.0])
    h.remove()
    x.clear_grad()
    P.sum(x * 3).backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0])


@BOTH
def test_retain_grads_on_an_intermediate(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x * 2
    y.retain_grads()
    P.sum(P.exp(y) * 3.0).backward()
    np.testing.assert_allclose(y.grad.numpy(), 3.0 * np.exp([2.0, 4.0]),
                               rtol=1e-4)


def test_retain_grads_counts_a_reused_tensor_once():
    """y used twice by one op: the port keeps dL/dy once. (The JAX
    package adds it twice, once per use: its sweep lists the tensor once
    per input slot; ROADMAP queue 3.)"""
    res = []
    for P in (jp, tp):
        x = P.to_tensor([1.0, 2.0], stop_gradient=False)
        y = x * 2
        y.retain_grads()
        P.sum(y * y).backward()
        res.append(y.grad.numpy())
    np.testing.assert_allclose(res[1], [4.0, 8.0])
    np.testing.assert_allclose(res[0], [8.0, 16.0])


@BOTH
def test_paddle_grad_as_test_tensor(P):
    x = P.to_tensor([2.0], stop_gradient=False)
    y = x * x * x
    (gx,) = P.grad([y], [x])
    np.testing.assert_allclose(gx.numpy(), [12.0])
    assert gx.stop_gradient and x.grad is None


@BOTH
def test_paddle_grad_options(P, ):
    x = P.to_tensor([2.0, 3.0], stop_gradient=False)
    u = P.to_tensor([1.0], stop_gradient=False)
    y = x * x
    err = JIAE if P is jp else TIAE
    with pytest.raises(err, match="unused"):
        P.grad([y], [x, u], retain_graph=True)
    gx, gu = P.grad([y], [x, u], grad_outputs=[P.to_tensor([1.0, 2.0])],
                    retain_graph=True, allow_unused=True)
    np.testing.assert_allclose(gx.numpy(), [4.0, 12.0])
    assert gu is None
    (g,) = P.grad(P.sum(x * x * x), x, create_graph=True)
    (gg,) = P.grad(P.sum(g), x)
    np.testing.assert_allclose(gg.numpy(), [12.0, 18.0])


@BOTH
def test_second_backward_needs_retain_graph(P):
    x = P.to_tensor([2.0], stop_gradient=False)
    y = x * x
    y.backward(retain_graph=True)
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), [8.0])
    z = P.exp(x)
    z.backward()
    with pytest.raises(RuntimeError, match="second time"):
        z.backward()
    with pytest.raises(JIAE if P is jp else TIAE, match="no grad graph"):
        P.to_tensor([1.0]).backward()


@BOTH
def test_matmul_grad_as_test_tensor(P):
    a = P.to_tensor(np.ones((2, 3), np.float32), stop_gradient=False)
    b = P.to_tensor(np.ones((3, 4), np.float32), stop_gradient=False)
    P.sum(a @ b).backward()
    np.testing.assert_allclose(a.grad.numpy(), np.full((2, 3), 4.0))
    np.testing.assert_allclose(b.grad.numpy(), np.full((3, 4), 2.0))


def test_dunders_match_jax():
    a, b = np.array([1.0, -2.0, 3.0], np.float32), \
        np.array([2.0, 2.0, -1.0], np.float32)
    i = np.array([5, 6, 7])
    for fn in (lambda x, y, k: x + y, lambda x, y, k: x - 1,
               lambda x, y, k: 2 * x, lambda x, y, k: x / y,
               lambda x, y, k: 1 / y, lambda x, y, k: x // y,
               lambda x, y, k: x % y, lambda x, y, k: x ** 2,
               lambda x, y, k: 2 ** x, lambda x, y, k: -x,
               lambda x, y, k: abs(x), lambda x, y, k: x < y,
               lambda x, y, k: x <= 1.0, lambda x, y, k: x > y,
               lambda x, y, k: x >= y, lambda x, y, k: x == y,
               lambda x, y, k: x != y, lambda x, y, k: ~(x > 0),
               lambda x, y, k: k & 3, lambda x, y, k: k | 1,
               lambda x, y, k: k ^ k, lambda x, y, k: ~k,
               lambda x, y, k: x.reshape([3, 1]) @ y.reshape([1, 3])):
        res = [fn(P.to_tensor(a), P.to_tensor(b), P.to_tensor(i))
               for P in (jp, tp)]
        check_same(res[0], res[1], FP32)


def test_methods_are_the_library():
    """Library functions are `Tensor` methods with paddle's arguments
    (tensor first); names the class defines stay."""
    t = tp.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert t.transpose([1, 0]).shape == [3, 2]
    assert [p.shape for p in t.split(3, axis=1)] == [[2, 1]] * 3
    assert t.max(axis=1).shape == [2]
    assert t.sum(axis=0, keepdim=True).shape == [1, 3]
    assert isinstance(t.numel(), int) and t.tolist()[0] == [0.0, 1.0, 2.0]
    for name in ("zeros", "arange", "assign", "scatter_nd"):
        assert name not in vars(tp.Tensor)


def test_functionals_read_paddle_tensors_as_plain():
    """Inside the port's functionals a paddle `Tensor` may reach a torch
    method call that the library rebinds (`var`, `argmax`, `mean`): they
    call torch's functions, so F.batch_norm and F.gumbel_softmax(hard=
    True) give on paddle Tensors what they give on plain tensors, through
    the `nn.functional` namespace and called directly."""
    from paddle_tpu_torch.nn.functional import activation, norm
    import paddle_tpu_torch.nn.functional as F
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 3, 5, 5)).astype(np.float32)
    plain = torch.from_numpy(x)
    for fn in (F.batch_norm, norm.batch_norm):
        got = []
        for t in (tp.to_tensor(x), plain):
            rm, rv = torch.zeros(3), torch.ones(3)
            y = fn(t, rm, rv, torch.ones(3), torch.zeros(3), training=True)
            got.append((torch.Tensor.detach(y).numpy(), rm.numpy(),
                        rv.numpy()))
        for a, b in zip(*got):
            np.testing.assert_array_equal(a, b)
    logits = rng.standard_normal((6, 7)).astype(np.float32)
    for fn in (F.gumbel_softmax, activation.gumbel_softmax):
        got = []
        for t in (tp.to_tensor(logits), torch.from_numpy(logits)):
            tp.seed(3)
            got.append(torch.Tensor.detach(fn(t, 0.5, hard=True)).numpy())
        np.testing.assert_array_equal(*got)
        np.testing.assert_allclose(got[0].sum(-1), np.ones(6), rtol=1e-6)
        assert np.array_equal((got[0] > 0.5).sum(-1), np.ones(6))


# -- places and devices -----------------------------------------------------------

def test_places_match_jax():
    assert tp.CPUPlace() == tp.CPUPlace() and repr(tp.CPUPlace()) == \
        repr(jp.CPUPlace())
    assert tp.TPUPlace is tp.CUDAPlace and tp.XPUPlace is tp.CUDAPlace
    assert tp.TPUPinnedPlace is tp.CUDAPinnedPlace
    assert tp.CUDAPlace(1).get_device_id() == 1
    assert tp.CUDAPlace(0) != tp.CPUPlace()
    assert tp.CPUPlace() == torch.device("cpu")
    assert tp.CUDAPlace(1) == torch.device("cuda:1")
    assert isinstance(tp.is_compiled_with_cuda(), bool)
    assert tp.is_compiled_with_tpu() == tp.is_compiled_with_cuda()
    assert tp.device_count() >= 1


def test_get_device_and_set_device_match_jax(monkeypatch):
    """paddle's types: set_device returns a Place, get_device a string
    ("cpu" or "gpu:N"); both packages take the same device strings."""
    jprev = jp.core.place._default_place
    try:
        for P in (jp, tp):
            place = P.set_device("cpu")
            assert isinstance(place, P.CPUPlace)
            assert isinstance(P.get_device(), str)
            assert P.get_device() == "cpu" or P is jp
            with pytest.raises(ValueError):
                P.set_device("nonsense")
    finally:
        jp.core.place._default_place = jprev
    assert tp.device.get_device is tp.get_device
    assert tdevice._DEFAULT == [torch.device("cpu")]
    if not torch.cuda.is_available():
        monkeypatch.setattr(tdevice, "_DEFAULT", [None])
        assert tp.get_device() == "cpu"
        for dev in ("gpu", "gpu:0", "cuda", "tpu", "xpu:0"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                tp.set_device(dev)
        assert tdevice._DEFAULT == [None]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdevice.default_device()


def test_rng_state_round_trip():
    for P in (jp, tp):
        P.seed(3)
        state = P.get_rng_state()
        a = np.random.rand(3)
        P.set_rng_state(state)
        if P is tp:
            assert np.array_equal(np.random.rand(3), a)
    tp.seed(5)
    st = tp.get_rng_state()
    w1 = torch.randn(4)
    tp.set_rng_state(st)
    assert torch.equal(torch.randn(4), w1)


# -- the port's layers and parameters with paddle Tensors --------------------------

def test_layers_fed_to_tensor_inputs():
    """A `Tensor` into a port layer: the same values as plain tensors,
    a `Tensor` out, gradients back to the input."""
    tp.seed(0)
    lin = tp.nn.Linear(4, 3)
    ln = tp.nn.LayerNorm(3)
    enc = tp.nn.TransformerEncoderLayer(4, 2, 8, dropout=0.0)
    x = np.random.default_rng(0).standard_normal((2, 5, 4)).astype(
        np.float32)
    xt = tp.to_tensor(x, stop_gradient=False)
    out = ln(lin(xt))
    assert isinstance(out, tp.Tensor) and out.shape == [2, 5, 3]
    plain = ln(lin(torch.from_numpy(x)))
    assert type(plain) is torch.Tensor
    np.testing.assert_array_equal(out.numpy(), plain.detach().numpy())
    tp.sum(out).backward()
    assert xt.grad is not None and xt.grad.shape == [2, 5, 4]
    e = enc(tp.to_tensor(x))
    assert isinstance(e, tp.Tensor)
    np.testing.assert_array_equal(e.numpy(),
                                  enc(torch.from_numpy(x)).detach().numpy())
    f = tp.nn.functional.gelu(tp.to_tensor(x))
    assert isinstance(f, tp.Tensor)


def test_gpt_with_to_tensor_inputs():
    from paddle_tpu_torch.models import GPT, gpt_tiny
    cfg = gpt_tiny()
    tp.seed(1)
    net = GPT(cfg)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    logits = net(tp.to_tensor(ids))
    assert isinstance(logits, tp.Tensor)
    np.testing.assert_array_equal(
        logits.numpy(), net(torch.from_numpy(ids)).detach().numpy())
    loss = net.loss(tp.to_tensor(ids), tp.to_tensor(ids))
    assert isinstance(loss, tp.Tensor)
    np.testing.assert_allclose(
        loss.numpy(), net.loss(torch.from_numpy(ids),
                               torch.from_numpy(ids)).detach().numpy(),
        rtol=1e-6)


def test_parameters_have_the_paddle_names():
    lin = tp.nn.Linear(3, 2)
    w = lin.weight
    assert isinstance(w, tp.Parameter) and isinstance(w, torch.nn.Parameter)
    assert w.shape == [3, 2] and w.numpy().shape == (3, 2)
    assert not w.stop_gradient and w.trainable and w.place == tp.CPUPlace()
    assert type(w.detach()) is torch.Tensor
    assert w.size(0) == 3 and w.size == 6
    w.stop_gradient = True
    assert not w.requires_grad
    w.stop_gradient = False
    (lin(tp.to_tensor(np.ones((1, 3), np.float32))) ** 2).sum().backward()
    assert w.gradient.shape == (3, 2)
    assert repr(w).startswith("Parameter containing:\nTensor(shape=[3, 2]")
    c = copy.deepcopy(lin)
    assert isinstance(c.weight, tp.Parameter)
    np.testing.assert_array_equal(c.weight.numpy(), w.numpy())


# -- ROADMAP queue 3 fault 2: run.py's _timed_steps on a port step -----------------

def _run_py():
    spec = importlib.util.spec_from_file_location(
        "benchmarks_run", os.path.join(ROOT, "benchmarks", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_py_timed_steps_times_a_port_train_step():
    """benchmarks/run.py's own `_timed_steps` reads each window's loss
    with `.numpy()`; the port's `CompiledTrainStep.step` returns a paddle
    `Tensor`, so it times a narrow port step as written."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed.fleet.compiler import \
        compile_train_step
    from paddle_tpu_torch.distributed.fleet.strategy import \
        DistributedStrategy
    from paddle_tpu_torch.models import GPT, gpt_tiny

    timed_steps = _run_py()._timed_steps
    cfg = gpt_tiny()
    tp.seed(0)
    net = GPT(cfg)
    prog = compile_train_step(
        net, topt.Momentum(learning_rate=1e-3, momentum=0.9,
                           parameters=net.parameters()),
        DistributedStrategy(), loss_method="loss")
    ids = prog._put_data(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    losses = []

    def step():
        out = prog.step(ids, ids)
        losses.append(out)
        return out
    secs = timed_steps(step, n_short=1, n_long=2)
    assert secs > 0 and len(losses) == 1 + 2 * (1 + 2)
    last = losses[-1]
    assert isinstance(last, tp.Tensor) and last.stop_gradient
    assert np.isfinite(last.numpy()) and last.numpy().shape == ()
    assert float(last.numpy()) == last.item()
    assert losses[-1].item() < losses[0].item()


def test_chip_smoke_times_through_run_py_verbatim():
    """chip_smoke.py's phases 10 and 12 time through a letter-for-letter
    copy of benchmarks/run.py:36-58 (its window, run.py:42-49, reads the
    loss with `out.numpy()`)."""
    with open(os.path.join(ROOT, "benchmarks", "run.py")) as f:
        run_lines = f.read().splitlines(keepends=True)
    block = "".join(run_lines[35:58])
    assert block.startswith("def _timed_steps(step_fn, n_short=2, "
                            "n_long=10):")
    assert "        out = out.numpy() if hasattr(out, \"numpy\") else out\n" \
        in "".join(run_lines[41:49])
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        smoke = f.read()
    assert block in smoke
    assert smoke.count("_timed_steps(step, n_short=") == 2
