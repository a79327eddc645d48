"""paddle_tpu_torch's vision functionals and layers against the JAX
package on the CPU, on the same numpy inputs: conv2d, max_pool2d,
avg_pool2d, adaptive_avg_pool2d, batch_norm, cross_entropy and
softmax_with_cross_entropy, forward and gradients (of sum(out * w), w
fixed random weights), and the layers Conv2D, MaxPool2D, AvgPool2D,
AdaptiveAvgPool2D, BatchNorm, BatchNorm2D, CrossEntropyLoss, ReLU,
Flatten and Sequential from one state dict.

The cases cover where a port of these ops silently disagrees: SAME
padding at stride 2 (XLA pads the odd element at the end), asymmetric
pads, a `ceil_mode` shape whose last window starts in the end padding
(the JAX package keeps it; torch's own ceil_mode drops it), exclusive
averages over padded windows, adaptive bins that do not divide, batch
norm's running buffers after three calls (paddle's momentum, the
unbiased running variance), NHWC, ignore_index, class weights and soft
labels; and each function's AMP dispatch under O1 and O2 (the names on
the AMP lists, and the output dtypes)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp                                       # noqa: E402
import paddle_tpu.amp as jamp                                 # noqa: E402
import paddle_tpu.nn as jnn                                   # noqa: E402
import paddle_tpu.nn.functional as JF                         # noqa: E402

import paddle_tpu_torch as tp                                 # noqa: E402
import paddle_tpu_torch.amp as tamp                           # noqa: E402
import paddle_tpu_torch.nn as tnn                             # noqa: E402
import paddle_tpu_torch.nn.functional as TF                   # noqa: E402
from paddle_tpu_torch.core import device as tdevice           # noqa: E402

from torch_op_parity import recording                         # noqa: E402

# fp32 through two frameworks: summation order only
OUT_REL = 1e-5       # outputs, as a fraction of their largest value
GRAD_REL = 1e-4      # gradients, as a fraction of their largest value


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])


def _rng(seed):
    return np.random.default_rng(seed)


def _close(t, j, rel, what):
    """Port array `t` against JAX's `j`: same shape, -inf / NaN in the
    same places, the finite values within rel of the largest."""
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    fin = np.isfinite(j)
    np.testing.assert_array_equal(np.isfinite(t), fin, err_msg=what)
    np.testing.assert_array_equal(t[~fin], j[~fin], err_msg=what)
    scale = max(float(np.abs(j[fin]).max(initial=0.0)), 1e-30)
    err = float(np.abs(t[fin] - j[fin]).max(initial=0.0))
    assert err <= rel * scale, (what, err, scale)


def _both(jfn, tfn, arrays, grad_idx=(0,), seed=99):
    """Run jfn on paddle_tpu Tensors and tfn on paddle_tpu_torch Tensors
    of `arrays`; the inputs at `grad_idx` differentiable. Holds the
    outputs (all float outputs) to OUT_REL and the gradients of
    sum(out * w) to GRAD_REL. Returns (jax outs, port outs)."""
    def run(P, fn):
        ts = [P.to_tensor(a, stop_gradient=i not in grad_idx)
              if isinstance(a, np.ndarray) else a
              for i, a in enumerate(arrays)]
        res = fn(*ts)
        outs = list(res) if isinstance(res, (list, tuple)) else [res]
        outs = [o for o in outs if o is not None]
        rng = _rng(seed)
        loss = None
        for o in outs:
            if np.asarray(o.numpy()).dtype.kind != "f":
                continue
            w = rng.standard_normal(list(o.shape)).astype(np.float32)
            fin = np.isfinite(np.asarray(o.numpy(), np.float64))
            w = np.where(fin, w, 0.0).astype(np.float32)
            term = P.sum(P.multiply(P.where(P.to_tensor(fin), o,
                                            P.zeros_like(o)),
                                    P.to_tensor(w)))
            loss = term if loss is None else loss + term
        if grad_idx:
            loss.backward()
        grads = [ts[i].grad for i in grad_idx]
        return [np.asarray(o.numpy()) for o in outs], \
            [np.asarray(g.numpy()) if g is not None else None
             for g in grads]

    jo, jg = run(jp, jfn)
    to, tg = run(tp, tfn)
    assert len(jo) == len(to)
    for k, (a, b) in enumerate(zip(to, jo)):
        _close(a, b, OUT_REL, f"out {k}")
    for k, (a, b) in enumerate(zip(tg, jg)):
        assert (a is None) == (b is None), f"grad {k}"
        if b is not None:
            _close(a, b, GRAD_REL, f"grad {k}")
    return jo, to


# ------------------------------------------------------------------ conv2d

CONV_CASES = {
    "stride1-pad0-bias": dict(stride=1, padding=0, bias=True),
    "stride2-pad1": dict(stride=2, padding=1),
    "per-dim-ints": dict(padding=[1, 2]),
    "flat-pairs-asym": dict(padding=[1, 2, 0, 1], bias=True),
    "nested-pairs": dict(stride=2, padding=[(0, 1), (2, 1)]),
    "same-stride2": dict(stride=2, padding="SAME", bias=True),
    "same-stride2-dil2": dict(stride=2, padding="SAME", dilation=2),
    "valid": dict(stride=(1, 2), padding="VALID"),
    "dilation2": dict(padding=2, dilation=2),
    "groups2": dict(padding=1, groups=2, bias=True),
    "nhwc-stride2": dict(stride=2, padding=1, data_format="NHWC",
                         bias=True),
    "nhwc-same-stride2": dict(stride=2, padding="SAME",
                              data_format="NHWC"),
}


@pytest.mark.parametrize("name", list(CONV_CASES))
def test_conv2d(name):
    kw = dict(CONV_CASES[name])
    bias = kw.pop("bias", False)
    groups = kw.get("groups", 1)
    rng = _rng(1)
    nhwc = kw.get("data_format") == "NHWC"
    # 8 rows: SAME at stride 2 pads them (0, 1) (and (1, 2) dilated)
    x = rng.standard_normal((2, 8, 11, 4) if nhwc else (2, 4, 8, 11)) \
        .astype(np.float32)
    w = rng.standard_normal((6, 4 // groups, 3, 3)).astype(np.float32)
    arrays = [x, w] + ([rng.standard_normal(6).astype(np.float32)]
                       if bias else [])

    def call(F):
        return lambda *t: F.conv2d(*t[:2], t[2] if bias else None, **kw)

    _both(call(JF), call(TF), arrays, grad_idx=tuple(range(len(arrays))))


def test_same_padding_is_asymmetric_at_stride_2():
    """XLA's SAME at stride 2 on an even size pads (0, 1) for a 3-wide
    kernel: the odd element goes at the end. torch's padding="same"
    refuses stride > 1, so the port pads explicitly."""
    from paddle_tpu_torch.nn.functional.conv import same_pads
    assert same_pads([8, 9], [3, 3], [2, 2]) == [(0, 1), (1, 1)]
    assert same_pads([7], [5], [1]) == [(2, 2)]
    with pytest.raises(Exception):
        torch.nn.functional.conv2d(torch.zeros(1, 1, 8, 8),
                                   torch.zeros(1, 1, 2, 2), stride=2,
                                   padding="same")


# --------------------------------------------------------------- pooling

POOL_CASES = {
    "max-k2s2": ("max", (2, 7, 8), dict(kernel_size=2, stride=2)),
    "max-k3s2p1": ("max", (2, 9, 9), dict(kernel_size=3, stride=2,
                                          padding=1)),
    "max-ceil-partial": ("max", (2, 6, 7), dict(kernel_size=3, stride=2,
                                                padding=1, ceil_mode=True)),
    # the last window starts in the end padding: JAX keeps it (-inf),
    # torch's own ceil_mode would drop it
    "max-ceil-window-in-pad": ("max", (2, 5, 5), dict(
        kernel_size=2, stride=2, padding=1, ceil_mode=True)),
    "max-asym": ("max", (2, 7, 6), dict(kernel_size=3, stride=2,
                                        padding=[0, 1, 1, 0])),
    "max-same": ("max", (2, 8, 7), dict(kernel_size=3, stride=2,
                                        padding="SAME")),
    "max-nhwc": ("max", (2, 9, 9), dict(kernel_size=3, stride=2, padding=1,
                                        data_format="NHWC")),
    "avg-k2s2": ("avg", (2, 8, 6), dict(kernel_size=2, stride=2)),
    "avg-exclusive-pad": ("avg", (2, 9, 7), dict(kernel_size=3, stride=2,
                                                 padding=1)),
    "avg-inclusive-pad": ("avg", (2, 9, 7), dict(kernel_size=3, stride=2,
                                                 padding=1,
                                                 exclusive=False)),
    "avg-divisor": ("avg", (2, 9, 7), dict(kernel_size=3, stride=2,
                                           padding=1, divisor_override=3)),
    "avg-ceil-exclusive": ("avg", (2, 6, 7), dict(kernel_size=3, stride=2,
                                                  padding=1,
                                                  ceil_mode=True)),
    "avg-ceil-window-in-pad": ("avg", (2, 5, 5), dict(
        kernel_size=2, stride=2, padding=1, ceil_mode=True,
        exclusive=False)),
    "avg-asym-exclusive": ("avg", (2, 7, 6), dict(kernel_size=3, stride=2,
                                                  padding=[0, 1, 1, 0])),
    "avg-same": ("avg", (2, 8, 7), dict(kernel_size=3, stride=2,
                                        padding="SAME")),
    "avg-nhwc": ("avg", (2, 9, 7), dict(kernel_size=3, stride=2, padding=1,
                                        data_format="NHWC")),
    "adaptive-ragged": ("adaptive", (3, 7, 5), dict(output_size=(3, 2))),
    "adaptive-divides": ("adaptive", (3, 8, 4), dict(output_size=(2, 2))),
    "adaptive-nhwc": ("adaptive", (3, 7, 5), dict(output_size=(4, 3),
                                                  data_format="NHWC")),
}


def _pool_fn(F, kind):
    return {"max": F.max_pool2d, "avg": F.avg_pool2d,
            "adaptive": F.adaptive_avg_pool2d}[kind]


@pytest.mark.parametrize("name", list(POOL_CASES))
def test_pooling(name):
    kind, (c, h, w), kw = POOL_CASES[name]
    nhwc = kw.get("data_format") == "NHWC"
    # continuous values: no ties among positive maxima
    x = _rng(2).standard_normal((2, h, w, c) if nhwc else (2, c, h, w)) \
        .astype(np.float32)
    jo, _ = _both(lambda t: _pool_fn(JF, kind)(t, **kw),
                  lambda t: _pool_fn(TF, kind)(t, **kw), [x])
    if name.endswith("window-in-pad"):
        # JAX's window count, one more than torch's own ceil_mode rule
        assert jo[0].shape[-1] == 4
        own = (torch.nn.functional.max_pool2d if kind == "max"
               else torch.nn.functional.avg_pool2d)(
            torch.from_numpy(x), 2, 2, 1, ceil_mode=True)
        assert own.shape[-1] == 3


def test_max_pool_return_mask_is_none():
    x = _rng(3).standard_normal((1, 2, 4, 4)).astype(np.float32)
    out, mask = TF.max_pool2d(tp.to_tensor(x), 2, return_mask=True)
    jout, jmask = JF.max_pool2d(jp.to_tensor(x), 2, return_mask=True)
    assert mask is None and jmask is None
    _close(out.numpy(), jout.numpy(), OUT_REL, "out")


# ------------------------------------------------------------- batch_norm

BN_CASES = {
    "train-nchw": dict(training=True),
    "train-nhwc": dict(training=True, data_format="NHWC"),
    "train-momentum-0.5": dict(training=True, momentum=0.5),
    "eval": dict(training=False),
    "global-stats": dict(training=True, use_global_stats=True),
    "train-no-affine": dict(training=True, affine=False),
    "train-2d-input": dict(training=True, shape=(6, 5)),
    # one value a channel: a zero variance (torch's own batch norm
    # refuses it; the port takes the op-by-op route, as JAX computes it)
    "train-one-value": dict(training=True, shape=(1, 5, 1, 1)),
}


@pytest.mark.parametrize("name", list(BN_CASES))
def test_batch_norm(name):
    """Three calls on fresh batches from the same running buffers: every
    output and gradient, then the buffers (paddle's momentum, the
    unbiased running variance)."""
    kw = dict(BN_CASES[name])
    affine = kw.pop("affine", True)
    shape = kw.pop("shape", None)
    nhwc = kw.get("data_format") == "NHWC"
    C = 5
    shape = shape or ((3, 4, 6, C) if nhwc else (3, C, 4, 6))
    rng = _rng(4)
    rm0 = rng.standard_normal(C).astype(np.float32) * 0.1
    rv0 = rng.uniform(0.5, 1.5, C).astype(np.float32)
    wb = [rng.uniform(0.5, 1.5, C).astype(np.float32),
          rng.standard_normal(C).astype(np.float32)] if affine else []
    bufs = {}
    for P in (jp, tp):
        bufs[P] = (P.to_tensor(rm0.copy()), P.to_tensor(rv0.copy()))

    for call in range(3):
        x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)

        def fn(F, P):
            def f(t, *p):
                return F.batch_norm(t, *bufs[P], *p, **kw)
            return f
        _both(fn(JF, jp), fn(TF, tp), [x] + wb,
              grad_idx=tuple(range(1 + len(wb))))
    for k in range(2):
        _close(bufs[tp][k].numpy(), bufs[jp][k].numpy(), OUT_REL,
               f"buffer {k}")
    if kw.get("training") and not kw.get("use_global_stats"):
        assert not np.allclose(bufs[tp][1].numpy(), rv0)


def test_batch_norm_running_update_is_paddles():
    """One call from zeros / ones: mean' = 0.1 * batch mean, var' = 0.9 +
    0.1 * the unbiased batch variance (torch's momentum is the batch's
    weight; passing paddle's 0.9 to it would give 0.9 * batch)."""
    x = _rng(5).standard_normal((4, 3, 2, 2)).astype(np.float32)
    rm, rv = tp.to_tensor(np.zeros(3, np.float32)), \
        tp.to_tensor(np.ones(3, np.float32))
    TF.batch_norm(tp.to_tensor(x), rm, rv, training=True)
    xs = x.transpose(1, 0, 2, 3).reshape(3, -1).astype(np.float64)
    np.testing.assert_allclose(rm.numpy(), 0.1 * xs.mean(1), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(rv.numpy(), 0.9 + 0.1 * xs.var(1, ddof=1),
                               rtol=1e-5)


# ---------------------------------------------------------- cross_entropy

def _ce_inputs(case, rng):
    N, C = 6, 5
    logits = rng.standard_normal((N, C)).astype(np.float32) * 2
    if case.get("soft_label"):
        lab = rng.uniform(size=(N, C)).astype(np.float32)
        return logits, lab / lab.sum(1, keepdims=True)
    lab = rng.integers(0, C, (N,)).astype(np.int64)
    if case.get("ignore"):
        lab[[1, 4]] = -100 if case["ignore"] is True else case["ignore"]
    if case.get("col"):
        lab = lab[:, None]
    if case.get("probs"):
        logits = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return logits, lab


CE_CASES = {
    "labels-n": {},
    "labels-n1": dict(col=True),
    "ignore-index": dict(ignore=True, col=True),
    "ignore-index-3": dict(ignore=3, kw=dict(ignore_index=3)),
    "weight": dict(weight=True),
    "weight-ignore": dict(weight=True, ignore=True),
    "weight-sum": dict(weight=True, kw=dict(reduction="sum")),
    "none": dict(ignore=True, kw=dict(reduction="none")),
    "sum": dict(kw=dict(reduction="sum")),
    "soft-label": dict(soft_label=True, kw=dict(soft_label=True)),
    "use-softmax-false": dict(probs=True, kw=dict(use_softmax=False)),
}


@pytest.mark.parametrize("name", list(CE_CASES))
def test_cross_entropy(name):
    case = CE_CASES[name]
    rng = _rng(6)
    logits, lab = _ce_inputs(case, rng)
    kw = dict(case.get("kw", {}))
    arrays = [logits, lab]
    if case.get("weight"):
        arrays.append(rng.uniform(0.2, 2.0, logits.shape[1])
                      .astype(np.float32))

    def call(F):
        return lambda lo, la, *w: F.cross_entropy(
            lo, la, weight=w[0] if w else None, **kw)

    _both(call(JF), call(TF), arrays, grad_idx=(0,))


@pytest.mark.parametrize("return_softmax", [False, True])
def test_softmax_with_cross_entropy(return_softmax):
    rng = _rng(7)
    logits, lab = _ce_inputs(dict(col=True, ignore=True), rng)

    def call(F):
        return lambda lo, la: F.softmax_with_cross_entropy(
            lo, la, return_softmax=return_softmax)

    jo, to = _both(call(JF), call(TF), [logits, lab])
    assert to[0].shape == (6, 1)


# ------------------------------------------------------ AMP dispatch, O2

def _dispatch_cases():
    rng = _rng(8)
    x = rng.standard_normal((2, 4, 6, 6)).astype(np.float32)
    w = rng.standard_normal((3, 4, 3, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    c = rng.standard_normal(4).astype(np.float32)
    logits = rng.standard_normal((4, 5)).astype(np.float32)
    lab = rng.integers(0, 5, (4, 1)).astype(np.int64)
    return {
        "conv2d": (lambda F, P, t: F.conv2d(t[0], t[1], t[2], padding=1),
                   [x, w, b]),
        "max_pool2d": (lambda F, P, t: F.max_pool2d(t[0], 3, 2, 1), [x]),
        "avg_pool2d": (lambda F, P, t: F.avg_pool2d(t[0], 3, 2, 1), [x]),
        "adaptive_avg_pool2d": (
            lambda F, P, t: F.adaptive_avg_pool2d(t[0], (2, 3)), [x]),
        "batch_norm-train": (
            lambda F, P, t: F.batch_norm(t[0], P.to_tensor(np.zeros(4,
                                                                    "f4")),
                                         P.to_tensor(np.ones(4, "f4")),
                                         t[1], t[2], training=True),
            [x, c, c]),
        "batch_norm-eval": (
            lambda F, P, t: F.batch_norm(t[0], t[1], t[2] * t[2],
                                         training=False), [x, c, c]),
        "cross_entropy": (lambda F, P, t: F.cross_entropy(t[0], t[1]),
                          [logits, lab]),
        "softmax_with_cross_entropy": (
            lambda F, P, t: F.softmax_with_cross_entropy(t[0], t[1]),
            [logits, lab]),
    }


def _listed(names, amp_mod):
    """The dispatch names on an AMP list; every other name is gray."""
    return sorted({n if n in amp_mod.WHITE_LIST | amp_mod.BLACK_LIST
                   else "gray" for n in names})


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("name", list(_dispatch_cases()))
def test_amp_dispatch(name, level):
    """Under auto_cast(level, bfloat16) on fp32 inputs (and on bf16
    activations, as the previous layer hands them on under O2): the
    names on the AMP lists the function casts under, and the output
    dtypes, equal the JAX package's. conv2d leaves bf16, batch_norm and
    cross_entropy fp32, the pools bf16 under O2 only."""
    fn, arrays = _dispatch_cases()[name]
    for act in ("float32", "bfloat16"):
        out = {}
        for P, F, amp_mod in ((jp, JF, jamp), (tp, TF, tamp)):
            with recording() as (jn, tn):
                ts = [P.to_tensor(a) for a in arrays]
                if act == "bfloat16":
                    ts[0] = P.cast(ts[0], "bfloat16") \
                        if ts[0].dtype != P.int64 else ts[0]
                with amp_mod.auto_cast(level=level, dtype="bfloat16"):
                    res = fn(F, P, ts)
            outs = res if isinstance(res, (list, tuple)) else [res]
            names = jn if P is jp else tn
            out[P] = ([str(o.dtype).split(".")[-1] for o in outs],
                      _listed(names, amp_mod))
        assert out[tp] == out[jp], (act, out)


# ----------------------------------------------------------------- layers

def _layer_cases():
    """(constructor, input shape): the shapes of the functional cases
    above, so that the JAX package's eager ops are compiled once."""
    return {
        "Conv2D": (lambda nn: nn.Conv2D(4, 6, 3, stride=2, padding="SAME"),
                   (2, 4, 8, 11)),
        "Conv2D-nhwc-nobias": (lambda nn: nn.Conv2D(
            4, 6, 3, stride=2, padding="SAME", bias_attr=False,
            data_format="NHWC"), (2, 8, 11, 4)),
        "MaxPool2D": (lambda nn: nn.MaxPool2D(3, 2, 1), (2, 2, 9, 9)),
        "AvgPool2D": (lambda nn: nn.AvgPool2D(3, 2, 1, ceil_mode=True),
                      (2, 2, 6, 7)),
        "AdaptiveAvgPool2D": (lambda nn: nn.AdaptiveAvgPool2D((3, 2)),
                              (2, 3, 7, 5)),
        "BatchNorm2D": (lambda nn: nn.BatchNorm2D(5), (3, 5, 4, 6)),
        "BatchNorm2D-nhwc": (lambda nn: nn.BatchNorm2D(
            5, momentum=0.8, data_format="NHWC"), (3, 4, 6, 5)),
        "BatchNorm-act": (lambda nn: nn.BatchNorm(5, act="relu"),
                          (3, 5, 4, 6)),
        "ReLU": (lambda nn: nn.ReLU(), (2, 3, 4)),
        "Flatten": (lambda nn: nn.Flatten(), (2, 3, 4, 5)),
        "Sequential": (lambda nn: nn.Sequential(
            nn.Conv2D(3, 4, 3, padding=1), nn.BatchNorm2D(4), nn.ReLU(),
            nn.MaxPool2D(2, 2), nn.Flatten()), (2, 3, 6, 6)),
    }


ZERO_GRADS = {"Sequential": ("0.bias",)}


@pytest.mark.parametrize("name", list(_layer_cases()))
def test_layer(name):
    """The layer built in both packages, the JAX one's state_dict loaded
    into the port's (parameters and buffers, key for key); a training
    call (two where the layer keeps running statistics): outputs, the
    input's and every parameter's gradient, and the state after."""
    ctor, shape = _layer_cases()[name]
    jp.seed(0)
    jl, tl = ctor(jnn), ctor(tnn)
    sd = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert sorted(sd) == sorted(tl.state_dict())
    assert tl.set_state_dict(sd) == ([], [])
    rng = _rng(9)
    for _ in range(2 if "Batch" in name or name == "Sequential" else 1):
        x = rng.standard_normal(shape).astype(np.float32)
        w = None
        res = {}
        for P, layer in ((jp, jl), (tp, tl)):
            layer.train()
            t = P.to_tensor(x, stop_gradient=False)
            out = layer(t)
            if w is None:
                w = rng.standard_normal(list(out.shape)).astype(np.float32)
            P.sum(P.multiply(out, P.to_tensor(w))).backward()
            res[P] = (out.numpy(), t.grad.numpy(),
                      {n: p.grad.numpy() for n, p in layer.named_parameters()})
            layer.clear_gradients() if P is jp else layer.zero_grad()
        _close(res[tp][0], res[jp][0], OUT_REL, "out")
        _close(res[tp][1], res[jp][1], GRAD_REL, "input grad")
        top = max((float(np.abs(g).max()) for g in res[jp][2].values()),
                  default=0.0)
        for n, g in res[jp][2].items():
            if n in ZERO_GRADS.get(name, ()):
                # a conv bias feeding a batch norm: its gradient is 0 in
                # exact arithmetic (the norm removes a per-channel
                # shift), all rounding; held to the largest of all
                err = float(np.abs(res[tp][2][n] - g).max())
                assert err <= GRAD_REL * top, (n, err, top)
                continue
            _close(res[tp][2][n], g, GRAD_REL, n)
    for k, v in jl.state_dict().items():
        _close(tl.state_dict()[k].numpy(), v.numpy(), OUT_REL, k)


def test_cross_entropy_loss_layer():
    rng = _rng(10)
    logits, lab = _ce_inputs(dict(col=True, ignore=True, weight=True), rng)
    wt = rng.uniform(0.2, 2.0, 5).astype(np.float32)
    _both(lambda lo, la: jnn.CrossEntropyLoss(weight=jp.to_tensor(wt))(
        lo, la),
        lambda lo, la: tnn.CrossEntropyLoss(weight=tp.to_tensor(wt))(lo, la),
        [logits, lab])


def test_conv2d_default_init_and_attrs():
    """Normal(0, sqrt(2 / fan_in)) with fan_in = in/groups * kh * kw, a
    zero bias, no bias with bias_attr=False; BN weight ones, bias zeros,
    _mean zeros, _variance ones; padding_mode other than zeros raises."""
    tp.seed(0)
    conv = tnn.Conv2D(64, 128, 3, groups=2)
    std = float(conv.weight.detach().std())
    assert abs(std / (2.0 / (32 * 9)) ** 0.5 - 1) < 0.02, std
    assert list(conv.weight.shape) == [128, 32, 3, 3]
    assert not conv.bias.detach().any()
    assert tnn.Conv2D(3, 4, 1, bias_attr=False).bias is None
    bn = tnn.BatchNorm2D(4)
    assert bn.weight.detach().tolist() == [1.0] * 4
    assert bn._mean.tolist() == [0.0] * 4 and bn._variance.tolist() == [1.0] * 4
    assert sorted(bn.state_dict()) == ["_mean", "_variance", "bias", "weight"]
    with pytest.raises(NotImplementedError):
        tnn.Conv2D(3, 4, 3, padding_mode="reflect")


@pytest.mark.parametrize("act,fused", [("bfloat16", True),
                                       ("float32", False)])
def test_batch_norm_route_under_o2(monkeypatch, act, fused):
    """Under O2 a bf16 activation (what a convolution hands on) is
    normalized by one `torch.nn.functional.batch_norm` call on its fp32
    cast: the statistics see the same values. An fp32 activation reaches
    the statistics rounded to bf16 (the JAX package's gray op), so it
    takes the op-by-op route."""
    from paddle_tpu_torch.nn.functional import norm
    calls = []
    real = norm.TF.batch_norm
    monkeypatch.setattr(norm.TF, "batch_norm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.randn(4, 3, 5, 5).to(getattr(torch, act))
    rm, rv = torch.zeros(3), torch.ones(3)
    with tamp.auto_cast(level="O2", dtype="bfloat16"):
        out = TF.batch_norm(x, rm, rv, torch.ones(3), torch.zeros(3),
                            training=True)
    assert out.dtype == torch.float32 and bool(calls) == fused


def test_batch_norm_with_bf16_buffers():
    """A model cast to bf16 keeps bf16 running buffers: the normalized
    output (batch statistics) equals the fp32-buffer call's, and the
    buffers take the same update rounded to bf16."""
    x = torch.randn(4, 3, 5, 5)
    outs, bufs = [], []
    for dt in (torch.float32, torch.bfloat16):
        rm, rv = torch.zeros(3, dtype=dt), torch.ones(3, dtype=dt)
        outs.append(TF.batch_norm(x, rm, rv, training=True))
        bufs.append((rm, rv))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-6)
    for a, b in zip(bufs[1], bufs[0]):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, b.to(torch.bfloat16))
