"""paddle_tpu_torch's training lifecycle against the JAX package, on the
CPU: every LR scheduler's sequence and mid-run state (exact); one step of
SGD, Momentum (multi_precision too), Adam (coupled weight decay), AdamW
and each clip and regularizer against the JAX eager `step()` on the same
arrays (fp32 rtol 1e-6); the metrics (exact); and a gpt_tiny `Model.fit`
with AdamW + LinearWarmup(CosineAnnealingDecay) + ClipGradByGlobalNorm +
eval_data + save_dir in both packages (losses within FIT_TOL), then each
package's `.pdparams` / `.pdopt` loaded by the other, bit for bit, and
trained on in both."""
import dataclasses
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

import paddle_tpu as paddle                                   # noqa: E402
import paddle_tpu.metric as jmetric                           # noqa: E402
import paddle_tpu.nn as jnn                                   # noqa: E402
import paddle_tpu.nn.functional as jF                         # noqa: E402
import paddle_tpu.optimizer as jopt                           # noqa: E402
import paddle_tpu.regularizer as jreg                         # noqa: E402
from paddle_tpu.core.tensor import Tensor as JTensor          # noqa: E402
from paddle_tpu.framework import Parameter as JParameter      # noqa: E402
from paddle_tpu.hapi import Model as JModel                   # noqa: E402
from paddle_tpu.hapi import callbacks as jcbks                # noqa: E402
from paddle_tpu.io import TensorDataset as JTensorDataset     # noqa: E402
from paddle_tpu.models import GPT as JGPT                     # noqa: E402
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny       # noqa: E402
from paddle_tpu.static import InputSpec as JInputSpec         # noqa: E402

import paddle_tpu_torch as ptt                                # noqa: E402
import paddle_tpu_torch.metric as tmetric                     # noqa: E402
import paddle_tpu_torch.nn as tnn                             # noqa: E402
import paddle_tpu_torch.optimizer as topt                     # noqa: E402
import paddle_tpu_torch.regularizer as treg                   # noqa: E402
from paddle_tpu_torch.core import arrays as tarrays           # noqa: E402
from paddle_tpu_torch.core import device as tdevice           # noqa: E402
from paddle_tpu_torch.framework import stacked_layout         # noqa: E402
from paddle_tpu_torch.hapi import Model as TModel             # noqa: E402
from paddle_tpu_torch.hapi import callbacks as tcbks          # noqa: E402
from paddle_tpu_torch.io import TensorDataset as TTensorDataset  # noqa: E402
from paddle_tpu_torch.models import GPT as TGPT               # noqa: E402
from paddle_tpu_torch.models.gpt import gpt_tiny as tgpt_tiny  # noqa: E402
from paddle_tpu_torch.static import InputSpec as TInputSpec   # noqa: E402

# one optimizer step in fp32: the same ops in the same order, so the two
# packages differ by at most an ulp or so per element
OPT_RTOL = 1e-6
# gpt_tiny through several AdamW steps, as tests/test_torch_train.py bounds
# its Adam fit: summation-order differences amplified through 1/sqrt(v)
FIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])


# ------------------------------------------------------- LR schedulers

def _schedulers(lr):
    """name -> (constructor of lr's module, metrics fed to step or None)."""
    return {
        "noam": lambda: lr.NoamDecay(d_model=64, warmup_steps=5,
                                     learning_rate=2.0),
        "piecewise": lambda: lr.PiecewiseDecay([5, 12], [0.1, 0.05, 0.01]),
        "natural_exp": lambda: lr.NaturalExpDecay(0.1, gamma=0.1),
        "inverse_time": lambda: lr.InverseTimeDecay(0.1, gamma=0.5),
        "polynomial": lambda: lr.PolynomialDecay(0.1, decay_steps=10,
                                                 end_lr=1e-3, power=2.0),
        "polynomial_cycle": lambda: lr.PolynomialDecay(
            0.1, decay_steps=7, end_lr=1e-3, cycle=True),
        "linear_warmup_cosine": lambda: lr.LinearWarmup(
            lr.CosineAnnealingDecay(6e-4, T_max=8), warmup_steps=2,
            start_lr=0.0, end_lr=6e-4),
        "linear_warmup_float": lambda: lr.LinearWarmup(
            0.1, warmup_steps=5, start_lr=0.01, end_lr=0.1),
        "exponential": lambda: lr.ExponentialDecay(0.1, gamma=0.9),
        "multi_step": lambda: lr.MultiStepDecay(0.1, [3, 7, 20], gamma=0.5),
        "step": lambda: lr.StepDecay(0.1, step_size=4, gamma=0.5),
        "lambda": lambda: lr.LambdaDecay(0.1, lambda e: 0.95 ** e),
        "reduce_on_plateau": lambda: lr.ReduceOnPlateau(
            0.1, patience=2, cooldown=1, factor=0.5),
        "cosine": lambda: lr.CosineAnnealingDecay(0.1, T_max=10,
                                                  eta_min=1e-3),
        "one_cycle": lambda: lr.OneCycleLR(0.1, total_steps=20),
        "one_cycle_linear": lambda: lr.OneCycleLR(
            0.1, total_steps=25, anneal_strategy="linear", phase_pct=0.2),
        "cyclic_triangular2": lambda: lr.CyclicLR(
            0.01, 0.1, step_size_up=4, step_size_down=3,
            mode="triangular2"),
        "cyclic_exp_range": lambda: lr.CyclicLR(
            0.01, 0.1, step_size_up=5, mode="exp_range", exp_gamma=0.97),
        "cyclic_scale_fn": lambda: lr.CyclicLR(
            0.01, 0.1, step_size_up=3, scale_fn=lambda c: 1.0 / c,
            scale_mode="cycle"),
    }


_PLATEAU = [1.0, 0.9, 0.95, 0.97, 0.96, 0.99, 0.8, 0.85, 0.86, 0.9] * 3


def _run_sched(s, steps, offset=0, plateau=False):
    out = []
    for i in range(steps):
        out.append(s())
        if plateau:
            s.step(_PLATEAU[offset + i])
        else:
            s.step()
    return out


@pytest.mark.parametrize("name", sorted(_schedulers(topt.lr)))
def test_lr_scheduler_sequence_and_state_match_jax(name):
    plateau = name == "reduce_on_plateau"
    js, ts = _schedulers(jopt.lr)[name](), _schedulers(topt.lr)[name]()
    assert _run_sched(ts, 15, 0, plateau) == _run_sched(js, 15, 0, plateau)
    sd = js.state_dict()
    assert ts.state_dict() == sd
    # a fresh port scheduler takes the JAX state mid-run and carries on
    resumed = _schedulers(topt.lr)[name]()
    resumed.set_state_dict(sd)
    want = _run_sched(js, 15, 15, plateau)
    assert _run_sched(resumed, 15, 15, plateau) == want
    assert _run_sched(ts, 15, 15, plateau) == want


# ------------------------------------------------ one optimizer step

_SHAPES = {"w": (8, 6), "b": (6,), "e": (5, 6)}


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in _SHAPES.items()}


def _opt_cases():
    """name -> (build(pkg, params), dtype, steps). pkg is a namespace of
    the package's optimizer, nn, lr and regularizer modules."""
    return {
        "sgd": (lambda m, P: m.opt.SGD(0.1, parameters=P), "float32", 1),
        "sgd_coupled_wd": (lambda m, P: m.opt.SGD(
            0.1, parameters=P, weight_decay=0.01), "float32", 2),
        "sgd_l1": (lambda m, P: m.opt.SGD(
            0.1, parameters=P, weight_decay=m.reg.L1Decay(0.01)),
            "float32", 1),
        "momentum_l2_nesterov": (lambda m, P: m.opt.Momentum(
            0.05, momentum=0.9, parameters=P, use_nesterov=True,
            weight_decay=m.reg.L2Decay(0.02)), "float32", 2),
        "momentum_multi_precision_bf16": (lambda m, P: m.opt.Momentum(
            0.05, parameters=P, multi_precision=True, weight_decay=1e-3),
            "bfloat16", 2),
        "momentum_clip_value": (lambda m, P: m.opt.Momentum(
            0.05, parameters=P, grad_clip=m.nn.ClipGradByValue(0.3)),
            "float32", 1),
        "adam_coupled_wd": (lambda m, P: m.opt.Adam(
            1e-2, parameters=P, weight_decay=0.01), "float32", 3),
        "adam_clip_norm": (lambda m, P: m.opt.Adam(
            1e-2, parameters=P, grad_clip=m.nn.ClipGradByNorm(0.5)),
            "float32", 2),
        "adamw": (lambda m, P: m.opt.AdamW(
            1e-2, beta1=0.9, beta2=0.95, parameters=P, weight_decay=0.1),
            "float32", 3),
        "adamw_clip_global_schedule": (lambda m, P: m.opt.AdamW(
            m.lr.LinearWarmup(m.lr.CosineAnnealingDecay(6e-3, T_max=8),
                              warmup_steps=2, start_lr=0.0, end_lr=6e-3),
            beta2=0.95, parameters=P, weight_decay=0.1,
            grad_clip=m.nn.ClipGradByGlobalNorm(1.0)), "float32", 4),
        # the JAX package ignores both arguments (ROADMAP queue 3): every
        # parameter decays at the full lr in both packages
        "adamw_decay_fun_unused": (lambda m, P: m.opt.AdamW(
            1e-2, parameters=P, weight_decay=0.05,
            apply_decay_param_fun=lambda n: False, lr_ratio=lambda p: 0.5,
            grad_clip=m.nn.ClipGradByGlobalNorm(0.1)), "float32", 2),
        # "b" carries its own L1Decay, which overrides the optimizer's
        "momentum_param_regularizer": (lambda m, P: m.opt.Momentum(
            0.05, parameters=P, weight_decay=m.reg.L2Decay(0.02),
            grad_clip=m.nn.ClipGradByGlobalNorm(0.1)), "float32", 2),
    }


class _NS:
    def __init__(self, **kw):
        self.__dict__.update(kw)


_J = _NS(opt=jopt, nn=jnn, lr=jopt.lr, reg=jreg)
_T = _NS(opt=topt, nn=tnn, lr=topt.lr, reg=treg)


def _jax_params(arrays, dtype):
    return {k: JParameter(jnp.asarray(v).astype(dtype))
            for k, v in arrays.items()}


def _port_params(arrays, dtype):
    return {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(
        getattr(torch, dtype))) for k, v in arrays.items()}


def _np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.detach().float().numpy()


def _close(got, want, what):
    got, want = _np32(got), _np32(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=OPT_RTOL,
                               atol=OPT_RTOL * scale, err_msg=what)


@pytest.mark.parametrize("case", sorted(_opt_cases()))
def test_optimizer_step_matches_jax_eager(case):
    build, dtype, steps = _opt_cases()[case]
    init = _arrays(0)
    jp, tp = _jax_params(init, dtype), _port_params(init, dtype)
    if case == "momentum_param_regularizer":
        jp["b"].regularizer = jreg.L1Decay(0.03)
        tp["b"].regularizer = treg.L1Decay(0.03)
    jo = build(_J, list(jp.values()))
    to = build(_T, list(tp.values()))
    for s in range(steps):
        grads = _arrays(10 + s, scale=0.7)
        for k in init:
            jp[k].grad = JTensor(jnp.asarray(grads[k]).astype(dtype))
            tp[k].grad = torch.from_numpy(grads[k].copy()).to(
                getattr(torch, dtype))
        jo.step()
        to.step()
        if jo._lr_scheduler is not None:
            jo._lr_scheduler.step()
            to._lr_scheduler.step()
    for k in init:
        assert tp[k].dtype == getattr(torch, dtype)
        _close(tp[k], jp[k]._data, f"{case} param {k}")
        jst = jo._state[id(jp[k])]
        tst = to.state(tp[k])
        assert set(tst) == set(jst)
        for slot in jst:
            _close(torch.as_tensor(np.asarray(tst[slot], np.float32))
                   if not isinstance(tst[slot], torch.Tensor)
                   else tst[slot], jst[slot], f"{case} {k} {slot}")
    assert to.get_lr() == jo.get_lr()


def test_optimizer_state_dict_round_trip():
    init = _arrays(0)
    tp = _port_params(init, "float32")
    sched = topt.lr.StepDecay(0.1, step_size=2)
    to = topt.AdamW(sched, parameters=list(tp.values()))
    for s in range(3):
        for k, g in _arrays(20 + s).items():
            tp[k].grad = torch.from_numpy(g)
        to.step()
        sched.step()
    sd = to.state_dict()
    assert set(sd) == {"LR_Scheduler"} | {
        f"param_{i}_{slot}" for i in range(3)
        for slot in ("moment1", "moment2", "beta1_pow", "beta2_pow")}
    tp2 = _port_params(init, "float32")
    sched2 = topt.lr.StepDecay(0.1, step_size=2)
    to2 = topt.AdamW(sched2, parameters=list(tp2.values()))
    to2.set_state_dict(sd)
    assert sched2.last_epoch == 3 and to2.get_lr() == to.get_lr()
    for a, b in zip(tp.values(), tp2.values()):
        for slot, v in to.state(a).items():
            w = to2.state(b)[slot]
            assert (torch.equal(v, w) if isinstance(v, torch.Tensor)
                    else v == w and type(v) is type(w))
    with pytest.raises(ValueError):
        to.set_lr(0.5)


def test_clip_keeps_the_global_norm_on_the_device():
    g = [torch.full((3,), 3.0), torch.full((4,), 2.0)]
    clip = tnn.ClipGradByGlobalNorm(1.0)
    clip([(None, x) for x in g])
    want = float(np.sqrt(27.0 + 16.0))
    assert isinstance(clip.global_norm, torch.Tensor)
    assert float(clip.global_norm) == pytest.approx(want, rel=1e-6)
    total = float(torch.linalg.vector_norm(torch.cat(g)))
    assert total == pytest.approx(1.0, rel=1e-6)


# ---------------------------------------------------------- metrics

def test_metrics_match_jax_exactly():
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((6, 5, 10)).astype(np.float32)
    label = rng.integers(0, 10, (6, 5)).astype(np.int64)
    for topk in ((1,), (1, 5)):
        ja, ta = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
        for i in range(2):
            jc = ja.compute(JTensor(jnp.asarray(pred[3 * i:3 * i + 3])),
                            JTensor(jnp.asarray(label[3 * i:3 * i + 3])))
            tc = ta.compute(torch.from_numpy(pred[3 * i:3 * i + 3]),
                            torch.from_numpy(label[3 * i:3 * i + 3]))
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc._data))
            np.testing.assert_array_equal(ta.update(tc), ja.update(jc))
        assert ta.accumulate() == ja.accumulate() and ta.name() == ja.name()
    # one-hot and column labels
    onehot = np.eye(10, dtype=np.float32)[label[0]]
    np.testing.assert_array_equal(
        tmetric.Accuracy().compute(torch.from_numpy(pred[0]),
                                   torch.from_numpy(onehot)).numpy(),
        np.asarray(jmetric.Accuracy().compute(
            JTensor(jnp.asarray(pred[0])), JTensor(jnp.asarray(onehot)))
            ._data))
    probs = rng.random(200).astype(np.float32)
    bits = (rng.random(200) < 0.4).astype(np.int64)
    for cls in ("Precision", "Recall", "Auc"):
        jm, tm = getattr(jmetric, cls)(), getattr(tmetric, cls)()
        for sl in (slice(0, 120), slice(120, 200)):
            jm.update(probs[sl], bits[sl])
            tm.update(torch.from_numpy(probs[sl]), torch.from_numpy(bits[sl]))
        assert tm.accumulate() == jm.accumulate() and tm.name() == jm.name()
    two = np.stack([1 - probs, probs], axis=1)
    ja, ta = jmetric.Auc(num_thresholds=255), tmetric.Auc(num_thresholds=255)
    ja.update(two, bits)
    ta.update(two, bits)
    assert ta.accumulate() == ja.accumulate()
    for k in (1, 3):
        got = tmetric.accuracy(torch.from_numpy(pred[0]),
                               torch.from_numpy(label[0][:, None]), k=k)
        want = jmetric.accuracy(JTensor(jnp.asarray(pred[0])),
                                JTensor(jnp.asarray(label[0][:, None])), k=k)
        assert float(got) == float(np.asarray(want._data))


# ------------------------------------------------------------- Model.fit

B, T, VOCAB = 4, 32, 512


class _JLM(jnn.Layer):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, ids):
        return self.m(ids)


class _TLM(tnn.Layer):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, ids):
        return self.m(ids)


def _jloss(logits, labels):
    return jF.cross_entropy(paddle.reshape(logits, [-1, VOCAB]),
                            paddle.reshape(labels, [-1]), ignore_index=-100)


def _tloss(logits, labels):
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, VOCAB).float(), labels.reshape(-1).long(),
        ignore_index=-100)


class _Rec:
    """Losses per train batch and the logs of each epoch's end."""

    def __init__(self, base):
        class R(base):
            def __init__(s):
                super().__init__()
                s.losses, s.epochs = [], []

            def on_train_batch_end(s, step, logs=None):
                s.losses.append(float(logs["loss"]))

            def on_epoch_end(s, epoch, logs=None):
                s.epochs.append({k: float(v) for k, v in logs.items()})
        self.cb = R()


def _data(n, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (n, T), dtype=np.int32)
    labels = np.concatenate([ids[:, 1:], ids[:, :1]], axis=1)
    labels[0, :3] = -100
    return ids, labels


def _sched(lr):
    return lr.LinearWarmup(lr.CosineAnnealingDecay(3e-3, T_max=8),
                           warmup_steps=2, start_lr=0.0, end_lr=3e-3)


def _jmodel(dtype="float32", opt="adamw"):
    paddle.seed(0)
    jgpt = JGPT(dataclasses.replace(jgpt_tiny(), max_seq_len=T))
    if dtype != "float32":
        jgpt.astype(dtype)
    model = JModel(_JLM(jgpt), inputs=[JInputSpec([None, T], "int32")],
                   labels=[JInputSpec([None, T], "int32")])
    if opt == "adamw":
        o = jopt.AdamW(_sched(jopt.lr), beta1=0.9, beta2=0.95,
                       weight_decay=0.1,
                       grad_clip=jnn.ClipGradByGlobalNorm(1.0),
                       parameters=model.parameters())
    else:
        o = jopt.Momentum(0.05, parameters=model.parameters())
    model.prepare(o, loss=_jloss, metrics=[jmetric.Accuracy()])
    return model, jgpt


def _tmodel(arrays, dtype="float32", opt="adamw"):
    tgpt = TGPT(dataclasses.replace(tgpt_tiny(), max_seq_len=T)) \
        .load_numpy(arrays)
    if dtype != "float32":
        tgpt.astype(dtype)
    model = TModel(_TLM(tgpt), inputs=[TInputSpec([None, T], "int32")],
                   labels=[TInputSpec([None, T], "int32")])
    if opt == "adamw":
        o = topt.AdamW(_sched(topt.lr), beta1=0.9, beta2=0.95,
                       weight_decay=0.1,
                       grad_clip=tnn.ClipGradByGlobalNorm(1.0),
                       parameters=model.parameters())
    else:
        o = topt.Momentum(0.05, parameters=model.parameters())
    model.prepare(o, loss=_tloss, metrics=[tmetric.Accuracy()])
    return model, tgpt


def _jfit(model, data, epochs, save_dir=None, eval_data=None):
    rec = _Rec(jcbks.Callback)
    model.fit(JTensorDataset(list(data)), batch_size=B, epochs=epochs,
              verbose=0, shuffle=False, save_dir=save_dir,
              eval_data=None if eval_data is None
              else JTensorDataset(list(eval_data)),
              callbacks=[jcbks.LRScheduler(by_step=True), rec.cb])
    return rec.cb


def _tfit(model, data, epochs, save_dir=None, eval_data=None):
    rec = _Rec(tcbks.Callback)
    model.fit(TTensorDataset(list(data)), batch_size=B, epochs=epochs,
              verbose=0, shuffle=False, save_dir=save_dir,
              eval_data=None if eval_data is None
              else TTensorDataset(list(eval_data)),
              callbacks=[tcbks.LRScheduler(by_step=True), rec.cb])
    return rec.cb


def _jax_state(jgpt):
    return {k: np.asarray(v._data) for k, v in jgpt.state_dict().items()}


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """Both packages through fit: 2 epochs x 3 steps, eval each epoch,
    checkpoints in save_dir."""
    tdevice._DEFAULT[0] = torch.device("cpu")
    root = tmp_path_factory.mktemp("fit")
    train, ev = _data(3 * B, 5), _data(2 * B, 6)
    jm, jgpt = _jmodel()
    tm, tgpt = _tmodel(_jax_state(jgpt))
    jrec = _jfit(jm, train, 2, str(root / "jax"), ev)
    trec = _tfit(tm, train, 2, str(root / "port"), ev)
    tdevice._DEFAULT[0] = None
    return _NS(root=root, jm=jm, tm=tm, jgpt=jgpt, tgpt=tgpt, jrec=jrec,
               trec=trec, train=train, ev=ev)


def test_fit_adamw_warmup_clip_eval_tracks_jax(fitted):
    f = fitted
    assert len(f.trec.losses) == len(f.jrec.losses) == 6
    np.testing.assert_allclose(f.trec.losses, f.jrec.losses, rtol=FIT_TOL,
                               atol=FIT_TOL)
    assert f.trec.losses[-1] < f.trec.losses[0]
    for te, je in zip(f.trec.epochs, f.jrec.epochs):
        assert set(te) == set(je)
        np.testing.assert_allclose(te["eval_loss"], je["eval_loss"],
                                   rtol=FIT_TOL, atol=FIT_TOL)
        # the metrics of a train batch (no strategy) and of the eval set
        assert te["acc"] == je["acc"] and te["eval_acc"] == je["eval_acc"]
    assert f.tm._optimizer.get_lr() == f.jm._optimizer.get_lr()
    assert sorted(os.listdir(f.root / "port")) == \
        sorted(os.listdir(f.root / "jax")) == sorted(
            f"{n}.{e}" for n in ("0", "1", "final")
            for e in ("pdparams", "pdopt"))


def _assert_state_bit_equal(tmodel, jax_sd, jax_fs, jax_sched):
    net = tmodel.network
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(tarrays.to_numpy(v), jax_sd[k],
                                      err_msg=k)
        assert tarrays.to_numpy(v).dtype == jax_sd[k].dtype, k
    fs = stacked_layout(tmodel._optimizer.functional_state(
        net.named_parameters()), net)
    assert set(fs) == set(jax_fs)
    for n, slots in jax_fs.items():
        assert set(fs[n]) == set(slots)
        for s, v in slots.items():
            np.testing.assert_array_equal(fs[n][s], np.asarray(v),
                                          err_msg=f"{n} {s}")
            assert fs[n][s].dtype == np.asarray(v).dtype, (n, s)
    assert tmodel._optimizer._scheduler_state() == jax_sched


def _read_pdopt(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_jax_checkpoint_loads_in_the_port_and_trains_on(fitted):
    f = fitted
    prefix = str(f.root / "jax" / "final")
    jm2, jgpt2 = _jmodel()
    jm2.load(prefix)
    tm2, _ = _tmodel(_jax_state(jgpt2))
    tm2.load(prefix)
    opt = _read_pdopt(prefix + ".pdopt")
    _assert_state_bit_equal(tm2, _jax_state(f.jm.network),
                            opt["functional_state"],
                            opt["LR_Scheduler"])
    more = _data(2 * B, 7)
    jl, tl = _jfit(jm2, more, 1).losses, _tfit(tm2, more, 1).losses
    assert len(tl) == len(jl) == 2
    np.testing.assert_allclose(tl, jl, rtol=FIT_TOL, atol=FIT_TOL)


def test_port_checkpoint_loads_in_jax_and_trains_on(fitted):
    f = fitted
    prefix = str(f.root / "port" / "final")
    jm2, jgpt2 = _jmodel()
    jm2.load(prefix)
    jsd = _jax_state(jgpt2)
    for k, v in f.tgpt.state_dict().items():
        np.testing.assert_array_equal(jsd[k], tarrays.to_numpy(v), err_msg=k)
    fs = stacked_layout(f.tm._optimizer.functional_state(
        f.tm.network.named_parameters()), f.tm.network)
    restored = jm2._restored_opt_state
    assert set(restored) == set(fs)
    for n, slots in fs.items():
        for s, v in slots.items():
            np.testing.assert_array_equal(np.asarray(restored[n][s]), v)
    assert jm2._optimizer._lr_scheduler.state_dict() == \
        f.tm._optimizer._scheduler_state()
    tm2, _ = _tmodel(_jax_state(jgpt2))
    tm2.load(prefix)
    more = _data(2 * B, 8)
    jl, tl = _jfit(jm2, more, 1).losses, _tfit(tm2, more, 1).losses
    # JAX took the port's slots (a mismatch would re-initialise them and
    # move its losses far from the port's)
    np.testing.assert_allclose(tl, jl, rtol=FIT_TOL, atol=FIT_TOL)


def test_predict_and_evaluate_match_jax():
    jm, jgpt = _jmodel()
    tm, _ = _tmodel(_jax_state(jgpt))
    ids, labels = _data(2 * B, 9)
    jp = jm.predict(JTensorDataset([ids]), batch_size=B, stack_outputs=True)
    tp = tm.predict(TTensorDataset([ids]), batch_size=B, stack_outputs=True)
    assert len(tp) == len(jp) == 1 and tp[0].shape == (2 * B, T, VOCAB)
    np.testing.assert_allclose(tp[0], np.asarray(jp[0]), rtol=1e-5,
                               atol=1e-5)
    je = jm.evaluate(JTensorDataset([ids, labels]), batch_size=B, verbose=0)
    te = tm.evaluate(TTensorDataset([ids, labels]), batch_size=B, verbose=0)
    assert set(te) == set(je) == {"loss", "acc"}
    np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-5)
    assert te["acc"] == je["acc"]


def test_accumulate_grad_batches_tracks_jax():
    jm, jgpt = _jmodel()
    tm, tgpt = _tmodel(_jax_state(jgpt))
    data = _data(4 * B, 10)
    kw = dict(batch_size=B, epochs=1, verbose=0, shuffle=False,
              accumulate_grad_batches=2)
    jr, tr = _Rec(jcbks.Callback).cb, _Rec(tcbks.Callback).cb
    jm.fit(JTensorDataset(list(data)), callbacks=[jr], **kw)
    tm.fit(TTensorDataset(list(data)), callbacks=[tr], **kw)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=FIT_TOL,
                               atol=FIT_TOL)
    jsd = _jax_state(jgpt)
    for k, v in tgpt.state_dict().items():
        np.testing.assert_allclose(v.numpy(), jsd[k], rtol=FIT_TOL,
                                   atol=FIT_TOL, err_msg=k)
    # two optimizer updates over four batches
    st = tm._optimizer.state(tgpt.wte.weight)
    assert float(st["beta1_pow"]) == pytest.approx(0.9 ** 2, rel=1e-6)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bf16_model_save_load_bit_equal(tmp_path, direction):
    """A bf16 GPT with Momentum (bf16 velocities): the .pdparams / .pdopt
    pair crosses bit for bit."""
    prefix = str(tmp_path / "bf16")
    data = _data(B, 11)
    if direction == "jax_to_port":
        jm, jgpt = _jmodel("bfloat16", "momentum")
        jm.save(prefix)                 # the bf16 weights, as loaded
        jsd = _jax_state(jm.network)
        tm, _ = _tmodel({k: v.astype(np.float32) for k, v in
                         _jax_state(jgpt).items()}, "bfloat16", "momentum")
        _jfit(jm, data, 1)              # a step: bf16 velocities
        fs = _read_pdopt(_save_opt(jm, prefix))["functional_state"]
        assert any(np.any(np.asarray(v["velocity"]) != 0)
                   for v in fs.values())
        tm.load(prefix)
        for k, v in tm.network.state_dict().items():
            assert v.dtype == torch.bfloat16
            np.testing.assert_array_equal(tarrays.to_numpy(v), jsd[k])
        got = stacked_layout(tm._optimizer.functional_state(
            tm.network.named_parameters()), tm.network)
        for n, slots in fs.items():
            v = np.asarray(slots["velocity"])
            assert got[n]["velocity"].dtype == v.dtype
            np.testing.assert_array_equal(got[n]["velocity"], v)
    else:
        jm, jgpt = _jmodel("bfloat16", "momentum")
        tm, tgpt = _tmodel({k: v.astype(np.float32) for k, v in
                            _jax_state(jgpt).items()}, "bfloat16", "momentum")
        _tfit(tm, data, 1)
        tm.save(prefix)
        jm.load(prefix)
        jsd = _jax_state(jm.network)
        for k, v in tm.network.state_dict().items():
            assert jsd[k].dtype.name == "bfloat16", k
            np.testing.assert_array_equal(jsd[k], tarrays.to_numpy(v))
        fs = stacked_layout(tm._optimizer.functional_state(
            tm.network.named_parameters()), tm.network)
        for n, slots in fs.items():
            got = np.asarray(jm._restored_opt_state[n]["velocity"])
            assert got.dtype.name == "bfloat16"
            np.testing.assert_array_equal(got, slots["velocity"])


def _save_opt(jm, prefix):
    """Only the .pdopt of a JAX Model.save, in place of `prefix`'s (its
    .pdparams would hold the fp32 parameters the JAX Momentum step
    returns)."""
    jm.save(prefix + "_opt")
    os.replace(prefix + "_opt.pdopt", prefix + ".pdopt")
    return prefix + ".pdopt"


def test_bf16_without_ml_dtypes_round_trips(tmp_path, monkeypatch):
    """Where ml_dtypes is missing, bf16 goes to the structured uint16
    encoding and back, bit for bit."""
    monkeypatch.setattr(tarrays, "bf16_numpy", lambda: None)
    t = torch.randn(5, 7).bfloat16()
    ptt.save({"w": t, "nested": [t[0]]}, str(tmp_path / "x.pdparams"))
    back = ptt.load(str(tmp_path / "x.pdparams"), device="cpu")
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), t.view(torch.int16))
    assert torch.equal(back["nested"][0], t[0])
    raw = ptt.load(str(tmp_path / "x.pdparams"), return_numpy=True)
    assert raw["w"].dtype == tarrays.BF16_BITS
