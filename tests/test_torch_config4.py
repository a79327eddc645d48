"""benchmarks/run.py config 4 (GPT-2 345M, ZeRO stage 2) and the
strategies that run on one device, ported, against the JAX package on
the CPU at gpt_tiny width, from the same numpy weights:

  * config 4's step: `GPT(gpt_tiny())`, AMP O2 pure bf16, Adam,
    `sharding = True` at stage 2, three `compile_train_step` steps against
    the JAX compiled step on a one-device mesh (the tests' 8 virtual CPU
    devices would otherwise give it dp = 8); ZeRO stages 1-3 and
    `pipeline` at pp_degree 1 bit-equal to the port's plain step;
  * gradient merge (`k_steps` 2 and 4, `avg` on and off): the loss (the
    mean of the microbatch losses) and the parameters after two steps
    against the JAX step, and a batch that `k_steps` does not divide;
  * the lamb / lars swaps: the class, learning rate, clip and decay
    defaults, and the parameters after three steps against the JAX step;
  * run.py's own `config4_gpt2_345m_zero2(True)` and
    `config5_gpt3_1p3b_pp(True)` bodies, with `_compiled_lm`, on the port.

Dropout is 0 in every shipped GPT config (and in gpt_tiny), so the JAX
step's per-microbatch keys (`fold_in(key, i)`) draw nothing here.
"""
import contextlib
import dataclasses
import importlib.util
import inspect
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

import paddle_tpu as paddle                                   # noqa: E402
import paddle_tpu.nn as jnn                                   # noqa: E402
import paddle_tpu.optimizer as jopt                           # noqa: E402
from paddle_tpu.distributed.fleet.compiler import \
    compile_train_step as jcompile                            # noqa: E402
from paddle_tpu.distributed.fleet.strategy import \
    DistributedStrategy as JStrategy                          # noqa: E402
from paddle_tpu.models import GPT as JGPT                     # noqa: E402
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny       # noqa: E402

import paddle_tpu_torch.nn as tnn                             # noqa: E402
import paddle_tpu_torch.optimizer as topt                     # noqa: E402
from paddle_tpu_torch.core import device as tdevice           # noqa: E402
from paddle_tpu_torch.distributed import mesh as tmesh        # noqa: E402
from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,  # noqa: E402
                                                compile_train_step)
from paddle_tpu_torch.models import GPT                       # noqa: E402
from paddle_tpu_torch.models.gpt import gpt_tiny              # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

B, T = 4, 64
# O2 Adam steps at an lr whose updates stand well above bf16 rounding,
# with tests/test_torch_bert.py's O2 tolerances: an O2 loss is a bf16
# number (~6.2, where one bf16 step is 2^-5); each leaf's update p - p0
# within 1/10 of JAX's by norm plus one entry turned the other way (2 lr)
LR = 1e-3
O2_STEPS = 3
O2_LOSS_TOL = 2.0 ** -5
O2_UPDATE_REL = 0.1
O2_UPDATE_ABS = 2 * LR
# the key part of qkv.bias has a gradient of 0 in exact arithmetic (a
# constant added to every key of a row leaves its softmax as it is), so
# its update is all rounding: Adam moves an entry at most 1.0, 1.0014 and
# 1.0036 lr in its first three steps, and the packages put it at most
# twice their sum apart (tests/test_torch_bert.py's K_BIAS_ABS)
K_BIAS_ABS = 2 * 3.005 * LR
# fp32 through two frameworks differs by summation order only (~1e-6
# relative a gradient). Under SGD, which the gradient-merge tests use
# because its update scales with the gradient (Adam's would hide a missing
# or extra 1/k), two steps leave the losses within 1e-5 and each parameter
# within 1e-4 of its largest value
LOSS_TOL = 1e-5
PARAM_REL = 1e-4
MERGE_LR = 0.5
# Lamb's first update is about lr * trust * sign(g) in each entry and
# Lars's a local lr times g, so an entry whose gradient is small beside the
# two frameworks' summation noise moves by a different amount in each:
# after three steps each leaf's update p - p0 is held by norm, within
# 1/1000 of JAX's (measured at most 1.3e-4, on attn.qkv.bias under Lamb),
# plus the fp32 rounding of p itself: three steps round each entry three
# times in each package, half an ulp (2^-24 relative) a time, so the two
# are at most 3 ulps apart
SWAP_UPDATE_REL = 1e-3
SWAP_ULPS = 3 * 2.0 ** -23
FIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])
    prior = tmesh.get_mesh()
    yield
    tmesh.set_mesh(prior)


def _arrays(seed=0):
    paddle.seed(seed)
    src = JGPT(jgpt_tiny())
    return {k: np.asarray(v._data) for k, v in src.state_dict().items()}


def _ids(seed=0, b=B):
    return np.random.default_rng(seed).integers(0, 512, (b, T)) \
        .astype(np.int64)


def _jax_param(params, name):
    """A port parameter name's value in the JAX step's params (scan-stacked
    blocks.<rel> with a leading layer axis)."""
    if name in params:
        return np.asarray(params[name])
    _, i, rel = name.split(".", 2)
    return np.asarray(params[f"blocks.{rel}"])[int(i)]


def _jax_prog(arrays, strategy, make_opt, scan_layers=None):
    model = JGPT(jgpt_tiny(scan_layers=scan_layers))
    model.set_state_dict(arrays)
    model.eval()
    opt = make_opt(jopt, jnn, list(model.parameters()))
    return jcompile(model, opt, strategy, loss_method="loss",
                    mesh=strategy.build_mesh(jax.devices()[:1]))


def _port_prog(arrays, strategy, make_opt):
    model = GPT(gpt_tiny()).load_numpy(arrays)
    model.eval()
    opt = make_opt(topt, tnn, list(model.parameters()))
    return compile_train_step(model, opt, strategy, loss_method="loss"), \
        model, opt


def _adam(lib, nn, params):
    return lib.Adam(learning_rate=LR, parameters=params)


def _config4(pkg_strategy):
    s = pkg_strategy()
    s.amp = True
    s.amp_configs.use_pure_bf16 = True
    s.sharding = True
    s.sharding_configs.stage = 2
    return s


# ------------------------------------------------------------ config 4

def test_config4_step_tracks_jax():
    """Three O2 steps of config 4's strategy (sharding stage 2, pure
    bf16, Adam) in both packages from one set of weights: the bf16 losses,
    which fall, and every parameter's update; the parameters and Adam's
    moments stay fp32 (the masters of the bf16 compute)."""
    arrays, ids = _arrays(), _ids()
    js = _config4(JStrategy)
    jprog = _jax_prog(arrays, js, _adam)
    assert dict(jprog.mesh.shape)["dp"] == 1 and js.sharding_stage() == 2
    jids = jprog._put_data(ids)
    jl = [float(jprog.step(jids, jids)) for _ in range(O2_STEPS)]

    s = _config4(DistributedStrategy)
    prog, model, adam = _port_prog(arrays, s, _adam)
    assert prog.mesh.shape["dp"] == 1 and s.sharding_stage() == 2
    p0 = {n: p.detach().clone().numpy() for n, p in model.named_parameters()}
    tids = prog._put_data(ids)
    raw = [prog.step(tids, tids) for _ in range(O2_STEPS)]
    assert {r.dtype for r in raw} == {torch.bfloat16}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {adam.state(p)["moment1"].dtype for p in model.parameters()} \
        == {torch.float32}
    tl = [float(r) for r in raw]
    assert all(b < a for a, b in zip(tl, tl[1:])), tl
    np.testing.assert_allclose(tl, jl, atol=O2_LOSS_TOL, rtol=0)
    H = model.cfg.hidden
    for name, p in model.named_parameters():
        dj = _jax_param(jprog.params, name).astype(np.float32) - p0[name]
        dt = p.detach().numpy() - p0[name]
        parts = [(dt, dj)]
        if name.endswith("attn.qkv.bias"):
            err = float(np.abs(dt[H:2 * H] - dj[H:2 * H]).max())
            assert err <= K_BIAS_ABS, (name, err)
            parts = [(dt[:H], dj[:H]), (dt[2 * H:], dj[2 * H:])]
        for t, j in parts:
            err = float(np.linalg.norm(t - j))
            size = float(np.linalg.norm(j))
            assert err <= O2_UPDATE_REL * size + O2_UPDATE_ABS, \
                (name, err, size)


def _port_steps(arrays, s, steps=3):
    prog, model, _ = _port_prog(arrays, s, _adam)
    ids = prog._put_data(_ids())
    losses = [prog.step(ids, ids) for _ in range(steps)]
    return losses, {n: p.detach().clone() for n, p in
                    model.named_parameters()}


@pytest.mark.parametrize("how", ["stage1", "stage2", "stage3",
                                 "pipeline_pp1"])
def test_one_device_strategies_are_the_plain_step(how):
    """On one device ZeRO (stages 1-3) shards over a dp axis of size 1 and
    pipeline at pp_degree 1 takes the plain branch (its accumulate_steps
    unread, as in the JAX step): three O2 steps equal the plain step's
    bit for bit."""
    arrays = _arrays()
    plain = DistributedStrategy()
    plain.amp = True
    plain.amp_configs.use_pure_bf16 = True
    s = _config4(DistributedStrategy)
    if how == "pipeline_pp1":
        s.sharding = False
        s.pipeline = True
        s.pipeline_configs.accumulate_steps = 4
    else:
        s.sharding_configs.stage = int(how[-1])
    want_l, want_p = _port_steps(arrays, plain)
    got_l, got_p = _port_steps(arrays, s)
    for a, b in zip(got_l, want_l):
        assert torch.equal(a, b)
    for n in want_p:
        assert torch.equal(got_p[n], want_p[n]), n


# ------------------------------------------------------- gradient merge

def _merge(pkg_strategy, k, avg):
    s = pkg_strategy()
    s.gradient_merge = True
    s.gradient_merge_configs.k_steps = k
    s.gradient_merge_configs.avg = avg
    return s


def _sgd(lib, nn, params):
    return lib.SGD(learning_rate=MERGE_LR, parameters=params)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("avg", [True, False])
def test_gradient_merge_tracks_jax(k, avg):
    """Two fp32 SGD steps of a batch of 8 in k microbatches: each step's
    loss is the mean of the microbatch losses, and the parameters after
    the two updates follow the JAX step's (the summed, or with avg the
    mean, gradients)."""
    arrays, ids = _arrays(), _ids(b=8)
    jprog = _jax_prog(arrays, _merge(JStrategy, k, avg), _sgd)
    jids = jprog._put_data(ids)
    jl = [float(jprog.step(jids, jids)) for _ in range(2)]
    prog, model, _ = _port_prog(arrays, _merge(DistributedStrategy, k, avg),
                                _sgd)
    tids = prog._put_data(ids)
    tl = [float(prog.step(tids, tids)) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL, rtol=0)
    for name, p in model.named_parameters():
        ref = _jax_param(jprog.params, name)
        err = float(np.abs(p.detach().numpy() - ref).max())
        assert err <= PARAM_REL * float(np.abs(ref).max()), (name, err)


def test_gradient_merge_loss_is_the_microbatch_mean():
    """The merged step's loss is the mean of the losses of its k
    microbatches, rows [i B/k, (i+1) B/k), on the weights before the
    update; a batch that k does not divide raises in both packages, and
    so does hapi's accumulate_grad_batches on top of the merge."""
    arrays, ids = _arrays(), _ids(b=8)
    ref = GPT(gpt_tiny()).load_numpy(arrays)
    with torch.no_grad():
        want = np.mean([float(ref.loss(torch.as_tensor(m),
                                       torch.as_tensor(m)))
                        for m in np.split(ids, 4)])
    prog, _, _ = _port_prog(arrays, _merge(DistributedStrategy, 4, True),
                            _adam)
    assert abs(float(prog.step(ids, ids)) - want) <= LOSS_TOL
    with pytest.raises(ValueError, match="k_steps=4 does not divide"):
        prog.step(ids[:6], ids[:6])
    prog.accumulate_steps = 2           # hapi's accumulate_grad_batches
    with pytest.raises(ValueError, match="accumulate_grad_batches"):
        prog.step(ids, ids)
    jprog = _jax_prog(arrays, _merge(JStrategy, 4, True), _adam)
    with pytest.raises((TypeError, ValueError)):
        jprog.step(jprog._put_data(ids[:6]), jprog._put_data(ids[:6]))


# ------------------------------------------------------ lamb / lars swap

def _clipped_adamw(lib, nn, params):
    return lib.AdamW(learning_rate=LR, weight_decay=0.1, parameters=params,
                     grad_clip=nn.ClipGradByGlobalNorm(1.0))


@pytest.mark.parametrize("toggle", ["lamb", "lars", "lamb_and_lars"])
def test_optimizer_swap_tracks_jax(toggle):
    """`lamb` / `lars` replace the optimizer (lamb first when both are
    set) by the JAX package's rule: the learning rate, parameters and
    clip carried over, the new class's own default decay, the original's
    weight_decay dropped; three fp32 steps against the JAX step built
    with `scan_layers=False` (see
    test_jax_scanned_stack_takes_layerwise_norms_over_all_layers)."""
    def strategy(pkg):
        s = pkg()
        s.lamb = "lamb" in toggle
        s.lars = "lars" in toggle
        return s
    arrays, ids = _arrays(), _ids()
    jprog = _jax_prog(arrays, strategy(JStrategy), _clipped_adamw,
                      scan_layers=False)
    prog, model, orig = _port_prog(arrays, strategy(DistributedStrategy),
                                   _clipped_adamw)
    want = "Lamb" if "lamb" in toggle else "Lars"
    assert type(jprog._opt).__name__ == type(prog._opt).__name__ == want
    assert prog._opt is not orig and prog._opt.get_lr() == LR
    assert prog._opt._grad_clip is orig._grad_clip
    assert prog._opt._parameter_list == orig._parameter_list
    if want == "Lamb":
        assert prog._opt._wd == jprog._opt._wd == 0.01
    else:
        assert prog._opt._lars_wd == jprog._opt._lars_wd == 0.0005
        assert prog._opt._momentum == jprog._opt._momentum
    p0 = {n: p.detach().clone().numpy() for n, p in model.named_parameters()}
    jids, tids = jprog._put_data(ids), prog._put_data(ids)
    jl = [float(jprog.step(jids, jids)) for _ in range(3)]
    tl = [float(prog.step(tids, tids)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL, rtol=0)
    for name, p in model.named_parameters():
        dj = _jax_param(jprog.params, name) - p0[name]
        dt = p.detach().numpy() - p0[name]
        err = float(np.linalg.norm(dt - dj))
        assert err <= SWAP_UPDATE_REL * float(np.linalg.norm(dj)) + \
            SWAP_ULPS * float(np.linalg.norm(p0[name])), (name, err)


def test_jax_scanned_stack_takes_layerwise_norms_over_all_layers():
    """A fault of the JAX package that the port does not share: a scanned
    GPT (gpt_tiny's default) holds each block weight of every layer in one
    stacked [layers, ...] parameter, so Lars's local lr (and Lamb's trust
    ratio) is taken over all the layers at once; paddle's layer-wise rule
    takes it per layer's tensor, as the JAX package does unscanned and as
    the port does. One Lars step of the scanned JAX GPT moves a block
    weight by more than a tenth away from the unscanned one's."""
    def lars(pkg):
        s = pkg()
        s.lars = True
        return s
    arrays, ids = _arrays(), _ids()
    moved = {}
    for scan in (None, False):
        jprog = _jax_prog(arrays, lars(JStrategy), _adam, scan_layers=scan)
        d = jprog._put_data(ids)
        jprog.step(d, d)
        moved[scan] = _jax_param(jprog.params, "blocks.1.fc2.weight") - \
            arrays["blocks.1.fc2.weight"]
    err = np.linalg.norm(moved[None] - moved[False])
    assert err > 0.1 * np.linalg.norm(moved[False])
    prog, model, _ = _port_prog(arrays, lars(DistributedStrategy), _adam)
    d = prog._put_data(ids)
    prog.step(d, d)
    p0 = arrays["blocks.1.fc2.weight"]
    mine = dict(model.named_parameters())["blocks.1.fc2.weight"] \
        .detach().numpy() - p0
    assert np.linalg.norm(mine - moved[False]) <= \
        SWAP_UPDATE_REL * np.linalg.norm(moved[False]) + \
        SWAP_ULPS * np.linalg.norm(p0)


# ------------------------------------- eval_step and checkpoints

def _slot(opt_state, name, slot):
    """A port parameter name's Adam slot in the JAX step's opt_state."""
    return _jax_param({k: v[slot] for k, v in opt_state.items()}, name)


def test_checkpoints_and_eval_step_cross_with_jax(tmp_path):
    """The compiled step's `save_checkpoint` / `restore_checkpoint`
    between the packages: the JAX step's checkpoint after two Adam steps
    restores into a port step (parameters and Adam moments bit for bit),
    and the port's, two steps later, into a fresh JAX step; `eval_step`
    gives the JAX step's loss on the same weights, and `write_back` has
    nothing to do."""
    arrays, ids = _arrays(), _ids()
    jprog = _jax_prog(arrays, JStrategy(), _adam)
    d = jprog._put_data(ids)
    for _ in range(2):
        jprog.step(d, d)
    jprog.save_checkpoint(str(tmp_path / "jax"), step=2, meta={"epoch": 1})
    prog, model, adam = _port_prog(_arrays(seed=7), DistributedStrategy(),
                                   _adam)
    assert prog.restore_checkpoint(str(tmp_path / "jax")) == \
        (2, {"epoch": 1})
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      _jax_param(jprog.params, name), name)
        for slot in ("moment1", "moment2"):
            np.testing.assert_array_equal(
                adam.state(p)[slot].numpy(),
                _slot(jprog.opt_state, name, slot), (name, slot))
    prog.write_back()
    jl, tl = float(jprog.eval_step(d, d)), float(prog.eval_step(ids, ids))
    assert abs(tl - jl) <= LOSS_TOL
    t = prog._put_data(ids)
    for _ in range(2):
        prog.step(t, t)
    prog.eval_step(t, t)
    assert model.training               # eval_step restores train mode
    prog.save_checkpoint(str(tmp_path / "port"), step=4)
    jprog2 = _jax_prog(_arrays(seed=7), JStrategy(), _adam)
    assert jprog2.restore_checkpoint(str(tmp_path / "port"))[0] == 4
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(_jax_param(jprog2.params, name),
                                      p.detach().numpy(), name)
        np.testing.assert_array_equal(
            _slot(jprog2.opt_state, name, "moment2"),
            adam.state(p)["moment2"].numpy(), name)


# ------------------------------------------------------ run.py's bodies

@contextlib.contextmanager
def _port_default_device(device):
    """`jax.default_device(d)` for the port: `d` is the default device
    inside the block."""
    prior = tdevice._DEFAULT[0]
    tdevice._DEFAULT[0] = device
    try:
        yield
    finally:
        tdevice._DEFAULT[0] = prior


def _port_devices(kind=None):
    """`jax.devices()` / `jax.devices("cpu")` for the port."""
    return [torch.device("cpu") if kind == "cpu"
            else tdevice.default_device()]


# the substitutions in run.py's functions, in order: the JAX package's
# imports, `import jax`, and the three jax calls the bodies make
_SUBS = ((r"\bpaddle_tpu\b", "paddle_tpu_torch"),
         (r"^\s*import jax\n", ""),
         (r"\bjax\.devices\(", "port_devices("),
         (r"\bjax\.default_device\(", "port_default_device("))


def _run_py_bodies(names, counts):
    """run.py's functions `names` with the substitutions of `_SUBS` (their
    counts checked against `counts`, one tuple per function) and nothing
    else changed, defined together in run.py's own module namespace (its
    _timed_steps, _emit and _mfu), so that config 4's and 5's bodies call
    the substituted `_compiled_lm`."""
    spec = importlib.util.spec_from_file_location(
        "_run_py", os.path.join(ROOT, "benchmarks", "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    ns = dict(vars(run))
    ns.update(port_devices=_port_devices,
              port_default_device=_port_default_device)
    for name, want in zip(names, counts):
        body = inspect.getsource(getattr(run, name))
        got = []
        for pat, rep in _SUBS:
            body, n = re.subn(pat, rep, body, flags=re.M)
            got.append(n)
        assert tuple(got) == want, (name, got)
        assert not re.search(r"\bjax\b", body), name
        exec(compile(body, f"run.py:{name}", "exec"), ns)
    return ns


def _record(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_run_py_config4_body_runs_against_the_port(capsys):
    """run.py config 4 in smoke mode: `GPT(gpt_tiny())`, fp32, sharding
    stage 2, Adam, B=8, T=64 through `_compiled_lm` and run.py's
    _timed_steps; its record has dp 1."""
    ns = _run_py_bodies(["_compiled_lm", "config4_gpt2_345m_zero2"],
                        [(4, 1, 1, 0), (3, 0, 0, 0)])
    ns["config4_gpt2_345m_zero2"](True)
    rec = _record(capsys)
    assert rec["config"] == "4_gpt_tiny_zero2_smoke"
    assert rec["unit"] == "tokens/s" and rec["value"] > 0
    assert rec["dp"] == 1 and rec["mfu"] is None


def test_run_py_config5_body_takes_its_one_device_branch(capsys):
    """run.py config 5 in smoke mode on one device (n = 1): the pipeline
    strategy at pp_degree 1 with recompute and accumulate_steps 4 through
    `_compiled_lm`, B=4, T=64; its record has pp 1 and dp 1."""
    ns = _run_py_bodies(["_compiled_lm", "config5_gpt3_1p3b_pp"],
                        [(4, 1, 1, 0), (7, 1, 2, 1)])
    ns["config5_gpt3_1p3b_pp"](True)
    rec = _record(capsys)
    assert rec["config"] == "5_gpt_tiny_pp_smoke"
    assert rec["unit"] == "tokens/s" and rec["value"] > 0
    assert rec["pp"] == 1 and rec["dp"] == 1


def test_config4_model_is_gpt2_345m():
    """Config 4's model at full width without building it: 24 layers of
    1024 with 16 heads of 64 and the padded vocabulary of 50304 (below
    the fused head's 65536, so the head is unfused), the JAX package's
    config; 354,871,296 parameters and 2,431,217,664 train FLOPs a token
    at T = 1024 (6 N + 12 layers hidden T)."""
    from paddle_tpu.models.gpt import gpt2_345m as jgpt2_345m
    from paddle_tpu_torch.models.gpt import gpt2_345m, param_shapes
    from paddle_tpu_torch.nn.functional.loss import FUSED_MIN_VOCAB
    cfg = gpt2_345m()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jgpt2_345m())
    assert (cfg.hidden, cfg.layers, cfg.heads, cfg.vocab_size) == \
        (1024, 24, 16, 50304)
    assert cfg.hidden // cfg.heads == 64
    assert cfg.vocab_size < FUSED_MIN_VOCAB
    n = sum(int(np.prod(s)) for s in param_shapes(cfg).values())
    assert n == 354_871_296
    assert 6 * n + 12 * cfg.layers * cfg.hidden * 1024 == 2_431_217_664
