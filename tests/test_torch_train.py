"""paddle_tpu_torch's training slice against the JAX package, on the CPU
at gpt_tiny size: linear_cross_entropy against `_lce_xla`; GPT loss and
every gradient from one numpy state_dict (T=256 with
pallas_attention_min_seq=128 in both, so the JAX side runs its Pallas
flash kernels in interpret mode and the port its flash path); three
`Model.fit` Adam steps in fp32; one AMP O2 step; the O2 cast lists; and
the strategy toggles the port does not run."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

import paddle_tpu as paddle                                   # noqa: E402
import paddle_tpu.amp as jamp                                 # noqa: E402
import paddle_tpu.nn as jnn                                   # noqa: E402
import paddle_tpu.optimizer as jopt                           # noqa: E402
from paddle_tpu.framework import (MethodAdapter, functional_call,  # noqa: E402
                                  param_arrays)
from paddle_tpu.hapi import Model as JModel                   # noqa: E402
from paddle_tpu.hapi import callbacks as jcbks                # noqa: E402
from paddle_tpu.io import TensorDataset as JTensorDataset     # noqa: E402
from paddle_tpu.models import GPT as JGPT                     # noqa: E402
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny       # noqa: E402
from paddle_tpu.ops.pallas import fused_ce as jce             # noqa: E402
from paddle_tpu.static import InputSpec as JInputSpec         # noqa: E402

import paddle_tpu_torch as ptt                                # noqa: E402
import paddle_tpu_torch.amp as tamp                           # noqa: E402
import paddle_tpu_torch.nn as tnn                             # noqa: E402
import paddle_tpu_torch.optimizer as topt                     # noqa: E402
from paddle_tpu_torch.core import device as tdevice           # noqa: E402
from paddle_tpu_torch.distributed.fleet import DistributedStrategy  # noqa: E402
from paddle_tpu_torch.hapi import Model as TModel             # noqa: E402
from paddle_tpu_torch.hapi import callbacks as tcbks          # noqa: E402
from paddle_tpu_torch.io import TensorDataset as TTensorDataset  # noqa: E402
from paddle_tpu_torch.models import GPT as TGPT               # noqa: E402
from paddle_tpu_torch.models.gpt import gpt_tiny as tgpt_tiny  # noqa: E402
from paddle_tpu_torch.nn import functional as TF              # noqa: E402
from paddle_tpu_torch.ops.kernels import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.static import InputSpec as TInputSpec   # noqa: E402

# fp32 end to end: the same weights through two frameworks differ by
# summation order only, ~1e-6 relative per op over a 2-layer model
LOSS_TOL = 1e-5
GRAD_TOL = 2e-4
# three Adam steps amplify those differences through 1/sqrt(v): a
# gradient entry near 0 can flip its first update's sign-scaled size
FIT_TOL = 1e-4
# an O2 loss is a bf16 number (the JAX package's loss dtype under O2):
# at ~6.2 one bf16 step is 2^-5 = 0.03125; the two frameworks round in
# the same places but accumulate in different orders, so allow two steps
O2_LOSS_TOL = 2 * 2.0 ** -5


@pytest.fixture(autouse=True)
def _cpu_and_flags(monkeypatch):
    """The port's default device is the CPU here; the sdpa threshold of
    both packages is restored after each test."""
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])
    old_j = paddle.get_flags("pallas_attention_min_seq")
    old_t = ptt.get_flags("pallas_attention_min_seq")
    yield
    paddle.set_flags({"pallas_attention_min_seq": old_j})
    ptt.set_flags({"pallas_attention_min_seq": old_t})


def _min_seq(n):
    paddle.set_flags({"pallas_attention_min_seq": n})
    ptt.set_flags({"pallas_attention_min_seq": n})


def _pair(seq=128, seed=0):
    """(JAX GPT, port GPT) with the JAX GPT's seed weights."""
    paddle.seed(seed)
    jgpt = JGPT(dataclasses.replace(jgpt_tiny(), max_seq_len=seq))
    arrays = {k: np.asarray(v._data) for k, v in jgpt.state_dict().items()}
    tgpt = TGPT(dataclasses.replace(tgpt_tiny(), max_seq_len=seq)) \
        .load_numpy(arrays)
    return jgpt, tgpt


def _batch(cfg_vocab, B, T, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg_vocab, (B, T), dtype=np.int32)
    labels = np.concatenate([ids[:, 1:], ids[:, :1]], axis=1)
    labels[0, :3] = -100                        # exercise ignore_index
    return ids, labels


def _jax_loss_and_grads(jgpt, ids, labels, level=None):
    jgpt.train()
    adapter = MethodAdapter(jgpt, "loss")
    params = param_arrays(jgpt)

    def loss_of(p):
        if level is None:
            out, _ = functional_call(adapter, p, {}, jnp.asarray(ids),
                                     jnp.asarray(labels))
            return out
        with jamp.auto_cast(level=level, dtype="bfloat16"):
            out, _ = functional_call(adapter, p, {}, jnp.asarray(ids),
                                     jnp.asarray(labels))
        return out

    loss, grads = jax.value_and_grad(loss_of)(params)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _jax_grad(grads, name):
    """A port parameter name's gradient out of the JAX grads, which use
    the scan-stacked layout (blocks.<rel> with a leading layer axis)."""
    if name in grads:
        return grads[name]
    _, i, rel = name.split(".", 2)
    return grads[f"blocks.{rel}"][int(i)]


# ------------------------------------------------------------- (iii) CE

@pytest.mark.parametrize("N,H,V", [(64, 32, 100), (40, 16, 512)])
def test_linear_cross_entropy_matches_lce_xla(N, H, V):
    rng = np.random.default_rng(N)
    x = rng.standard_normal((N, H)).astype(np.float32)
    w = rng.standard_normal((V, H)).astype(np.float32) * 0.1
    lab = rng.integers(0, V, N).astype(np.int32)
    g = rng.standard_normal(N).astype(np.float32)

    def jf(a, b):
        return (jce._lce_xla(a, b, jnp.asarray(lab)) * jnp.asarray(g)).sum()
    jrows = np.asarray(jce._lce_xla(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(lab)))
    jdx, jdw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    rows = TF.linear_cross_entropy(tx, tw, torch.tensor(lab),
                                   reduction="none")
    (rows * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(rows.detach().numpy(), jrows, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=1e-5,
                               rtol=1e-5)
    mean = TF.linear_cross_entropy(tx, tw, torch.tensor(lab))
    assert mean.item() == pytest.approx(float(jrows.mean()), abs=1e-5)


def test_linear_cross_entropy_fused_off_cpu_raises():
    """fused=True runs the fused-CE kernels on a CUDA tensor and their
    plain versions on a CPU tensor (tests/test_torch_fused_ce.py holds
    them to the JAX package's Pallas kernels); a device with neither
    (meta) raises."""
    x, w = torch.zeros(4, 8), torch.zeros(16, 8)
    lab = torch.zeros(4, dtype=torch.long)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        TF.linear_cross_entropy(x.to("meta"), w.to("meta"), lab.to("meta"),
                                fused=True)
    assert torch.isfinite(TF.linear_cross_entropy(x, w, lab, fused=True))


# -------------------------------------------------------- (iv) GPT grads

def test_gpt_loss_and_every_gradient_match_jax_with_flash():
    _min_seq(128)
    jgpt, tgpt = _pair(seq=256)
    ids, labels = _batch(512, 2, 256)
    jloss, jgrads = _jax_loss_and_grads(jgpt, ids, labels)
    before = (tfa.fwd_launches, tfa.dq_launches, tfa.bwd_launches)
    tloss = tgpt.loss(ids, labels)
    tloss.backward()
    # the CPU ran the plain versions: no kernel launch was counted
    assert (tfa.fwd_launches, tfa.dq_launches, tfa.bwd_launches) == before
    assert tloss.item() == pytest.approx(jloss, abs=LOSS_TOL)
    names = [n for n, _ in tgpt.named_parameters()]
    assert len(names) == 4 + 12 * 2
    for name, p in tgpt.named_parameters():
        want = _jax_grad(jgrads, name)
        scale = max(float(np.abs(want).max()), 1e-6)
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


def test_load_numpy_takes_both_jax_layouts():
    """The JAX GPT's stacked param arrays (scan layout) and its expanded
    state_dict load into the same port weights."""
    jgpt, tgpt = _pair()
    stacked = {k: np.asarray(v) for k, v in param_arrays(jgpt).items()}
    assert "blocks.attn.qkv.weight" in stacked
    other = TGPT(tgpt_tiny()).load_numpy(stacked)
    for (n1, a), (n2, b) in zip(tgpt.state_dict().items(),
                                other.state_dict().items()):
        assert n1 == n2 and torch.equal(a, b)
    assert set(tgpt.state_dict()) == set(jgpt.state_dict())
    assert tgpt.num_params() == jgpt.num_params()
    assert tgpt.flops_per_token(128) == jgpt.flops_per_token(128)


# ------------------------------------------------------ (v) Model.fit

class _JLoss(jnn.Layer):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, ids, labels):
        return self.m.loss(ids, labels)


class _TLoss(tnn.Layer):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, ids, labels):
        return self.m.loss(ids, labels)


class _JLosses(jcbks.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


class _TLosses(tcbks.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


def _fit_both(steps, B, T, amp_level, lr):
    """`steps` Model.fit Adam steps in each package from one set of
    weights. The JAX side takes its single-device jit step (its strategy
    step would shard the batch over the 8 virtual CPU devices that
    tests/conftest.py sets up); the port takes its strategy step."""
    jgpt, tgpt = _pair(seq=T)
    ids, labels = _batch(512, B, T, seed=2)
    ids_all = np.concatenate([np.roll(ids, i, axis=1) for i in range(steps)])
    lab_all = np.concatenate([np.roll(labels, i, axis=1)
                              for i in range(steps)])
    jnet = _JLoss(jgpt)
    jmodel = JModel(jnet, inputs=[JInputSpec([None, T], "int32"),
                                  JInputSpec([None, T], "int32")])
    jmodel.prepare(jopt.Adam(learning_rate=lr,
                             parameters=jmodel.parameters()),
                   amp_configs=amp_level)
    jl = _JLosses()
    jmodel.fit(JTensorDataset([ids_all, lab_all]), batch_size=B, epochs=1,
               verbose=0, shuffle=False, callbacks=[jl])

    tnet = _TLoss(tgpt)
    tmodel = TModel(tnet, inputs=[TInputSpec([None, T], "int32"),
                                  TInputSpec([None, T], "int32")])
    s = DistributedStrategy()
    if amp_level == "O2":
        s.amp = True
        s.amp_configs.use_pure_bf16 = True
    adam = topt.Adam(learning_rate=lr, parameters=tmodel.parameters())
    tmodel.prepare(adam, strategy=s)
    tl = _TLosses()
    tmodel.fit(TTensorDataset([ids_all, lab_all]), batch_size=B, epochs=1,
               verbose=0, shuffle=False, callbacks=[tl])
    return ([float(x) for x in jl.losses], [float(x) for x in tl.losses],
            tgpt, adam, tl.losses)


def test_three_fit_adam_steps_track_jax_fp32():
    jl, tl, tgpt, adam, raw = _fit_both(3, 4, 64, None, 1e-3)
    assert len(jl) == len(tl) == 3
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, atol=FIT_TOL, rtol=FIT_TOL)
    st = adam.state(tgpt.wte.weight)
    assert st["moment1"].dtype == torch.float32
    assert float(st["beta1_pow"]) == pytest.approx(0.9 ** 3, rel=1e-6)
    # the loss reached the callback still a tensor, read by float()
    assert all(isinstance(x._t, torch.Tensor) for x in raw)


# ------------------------------------------------------------ (vi) O2

def test_one_o2_step_matches_jax_within_bf16():
    jl, tl, tgpt, adam, raw = _fit_both(2, 4, 64, "O2", 1e-3)
    assert raw[0]._t.dtype == torch.bfloat16      # the O2 loss is bf16
    assert {p.dtype for p in tgpt.parameters()} == {torch.float32}
    assert adam.state(tgpt.wte.weight)["moment2"].dtype == torch.float32
    np.testing.assert_allclose(tl, jl, atol=O2_LOSS_TOL)


def test_o2_gpt_loss_and_gradients_match_jax_within_bf16():
    """One O2 forward/backward with the flash path on both sides: the
    loss within two bf16 steps, each gradient within 5% of its scale."""
    _min_seq(128)
    jgpt, tgpt = _pair(seq=128)
    ids, labels = _batch(512, 2, 128, seed=3)
    jloss, jgrads = _jax_loss_and_grads(jgpt, ids, labels, level="O2")
    with tamp.auto_cast(level="O2", dtype="bfloat16"):
        tloss = tgpt.loss(ids, labels)
    tloss.backward()
    assert tloss.dtype == torch.bfloat16
    assert tloss.item() == pytest.approx(jloss, abs=O2_LOSS_TOL)
    for name, p in tgpt.named_parameters():
        assert p.grad.dtype == torch.float32, name
        want = _jax_grad(jgrads, name)
        scale = max(float(np.abs(want).max()), 1e-6)
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= 0.05 * scale, (name, err, scale)


_OPS = sorted(tamp.WHITE_LIST | tamp.BLACK_LIST
              | {"add", "reshape", "where", "sum_all", "embedding", "gelu",
                 "dropout", "linear_cross_entropy", "split", "cast"})


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_o2_casts_follow_the_jax_lists(level):
    """maybe_cast_inputs of both packages gives the same dtypes for every
    listed op and the gray ops of the GPT path, for fp32, bf16 and mixed
    inputs (plus an integer input that never casts)."""
    assert tamp.WHITE_LIST == jamp.WHITE_LIST
    assert tamp.BLACK_LIST == jamp.BLACK_LIST
    combos = [("float32",), ("bfloat16",), ("float32", "bfloat16"),
              ("int32", "float32")]
    for op in _OPS:
        for combo in combos:
            jin = [jnp.zeros(2, jnp.dtype(d)) for d in combo]
            tin = [torch.zeros(2, dtype=getattr(torch, d)) for d in combo]
            with jamp.auto_cast(level=level, dtype="bfloat16"):
                jout = jamp.maybe_cast_inputs(op, jin)
            with tamp.auto_cast(level=level, dtype="bfloat16"):
                tout = tamp.maybe_cast_inputs(op, tin)
            assert [str(a.dtype) for a in jout] == \
                [str(t.dtype).replace("torch.", "") for t in tout], \
                (op, combo)
    assert tamp.maybe_cast_inputs("linear", [torch.zeros(1)])[0].dtype \
        == torch.float32                        # no auto_cast: unchanged


def test_o2_dtypes_along_the_gpt_path(monkeypatch):
    """Under O2 the activations entering attention are bf16, LayerNorm
    runs in fp32, and the logits of the CE head are fp32."""
    _min_seq(64)
    _, tgpt = _pair(seq=64)
    ids, labels = _batch(512, 1, 64, seed=4)
    seen = {}
    real_fa = tfa.flash_attention
    monkeypatch.setattr(
        "paddle_tpu_torch.nn.functional.attention.flash_attention",
        lambda q, k, v, **kw: seen.setdefault("attn", q.dtype)
        and real_fa(q, k, v, **kw))
    with tamp.auto_cast(level="O2"):
        h = tgpt.forward_hidden(ids)
        loss = tgpt.loss(ids, labels)
    assert seen["attn"] == torch.bfloat16
    assert h.dtype == torch.float32             # ln_f is black-listed
    assert loss.dtype == torch.bfloat16


# ------------------------------------------------------ (vii) strategy

# the JAX strategy's toggles: what each does at prepare on one device
_RUNS = ("sharding", "pipeline", "gradient_merge", "lars", "lamb")
_MULTI = ("tensor_parallel", "sequence_parallel", "expert_parallel",
          "localsgd", "adaptive_localsgd", "dgc", "fp16_allreduce",
          "dp_degree", "mp_degree", "pp_degree", "sharding_degree")


@pytest.mark.parametrize("toggle", list(_RUNS) + list(_MULTI) + [
    "recompute", "recompute_policy", "custom_white_list",
    "custom_black_list"])
def test_unported_strategy_toggles_raise_at_prepare(toggle):
    """Each toggle of the JAX strategy at `Model.prepare`. On one device
    sharding (stage 2 by default), pipeline (pp_degree 1), gradient_merge
    and the lars / lamb swaps build the step; what needs more devices
    raises naming ROADMAP queue 1 item 7; recompute runs per block with
    the dots_saveable / nothing_saveable policies, and named checkpoints,
    other policies and custom AMP op lists raise."""
    s = DistributedStrategy()
    if toggle == "recompute":
        s.recompute = True
        s.recompute_configs.checkpoints = ["blocks.0"]
    elif toggle == "recompute_policy":
        s.recompute = True
        s.recompute_configs.policy = "everything_saveable"
    elif toggle.endswith("_degree"):
        setattr(s.hybrid_configs, toggle, 2)
    elif toggle.startswith("custom_"):
        setattr(s.amp_configs, toggle, ["gelu"])
    else:
        setattr(s, toggle, True)
    if toggle == "gradient_merge":
        s.gradient_merge_configs.k_steps = 2
    _, tgpt = _pair()
    model = TModel(_TLoss(tgpt))
    adam = topt.Adam(parameters=model.parameters())
    if toggle not in _RUNS:
        with pytest.raises(NotImplementedError,
                           match="queue 1 item 7" if toggle in _MULTI
                           else "not ported"):
            model.prepare(adam, strategy=s)
        return
    model.prepare(adam, strategy=s)
    prog = model._prog
    assert dict(prog.mesh.shape) == {"pp": 1, "dp": 1, "ep": 1, "sp": 1,
                                     "tp": 1}
    assert s.sharding_stage() == (2 if toggle == "sharding" else 0)
    assert prog._k_merge == (2 if toggle == "gradient_merge" else 1)
    want = {"lars": topt.Lars, "lamb": topt.Lamb}.get(toggle, topt.Adam)
    assert type(prog._opt) is want
    assert (prog._opt is adam) == (toggle not in ("lars", "lamb"))


def test_unported_model_surface_raises(tmp_path):
    """What of hapi and the checkpoint surface is still unported: the
    inference export, a mesh or shardings at restore, and AMP options the
    op-by-op bf16 AMP cannot express. (The rest of what this test once
    asserted raised -- metrics, amp levels, eval_data, evaluate, LR
    schedulers, weight decay -- is ported and held to the JAX package in
    tests/test_torch_lifecycle.py; `summary` and encrypted files in
    tests/test_torch_hapi_tools.py: `summary` without an input size
    raises the JAX package's ValueError, and an encrypted file loads back
    only with its key.)"""
    from paddle_tpu_torch.io import checkpoint as tckpt
    _, tgpt = _pair()
    model = TModel(_TLoss(tgpt))
    adam = topt.Adam(parameters=model.parameters())
    with pytest.raises(NotImplementedError):
        model.prepare(adam, amp_configs={"level": "O2",
                                         "custom_white_list": ["gelu"]})
    with pytest.raises(NotImplementedError):
        model.prepare(adam, amp_configs="O3")
    model.prepare(adam)
    with pytest.raises(NotImplementedError):
        model.save(str(tmp_path / "m"), training=False)
    with pytest.raises(ValueError, match="input_size"):
        model.summary()
    ptt.save({"w": tgpt.wte.weight}, str(tmp_path / "w.pdparams"),
             cipher_key=b"k" * 32)
    with pytest.raises(ValueError, match="wrong key"):
        ptt.load(str(tmp_path / "w.pdparams"), cipher_key=b"j" * 32)
    assert torch.equal(ptt.load(str(tmp_path / "w.pdparams"),
                                cipher_key=b"k" * 32, device="cpu")["w"],
                       tgpt.wte.weight.detach())
    ptt.save({"w": tgpt.wte.weight}, str(tmp_path / "w.pdparams"))
    with pytest.raises(ValueError, match="not a paddle_tpu encrypted"):
        ptt.load(str(tmp_path / "w.pdparams"), cipher_key=b"k" * 32)
    tckpt.save_checkpoint(str(tmp_path / "step_1"), {"w": tgpt.wte.weight})
    with pytest.raises(NotImplementedError):
        tckpt.load_checkpoint(str(tmp_path / "step_1"), mesh=object())
    with pytest.raises(NotImplementedError):
        tckpt.load_checkpoint(str(tmp_path / "step_1"),
                              shardings={"params": {"w": None}})
