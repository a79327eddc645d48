"""paddle_tpu_torch's BERT / ERNIE (benchmarks/run.py config 3) against
the JAX package on the CPU at `bert_tiny` width, from the same numpy
weights: the MLM logits and `mlm_loss` (with ignore_index rows and
segment ids) and every gradient on both attention routes (the
composition, and the flash path with `pallas_attention_min_seq` lowered
to 128 in both packages: the JAX Pallas kernels in interpret mode, the
port's plain versions); the O2 dtypes along the path; a padding mask; `load_numpy` on both JAX layouts
and its refusals; one AMP O2 `compile_train_step(loss_method="mlm_loss")`
step against the JAX compiled step; run.py's `config3_bert` body itself,
in smoke mode, against `paddle_tpu_torch`; the one-device mesh; and the
GPU as the default device of the new entry points."""
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
import jax.numpy as jnp                                       # noqa: E402

import paddle_tpu as paddle                                   # noqa: E402
import paddle_tpu.amp as jamp                                 # noqa: E402
import paddle_tpu.optimizer as jopt                           # noqa: E402
from paddle_tpu.distributed.fleet.compiler import \
    compile_train_step as jcompile                            # noqa: E402
from paddle_tpu.distributed.fleet.strategy import \
    DistributedStrategy as JStrategy                          # noqa: E402
from paddle_tpu.framework import (MethodAdapter, functional_call,  # noqa: E402
                                  param_arrays)
from paddle_tpu.models import Bert as JBert                   # noqa: E402
from paddle_tpu.models import bert_tiny as jbert_tiny         # noqa: E402
from paddle_tpu.models import ernie_base as jernie_base       # noqa: E402

import paddle_tpu_torch as ptt                                # noqa: E402
import paddle_tpu_torch.amp as tamp                           # noqa: E402
import paddle_tpu_torch.nn as tnn                             # noqa: E402
import paddle_tpu_torch.optimizer as topt                     # noqa: E402
from paddle_tpu_torch.core import device as tdevice           # noqa: E402
from paddle_tpu_torch.distributed import build_mesh           # noqa: E402
from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,  # noqa: E402
                                                compile_train_step)
from paddle_tpu_torch.models import (Bert, Ernie, bert,  # noqa: E402
                                     bert_tiny, ernie_base)
from paddle_tpu_torch.models.bert import param_shapes         # noqa: E402
from paddle_tpu_torch.ops import basic                    # noqa: E402
from paddle_tpu_torch.ops.kernels import flash_attention as tfa  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fp32 through two frameworks: summation order only
LOSS_TOL = 1e-5
GRAD_REL = 1e-4          # each gradient, as a fraction of its largest
# O2 Adam steps at an lr whose updates stand well above bf16 rounding
LR = 1e-3
O2_STEPS = 4
# an O2 loss is a bf16 number (~6, where one bf16 step is 2^-5); the
# packages round in the same places and sum in different orders. The
# loss falls by 3 steps of 2^-5 a step here, so a step not taken shows
O2_LOSS_TOL = 2.0 ** -5
# each leaf's update p - p0 against JAX's, by norm: 1/10 of it, plus one
# entry turned the other way in one step (2 lr). Adam's first step is the
# gradient's sign, and an entry whose gradient is near 0 is rounded to
# either sign by the two packages' bf16 sums (layer 1's v_proj.bias[38]:
# an fp32 gradient of 1.3e-5 against the leaf's 3.4e-3)
O2_UPDATE_REL = 0.1
O2_UPDATE_ABS = 2 * LR
# k_proj.bias's gradient is 0 in exact arithmetic, so its update is all
# rounding: Adam moves an entry at most 1.0, 1.0014, 1.0036 and 1.0068 lr
# in its first four steps (Cauchy-Schwarz over the moments' weights), and
# the packages put it at most twice their sum apart
K_BIAS_ABS = 2 * 4.012 * LR


@pytest.fixture(autouse=True)
def _cpu_and_flags(monkeypatch):
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])
    old_j = paddle.get_flags("pallas_attention_min_seq")
    old_t = ptt.get_flags("pallas_attention_min_seq")
    yield
    paddle.set_flags({"pallas_attention_min_seq": old_j})
    ptt.set_flags({"pallas_attention_min_seq": old_t})


def _min_seq(n):
    paddle.set_flags({"pallas_attention_min_seq": n})
    ptt.set_flags({"pallas_attention_min_seq": n})


def _pair(seed=0):
    """(JAX Bert scanned, its raw stacked arrays, port Bert from them)."""
    paddle.seed(seed)
    jm = JBert(jbert_tiny())
    arrays = {k: np.asarray(v) for k, v in param_arrays(jm).items()}
    return jm, arrays, Bert(bert_tiny()).load_numpy(arrays)


def _batch(B, T, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (B, T)).astype(np.int64)
    labels = np.where(rng.random((B, T)) < 0.3, ids, -100)   # MLM rows
    labels[0, 0] = 7
    seg = rng.integers(0, 2, (B, T)).astype(np.int64)
    return ids, labels, seg


def _jax_param(tree, name):
    """A port parameter name's value in the JAX scan layout."""
    if name in tree:
        return np.asarray(tree[name])
    _, _, i, rel = name.split(".", 3)
    return np.asarray(tree[f"encoder.layers.{rel}"])[int(i)]


@pytest.mark.parametrize("flash", [False, True])
def test_bert_logits_loss_and_gradients_match_jax(flash):
    B, T = 2, 128
    if flash:
        _min_seq(T)
    jm, _, tm = _pair()
    ids, labels, seg = _batch(B, T)
    before = (tfa.fwd_launches, tfa.dq_launches, tfa.bwd_launches)
    jlog = np.asarray(jm(paddle.to_tensor(ids),
                         token_type_ids=paddle.to_tensor(seg))._data)
    tlog = tm(ids, token_type_ids=seg)
    np.testing.assert_allclose(tlog.detach().numpy(), jlog, atol=LOSS_TOL,
                               rtol=LOSS_TOL)

    adapter = MethodAdapter(jm, "mlm_loss")

    def loss_of(p):
        out, _ = functional_call(adapter, p, {}, jnp.asarray(ids),
                                 jnp.asarray(labels),
                                 token_type_ids=jnp.asarray(seg))
        return out

    jloss, jgrads = jax.value_and_grad(loss_of)(param_arrays(jm))
    tloss = tm.mlm_loss(ids, labels, token_type_ids=seg)
    tloss.backward()
    # the CPU ran the plain versions: no kernel launch was counted
    assert (tfa.fwd_launches, tfa.dq_launches, tfa.bwd_launches) == before
    assert tloss.item() == pytest.approx(float(jloss), abs=LOSS_TOL)
    top = max(float(np.abs(np.asarray(v)).max()) for v in jgrads.values())
    names = [n for n, _ in tm.named_parameters()]
    assert len(names) == 9 + 16 * 2
    for name, p in tm.named_parameters():
        want = _jax_param(jgrads, name)
        # k_proj.bias's gradient is 0 in exact arithmetic (softmax ignores
        # a shift common to a row's scores): held to the largest of all
        scale = top if name.endswith("k_proj.bias") \
            else max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= GRAD_REL * scale, (name, err, scale)


def test_flash_route_runs_the_flash_functions(monkeypatch):
    """At T >= pallas_attention_min_seq with no mask every layer's
    attention calls flash_attention non-causally; a padding mask sends
    each to the composition."""
    _min_seq(128)
    _, _, tm = _pair()
    seen = []
    real = tfa.flash_attention
    monkeypatch.setattr(
        "paddle_tpu_torch.nn.functional.attention.flash_attention",
        lambda q, k, v, **kw: seen.append(kw["causal"]) or real(q, k, v,
                                                                **kw))
    ids, _, _ = _batch(1, 128)
    tm(ids)
    assert seen == [False, False]
    tm(ids, attn_mask=np.ones((1, 1, 1, 128), bool))
    assert seen == [False, False]


@pytest.mark.parametrize("flash", [False, True])
def test_o2_dtypes_along_the_bert_path_follow_jax(flash, monkeypatch):
    """Under O2 both packages give the same dtypes: bf16 into attention
    (either route), fp32 out of the black-listed mlm_ln, fp32 logits of
    the head's linear, and a bf16 MLM loss."""
    T = 128
    if flash:
        _min_seq(T)
    scanned, _, tm = _pair()
    jm = JBert(jbert_tiny(scan_layers=False))   # the JAX scan refuses O2
    jm.set_state_dict(scanned.state_dict())
    ids, labels, _ = _batch(2, T)
    seen = []
    real = tfa.flash_attention
    monkeypatch.setattr(
        "paddle_tpu_torch.nn.functional.attention.flash_attention",
        lambda q, k, v, **kw: seen.append(q.dtype) or real(q, k, v, **kw))
    with tamp.auto_cast(level="O2"):
        th = tm.forward_hidden(ids)
        tlog = tm(ids)
        tloss = tm.mlm_loss(ids, labels)
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        jh = jm.forward_hidden(paddle.to_tensor(ids))
        jlog = jm(paddle.to_tensor(ids))
        jloss = jm.mlm_loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
    got = [str(t.dtype).replace("torch.", "") for t in (th, tlog, tloss)]
    assert got == [str(np.asarray(t._data).dtype) for t in (jh, jlog, jloss)]
    assert got == ["float32", "bfloat16", "bfloat16"]
    assert seen == ([torch.bfloat16] * 6 if flash else [])


def test_padding_mask_matches_jax():
    """A bool key-padding mask [B, 1, 1, T] (True keeps) through the
    composition of both packages: the rows of the unpadded tokens."""
    B, T = 2, 32
    jm, _, tm = _pair(seed=1)
    ids, _, _ = _batch(B, T, seed=3)
    mask = np.ones((B, 1, 1, T), bool)
    mask[1, ..., 20:] = False
    jlog = np.asarray(jm(paddle.to_tensor(ids),
                         attn_mask=paddle.to_tensor(mask))._data)
    tlog = tm(ids, attn_mask=mask).detach().numpy()
    np.testing.assert_allclose(tlog, jlog, atol=LOSS_TOL, rtol=LOSS_TOL)
    unmasked = tm(ids).detach().numpy()
    assert np.abs(unmasked[1] - tlog[1]).max() > 1e-3   # the mask acts


def test_load_numpy_reads_both_jax_layouts():
    """The JAX Bert's raw parameters (scan-stacked, encoder.layers.<rel>
    with a leading [layers] axis) and its state_dict (indexed) give the
    same port weights, under the JAX package's names and shapes."""
    jm, stacked, tm = _pair()
    assert "encoder.layers.self_attn.q_proj.weight" in stacked
    indexed = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    other = Bert(bert_tiny()).load_numpy(indexed)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} \
        == {k: v.shape for k, v in indexed.items()} \
        == param_shapes(bert_tiny())
    for (n1, a), (n2, b) in zip(tm.state_dict().items(),
                                other.state_dict().items()):
        assert n1 == n2 and torch.equal(a, b)
    assert tm.num_params() == jm.num_params()
    assert tm.flops_per_token(64) == jm.flops_per_token(64)


def _broken(arrays, how):
    out = dict(arrays)
    if how == "missing":
        del out["mlm_fc.bias"]
    elif how == "stray":
        out["encoder.norm.weight"] = np.ones(64, np.float32)
    elif how == "misshaped":
        out["tok.weight"] = out["tok.weight"][:-1]
    elif how == "stacked_axis":
        out["encoder.layers.linear1.bias"] = \
            out["encoder.layers.linear1.bias"][:1]
    else:
        out["ln.weight"] = out["ln.weight"].astype(np.int32)
    return out


@pytest.mark.parametrize("how,err", [("missing", KeyError),
                                     ("stray", KeyError),
                                     ("misshaped", ValueError),
                                     ("stacked_axis", ValueError),
                                     ("int", ValueError)])
def test_load_numpy_refuses_a_wrong_key_or_shape(how, err):
    _, arrays, _ = _pair()
    with pytest.raises(err, match="params_from_numpy"):
        Bert(bert_tiny()).load_numpy(_broken(arrays, how))


def test_ernie_base_is_config3s_model():
    """`ernie_base()` is the JAX package's config (V=18048), Ernie is
    Bert, and its parameter count and flops per token at T=512 follow
    from its shapes (no weights are built)."""
    cfg = ernie_base()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jernie_base())
    assert Ernie is Bert and cfg.vocab_size == 18048
    n = sum(int(np.prod(s)) for s in param_shapes(cfg).values())
    assert n == 99_903_744
    assert 6 * n + 12 * cfg.layers * cfg.hidden * 512 == 656_045_568
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        Bert(bert_tiny()).param_shardings({})


# --------------------------------------------------------- the compiled step

def _jax_o2_program(scan_layers, arrays=None):
    """run.py config 3's call sequence in the JAX package, O2, on a
    one-device mesh (the tests' 8 virtual CPU devices would otherwise
    shard the batch)."""
    paddle.seed(0)
    model = JBert(jbert_tiny(scan_layers=scan_layers))
    if arrays is not None:
        model.set_state_dict(arrays)
    model.eval()
    s = JStrategy()
    s.amp = True
    s.amp_configs.use_pure_bf16 = True
    adam = jopt.Adam(learning_rate=LR, parameters=list(model.parameters()))
    return jcompile(model, adam, s, loss_method="mlm_loss",
                    mesh=s.build_mesh(jax.devices()[:1]))


def test_o2_compiled_step_tracks_jax():
    """O2_STEPS O2 steps of compile_train_step(model, Adam, strategy,
    loss_method="mlm_loss") in both packages from one set of weights: the
    bf16 losses, which fall, and every parameter's update."""
    paddle.seed(0)
    src = JBert(jbert_tiny())
    arrays = {k: np.asarray(v._data) for k, v in src.state_dict().items()}
    ids = np.random.default_rng(0).integers(0, 512, (4, 64)) \
        .astype(np.int64)
    # the JAX layers unrolled: see test_jax_scanned_bert_cannot_take_an_o2_step
    jprog = _jax_o2_program(False, arrays)
    jids = jprog._put_data(ids)
    jl = [float(jprog.step(jids, jids)) for _ in range(O2_STEPS)]
    jparams = {k: np.asarray(v.astype(jnp.float32))
               for k, v in jprog.params.items()}

    model = Bert(bert_tiny()).load_numpy(arrays)
    model.eval()
    p0 = {n: p.detach().clone().numpy() for n, p in model.named_parameters()}
    s = DistributedStrategy()
    s.amp = True
    s.amp_configs.use_pure_bf16 = True
    adam = topt.Adam(learning_rate=LR, parameters=list(model.parameters()))
    prog = compile_train_step(model, adam, s, loss_method="mlm_loss")
    tids = prog._put_data(ids)
    raw = [prog.step(tids, tids) for _ in range(O2_STEPS)]
    assert {r.dtype for r in raw} == {torch.bfloat16}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    tl = [float(r) for r in raw]
    assert all(b < a for a, b in zip(tl, tl[1:])), tl
    assert min(a - b for a, b in zip(jl, jl[1:])) > O2_LOSS_TOL, jl
    np.testing.assert_allclose(tl, jl, atol=O2_LOSS_TOL, rtol=0)
    for name, p in model.named_parameters():
        dj = _jax_param(jparams, name) - p0[name]
        dt = p.detach().numpy() - p0[name]
        if name.endswith("k_proj.bias"):
            err = float(np.abs(dt - dj).max())
            assert err <= K_BIAS_ABS, (name, err)
            continue
        err = float(np.linalg.norm(dt - dj))
        size = float(np.linalg.norm(dj))
        assert err <= O2_UPDATE_REL * size + O2_UPDATE_ABS, (name, err, size)


def test_jax_scanned_bert_cannot_take_an_o2_step():
    """A fault of the JAX package that the port does not share: under O2
    its scanned encoder (BertConfig's default scan_layers=True, the one
    run.py config 3 builds) takes an fp32 carry in (the embedding
    LayerNorm's output) and gives a bf16 one back (the residual add), and
    lax.scan refuses it at trace time. The port's loop takes the step."""
    prog = _jax_o2_program(scan_layers=True)
    ids = prog._put_data(np.zeros((2, 16), np.int64))
    with pytest.raises(TypeError, match="carry"):
        prog.step(ids, ids)
    model = Bert(bert_tiny(scan_layers=True))
    s = DistributedStrategy()
    s.amp = True
    s.amp_configs.use_pure_bf16 = True
    prog = compile_train_step(model, topt.Adam(
        parameters=model.parameters()), s, loss_method="mlm_loss")
    assert torch.isfinite(prog.step(np.zeros((2, 16), np.int64),
                                    np.zeros((2, 16), np.int64)))


def _config3_body():
    """benchmarks/run.py's config3_bert with the JAX package's imports
    pointed at paddle_tpu_torch and nothing else changed, defined in
    run.py's own module namespace (its _timed_steps, _emit and _mfu)."""
    spec = importlib.util.spec_from_file_location(
        "_run_py", os.path.join(ROOT, "benchmarks", "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    src = inspect.getsource(run.config3_bert)
    body = re.sub(r"^\s*import jax\n", "", src, flags=re.M)
    body = re.sub(r"\bpaddle_tpu\b", "paddle_tpu_torch", body)
    assert body.count("paddle_tpu_torch") == 5
    ns = dict(vars(run))
    exec(compile(body, "run.py:config3_bert", "exec"), ns)
    return ns["config3_bert"]


def test_run_py_config3_body_runs_against_the_port(capsys):
    """run.py config 3 in smoke mode (bert_tiny, B=8, T=64, fp32) through
    the port: 25 steps of run.py's _timed_steps and its one JSON record,
    with prog.mesh.shape.get("dp", 1) == 1."""
    _config3_body()(True)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["config"] == "3_bert_tiny_smoke" and rec["unit"] == "tokens/s"
    assert rec["dp"] == 1 and rec["mfu"] is None and rec["value"] > 0


def test_one_device_mesh_and_nothing_larger():
    """build_mesh and the strategy's build a one-device mesh that
    compile_train_step takes (and builds when given none); a mesh of more
    devices, or anything else passed as a mesh, raises."""
    net = Bert(bert_tiny())
    adam = topt.Adam(parameters=net.parameters())
    s = DistributedStrategy()
    prog = compile_train_step(net, adam, s, loss_method="mlm_loss")
    assert dict(prog.mesh.shape) == {"pp": 1, "dp": 1, "ep": 1, "sp": 1,
                                     "tp": 1}
    assert prog.mesh.shape.get("dp", 1) == 1 and prog.mesh.size == 1
    from paddle_tpu_torch.distributed import get_mesh
    assert get_mesh() is prog.mesh            # set as JAX's build sets it
    mesh = build_mesh()
    assert mesh.axis_names == ("dp",) and mesh.devices.shape == (1,)
    assert mesh.device == torch.device("cpu")
    assert compile_train_step(net, adam, s, "mlm_loss", mesh=mesh).mesh \
        is mesh
    assert dict(build_mesh({"dp": -1, "tp": 1}).shape) == {"dp": 1, "tp": 1}
    cpu = torch.device("cpu")
    for call in (lambda: build_mesh({"dp": 2}),
                 lambda: build_mesh(devices=[cpu, cpu]),
                 lambda: s.build_mesh(devices=[cpu, cpu]),
                 lambda: compile_train_step(net, adam, s, "mlm_loss",
                                            mesh=object())):
        with pytest.raises(NotImplementedError, match="queue 1 item 7"):
            call()


def test_bert_layers_and_mesh_default_to_cuda(monkeypatch):
    """Bert, the transformer layers, params_from_numpy, build_mesh and
    ops.basic.zeros use the GPU unless told otherwise, and raise without
    one."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = bert_tiny()
    arrays = bert.init_params_numpy(cfg, seed=0)
    monkeypatch.setattr(tdevice, "_DEFAULT", [None])
    for call in (lambda: Bert(cfg),
                 lambda: tnn.TransformerEncoderLayer(16, 2, 32),
                 lambda: tnn.Transformer(16, 2, 1, 1, 32),
                 lambda: bert.params_from_numpy(cfg, arrays),
                 lambda: build_mesh(),
                 lambda: DistributedStrategy().build_mesh(),
                 lambda: basic.zeros((2, 3))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    params = bert.params_from_numpy(cfg, arrays, device="cpu")
    assert {t.device.type for t in params.values()} == {"cpu"}
    assert basic.zeros((2, 3), "int64", device="cpu").device.type == "cpu"
