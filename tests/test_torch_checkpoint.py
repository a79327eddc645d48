"""paddle_tpu_torch's checkpoint files against the JAX package, on the
CPU: format-2 directories (`io.checkpoint`) written by one package and
loaded and validated by the other, fp32 and bf16, bit for bit and byte
for byte; `framework.save` / `load` across the packages; the format-2
integrity cases (a torn or truncated shard, a missing meta or index,
`latest_checkpoint` falling back past a corrupt newest, retention), done
by hand on the port's files; and the hapi callbacks that write and
prune checkpoints (ModelCheckpoint, EarlyStopping)."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

import paddle_tpu as paddle                                   # noqa: E402
from paddle_tpu.hapi import callbacks as jcbks                # noqa: E402
from paddle_tpu.io import checkpoint as jckpt                 # noqa: E402

import paddle_tpu_torch as ptt                                # noqa: E402
import paddle_tpu_torch.nn as tnn                             # noqa: E402
import paddle_tpu_torch.optimizer as topt                     # noqa: E402
from paddle_tpu_torch.core import arrays as tarrays           # noqa: E402
from paddle_tpu_torch.core import device as tdevice           # noqa: E402
from paddle_tpu_torch.framework import param_arrays           # noqa: E402
from paddle_tpu_torch.hapi import Model as TModel             # noqa: E402
from paddle_tpu_torch.hapi import callbacks as tcbks          # noqa: E402
from paddle_tpu_torch.io import TensorDataset as TTensorDataset  # noqa: E402
from paddle_tpu_torch.io import checkpoint as tckpt           # noqa: E402
from paddle_tpu_torch.models import GPT as TGPT               # noqa: E402
from paddle_tpu_torch.models.gpt import gpt_tiny as tgpt_tiny  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])


def _tree(dtype, seed=0):
    """A train state's shape: params (a stacked block weight, a vector)
    and optimizer slots with 0-d beta powers."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((2, 8, 6)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    params = {"m.blocks.attn.qkv.weight": w, "m.ln_f.bias": b}
    opt = {n: {"moment1": v * 0.1, "moment2": v * v,
               "beta1_pow": np.asarray(0.729, np.float32)}
           for n, v in params.items()}
    if dtype == "bfloat16":
        params = {k: v.astype(tarrays.bf16_numpy()) for k, v in
                  params.items()}
    return params, opt


def _jax_tree(tree):
    return {k: (_jax_tree(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items()}


def _port_tree(tree):
    return {k: (_port_tree(v) if isinstance(v, dict)
                else tarrays.to_tensor(v, "cpu"))
            for k, v in tree.items()}


def _assert_tree_equal(got, want, path=""):
    assert set(got) == set(want), path
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_tree_equal(got[k], w, f"{path}/{k}")
            continue
        g = got[k]
        g = tarrays.to_numpy(g) if isinstance(g, torch.Tensor) \
            else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, k)
        assert g.tobytes() == w.tobytes(), (path, k)


def _index(path):
    with open(os.path.join(path, "index.0.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_format2_crosses_bit_for_bit(tmp_path, dtype, writer):
    params, opt = _tree(dtype)
    jdir, tdir = str(tmp_path / "jax" / "step_3"), \
        str(tmp_path / "port" / "step_3")
    jckpt.save_checkpoint(jdir, _jax_tree(params), _jax_tree(opt), step=3,
                          meta={"epoch": 1})
    tckpt.save_checkpoint(tdir, _port_tree(params), _port_tree(opt), step=3,
                          meta={"epoch": 1})
    # the same files, byte for byte: equal sizes and checksums
    assert _index(tdir) == _index(jdir)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    src = jdir if writer == "jax" else tdir
    tckpt.validate_checkpoint(src, deep=True)
    jckpt.validate_checkpoint(src, deep=True)
    tp, to, _, tstep, tmeta = tckpt.load_checkpoint(src, device="cpu")
    assert all(isinstance(v, torch.Tensor) for v in tp.values())
    _assert_tree_equal(tp, params)
    _assert_tree_equal(to, opt)
    assert tstep == 3 and tmeta == {"epoch": 1}
    if dtype == "bfloat16":
        # the JAX package cannot read a bf16 array back from a checkpoint,
        # its own included (ROADMAP.md queue 3): it fails on the port's
        # file exactly as on its own
        for d in (jdir, tdir):
            with pytest.raises(ValueError, match="cast"):
                jckpt.load_checkpoint(d)
        return
    jp, jo, _, jstep, jmeta = jckpt.load_checkpoint(src)
    _assert_tree_equal(jp, params)
    _assert_tree_equal(jo, opt)
    assert jstep == 3 and jmeta == {"epoch": 1}


def test_a_trained_port_state_restores_bit_for_bit(tmp_path):
    """A port GPT's params and AdamW slots after two steps, through
    save_checkpoint / load_checkpoint and into a fresh optimizer."""
    paddle.seed(0)
    cfg = dataclasses.replace(tgpt_tiny(), max_seq_len=16)
    gpt = TGPT(cfg)
    o = topt.AdamW(1e-3, parameters=gpt.parameters(),
                   grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    for _ in range(2):
        o.clear_grad()
        gpt.loss(ids, np.roll(ids, -1, axis=1)).backward()
        o.step()
    named = gpt.named_parameters()
    tckpt.save_checkpoint(str(tmp_path / "step_2"), param_arrays(gpt),
                          o.functional_state(named), step=2)
    jckpt.validate_checkpoint(str(tmp_path / "step_2"))
    p, st, _, step, _ = tckpt.load_checkpoint(str(tmp_path / "step_2"),
                                              device="cpu")
    gpt2 = TGPT(cfg)
    gpt2.set_state_dict(p)
    o2 = topt.AdamW(1e-3, parameters=gpt2.parameters())
    o2.set_functional_state(gpt2.named_parameters(), st)
    for (n, a), (_, b) in zip(named, gpt2.named_parameters()):
        assert torch.equal(a, b), n
        for slot, v in o.state(a).items():
            w = o2.state(b)[slot]
            assert (torch.equal(v, w) if isinstance(v, torch.Tensor)
                    else (v == w and type(v) is type(w))), (n, slot)
    assert step == 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_framework_save_load_crosses(tmp_path, writer):
    rng = np.random.default_rng(2)
    arrays = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "h": rng.standard_normal((5,)).astype(np.float32).astype(
                  tarrays.bf16_numpy()),
              "i": np.arange(6, dtype=np.int64).reshape(2, 3)}
    obj = {"state": arrays, "epoch": 3, "names": ["a", "b"]}
    path = str(tmp_path / "x.pdparams")
    if writer == "jax":
        from paddle_tpu.core.tensor import Tensor as JTensor
        paddle.save({"state": {k: JTensor(jnp.asarray(v))
                               for k, v in arrays.items()},
                     "epoch": 3, "names": ["a", "b"]}, path)
    else:
        ptt.save({"state": {k: tarrays.to_tensor(v, "cpu")
                            for k, v in arrays.items()},
                  "epoch": 3, "names": ["a", "b"]}, path)
    got = ptt.load(path, device="cpu")
    assert got["epoch"] == 3 and got["names"] == ["a", "b"]
    _assert_tree_equal(got["state"], arrays)
    assert got["state"]["h"].dtype == torch.bfloat16
    back = paddle.load(path)
    _assert_tree_equal({k: np.asarray(v._data)
                        for k, v in back["state"].items()}, arrays)
    assert ptt.load(path, return_numpy=True)["epoch"] == obj["epoch"]


# ------------------------------------------------ format-2 integrity

def _params(v):
    return {"w": torch.full((4, 4), float(v)),
            "nested": {"b": torch.full((3,), float(v))}}


def _corrupt(d, step, how):
    path = os.path.join(d, f"step_{step}")
    shard = sorted(f for f in os.listdir(path) if f.endswith(".npy"))[0]
    fp = os.path.join(path, shard)
    if how == "torn":             # bytes flipped, size unchanged
        with open(fp, "r+b") as f:
            f.seek(os.path.getsize(fp) - 8)
            f.write(b"\xde\xad\xbe\xef\xde\xad\xbe\xef")
    elif how == "truncated":
        with open(fp, "r+b") as f:
            f.truncate(os.path.getsize(fp) - 4)
    elif how == "no_meta":
        os.unlink(os.path.join(path, "meta.json"))
    elif how == "no_index":
        os.unlink(os.path.join(path, "index.0.json"))


@pytest.mark.parametrize("case", ["torn_shard", "truncated_shard",
                                  "missing_meta", "missing_index",
                                  "format1_without_checksums",
                                  "latest_falls_back", "retention"])
def test_format2_integrity(tmp_path, case):
    d = str(tmp_path)
    save = tckpt.save_checkpoint
    save(os.path.join(d, "step_2"), _params(2), step=2)
    if case == "torn_shard":
        _corrupt(d, 2, "torn")
        with pytest.raises(tckpt.CheckpointError, match="crc"):
            tckpt.validate_checkpoint(os.path.join(d, "step_2"))
        tckpt.validate_checkpoint(os.path.join(d, "step_2"), deep=False)
        with pytest.raises(tckpt.CheckpointError):
            tckpt.load_checkpoint(os.path.join(d, "step_2"))
        assert not jckpt.is_valid_checkpoint(os.path.join(d, "step_2"))
    elif case == "truncated_shard":
        _corrupt(d, 2, "truncated")
        with pytest.raises(tckpt.CheckpointError, match="size"):
            tckpt.validate_checkpoint(os.path.join(d, "step_2"), deep=False)
        assert tckpt.latest_checkpoint(d) is None
    elif case in ("missing_meta", "missing_index"):
        _corrupt(d, 2, "no_meta" if case == "missing_meta" else "no_index")
        with pytest.raises(tckpt.CheckpointError,
                           match="meta" if case == "missing_meta"
                           else "index"):
            tckpt.validate_checkpoint(os.path.join(d, "step_2"))
        assert not tckpt.is_valid_checkpoint(os.path.join(d, "step_2"))
        assert tckpt.latest_checkpoint(d) is None
    elif case == "format1_without_checksums":
        idx = os.path.join(d, "step_2", "index.0.json")
        with open(idx) as f:
            index = json.load(f)
        for entry in index.values():
            for sh in entry["shards"]:
                sh.pop("size"), sh.pop("crc32")
        with open(idx, "w") as f:
            json.dump(index, f)
        assert tckpt.latest_checkpoint(d).endswith("step_2")
        p, _, _, step, _ = tckpt.load_checkpoint(os.path.join(d, "step_2"))
        assert step == 2 and float(p["w"][0, 0]) == 2.0
    elif case == "latest_falls_back":
        save(os.path.join(d, "step_4"), _params(4), step=4)
        _corrupt(d, 4, "torn")
        with pytest.warns(UserWarning, match="skipping invalid checkpoint"):
            ck = tckpt.latest_checkpoint(d)
        assert ck.endswith("step_2")
        p, _, _, step, _ = tckpt.load_checkpoint(ck)
        assert step == 2 and torch.equal(p["nested"]["b"],
                                         torch.full((3,), 2.0))
    elif case == "retention":
        os.makedirs(os.path.join(d, "step_9.tmp"))        # an orphan
        for s in (3, 4, 5):
            save(os.path.join(d, f"step_{s}"), _params(s), step=s,
                 keep_last=2)
        assert [s for s, _ in tckpt.list_checkpoints(d)] == [5, 4]
        assert not os.path.exists(os.path.join(d, "step_9.tmp"))
        # a save over an existing step replaces it whole
        save(os.path.join(d, "step_5"), _params(7), step=5)
        p, _, _, _, _ = tckpt.load_checkpoint(os.path.join(d, "step_5"))
        assert float(p["w"][0, 0]) == 7.0
        assert sorted(os.listdir(d)) == ["step_4", "step_5"]
        tckpt.gc_checkpoints(d, keep_last=1)
        assert [s for s, _ in tckpt.list_checkpoints(d)] == [5]
        assert jckpt.latest_checkpoint(d).endswith("step_5")


# ------------------------------------------------------- callbacks

class _Net(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.lin = tnn.Linear(4, 1)

    def forward(self, x):
        return self.lin(x)


def test_model_checkpoint_publishes_atomically_and_keeps_last(tmp_path):
    model = TModel(_Net())
    sched = topt.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    model.prepare(topt.SGD(sched, parameters=model.parameters()),
                  loss=lambda out, y: ((out - y) ** 2).mean())
    rng = np.random.default_rng(0)
    data = TTensorDataset([rng.standard_normal((8, 4)).astype(np.float32),
                           rng.standard_normal((8, 1)).astype(np.float32)])
    model.fit(data, batch_size=4, epochs=3, verbose=0, save_dir=str(tmp_path),
              callbacks=[tcbks.ModelCheckpoint(save_dir=str(tmp_path),
                                               keep_last=1)])
    assert sorted(os.listdir(tmp_path)) == [
        "2.pdopt", "2.pdparams", "final.pdopt", "final.pdparams"]
    # the default LRScheduler callback stepped once per epoch
    assert sched.last_epoch == 3
    sd = ptt.load(str(tmp_path / "final.pdparams"), device="cpu")
    assert torch.equal(sd["lin.weight"], model.network.lin.weight)
    opt = ptt.load(str(tmp_path / "final.pdopt"), return_numpy=True)
    assert opt["LR_Scheduler"]["last_epoch"] == 3


class _Saver:
    def __init__(self):
        self.saved, self.stop_training = [], False

    def save(self, path):
        self.saved.append(os.path.basename(path))


@pytest.mark.parametrize("monitor", ["loss", "acc"])
def test_early_stopping_matches_jax(tmp_path, monitor):
    seq = [{"eval_" + monitor: v, monitor: 0.0}
           for v in (0.5, 0.4, 0.45, 0.41, 0.6, 0.3)]
    out = []
    for mod in (jcbks, tcbks):
        cb = mod.EarlyStopping(monitor=monitor, patience=1, verbose=0,
                               min_delta=0.01)
        m = _Saver()
        cb.set_model(m)
        cb.set_params({"save_dir": str(tmp_path)})
        cb.on_train_begin()
        stops = []
        for e, logs in enumerate(seq):
            cb.on_epoch_end(e, logs)
            stops.append(m.stop_training)
        out.append((stops, m.saved, cb.best, cb.wait))
    assert out[0] == out[1]
