"""The rest of the trainer's surface against the JAX package's: `summary`
and `flops` (LeNet and ResNet-18: the printed table and the totals),
`Model.summary`, the `MetricsLogger` and `VisualDL` files of a fit, and
model-file encryption (`io.crypto`: the RFC 7539 vectors, files that
cross between the packages both ways, version-1 files rejected)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

import paddle_tpu as jpaddle                                  # noqa: E402
import paddle_tpu.io as jio                                   # noqa: E402
import paddle_tpu.nn as jnn                                   # noqa: E402
import paddle_tpu.optimizer as jopt                           # noqa: E402
from paddle_tpu.core.tensor import Tensor as JTensor          # noqa: E402
from paddle_tpu.hapi import callbacks as jcbks                # noqa: E402
from paddle_tpu.io import crypto as jcrypto                   # noqa: E402
from paddle_tpu.vision import models as jmodels               # noqa: E402

import paddle_tpu_torch as ptt                                # noqa: E402
import paddle_tpu_torch.io as tio                             # noqa: E402
import paddle_tpu_torch.nn as tnn                             # noqa: E402
import paddle_tpu_torch.optimizer as topt                     # noqa: E402
from paddle_tpu_torch.core import device as tdevice           # noqa: E402
from paddle_tpu_torch.hapi import callbacks as tcbks          # noqa: E402
from paddle_tpu_torch.io import crypto as tcrypto             # noqa: E402
from paddle_tpu_torch.vision import models as tmodels         # noqa: E402

# MetricsLogger keys the JAX package takes from its async step pipeline;
# the port has none and leaves them out
PIPELINE_KEYS = {"steps_in_flight", "host_blocked_s", "steps_submitted",
                 "window"}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])


# ------------------------------------------------------- summary / flops

@pytest.mark.parametrize("name,size", [("LeNet", (1, 1, 28, 28)),
                                       ("resnet18", (1, 3, 32, 32))])
def test_summary_and_flops_match_jax(name, size, capsys):
    tnet = getattr(tmodels, name)()
    jnet = getattr(jmodels, name)()
    want = jpaddle.summary(jnet, size)
    jtext = capsys.readouterr().out
    got = ptt.summary(tnet, size)
    ttext = capsys.readouterr().out
    assert got == want
    assert ttext == jtext
    assert ptt.flops(tnet, list(size)) == jpaddle.flops(jnet, list(size))
    assert tnet.training                 # eval for the pass, then back
    m = ptt.Model(tnet)
    assert m.summary(size) == want
    capsys.readouterr()


def test_summary_counts_resnet50_parameters():
    assert ptt.summary(tmodels.resnet50(), (1, 3, 64, 64))[
        "total_params"] == 25557032
    with pytest.raises(ValueError):
        ptt.summary(tmodels.LeNet())


# -------------------------------------------------------------- callbacks

class _TNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(6, 3)

    def forward(self, x):
        return self.fc(x)


class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(6, 3)

    def forward(self, x):
        return self.fc(x)


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((20, 6)).astype(np.float32),
            rng.standard_normal((20, 3)).astype(np.float32))


def _init():
    rng = np.random.default_rng(1)
    return {"fc.weight": rng.standard_normal((6, 3)).astype(np.float32),
            "fc.bias": rng.standard_normal(3).astype(np.float32)}


def _fit(pkg, tmp_path):
    x, y = _data()
    if pkg == "port":
        net = _TNet()
        net.set_state_dict(_init())
        m = ptt.Model(net)
        m.prepare(topt.SGD(0.05, parameters=net.parameters()), loss=_mse)
        io_, cb = tio, tcbks
    else:
        net = _JNet()
        net.set_state_dict({k: JTensor(jnp.asarray(v))
                            for k, v in _init().items()})
        m = jpaddle.Model(net)
        m.prepare(jopt.SGD(0.05, parameters=net.parameters()), loss=_mse)
        io_, cb = jio, jcbks
    path = tmp_path / pkg / "metrics.jsonl"
    vdl = tmp_path / pkg / "vdl"
    m.fit(io_.TensorDataset([x, y]), batch_size=4, epochs=2, verbose=0,
          shuffle=False, callbacks=[cb.MetricsLogger(log_freq=2,
                                                     path=str(path)),
                                    cb.VisualDL(log_dir=str(vdl))])
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    tsv = (vdl / "scalars.tsv").read_text().splitlines()
    return lines, tsv


def test_metrics_logger_and_visualdl_files_match_jax(tmp_path):
    tl, ttsv = _fit("port", tmp_path)
    jl, jtsv = _fit("jax", tmp_path)
    assert len(tl) == len(jl) == 5 + 2     # steps 2, 4, ..., 10; epoch ends
    for t, j in zip(tl, jl):
        assert set(t) == set(j) - PIPELINE_KEYS, (set(t), set(j))
        assert "hbm_bytes_in_use" not in t      # nothing to report on CPU
        for k in ("event", "epoch", "step", "batch_size"):
            assert t[k] == j[k], k
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-5)
        assert isinstance(t["ts_monotonic"], float)
        assert t["steps_per_s"] >= 0.0
    assert ttsv[0].startswith("# run ") and jtsv[0].startswith("# run ")
    assert len(ttsv) == len(jtsv) == 1 + 10 * 3
    for t, j in zip(ttsv[1:], jtsv[1:]):
        ts, tk, tv = t.split("\t")
        js, jk, jv = j.split("\t")
        assert (ts, tk) == (js, jk)
        assert float(tv) == pytest.approx(float(jv), rel=1e-5)


def test_metrics_logger_hbm_on_a_cuda_model_only(monkeypatch):
    """On a CUDA device the entry is {"cuda:<i>": allocated bytes} from
    torch.cuda.memory_stats (through core.monitor, one card visible);
    elsewhere it is left out."""
    cb = tcbks.MetricsLogger()

    class M:
        _device = torch.device("cuda", 0)

    cb.set_model(M())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (0, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda dev: {"allocated_bytes.all.current": 1234})
    cb.on_train_begin()
    assert cb._payload({"loss": 1.0}, "step")["hbm_bytes_in_use"] == \
        {"cuda:0": 1234}
    M._device = torch.device("cpu")
    assert "hbm_bytes_in_use" not in cb._payload({}, "step")
    assert ptt.callbacks.VisualDL is tcbks.VisualDL


# ----------------------------------------------------------------- crypto

def test_rfc7539_vectors():
    key = bytes(range(32))
    nonce = bytes.fromhex("000000000000004a00000000")
    pt = (b"Ladies and Gentlemen of the class of '99: If I could offer "
          b"you only one tip for the future, sunscreen would be it.")
    assert tcrypto._keystream_xor(key, nonce, pt, counter=1) == \
        bytes.fromhex(
            "6e2e359a2568f98041ba0728dd0d6981e97e7aec1d4360c20a27afccfd9fae0b"
            "f91b65c5524733ab8f593dabcd62b3571639d624e65152ab8f530c359f0861d8"
            "07ca0dbf500d6a6156a38e088a22b65e52bc514d16ccf806818ce91ab7793736"
            "5af90bbf74a35be6b40b8eedf2785e42874d")
    key = bytes.fromhex("85d6be7857556d337f4452fe42d506a8"
                        "0103808afb0db2fd4abff6af4149f51b")
    assert tcrypto._poly1305(key, b"Cryptographic Forum Research Group") \
        == bytes.fromhex("a8061dc1305136c6c22b8baf0c0127a9")
    # the library lives in the build directory, not beside the source
    assert "build" in str(tcrypto._build())


def test_encrypted_files_cross_both_ways(tmp_path):
    key = tcrypto.CipherFactory.generate_key()
    data = b"\x00\x01" * 500 + b"tail"
    tcrypto.encrypt_to_file(data, key, str(tmp_path / "t.enc"))
    assert jcrypto.decrypt_from_file(key, str(tmp_path / "t.enc")) == data
    jcrypto.encrypt_to_file(data, key, str(tmp_path / "j.enc"))
    assert tcrypto.CipherFactory.create_cipher().decrypt_from_file(
        key, str(tmp_path / "j.enc")) == data
    with pytest.raises(ValueError, match="wrong key or corrupted"):
        tcrypto.decrypt_from_file(bytes(32), str(tmp_path / "j.enc"))
    with pytest.raises(ValueError, match="32 bytes"):
        tcrypto.encrypt(b"x", b"short")

    sd = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "step": 7}
    ptt.save({"w": torch.from_numpy(sd["w"]), "step": 7},
             str(tmp_path / "p.pdparams"), cipher_key=key)
    raw = (tmp_path / "p.pdparams").read_bytes()
    assert raw[:4] == b"PDTC"
    back = jpaddle.load(str(tmp_path / "p.pdparams"), cipher_key=key)
    np.testing.assert_array_equal(back["w"].numpy(), sd["w"])
    assert back["step"] == 7
    jpaddle.save({"w": jpaddle.to_tensor(sd["w"]), "step": 7},
                 str(tmp_path / "j.pdparams"), cipher_key=key)
    back = ptt.load(str(tmp_path / "j.pdparams"), cipher_key=key,
                    device="cpu")
    np.testing.assert_array_equal(back["w"].numpy(), sd["w"])
    assert back["step"] == 7
    np.testing.assert_array_equal(
        ptt.load(str(tmp_path / "j.pdparams"), cipher_key=key,
                 return_numpy=True)["w"], sd["w"])
    with pytest.raises(ValueError):
        ptt.load(str(tmp_path / "j.pdparams"), cipher_key=bytes(32))


def test_version1_files_rejected():
    key = tcrypto.CipherFactory.generate_key()
    for enc in (tcrypto.encrypt, jcrypto.encrypt):
        blob = enc(b"payload", key)
        v1 = blob[:4] + bytes([1]) + blob[5:]
        for dec in (tcrypto.decrypt, jcrypto.decrypt):
            with pytest.raises(ValueError, match="version"):
                dec(v1, key)
