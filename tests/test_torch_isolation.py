"""paddle_tpu_torch stands alone: it imports neither jax nor paddle_tpu,
and its entry points default to the GPU and raise when there is none."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")


def _modules():
    out = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                out.append(mod[:-len(".__init__")]
                           if mod.endswith(".__init__") else mod)
    return sorted(out)


def test_importing_every_module_loads_no_jax_and_no_paddle_tpu():
    mods = _modules()
    assert "paddle_tpu_torch.inference.decode" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith(('jax.', 'jaxlib'))\n"
        "             or n == 'paddle_tpu' or n.startswith('paddle_tpu.'))\n"
        "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []", out.stdout


def test_no_source_file_imports_jax_or_paddle_tpu():
    offenders = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                for n in names:
                    top = n.split(".")[0]
                    if top in ("jax", "jaxlib", "paddle_tpu"):
                        offenders.append(f"{path}: {n}")
    assert not offenders, offenders


def test_default_device_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.inference import decode, serve
    from paddle_tpu_torch.models import gpt

    cfg = gpt.gpt_tiny()
    arrays = gpt.init_params_numpy(cfg, seed=0)
    prefix = str(tmp_path / "gpt")
    decode.save_for_decode(arrays, cfg, 1e-5, prefix)
    calls = [
        lambda: resolve_device(None),
        lambda: resolve_device("cuda:0"),
        lambda: gpt.GPTDecoder(cfg),
        lambda: gpt.params_from_numpy(cfg, arrays),
        lambda: decode.DecodeEngine(
            cfg=cfg, params=gpt.params_from_numpy(cfg, arrays, "cpu")),
        lambda: decode.load_for_decode(prefix),
        lambda: serve.InferenceServer(prefix, port=0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    # the CPU is reachable only by asking for it
    eng = decode.load_for_decode(prefix, device="cpu", max_slots=1)
    try:
        assert len(eng.submit(np.arange(4), max_new_tokens=2)
                   .result(timeout=60)) == 2
    finally:
        eng.stop()


def test_training_entry_points_default_to_cuda(monkeypatch):
    """GPT(cfg), set_device() and Model.prepare use the GPU unless told
    otherwise, and raise without one; set_device("cpu") opens the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.core import device as device_mod
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import GPT, gpt_tiny
    from paddle_tpu_torch.optimizer import Adam

    monkeypatch.setattr(device_mod, "_DEFAULT", [None])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPT(gpt_tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ptt.set_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ptt.set_device("gpu:0")
    assert device_mod._DEFAULT == [None]        # a failed call changes nothing
    assert ptt.set_device("cpu") == torch.device("cpu")
    net = GPT(gpt_tiny())
    assert net.wte.weight.device.type == "cpu"
    model = Model(net)
    adam = Adam(parameters=model.parameters())
    monkeypatch.setattr(device_mod, "_DEFAULT", [None])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.prepare(adam)
    ptt.set_device("cpu")
    model.prepare(adam)
