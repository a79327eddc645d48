"""Framework glue (port of paddle_tpu's `framework.py`): `save` / `load`,
`ParamAttr`, and the two helpers that feed the pure decode fns.

`save(obj, path)` pickles a (nested) state dict in the JAX package's
format: every tensor becomes a host numpy array (`core.arrays.to_numpy`:
bf16 as an `ml_dtypes.bfloat16` array where ml_dtypes is installed, else
as its raw bits in a structured uint16 array), so a file either package
writes loads in the other. `load(path)` gives the arrays back as tensors
on the default device (`set_device`; cuda, which raises without a GPU) or
on `device=`; `return_numpy=True` keeps them numpy. A `cipher_key`
encrypts the file through `io.crypto` (ChaCha20-Poly1305, the JAX
package's file layout, so encrypted files cross too).

`param_arrays(GPT(cfg))` is the param dict `models.gpt.gpt_decode_fns`
takes: the port's `Layer.state_dict()` names are the JAX package's
expanded per-block names (``blocks.3.attn.qkv.weight``), the layout
`split_decode_params` reads.

The JAX package's GPT and Bert scan their blocks by default, and what
they key by parameter (the optimizer's ``functional_state``, the train
step's params) then uses one stacked name per block parameter,
``blocks.attn.qkv.weight`` / ``encoder.layers.self_attn.q_proj.weight``
with a leading [layers] axis. `stacked_layout` and `indexed_layout`
convert a {name: value} dict between that layout and the port's indexed
names for the GPTs and Berts inside a layer.
"""
from __future__ import annotations

import os
import pickle
import re
from typing import Dict

import numpy as np
import torch

from .core.arrays import to_numpy, to_tensor
from .core.device import default_device, resolve_device

__all__ = ["ParamAttr", "save", "load", "param_arrays", "state_arrays",
           "stacked_layout", "indexed_layout"]


class ParamAttr:
    """Parameter attribute bundle, as the JAX package's: name,
    initializer, learning-rate scale, regularizer, trainable. The port's
    `Layer.create_parameter` reads `initializer` and sets the parameter's
    `regularizer`, which the optimizer applies in place of its own."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        return to_numpy(obj)
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _from_saved(obj, device):
    if isinstance(obj, np.ndarray):
        return to_tensor(obj, device)
    if isinstance(obj, dict):
        return {k: _from_saved(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saved(v, device) for v in obj)
    return obj


def save(obj, path, protocol=4, cipher_key=None):
    """paddle.save: pickle a (possibly nested) state dict, tensors as host
    numpy arrays. A 32-byte `cipher_key` encrypts the file (`io.crypto`,
    the JAX package's format)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if cipher_key is None:
        with open(path, "wb") as f:
            pickle.dump(_to_saveable(obj), f, protocol=protocol)
        return
    from .io import crypto
    blob = crypto.encrypt(pickle.dumps(_to_saveable(obj), protocol=protocol),
                          cipher_key)
    with open(path, "wb") as f:
        f.write(blob)


def load(path, return_numpy=False, cipher_key=None, device=None):
    """paddle.load: the pickled object, its arrays as tensors on `device`
    (default: the default device), or as numpy with `return_numpy`;
    `cipher_key` decrypts a file saved with one."""
    dev = None if return_numpy else (
        default_device() if device is None else resolve_device(device))
    if cipher_key is None:
        with open(path, "rb") as f:
            obj = pickle.load(f)
    else:
        from .io import crypto
        with open(path, "rb") as f:
            obj = pickle.loads(crypto.decrypt(f.read(), cipher_key))
    return obj if return_numpy else _from_saved(obj, dev)


def param_arrays(layer) -> Dict[str, torch.Tensor]:
    """Trainable parameters (``requires_grad``) keyed by qualified name,
    detached: the same storage, no autograd history."""
    return {n: p.detach() for n, p in layer.named_parameters()
            if p.requires_grad}


def state_arrays(layer) -> Dict[str, torch.Tensor]:
    """Non-trainable state: buffers and frozen parameters."""
    out = {n: b for n, b in layer.named_buffers()}
    out.update({n: p.detach() for n, p in layer.named_parameters()
                if not p.requires_grad})
    return out


def _stacks(layer):
    """(block-list prefix, number of blocks, whether the JAX package
    scans them) of every port GPT (``{p}blocks.``) and Bert
    (``{p}encoder.layers.``) inside `layer`."""
    from .models.bert import Bert
    from .models.gpt import GPT
    out = []
    for name, m in layer.named_modules():
        pre = name + "." if name else ""
        if isinstance(m, GPT):
            out.append((pre + "blocks.", m.cfg.layers,
                        m.cfg.scan_layers is not False))
        elif isinstance(m, Bert):
            out.append((pre + "encoder.layers.", m.cfg.layers,
                        m.cfg.scan_layers is not False))
    return out


def _stack(vals, name):
    if isinstance(vals[0], dict):
        return {k: _stack([v[k] for v in vals], f"{name}/{k}")
                for k in vals[0]}
    arrs = [np.asarray(v) for v in vals]
    if arrs[0].ndim:
        return np.stack(arrs)
    if any(a.tobytes() != arrs[0].tobytes() for a in arrs):
        raise ValueError(f"stacked_layout: {name} differs across blocks "
                         f"({[a.item() for a in arrs]}); the stacked "
                         f"layout keeps one value")
    return arrs[0]


def stacked_layout(tree, layer):
    """`tree` ({name: numpy array, or a dict of them}) with each port GPT
    or Bert in `layer` that scans in the JAX package (``cfg.scan_layers``
    not False) keyed as the JAX package keys it: ``{b}{i}.{rel}`` for
    every block i of the block list ``{b}`` (``{p}blocks.``,
    ``{p}encoder.layers.``) stacked under ``{b}{rel}``; a 0-d value (a
    beta power) is the same in every block and is kept once."""
    out = dict(tree)
    for pre, n, scans in _stacks(layer):
        if not scans:
            continue
        pat = re.compile(re.escape(pre) + r"(\d+)\.(.+)$")
        groups = {}
        for k in list(out):
            m = pat.match(k)
            if m:
                groups.setdefault(m.group(2), {})[int(m.group(1))] = \
                    out.pop(k)
        for rel, by_i in groups.items():
            out[pre + rel] = _stack([by_i[i] for i in range(n)], pre + rel)
    return out


def _index(v, i):
    if isinstance(v, dict):
        return {k: _index(x, i) for k, x in v.items()}
    return v if np.ndim(v) == 0 else v[i]


def indexed_layout(tree, layer):
    """The inverse of `stacked_layout`: every stacked ``{b}{rel}`` of a
    port GPT or Bert in `layer` split into ``{b}{i}.{rel}`` (a 0-d value
    repeated); other names pass through."""
    out = dict(tree)
    for pre, n, _ in _stacks(layer):
        pat = re.compile(re.escape(pre) + r"(?!\d+\.)(.+)$")
        for k in list(out):
            m = pat.match(k)
            if m:
                v = out.pop(k)
                for i in range(n):
                    out[f"{pre}{i}.{m.group(1)}"] = _index(v, i)
    return out
