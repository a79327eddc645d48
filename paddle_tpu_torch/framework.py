"""Framework glue (port of paddle_tpu's `framework.py`): `save` / `load`,
`ParamAttr`, and the two helpers that feed the pure decode fns.

`save(obj, path)` pickles a (nested) state dict in the JAX package's
format: every tensor becomes a host numpy array (`core.arrays.to_numpy`:
bf16 as an `ml_dtypes.bfloat16` array where ml_dtypes is installed, else
as its raw bits in a structured uint16 array), so a file either package
writes loads in the other. `load(path)` gives the arrays back as tensors
on the default device (`set_device`; cuda, which raises without a GPU) or
on `device=`; `return_numpy=True` keeps them numpy. Encrypted files
(`cipher_key`, the JAX package's io/crypto) are not ported and raise.

`param_arrays(GPT(cfg))` is the param dict `models.gpt.gpt_decode_fns`
takes: the port's `Layer.state_dict()` names are the JAX package's
expanded per-block names (``blocks.3.attn.qkv.weight``), the layout
`split_decode_params` reads.

The JAX package's GPT scans its blocks by default, and what it keys by
parameter (its optimizer's ``functional_state``, the train step's params)
then uses one stacked name per block parameter, ``blocks.attn.qkv.weight``
with a leading [layers] axis. `stacked_layout` and `indexed_layout`
convert a {name: value} dict between that layout and the port's indexed
names for the GPTs inside a layer.
"""
from __future__ import annotations

import os
import pickle
import re
from typing import Dict

import numpy as np
import torch

from .core.arrays import to_numpy, to_tensor
from .core.device import get_device, resolve_device

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


def _no_cipher(cipher_key):
    if cipher_key is not None:
        raise NotImplementedError("cipher_key: encrypted files (io/crypto) "
                                  "are not ported to paddle_tpu_torch")


def save(obj, path, protocol=4, cipher_key=None):
    """paddle.save: pickle a (possibly nested) state dict, tensors as host
    numpy arrays."""
    _no_cipher(cipher_key)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path, return_numpy=False, cipher_key=None, device=None):
    """paddle.load: the pickled object, its arrays as tensors on `device`
    (default: the default device), or as numpy with `return_numpy`."""
    _no_cipher(cipher_key)
    dev = None if return_numpy else (
        get_device() if device is None else resolve_device(device))
    with open(path, "rb") as f:
        obj = pickle.load(f)
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


def _gpts(layer):
    """(name prefix, GPT) of every port GPT inside `layer`."""
    from .models.gpt import GPT
    return [(name + "." if name else "", m)
            for name, m in layer.named_modules() if isinstance(m, GPT)]


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
    in `layer` that scans in the JAX package (``cfg.scan_layers`` not
    False) keyed as the JAX package keys it: ``{p}blocks.{i}.{rel}`` for
    every i stacked under ``{p}blocks.{rel}``; a 0-d value (a beta power)
    is the same in every block and is kept once."""
    out = dict(tree)
    for pre, gpt in _gpts(layer):
        if gpt.cfg.scan_layers is False:
            continue
        pat = re.compile(re.escape(pre) + r"blocks\.(\d+)\.(.+)$")
        groups = {}
        for k in list(out):
            m = pat.match(k)
            if m:
                groups.setdefault(m.group(2), {})[int(m.group(1))] = \
                    out.pop(k)
        for rel, by_i in groups.items():
            out[f"{pre}blocks.{rel}"] = _stack(
                [by_i[i] for i in range(gpt.cfg.layers)], f"{pre}blocks.{rel}")
    return out


def _index(v, i):
    if isinstance(v, dict):
        return {k: _index(x, i) for k, x in v.items()}
    return v if np.ndim(v) == 0 else v[i]


def indexed_layout(tree, layer):
    """The inverse of `stacked_layout`: every stacked ``{p}blocks.{rel}``
    of a port GPT in `layer` split into ``{p}blocks.{i}.{rel}`` (a 0-d
    value repeated); other names pass through."""
    out = dict(tree)
    for pre, gpt in _gpts(layer):
        pat = re.compile(re.escape(pre) + r"blocks\.(?!\d+\.)(.+)$")
        for k in list(out):
            m = pat.match(k)
            if m:
                v = out.pop(k)
                for i in range(gpt.cfg.layers):
                    out[f"{pre}blocks.{i}.{m.group(1)}"] = _index(v, i)
    return out
