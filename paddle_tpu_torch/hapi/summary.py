"""Model summary and FLOPs estimate (port of paddle_tpu's
`hapi/summary.py`).

`summary(net, input_size)` runs one eval-mode forward of zeros on the
device of the network's parameters and prints the JAX package's table:
one row per sublayer (in `named_sublayers` order: depth first, each
layer before its children) with its type, the shape of its first output
and its own parameter count, then the totals, which it returns as
``{"total_params", "trainable_params"}``. Buffers (batch norm's running
statistics) are not parameters and are not counted.

`flops(net, input_size)` is the JAX package's multiply-accumulate count
of the convolutions (output elements x in-channels / groups x kernel
area) and the linear layers (output elements x in-features), from one
forward of zeros.
"""
from __future__ import annotations

import math

import torch

from ..core.device import default_device
from ..core.dtype import convert_dtype
from ..nn.layer.common import Linear
from ..nn.layer.conv import Conv2D

__all__ = ["summary", "flops"]


def _numel(t):
    return int(math.prod(t.shape))


def _device(net):
    p = next(iter(net.parameters()), None)
    return p.device if p is not None else default_device()


def _first(outputs):
    return outputs[0] if isinstance(outputs, (list, tuple)) else outputs


def _zeros(size, dtype, device):
    return torch.zeros([d if d is not None else 1 for d in size],
                       dtype=dtype, device=device)


def _eval_forward(net, x):
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*x)
    finally:
        if was_training:
            net.train()


def summary(net, input_size=None, dtypes=None, input=None):
    """Print a per-layer table; returns {'total_params',
    'trainable_params'}."""
    rows = []
    hooks = []

    def mk_hook(name):
        def hook(layer, inputs, outputs):
            out = _first(outputs)
            shape = list(out.shape) if hasattr(out, "shape") else "?"
            own = sum(_numel(p) for p in layer.parameters(recurse=False))
            rows.append((name, type(layer).__name__, shape, own))
        return hook

    for name, sub in net.named_modules():
        if sub is not net:
            hooks.append(sub.register_forward_hook(mk_hook(name)))
    try:
        if input is not None:
            x = list(input) if isinstance(input, (list, tuple)) else [input]
        elif input_size is not None:
            sizes = (input_size if isinstance(input_size, list)
                     else [input_size])
            dts = dtypes if isinstance(dtypes, (list, tuple)) else \
                [dtypes] * len(sizes)
            dev = _device(net)
            x = [_zeros(s, convert_dtype(dt or "float32"), dev)
                 for s, dt in zip(sizes, dts)]
        else:
            raise ValueError("summary needs input_size or input")
        _eval_forward(net, x)
    finally:
        for h in hooks:
            h.remove()

    params = net.parameters()
    total = sum(_numel(p) for p in params)
    trainable = sum(_numel(p) for p in params if p.requires_grad)
    width = max([len(r[0]) for r in rows] + [10])
    print(f"{'Layer':<{width}}  {'Type':<20} {'Output Shape':<20} Params")
    print("-" * (width + 50))
    for name, tname, shape, own in rows:
        print(f"{name:<{width}}  {tname:<20} {str(shape):<20} {own}")
    print("-" * (width + 50))
    print(f"Total params: {total:,}\nTrainable params: {trainable:,}")
    return {"total_params": total, "trainable_params": trainable}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Multiply-accumulates of the convolutions and linear layers of one
    forward at `input_size`."""
    total = [0]
    hooks = []

    def conv_hook(layer, inputs, outputs):
        k = math.prod(layer._kernel_size)
        total[0] += (_numel(_first(outputs)) * layer._in_channels
                     // layer._groups * k)

    def linear_hook(layer, inputs, outputs):
        total[0] += _numel(_first(outputs)) * layer.weight.shape[0]

    for sub in net.modules():
        if isinstance(sub, Conv2D):
            hooks.append(sub.register_forward_hook(conv_hook))
        elif isinstance(sub, Linear):
            hooks.append(sub.register_forward_hook(linear_hook))
    try:
        _eval_forward(net, [_zeros(input_size, torch.float32,
                                   _device(net))])
    finally:
        for h in hooks:
            h.remove()
    if print_detail:
        print(f"FLOPs (MACs): {total[0]:,}")
    return total[0]
