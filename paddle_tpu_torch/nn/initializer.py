"""Parameter initializers (port of paddle_tpu's `nn/initializer`): each is
called with (shape, device) and draws on the CPU from `core.random`'s
generator, so one `seed` gives the same weights on every device."""
from __future__ import annotations

import math

import torch

from ..core.random import generator

__all__ = ["Normal", "XavierNormal", "Constant"]


def _fans(shape):
    """(fan_in, fan_out) of a weight shaped [in, out] (or [in] / [..., in,
    out] with receptive field, as the JAX package counts them)."""
    if len(shape) < 2:
        return shape[0], shape[0]
    field = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[0] * field, shape[1] * field


class Normal:
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, shape, device):
        t = torch.randn(tuple(shape), generator=generator()) * self.std
        return (t + self.mean).to(device)


class XavierNormal:
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, device):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, device)


class Constant:
    def __init__(self, value=0.0):
        self.value = float(value)

    def __call__(self, shape, device):
        return torch.full(tuple(shape), self.value, device=device)
