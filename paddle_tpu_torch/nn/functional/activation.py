"""Activation functionals (port of paddle_tpu's
`nn/functional/activation.py`).

Every name a layer can take as its ``activation`` string
(`TransformerEncoderLayer` resolves it with ``getattr(F, activation)``)
and call with one tensor. Each casts its input through
`amp.maybe_cast_inputs` under the JAX package's op name: softmax and
log_softmax are black-listed (fp32 under AMP), every other one is gray
(bf16 under O2, unchanged under O1), as in the JAX lists. The arithmetic
is the JAX package's where it differs from torch's own (hardsigmoid's
slope, softplus's threshold). rrelu (in training) and gumbel_softmax draw
from PyTorch's generator, so their bits differ from the JAX package's.

Not ported: the in-place `relu_` / `tanh_` (the JAX package rebinds the
tensor to a result whose dtype AMP may have changed, which a torch tensor
cannot do in place), and `prelu` and `maxout`, which need a weight or a
group count and so cannot be a layer's one-argument activation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...amp import _dtype, maybe_cast_inputs

__all__ = [
    "relu", "relu6", "elu", "selu", "celu", "gelu", "sigmoid",
    "log_sigmoid", "softmax", "log_softmax", "tanh", "leaky_relu",
    "hardshrink", "hardtanh", "hardsigmoid", "hardswish", "silu", "swish",
    "mish", "softplus", "softshrink", "softsign", "tanhshrink",
    "thresholded_relu", "glu", "gumbel_softmax", "rrelu",
]


def _cast(op_name, x):
    (x,) = maybe_cast_inputs(op_name, (x,))
    return x


def relu(x):
    return torch.relu(_cast("relu", x))


def relu6(x):
    return _cast("relu6", x).clamp(0.0, 6.0)


def elu(x, alpha=1.0):
    return TF.elu(_cast("elu", x), alpha=alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    a = _cast("selu", x)
    return scale * torch.where(a > 0, a, alpha * torch.expm1(a))


def celu(x, alpha=1.0):
    return TF.celu(_cast("celu", x), alpha=alpha)


def gelu(x, approximate=False):
    """GELU; exact (erf) unless `approximate` (tanh), as jax.nn.gelu."""
    return TF.gelu(_cast("gelu", x),
                   approximate="tanh" if approximate else "none")


def sigmoid(x):
    return torch.sigmoid(_cast("sigmoid", x))


def log_sigmoid(x):
    return TF.logsigmoid(_cast("log_sigmoid", x))


def _softmax(op_name, fn, x, axis, dtype):
    a = _cast(op_name, x)
    if dtype is not None:
        a = a.to(_dtype(dtype))
    return fn(a, dim=axis)


def softmax(x, axis=-1, dtype=None):
    return _softmax("softmax", torch.softmax, x, axis, dtype)


def log_softmax(x, axis=-1, dtype=None):
    return _softmax("log_softmax", torch.log_softmax, x, axis, dtype)


def tanh(x):
    return torch.tanh(_cast("tanh", x))


def leaky_relu(x, negative_slope=0.01):
    return TF.leaky_relu(_cast("leaky_relu", x), negative_slope)


def hardshrink(x, threshold=0.5):
    a = _cast("hardshrink", x)
    return torch.where(a.abs() > threshold, a, torch.zeros_like(a))


def hardtanh(x, min=-1.0, max=1.0):                   # noqa: A002 (paddle)
    return _cast("hardtanh", x).clamp(min, max)


def hardsigmoid(x, slope=0.1666667, offset=0.5):
    return (_cast("hardsigmoid", x) * slope + offset).clamp(0.0, 1.0)


def hardswish(x):
    a = _cast("hardswish", x)
    return a * (a + 3.0).clamp(0.0, 6.0) / 6.0


def silu(x):
    return TF.silu(_cast("silu", x))


def swish(x):
    return silu(x)


def mish(x):
    a = _cast("mish", x)
    return a * torch.tanh(TF.softplus(a))


def softplus(x, beta=1.0, threshold=20.0):
    """softplus(beta x) / beta, and x itself where beta x > threshold."""
    a = _cast("softplus", x)
    return torch.where(a * beta > threshold, a, TF.softplus(a * beta) / beta)


def softshrink(x, threshold=0.5):
    a = _cast("softshrink", x)
    return torch.sign(a) * (a.abs() - threshold).clamp_min(0.0)


def softsign(x):
    return TF.softsign(_cast("soft_sign", x))


def tanhshrink(x):
    a = _cast("tanhshrink", x)
    return a - torch.tanh(a)


def thresholded_relu(x, threshold=1.0):
    a = _cast("thresholded_relu", x)
    return torch.where(a > threshold, a, torch.zeros_like(a))


def glu(x, axis=-1):
    return TF.glu(_cast("glu", x), dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    """softmax((x + Gumbel noise) / temperature); with `hard`, the one-hot
    of its argmax carrying the soft result's gradient."""
    a = _cast("gumbel_softmax", x)
    u = torch.rand(a.shape, device=a.device).clamp(1e-20, 1.0)
    g = (-torch.log(-torch.log(u))).to(a.dtype)
    y = torch.softmax((a + g) / temperature, dim=axis)
    if hard:
        onehot = torch.zeros_like(y).scatter_(
            axis, torch.argmax(y, axis, keepdim=True), 1.0)
        y = onehot + y - y.detach()
    return y


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True):
    """Leaky ReLU with a slope drawn per element from U(lower, upper) in
    training, and the mean slope otherwise."""
    if not training:
        return leaky_relu(x, (lower + upper) / 2.0)
    a = _cast("rrelu", x)
    slope = torch.empty(a.shape, device=a.device).uniform_(lower, upper)
    return torch.where(a >= 0, a, slope.to(a.dtype) * a)
