"""linear / embedding / dropout (port of paddle_tpu's
`nn/functional/common.py`), each casting its inputs per the AMP lists."""
from __future__ import annotations

import torch

from ...amp import maybe_cast_inputs


def linear(x, weight, bias=None):
    """y = x @ W + b with W shaped [in, out] (never torch's [out, in])."""
    if bias is None:
        x, weight = maybe_cast_inputs("linear", (x, weight))
        return torch.matmul(x, weight)
    x, weight, bias = maybe_cast_inputs("linear", (x, weight, bias))
    return torch.matmul(x, weight) + bias


def embedding(x, weight):
    """Rows of `weight` at the integer ids `x`."""
    x, weight = maybe_cast_inputs("embedding", (x, weight))
    return weight[x.long()]


def dropout(x, p=0.5, training=True):
    """Inverted dropout (mode "upscale_in_train"); the identity when not
    training or p == 0. The mask comes from PyTorch's generator for x's
    device (seeded by `seed`), so it differs from the JAX package's bits."""
    if not training or p == 0.0:
        return x
    (x,) = maybe_cast_inputs("dropout", (x,))
    if p == 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x)).to(x.dtype)
