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


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train"):
    """Dropout with the JAX package's modes. "upscale_in_train": kept
    elements scaled by 1 / (1 - p) in training, the identity otherwise;
    "downscale_in_infer": kept elements unscaled in training, x * (1 - p)
    otherwise. `axis` (an int or a list) draws one mask entry per index of
    those dims, shared along the others. The identity when training with
    p == 0. The mask comes from PyTorch's generator for x's device
    (seeded by `seed`), so it differs from the JAX package's bits."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r}: want 'upscale_in_train' "
                         f"or 'downscale_in_infer'")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            (x,) = maybe_cast_inputs("dropout_infer", (x,))
            return x * (1.0 - p)
        return x
    (x,) = maybe_cast_inputs("dropout", (x,))
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = [a % x.dim() for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, device=x.device) >= p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros_like(x)).to(x.dtype)
