"""conv2d (port of paddle_tpu's `nn/functional/conv.py`).

The weight is [out, in/groups, kh, kw] in both data formats, as in the
JAX package, so an NHWC layer's parameters are an NCHW layer's. NHWC runs
as a permuted view (channels-last strides, no copy) through
`torch.nn.functional.conv2d`, which cuDNN takes as it is; the output is
permuted back. Padding takes paddle's forms: an int, one int per spatial
dim, a (before, after) pair per dim (flat or nested), or "SAME" /
"VALID". "SAME" pads as XLA does at any stride: out = ceil(in / stride),
the total pad split with the odd element at the end. An asymmetric pad
goes in as an explicit `F.pad`; a symmetric one is the convolution's own.
"""
from __future__ import annotations

import math

import torch.nn.functional as TF

from ...amp import maybe_cast_inputs

__all__ = ["conv2d"]


def _tuplize(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(i) for i in v)


def _padding(padding, n):
    """Paddle padding as "SAME" / "VALID" or n (before, after) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    return [tuple(p) for p in padding]


def same_pads(sizes, windows, strides):
    """XLA's SAME padding (`lax.padtype_to_pads`): per dim, the output is
    ceil(size / stride) and the total pad max((out - 1) * stride + window
    - size, 0), split with the odd element at the end."""
    pads = []
    for size, win, st in zip(sizes, windows, strides):
        total = max((math.ceil(size / st) - 1) * st + win - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def resolve_pads(padding, sizes, windows, strides):
    """n (before, after) pairs for paddle `padding` over spatial `sizes`
    (VALID is no padding; SAME as `same_pads`)."""
    pad = _padding(padding, len(sizes))
    if pad == "VALID":
        return [(0, 0)] * len(sizes)
    if pad == "SAME":
        return same_pads(sizes, windows, strides)
    if isinstance(pad, str):
        raise ValueError(f"padding {padding!r}: want SAME or VALID")
    return [(int(a), int(b)) for a, b in pad]


def flat_pad(pads):
    """(before, after) pairs of the spatial dims in order as `F.pad`'s
    flat list (last dim first)."""
    return [v for a, b in reversed(pads) for v in (a, b)]


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution, cast as the JAX package's "conv2d" (white-listed:
    bf16 inputs and output under AMP)."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"conv2d data_format {data_format!r}: want NCHW "
                         f"or NHWC")
    args = [x, weight] + ([] if bias is None else [bias])
    args = maybe_cast_inputs("conv2d", args)
    a, w = args[0], args[1]
    channels_last = data_format == "NHWC"
    if channels_last:
        a = a.permute(0, 3, 1, 2)
    stride, dilation = _tuplize(stride, 2), _tuplize(dilation, 2)
    eff = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dilation)]
    pads = resolve_pads(padding, a.shape[2:], eff, stride)
    if all(lo == hi for lo, hi in pads):
        conv_pad = tuple(lo for lo, _ in pads)
    else:
        a = TF.pad(a, flat_pad(pads))
        conv_pad = 0
    out = TF.conv2d(a, w, args[2] if bias is not None else None, stride,
                    conv_pad, dilation, groups)
    return out.permute(0, 2, 3, 1) if channels_last else out
