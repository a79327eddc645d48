"""What every library op does around its torch call: the AMP casts under
the JAX package's dispatch name, non-tensor array inputs as tensors, the
JAX package's dtype rules where torch's differ, and the wrapping rule of
`core.tensor` (a paddle `Tensor` in, `Tensor`s out)."""
from __future__ import annotations

import torch

from ..amp import maybe_cast_inputs
from ..core import dtype as dtype_mod
from ..core.tensor import Tensor, paddle_out

__all__ = ["cast_in", "as_t", "out", "axes", "inexact", "to_inexact",
           "float_scalar", "np_int", "is_int_like", "pair", "operands",
           "promote"]

out = paddle_out


def cast_in(name, *args):
    """`args` cast as the JAX dispatcher casts an op named `name` (an
    `amp.auto_cast` rule; outside one, `args` as they are)."""
    return maybe_cast_inputs(name, args)


def as_t(x, like=None):
    """`x` as a tensor: tensors as they are, arrays and scalars on the
    device of `like` (else the default device) with the JAX package's
    dtype rules (`to_tensor`'s)."""
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        return torch.Tensor.detach(Tensor(x, place=like.device))
    return torch.Tensor.detach(Tensor(x))


def axes(axis, ndim=None):
    """paddle's `axis` (None, an int, a list or tuple, or a Tensor) as
    torch's `dim`: None with `ndim` given means every axis."""
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if axis is None:
        return None if ndim is None else tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def inexact(dtype):
    """The dtype the JAX package computes a float function of `dtype` in:
    floating and complex dtypes stay, int64 becomes float64, other ints
    and bool float32."""
    if dtype_mod.is_inexact(dtype):
        return dtype
    return torch.float64 if dtype in (torch.int64,) else torch.float32


def to_inexact(t):
    """`t` in `inexact(t.dtype)`."""
    d = inexact(t.dtype)
    return t if d == t.dtype else t.to(d)


def float_scalar(t, *scalars):
    """An integer or bool tensor meeting a Python float becomes float64,
    as under the JAX package's x64 promotion."""
    if (isinstance(t, torch.Tensor) and not dtype_mod.is_inexact(t.dtype)
            and any(isinstance(s, float) for s in scalars)):
        return t.to(torch.float64)
    return t


def np_int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def is_int_like(t):
    return isinstance(t, torch.Tensor) and not dtype_mod.is_inexact(t.dtype)


def pair(x, y):
    """Both operands of a binary op as torch takes them: tensors, or a
    Python scalar beside a tensor (an integer tensor beside a float is
    float64)."""
    if isinstance(x, torch.Tensor):
        if not isinstance(y, (torch.Tensor, bool, int, float, complex)):
            y = as_t(y, x)
        return float_scalar(x, y), y
    if isinstance(y, torch.Tensor):
        if not isinstance(x, (bool, int, float, complex)):
            x = as_t(x, y)
        return x, float_scalar(y, x)
    return as_t(x), y


def operands(x, y):
    """Both operands as tensors: an array or scalar on the other's
    device."""
    a = as_t(x, y if isinstance(y, torch.Tensor)
             and not isinstance(x, torch.Tensor) else None)
    return a, as_t(y, a)


def promote(a, b):
    """Two tensors in their common dtype (torch's promotion)."""
    dt = torch.result_type(a, b)
    return a.to(dt), b.to(dt)
