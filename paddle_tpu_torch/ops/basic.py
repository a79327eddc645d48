"""The generic tensor ops of the training path, each casting its inputs
through `amp.maybe_cast_inputs` as the JAX package's dispatcher does for
its `ops` (math, manipulation, search, creation).

Under AMP O2 these matter: none of them is on the black list, so a
residual add, a reshape, a `where` or a `sum` gets bf16 inputs there
(`sum` then reduces in fp32 and rounds its result to bf16, as `jnp.sum`
does). Outside `auto_cast` each is the plain torch op.
"""
from __future__ import annotations

import torch

from ..amp import maybe_cast_inputs


def add(x, y):
    x, y = maybe_cast_inputs("add", (x, y))
    return x + y


def divide(x, y):
    x, y = maybe_cast_inputs("divide", (x, y))
    return x / y


def maximum(x, y):
    x, y = maybe_cast_inputs("maximum", (x, y))
    return torch.maximum(x, y)


def sum(x):                                         # noqa: A001 (paddle name)
    """Sum of every element. The JAX package's `ops.sum` dispatches under
    its inner function's name ("f"), not the black-listed "sum", so O2
    casts its input to bf16; "sum_all" keeps that rule here."""
    (x,) = maybe_cast_inputs("sum_all", (x,))
    return x.sum()


def reshape(x, shape):
    (x,) = maybe_cast_inputs("reshape", (x,))
    return x.reshape(shape)


def transpose(x, perm):
    (x,) = maybe_cast_inputs("transpose", (x,))
    return x.permute(*perm)


def chunk(x, chunks, axis=0):
    (x,) = maybe_cast_inputs("split", (x,))
    return list(x.chunk(chunks, dim=axis))


def where(cond, x, y):
    cond, x, y = maybe_cast_inputs("where", (cond, x, y))
    return torch.where(cond, x, y)


def zeros_like(x):
    (x,) = maybe_cast_inputs("zeros_like", (x,))
    return torch.zeros_like(x)


def ones_like(x):
    (x,) = maybe_cast_inputs("ones_like", (x,))
    return torch.ones_like(x)


def cast(x, dtype):
    (x,) = maybe_cast_inputs("cast", (x,))
    return x.to(dtype)


__all__ = ["add", "divide", "maximum", "sum", "reshape", "transpose", "chunk",
           "where", "zeros_like", "ones_like", "cast"]
