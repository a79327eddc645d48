"""Comparison, logical and bitwise ops (port of paddle_tpu's
`ops/logic.py`).

Each op casts its inputs under AMP by the JAX dispatcher's name for it:
the jnp function's name for the elementwise ops (`greater_than` as
"greater", `less_than` as "less", ...), "<lambda>" for `equal_all`,
`allclose` and `isclose`. `equal_all` and `allclose` return a 0-d bool
tensor, as `is_empty` does. The `Tensor` comparison and bitwise dunders
call these functions (`ops._bind`).
"""
from __future__ import annotations

import torch

from ..core.tensor import Parameter, Tensor, wrap
from ._dispatch import as_t, cast_in, operands, out, pair, promote

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "equal_all", "allclose", "isclose", "logical_and",
    "logical_or", "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_not", "bitwise_xor", "is_empty", "is_tensor",
]


def _cmp(jname, tfn):
    def op(x, y, name=None):
        a, b = cast_in(jname, *pair(x, y))
        return out(tfn(a, b), x, y)
    op.__name__ = jname
    return op


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less", torch.lt)
less_equal = _cmp("less_equal", torch.le)
logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)
bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)


def logical_not(x, name=None):
    (a,) = cast_in("logical_not", as_t(x))
    return out(torch.logical_not(a), x)


def bitwise_not(x, name=None):
    (a,) = cast_in("bitwise_not", as_t(x))
    return out(torch.bitwise_not(a), x)


def equal_all(x, y, name=None):
    """True when both have one shape and equal values (a 0-d bool)."""
    a, b = cast_in("<lambda>", *operands(x, y))
    if tuple(a.shape) != tuple(b.shape):
        return out(torch.zeros((), dtype=torch.bool, device=a.device), x, y)
    return out(torch.all(torch.eq(a, b)), x, y)


def _isclose(a, b, rtol, atol, equal_nan):
    a, b = promote(a, b)
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a, b = cast_in("<lambda>", *operands(x, y))
    return out(torch.all(_isclose(a, b, rtol, atol, equal_nan)), x, y)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a, b = cast_in("<lambda>", *operands(x, y))
    return out(_isclose(a, b, rtol, atol, equal_nan), x, y)


def is_empty(x, name=None):
    """Whether `x` has no elements, as a 0-d bool `Tensor` on its
    device."""
    a = as_t(x)
    return wrap(torch.tensor(a.numel() == 0, device=a.device))


def is_tensor(x):
    """Whether `x` is a paddle `Tensor` or `Parameter` (numpy arrays and
    lists are not)."""
    return isinstance(x, (Tensor, Parameter))
