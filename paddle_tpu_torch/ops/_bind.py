"""The op library as `Tensor` methods and the arithmetic and comparison
dunders (port of paddle_tpu's `ops/_bind.py`).

Every library function whose first argument is a tensor becomes a method,
from the JAX package's list of modules with its `_SKIP` set; a name the
`Tensor` class defines itself (`astype`, `clone`, `numel`, `tolist`,
`rank`, ...) stays. Where torch has a method of the same name, a `Tensor`
gets paddle's (``x.transpose([1, 0])``, ``x.split(2)``, ``x.max(axis=1)``,
``x.argmax(-1)``, ``x.sort()``, ``x.norm(p=1)``, ``x.uniform_(min=0.)``);
a `Parameter` keeps torch's, which `torch.nn.init` and torch's own code
call (``param.uniform_(a, b, generator=g)``). The dunders call the
library: `@` is `linalg.matmul`, the comparisons and bitwise operators
`ops.logic`'s functions.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor, TensorMixin
from . import (creation, linalg, logic, manipulation, math, random, search,
               stat)

_METHOD_SOURCES = [math, manipulation, linalg, logic, search, stat, creation,
                   random]

_SKIP = {
    "zeros", "ones", "full", "arange", "linspace", "logspace", "eye", "empty",
    "meshgrid", "assign", "rand", "randn", "randint", "randperm", "uniform",
    "normal", "standard_normal", "scatter_nd", "is_tensor", "broadcast_shape",
    "stride_check",
}

_OWN = set(vars(Tensor)) | set(vars(TensorMixin))

for mod in _METHOD_SOURCES:
    for name in getattr(mod, "__all__", []):
        if name in _SKIP or name in _OWN:
            continue
        fn = getattr(mod, name)
        if callable(fn):
            setattr(Tensor, name, fn)


def _binary_dunder(fn, reverse=False):
    if reverse:
        def op(self, other):
            return fn(other, self)
    else:
        def op(self, other):
            return fn(self, other)
    return op


Tensor.__add__ = _binary_dunder(math.add)
Tensor.__radd__ = _binary_dunder(math.add, True)
Tensor.__sub__ = _binary_dunder(math.subtract)
Tensor.__rsub__ = _binary_dunder(math.subtract, True)
Tensor.__mul__ = _binary_dunder(math.multiply)
Tensor.__rmul__ = _binary_dunder(math.multiply, True)
Tensor.__truediv__ = _binary_dunder(math.divide)
Tensor.__rtruediv__ = _binary_dunder(math.divide, True)
Tensor.__floordiv__ = _binary_dunder(math.floor_divide)
Tensor.__rfloordiv__ = _binary_dunder(math.floor_divide, True)
Tensor.__mod__ = _binary_dunder(math.remainder)
Tensor.__rmod__ = _binary_dunder(math.remainder, True)
Tensor.__pow__ = _binary_dunder(math.pow)
Tensor.__rpow__ = _binary_dunder(math.pow, True)
Tensor.__matmul__ = _binary_dunder(linalg.matmul)
Tensor.__rmatmul__ = _binary_dunder(linalg.matmul, True)
Tensor.__neg__ = lambda self: math.neg(self)
Tensor.__abs__ = lambda self: math.abs(self)
Tensor.__invert__ = lambda self: logic.logical_not(self) \
    if self.dtype == torch.bool else logic.bitwise_not(self)
Tensor.__and__ = _binary_dunder(logic.bitwise_and)
Tensor.__or__ = _binary_dunder(logic.bitwise_or)
Tensor.__xor__ = _binary_dunder(logic.bitwise_xor)
Tensor.__eq__ = _binary_dunder(logic.equal)
Tensor.__ne__ = _binary_dunder(logic.not_equal)
Tensor.__lt__ = _binary_dunder(logic.less_than)
Tensor.__le__ = _binary_dunder(logic.less_equal)
Tensor.__gt__ = _binary_dunder(logic.greater_than)
Tensor.__ge__ = _binary_dunder(logic.greater_equal)
Tensor.__hash__ = torch.Tensor.__hash__   # __eq__ would otherwise drop it

