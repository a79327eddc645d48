"""Elementwise and reduction math ops (port of paddle_tpu's `ops/math.py`).

Each op casts its inputs under AMP by the name the JAX dispatcher gives
it: the jnp function's own name for the elementwise ops ("add",
"power", "arcsin", "_true_divide_f32", ...) and the name of the inner
function for the rest ("<lambda>" for `max`, `mean`, `clip`, ...; "f"
for `cumsum`, `scale`, ...), so that O1 and O2 cast the same inputs as
there (`sum` among the latter: "f"). Result dtypes follow the JAX package under x64:
a float function of an int64 tensor is float64, of other ints float32;
an integer tensor meeting a Python float becomes float64; reductions of
ints sum in int64.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtype_mod
from ._dispatch import (as_t, axes, cast_in, float_scalar, inexact,
                        is_int_like, out, to_inexact)
from ._dispatch import pair as _pair

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "floor_mod", "pow", "sqrt", "rsqrt", "square", "exp", "expm1",
    "log", "log2", "log10", "log1p", "abs", "neg", "sign", "floor", "ceil",
    "round", "trunc", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
    "cosh", "tanh", "tanh_", "addmm", "all", "any", "asinh", "acosh", "atanh", "reciprocal", "clip",
    "maximum", "minimum", "fmax", "fmin", "max", "min", "amax", "amin",
    "sum", "nansum", "mean", "nanmean", "prod", "cumsum", "cumprod",
    "logsumexp", "logcumsumexp", "add_n", "scale", "stanh", "erf", "erfinv",
    "lgamma", "digamma", "atan2", "isnan", "isinf", "isfinite", "nan_to_num",
    "kron", "inner", "outer", "trace", "increment", "multiplex", "lerp",
    "rad2deg", "deg2rad", "gcd", "lcm", "angle", "conj", "real", "imag",
    "heaviside", "frac", "sgn", "diff", "count_nonzero",
]


def _binary(jname, tfn):
    def op(x, y, name=None):
        a, b = cast_in(jname, *_pair(x, y))
        return out(tfn(a, b), x, y)
    return op


def _same(tfn):
    """A torch binary op that wants one dtype: both operands promoted."""
    def f(a, b):
        if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
            dt = torch.result_type(a, b)
            a, b = a.to(dt), b.to(dt)
        elif not isinstance(a, torch.Tensor):
            a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
        else:
            b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
        return tfn(a, b)
    return f


def _true_divide(a, b):
    # int / int true division gives the default float dtype (not float64)
    o = torch.true_divide(a, b)
    if (not dtype_mod.is_inexact(_dt(a)) and not dtype_mod.is_inexact(_dt(b))
            and not isinstance(a, float) and not isinstance(b, float)):
        o = o.to(dtype_mod.get_default_dtype())
    return o


def _dt(v):
    return v.dtype if isinstance(v, torch.Tensor) else torch.get_default_dtype() \
        if isinstance(v, float) else torch.int64


def _inexact_binary(tfn):
    def f(a, b):
        dt = inexact(torch.result_type(a, b))
        return tfn(a.to(dt) if isinstance(a, torch.Tensor) else a,
                   b.to(dt) if isinstance(b, torch.Tensor) else b)
    return f


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.subtract)
multiply = _binary("multiply", torch.multiply)
divide = _binary("_true_divide_f32", _true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
remainder = _binary("remainder", torch.remainder)
mod = remainder
floor_mod = remainder
pow = _binary("power", torch.pow)
maximum = _binary("maximum", _same(torch.maximum))
minimum = _binary("minimum", _same(torch.minimum))
fmax = _binary("fmax", _same(torch.fmax))
fmin = _binary("fmin", _same(torch.fmin))
atan2 = _binary("arctan2", _inexact_binary(torch.atan2))
kron = _binary("kron", _same(torch.kron))
heaviside = _binary("heaviside", _same(torch.heaviside))
gcd = _binary("gcd", _same(torch.gcd))
lcm = _binary("lcm", _same(torch.lcm))


def _unary(jname, tfn, floats=False):
    """`floats`: a float function, computed in `inexact` of the input."""
    def op(x, name=None):
        (a,) = cast_in(jname, as_t(x))
        return out(tfn(to_inexact(a) if floats else a), x)
    return op


def _keep_ints(tfn):
    """A rounding function, the identity on integer tensors."""
    return lambda a: torch.clone(a) if is_int_like(a) else tfn(a)


def _imag(a):
    return torch.imag(a) if a.is_complex() else torch.zeros_like(a)


def _angle(a):
    return torch.angle(a if dtype_mod.is_inexact(a.dtype)
                       else a.to(torch.float64))


sqrt = _unary("sqrt", torch.sqrt, True)
rsqrt = _unary("rsqrt", torch.rsqrt, True)
square = _unary("square", torch.square)
exp = _unary("exp", torch.exp, True)
expm1 = _unary("expm1", torch.expm1, True)
log = _unary("log", torch.log, True)
log2 = _unary("log2", torch.log2, True)
log10 = _unary("log10", torch.log10, True)
log1p = _unary("log1p", torch.log1p, True)
abs = _unary("abs", torch.abs)
neg = _unary("negative", torch.neg)
sign = _unary("sign", torch.sign)
floor = _unary("floor", _keep_ints(torch.floor))
ceil = _unary("ceil", _keep_ints(torch.ceil))
round = _unary("round", _keep_ints(torch.round))
trunc = _unary("trunc", _keep_ints(torch.trunc))
sin = _unary("sin", torch.sin, True)
cos = _unary("cos", torch.cos, True)
tan = _unary("tan", torch.tan, True)
asin = _unary("arcsin", torch.asin, True)
acos = _unary("arccos", torch.acos, True)
atan = _unary("arctan", torch.atan, True)
sinh = _unary("sinh", torch.sinh, True)
cosh = _unary("cosh", torch.cosh, True)
tanh = _unary("tanh", torch.tanh, True)
asinh = _unary("arcsinh", torch.asinh, True)
acosh = _unary("arccosh", torch.acosh, True)
atanh = _unary("arctanh", torch.atanh, True)
reciprocal = _unary("reciprocal", torch.reciprocal, True)
erf = _unary("erf", torch.erf, True)
erfinv = _unary("erf_inv", torch.erfinv, True)
lgamma = _unary("lgamma", torch.lgamma, True)
digamma = _unary("digamma", torch.digamma, True)
isnan = _unary("isnan", torch.isnan)
isinf = _unary("isinf", torch.isinf)
isfinite = _unary("isfinite", torch.isfinite)
angle = _unary("angle", _angle)
conj = _unary("conj", lambda a: torch.conj(a).resolve_conj())
real = _unary("real", lambda a: torch.clone(torch.real(a)))
imag = _unary("imag", _imag)
rad2deg = _unary("rad2deg", torch.rad2deg, True)
deg2rad = _unary("deg2rad", torch.deg2rad, True)
frac = _unary("<lambda>", lambda a: torch.sub(a, torch.trunc(a))
              if dtype_mod.is_inexact(a.dtype) else torch.sub(a, a))
sgn = _unary("sign", torch.sgn)


def clip(x, min=None, max=None, name=None):
    lo = min.item() if isinstance(min, torch.Tensor) else min
    hi = max.item() if isinstance(max, torch.Tensor) else max
    (a,) = cast_in("<lambda>", as_t(x))
    a = float_scalar(a, lo, hi)
    return out(torch.clamp(a, lo, hi), x)


def _reduce(a, axis, keepdim, fn):
    """`fn(a, dims, keepdim)` over paddle's `axis` (None: every axis)."""
    dims = axes(axis, a.dim())
    if isinstance(dims, int):
        dims = (dims,)
    if not dims:
        return torch.clone(a)
    return fn(a, dims, keepdim)


def max(x, axis=None, keepdim=False, name=None):
    (a,) = cast_in("<lambda>", as_t(x))
    return out(_reduce(a, axis, keepdim, lambda t, d, k: torch.amax(t, d, k)),
               x)


def min(x, axis=None, keepdim=False, name=None):
    (a,) = cast_in("<lambda>", as_t(x))
    return out(_reduce(a, axis, keepdim, lambda t, d, k: torch.amin(t, d, k)),
               x)


amax = max
amin = min


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    """Integer and bool sums are int64, as in the JAX package."""
    dt = dtype_mod.convert_dtype(dtype)
    (a,) = cast_in("f", as_t(x))
    if dt is None and is_int_like(a):
        dt = torch.int64
    if axis is None and not keepdim:
        return out(torch.sum(a, dtype=dt), x)
    return out(_reduce(a if dt is None else a.to(dt), axis, keepdim,
                       lambda t, d, k: torch.sum(t, d, k)), x)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    (a,) = cast_in("<lambda>", as_t(x))
    if is_int_like(a):
        a = a.to(torch.int64)
        return out(_reduce(a, axis, keepdim,
                           lambda t, d, k: torch.sum(t, d, k)), x)
    return out(_reduce(a, axis, keepdim,
                       lambda t, d, k: torch.nansum(t, d, k)), x)


def mean(x, axis=None, keepdim=False, name=None):
    (a,) = cast_in("<lambda>", as_t(x))
    return out(_reduce(to_inexact(a), axis, keepdim,
                       lambda t, d, k: torch.mean(t, d, k)), x)


def nanmean(x, axis=None, keepdim=False, name=None):
    (a,) = cast_in("<lambda>", as_t(x))
    return out(_reduce(to_inexact(a), axis, keepdim,
                       lambda t, d, k: torch.nanmean(t, d, k)), x)


def _prod(t, dims, keepdim):
    for d in sorted((d % t.dim() for d in dims), reverse=True):
        t = torch.prod(t, d, keepdim)
    return t


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    (a,) = cast_in("<lambda>", as_t(x))
    if is_int_like(a):
        a = a.to(torch.int64)
    return out(_reduce(a, axis, keepdim, _prod), x)


def _scan_dtype(a):
    # the JAX package keeps an integer scan's dtype; bool scans in int64
    return torch.int64 if a.dtype == torch.bool else \
        (a.dtype if is_int_like(a) else None)


def cumsum(x, axis=None, dtype=None, name=None):
    (a,) = cast_in("f", as_t(x))
    if axis is None:
        a, axis = torch.reshape(a, (-1,)), 0
    return out(torch.cumsum(a, int(axis), dtype=_scan_dtype(a)), x)


def cumprod(x, dim=None, dtype=None, name=None):
    (a,) = cast_in("<lambda>", as_t(x))
    if dim is None:
        a, dim = torch.reshape(a, (-1,)), 0
    return out(torch.cumprod(a, int(dim), dtype=_scan_dtype(a)), x)


def logsumexp(x, axis=None, keepdim=False, name=None):
    (a,) = cast_in("<lambda>", as_t(x))
    return out(_reduce(to_inexact(a), axis, keepdim,
                       lambda t, d, k: torch.logsumexp(t, d, k)), x)


def logcumsumexp(x, axis=None, name=None):
    """The JAX package's formula: log(cumsum(exp(x - max))) + max, the
    max taken over the whole axis."""
    (a,) = cast_in("f", as_t(x))
    if axis is None:
        a, axis = torch.reshape(a, (-1,)), 0
    a = to_inexact(a)
    m = torch.amax(a, int(axis), keepdim=True)
    return out(torch.add(torch.log(torch.cumsum(torch.exp(torch.sub(a, m)),
                                                int(axis))), m), x)


def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        return inputs
    xs = cast_in("add_n", *inputs)
    acc = xs[0]
    for t in xs[1:]:
        acc = torch.add(acc, t)
    return out(acc, inputs)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    s = scale.item() if isinstance(scale, torch.Tensor) else scale
    (a,) = cast_in("f", as_t(x))
    a = float_scalar(a, s, bias)
    res = torch.add(torch.mul(a, s), bias) if bias_after_scale \
        else torch.mul(torch.add(a, bias), s)
    res = out(res, x)
    if act is not None:
        from ..nn import functional as F
        res = getattr(F, act)(res)
    return res


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    (a,) = cast_in("<lambda>", as_t(x))
    a = float_scalar(a, scale_a, scale_b)
    return out(torch.mul(torch.tanh(torch.mul(a, scale_a)), scale_b), x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    (a,) = cast_in("<lambda>", as_t(x))
    return out(torch.nan_to_num(a, nan=nan, posinf=posinf, neginf=neginf), x)


def inner(x, y, name=None):
    a, b = cast_in("<lambda>", *_pair(x, y))
    return out(_same(torch.inner)(a, b), x, y)


def outer(x, y, name=None):
    a, b = cast_in("<lambda>", *_pair(x, y))
    return out(_same(torch.outer)(torch.reshape(a, (-1,)),
                                  torch.reshape(b, (-1,))), x, y)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    (a,) = cast_in("<lambda>", as_t(x))
    d = torch.diagonal(a, offset, axis1, axis2)
    return out(torch.sum(d, -1, dtype=torch.int64 if is_int_like(d)
                         else None), x)


def increment(x, value=1.0, name=None):
    """x += value in place, outside autograd; returns x."""
    with torch.no_grad():
        torch.Tensor.add_(x, value)
    return x


def multiplex(inputs, index, name=None):
    idx, *xs = cast_in("multiplex", as_t(index), *inputs)
    stacked = torch.stack(xs, 0)
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return out(stacked[torch.reshape(idx, (-1,)).long(), rows], index, inputs)


def lerp(x, y, weight, name=None):
    if isinstance(weight, torch.Tensor):
        a, b, w = cast_in("<lambda>", as_t(x), as_t(y), weight)
    else:
        (a, b), w = cast_in("<lambda>", *_pair(x, y)), weight
    return out(torch.add(a, torch.mul(torch.sub(b, a), w)), x, y, weight)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    args = [as_t(x)] + [as_t(v) for v in (prepend, append) if v is not None]
    a, *rest = cast_in("diff", *args)
    pre = rest[0] if prepend is not None else None
    app = rest[-1] if append is not None else None
    return out(torch.diff(a, n, axis, pre, app), x, prepend, append)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    (a,) = cast_in("<lambda>", as_t(x))
    nz = torch.ne(a, 0).to(torch.int64)
    return out(_reduce(nz, axis, keepdim, lambda t, d, k: torch.sum(t, d, k)),
               x)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """beta * input + alpha * (x @ y)."""
    i, a, b = cast_in("addmm", as_t(input), as_t(x), as_t(y))
    return out(torch.add(torch.mul(i, beta),
                         torch.mul(torch.matmul(a, b), alpha)), input, x, y)


def all(x, axis=None, keepdim=False, name=None):
    (a,) = cast_in("all", as_t(x))
    return out(_reduce(a.bool(), axis, keepdim,
                       lambda t, d, k: torch.all(t, d, k)), x)


def any(x, axis=None, keepdim=False, name=None):
    (a,) = cast_in("any", as_t(x))
    return out(_reduce(a.bool(), axis, keepdim,
                       lambda t, d, k: torch.any(t, d, k)), x)


def tanh_(x, name=None):
    """In-place tanh."""
    from .manipulation import _inplace_from
    return _inplace_from(x, tanh(x))

