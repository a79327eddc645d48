"""Statistics ops (port of paddle_tpu's `ops/stat.py`).

Each op casts its inputs under AMP as "<lambda>", the JAX dispatcher's
name for them, and computes an integer input in `inexact` of its dtype
(int64 in float64, other ints in float32), as jnp does under x64.
`median` and `nanmedian` average the two middle values of an even count
(`jnp.median`; `torch.median` takes the lower one) and are computed from
a sort, so they take inputs of any size; `quantile` and `nanquantile` are
`torch.quantile` / `torch.nanquantile`, which refuse inputs of more than
2^24 elements. A list `q` puts the q axis first.
"""
from __future__ import annotations

import torch

from ._dispatch import as_t, axes, cast_in, out, to_inexact

__all__ = ["std", "var", "median", "nanmedian", "quantile", "nanquantile"]


def _dims(axis, ndim):
    d = axes(axis, ndim)
    return tuple(sorted(a % max(ndim, 1) for a in
                        ((d,) if isinstance(d, int) else d)))


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    (a,) = cast_in("<lambda>", as_t(x))
    a = to_inexact(a)
    return out(torch.var(a, _dims(axis, a.dim()),
                         correction=1 if unbiased else 0, keepdim=keepdim),
               x)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    (a,) = cast_in("<lambda>", as_t(x))
    a = to_inexact(a)
    return out(torch.std(a, _dims(axis, a.dim()),
                         correction=1 if unbiased else 0, keepdim=keepdim),
               x)


def _last(a, dims):
    """`a` with the axes `dims` moved to the end and flattened into one."""
    rest = [d for d in range(a.dim()) if d not in dims]
    t = torch.permute(a, rest + list(dims))
    return torch.reshape(t, tuple(t.shape[:len(rest)]) + (-1,))


def _keep(r, dims, ndim, lead=0):
    """A reduced result with size-1 axes put back at `dims` (after `lead`
    leading axes)."""
    for d in sorted(dims):
        r = torch.unsqueeze(r, lead + d)
    return r


def _median(x, axis, keepdim, skip_nan):
    (a,) = cast_in("<lambda>", as_t(x))
    a = to_inexact(a)
    dims = _dims(axis, a.dim())
    t = _last(a, dims)
    s = torch.sort(t, dim=-1).values             # NaNs last
    nan = torch.isnan(t)
    if skip_nan:
        n = torch.sum(torch.logical_not(nan), -1, keepdim=True)
    else:
        n = torch.full(t.shape[:-1] + (1,), t.shape[-1], device=t.device)
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"),
                     max=t.shape[-1] - 1)
    m = torch.mul(torch.add(torch.take_along_dim(s, lo, -1),
                            torch.take_along_dim(s, hi, -1)), 0.5)
    m = torch.squeeze(m, -1)
    bad = torch.eq(torch.squeeze(n, -1), 0) if skip_nan \
        else torch.any(nan, -1)
    m = torch.where(bad, torch.full_like(m, float("nan")), m)
    return out(_keep(m, dims, a.dim()) if keepdim else m, x)


def median(x, axis=None, keepdim=False, name=None):
    """The middle value, or the mean of the two middle ones for an even
    count; NaN where a NaN is in the reduced values."""
    return _median(x, axis, keepdim, skip_nan=False)


def nanmedian(x, axis=None, keepdim=False, name=None):
    """`median` of the non-NaN values (NaN where there are none)."""
    return _median(x, axis, keepdim, skip_nan=True)


def _quantile(tfn, x, q, axis, keepdim, interpolation):
    (a,) = cast_in("<lambda>", as_t(x))
    a = to_inexact(a)
    dims = _dims(axis, a.dim())
    if isinstance(q, torch.Tensor):
        q = q.tolist()
    multi = isinstance(q, (list, tuple))
    qt = torch.tensor(q, dtype=a.dtype, device=a.device) if multi \
        else float(q)
    r = tfn(_last(a, dims), qt, dim=-1, interpolation=interpolation)
    return out(_keep(r, dims, a.dim(), int(multi)) if keepdim else r, x)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    """The q-th quantiles along `axis` ("linear", "lower", "higher",
    "midpoint" or "nearest" between data points); `torch.quantile`, so at
    most 2^24 elements."""
    return _quantile(torch.quantile, x, q, axis, keepdim, interpolation)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    """`quantile` ignoring NaNs; `torch.nanquantile`, so at most 2^24
    elements."""
    return _quantile(torch.nanquantile, x, q, axis, keepdim, interpolation)
