"""Search, sort and index ops (port of paddle_tpu's `ops/search.py`).

Each op casts its inputs under AMP by the JAX dispatcher's name for it
("f" for `argmax`, `argmin`, `argsort`, `sort`; the op's own name for
`topk`, `where`, `index_sample`, `searchsorted`, `kthvalue`). Ties go as
in the JAX package: sorts are stable; `topk` and `kthvalue` take the
lowest index among equal values (`lax.top_k` and the stable argsort
there), which `torch.topk` / `torch.kthvalue` do not promise; `mode` is
the smallest of the most frequent values with its count
(`scipy.stats.mode` there). `nonzero`, `masked_select` and `mode` run on
the tensor's device, where the JAX package copies to the host.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtype_mod
from ._dispatch import as_t, cast_in, operands, out, promote

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "where", "nonzero",
    "masked_select", "index_sample", "searchsorted", "kthvalue", "mode",
]


def _arg(tfn):
    def op(x, axis=None, keepdim=False, dtype="int64", name=None):
        """With `axis=None`, over the flattened input (`keepdim`
        dropped)."""
        d = dtype_mod.convert_dtype(dtype)
        (a,) = cast_in("f", as_t(x))
        if a.dtype == torch.bool:
            a = a.to(torch.uint8)
        if axis is None:
            r = tfn(torch.reshape(a, (-1,)))
        else:
            r = tfn(a, int(axis), keepdim)
        return out(r.to(d), x)
    return op


argmax = _arg(torch.argmax)
argmin = _arg(torch.argmin)


def argsort(x, axis=-1, descending=False, name=None):
    (a,) = cast_in("f", as_t(x))
    return out(torch.argsort(a, dim=int(axis), descending=descending,
                             stable=True), x)


def sort(x, axis=-1, descending=False, name=None):
    (a,) = cast_in("f", as_t(x))
    return out(torch.sort(a, dim=int(axis), descending=descending,
                          stable=True).values, x)


def _top(t, k):
    """`lax.top_k` on the last axis: the k largest, sorted, ties to the
    lowest index (a stable descending sort)."""
    idx = torch.argsort(t, dim=-1, descending=True, stable=True)
    idx = torch.narrow(idx, -1, 0, k)
    return torch.take_along_dim(t, idx, -1), idx


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """The k largest (smallest with `largest=False`) along `axis` (the
    last by default) and their int64 indices, always sorted."""
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    (a,) = cast_in("topk", as_t(x))
    ax = -1 if axis is None else int(axis)
    moved = torch.movedim(a, ax, -1)
    if largest:
        vals, idx = _top(moved, k)
    else:
        vals, idx = _top(torch.neg(moved), k)
        vals = torch.neg(vals)
    return out((torch.movedim(vals, -1, ax), torch.movedim(idx, -1, ax)), x)


def _operand(v, like):
    return v if isinstance(v, (torch.Tensor, bool, int, float)) \
        else as_t(v, like)


def where(condition, x=None, y=None, name=None):
    """Elementwise `x` where `condition`, else `y`; with neither,
    `nonzero(condition, as_tuple=True)`."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    like = next((t for t in (condition, x, y)
                 if isinstance(t, torch.Tensor)), None)
    c, a, b = cast_in("where", as_t(condition, like), _operand(x, like),
                      _operand(y, like))
    return out(torch.where(c.bool(), a, b), condition, x, y)


def nonzero(x, as_tuple=False):
    """The indices of the nonzero entries in row-major order: [n, ndim]
    int64, or with `as_tuple` one [n, 1] tensor per axis."""
    a = as_t(x)
    idx = torch.nonzero(a)
    if as_tuple:
        return out(tuple(torch.clone(torch.narrow(idx, 1, i, 1))
                         for i in range(a.dim())), x)
    return out(idx, x)


def masked_select(x, mask, name=None):
    """The entries of `x` where `mask`, flattened in row-major order."""
    a = as_t(x)
    return out(torch.masked_select(a, as_t(mask, a).bool()), x, mask)


def index_sample(x, index, name=None):
    """out[i, j] = x[i, index[i, j]]."""
    a, idx = cast_in("index_sample", *operands(x, index))
    rows = torch.arange(a.shape[0], device=a.device)[:, None]
    return out(torch.Tensor.__getitem__(a, (rows, idx.long())), x, index)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    """Insertion points of `values` in `sorted_sequence` (1-D, or batched
    over equal leading dims), int64 or int32."""
    seq, v = promote(*cast_in("searchsorted",
                              *operands(sorted_sequence, values)))
    return out(torch.searchsorted(seq.contiguous(), v.contiguous(),
                                  right=right, out_int32=out_int32),
               sorted_sequence, values)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The k-th smallest along `axis` and its index, taken from a stable
    sort (the lowest index among equal values)."""
    (a,) = cast_in("kthvalue", as_t(x))
    ax = int(axis)
    s = torch.sort(a, dim=ax, stable=True)
    v = torch.select(s.values, ax, k - 1)
    i = torch.select(s.indices, ax, k - 1)
    if keepdim:
        v, i = torch.unsqueeze(v, ax), torch.unsqueeze(i, ax)
    return out((v, i), x)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along `axis` (the smallest among equally
    frequent ones) and how often it occurs (int64), as
    `scipy.stats.mode` gives them; not its index."""
    a = as_t(x)
    ax = int(axis)
    s = torch.sort(torch.movedim(a, ax, -1), dim=-1).values
    n = s.shape[-1]
    pos = torch.arange(n, device=s.device).expand(s.shape)
    change = torch.ne(torch.narrow(s, -1, 1, n - 1),
                      torch.narrow(s, -1, 0, n - 1))
    edge = torch.ones(s.shape[:-1] + (1,), dtype=torch.bool, device=s.device)
    first = torch.cat([edge, change], -1)     # a run starts here
    last = torch.cat([change, edge], -1)      # a run ends here
    start = torch.cummax(torch.where(first, pos, 0), -1).values
    end = torch.flip(torch.cummin(torch.flip(
        torch.where(last, pos, n - 1), [-1]), -1).values, [-1])
    count = torch.sub(end, start) + 1
    best = torch.argmax(count, -1, keepdim=True)   # the first: smallest
    m = torch.take_along_dim(s, best, -1)
    c = torch.take_along_dim(count, best, -1)
    if keepdim:
        m, c = torch.movedim(m, -1, ax), torch.movedim(c, -1, ax)
    else:
        m, c = torch.squeeze(m, -1), torch.squeeze(c, -1)
    return out((m, c), x)
