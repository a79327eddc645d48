"""Linear-algebra ops (port of paddle_tpu's `ops/linalg.py`).

Each op casts its inputs under AMP by the JAX dispatcher's name for it:
"matmul" for `matmul`, `mm` and `bmm` (a white-listed name), "norm" for
`norm` (black-listed), the op's own name for `dot`, `dist`, `svd`, `qr`,
`eigh`, `triangular_solve`, `cholesky_solve`, `cross`, `lu`, `lstsq`,
`multi_dot` and a weighted `bincount`, the jnp function's for `inv`,
`det` and `solve`, "f" for `cholesky` and `slogdet`, and "<lambda>" for
the rest that dispatch. fp32 products run at the card's fp32 (TF32 only
where `torch.backends.cuda.matmul.allow_tf32` says so, off by default).

Where the JAX package computes on the host (`eig`, `eigvals`,
`histogram`), the port computes on the tensor's device. Behaviours kept
from the JAX package: `eigh` reads the lower triangle whatever `UPLO`
says, `eigvalsh` symmetrizes; `cov` ignores `fweights` and `aweights`;
`lstsq` returns (solution, squared residual norms, rank, singular values)
from an SVD, rank-deficient inputs and the card included; `lu` gives
1-based int32 pivots; `histogram` gives int64 counts.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtype_mod
from ..core.tensor import wrap
from ._dispatch import (as_t, cast_in, is_int_like, operands, out, promote,
                        to_inexact)

__all__ = [
    "matmul", "mm", "bmm", "dot", "t", "norm", "dist", "cholesky", "inv",
    "inverse", "det", "slogdet", "svd", "qr", "eig", "eigh", "eigvals",
    "eigvalsh", "solve", "triangular_solve", "cholesky_solve",
    "matrix_power", "pinv", "cross", "histogram", "bincount", "mv",
    "matrix_rank", "lu", "lstsq", "multi_dot", "cov", "corrcoef", "rank",
]


def _mm(a, b):
    """jnp.matmul: operands promoted to one dtype; an integer product
    (which cuBLAS does not take) summed from elementwise products."""
    a, b = promote(a, b)
    if dtype_mod.is_inexact(a.dtype):
        return torch.matmul(a, b)
    va, vb = a.dim() == 1, b.dim() == 1
    a = torch.unsqueeze(a, 0) if va else a
    b = torch.unsqueeze(b, 1) if vb else b
    r = torch.sum(torch.mul(torch.unsqueeze(a, -1), torch.unsqueeze(b, -3)),
                  -2)
    r = torch.squeeze(r, -2) if va else r
    return torch.squeeze(r, -1) if vb else r


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """x @ y; `transpose_x` / `transpose_y` swap the last two axes of an
    operand of two or more axes (a vector stays)."""
    a, b = cast_in("matmul", *operands(x, y))
    if transpose_x and a.dim() > 1:
        a = torch.swapaxes(a, -1, -2)
    if transpose_y and b.dim() > 1:
        b = torch.swapaxes(b, -1, -2)
    return out(_mm(a, b), x, y)


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return matmul(x, y)


def mv(x, vec, name=None):
    a, b = cast_in("<lambda>", *operands(x, vec))
    return out(_mm(a, b), x, vec)


def dot(x, y, name=None):
    """sum(x * y, -1): row by row for 2-D inputs; integer sums in int64."""
    a, b = cast_in("dot", *operands(x, y))
    p = torch.mul(a, b)
    return out(torch.sum(p, -1, dtype=torch.int64 if is_int_like(p)
                         else None), x, y)


def t(input, name=None):
    """`input.T`: every axis reversed (a 2-D transpose; 0-d and 1-D as
    they are)."""
    (a,) = cast_in("<lambda>", as_t(input))
    return out(torch.permute(a, tuple(range(a.dim() - 1, -1, -1))), input)


def _p(p):
    if p == "inf":
        return float("inf")
    if p == "-inf":
        return float("-inf")
    return p


def _pnorm(a, p, dims, keepdim):
    """The entrywise p-norm over `dims` (None: all), the JAX package's
    formulas: a count of nonzeros for p=0, max / min |a| for +-inf."""
    if p == 0:
        return torch.sum(torch.ne(a, 0).to(a.dtype), dims, keepdim)
    if p == float("inf"):
        return torch.amax(torch.abs(a), dims, keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(a), dims, keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(a), p), dims, keepdim),
                     1.0 / p)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """The JAX package's branches: "fro" over every axis or a list of
    axes; "nuc" (the singular values' sum over the last two axes); with
    `axis=None` the vector p-norm of the flattened input (keepdim gives
    shape [1]); a list of two axes a matrix norm, of one a vector norm;
    an int axis: p=0 counts nonzeros, +-inf the max / min of |x|, else
    (sum |x|^p)^(1/p) ("fro" there is p=2)."""
    (a,) = cast_in("norm", as_t(x))
    if p == "fro" and (axis is None or isinstance(axis, (list, tuple))):
        dims = tuple(range(a.dim())) if axis is None else tuple(axis)
        return out(torch.sqrt(torch.sum(torch.mul(a, a), dims, keepdim)), x)
    if p == "nuc":
        return out(torch.sum(torch.linalg.svdvals(a), -1), x)
    pp = _p(p)
    if axis is None:
        flat = torch.reshape(a, (-1,))
        return out(torch.linalg.vector_norm(flat, ord=pp, keepdim=keepdim),
                   x)
    if isinstance(axis, (list, tuple)):
        dims = tuple(int(d) for d in axis)
        fn = torch.linalg.matrix_norm if len(dims) == 2 else \
            torch.linalg.vector_norm
        return out(fn(a, ord=pp, dim=dims, keepdim=keepdim), x)
    if pp == "fro":
        pp = 2
    return out(_pnorm(a, pp, int(axis), keepdim), x)


def dist(x, y, p=2, name=None):
    """The p-norm of x - y, flattened (p=0 a count, +-inf max / min)."""
    a, b = cast_in("dist", *operands(x, y))
    d = torch.reshape(torch.sub(a, b), (-1,))
    return out(_pnorm(d, p, 0, False), x, y)


def cholesky(x, upper=False, name=None):
    (a,) = cast_in("f", as_t(x))
    return out(torch.linalg.cholesky(a, upper=upper), x)


def inv(x, name=None):
    (a,) = cast_in("inv", as_t(x))
    return out(torch.linalg.inv(a), x)


inverse = inv    # reference alias (tensor/linalg.py inverse)


def det(x, name=None):
    (a,) = cast_in("det", as_t(x))
    return out(torch.linalg.det(a), x)


def slogdet(x, name=None):
    """[sign, log|det|] stacked on a new axis 0."""
    (a,) = cast_in("f", as_t(x))
    sign, logdet = torch.linalg.slogdet(a)
    return out(torch.stack([sign, logdet], 0), x)


def svd(x, full_matrices=False, name=None):
    """(U, S, Vh) with x = U diag(S) Vh; the vectors are defined up to
    sign."""
    (a,) = cast_in("svd", as_t(x))
    u, s, vh = torch.linalg.svd(a, full_matrices=full_matrices)
    return out((u, s, vh), x)


def qr(x, mode="reduced", name=None):
    """(Q, R), or R alone with mode="r"."""
    (a,) = cast_in("qr", as_t(x))
    q, r = torch.linalg.qr(a, mode=mode)
    return out(r if mode == "r" else (q, r), x)


def _real_if_real(w, v=None):
    """numpy's `eig` rule: real outputs when no eigenvalue has an
    imaginary part (one read of a flag from the device)."""
    if bool(torch.any(torch.ne(torch.imag(w), 0))):
        return w, v
    return torch.clone(torch.real(w)), None if v is None else \
        torch.clone(torch.real(v))


def eig(x, name=None):
    """Eigenvalues and right eigenvectors of a general matrix: complex,
    or real when every eigenvalue is (numpy's rule, as in the JAX
    package); the vectors are defined up to a phase."""
    a = as_t(x)
    w, v = torch.linalg.eig(a)
    return out(_real_if_real(w, v), x)


def eigvals(x, name=None):
    a = as_t(x)
    return out(_real_if_real(torch.linalg.eigvals(a))[0], x)


def eigh(x, UPLO="L", name=None):
    """(eigenvalues ascending, eigenvectors) of a symmetric matrix, read
    from its lower triangle whatever `UPLO` says, as in the JAX
    package."""
    (a,) = cast_in("eigh", as_t(x))
    w, v = torch.linalg.eigh(a, UPLO="L")
    return out((w, v), x)


def eigvalsh(x, UPLO="L", name=None):
    """The eigenvalues of (x + x^H) / 2, ascending."""
    (a,) = cast_in("<lambda>", as_t(x))
    sym = torch.mul(torch.add(a, torch.conj(torch.swapaxes(a, -1, -2))),
                    0.5)
    return out(torch.linalg.eigvalsh(sym), x)


def solve(x, y, name=None):
    a, b = cast_in("solve", *operands(x, y))
    return out(torch.linalg.solve(*promote(a, b)), x, y)


def _as_matrix(b):
    return (torch.unsqueeze(b, -1), True) if b.dim() == 1 else (b, False)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """X with x X = y (x^T X = y with `transpose`), x triangular."""
    a, b = cast_in("triangular_solve", *operands(x, y))
    a, b = promote(a, b)
    b, vec = _as_matrix(b)
    if transpose:
        a, upper = torch.swapaxes(a, -1, -2), not upper
    r = torch.linalg.solve_triangular(a, b, upper=upper,
                                      unitriangular=unitriangular)
    return out(torch.squeeze(r, -1) if vec else r, x, y)


def cholesky_solve(x, y, upper=False, name=None):
    """X with A X = x, where `y` is A's Cholesky factor (lower, or upper
    with `upper`): two triangular solves reading that triangle only, as
    `cho_solve` does."""
    b, f = cast_in("cholesky_solve", *operands(x, y))
    b, f = promote(b, f)
    b, vec = _as_matrix(b)
    lo = torch.swapaxes(f, -1, -2) if upper else f
    z = torch.linalg.solve_triangular(lo, b, upper=False)
    r = torch.linalg.solve_triangular(torch.swapaxes(lo, -1, -2), z,
                                      upper=True)
    return out(torch.squeeze(r, -1) if vec else r, x, y)


def matrix_power(x, n, name=None):
    """x^n; a negative n powers the inverse."""
    (a,) = cast_in("<lambda>", as_t(x))
    return out(torch.linalg.matrix_power(a, n), x)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    """The pseudo-inverse; singular values below `rcond` times the
    largest are dropped."""
    (a,) = cast_in("<lambda>", as_t(x))
    return out(torch.linalg.pinv(a, rtol=rcond, hermitian=hermitian), x)


def cross(x, y, axis=9, name=None):
    """The cross product along `axis`; the default 9 means the first axis
    of size 3."""
    a, b = cast_in("cross", *operands(x, y))
    a, b = promote(a, b)
    ax = axis
    if ax == 9:
        ax = next(i for i, s in enumerate(a.shape) if s == 3)
    a, b = torch.broadcast_tensors(a, b)
    return out(torch.linalg.cross(a, b, dim=ax), x, y)


def histogram(input, bins=100, min=0, max=0, name=None):
    """int64 counts of `input` in `bins` equal bins over [min, max] (the
    last bin closed), numpy's binning; min == max == 0 takes the data's
    range, and a range of zero width is widened by 0.5 on each side."""
    a = torch.reshape(as_t(input), (-1,))
    # numpy bins in the data's float dtype, integers in float64
    a = a if a.is_floating_point() else a.to(torch.float64)
    if min != 0 or max != 0:
        lo = torch.tensor(float(min), dtype=a.dtype, device=a.device)
        hi = torch.tensor(float(max), dtype=a.dtype, device=a.device)
    else:
        lo, hi = torch.amin(a), torch.amax(a)
    flat = torch.eq(lo, hi)
    lo = torch.where(flat, lo - 0.5, lo)
    hi = torch.where(flat, hi + 0.5, hi)
    # numpy.histogram's uniform bins: edges lo + i * step (the last hi),
    # an index from the scaled value, then corrected against the edges
    edges = torch.add(torch.mul(torch.arange(
        bins + 1, dtype=a.dtype, device=a.device),
        torch.div(torch.sub(hi, lo), bins)), lo)
    edges[-1] = hi
    keep = torch.logical_and(torch.ge(a, lo), torch.le(a, hi))
    idx = torch.mul(torch.div(torch.sub(a, lo), torch.sub(hi, lo)),
                    bins).long()
    idx = torch.clamp(idx, 0, bins - 1)
    idx = torch.where(torch.lt(a, edges[idx]), idx - 1, idx)
    idx = torch.where(torch.logical_and(torch.ge(a, edges[idx + 1]),
                                        torch.ne(idx, bins - 1)),
                      idx + 1, idx)
    counts = torch.zeros(bins, dtype=torch.int64, device=a.device)
    counts.index_add_(0, torch.clamp(idx, 0, bins - 1), keep.long())
    return out(counts, input)


def bincount(x, weights=None, minlength=0, name=None):
    """Counts (or summed `weights`) of each value of a non-negative int
    tensor, of length max(minlength, max(x) + 1)."""
    if weights is None:
        (a,) = cast_in("<lambda>", as_t(x))
        n = max(minlength, int(torch.amax(a)) + 1)
        return out(torch.bincount(a, minlength=n), x)
    a, w = cast_in("bincount", as_t(x), as_t(weights, as_t(x)))
    n = max(minlength, int(torch.amax(a)) + 1)
    r = torch.zeros(n, dtype=w.dtype, device=w.device)
    return out(r.index_add_(0, a.long(), w), x, weights)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """The count of singular values above `tol` (absolute), or above
    S.max * max(M, N) * eps with `tol=None` (int64)."""
    (a,) = cast_in("<lambda>", as_t(x))
    a = to_inexact(a)
    if a.dim() < 2:
        return out(torch.any(torch.ne(a, 0)).to(torch.int32), x)
    s = torch.linalg.svdvals(a)
    if tol is None:
        cut = torch.amax(s, -1) * max(a.shape[-2:]) * \
            torch.finfo(s.dtype).eps
    else:
        cut = torch.as_tensor(tol, dtype=s.dtype, device=s.device)
    return out(torch.sum(torch.gt(s, torch.unsqueeze(cut, -1)), -1), x)


def lu(x, pivot=True, get_infos=False, name=None):
    """(LU, 1-based int32 pivots) of a partial-pivoting LU; with
    `get_infos` also int32 zeros([1])."""
    (a,) = cast_in("lu", as_t(x))
    lu_mat, piv = torch.linalg.lu_factor(a)
    piv = piv.to(torch.int32)
    if get_infos:
        return out((lu_mat, piv, torch.zeros(1, dtype=torch.int32,
                                              device=a.device)), x)
    return out((lu_mat, piv), x)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, squared residual norms, rank, singular values) of min
    |x X - y| from x's SVD, jnp.linalg.lstsq's algorithm: singular values
    below rcond * the largest (rcond defaults to eps * max(M, N)) are
    dropped, residuals always computed."""
    a, b = cast_in("lstsq", *operands(x, y))
    a, b = promote(to_inexact(a), b)
    vec = b.dim() == 1
    if vec:
        b = torch.unsqueeze(b, 1)
    m, n = a.shape
    eps = torch.finfo(a.dtype).eps
    rc = eps * max(m, n) if rcond is None else \
        (eps if rcond < 0 else rcond)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    mask = torch.logical_and(torch.gt(s, 0), torch.ge(s, rc * s[0]))
    rk = torch.sum(mask)
    s_inv = torch.where(mask, torch.reciprocal(torch.where(
        mask, s, torch.ones_like(s))), torch.zeros_like(s))
    sol = torch.matmul(torch.conj(vh).mT,
                       torch.mul(s_inv[:, None],
                                 torch.matmul(torch.conj(u).mT, b)))
    resid = torch.pow(torch.linalg.vector_norm(
        torch.sub(b, torch.matmul(a, sol)), dim=0), 2)
    if vec:
        sol = torch.reshape(sol, (-1,))
    return out((sol, resid, rk, s), x, y)


def multi_dot(x, name=None):
    xs = cast_in("multi_dot", *[as_t(v) for v in x])
    return out(torch.linalg.multi_dot(list(xs)), x)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    """The covariance of the variables (rows, or columns with
    `rowvar=False`); `fweights` and `aweights` are ignored, as in the JAX
    package."""
    (a,) = cast_in("<lambda>", as_t(x))
    a = to_inexact(a)
    if not rowvar and a.dim() == 2:
        a = a.mT
    return out(torch.cov(a, correction=1 if ddof else 0), x)


def corrcoef(x, rowvar=True, name=None):
    (a,) = cast_in("<lambda>", as_t(x))
    a = to_inexact(a)
    if not rowvar and a.dim() == 2:
        a = a.mT
    return out(torch.corrcoef(a), x)


def rank(input, name=None):
    """The number of axes, as a 0-d int32 `Tensor`."""
    a = as_t(input)
    return wrap(torch.tensor(a.dim(), dtype=torch.int32, device=a.device))
