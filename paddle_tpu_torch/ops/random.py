"""Random ops (port of paddle_tpu's `ops/random.py`) on torch.Generators.

The ops draw on the default device (cuda unless `set_device` says
otherwise; the `*_like` ops and those of a tensor on its device) from
torch's own generators, which `paddle.seed` reseeds. `key=` takes a
`torch.Generator` on that device (a JAX key has no meaning here);
`uniform` / `uniform_` with `seed != 0` draw from a generator seeded with
it, so the same seed gives the same numbers on every call, as
`jax.random.key(seed)` does there. The numbers differ from the JAX
package's for the same seed; shapes, dtypes, supports and laws are the
same. Only `bernoulli`, `poisson` and `gaussian` dispatch (cast by AMP
under those names), as in the JAX package.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtype_mod
from ..core.place import to_torch_device
from ..core.tensor import wrap
from ._dispatch import as_t, cast_in, out
from .creation import _dt, _shape

__all__ = [
    "rand", "randn", "randint", "randint_like", "randperm", "uniform",
    "uniform_", "normal", "standard_normal", "gaussian", "bernoulli",
    "multinomial", "poisson", "exponential_",
]


def _gen(seed, key, device):
    """A generator seeded with `seed`, else `key` (None: torch's default
    generator of the device)."""
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return key


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None,
            key=None):
    """U[min, max) samples of `shape`."""
    dev = to_torch_device(None)
    t = torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
    return wrap(torch.Tensor.uniform_(t, min, max,
                                      generator=_gen(seed, key, dev)))


def rand(shape, dtype=None, name=None, key=None):
    return uniform(shape, dtype, 0.0, 1.0, key=key)


def randn(shape, dtype=None, name=None, key=None):
    return wrap(torch.randn(_shape(shape), generator=key, dtype=_dt(dtype),
                            device=to_torch_device(None)))


standard_normal = randn


def normal(mean=0.0, std=1.0, shape=None, name=None, key=None):
    """N(mean, std) samples in the default dtype: of `shape`, or of the
    broadcast shape of a Tensor `mean` / `std` (on its device); not
    differentiable."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        like = mean if isinstance(mean, torch.Tensor) else std
        m = torch.Tensor.detach(mean) if isinstance(mean, torch.Tensor) \
            else mean
        s = torch.Tensor.detach(std) if isinstance(std, torch.Tensor) \
            else std
        shp = torch.broadcast_shapes(tuple(getattr(m, "shape", ())),
                                     tuple(getattr(s, "shape", ())))
        z = torch.randn(shp, generator=key, device=like.device,
                        dtype=dtype_mod.get_default_dtype())
        return wrap(torch.add(torch.mul(z, s), m))
    z = torch.randn(_shape(shape), generator=key,
                    dtype=dtype_mod.get_default_dtype(),
                    device=to_torch_device(None))
    return wrap(torch.add(torch.mul(z, std), mean))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None,
            key=None):
    """Integers uniform in [low, high), or [0, low) without `high`."""
    if high is None:
        low, high = 0, low
    d = dtype_mod.convert_dtype(dtype) or torch.int64
    return wrap(torch.randint(low, high, _shape(shape), generator=key,
                              dtype=d, device=to_torch_device(None)))


def randint_like(x, low=0, high=None, dtype=None, name=None, key=None):
    """`randint` of `x`'s shape, on its device, in `dtype` (default:
    `x.dtype`)."""
    a = as_t(x)
    d = dtype_mod.convert_dtype(dtype) or a.dtype
    if high is None:
        low, high = 0, low
    r = torch.randint(low, high, tuple(a.shape), generator=key,
                      dtype=torch.int64, device=a.device)
    return wrap(r.to(d))


def randperm(n, dtype="int64", name=None, key=None):
    return wrap(torch.randperm(n, generator=key,
                               dtype=dtype_mod.convert_dtype(dtype),
                               device=to_torch_device(None)))


def bernoulli(x, name=None, key=None):
    """1 with probability x, else 0, in x's dtype."""
    (a,) = cast_in("bernoulli", as_t(x))
    return out(torch.bernoulli(torch.Tensor.detach(a), generator=key), x)


def multinomial(x, num_samples=1, replacement=False, name=None, key=None):
    """int64 category indices drawn from the rows of `x` (weights, not
    necessarily normalized) by the Gumbel-max trick over log(max(x,
    1e-30)): with replacement each sample an argmax, without the top
    `num_samples`. Never raises when `num_samples` exceeds the number of
    nonzero weights (then zero-weight categories fill the rest), as in
    the JAX package."""
    a = torch.Tensor.detach(as_t(x))
    logits = torch.log(torch.clamp(a, min=1e-30))

    def gumbel(shape):
        u = torch.rand(shape, generator=key, dtype=logits.dtype,
                       device=logits.device)
        tiny = torch.finfo(logits.dtype).tiny
        return torch.neg(torch.log(torch.neg(torch.log(
            torch.clamp(u, min=tiny)))))
    if replacement:
        shape = tuple(a.shape[:-1]) + (num_samples, a.shape[-1])
        z = torch.add(torch.unsqueeze(logits, -2), gumbel(shape))
        idx = torch.argmax(z, -1)
    else:
        idx = torch.topk(torch.add(logits, gumbel(tuple(a.shape))),
                         num_samples, -1).indices
    return wrap(idx.to(torch.int64))


def poisson(x, name=None, key=None):
    """Poisson(x) counts in x's dtype."""
    (a,) = cast_in("poisson", as_t(x))
    return out(torch.poisson(torch.Tensor.detach(a), generator=key), x)


def exponential_(x, lam=1.0, name=None, key=None):
    """Fills `x` in place (outside autograd) with Exp(1) / lam; returns
    `x`."""
    with torch.no_grad():
        torch.Tensor.exponential_(x, 1.0, generator=key)
        torch.Tensor.div_(x, lam)
    return x


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None, key=None):
    """Fills `x` in place (outside autograd) with U[min, max); returns
    `x`."""
    with torch.no_grad():
        torch.Tensor.uniform_(x, min, max,
                              generator=_gen(seed, key, x.device))
    return x


def gaussian(shape, mean=0.0, std=1.0, dtype=None, name=None, key=None):
    """N(mean, std) samples of `shape`: standard normals, then scaled,
    dispatched as "gaussian"."""
    z = standard_normal(shape, dtype=dtype, key=key)
    (a,) = cast_in("gaussian", z)
    return out(torch.add(torch.mul(a, std), mean), z)
