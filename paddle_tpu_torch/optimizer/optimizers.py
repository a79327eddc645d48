"""SGD, Momentum, Adam, AdamW, Lamb, Lars, RMSProp, Adagrad,
Adadelta and Adamax (port of paddle_tpu's `optimizer/optimizers.py`). The base class (`optimizer.py`) clips, casts
to the fp32 master and adds the decay term to the gradient first; each
`_apply` below is the JAX `apply_one`, run over `torch._foreach_*`.

SGD: ``p -= lr g``.

Momentum: the same update, in the parameter's type,

    v = momentum v + g          p -= lr (g + momentum v)  if use_nesterov
                                p -= lr v                 otherwise

with the velocity `v` a tensor of the parameter's dtype beside it (bf16
for a `.bfloat16()` model, as the JAX package's `zeros_like` gives; fp32
beside the fp32 master with `multi_precision`). Each op rounds to that
dtype where the JAX op does: `momentum v` and the sum with g are two
roundings; `p - lr update` is one, computed in fp32 (JAX multiplies the
bf16 update by its fp32 lr). Parameters and velocities are updated in
place, so a bf16 parameter stays bf16 (the JAX step returns the fp32
result of that last op as the new parameter, see ROADMAP.md queue 3).

Adam: the same update, in fp32,

    m = b1 m + (1 - b1) g          v = b2 v + (1 - b2) g g
    b1p *= b1                      b2p *= b2
    p -= lr (m / (1 - b1p)) / (sqrt(v / (1 - b2p)) + eps)

with a float `weight_decay` added to g first as coupled L2. The moments
are fp32 tensors beside each parameter; the beta powers are fp32 scalars
per parameter (numpy float32 on the host, so they round as the JAX
package's do and reading them never syncs the device); the betas
themselves are Python floats, which an fp32 op rounds to fp32 as JAX's
weak typing does. The update runs as `torch._foreach_*` ops over the
parameters that share their beta powers (all of them, in a run where
every parameter gets a gradient each step).

AdamW: Adam's update, then the decoupled decay ``p -= lr wd p_old`` on the
parameter from before the step, a second rounding as in the JAX
``new_p - lr * wd * p``. As in the JAX package, `apply_decay_param_fun`
and `lr_ratio` are accepted and not used: every parameter decays with the
same lr (ROADMAP.md queue 3 lists this JAX fault, reproduced so that
weights match).

Lamb: Adam's moments and beta powers, then the trust ratio,

    r = (m / (1 - b1p)) / (sqrt(v / (1 - b2p)) + eps) + lamb_wd p
    trust = |p| / |r| where both norms are > 0, else 1
    p -= (lr trust) r

with the norms per tensor (`torch._foreach_norm`) and the trust ratio a
device tensor (`torch.where`): nothing is read back, so a step makes no
host sync. The moments have the parameter's dtype (JAX's `zeros_like`).
On bf16 parameters without masters Lamb and Lars round as the JAX ops
do: each hyperparameter to bf16 (weak typing), each norm from bf16
squares summed in fp32 and rounded to bf16 (`jnp.linalg.norm`); the
parameters are grouped by dtype for that.
As in the JAX package, `exclude_from_weight_decay_fn` is stored and never
read: every tensor decays (ROADMAP.md queue 3, reproduced).

Lars: Momentum with a per-tensor local lr, on the device as Lamb's trust,

    local = coeff |p| / (|g| + lars_wd |p| + eps) where both > 0, else 1
    v = momentum v + (lr local) (g + lars_wd p)        p -= v

The JAX class takes `exclude_from_weight_decay` and never stores it, so
`lars_wd` applies to every tensor, biases and batch-norm weights too; the
port does the same (ROADMAP.md queue 3, reproduced). With
`multi_precision` the norms are of the fp32 masters.

RMSProp, Adagrad, Adadelta and Adamax are the JAX formulas in the JAX
order of operations. A float `weight_decay` is added to the gradient once,
by the base class (the JAX ``wd`` slot these four read). Like SGD,
Momentum and Adam they take each hyperparameter at fp32 (torch's scalar
rule), so on bf16 parameters without masters they can differ from the
JAX package by a few bf16 ulps.

    RMSProp   ms = rho ms + ((1 - rho) g) g
              centered: mg = rho mg + (1 - rho) g,
                        den = sqrt((ms - mg mg) + eps); else sqrt(ms + eps)
              mom = momentum mom + (lr g) / den        p -= mom
    Adagrad   acc += g g                  p -= (lr g) / (sqrt(acc) + eps)
    Adadelta  asg = rho asg + ((1 - rho) g) g
              u = (g sqrt(asu + eps)) / sqrt(asg + eps)
              asu = rho asu + ((1 - rho) u) u          p -= lr u
    Adamax    m = b1 m + (1 - b1) g       inf = max(b2 inf, |g| + eps)
              b1p *= b1                   p -= ((lr / (1 - b1p)) m) / inf
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Lamb", "Lars", "RMSProp",
           "Adagrad", "Adadelta", "Adamax"]


class SGD(Optimizer):
    def _apply(self, ps, arrs, gs, lr):
        torch._foreach_sub_(arrs, torch._foreach_mul(gs, lr))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)

    def _init_state(self, arr):
        return {"velocity": torch.zeros_like(arr)}

    def _apply(self, ps, arrs, gs, lr):
        vs = [self._state[id(p)]["velocity"] for p in ps]
        torch._foreach_mul_(vs, self._momentum)
        torch._foreach_add_(vs, gs)
        update = vs
        if self._nesterov:
            update = torch._foreach_add(gs, torch._foreach_mul(
                vs, self._momentum))
        torch._foreach_add_(arrs, update, alpha=-lr)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._eps = float(epsilon)

    def _init_state(self, arr):
        return {"moment1": torch.zeros_like(arr, dtype=torch.float32),
                "moment2": torch.zeros_like(arr, dtype=torch.float32),
                "beta1_pow": np.float32(1.0), "beta2_pow": np.float32(1.0)}

    def _apply(self, ps, arrs, gs, lr):
        b1, b2 = self._beta1, self._beta2
        for (b1p, b2p), members in _beta_groups(
                self, ps, arrs, gs, (b1, b2)).items():
            ps_ = [a for a, _, _ in members]
            ms = [st["moment1"] for _, _, st in members]
            vs = [st["moment2"] for _, _, st in members]
            gs_ = [g.float() for _, g, _ in members]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, torch._foreach_mul(gs_, 1 - b1))
            torch._foreach_mul_(vs, b2)
            torch._foreach_add_(vs, torch._foreach_mul(
                torch._foreach_mul(gs_, gs_), 1 - b2))
            c1 = float(np.float32(1) - np.float32(b1p))
            c2 = float(np.float32(1) - np.float32(b2p))
            num = torch._foreach_mul(torch._foreach_div(ms, c1), lr)
            den = torch._foreach_add(
                torch._foreach_sqrt(torch._foreach_div(vs, c2)), self._eps)
            decay = self._decay(ps_, lr)
            torch._foreach_sub_(ps_, torch._foreach_div(num, den))
            if decay is not None:
                torch._foreach_sub_(ps_, decay)

    def _decay(self, ps, lr):
        """AdamW's decoupled decay term of the parameters before the
        step (None for Adam)."""
        return None


class AdamW(Adam):
    """Decoupled weight decay (reference: python/paddle/optimizer/adamw.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        if not isinstance(weight_decay, (int, float)):
            raise TypeError(f"AdamW weight_decay must be a float, got "
                            f"{type(weight_decay)}")
        self._wd = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio
        self._decoupled_wd = float(weight_decay)

    def _decay(self, ps, lr):
        if not self._decoupled_wd:
            return None
        return torch._foreach_mul(ps, lr * self._decoupled_wd)


def _beta_groups(opt, ps, arrs, gs, betas):
    """Advance each parameter's beta powers (fp32 on the host, as the JAX
    package's) and group (arr, grad, state) by their values."""
    groups = {}
    for p, a, g in zip(ps, arrs, gs):
        st = opt._state[id(p)]
        for i, b in enumerate(betas, 1):
            st[f"beta{i}_pow"] = st[f"beta{i}_pow"] * np.float32(b)
        key = tuple(float(st[f"beta{i}_pow"])
                    for i in range(1, len(betas) + 1))
        groups.setdefault(key, []).append((a, g, st))
    return groups


def _weak(x, dtype):
    """A Python float as an op on `dtype` tensors sees it in the JAX
    package: rounded to that dtype (JAX's weak typing), so that bf16
    parameters update as there; fp32 rounding, which torch's fp32 ops
    apply anyway, otherwise. Computed on the host, from the bits."""
    f = np.float32(x)
    if dtype == torch.float16:
        return float(np.float16(f))
    if dtype != torch.bfloat16:
        return float(f)
    b = int(f.view(np.uint32))
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16    # nearest, ties even
    return float(np.uint32(b).view(np.float32))


def _norms(xs):
    """Per-tensor 2-norms, as one stacked device tensor. fp32 by
    `_foreach_norm`; a lower precision as `jnp.linalg.norm` takes it:
    squares rounded to the dtype, summed with fp32 accumulation, the sum
    and its root rounded to the dtype."""
    if xs[0].dtype == torch.float32:
        return torch.stack(torch._foreach_norm(xs))
    return torch.stack(torch._foreach_sqrt(torch._foreach_norm(
        torch._foreach_mul(xs, xs), 1)))


def _dtype_groups(*lists):
    """The zipped items of `lists`, grouped by the first list's dtype."""
    groups = {}
    for items in zip(*lists):
        groups.setdefault(items[0].dtype, []).append(items)
    return [[list(c) for c in zip(*g)] for g in groups.values()]


def _trust(num, den):
    """`num / den` where both per-tensor norms are > 0, else 1: device
    ops over every parameter at once, nothing read back."""
    return torch.where((num > 0) & (den > 0), num / den,
                       torch.ones_like(num))


class Lamb(Optimizer):
    """Layer-wise trust-ratio Adam (paddle's lamb_op)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._eps = float(epsilon)
        self._wd = float(lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, arr):
        return {"moment1": torch.zeros_like(arr),
                "moment2": torch.zeros_like(arr),
                "beta1_pow": np.float32(1.0), "beta2_pow": np.float32(1.0)}

    def _apply(self, ps, arrs, gs, lr):
        for (b1p, b2p), members in _beta_groups(
                self, ps, arrs, gs, (self._beta1, self._beta2)).items():
            for ps_, gs_, sts in _dtype_groups(*zip(*members)):
                self._apply_group(ps_, gs_, sts, b1p, b2p, lr)

    def _apply_group(self, ps_, gs_, sts, b1p, b2p, lr):
        w = functools.partial(_weak, dtype=ps_[0].dtype)
        b1, b2 = self._beta1, self._beta2
        ms = [st["moment1"] for st in sts]
        vs = [st["moment2"] for st in sts]
        torch._foreach_mul_(ms, w(b1))
        torch._foreach_add_(ms, torch._foreach_mul(gs_, w(1 - b1)))
        torch._foreach_mul_(vs, w(b2))
        torch._foreach_add_(vs, torch._foreach_mul(
            torch._foreach_mul(gs_, gs_), w(1 - b2)))
        c1 = w(np.float32(1) - np.float32(b1p))
        c2 = w(np.float32(1) - np.float32(b2p))
        r = torch._foreach_div(
            torch._foreach_div(ms, c1),
            torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_div(vs, c2)), w(self._eps)))
        torch._foreach_add_(r, torch._foreach_mul(ps_, w(self._wd)))
        scale = (_trust(_norms(ps_), _norms(r)) * w(lr)).unbind()
        torch._foreach_sub_(ps_, torch._foreach_mul(r, scale))


class Lars(Momentum):
    """Layer-wise adaptive-rate Momentum (paddle's lars_momentum_op)."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005, parameters=None,
                 grad_clip=None, exclude_from_weight_decay=None,
                 epsilon=1e-9, multi_precision=False, name=None):
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip, multi_precision, name)
        self._lars_coeff = float(lars_coeff)
        self._lars_wd = float(lars_weight_decay)
        self._lars_eps = float(epsilon)

    def _apply(self, ps, arrs, gs, lr):
        vs = [self._state[id(p)]["velocity"] for p in ps]
        for arrs_, gs_, vs_ in _dtype_groups(arrs, gs, vs):
            w = functools.partial(_weak, dtype=arrs_[0].dtype)
            wd = w(self._lars_wd)
            p_norm, g_norm = _norms(arrs_), _norms(gs_)
            local = torch.where(
                (p_norm > 0) & (g_norm > 0),
                w(self._lars_coeff) * p_norm
                / (g_norm + wd * p_norm + w(self._lars_eps)),
                torch.ones_like(p_norm))
            scale = (local * w(lr)).unbind()
            g_eff = torch._foreach_add(gs_, torch._foreach_mul(arrs_, wd))
            torch._foreach_mul_(vs_, w(self._momentum))
            torch._foreach_add_(vs_, torch._foreach_mul(g_eff, scale))
            torch._foreach_sub_(arrs_, vs_)


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = float(rho), float(epsilon)
        self._momentum, self._centered = float(momentum), bool(centered)

    def _init_state(self, arr):
        s = {"mean_square": torch.zeros_like(arr),
             "momentum": torch.zeros_like(arr)}
        if self._centered:
            s["mean_grad"] = torch.zeros_like(arr)
        return s

    def _apply(self, ps, arrs, gs, lr):
        rho = self._rho
        sts = [self._state[id(p)] for p in ps]
        ms = [st["mean_square"] for st in sts]
        torch._foreach_mul_(ms, rho)
        torch._foreach_add_(ms, torch._foreach_mul(
            torch._foreach_mul(gs, 1 - rho), gs))
        if self._centered:
            mg = [st["mean_grad"] for st in sts]
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, torch._foreach_mul(gs, 1 - rho))
            den = torch._foreach_sqrt(torch._foreach_add(
                torch._foreach_sub(ms, torch._foreach_mul(mg, mg)),
                self._eps))
        else:
            den = torch._foreach_sqrt(torch._foreach_add(ms, self._eps))
        mom = [st["momentum"] for st in sts]
        torch._foreach_mul_(mom, self._momentum)
        torch._foreach_add_(mom, torch._foreach_div(
            torch._foreach_mul(gs, lr), den))
        torch._foreach_sub_(arrs, mom)


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = float(epsilon)
        self._init_acc = float(initial_accumulator_value)

    def _init_state(self, arr):
        return {"moment": torch.full_like(arr, self._init_acc)}

    def _apply(self, ps, arrs, gs, lr):
        acc = [self._state[id(p)]["moment"] for p in ps]
        torch._foreach_add_(acc, torch._foreach_mul(gs, gs))
        torch._foreach_sub_(arrs, torch._foreach_div(
            torch._foreach_mul(gs, lr),
            torch._foreach_add(torch._foreach_sqrt(acc), self._eps)))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = float(epsilon), float(rho)

    def _init_state(self, arr):
        return {"avg_squared_grad": torch.zeros_like(arr),
                "avg_squared_update": torch.zeros_like(arr)}

    def _apply(self, ps, arrs, gs, lr):
        rho, eps = self._rho, self._eps
        sts = [self._state[id(p)] for p in ps]
        asg = [st["avg_squared_grad"] for st in sts]
        asu = [st["avg_squared_update"] for st in sts]
        torch._foreach_mul_(asg, rho)
        torch._foreach_add_(asg, torch._foreach_mul(
            torch._foreach_mul(gs, 1 - rho), gs))
        upd = torch._foreach_div(
            torch._foreach_mul(gs, torch._foreach_sqrt(
                torch._foreach_add(asu, eps))),
            torch._foreach_sqrt(torch._foreach_add(asg, eps)))
        torch._foreach_mul_(asu, rho)
        torch._foreach_add_(asu, torch._foreach_mul(
            torch._foreach_mul(upd, 1 - rho), upd))
        torch._foreach_sub_(arrs, torch._foreach_mul(upd, lr))


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._eps = float(epsilon)

    def _init_state(self, arr):
        return {"moment": torch.zeros_like(arr),
                "inf_norm": torch.zeros_like(arr),
                "beta1_pow": np.float32(1.0)}

    def _apply(self, ps, arrs, gs, lr):
        b1, b2 = self._beta1, self._beta2
        for (b1p,), members in _beta_groups(self, ps, arrs, gs,
                                            (b1,)).items():
            ps_ = [a for a, _, _ in members]
            gs_ = [g for _, g, _ in members]
            ms = [st["moment"] for _, _, st in members]
            us = [st["inf_norm"] for _, _, st in members]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, torch._foreach_mul(gs_, 1 - b1))
            torch._foreach_mul_(us, b2)
            torch._foreach_maximum_(us, torch._foreach_add(
                torch._foreach_abs(gs_), self._eps))
            step = float(np.float32(lr) / (np.float32(1) - np.float32(b1p)))
            torch._foreach_sub_(ps_, torch._foreach_div(
                torch._foreach_mul(ms, step), us))
