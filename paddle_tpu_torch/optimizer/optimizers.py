"""SGD, Momentum, Adam and AdamW (port of paddle_tpu's
`optimizer/optimizers.py`). The base class (`optimizer.py`) clips, casts
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
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW"]


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
        groups = {}
        for p, a, g in zip(ps, arrs, gs):
            st = self._state[id(p)]
            st["beta1_pow"] = st["beta1_pow"] * np.float32(b1)
            st["beta2_pow"] = st["beta2_pow"] * np.float32(b2)
            key = (float(st["beta1_pow"]), float(st["beta2_pow"]))
            groups.setdefault(key, []).append((a, g, st))
        for (b1p, b2p), members in groups.items():
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
