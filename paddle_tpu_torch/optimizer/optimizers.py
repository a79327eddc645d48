"""Momentum and Adam (port of paddle_tpu's `optimizer/optimizers.py`).

Momentum: the same update, in the parameter's type,

    v = momentum v + g          p -= lr (g + momentum v)  if use_nesterov
                                p -= lr v                 otherwise

with the velocity `v` a tensor of the parameter's dtype beside it (bf16
for a `.bfloat16()` model, as the JAX package's `zeros_like` gives). Each
op rounds to that dtype where the JAX op does: `momentum v` and the sum
with g are two roundings; `p - lr update` is one, computed in fp32 (JAX
multiplies the bf16 update by its fp32 lr). Parameters and velocities are
updated in place with `torch._foreach_*`, so a bf16 parameter stays bf16
(the JAX step returns the fp32 result of that last op as the new
parameter, see ROADMAP.md queue 3).

Adam: the same update, in fp32,

    m = b1 m + (1 - b1) g          v = b2 v + (1 - b2) g g
    b1p *= b1                      b2p *= b2
    p -= lr (m / (1 - b1p)) / (sqrt(v / (1 - b2p)) + eps)

(weight decay is not ported and raises). The moments are fp32
tensors beside each parameter; the beta powers are fp32 scalars per
parameter (numpy float32, so they round as the JAX package's do); the
betas themselves are Python floats, which an fp32 op rounds to fp32 as
JAX's weak typing does. The
update runs as `torch._foreach_*` ops over the parameters that share their
beta powers (all of them, in a run where every parameter gets a gradient
each step).
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["Momentum", "Adam"]


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        if multi_precision:
            raise NotImplementedError("Momentum(multi_precision=True) is "
                                      "not ported to paddle_tpu_torch")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)

    def _update(self, lr):
        ps = self._params_with_grads()
        for p in ps:
            if id(p) not in self._state:
                self._state[id(p)] = {"velocity": torch.zeros_like(p)}
        vs = [self._state[id(p)]["velocity"] for p in ps]
        gs = [p.grad.to(p.dtype) for p in ps]
        torch._foreach_mul_(vs, self._momentum)
        torch._foreach_add_(vs, gs)
        update = vs
        if self._nesterov:
            update = torch._foreach_add(gs, torch._foreach_mul(
                vs, self._momentum))
        torch._foreach_add_(ps, update, alpha=-lr)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._eps = float(epsilon)

    def _slot(self, p):
        st = self._state.get(id(p))
        if st is None:
            st = self._state[id(p)] = {
                "moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32),
                "beta1_pow": np.float32(1.0), "beta2_pow": np.float32(1.0)}
        return st

    def _update(self, lr):
        b1, b2 = self._beta1, self._beta2
        groups = {}
        for p in self._params_with_grads():
            st = self._slot(p)
            st["beta1_pow"] = st["beta1_pow"] * np.float32(b1)
            st["beta2_pow"] = st["beta2_pow"] * np.float32(b2)
            key = (float(st["beta1_pow"]), float(st["beta2_pow"]))
            groups.setdefault(key, []).append((p, st))
        for (b1p, b2p), members in groups.items():
            ps = [p for p, _ in members]
            ms = [st["moment1"] for _, st in members]
            vs = [st["moment2"] for _, st in members]
            gs = [p.grad.float() for p in ps]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b1))
            torch._foreach_mul_(vs, b2)
            torch._foreach_add_(vs, torch._foreach_mul(
                torch._foreach_mul(gs, gs), 1 - b2))
            c1 = float(np.float32(1) - np.float32(b1p))
            c2 = float(np.float32(1) - np.float32(b2p))
            num = torch._foreach_mul(torch._foreach_div(ms, c1), lr)
            den = torch._foreach_add(
                torch._foreach_sqrt(torch._foreach_div(vs, c2)), self._eps)
            torch._foreach_sub_(ps, torch._foreach_div(num, den))
