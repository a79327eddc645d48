"""Optimizer base (port of paddle_tpu's `optimizer/optimizer.py`): holds
the parameter list and the learning rate, and updates every parameter
that has a gradient, in place, under `torch.no_grad`."""
from __future__ import annotations

import torch

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported to "
                "paddle_tpu_torch; pass a float learning_rate")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported to "
                                      "paddle_tpu_torch")
        if weight_decay is not None:
            raise NotImplementedError("weight_decay is not ported to "
                                      "paddle_tpu_torch")
        self._learning_rate = float(learning_rate)
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._state = {}                 # id(param) -> per-param state

    def get_lr(self) -> float:
        return self._learning_rate

    def state(self, p):
        """The optimizer's state of parameter `p` (Adam's moments and beta
        powers, Momentum's velocity)."""
        return self._state[id(p)]

    def _params_with_grads(self):
        if self._parameter_list is None:
            raise ValueError("Optimizer created without a parameter list; "
                             "pass parameters=model.parameters()")
        return [p for p in self._parameter_list
                if p.grad is not None and p.requires_grad]

    @torch.no_grad()
    def step(self):
        self._update(self.get_lr())

    def _update(self, lr):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list or ():
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None
