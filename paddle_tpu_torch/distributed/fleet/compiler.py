"""The single-device train step (port of the single-device branch of
paddle_tpu's `distributed/fleet/compiler.py` `compile_train_step`).

`compile_train_step(layer, optimizer, strategy, loss_method="loss")` takes
the JAX package's call, so code written against it (benchmarks/run.py's
config 5: `compile_train_step`, `prog._put_data(ids)`, `prog.step(ids,
ids)`) runs unchanged. `CompiledTrainStep.step(*data, lr=)` runs
`getattr(layer, loss_method)(*data)` (the layer itself when `loss_method`
is empty) under `amp.auto_cast(level="O2" if use_pure_bf16 else "O1",
dtype="bfloat16")` when `strategy.amp` is set, backpropagates, and
applies the optimizer: eagerly, with no `torch.compile`, no CUDA graph and
no mesh. With `strategy.recompute`, a layer that has
`enable_block_recompute` (GPT) runs each block under
`fleet.utils.recompute` with `recompute_configs.policy`; the flag is set
around the forward only and restored after it, so it never leaks into
eager use of the layer. Any other layer's whole forward is recomputed.
Parameters are updated in place and stay the layer's own tensors (the JAX
step donates copies and writes back later; here there is nothing to write
back).

The optimizer's `_update(lr)` applies its gradient clip, regularizers and
weight decay, as the eager `step()` does; `lr` is the scheduler's value,
read on the host. With `accumulate_steps = n > 1` (hapi's
`accumulate_grad_batches`) each call adds its batch's gradients to the
parameters' `.grad` and every n-th call divides them by n and applies
the optimizer: the JAX hapi `grad_step` / `apply_step` pair, the same sum
in the same order. `gradient_merge` as a strategy toggle is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import amp as amp_mod
from ...core.device import get_device
from .strategy import DistributedStrategy
from .utils import recompute

__all__ = ["CompiledTrainStep", "compile_train_step"]


class CompiledTrainStep:
    def __init__(self, layer, optimizer, strategy: DistributedStrategy,
                 loss_method, device: torch.device):
        self.layer = layer
        self.device = device
        self._opt = optimizer
        self.accumulate_steps = 1       # hapi's accumulate_grad_batches
        self._micro = 0                 # batches accumulated so far
        self._loss = getattr(layer, loss_method) if loss_method else layer
        self._amp = bool(strategy.amp)
        self._level = "O2" if strategy.amp_configs.use_pure_bf16 else "O1"
        self._recompute = bool(strategy.recompute)
        self._policy = strategy.recompute_configs.policy

    def _put_data(self, d):
        """One batch item as a tensor on the step's device."""
        if isinstance(d, torch.Tensor):
            return d.to(self.device, non_blocking=True)
        return torch.from_numpy(np.ascontiguousarray(d)).to(
            self.device, non_blocking=True)

    def _forward_loss(self, *data):
        with amp_mod.auto_cast(enable=self._amp, level=self._level,
                               dtype="bfloat16"):
            return self._loss(*data)

    def _run(self, *data):
        if not self._recompute:
            return self._forward_loss(*data)
        layer = self.layer
        if not hasattr(layer, "enable_block_recompute"):
            return recompute(self._forward_loss, *data,
                             checkpoint_policy=self._policy)
        prev = (getattr(layer, "_recompute_blocks", False),
                getattr(layer, "_recompute_policy", None))
        layer.enable_block_recompute(True, policy=self._policy)
        try:
            return self._forward_loss(*data)
        finally:
            layer._recompute_blocks, layer._recompute_policy = prev

    def step(self, *data, lr=None):
        """One batch: forward, backward and, on the last batch of an
        accumulation (every batch by default), the optimizer update.
        Returns the loss, left on the device."""
        data = [self._put_data(d) for d in data]
        self.layer.train()
        if self._micro == 0:
            self._opt.clear_grad()
        loss = self._run(*data)
        loss.backward()
        self._micro += 1
        if self._micro >= self.accumulate_steps:
            self._micro = 0
            with torch.no_grad():
                if self.accumulate_steps > 1:
                    torch._foreach_div_(
                        [g for g in (p.grad for p in
                                     self._opt._parameter_list or ())
                         if g is not None], float(self.accumulate_steps))
                self._opt._update(self._opt.get_lr() if lr is None else lr)
        return loss.detach()


def _layer_device(layer):
    """The device of the layer's parameters, else the default device."""
    params = getattr(layer, "parameters", None)
    first = next(iter(params()), None) if callable(params) else None
    return first.device if first is not None else get_device()


def compile_train_step(layer, optimizer, strategy: DistributedStrategy,
                       loss_method: str = "loss", mesh=None,
                       device=None) -> CompiledTrainStep:
    """The train step for `layer` on `device` (default: where its
    parameters are); raises `NotImplementedError` for a mesh and for
    strategy toggles the port does not run."""
    if mesh is not None:
        raise NotImplementedError("compile_train_step(mesh=...): meshes are "
                                  "not ported to paddle_tpu_torch (one "
                                  "device)")
    strategy.check_ported()
    dev = torch.device(device) if device is not None else _layer_device(layer)
    return CompiledTrainStep(layer, optimizer, strategy, loss_method, dev)
