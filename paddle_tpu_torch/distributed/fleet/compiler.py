"""The single-device train step (port of the single-device branch of
paddle_tpu's `distributed/fleet/compiler.py` `compile_train_step`).

`CompiledTrainStep.step(*data, lr=)` runs `layer.loss(*data)` under
`amp.auto_cast(level="O2" if use_pure_bf16 else "O1", dtype="bfloat16")`
when `strategy.amp` is set, backpropagates, and applies the optimizer:
eagerly, with no `torch.compile`, no CUDA graph and no mesh. Parameters
are updated in place and stay the layer's own tensors (the JAX step
donates copies and writes back later; here there is nothing to write
back).
"""
from __future__ import annotations

import numpy as np
import torch

from ... import amp as amp_mod
from .strategy import DistributedStrategy

__all__ = ["CompiledTrainStep", "compile_train_step"]


class CompiledTrainStep:
    def __init__(self, layer, optimizer, strategy: DistributedStrategy,
                 device: torch.device):
        self.layer = layer
        self.device = device
        self._opt = optimizer
        self._amp = bool(strategy.amp)
        self._level = "O2" if strategy.amp_configs.use_pure_bf16 else "O1"

    def _put(self, d):
        if isinstance(d, torch.Tensor):
            return d.to(self.device, non_blocking=True)
        return torch.from_numpy(np.ascontiguousarray(d)).to(
            self.device, non_blocking=True)

    def step(self, *data, lr=None):
        """One optimizer step on a batch; returns the loss, left on the
        device."""
        data = [self._put(d) for d in data]
        self.layer.train()
        self._opt.clear_grad()
        with amp_mod.auto_cast(enable=self._amp, level=self._level,
                               dtype="bfloat16"):
            loss = self.layer.loss(*data)
        loss.backward()
        with torch.no_grad():
            self._opt._update(self._opt.get_lr() if lr is None else lr)
        return loss.detach()


def compile_train_step(layer, optimizer, strategy: DistributedStrategy,
                       device) -> CompiledTrainStep:
    """The train step for `layer` on `device`; raises
    `NotImplementedError` for strategy toggles the port does not run."""
    strategy.check_ported()
    return CompiledTrainStep(layer, optimizer, strategy, device)
