"""The single-device train step (port of the single-device branch of
paddle_tpu's `distributed/fleet/compiler.py` `compile_train_step`).

`compile_train_step(layer, optimizer, strategy, loss_method="loss")` takes
the JAX package's call, so code written against it (benchmarks/run.py's
configs 2-5: `compile_train_step`, `prog._put_data(ids)`, `prog.step(ids,
ids)`) runs unchanged. `put_batch` is the placement hook that
`hapi.Model.fit(prefetch_device=True)` hands `io.device_prefetch`. `CompiledTrainStep.step(*data, lr=)` runs
`getattr(layer, loss_method)(*data)` (the layer itself when `loss_method`
is empty) under `amp.auto_cast(level="O2" if use_pure_bf16 else "O1",
dtype="bfloat16")` when `strategy.amp` is set, backpropagates, and
applies the optimizer: eagerly, with no `torch.compile` and no CUDA
graph. Its `mesh` is the one-device mesh it was given, or the
strategy's (`build_mesh` of the step's device: every axis 1, so run.py's
``prog.mesh.shape.get("dp", 1)`` reads 1); a mesh of more devices cannot
be built, and anything else passed as `mesh` raises. With
`strategy.recompute`, a layer that has `enable_block_recompute` (GPT)
runs each block under
`fleet.utils.recompute` with `recompute_configs.policy`; the flag is set
around the forward only and restored after it, so it never leaks into
eager use of the layer. Any other layer's whole forward is recomputed.
Parameters are updated in place and stay the layer's own tensors (the JAX
step donates copies and writes back later; here `write_back` has nothing
to do).

The strategy's one-device toggles, as the JAX step runs them:

  * `sharding` (ZeRO stages 1-3) over a dp axis of size 1 shards nothing:
    the step is the plain one, bit for bit;
  * `pipeline` at pp_degree 1 is the plain step too (the JAX step takes
    its SPMD branch and reads no `pipeline_configs`);
  * `gradient_merge` with `k_steps = k > 1`: each data argument is split
    along dim 0 into k microbatches (rows [i B/k, (i+1) B/k)), forward and
    backward run on each in order, and their gradients are summed (then
    divided by k with `gradient_merge_configs.avg`) before the one
    update; the step's loss is the mean of the microbatch losses. A batch
    that k does not divide raises `ValueError`, as does hapi's
    `accumulate_grad_batches` on top (the JAX hapi refuses it with any
    strategy). Dropout draws afresh in each microbatch (the JAX step
    folds the microbatch index into its key);
  * `lamb` / `lars` swap the optimizer for `Lamb` / `Lars` (lamb first)
    with the original's learning rate, parameters and gradient clip, and
    the new class's own default decay (`_maybe_swap_optimizer`).

The optimizer's `_update(lr)` applies its gradient clip, regularizers and
weight decay, as the eager `step()` does; `lr` is the scheduler's value,
read on the host. With `accumulate_steps = n > 1` (hapi's
`accumulate_grad_batches`, across calls rather than within one) each call
adds its batch's gradients to the parameters' `.grad` and every n-th call
divides them by n and applies the optimizer: the JAX hapi `grad_step` /
`apply_step` pair, the same sum in the same order.

`eval_step(*data)` is the loss in eval mode under the same AMP, with no
gradient (and the outputs too, for a layer with `loss_and_outs`).
`save_checkpoint` / `restore_checkpoint` write and read a format-2
checkpoint (`io.checkpoint`) of the parameters, the optimizer's slots and
the buffers, keyed as the JAX package keys them (`framework.
stacked_layout`), so that either package's step restores the other's.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import amp as amp_mod
from ... import optimizer as opt_mod
from ...core.arrays import to_numpy
from ...core.device import default_device
from ...core.tensor import unwrap, wrap
from ...framework import (indexed_layout, param_arrays, stacked_layout,
                          state_arrays)
from ...io import checkpoint as ckpt_mod
from ..env import MULTI_DEVICE
from ..mesh import Mesh
from .strategy import DistributedStrategy
from .utils import recompute

__all__ = ["CompiledTrainStep", "compile_train_step"]


class CompiledTrainStep:
    def __init__(self, layer, optimizer, strategy: DistributedStrategy,
                 loss_method, device: torch.device, mesh: Mesh):
        self.layer = layer
        self.device = device
        self.mesh = mesh
        self._opt = optimizer
        self.accumulate_steps = 1       # hapi's accumulate_grad_batches
        self._micro = 0                 # batches accumulated so far
        self._loss = getattr(layer, loss_method) if loss_method else layer
        self._amp = bool(strategy.amp)
        self._level = "O2" if strategy.amp_configs.use_pure_bf16 else "O1"
        self._recompute = bool(strategy.recompute)
        self._policy = strategy.recompute_configs.policy
        self._k_merge = (int(strategy.gradient_merge_configs.k_steps)
                         if strategy.gradient_merge else 1)
        self._merge_avg = bool(strategy.gradient_merge_configs.avg)

    def put_batch(self, d):
        """One batch item as a paddle `Tensor` on the step's device, copied
        on the caller's current stream; one already there passes through.
        `step()` places each item so, and `io.device_prefetch` takes this
        as its `place=` hook, to place a batch ahead of the step."""
        if isinstance(d, torch.Tensor):
            return wrap(unwrap(d).to(self.device, non_blocking=True))
        return wrap(torch.from_numpy(np.ascontiguousarray(d)).to(
            self.device, non_blocking=True))

    _put_data = put_batch           # the JAX package's name for it

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

    def _grads(self):
        return [g for g in (p.grad for p in self._opt._parameter_list or ())
                if g is not None]

    def _merged(self, data):
        """Gradient merge: forward and backward over `_k_merge`
        microbatches in order, the gradients summed into `.grad` (and
        averaged with `avg`); the mean of their losses."""
        k = self._k_merge
        if self.accumulate_steps > 1:
            raise ValueError(
                "gradient_merge and accumulate_grad_batches together: the "
                "JAX package takes neither with the other; set k_steps to "
                "their product")
        for d in data:
            if d.ndim == 0 or d.shape[0] % k:
                raise ValueError(
                    f"gradient_merge: k_steps={k} does not divide a batch "
                    f"of shape {tuple(d.shape)} along dim 0")
        micro = [d.chunk(k) for d in data]
        losses = []
        for i in range(k):
            loss = self._run(*(m[i] for m in micro))
            loss.backward()
            losses.append(loss.detach())
        if self._merge_avg:
            with torch.no_grad():
                torch._foreach_div_(self._grads(), float(k))
        return torch.stack(losses).mean()

    def step(self, *data, lr=None):
        """One batch: forward, backward and, on the last batch of an
        accumulation (every batch by default), the optimizer update.
        Returns the loss, left on the device, as a paddle `Tensor`
        (`numpy()` reads it from any device)."""
        data = [unwrap(self.put_batch(d)) for d in data]
        self.layer.train()
        if self._micro == 0:
            self._opt.clear_grad()
        if self._k_merge > 1:
            loss = self._merged(data)
        else:
            loss = self._run(*data)
            loss.backward()
        self._micro += 1
        if self._micro >= self.accumulate_steps:
            self._micro = 0
            with torch.no_grad():
                if self.accumulate_steps > 1:
                    torch._foreach_div_(self._grads(),
                                        float(self.accumulate_steps))
                self._opt._update(self._opt.get_lr() if lr is None else lr)
        return wrap(unwrap(loss).detach())

    def eval_step(self, *data):
        """The loss on a batch in eval mode (dropout off), under the
        step's AMP and with no gradient; `(loss, outputs)` for a layer
        with `loss_and_outs`, as in the JAX package."""
        data = [unwrap(self.put_batch(d)) for d in data]
        layer = self.layer
        was = bool(getattr(layer, "training", False))
        if hasattr(layer, "eval"):
            layer.eval()
        try:
            with torch.no_grad(), amp_mod.auto_cast(
                    enable=self._amp, level=self._level, dtype="bfloat16"):
                if getattr(layer, "loss_and_outs", None) is not None:
                    loss, outs = layer.loss_and_outs(*data)
                    return wrap(unwrap(loss)), outs
                return wrap(unwrap(self._loss(*data)))
        finally:
            if was and hasattr(layer, "train"):
                layer.train()

    def write_back(self):
        """The JAX step copies its parameters back into the layer; here
        they are the layer's own tensors already."""

    # -- checkpoints (io/checkpoint.py) -------------------------------------
    def save_checkpoint(self, path, step=0, meta=None):
        """A format-2 checkpoint directory of the parameters, the
        optimizer's slots and the buffers, keyed as the JAX package's
        compiled step keys them."""
        def host(tree):
            return stacked_layout({k: to_numpy(v) for k, v in tree.items()},
                                  self.layer)
        opt = self._opt.functional_state(self.layer.named_parameters())
        ckpt_mod.save_checkpoint(
            path, host(param_arrays(self.layer)),
            stacked_layout(opt, self.layer), host(state_arrays(self.layer)),
            step=step, meta=meta)

    def restore_checkpoint(self, path):
        """Load a checkpoint written by `save_checkpoint` (or by the JAX
        package's) into the layer's parameters and buffers, in place, and
        into the optimizer's slots (a params-only checkpoint keeps the
        live slots). Returns (step, meta)."""
        params, opt, state, step, meta = ckpt_mod.load_checkpoint(
            path, device="cpu")
        loaded = indexed_layout({**params, **state}, self.layer)
        own = param_arrays(self.layer)
        missing = sorted(set(own) - set(loaded))
        if missing:
            raise KeyError(f"restore_checkpoint: {path} lacks {missing}")
        own.update(state_arrays(self.layer))
        with torch.no_grad():
            for k, v in own.items():
                if k in loaded:
                    v.copy_(unwrap(loaded[k]))
        if opt:
            self._opt.set_functional_state(self.layer.named_parameters(),
                                           indexed_layout(opt, self.layer))
        return step, meta


def _maybe_swap_optimizer(optimizer, strategy):
    """The lars / lamb toggles, as the JAX step runs them: the optimizer
    becomes a `Lamb` (checked first) or a `Lars` with the original's
    learning rate, parameters and gradient clip; its weight decay is the
    new class's own default (`lamb_weight_decay` 0.01, `lars_weight_decay`
    0.0005), and the original's is dropped."""
    kw = dict(grad_clip=optimizer._grad_clip)
    if getattr(strategy, "lamb", False) and not isinstance(
            optimizer, opt_mod.Lamb):
        return opt_mod.Lamb(learning_rate=optimizer._learning_rate,
                            parameters=optimizer._parameter_list, **kw)
    if getattr(strategy, "lars", False) and not isinstance(
            optimizer, opt_mod.Lars):
        return opt_mod.Lars(learning_rate=optimizer._learning_rate,
                            parameters=optimizer._parameter_list, **kw)
    return optimizer


def _layer_device(layer):
    """The device of the layer's parameters, else the default device."""
    params = getattr(layer, "parameters", None)
    first = next(iter(params()), None) if callable(params) else None
    return first.device if first is not None else default_device()


def compile_train_step(layer, optimizer, strategy: DistributedStrategy,
                       loss_method: str = "loss", mesh=None,
                       device=None) -> CompiledTrainStep:
    """The train step for `layer` on `device` (default: where its
    parameters are), over `mesh` (a one-device `distributed.mesh.Mesh` of
    that device; default the strategy's `build_mesh`). Raises
    `NotImplementedError` for any other mesh and for strategy toggles the
    port does not run."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise NotImplementedError(
            f"compile_train_step(mesh={type(mesh).__name__}): only a "
            f"one-device paddle_tpu_torch.distributed.mesh.Mesh is ported "
            f"(multi-device meshes: {MULTI_DEVICE})")
    strategy.check_ported()
    dev = torch.device(device) if device is not None else _layer_device(layer)
    if mesh is None:
        mesh = strategy.build_mesh(devices=[dev])
    elif not _same_device(mesh.device, dev):
        raise ValueError(f"compile_train_step: the mesh's device "
                         f"{mesh.device} is not the step's {dev}")
    optimizer = _maybe_swap_optimizer(optimizer, strategy)
    return CompiledTrainStep(layer, optimizer, strategy, loss_method, dev,
                             mesh)


def _same_device(a, b):
    """cuda and cuda:0 name one device (on a one-GPU machine)."""
    return a.type == b.type and (a.index or 0) == (b.index or 0)
