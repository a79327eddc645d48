"""Optimizer base (port of paddle_tpu's `optimizer/optimizer.py`): holds
the parameter list, the learning rate (a float or an `lr.LRScheduler`),
the gradient clip and the weight decay, and updates every parameter that
has a gradient, in place, under `torch.no_grad`.

`_update(lr)` is the one update, called by the eager `step()` and by the
strategy's `CompiledTrainStep`, in the JAX package's order:

  1. the gradient clip (`grad_clip`, one of `nn.ClipGradBy*`), on the
     gradients in their own dtype;
  2. with `multi_precision`, each non-fp32 parameter's fp32 master copy
     (the JAX `_master` dict) takes the parameter's place, and the
     gradient is cast to it;
  3. the regularizer (`_apply_reg`): a per-parameter `regularizer`
     (`framework.ParamAttr(regularizer=...)`), else the optimizer-wide
     one, adds ``coeff * sign(p)`` (L1Decay) or ``coeff * p`` (L2Decay)
     to the gradient; with no regularizer object a float `weight_decay`
     is coupled L2 and adds ``wd * p`` (the JAX `wd` slot, which AdamW
     ignores);
  4. the subclass's `_apply(params, grads, lr)` over `torch._foreach_*`;
  5. a bf16 parameter takes its updated master, rounded.

`state_dict` keys the per-parameter slots as ``{name}_{slot}`` with the
name ``param_{i}``, the parameter's place in the list (the JAX package
uses a generated name that no other process can know);
`functional_state(named_params)` gives the same slots keyed by qualified
parameter name, the form `hapi.Model.save` writes for the JAX package.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..core.arrays import to_numpy, to_tensor
from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if not isinstance(learning_rate, (numbers.Real, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate)}")
        self._learning_rate = learning_rate \
            if isinstance(learning_rate, LRScheduler) else float(learning_rate)
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._global_reg = None
        if weight_decay is None or isinstance(weight_decay, numbers.Real):
            self._coupled_wd = None if weight_decay is None \
                else float(weight_decay)
        else:
            # an L1Decay / L2Decay object: applied grad-side in _apply_reg,
            # never through the wd slot, which AdamW ignores
            self._global_reg = weight_decay
            self._coupled_wd = None
        self._state = {}                 # id(param) -> per-param state
        self._master = {}                # id(param) -> fp32 master weight

    # -- learning rate ------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise ValueError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    @property
    def _lr_scheduler(self):
        return self._learning_rate if isinstance(self._learning_rate,
                                                 LRScheduler) else None

    # -- per-parameter state ------------------------------------------------
    def _init_state(self, arr) -> dict:
        """The slots of a parameter (or its fp32 master) before its first
        update."""
        return {}

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

    def _master_of(self, p):
        """The tensor the update runs on: `p`, or with multi_precision its
        fp32 master (made from `p` on first use)."""
        if not self._multi_precision or p.dtype == torch.float32:
            return p
        m = self._master.get(id(p))
        if m is None:
            m = self._master[id(p)] = p.detach().float()
        return m

    # -- the update -----------------------------------------------------------
    @torch.no_grad()
    def step(self):
        self._update(self.get_lr())

    minimize_step = step

    def _update(self, lr):
        ps = self._params_with_grads()
        if not ps:
            return
        gs = [p.grad for p in ps]
        if self._grad_clip is not None:
            gs = [g for _, g in self._grad_clip(list(zip(ps, gs)))]
        arrs = [self._master_of(p) for p in ps]
        gs = [g if g.dtype == a.dtype else g.to(a.dtype)
              for g, a in zip(gs, arrs)]
        gs = self._apply_reg(ps, arrs, gs)
        for p, a in zip(ps, arrs):
            if id(p) not in self._state:
                self._state[id(p)] = self._init_state(a)
        self._apply(ps, arrs, gs, lr)
        for p, a in zip(ps, arrs):
            if a is not p:
                p.copy_(a)

    def _apply(self, ps, arrs, gs, lr):
        """Update `arrs` (the parameters or their masters) in place from
        the gradients `gs`; `ps` keys the state."""
        raise NotImplementedError

    def _apply_reg(self, ps, arrs, gs):
        """The gradients with the decay term added: grouped by (kind,
        coeff), each group one `_foreach_mul` and one `_foreach_add` (two
        roundings, as the JAX ``g + coeff * p``)."""
        groups = {}
        for i, p in enumerate(ps):
            reg = getattr(p, "regularizer", None) or self._global_reg
            if reg is not None and hasattr(reg, "_coeff"):
                key = ("l1" if getattr(reg, "_l1", False) else "l2",
                       reg._coeff)
            elif self._coupled_wd:
                key = ("l2", self._coupled_wd)
            else:
                continue
            groups.setdefault(key, []).append(i)
        if not groups:
            return gs
        gs = list(gs)
        for (kind, coeff), idx in groups.items():
            src = [arrs[i] for i in idx]
            if kind == "l1":
                src = [torch.sign(a) for a in src]
            new = torch._foreach_add([gs[i] for i in idx],
                                     torch._foreach_mul(src, coeff))
            for i, g in zip(idx, new):
                gs[i] = g
        return gs

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list or ():
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    # -- checkpoint -----------------------------------------------------------
    def _scheduler_state(self):
        sch = self._lr_scheduler
        return sch.state_dict() if sch else {"lr": self.get_lr()}

    def _slots(self, p):
        """`p`'s slots, its initial ones if it has not been updated yet."""
        st = self._state.get(id(p))
        return st if st is not None else self._init_state(self._master_of(p))

    def state_dict(self):
        out = {"LR_Scheduler": self._scheduler_state()}
        for i, p in enumerate(self._parameter_list or ()):
            for k, v in self._state.get(id(p), {}).items():
                out[f"param_{i}_{k}"] = v
        return out

    def set_state_dict(self, state_dict):
        sch = state_dict.get("LR_Scheduler")
        if sch and self._lr_scheduler:
            self._lr_scheduler.set_state_dict(sch)
        for i, p in enumerate(self._parameter_list or ()):
            loaded = {k: state_dict[f"param_{i}_{k}"]
                      for k in self._slots(p) if f"param_{i}_{k}" in state_dict}
            if loaded:
                self._load_slots(p, loaded)

    def _load_slots(self, p, loaded):
        """Set `p`'s slots from tensors or numpy arrays (the others keep
        their values); tensors land on `p`'s device, scalars on the host."""
        st = dict(self._slots(p))
        for k, v in loaded.items():
            if isinstance(st[k], torch.Tensor):
                st[k] = (v.detach().to(p.device, copy=True)
                         if isinstance(v, torch.Tensor)
                         else to_tensor(v, p.device))
            else:
                st[k] = type(st[k])(v.item() if isinstance(v, torch.Tensor)
                                    else np.asarray(v))
        self._state[id(p)] = st

    def functional_state(self, named_params):
        """{qualified name: {slot: numpy array}} for every parameter of
        `named_params` ((name, param) pairs) in this optimizer: the
        JAX package's ``functional_state``."""
        mine = {id(p) for p in self._parameter_list or ()}
        return {n: {k: (to_numpy(v) if isinstance(v, torch.Tensor)
                        else np.asarray(v))
                    for k, v in self._slots(p).items()}
                for n, p in named_params if id(p) in mine}

    def set_functional_state(self, named_params, state):
        """Load `functional_state`'s form, by qualified name; a name in
        `state` that `named_params` lacks, or a slot the parameter does
        not have, raises."""
        by_name = dict(named_params)
        for n, slots in state.items():
            if n not in by_name:
                raise KeyError(f"optimizer state for {n!r}: no such "
                               f"parameter")
            p = by_name[n]
            extra = set(slots) - set(self._slots(p))
            if extra:
                raise KeyError(f"optimizer state for {n!r}: unknown slots "
                               f"{sorted(extra)}")
            self._load_slots(p, slots)
