"""Layer: `torch.nn.Module` with paddle's names (port of paddle_tpu's
`nn/layer/layers.py`).

`state_dict()` keys are the JAX package's expanded per-block names
(``blocks.{i}.attn.qkv.weight``, ...), the layout its own `state_dict()`
writes whether or not the model scans its layers. Parameters are created
fp32 on `core.device.get_device()` (the `set_device` default: cuda, which
raises without a GPU).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ...amp import _dtype
from ...core.device import get_device
from .. import initializer as I

__all__ = ["Layer"]


class Layer(torch.nn.Module):

    def create_parameter(self, shape, attr=None, default_initializer=None,
                         is_bias=False):
        """A trainable fp32 parameter on the default device, drawn from
        `attr` (an initializer, or an object with an ``initializer``, a
        `framework.ParamAttr`), else `default_initializer`, else zeros for
        a bias. The attr's `regularizer`, if any, goes on the parameter
        for the optimizer."""
        init = getattr(attr, "initializer", attr) or default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        p = torch.nn.Parameter(init(shape, get_device()).float())
        reg = getattr(attr, "regularizer", None)
        if reg is not None:
            p.regularizer = reg
        return p

    # paddle returns lists and names the flag include_sublayers; torch's
    # own callers pass recurse=, which these keep taking
    def parameters(self, include_sublayers=True,
                   recurse=None) -> List[torch.nn.Parameter]:
        return list(super().parameters(
            recurse=include_sublayers if recurse is None else recurse))

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        return list(super().named_parameters(
            prefix=prefix,
            recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate))

    def astype(self, dtype):
        """Cast every floating parameter and buffer to `dtype` (a torch
        dtype or paddle's name, "float32" / "bfloat16" / "float16") in
        place and return self, as the JAX package's `Layer.astype`.
        `float()`, `bfloat16()` and `half()` are torch's own, which do the
        same."""
        return self.to(dtype=_dtype(dtype))

    def set_state_dict(self, state_dict) -> Tuple[List[str], List[str]]:
        """Copy `state_dict` (tensors or numpy arrays, by name) into the
        parameters; returns (missing, unexpected) names. A shape mismatch
        raises."""
        own = dict(self.state_dict())
        with torch.no_grad():
            for name, value in state_dict.items():
                if name not in own:
                    continue
                src = torch.as_tensor(np.asarray(value)
                                      if not isinstance(value, torch.Tensor)
                                      else value)
                if tuple(src.shape) != tuple(own[name].shape):
                    raise ValueError(f"set_state_dict: {name} has shape "
                                     f"{tuple(src.shape)}, want "
                                     f"{tuple(own[name].shape)}")
                own[name].copy_(src)
        missing = sorted(set(own) - set(state_dict))
        unexpected = sorted(set(state_dict) - set(own))
        return missing, unexpected
