"""A layer's tensors as flat ``{name: tensor}`` dicts (port of the two
helpers of paddle_tpu's `framework.py` that feed the pure decode fns).

`param_arrays(GPT(cfg))` is the param dict `models.gpt.gpt_decode_fns`
takes: the port's `Layer.state_dict()` names are the JAX package's
expanded per-block names (``blocks.3.attn.qkv.weight``), the layout
`split_decode_params` reads.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["param_arrays", "state_arrays"]


def param_arrays(layer) -> Dict[str, torch.Tensor]:
    """Trainable parameters (``requires_grad``) keyed by qualified name,
    detached: the same storage, no autograd history."""
    return {n: p.detach() for n, p in layer.named_parameters()
            if p.requires_grad}


def state_arrays(layer) -> Dict[str, torch.Tensor]:
    """Non-trainable state: buffers and frozen parameters."""
    out = {n: b for n, b in layer.named_buffers()}
    out.update({n: p.detach() for n, p in layer.named_parameters()
                if not p.requires_grad})
    return out
