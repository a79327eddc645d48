"""Gradient clipping (port of the three ClipGradBy* classes of paddle_tpu's
`nn/__init__.py`).

Each is called with a list of (param, grad) pairs and returns that list
with the gradients clipped, as the JAX classes are; the optimizer calls it
on the gradients before its update. The arithmetic is the JAX package's:
norms in fp32, ``scale = min(1, clip_norm / max(norm, 1e-12))``, the
gradient multiplied in fp32 and cast back to its dtype. Unlike the JAX
classes, which return new arrays, these scale each gradient in place, so
after `step()` a parameter's `.grad` holds the clipped gradient.

The norms and the scale stay on the gradients' device (`_foreach_norm`,
then one norm over the stacked per-tensor norms); nothing is read back to
the host, so a clipped step makes no host sync. `ClipGradByGlobalNorm`
keeps the last pre-clip global norm, a device tensor, in `global_norm`.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]


def _scale_(grads, scale):
    """g *= scale (a device scalar) for each g, in fp32, the result cast
    back to g's dtype."""
    f32 = [g for g in grads if g.dtype == torch.float32]
    if f32:
        torch._foreach_mul_(f32, scale)
    for g in grads:
        if g.dtype != torch.float32:
            g.copy_(g.float() * scale)


def _clip_scale(clip_norm, norm):
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)


class ClipGradByGlobalNorm:
    """Scale every gradient by min(1, clip_norm / global_norm), the global
    norm taken over all of them (reference: fluid/clip.py
    GradientClipByGlobalNorm)."""

    def __init__(self, clip_norm=1.0, group_name="default_group"):
        self.clip_norm = clip_norm
        self.global_norm = None

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        norms = torch._foreach_norm(grads, 2.0, dtype=torch.float32)
        self.global_norm = torch.linalg.vector_norm(torch.stack(norms))
        _scale_(grads, _clip_scale(self.clip_norm, self.global_norm))
        return params_grads


class ClipGradByNorm:
    """Scale each gradient by min(1, clip_norm / its own norm)."""

    def __init__(self, clip_norm=1.0):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if grads:
            norms = torch._foreach_norm(grads, 2.0, dtype=torch.float32)
            for g, n in zip(grads, norms):
                _scale_([g], _clip_scale(self.clip_norm, n))
        return params_grads


class ClipGradByValue:
    """Clamp each gradient element to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        for _, g in params_grads:
            if g is not None:
                g.clamp_(self.min, self.max)
        return params_grads
