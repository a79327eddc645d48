"""linear_cross_entropy (port of paddle_tpu's `nn/functional/loss.py`
`linear_cross_entropy` over `ops/pallas/fused_ce.py`).

loss[i] = -log softmax(x[i] @ w.T)[labels[i]], x [N, H], w [V, H]. Two
routes, as in the JAX package:

  * fused (`fused=True`, or `fused=None` with V >= FUSED_MIN_VOCAB):
    `ops.kernels.fused_ce.fused_linear_cross_entropy`, the streaming
    kernels on a CUDA tensor and their plain versions on a CPU tensor; any
    other device raises. The JAX package also falls back here when N or H
    is not a multiple of its TPU tile (`_pallas_ok`); the port's kernels
    take any N, V and H up to their limit and raise above it.
  * unfused (`_LinearCrossEntropy`, the JAX package's `_lce_xla`): the
    same math with the [N, V] fp32 logits materialised and the products
    left to `torch.matmul`, as the JAX package leaves them to XLA.

Both keep (x, w, labels, lse) for the backward and never the logits: the
backward recomputes them. The logits are fp32 even for bf16 operands (the
JAX package's preferred_element_type).
"""
from __future__ import annotations

import torch

from ...amp import maybe_cast_inputs
from ...ops.kernels.fused_ce import (dlogits_reference,
                                     fused_ce_fwd_reference,
                                     fused_linear_cross_entropy)

__all__ = ["linear_cross_entropy", "FUSED_MIN_VOCAB"]

# fused=None takes the fused route from this vocabulary size on: the JAX
# package's number, measured on a TPU v5e (fused_ce.py:373), kept only so
# that the port routes as the JAX package does; the H100's own crossover
# is not measured yet
FUSED_MIN_VOCAB = 65536


class _LinearCrossEntropy(torch.autograd.Function):
    """The unfused head: the plain forward of the fused kernels, and a
    backward whose two products run in x's type in `torch.matmul`."""

    @staticmethod
    def forward(ctx, x, w, labels):
        lse, lab = fused_ce_fwd_reference(x, w, labels)
        ctx.save_for_backward(x, w, labels, lse)
        return lse - lab

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        dlg = dlogits_reference(x, w, labels, lse, g)
        dx = torch.matmul(dlg, w.to(x.dtype)).to(x.dtype)
        dw = torch.matmul(dlg.t(), x).to(w.dtype)
        return dx, dw, None


def linear_cross_entropy(input, weight, label, fused=None, reduction="mean"):
    """Per-row CE of the tied LM head without storing the logits: input
    [N, H], weight [V, H] (e.g. a tied embedding table), label [N]."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction {reduction!r}: want mean, sum or none")
    x, w = maybe_cast_inputs("linear_cross_entropy", (input, weight))
    if fused is None:
        fused = w.shape[0] >= FUSED_MIN_VOCAB
    if fused:
        rows = fused_linear_cross_entropy(x, w, label)
    else:
        rows = _LinearCrossEntropy.apply(x, w, label)
    if reduction == "mean":
        return rows.mean()
    if reduction == "sum":
        return rows.sum()
    return rows
