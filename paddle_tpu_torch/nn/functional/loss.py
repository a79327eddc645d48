"""cross_entropy, softmax_with_cross_entropy and linear_cross_entropy
(port of paddle_tpu's `nn/functional/loss.py`; the last over
`ops/pallas/fused_ce.py`).

cross_entropy is the JAX package's arithmetic, cast as its
"cross_entropy" (black-listed: fp32 under AMP): log_softmax in fp32 (or,
with `use_softmax=False`, the log of the input clipped at 1e-30); soft
labels sum -label * logp; hard labels ([N] or [N, 1] on `axis`) pick
-logp at the label, rows equal to `ignore_index` give 0 and leave the
mean's denominator (the count of valid rows, at least 1), and a `weight`
per class scales each row, the mean then dividing by the valid rows'
weights.

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

from ... import ops
from ...amp import maybe_cast_inputs
from ...ops.kernels.fused_ce import (dlogits_reference,
                                     fused_ce_fwd_reference,
                                     fused_linear_cross_entropy)
from .activation import softmax

__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "linear_cross_entropy", "FUSED_MIN_VOCAB"]

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


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True):
    args = [input, label] + ([weight] if weight is not None else [])
    args = maybe_cast_inputs("cross_entropy", args)
    logits, lbl = args[0].float(), args[1]
    if use_softmax:
        logp = torch.log_softmax(logits, dim=axis)
    else:
        logp = torch.log(torch.clamp_min(logits, 1e-30))
    if soft_label:
        return _reduce(-(lbl * logp).sum(axis), reduction)
    if lbl.dim() == logp.dim():
        lbl = lbl.squeeze(axis)
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    loss = -torch.gather(logp, axis % logp.dim(),
                         safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        wt = args[2][safe]
        wt = torch.where(valid, wt, torch.zeros_like(wt))
        loss = loss * wt
        if reduction == "mean":
            return loss.sum() / torch.clamp_min(wt.sum(), 1e-12)
    elif reduction == "mean":
        return loss.sum() / torch.clamp_min(valid.float().sum(), 1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """cross_entropy's per-row loss with `axis` kept (size 1), and with
    `return_softmax` the softmax of the logits beside it. The JAX package
    keeps the axis in an op on neither AMP list, so under O2 the loss
    leaves in bf16; `ops.unsqueeze` casts the same way."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = ops.unsqueeze(loss, axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss
