"""linear_cross_entropy (port of paddle_tpu's `nn/functional/loss.py`
`linear_cross_entropy` over `ops/pallas/fused_ce.py`'s XLA path,
`_lce_xla` / `_xla_fwd` / `_xla_bwd`).

loss[i] = -log softmax(x[i] @ w.T)[labels[i]], x [N, H], w [V, H]. The
forward keeps (x, w, labels, lse) for the backward and never the
[N, V] logits: the backward recomputes them. The JAX package leaves this
path to XLA; the port leaves its matrix products to `torch.matmul`. The
logits are fp32 even for bf16 operands (the JAX package's
preferred_element_type): the product runs on the operands' fp32 values,
which holds bf16 values exactly.

`fused=True` asks for the streaming Pallas kernels (`_fwd_kernel`,
`_bwd_dx_kernel`, `_bwd_dw_kernel` of fused_ce.py), which are not ported
yet: on a CUDA (or any non-CPU) tensor it raises. On the CPU it takes this
path, as the JAX package does off the TPU.
"""
from __future__ import annotations

import torch

from ...amp import maybe_cast_inputs

__all__ = ["linear_cross_entropy"]


def _logits(x, w):
    """fp32 [N, V] logits of x @ w.T."""
    return torch.matmul(x.float(), w.float().t())


class _LinearCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, labels):
        lg = _logits(x, w)
        m = lg.amax(dim=1)
        l = torch.exp(lg - m[:, None]).sum(dim=1)
        lse = m + torch.log(l.clamp_min(1e-30))
        lab = lg.gather(1, labels.long()[:, None])[:, 0]
        ctx.save_for_backward(x, w, labels, lse)
        return lse - lab

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        p = torch.exp(_logits(x, w) - lse[:, None])
        p[torch.arange(p.shape[0], device=p.device), labels.long()] -= 1.0
        dlg = (p * g.float()[:, None]).to(x.dtype)      # (softmax - onehot) g
        dx = torch.matmul(dlg, w.to(x.dtype)).to(x.dtype)
        dw = torch.matmul(dlg.t(), x).to(w.dtype)
        return dx, dw, None


def linear_cross_entropy(input, weight, label, fused=None, reduction="mean"):
    """Per-row CE of the tied LM head without storing the logits: input
    [N, H], weight [V, H] (e.g. a tied embedding table), label [N]."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction {reduction!r}: want mean, sum or none")
    x, w = maybe_cast_inputs("linear_cross_entropy", (input, weight))
    if fused and x.device.type != "cpu":
        raise NotImplementedError(
            "linear_cross_entropy(fused=True): the streaming fused-CE "
            "kernels (paddle_tpu/ops/pallas/fused_ce.py rows 9-11 of "
            "PERF.md's kernel table) are not ported yet; see ROADMAP.md "
            "queue 2")
    rows = _LinearCrossEntropy.apply(x, w, label)
    if reduction == "mean":
        return rows.mean()
    if reduction == "sum":
        return rows.sum()
    return rows
