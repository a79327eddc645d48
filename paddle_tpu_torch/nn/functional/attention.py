"""scaled_dot_product_attention (port of paddle_tpu's
`nn/functional/attention.py`).

Routing is the JAX package's, written as explicit conditions: with the
`use_pallas_attention` flag on, no mask, no dropout and seq_len >=
`pallas_attention_min_seq`, the call goes to `ops.kernels.flash_attention`
(the Hopper kernels on a CUDA tensor, their plain versions on a CPU one);
otherwise to the composition of `_sdpa_xla`, in plain torch ops. The JAX
package also falls back to the composition when the sequence is not a
multiple of its TPU block size; the port's kernels take any length, so it
has no such fallback. Sequence parallelism is not ported.
"""
from __future__ import annotations

import math

import torch

from ...amp import maybe_cast_inputs
from ...core.flags import get_flags
from ...ops.kernels.flash_attention import NEG_INF, flash_attention

__all__ = ["scaled_dot_product_attention", "seq_parallel_scope"]


class seq_parallel_scope:
    """The JAX package's sequence-parallel attention scope; not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "sequence-parallel attention is not ported to paddle_tpu_torch "
            "(single-device training only)")


def _sdpa_composed(q, k, v, mask, dropout_p, causal, scale):
    """The JAX package's `_sdpa_xla`: scores in q's dtype, then fp32 with
    a -1e30 mask, fp32 softmax cast back to q's dtype, then . v."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))    # [B, H, S, D]
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = (torch.einsum("bhsd,bhtd->bhst", qt, kt) * s).float()
    if causal:
        S, T = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(S, T, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, NEG_INF)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, device=probs.device) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs)).to(q.dtype)
    return torch.einsum("bhst,bhtd->bhsd", probs, vt).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, scale=None,
                                 training=True):
    """query/key/value: [batch, seq, heads, head_dim]."""
    if not training:
        dropout_p = 0.0
    use_flash = (get_flags("use_pallas_attention") and attn_mask is None
                 and dropout_p == 0.0
                 and query.shape[1] >= get_flags("pallas_attention_min_seq"))
    if use_flash:
        q, k, v = maybe_cast_inputs("flash_attention", (query, key, value))
        return flash_attention(q, k, v, causal=is_causal, scale=scale)
    args = maybe_cast_inputs("sdpa", [query, key, value]
                             + ([attn_mask] if attn_mask is not None else []))
    mask = args[3] if attn_mask is not None else None
    return _sdpa_composed(args[0], args[1], args[2], mask, dropout_p,
                          is_causal, scale)
