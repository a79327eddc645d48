"""layer_norm and batch_norm (port of paddle_tpu's `nn/functional/norm.py`)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...amp import maybe_cast_inputs


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing `normalized_shape` dims, computed in
    fp32 (biased variance, as the JAX package) and returned in the dtype
    of the (AMP-cast) input: layer_norm is black-listed, so under AMP the
    input arrives, and the output leaves, in fp32."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    args = [x]                          # bias applies only with a weight,
    if weight is not None:              # as in the JAX package
        args.append(weight)
        if bias is not None:
            args.append(bias)
    args = maybe_cast_inputs("layer_norm", args)
    a = args[0]
    w = args[1].float() if len(args) > 1 else None
    b = args[2].float() if len(args) > 2 else None
    out = torch.nn.functional.layer_norm(a.float(), list(normalized_shape),
                                         w, b, epsilon)
    return out.to(a.dtype)


_CHANNELS_LAST = ("NHWC", "NLC", "NDHWC")


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """Batch norm with paddle's conventions, as the JAX package computes
    it. Training (unless `use_global_stats`) normalizes by the batch's
    mean and biased variance, computed in fp32, and updates the running
    buffers in place, without autograd: running = momentum * running +
    (1 - momentum) * batch, the variance's unbiased (var * n / (n - 1)).
    Eval and `use_global_stats` normalize by the running buffers. The
    channel axis is 1, or -1 for NHWC / NLC / NDHWC; `bias` applies only
    with a `weight`, as in the JAX package.

    AMP: "batch_norm" is black-listed, so the normalized input, and the
    output, are fp32 under AMP (the output keeps the cast input's dtype).
    The JAX package computes the batch statistics in an op of their own
    that is on neither list ("batch_norm_stats" here): under O2 an fp32
    input reaches them rounded to bf16.

    The work is `torch.nn.functional.batch_norm` on the fp32 input
    (cuDNN on the card), whose momentum is the weight of the batch: it is
    given 1 - momentum. It saves its fp32 input and the per-channel
    statistics for the backward. Where the statistics' input differs from
    the normalized one (an fp32 input under O2), a channel has one value
    or a running buffer is not fp32, the same arithmetic runs op by op."""
    ch = x.dim() - 1 if data_format in _CHANNELS_LAST else 1
    use_batch = bool(training and not use_global_stats)
    args = [x]
    if weight is not None:
        args.append(weight)
        if bias is not None:
            args.append(bias)
    args = maybe_cast_inputs("batch_norm", args)
    a = args[0]
    w = args[1].float() if len(args) > 1 else None
    b = args[2].float() if len(args) > 2 else None
    a32 = a.float().movedim(ch, 1)  # channels on dim 1 (a view)
    n = a32.numel() // max(a32.shape[1], 1)
    stats = maybe_cast_inputs("batch_norm_stats", (x,))[0] \
        if use_batch else x
    # the statistics see other values than the normalized input only
    # where their cast rounded x (an fp32 x under O2)
    if stats.dtype != x.dtype or (use_batch and n < 2) or any(
            t is not None and t.dtype != torch.float32
            for t in (running_mean, running_var)):
        out = _batch_norm_ops(a32, stats.float().movedim(ch, 1),
                              running_mean, running_var, w, b, use_batch,
                              momentum, epsilon, n)
    else:
        out = TF.batch_norm(a32, running_mean, running_var, w, b,
                            training=use_batch, momentum=1.0 - momentum,
                            eps=epsilon)
    return out.movedim(1, ch).to(a.dtype)


def _batch_norm_ops(a32, s32, running_mean, running_var, w, b, use_batch,
                    momentum, epsilon, n):
    """`batch_norm` op by op (channels on dim 1): the statistics of `s32`
    in training, else the running buffers, normalizing `a32`."""
    if use_batch:
        dims = [d for d in range(s32.dim()) if d != 1]
        mean = torch.mean(s32, dims)
        var = torch.var(s32, dims, unbiased=False)
        with torch.no_grad():
            if running_mean is not None:
                running_mean.copy_(momentum * running_mean.float()
                                   + (1.0 - momentum) * mean)
            if running_var is not None:
                running_var.copy_(momentum * running_var.float()
                                  + (1.0 - momentum)
                                  * (var * (n / max(n - 1, 1))))
    else:
        mean, var = running_mean.float(), running_var.float()
    shape = [1] * a32.dim()
    shape[1] = a32.shape[1]
    out = (a32 - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                     + epsilon)
    if w is not None:
        out = out * w.reshape(shape)
        if b is not None:
            out = out + b.reshape(shape)
    return out
