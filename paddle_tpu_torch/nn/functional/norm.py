"""layer_norm (port of paddle_tpu's `nn/functional/norm.py`)."""
from __future__ import annotations

import torch

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
