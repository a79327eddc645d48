"""gelu (port of paddle_tpu's `nn/functional/activation.py`)."""
from __future__ import annotations

import torch

from ...amp import maybe_cast_inputs


def gelu(x, approximate=False):
    """GELU; exact (erf) unless `approximate` (tanh), as jax.nn.gelu."""
    (x,) = maybe_cast_inputs("gelu", (x,))
    return torch.nn.functional.gelu(x,
                                    approximate="tanh" if approximate
                                    else "none")
