"""paddle.seed on torch.Generators.

`seed(s)` reseeds the generator that parameter initializers draw from
(`generator()`, a CPU `torch.Generator`, so one seed gives the same weights
whichever device the layer lives on), PyTorch's own per-device generators
(dropout masks), and numpy's global generator (the DataLoader's shuffle),
as the JAX package's `core/random.py` reseeds its key and numpy. The two
packages draw different numbers from the same seed: tests carry weights
across as numpy arrays instead.
"""
from __future__ import annotations

import numpy as np
import torch

_GENERATOR = torch.Generator()


def seed(s: int) -> torch.Generator:
    """Reseed every generator the port draws from; returns the
    initializers' generator."""
    s = int(s)
    _GENERATOR.manual_seed(s)
    torch.manual_seed(s)
    np.random.seed(s % (2 ** 32))
    return _GENERATOR


def generator() -> torch.Generator:
    """The CPU generator parameter initializers draw from."""
    return _GENERATOR
