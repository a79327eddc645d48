"""LayerList (port of paddle_tpu's `nn/layer/container.py`)."""
from __future__ import annotations

import torch

from .layers import Layer

__all__ = ["LayerList"]


class LayerList(Layer, torch.nn.ModuleList):
    """A list of sublayers named by index (``blocks.0``, ``blocks.1``...)."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            for layer in sublayers:
                self.append(layer)
