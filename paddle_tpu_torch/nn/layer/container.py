"""LayerList and Sequential (port of paddle_tpu's
`nn/layer/container.py`)."""
from __future__ import annotations

import collections

import torch

from .layers import Layer

__all__ = ["LayerList", "Sequential"]


class LayerList(Layer, torch.nn.ModuleList):
    """A list of sublayers named by index (``blocks.0``, ``blocks.1``...)."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            for layer in sublayers:
                self.append(layer)


class Sequential(Layer, torch.nn.Sequential):
    """Sublayers called in order, named by index, or by the keys of one
    OrderedDict, or by the names of (name, layer) pairs."""

    def __init__(self, *layers):
        Layer.__init__(self)
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            items = list(layers[0].items())
        else:
            items = [tuple(l) if isinstance(l, (list, tuple)) and len(l) == 2
                     else (str(i), l) for i, l in enumerate(layers)]
        for name, layer in items:
            self.add_module(name, layer)

    def forward(self, x):
        for layer in self:
            x = layer(x)
        return x
