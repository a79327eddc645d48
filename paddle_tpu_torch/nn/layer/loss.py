"""CrossEntropyLoss (port of paddle_tpu's `nn/layer/loss.py`)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self._kw = dict(weight=weight, ignore_index=ignore_index,
                        reduction=reduction, soft_label=soft_label, axis=axis,
                        use_softmax=use_softmax)

    def forward(self, input, label):
        return F.cross_entropy(input, label, **self._kw)
