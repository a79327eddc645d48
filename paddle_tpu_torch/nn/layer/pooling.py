"""MaxPool2D / AvgPool2D / AdaptiveAvgPool2D (port of paddle_tpu's
`nn/layer/pooling.py`)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D"]


class _Pool(Layer):
    def __init__(self, fn, **kw):
        super().__init__()
        self._fn = fn
        self._kw = kw

    def forward(self, x):
        return self._fn(x, **self._kw)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(F.max_pool2d, kernel_size=kernel_size, stride=stride,
                         padding=padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format=data_format)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(F.avg_pool2d, kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         exclusive=exclusive,
                         divisor_override=divisor_override,
                         data_format=data_format)


class AdaptiveAvgPool2D(_Pool):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(F.adaptive_avg_pool2d, output_size=output_size,
                         data_format=data_format)
