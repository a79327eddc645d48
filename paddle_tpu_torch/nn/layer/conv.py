"""Conv2D (port of paddle_tpu's `nn/layer/conv.py`)."""
from __future__ import annotations

import math

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Conv2D"]


class Conv2D(Layer):
    """2-D convolution with weight [out, in/groups, kh, kw] (both data
    formats), drawn from Normal(0, sqrt(2 / fan_in)), fan_in = in/groups *
    kh * kw; a zero bias unless `bias_attr` is False. `padding_mode` other
    than "zeros" is not ported."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        if in_channels % groups:
            raise ValueError(f"Conv2D: in_channels {in_channels} is not a "
                             f"multiple of groups {groups}")
        if padding_mode != "zeros":
            raise NotImplementedError(f"Conv2D(padding_mode="
                                      f"{padding_mode!r}) is not ported")
        k = (kernel_size,) * 2 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = k
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        fan_in = in_channels // groups * math.prod(k)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *k], attr=weight_attr,
            default_initializer=I.Normal(0.0, (2.0 / fan_in) ** 0.5))
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={self._stride}")
