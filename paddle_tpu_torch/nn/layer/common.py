"""Linear / Embedding / Dropout / Flatten (port of paddle_tpu's
`nn/layer/common.py`). Linear keeps the JAX package's [in, out] weight:
it is never `torch.nn.Linear` ([out, in]), into which a state dict would
load silently transposed."""
from __future__ import annotations

from ... import ops
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Flatten"]


class Linear(Layer):
    """y = x W + b, W [in_features, out_features], XavierNormal by
    default, zero bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(Layer):
    """Lookup table [num_embeddings, embedding_dim], Normal(0, 1) by
    default."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None):
        super().__init__()
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))

    def forward(self, x):
        return F.embedding(x, self.weight)


class Dropout(Layer):
    """`F.dropout` with this layer's p, axis and mode, active in
    training."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Flatten(Layer):
    """`ops.flatten(x, start_axis, stop_axis)`."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return ops.flatten(x, self.start_axis, self.stop_axis)
