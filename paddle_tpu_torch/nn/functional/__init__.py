"""paddle.nn.functional: the functionals of the training slice."""
from .activation import gelu
from .attention import scaled_dot_product_attention, seq_parallel_scope
from .common import dropout, embedding, linear
from .loss import linear_cross_entropy
from .norm import layer_norm

__all__ = ["gelu", "scaled_dot_product_attention", "seq_parallel_scope",
           "dropout", "embedding", "linear", "linear_cross_entropy",
           "layer_norm"]
