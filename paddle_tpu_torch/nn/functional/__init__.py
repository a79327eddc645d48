"""paddle.nn.functional: the functionals of the training slice. Each takes
paddle `Tensor`s as plain tensors and returns `Tensor`s for them
(`core.tensor.paddle_io`); plain tensors pass straight through."""
import inspect as _inspect

from ...core.tensor import paddle_io as _paddle_io
from .activation import *                                     # noqa: F403
from .activation import __all__ as _activations
from .attention import scaled_dot_product_attention, seq_parallel_scope
from .common import dropout, embedding, linear
from .conv import conv2d
from .loss import (cross_entropy, linear_cross_entropy,
                   softmax_with_cross_entropy)
from .norm import batch_norm, layer_norm
from .pooling import adaptive_avg_pool2d, avg_pool2d, max_pool2d

__all__ = list(_activations) + [
    "scaled_dot_product_attention", "seq_parallel_scope", "dropout",
    "embedding", "linear", "linear_cross_entropy", "layer_norm", "conv2d",
    "max_pool2d", "avg_pool2d", "adaptive_avg_pool2d", "batch_norm",
    "cross_entropy", "softmax_with_cross_entropy"]

for _n in __all__:
    if _inspect.isfunction(globals()[_n]):
        globals()[_n] = _paddle_io(globals()[_n])

# the op library's own, as in the JAX package (they take paddle Tensors)
from ...ops.manipulation import pad                           # noqa: E402
from ...ops.math import erf                                   # noqa: E402

__all__ += ["pad", "erf"]
