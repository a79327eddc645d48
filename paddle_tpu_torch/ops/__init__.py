"""The tensor function library (port of paddle_tpu's `ops/`): creation,
math, manipulation, linalg, logic, search, stat, random and `einsum`,
each a torch expression under the JAX package's names, signatures, dtype
rules and AMP dispatch names; hand-written GPU kernels live under
`ops.kernels`."""
from ..core.tensor import (Tensor, enable_grad, is_grad_enabled, no_grad,
                           to_tensor)
from .creation import *       # noqa: F401,F403
from .math import *           # noqa: F401,F403
from .manipulation import *   # noqa: F401,F403
from .linalg import *         # noqa: F401,F403
from .logic import *          # noqa: F401,F403
from .search import *         # noqa: F401,F403
from .stat import *           # noqa: F401,F403
from .random import *         # noqa: F401,F403
from .einsum import einsum    # noqa: F401

from . import _bind           # noqa: F401  (attaches Tensor methods/dunders)
