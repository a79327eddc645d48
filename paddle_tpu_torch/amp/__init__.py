"""Automatic mixed precision, op by op, as the JAX package does it.

Port of paddle_tpu's `amp/__init__.py` `auto_cast` and
`maybe_cast_inputs`. This is not `torch.autocast`, whose op lists differ:
every functional op of the port (`nn.functional`, `ops.basic`) calls
`maybe_cast_inputs(op_name, tensors)` under the JAX package's op name, and
under an active `auto_cast` the floating inputs are cast by the same rules:

  * a WHITE_LIST op, or under level "O2" any op not on the BLACK_LIST,
    gets its floating inputs in the AMP dtype (bf16): at O2 that includes
    embedding lookups, residual adds, gelu, reshapes and
    `linear_cross_entropy`;
  * a BLACK_LIST op (layer_norm, softmax, sum-like reductions, exp, log,
    cross_entropy, ...) gets fp16/bf16 inputs back in fp32;
  * any other op ("gray") with floating inputs of more than one dtype
    gets them all in the AMP dtype (see `maybe_cast_inputs`).

Parameters stay fp32 and are cast at each use, so their gradients (and
the optimizer's state) are fp32 with no separate master copy.

One naming note: in the JAX package, ops dispatched without an explicit
name carry their function's name ("add", "<lambda>", "f", ...); none of
those is on either list, so the port's names for them ("add", "reshape",
"sum", ...) select the same rule.
"""
from __future__ import annotations

import threading

import torch

from ..core.flags import get_flags

__all__ = ["auto_cast", "maybe_cast_inputs", "amp_state",
           "WHITE_LIST", "BLACK_LIST"]

WHITE_LIST = {"matmul", "linear", "conv1d", "conv2d", "conv3d", "einsum",
              "flash_attention", "sdpa", "sp_attention", "mm", "bmm"}
BLACK_LIST = {"softmax", "log_softmax", "cross_entropy", "layer_norm",
              "batch_norm", "norm", "mean", "sum", "exp", "log", "logsumexp",
              "cumsum", "softmax_with_cross_entropy", "kl_div", "nll_loss"}

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "float32": torch.float32}

_state = threading.local()


def amp_state():
    """The active `auto_cast`, or None."""
    return getattr(_state, "amp", None)


def _dtype(d):
    if isinstance(d, torch.dtype):
        return d
    if d not in _DTYPES:
        raise ValueError(f"amp dtype {d!r}: want one of {sorted(_DTYPES)}")
    return _DTYPES[d]


class auto_cast:
    """``with amp.auto_cast(level="O2", dtype="bfloat16"): ...``"""

    def __init__(self, enable=True, level="O1", dtype=None):
        if level not in ("O1", "O2"):
            raise ValueError(f"amp level {level!r}: want 'O1' or 'O2'")
        self.enable = enable
        self.level = level
        self.dtype = _dtype(dtype or get_flags("amp_dtype"))

    def __enter__(self):
        self._prev = amp_state()
        _state.amp = self if self.enable else None
        return self

    def __exit__(self, *exc):
        _state.amp = self._prev
        return False



def _is_float(t):
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def maybe_cast_inputs(op_name, tensors):
    """The inputs of op `op_name`, cast per the active `auto_cast` (a
    list; non-tensors and integer tensors pass through)."""
    st = amp_state()
    tensors = list(tensors)
    if st is None:
        return tensors
    if op_name in WHITE_LIST or (st.level == "O2"
                                 and op_name not in BLACK_LIST):
        return [t.to(st.dtype) if _is_float(t) else t for t in tensors]
    if op_name in BLACK_LIST:
        return [t.float() if _is_float(t) and t.dtype in (torch.float16,
                                                          torch.bfloat16)
                else t for t in tensors]
    # gray op with mixed floating inputs. The JAX package means to promote
    # to fp32 here, but its test `jnp.float32 in {dtypes}` compares a type
    # with dtype objects of another hash and is never true, so it casts to
    # the AMP dtype; the port does the same (ROADMAP queue 3)
    if len({t.dtype for t in tensors if _is_float(t)}) > 1:
        return [t.to(st.dtype) if _is_float(t) else t for t in tensors]
    return tensors
