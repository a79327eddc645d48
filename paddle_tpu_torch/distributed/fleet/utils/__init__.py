"""paddle.distributed.fleet.utils: `recompute` (port of paddle_tpu's
`distributed/fleet/utils/__init__.py` `recompute`).

`recompute(function, *args, checkpoint_policy=None, **kwargs)` runs one
call (a transformer block, in `GPT.forward_hidden`) so that its
activations are recomputed in the backward instead of kept, as the JAX
package's `jax.checkpoint` does, on
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`:

  * ``"dots_saveable"`` (`jax.checkpoint_policies.dots_saveable`): the
    outputs of the matrix products (`aten.mm`, `addmm`, `bmm`, `baddbmm`)
    are kept, through `create_selective_checkpoint_contexts`; everything
    else is recomputed, the flash-attention forward included, as
    `jax.checkpoint` recomputes a `pallas_call` (its kernel launches
    through ctypes, out of the dispatcher's sight, so the recomputed
    forward launches it again and fills fresh `torch.empty` outputs);
  * ``"nothing_saveable"`` or None: only the call's inputs are kept.

The recomputation runs under the `amp.auto_cast` state of the original
call (the port's AMP is its own thread-local state, which
`torch.utils.checkpoint` does not restore), and with the RNG state of the
original call (`checkpoint`'s own `preserve_rng_state`).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ....amp import amp_state, auto_cast

__all__ = ["recompute", "RECOMPUTE_POLICIES"]

# the checkpoint policies `recompute` runs (jax.checkpoint_policies names)
RECOMPUTE_POLICIES = ("dots_saveable", "nothing_saveable", None)

_aten = torch.ops.aten
_DOTS = frozenset((_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                   _aten.baddbmm.default))


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_saveable_contexts():
    return create_selective_checkpoint_contexts(_dots_saveable)


def _under_amp(state, function, *args, **kwargs):
    """`function` under the auto_cast `state` (None: AMP off)."""
    if state is None:
        with auto_cast(enable=False):
            return function(*args, **kwargs)
    with auto_cast(level=state.level, dtype=state.dtype):
        return function(*args, **kwargs)


def recompute(function, *args, checkpoint_policy=None, **kwargs):
    """`function(*args, **kwargs)` with its activations recomputed in the
    backward; `checkpoint_policy` is one of `RECOMPUTE_POLICIES`."""
    if checkpoint_policy not in RECOMPUTE_POLICIES:
        raise NotImplementedError(
            f"recompute: checkpoint_policy {checkpoint_policy!r} is not "
            f"ported to paddle_tpu_torch (want one of {RECOMPUTE_POLICIES})")
    run = functools.partial(_under_amp, amp_state(), function)
    if checkpoint_policy == "dots_saveable":
        return checkpoint(run, *args, use_reentrant=False,
                          context_fn=_dots_saveable_contexts, **kwargs)
    return checkpoint(run, *args, use_reentrant=False, **kwargs)
