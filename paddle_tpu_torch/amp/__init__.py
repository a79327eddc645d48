"""Automatic mixed precision, op by op, as the JAX package does it.

Port of paddle_tpu's `amp/__init__.py` `auto_cast` and
`maybe_cast_inputs`. This is not `torch.autocast`, whose op lists differ:
every functional op of the port (`nn.functional`, `ops`) calls
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
the optimizer's state) are fp32 with no separate master copy; or
`decorate` casts them to the AMP dtype in place (paddle's "pure" O2),
and the optimizers keep fp32 masters (`_multi_precision`). `GradScaler`
is dynamic loss scaling for float16, whose exponent range a gradient
leaves: scale the loss, unscale the gradients before the step (one
fused check for non-finite values, one device-to-host read), skip a
step that overflowed, and move the scale.

One naming note: in the JAX package, ops dispatched without an explicit
name carry their function's name ("add", "<lambda>", "f", ...); none of
those is on either list, so the port's names for them ("add", "reshape",
"sum", ...) select the same rule.
"""
from __future__ import annotations

import threading

import torch

from ..core.flags import get_flags

__all__ = ["auto_cast", "amp_guard", "maybe_cast_inputs", "amp_state",
           "GradScaler", "decorate", "WHITE_LIST", "BLACK_LIST"]

WHITE_LIST = {"matmul", "linear", "conv1d", "conv2d", "conv3d", "einsum",
              "flash_attention", "sdpa", "sp_attention", "mm", "bmm"}
BLACK_LIST = {"softmax", "log_softmax", "cross_entropy", "layer_norm",
              "batch_norm", "norm", "mean", "sum", "exp", "log", "logsumexp",
              "cumsum", "softmax_with_cross_entropy", "kl_div", "nll_loss"}

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "float32": torch.float32}

_state = threading.local()
_GRAD = torch._C.TensorBase.grad    # a parameter's gradient, unwrapped


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



amp_guard = auto_cast


def _is_float(t):
    return isinstance(t, torch.Tensor) and t.is_floating_point()


_profiler_hook = [None]  # paddle_tpu_torch.profiler installs its per-op hook


def maybe_cast_inputs(op_name, tensors):
    """The inputs of op `op_name`, cast per the active `auto_cast` (a
    list; non-tensors and integer tensors pass through).

    Every op of the port passes here once under the name the JAX
    package's tape dispatches it by (the library ops through
    `ops._dispatch.cast_in`, the functionals directly), so this is also
    where the profiler sees each dispatch."""
    if _profiler_hook[0] is not None:
        _profiler_hook[0](op_name)
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


class GradScaler:
    """Dynamic loss scaling (port of paddle_tpu's `amp.GradScaler`; the
    reference's amp/grad_scaler.py over check_finite_and_unscale and
    update_loss_scaling):

        scaler.scale(loss).backward()
        scaler.step(optimizer)       # unscale_, then step unless inf/nan
        scaler.update()              # move the scale

    `update` counts good and bad steps: `decr_every_n_nan_or_inf` bad
    ones in a row multiply the scale by `decr_ratio` (not below 1),
    `incr_every_n_steps` good ones in a row by `incr_ratio`."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = set()  # optimizer ids unscaled since last update()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def scale(self, loss):
        """`loss * scale` (the loss itself when disabled); a new
        iteration begins."""
        if not self._enable:
            return loss
        self._unscaled.clear()
        return loss * self._scale

    def unscale_(self, optimizer):
        """Multiply every gradient of `optimizer`'s parameters by 1/scale
        in fp32 (written back in the gradient's dtype) and note whether
        any is not finite: one fused launch per dtype, one device-to-host
        read for the whole set. A second call for the same optimizer
        before `update` does nothing."""
        if not self._enable or id(optimizer) in self._unscaled:
            return
        self._unscaled.add(id(optimizer))
        grads = [g for g in (_GRAD.__get__(p) for p in
                             (optimizer._parameter_list or []))
                 if g is not None]
        if not grads:
            self._found_inf = False
            return
        dev = grads[0].device
        found = torch.zeros((), dtype=torch.float32, device=dev)
        inv = torch.full((), 1.0 / self._scale, dtype=torch.float32,
                         device=dev)
        by_dtype = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for gs in by_dtype.values():
            torch._amp_foreach_non_finite_check_and_unscale_(gs, found, inv)
        self._found_inf = bool(found.item())

    def step(self, optimizer):
        """`unscale_`, then `optimizer.step()` unless a gradient was not
        finite."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def minimize(self, optimizer, scaled_loss):
        """`scaled_loss.backward()`, `step`, `update`."""
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        self._unscaled.clear()
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


def decorate(models=None, optimizers=None, level="O2", dtype=None,
             master_weight=None, save_dtype=None):
    """paddle's pure-fp16/bf16 decoration: every floating parameter of
    `models` cast to the AMP dtype (`dtype`, else the `amp_dtype` flag)
    in place, buffers untouched, and `_multi_precision` set on
    `optimizers`, which then update fp32 masters. Returns the model(s)
    and optimizer(s) in the form they came (a single object or a list);
    with no optimizers the model(s) alone, with no models the
    optimizer(s) alone."""
    dt = _dtype(dtype or get_flags("amp_dtype"))
    single_model = not isinstance(models, (list, tuple))
    ms = [models] if single_model else list(models)
    for m in ms:
        if m is None:
            continue
        for p in m.parameters():
            if p.is_floating_point() and p.dtype != dt:
                # the same Parameter object, so an optimizer built on the
                # model's parameters still holds them
                p.data = p.data.to(dt)
    if optimizers is not None:
        single_opt = not isinstance(optimizers, (list, tuple))
        opts = [optimizers] if single_opt else list(optimizers)
        for o in opts:
            o._multi_precision = True
        if models is None:
            return optimizers
        return (ms[0] if single_model else ms,
                opts[0] if single_opt else opts)
    return ms[0] if single_model else ms
