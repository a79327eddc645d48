"""max_pool2d / avg_pool2d / adaptive_avg_pool2d (port of paddle_tpu's
`nn/functional/pooling.py`).

The JAX package pools with `lax.reduce_window` over explicitly padded
windows; this port keeps its rules:

  * padding takes the conv forms (an int, per-dim ints, pairs, "SAME" /
    "VALID"); max pooling pads with -inf, average pooling with 0;
  * `ceil_mode` adds stride - rem to the end pad of a dim whose padded
    size leaves a remainder rem (`_ceil_pads`), and keeps every window,
    also one that starts in the end padding (torch's own ceil_mode drops
    such a window, so it is never used here);
  * average pooling divides by `divisor_override` when given, else with
    `exclusive` and any padding (a string padding, or a non-zero pad,
    ceil_mode's included) by the count of in-bounds elements of each
    window, else by the kernel's size;
  * `return_mask=True` returns (out, None), as the JAX function does.

Where torch's own padding computes the same windows (a symmetric pad of
at most half the kernel, no ceil_mode) the pad is the pooling call's;
otherwise it is an explicit `F.pad`. Adaptive bins run from
floor(i * n / o) to ceil((i + 1) * n / o), torch's bins and the JAX
package's. NHWC runs on a permuted view. Dispatch names: "pool" and
"adaptive_pool", on neither AMP list (bf16 under O2).
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...amp import maybe_cast_inputs
from .conv import _tuplize, flat_pad, resolve_pads

__all__ = ["max_pool2d", "avg_pool2d", "adaptive_avg_pool2d"]


def _nchw(x, data_format):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"pool data_format {data_format!r}: want NCHW or "
                         f"NHWC")
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _back(out, data_format):
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def _windows(a, kernel_size, stride, padding, ceil_mode):
    """(kernel, stride, pads) of a pooling over NCHW `a`: the JAX
    package's pads, ceil_mode's end pad added."""
    kernel = _tuplize(kernel_size, 2)
    stride = _tuplize(stride if stride is not None else kernel_size, 2)
    pads = resolve_pads(padding, a.shape[2:], kernel, stride)
    if ceil_mode and not isinstance(padding, str):
        grown = []
        for (lo, hi), size, k, s in zip(pads, a.shape[2:], kernel, stride):
            rem = (size + lo + hi - k) % s
            grown.append((lo, hi + (s - rem if rem else 0)))
        pads = grown
    return kernel, stride, pads


def _own_pad(pads, kernel, ceil_mode):
    """The pads as torch's pooling padding when torch computes the same
    windows with it (symmetric, at most half the kernel, no ceil_mode),
    else None."""
    if ceil_mode or any(lo != hi or 2 * lo > k
                        for (lo, hi), k in zip(pads, kernel)):
        return None
    return tuple(lo for lo, _ in pads)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW"):
    (a,) = maybe_cast_inputs("pool", (x,))
    a = _nchw(a, data_format)
    kernel, stride, pads = _windows(a, kernel_size, stride, padding,
                                    ceil_mode)
    own = _own_pad(pads, kernel, ceil_mode)
    if own is None:
        a = TF.pad(a, flat_pad(pads), value=float("-inf"))
        own = 0
    out = _back(TF.max_pool2d(a, kernel, stride, own), data_format)
    return (out, None) if return_mask else out


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    (a,) = maybe_cast_inputs("pool", (x,))
    a = _nchw(a, data_format)
    kernel, stride, pads = _windows(a, kernel_size, stride, padding,
                                    ceil_mode)
    padded = isinstance(padding, str) or any(p != (0, 0) for p in pads)
    own = _own_pad(pads, kernel, ceil_mode)
    if divisor_override:
        out = _window_sum(a, kernel, stride, pads, own) / divisor_override
    elif own is not None:
        # torch's count_include_pad=False divides by the in-bounds count
        out = TF.avg_pool2d(a, kernel, stride, own,
                            count_include_pad=not exclusive)
    elif exclusive and padded:
        ones = torch.ones((1, 1) + tuple(a.shape[2:]), dtype=a.dtype,
                          device=a.device)
        out = _window_sum(a, kernel, stride, pads, None) \
            / _window_sum(ones, kernel, stride, pads, None)
    else:
        out = _window_sum(a, kernel, stride, pads, None) \
            / float(kernel[0] * kernel[1])
    return _back(out, data_format)


def _window_sum(a, kernel, stride, pads, own):
    """The sum over each window of `a` zero-padded by `pads`."""
    if own is None:
        a, own = TF.pad(a, flat_pad(pads)), 0
    return TF.avg_pool2d(a, kernel, stride, own, count_include_pad=True,
                         divisor_override=1)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    (a,) = maybe_cast_inputs("adaptive_pool", (x,))
    a = _nchw(a, data_format)
    size = (output_size, output_size) if isinstance(output_size, int) \
        else tuple(output_size)
    size = tuple(a.shape[2 + i] if s is None else int(s)
                 for i, s in enumerate(size))
    return _back(TF.adaptive_avg_pool2d(a, size), data_format)
