"""Serving-side post-training quantization for decode param dicts.

The port's own copy of paddle_tpu's `quant/ptq.py` (pure numpy). The
decode artifact (`save_for_decode`) stores a flat ``{name: array}`` dict.
Quantization keeps that shape: an eligible weight is replaced by its int8
tensor under the *original* key, and its per-output-channel fp32 scale
rides along under ``name + "::scale"``. `models.gpt._qmm` routes any
matmul whose weight has a ``::scale`` sibling through the int8-weight
matmul kernel (`ops.kernels.quant_matmul`).

Convention (symmetric, per-channel over the contraction axis)::

    scale = max(|w|, axis=-2) / 127          # shape [out] ([L, out] stacked)
    q     = clip(round(w / scale), -127, 127).astype(int8)
    w_hat = q * scale                        # |w - w_hat| <= scale / 2

Embedding tables (``wte.*`` / ``wpe.*``) and 1-D params (biases,
layernorm gains) stay fp32. In the scan-stacked layout every block param
carries a leading ``[L]`` axis, so "1-D" there means 2-D: only
``[L, in, out]`` matmul weights quantize, a ``[L, hidden]`` stacked
layernorm gain does not.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np

SCALE_SUFFIX = "::scale"

_FP32_PREFIXES = ("wte.", "wpe.")

# "blocks.0.attn.qkv.weight" is a per-layer key; "blocks.attn.qkv.weight"
# is the scan-stacked layout where EVERY block param carries a leading
# [L] axis — there a 2-D tensor is a stacked 1-D gain, not a matmul weight
_PER_LAYER_BLOCK = re.compile(r"blocks\.\d+\.")


def _eligible(name: str, v) -> bool:
    if not name.endswith(".weight") or name.startswith(_FP32_PREFIXES):
        return False
    ndim = getattr(np.asarray(v), "ndim", 0)
    stacked = name.startswith("blocks.") and not _PER_LAYER_BLOCK.match(name)
    return ndim >= (3 if stacked else 2)


def is_quantized(params: Dict[str, object]) -> bool:
    """True if ``params`` carries any ``::scale`` sibling keys."""
    return any(k.endswith(SCALE_SUFFIX) for k in params)


def quantize_params(params: Dict[str, object]) -> Dict[str, np.ndarray]:
    """Symmetric per-channel int8 PTQ of a flat decode param dict.

    Returns a new dict: eligible ``*.weight`` tensors become int8 under
    their original key plus an fp32 ``name::scale`` sibling (reduced over
    the contraction axis: ``[out]`` for 2-D weights, ``[L, out]`` for
    scan-stacked ``[L, in, out]`` weights); everything else passes
    through unchanged."""
    if is_quantized(params):
        raise ValueError("params already carry ::scale keys (double quantize)")
    out: Dict[str, np.ndarray] = {}
    for name, v in params.items():
        arr = np.asarray(v)
        if not _eligible(name, arr):
            out[name] = arr
            continue
        w = arr.astype(np.float32)
        scale = np.maximum(np.abs(w).max(axis=-2), 1e-8) / 127.0
        q = np.clip(np.rint(w / np.expand_dims(scale, -2)), -127, 127)
        out[name] = q.astype(np.int8)
        out[name + SCALE_SUFFIX] = scale.astype(np.float32)
    return out


def dequantize_params(params: Dict[str, object]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`quantize_params` (up to rounding error)."""
    out: Dict[str, np.ndarray] = {}
    for name, v in params.items():
        if name.endswith(SCALE_SUFFIX):
            continue
        scale = params.get(name + SCALE_SUFFIX)
        if scale is None:
            out[name] = np.asarray(v)
        else:
            out[name] = np.asarray(v).astype(np.float32) * np.expand_dims(
                np.asarray(scale, np.float32), -2)
    return out


__all__ = ["SCALE_SUFFIX", "is_quantized", "quantize_params",
           "dequantize_params"]
