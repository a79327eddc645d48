"""Serving-side quantization: int8 PTQ of decode weights (`ptq`) and int8
KV page pools (`kv`)."""
from .kv import (KV_DTYPES, dequantize_kv, kv_pool_zeros, quantize_kv,
                 validate_kv_dtype)
from .ptq import SCALE_SUFFIX, dequantize_params, is_quantized, \
    quantize_params

__all__ = ["KV_DTYPES", "SCALE_SUFFIX", "dequantize_kv", "dequantize_params",
           "is_quantized", "kv_pool_zeros", "quantize_kv", "quantize_params",
           "validate_kv_dtype"]
