"""Int8 KV page pools for the paged decode engine.

Port of paddle_tpu's `quant/kv.py` on tensors. An fp32 pool is a bare
``[layers, pages, page_tokens, heads, head_dim]`` tensor; the int8 pool is
the pair ``(data int8, scale f32)`` where the scale drops the trailing
``head_dim`` axis — one symmetric scale per (layer, page, token row,
head). Per-row scales mean a freshly written token never forces its page
to be requantized, and a copy-on-write page copy is a copy of both
tensors. Every pool consumer (`memory.page_allocator`'s pool ops, the
decode fns in `models.gpt`, the engine) branches on the pair.

Bytes per element: 1 (int8) + 4 / head_dim (the amortized scale) against
4 for fp32 — 3.76x fewer at head_dim 64.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

KV_DTYPES = ("float32", "int8")

PoolLike = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def validate_kv_dtype(kv_dtype) -> str:
    """Normalize/validate a pool-dtype knob value ('' -> float32)."""
    s = str(kv_dtype or "float32").strip().lower()
    if s in ("float32", "fp32", "f32"):
        return "float32"
    if s == "int8":
        return "int8"
    raise ValueError(f"kv_dtype {kv_dtype!r}: expected one of {KV_DTYPES}")


def quantize_kv(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(row, head) symmetric int8: ``[..., D] f32 -> (int8 [..., D],
    f32 scale [...])`` with ``scale = max(|row|) / 127`` (floored so an
    all-zero row quantizes to zeros, not NaNs). `torch.round` rounds half
    to even, as `jnp.round` does."""
    rows = rows.float()
    scale = torch.clamp(rows.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(rows / scale[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_kv(data: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: ``q * scale`` broadcast over D."""
    return data.float() * scale[..., None]


def kv_pool_zeros(shape: Sequence[int], kv_dtype: str = "float32",
                  device=None) -> PoolLike:
    """Zero pool for ``shape`` = [L, P, pt, nh, D] on `device`: an fp32
    tensor, or for int8 the ``(data int8 [L,P,pt,nh,D], scale f32
    [L,P,pt,nh])`` pair."""
    shape = tuple(int(s) for s in shape)
    if validate_kv_dtype(kv_dtype) == "int8":
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return torch.zeros(shape, dtype=torch.float32, device=device)


__all__ = ["KV_DTYPES", "validate_kv_dtype", "quantize_kv", "dequantize_kv",
           "kv_pool_zeros"]
