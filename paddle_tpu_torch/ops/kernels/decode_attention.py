"""Single-token (q_len == 1) paged decode attention.

Port of the paged half of paddle_tpu's `ops/pallas/decode_attention.py`.
Every decode step of the engine attends one fresh query row per sequence
against that sequence's cached K/V, which lives in a shared page pool
addressed through a per-sequence block table:

    q        [B, H, D]          fresh query row per sequence (fp32)
    k_pool   [P, pt, H, D]      one layer's page pool (pt = page tokens)
    v_pool   [P, pt, H, D]
    tables   [B, W] int32       tables[b, w] = page holding rows
                                [w*pt, (w+1)*pt) of sequence b; unused
                                entries point at the null page 0
    lengths  [B] int32          valid prefix per sequence, 1..W*pt
    out      [B, H, D]

`paged_decode_attention` dispatches on the tensors' device: a CPU tensor
takes the plain PyTorch version (`paged_decode_attention_reference`), a
CUDA tensor launches the hand-written Hopper kernel
(`csrc/paged_decode_attention.cu`) or raises. ``kernel="reference"``
forces the plain version (for tests and for holding the kernel against
it on the card).

`launches` counts kernel launches made by this module, so a run can show
that its decode path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30       # the JAX package's mask constant (_common.py NEG_INF)
MAX_HEAD_DIM = 128    # the kernel keeps up to 4 floats of a row per lane

#: Kernel launches made by `paged_decode_attention` in this process.
launches = 0

_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("paged_decode_attention").paged_decode_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def decode_attention_reference(q, k, v, lengths):
    """Masked softmax(q.k/sqrt(D)).v over contiguous cache rows
    k, v [B, cap, H, D] (rows >= length masked with -1e30)."""
    B, cap, H, D = k.shape
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhd,bkhd->bhk", q, k) * scale
    s = s.float()
    live = torch.arange(cap, device=k.device)[None, None, :] \
        < lengths.to(k.device, torch.long)[:, None, None]
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhk,bkhd->bhd", p, v)
    return o.to(q.dtype)


def paged_decode_attention_reference(q, k_pool, v_pool, tables, lengths):
    """The plain version: gather the table's pages into a contiguous
    [B, W*pt, H, D] panel, then the masked softmax of
    `decode_attention_reference`."""
    B, W = tables.shape
    P, pt, H, D = k_pool.shape
    idx = tables.to(k_pool.device, torch.long)
    k = k_pool[idx].reshape(B, W * pt, H, D)
    v = v_pool[idx].reshape(B, W * pt, H, D)
    return decode_attention_reference(q, k, v, lengths)


def _check(q, k_pool, v_pool, tables, lengths):
    dev = q.device
    for name, t, dtype, ndim in (("q", q, torch.float32, 3),
                                 ("k_pool", k_pool, torch.float32, 4),
                                 ("v_pool", v_pool, torch.float32, 4),
                                 ("tables", tables, torch.int32, 2),
                                 ("lengths", lengths, torch.int32, 1)):
        if t.device != dev:
            raise ValueError(f"paged_decode_attention: {name} on {t.device}, "
                             f"q on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"paged_decode_attention: {name} must be "
                            f"{dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"paged_decode_attention: {name} must have "
                             f"{ndim} dims, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"contiguous")
    B, H, D = q.shape
    if k_pool.shape != v_pool.shape or k_pool.shape[2:] != (H, D):
        raise ValueError(f"paged_decode_attention: pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if tables.shape[0] != B or lengths.shape[0] != B:
        raise ValueError(f"paged_decode_attention: tables "
                         f"{tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")
    if D > MAX_HEAD_DIM or D % 2:
        raise ValueError(f"paged_decode_attention: head_dim {D} must be "
                         f"even and <= {MAX_HEAD_DIM}")


def _launch(q, k_pool, v_pool, tables, lengths):
    global launches
    _check(q, k_pool, v_pool, tables, lengths)
    B, H, D = q.shape
    pt = k_pool.shape[1]
    W = tables.shape[1]
    out = torch.empty_like(q)
    if B == 0 or H == 0 or W == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                B, H, D, pt, W, 1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, tables, lengths, kernel=None):
    """Paged decode attention (see module docstring for shapes).

    CPU tensors -> the plain PyTorch version; CUDA tensors -> the Hopper
    kernel, or an error. ``kernel="reference"`` forces the plain version
    on any device."""
    if kernel == "reference":
        return paged_decode_attention_reference(q, k_pool, v_pool,
                                                tables, lengths)
    if kernel is not None:
        raise ValueError(f"kernel={kernel!r}: expected None or 'reference'")
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pool, v_pool,
                                                tables, lengths)
    if q.device.type == "cuda":
        return _launch(q, k_pool, v_pool, tables, lengths)
    raise ValueError(f"paged_decode_attention: no kernel for device "
                     f"{q.device}")
