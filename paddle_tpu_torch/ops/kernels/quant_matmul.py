"""Dequant-inside-matmul for int8 PTQ weights (`quant/ptq.py` layout).

Port of paddle_tpu's `ops/pallas/quant_matmul.py`. A quantized decode
weight is an int8 ``[in, out]`` tensor plus a per-output-channel fp32
scale ``[out]`` (``w ~= q * scale``). The scale is constant along the
contraction axis, so it factors out of the dot product::

    x @ (q * scale) == (x @ q) * scale

and dequantization costs one multiply per output after the accumulate
instead of an fp32 copy of the weight.

`int8_weight_matmul(x [..., K] f32, w_q [K, N] int8, scale [N] f32)`
dispatches on the tensors' device: a CPU tensor takes the plain PyTorch
version (`int8_weight_matmul_reference`), a CUDA tensor launches the
hand-written Hopper kernels (`csrc/int8_weight_matmul.cu`: a CUDA-core
GEMV for M <= 8 rows, the tensor cores on an exact three-piece bf16 split
of x above) or raises. Where the M > 8 kernel splits K across CTAs, the
wrapper allocates its fp32 workspace (`torch.empty`).
``kernel="reference"`` forces the plain version (for tests and for
holding the kernel against it on the card).

`launches` counts the calls that launched the kernels (one per call,
the split-K sum included).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: Kernel launches made by `int8_weight_matmul` in this process.
launches = 0

_FN = None


def _kernel_fn():
    """(the C entry point, its workspace query), declared once."""
    global _FN
    if _FN is None:
        lib = _build.load("int8_weight_matmul")
        fn = lib.int8_weight_matmul_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ws = lib.int8_weight_matmul_workspace
        ws.argtypes = [ctypes.c_int] * 3
        ws.restype = ctypes.c_longlong
        _FN = fn, ws
    return _FN


def int8_weight_matmul_reference(x, w_q, scale):
    """The plain version: ``(x @ float(w_q)) * scale`` with an fp32
    accumulate."""
    return (x.float() @ w_q.float()) * scale


def _check(x, w_q, scale):
    what = "int8_weight_matmul"
    for name, t, dtype in (("x", x, torch.float32), ("w_q", w_q, torch.int8),
                           ("scale", scale, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
    if x.dim() < 1 or w_q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"{what}: want x [..., K], w_q [K, N], scale [N]; "
                         f"got {tuple(x.shape)}, {tuple(w_q.shape)}, "
                         f"{tuple(scale.shape)}")
    K, N = w_q.shape
    if x.shape[-1] != K or scale.shape[0] != N or K == 0:
        raise ValueError(f"{what}: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)} and scale {tuple(scale.shape)} "
                         f"do not match")
    if not (w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{what}: w_q and scale must be contiguous")


def _launch(x, w_q, scale):
    global launches
    _check(x, w_q, scale)
    K, N = w_q.shape
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M > 0:
        fn, ws_floats = _kernel_fn()
        with torch.cuda.device(x.device):
            n_ws = ws_floats(M, N, K)
            ws = torch.empty(n_ws, dtype=torch.float32, device=x.device) \
                if n_ws else None
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), None if ws is None else ws.data_ptr(),
                    M, N, K, stream)
        if rc != 0:
            raise RuntimeError(f"int8_weight_matmul kernel launch failed: "
                               f"cudaError {rc}")
        launches += 1
    return out.reshape(*x.shape[:-1], N)


def int8_weight_matmul(x, w_q, scale, kernel=None):
    """``(x @ w_q) * scale`` for x [..., K] fp32, w_q [K, N] int8, scale
    [N] fp32 -> [..., N] fp32.

    CPU tensors -> the plain PyTorch version; CUDA tensors -> the Hopper
    kernel, or an error. ``kernel="reference"`` forces the plain version
    on any device."""
    if kernel == "reference":
        return int8_weight_matmul_reference(x, w_q, scale)
    if kernel is not None:
        raise ValueError(f"kernel={kernel!r}: expected None or 'reference'")
    if x.device.type == "cpu":
        _check(x, w_q, scale)
        return int8_weight_matmul_reference(x, w_q, scale)
    if x.device.type == "cuda":
        return _launch(x, w_q, scale)
    raise ValueError(f"int8_weight_matmul: no kernel for device {x.device}")
