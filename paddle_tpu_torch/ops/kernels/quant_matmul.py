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
hand-written Hopper kernels (`csrc/int8_weight_matmul.cu`, both on the
tensor cores over an exact three-piece bf16 split of x) or raises. For M
<= 8 rows the GEMV splits K over a thread-block cluster and sums the
ranges in shared memory (`gemv_geometry` gives its launch, a function of
(M, N, K) alone); above, where the tiled kernel splits K across CTAs,
the wrapper allocates its fp32 workspace (`torch.empty`).
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

# the M <= 8 GEMV's launch (csrc/int8_weight_matmul.cu `gemv_plan`,
# mirrored here)
GEMV_M = 8                  # kGemvM: most rows of x it takes
GEMV_WARPS = 4              # kGemvWarps: warps per CTA, 16 columns each
GEMV_MAX_SPLIT = 8          # kGemvMaxSplit: CTAs of a cluster (K ranges)
GEMV_TARGET_CTAS = 264      # kGemvTargetCtas: two CTAs on each of 132 SMs
GEMV_STEP = 16              # kStep: k of one mma
# k steps staged at once, by strip width: the boxes stay within 48 KB
GEMV_MAX_PASS = {16: 32, 32: 16, 64: 16}
GEMV_X_STEP_BYTES = GEMV_M * 16 * 4  # kXStepBytes: a step's box of x
GEMV_BOX_ALIGN = 1024               # kBoxAlign: slack to align the boxes

_FN = None
_GEOM = None


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


def _geometry_fn():
    """The kernel library's own `int8_gemv_geometry` export (for checking
    `gemv_geometry` against it on the card)."""
    global _GEOM
    if _GEOM is None:
        fn = _build.load("int8_weight_matmul").int8_gemv_geometry
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _GEOM = fn
    return _GEOM


def gemv_geometry(M, N, K):
    """The M <= 8 GEMV's launch for static shapes: grid (split, strips) in
    clusters of (split, 1, 1), the threads of a CTA, its dynamic shared
    memory, the columns of out a CTA owns (`strip`: the widest of 64, 32,
    16 that keeps GEMV_TARGET_CTAS CTAs), the 16-deep k steps of each of
    the `split` K ranges, the k steps staged at once, and the workspace
    (none: the cluster sums its ranges in shared memory). Raises
    ValueError for shapes the GEMV does not take; mirrors
    csrc/int8_weight_matmul.cu `gemv_plan`."""
    if not 0 < M <= GEMV_M or N <= 0 or K <= 0:
        raise ValueError(f"int8_weight_matmul GEMV: M={M}, N={N}, K={K} "
                         f"out of its range (1 <= M <= {GEMV_M})")
    steps = -(-K // GEMV_STEP)
    strip = next((w for w in (64, 32) if -(-N // w) * GEMV_MAX_SPLIT
                  >= GEMV_TARGET_CTAS), 16)
    strips = -(-N // strip)
    if strips > 65535:
        raise ValueError(f"int8_weight_matmul GEMV: N={N} is too wide")
    split = min(GEMV_MAX_SPLIT, -(-GEMV_TARGET_CTAS // strips), steps)
    chunk = -(-steps // split)
    pass_steps = min(chunk, GEMV_MAX_PASS[strip])
    box_rows = min(pass_steps * GEMV_STEP, 256)
    wrows = -(-pass_steps * GEMV_STEP // box_rows) * box_rows
    return {"grid": (split, strips, 1), "cluster": (split, 1, 1),
            "threads": 32 * GEMV_WARPS,
            "smem_bytes": wrows * strip + pass_steps * GEMV_X_STEP_BYTES
            + GEMV_BOX_ALIGN,
            "strip": strip, "k_steps": chunk, "pass_steps": pass_steps,
            "workspace_bytes": 0}


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
