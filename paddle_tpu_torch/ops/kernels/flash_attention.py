"""Flash attention (forward + backward) on [B, T, H, D].

Port of paddle_tpu's `ops/pallas/flash_attention.py`: softmax(scale *
q.k) . v, causal or full, with the backward recomputing the probabilities
from the saved per-row logsumexp instead of keeping the [T, T] matrix.

    q, k, v   [B, T, H, D]   fp32 or bf16 (the operand type)
    o         [B, T, H, D]   q's dtype
    lse       [B*H, T]       fp32, m + log(l) of each query row

Arithmetic, as in the TPU kernels: q is scaled in fp32 and rounded to the
operand type, scores accumulate in fp32, masked scores are -1e30, P (and
in the backward dS) is rounded to the operand type before its product, l
is clamped at 1e-30, delta = rowsum(dO * O) in fp32, dk = dS^T . q (q
carries the scale) and dq = (dS . k) * scale.

`flash_attention` is the differentiable entry (a `torch.autograd.Function`).
`flash_attention_forward` / `flash_attention_backward` are the two halves
without autograd, and the backward is `flash_attention_bwd_dq` then
`flash_attention_bwd_dkv`, one kernel each. All dispatch on the tensors'
device: a CPU tensor takes
the plain PyTorch versions (`*_reference` below), a CUDA tensor launches the
hand-written Hopper kernels or raises:

  * `csrc/flash_attention_fwd.cu`  — replaces `_fwd_kernel`;
  * `csrc/flash_attention_bwd.cu`  — `flash_attention_bwd_dq` then
    `flash_attention_bwd_dkv`, which replace `_bwd_dq_kernel`,
    `_bwd_dkv_kernel` and the fused `_bwd_dkv_kernel(emit_dq=True)`.

Each file has two routes, chosen by the operand type, which is the
arithmetic contract and not a fallback: fp32 runs fp32 FMAs on the CUDA
cores (exact fp32 products, the JAX package's 2e-5 / 5e-4 contract, which
TF32 tensor cores would break); bf16 runs every product on the tensor
cores by wgmma, its tiles loaded by TMA (bf16 operands, fp32
accumulators: the contract above). The bf16 route's tensor maps take
16-byte rows and strides, so `_tc_layout` hands it D % 8 == 0 (zero
columns padded on and cut off again: exact, and the scale stays the real
D's) and 16-byte aligned rows (misaligned operands are copied). Its dq
kernel also writes q_s = bf16(q * scale) [B, T, H, D], a scratch that the
dk/dv kernel streams instead of scaling q again at every visit:
`flash_attention_bwd_dq` returns it and `flash_attention_bwd_dkv` takes
it (`flash_attention_backward` passes it on and drops it).

``kernel="reference"`` forces the plain versions on any device (tests, and
holding the kernels against them on the card). The kernels read q, k, v in
place through their strides (the q/k/v chunks of a fused qkv projection
need no copy); `fwd_launches`, `dq_launches` and `bwd_launches` (the dk/dv
kernel) count the kernel launches made by this module.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30       # the JAX package's mask constant (_common.py NEG_INF)
MAX_HEAD_DIM = 128    # the kernels pad a head to 64 or 128 columns

#: Forward kernel launches made by this module in this process.
fwd_launches = 0
#: dq kernel launches (the first of the two backward kernels).
dq_launches = 0
#: dk/dv kernel launches (the second backward kernel).
bwd_launches = 0

_FNS = {}


def _kernel_fn(lib, name, n_ptr):
    """The C entry point `name` of csrc/<lib>.cu, built and loaded on first
    use: n_ptr pointers, then (B, n, H, D), (sb, st, sh), causal, scale,
    bf16 and the stream."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load(lib), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 \
            + [ctypes.c_longlong] * 3 \
            + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


# ---------------------------------------------------------- plain versions

def _scaled_q(q, scale):
    """q scaled in fp32 and rounded to its own dtype, returned as fp32."""
    return (q.float() * scale).to(q.dtype).float()


def _scores(qs, k, causal):
    """fp32 scores [B, H, Tq, Tk] of the scaled q against k, masked with
    -1e30 above the diagonal when causal."""
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    if causal:
        T = s.shape[-1]
        keep = torch.ones(T, T, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _rows(x, B, H, T):
    """A per-row [B*H, T] tensor as [B, H, T, 1]."""
    return x.reshape(B, H, T, 1)


def flash_attention_fwd_reference(q, k, v, causal=False, scale=None):
    """The plain forward: (o [B, T, H, D] in q's dtype, lse [B*H, T])."""
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    s = _scores(_scaled_q(q, scale), k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l)).reshape(B * H, T)


def flash_attention_bwd_dq_reference(q, k, v, o, do, lse, causal=False,
                                     scale=None):
    """The plain version of the dq kernel: (dq in q's dtype, delta
    [B*H, T] fp32 = rowsum(dO * O))."""
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1) \
        .reshape(B * H, T)
    s = _scores(_scaled_q(q, scale), k, causal)
    p = torch.exp(s - _rows(lse, B, H, T))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - _rows(delta, B, H, T))).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype), delta


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                      causal=False, scale=None):
    """The plain version of the dk/dv kernel: (dk, dv) in the input
    dtype, from lse and the delta of `flash_attention_bwd_dq_reference`."""
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    qs = _scaled_q(q, scale)
    s = _scores(qs, k, causal)
    p = torch.exp(s - _rows(lse, B, H, T))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - _rows(delta, B, H, T))).to(q.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return dk.to(q.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernels

def _check(q, k, v):
    """The CUDA kernels' contract; raises on what they do not take.
    Returns (q, k, v) sharing one set of strides with a unit last stride
    (copies only when the three differ in layout)."""
    what = "flash_attention"
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on {q.device}")
        if t.shape != q.shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} does not "
                             f"match q {tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"{what}: want [B, T, H, D], got {tuple(q.shape)}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head_dim {q.shape[-1]} > {MAX_HEAD_DIM}")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError(f"{what}: batch x heads {q.shape[0] * q.shape[2]} "
                         f"> 65535")
    if q.stride(-1) != 1 or not (q.stride() == k.stride() == v.stride()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


def _aligned(t):
    """Rows of `t` are whole 16-byte chunks at 16-byte aligned addresses
    (strides in elements, bf16 = 2 bytes)."""
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0
                                          for st in t.stride()[:-1])


def _pad_d(t, width):
    """`t` [..., D] with zero columns up to `width`."""
    if t.shape[-1] == width:
        return t
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def _tc_layout(q, k, v, like_q=()):
    """The bf16 route's operands: q, k, v (sharing strides) and the
    contiguous `like_q` tensors with D zero-padded to a multiple of 8 and
    16-byte aligned rows, copying only what is misaligned. Zero columns
    add nothing to the scores and their output columns are cut off, so
    with the real D's scale the result is the same function."""
    width = -(-q.shape[-1] // 8) * 8
    q, k, v = (_pad_d(t, width) for t in (q, k, v))
    if not all(_aligned(t) for t in (q, k, v)):
        q, k, v = (t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    like_q = [_pad_d(t, width) for t in like_q]
    like_q = [t if t.is_contiguous() and _aligned(t)
              else t.clone(memory_format=torch.contiguous_format)
              for t in like_q]
    return q, k, v, like_q


def _cut_d(t, D):
    """A kernel output back to the caller's head width."""
    return t if t.shape[-1] == D else t[..., :D].contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _work_counter(t):
    """A zeroed int32 in device memory from which a persistent bf16
    kernel's CTAs take their work tiles."""
    return torch.zeros(1, dtype=torch.int32, device=t.device)


def _launch_fwd(q, k, v, causal, scale):
    global fwd_launches
    q, k, v = _check(q, k, v)
    d_in = q.shape[-1]
    if q.dtype == torch.bfloat16:
        q, k, v, _ = _tc_layout(q, k, v)
    B, T, H, D = q.shape
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return _cut_d(o, d_in), lse
    fn = _kernel_fn("flash_attention_fwd", "flash_attention_fwd", 6)
    sb, st, sh, _ = q.stride()
    bf16 = q.dtype == torch.bfloat16
    counter = _work_counter(q) if bf16 else None
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), counter.data_ptr() if bf16 else None, B, T,
                H, D, sb, st, sh, int(causal), scale, int(bf16), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: "
                           f"cudaError {rc}")
    fwd_launches += 1
    return _cut_d(o, d_in), lse


def _bwd_operands(q, k, v, like_q, per_row):
    """The backward kernels' contract on top of `_check`: the tensors of
    `like_q` (dO, O) contiguous [B, T, H, D] in q's dtype, those of
    `per_row` (lse, delta) contiguous [B*H, T] fp32; bf16 operands laid
    out by `_tc_layout`. Returns (q, k, v, like_q, per_row, the kernels'
    shape arguments)."""
    q, k, v = _check(q, k, v)
    B, T, H, _ = q.shape
    like_q = [t.to(q.dtype).contiguous() for t in like_q]
    # contiguous fp32 on 16-byte aligned bases (the dk/dv kernel's TMA)
    per_row = [t.float().contiguous() for t in per_row]
    per_row = [t if t.data_ptr() % 16 == 0 else t.clone() for t in per_row]
    for t, want in [(t, q.shape) for t in like_q] \
            + [(t, (B * H, T)) for t in per_row]:
        if t.shape != want or t.device != q.device:
            raise ValueError(f"flash_attention backward: an operand is "
                             f"{tuple(t.shape)} on {t.device}, want "
                             f"{tuple(want)} on {q.device} for q "
                             f"{tuple(q.shape)}")
    if q.dtype == torch.bfloat16:
        q, k, v, like_q = _tc_layout(q, k, v, like_q)
    sb, st, sh, _ = q.stride()
    return q, k, v, like_q, per_row, (B, T, H, q.shape[-1], sb, st, sh)


def _launch_bwd_dq(q, k, v, o, do, lse, causal, scale):
    global dq_launches
    d_in = q.shape[-1]
    q, k, v, (o, do), (lse,), shape = _bwd_operands(q, k, v, (o, do), (lse,))
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    delta = torch.empty_like(lse)
    bf16 = q.dtype == torch.bfloat16
    q_s = torch.empty_like(dq) if bf16 else None
    if dq.numel() == 0:
        return _cut_d(dq, d_in), delta, q_s
    fn = _kernel_fn("flash_attention_bwd", "flash_attention_bwd_dq", 9)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), q_s.data_ptr() if bf16 else None, *shape,
                int(causal), scale, int(bf16), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_dq kernel launch failed: "
                           f"cudaError {rc}")
    dq_launches += 1
    return _cut_d(dq, d_in), delta, q_s


def _launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale, q_s):
    global bwd_launches
    d_in = q.shape[-1]
    q, k, v, (do,), (lse, delta), shape = _bwd_operands(q, k, v, (do,),
                                                        (lse, delta))
    bf16 = q.dtype == torch.bfloat16
    if bf16 and (q_s is None or q_s.shape != q.shape or q_s.dtype != q.dtype
                 or q_s.device != q.device or not q_s.is_contiguous()
                 or not _aligned(q_s)):
        raise ValueError(
            "flash_attention_bwd_dkv: the bf16 kernel streams the q_s that "
            "flash_attention_bwd_dq returned (contiguous, "
            f"{tuple(q.shape)} {q.dtype} on {q.device}); got "
            f"{None if q_s is None else (tuple(q_s.shape), q_s.dtype)}")
    dk = torch.empty_like(q, memory_format=torch.contiguous_format)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return _cut_d(dk, d_in), _cut_d(dv, d_in)
    fn = _kernel_fn("flash_attention_bwd", "flash_attention_bwd_dkv", 9)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), q_s.data_ptr() if bf16 else None, *shape,
                int(causal), scale, int(bf16), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv kernel launch failed: "
                           f"cudaError {rc}")
    bwd_launches += 1
    return _cut_d(dk, d_in), _cut_d(dv, d_in)


# ---------------------------------------------------------------- entries

def _plain(kernel, q):
    """True when the plain versions run: ``kernel="reference"`` or a CPU
    tensor. A CUDA tensor runs the kernels; any other device raises."""
    if kernel == "reference":
        return True
    if kernel is not None:
        raise ValueError(f"kernel={kernel!r}: expected None or 'reference'")
    if q.device.type == "cpu":
        return True
    if q.device.type == "cuda":
        return False
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def flash_attention_forward(q, k, v, causal=False, scale=None, kernel=None):
    """(o, lse) without autograd; dispatch as the module docstring says."""
    scale = _scale(q, scale)
    if _plain(kernel, q):
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    return _launch_fwd(q, k, v, causal, scale)


def flash_attention_bwd_dq(q, k, v, o, do, lse, causal=False, scale=None,
                           kernel=None):
    """The first backward kernel: (dq, delta = rowsum(dO * O) [B*H, T],
    q_s), same dispatch as `flash_attention_forward`. q_s = bf16(q *
    scale) [B, T, H, D'] (D' = D rounded up to 8) is the bf16 kernel's
    scratch for `flash_attention_bwd_dkv`; None from the fp32 kernels and
    the plain versions, which scale q themselves."""
    scale = _scale(q, scale)
    if _plain(kernel, q):
        return flash_attention_bwd_dq_reference(q, k, v, o, do, lse, causal,
                                                scale) + (None,)
    return _launch_bwd_dq(q, k, v, o, do, lse, causal, scale)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            scale=None, kernel=None, q_s=None):
    """The second backward kernel: (dk, dv) from lse and the delta of
    `flash_attention_bwd_dq`; same dispatch. The bf16 kernel reads the
    q_s that `flash_attention_bwd_dq` returned and raises without it."""
    scale = _scale(q, scale)
    if _plain(kernel, q):
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 causal, scale)
    return _launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale, q_s)


def flash_attention_backward(q, k, v, o, lse, do, causal=False, scale=None,
                             kernel=None):
    """(dq, dk, dv) from the forward's (o, lse) and the output gradient
    dO, without autograd: the dq kernel, then the dk/dv kernel (the q_s
    scratch lives from one to the other)."""
    dq, delta, q_s = flash_attention_bwd_dq(q, k, v, o, do, lse, causal,
                                            scale, kernel)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                                     kernel, q_s)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Saves (q, k, v, o, lse) — never the [T, T] probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kernel):
        o, lse = flash_attention_forward(q, k, v, causal, scale, kernel)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.kernel = causal, scale, kernel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              ctx.causal, ctx.scale,
                                              ctx.kernel)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, kernel=None):
    """q, k, v [B, T, H, D] -> o [B, T, H, D] (the JAX package's
    `flash_attention`), differentiable in q, k and v. CPU tensors -> the
    plain versions; CUDA tensors -> the Hopper kernels or an error."""
    return _FlashAttention.apply(q, k, v, bool(causal), _scale(q, scale),
                                 kernel)


__all__ = ["flash_attention", "flash_attention_forward",
           "flash_attention_backward", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_fwd_reference",
           "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv_reference", "NEG_INF", "MAX_HEAD_DIM"]
