"""Fused linear + softmax cross-entropy: the tied LM head's per-row loss
without the [N, V] logits.

Port of paddle_tpu's `ops/pallas/fused_ce.py`:

    loss[i] = lse[i] - lab[i],  lse = logsumexp(x[i] . W^T),
                                lab = (x[i] . W^T)[labels[i]]
    x [N, H], W [V, H] (fp32 or bf16, one type), labels [N] (int64 here)

The forward keeps (x, W, labels, lse) for the backward and never the
logits; the backward recomputes each block of them:

    dlg = round((softmax - onehot) * g)  in the operand type
    dx  = dlg . W   (x's type)           dW = dlg^T . x   (W's type)

Arithmetic, as in the TPU kernels: logits in fp32 from the operands in
their own type (bf16 products are exact in fp32), vocab columns at or past
V masked to -1e30, l clamped at 1e-30 before the log, dlg rounded to the
operand type before its products.

Each of the three functions dispatches on the tensors' device: a CPU tensor
takes the plain PyTorch version (`*_reference` below, written after the
JAX package's `_xla_fwd` / `_xla_bwd`), a CUDA tensor launches the
hand-written Hopper kernel or raises:

  * `csrc/fused_linear_ce_fwd.cu` (`fused_ce_forward`) — replaces
    `_fwd_kernel`: bf16 on the tensor cores (a GEMM with an online-
    logsumexp epilogue over vocabulary chunks, combined by a second small
    kernel), fp32 on the CUDA cores;
  * `csrc/fused_linear_ce_bwd.cu` (`fused_ce_bwd_dx`, `fused_ce_bwd_dw`) —
    replace `_bwd_dx_kernel` and `_bwd_dw_kernel`: bf16 on the tensor
    cores (a cluster of CTAs splits H), fp32 on the CUDA cores.

``kernel="reference"`` forces the plain versions on any device (tests, and
holding the kernels against them on the card). The kernels take any N and
V, and any H up to `max_hidden(dtype)` (above it they raise). The bf16
kernels take H in whole 16-byte chunks at 16-byte aligned addresses:
the wrapper zero-pads H to a multiple of 8 (exact: zero columns add
nothing to the logits, and the gradient's extra columns are cut off) and
copies a misaligned operand. The bf16 forward's per-chunk partials go to
a small fp32 scratch the wrapper allocates. `fwd_launches`, `dx_launches`
and `dw_launches` count the calls that launched each kernel (one per
call).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30       # the JAX package's mask constant (_common.py NEG_INF)

#: Forward kernel launches made by this module in this process.
fwd_launches = 0
#: dx kernel launches.
dx_launches = 0
#: dW kernel launches.
dw_launches = 0

# the fp32 (SIMT) kernels' shape (csrc/fused_linear_ce_common.cuh):
# resident rows per CTA, streamed rows per tile, shared memory per CTA
_RESIDENT_ROWS = 8
_STREAM_ROWS = 32
_SMEM_LIMIT = 232448
# the bf16 backward (csrc/fused_linear_ce_bwd.cu `lce_bwd_mma_kernel`): H
# columns per CTA of a cluster, CTAs per cluster at most
_TC_SLICE = 512
_TC_MAX_CLUSTER = 8

_FNS = {}


def max_hidden(dtype) -> int:
    """The largest H all three kernels take for operands of `dtype`: in
    bf16 the backward's cluster of at most 8 CTAs of 512 columns (4096;
    the forward streams H); in fp32 the forward's R resident rows in one
    CTA's shared memory and the backward's R rows and their fp32 [R, H]
    accumulator there (3616)."""
    if dtype == torch.bfloat16:
        return _TC_SLICE * _TC_MAX_CLUSTER
    r = _RESIDENT_ROWS
    fwd = (_SMEM_LIMIT - 4 * _STREAM_ROWS * (r + 1)) // (r * 4)
    bwd = (_SMEM_LIMIT - 4 * _STREAM_ROWS * r) // (r * 8)
    return min(fwd, bwd) // 8 * 8


def _kernel_fn(lib, name, n_ptr):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load(lib), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _fwd_scratch_fn():
    """The forward's scratch query: floats for (N, V, bf16)."""
    fn = _FNS.get("scratch")
    if fn is None:
        fn = _build.load("fused_linear_ce_fwd").fused_linear_ce_fwd_scratch
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_longlong
        _FNS["scratch"] = fn
    return fn


# ---------------------------------------------------------- plain versions

def _logits(x, w):
    """fp32 [N, V] logits of x . w^T (fp32 products of the operands'
    values: exact for bf16 operands)."""
    return torch.matmul(x.float(), w.float().t())


def fused_ce_fwd_reference(x, w, labels):
    """The plain forward (`_xla_fwd`): (lse [N], lab [N]), fp32."""
    lg = _logits(x, w)
    m = lg.amax(dim=1)
    l = torch.exp(lg - m[:, None]).sum(dim=1)
    lse = m + torch.log(l.clamp_min(1e-30))
    lab = lg.gather(1, labels.long()[:, None])[:, 0]
    return lse, lab


def dlogits_reference(x, w, labels, lse, g):
    """dlg = (softmax - onehot) * g [N, V], rounded to x's type (`_xla_bwd`
    before its products)."""
    p = torch.exp(_logits(x, w) - lse.float()[:, None])
    p[torch.arange(p.shape[0], device=p.device), labels.long()] -= 1.0
    return (p * g.float()[:, None]).to(x.dtype)


def fused_ce_bwd_dx_reference(x, w, labels, lse, g):
    """The plain dx: dlg . W accumulated in fp32, in x's type."""
    dlg = dlogits_reference(x, w, labels, lse, g)
    return torch.matmul(dlg.float(), w.float()).to(x.dtype)


def fused_ce_bwd_dw_reference(x, w, labels, lse, g):
    """The plain dW: dlg^T . x accumulated in fp32, in W's type."""
    dlg = dlogits_reference(x, w, labels, lse, g)
    return torch.matmul(dlg.float().t(), x.float()).to(w.dtype)


# ---------------------------------------------------------------- kernels

def _check(x, w, labels, per_row=()):
    """The CUDA kernels' contract; raises on what they do not take.
    Returns (x, w, labels int64, per-row fp32 tensors), all contiguous."""
    what = "fused linear cross-entropy"
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"{what}: want x [N, H] and w [V, H], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: the kernels take x and w both float32 or "
                        f"both bfloat16, got {x.dtype} and {w.dtype}")
    N, H = x.shape
    if H > max_hidden(x.dtype):
        raise ValueError(f"{what}: H = {H} > {max_hidden(x.dtype)}, the "
                         f"kernels' shared-memory limit for {x.dtype}")
    if max(N, w.shape[0], H) >= 2 ** 31:
        raise ValueError(f"{what}: a dimension of {N, w.shape[0], H} does "
                         f"not fit an int")
    tensors = [labels] + list(per_row)
    for t in [w] + tensors:
        if t.device != x.device:
            raise ValueError(f"{what}: an operand on {t.device}, x on "
                             f"{x.device}")
    for t in tensors:
        if tuple(t.shape) != (N,):
            raise ValueError(f"{what}: a per-row operand is "
                             f"{tuple(t.shape)}, want ({N},)")
    return (x.contiguous(), w.contiguous(), labels.long().contiguous(),
            [t.float().contiguous() for t in per_row])


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _tc_operands(x, w):
    """The bf16 kernels' operands: x and w with H zero-padded to a
    multiple of 8 and 16-byte aligned bases, copying only what needs it."""
    H = x.shape[1]
    width = -(-H // 8) * 8
    if width != H:
        x, w = (torch.nn.functional.pad(t, (0, width - H)) for t in (x, w))
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, w))


def _launch_fwd(x, w, labels):
    global fwd_launches
    x, w, labels, _ = _check(x, w, labels)
    N, V = x.shape[0], w.shape[0]
    lse = torch.empty(N, dtype=torch.float32, device=x.device)
    lab = torch.empty_like(lse)
    if N == 0:
        return lse, lab
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        x, w = _tc_operands(x, w)
    fn = _kernel_fn("fused_linear_ce_fwd", "fused_linear_ce_fwd", 6)
    with torch.cuda.device(x.device):
        n_scratch = _fwd_scratch_fn()(N, V, int(bf16))
        scratch = torch.empty(n_scratch, dtype=torch.float32,
                              device=x.device) if n_scratch else None
        rc = fn(x.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                lab.data_ptr(),
                None if scratch is None else scratch.data_ptr(), N, V,
                x.shape[1], int(bf16), _stream(x))
    if rc != 0:
        raise RuntimeError(f"fused_linear_ce_fwd kernel launch failed: "
                           f"cudaError {rc}")
    fwd_launches += 1
    return lse, lab


def _launch_bwd(which, x, w, labels, lse, g):
    global dx_launches, dw_launches
    x, w, labels, (lse, g) = _check(x, w, labels, (lse, g))
    N, H = x.shape
    if N == 0 or w.shape[0] == 0 or H == 0:
        return torch.zeros_like(x if which == "dx" else w)
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        x, w = _tc_operands(x, w)
    out = torch.empty_like(x if which == "dx" else w)
    name = f"fused_linear_ce_bwd_{which}"
    fn = _kernel_fn("fused_linear_ce_bwd", name, 6)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                g.data_ptr(), out.data_ptr(), N, w.shape[0], x.shape[1],
                int(bf16), _stream(x))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    if which == "dx":
        dx_launches += 1
    else:
        dw_launches += 1
    return out if out.shape[1] == H else out[:, :H].contiguous()


# ---------------------------------------------------------------- entries

def _plain(kernel, x):
    """True when the plain versions run: ``kernel="reference"`` or a CPU
    tensor. A CUDA tensor runs the kernels; any other device raises."""
    if kernel == "reference":
        return True
    if kernel is not None:
        raise ValueError(f"kernel={kernel!r}: expected None or 'reference'")
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"fused linear cross-entropy: no kernel for device "
                     f"{x.device}")


def fused_ce_forward(x, w, labels, kernel=None):
    """(lse, lab), each [N] fp32, without autograd; dispatch as the module
    docstring says."""
    if _plain(kernel, x):
        return fused_ce_fwd_reference(x, w, labels)
    return _launch_fwd(x, w, labels)


def fused_ce_bwd_dx(x, w, labels, lse, g, kernel=None):
    """dx [N, H] in x's type from the forward's lse and the loss gradient
    g [N]; same dispatch."""
    if _plain(kernel, x):
        return fused_ce_bwd_dx_reference(x, w, labels, lse, g)
    return _launch_bwd("dx", x, w, labels, lse, g)


def fused_ce_bwd_dw(x, w, labels, lse, g, kernel=None):
    """dW [V, H] in W's type; same dispatch."""
    if _plain(kernel, x):
        return fused_ce_bwd_dw_reference(x, w, labels, lse, g)
    return _launch_bwd("dw", x, w, labels, lse, g)


class _FusedLinearCE(torch.autograd.Function):
    """Saves (x, w, labels, lse) — never the [N, V] logits."""

    @staticmethod
    def forward(ctx, x, w, labels):
        lse, lab = fused_ce_forward(x, w, labels)
        ctx.save_for_backward(x, w, labels, lse)
        return lse - lab

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = fused_ce_bwd_dx(x, w, labels, lse, g)
        if ctx.needs_input_grad[1]:
            dw = fused_ce_bwd_dw(x, w, labels, lse, g)
        return dx, dw, None


def fused_linear_cross_entropy(x, w, labels):
    """Per-row loss [N] fp32 of the tied head, differentiable in x and w:
    CPU tensors -> the plain versions; CUDA tensors -> the Hopper kernels
    or an error."""
    return _FusedLinearCE.apply(x, w, labels)


__all__ = ["fused_linear_cross_entropy", "fused_ce_forward",
           "fused_ce_bwd_dx", "fused_ce_bwd_dw", "fused_ce_fwd_reference",
           "fused_ce_bwd_dx_reference", "fused_ce_bwd_dw_reference",
           "dlogits_reference", "max_hidden", "NEG_INF"]
