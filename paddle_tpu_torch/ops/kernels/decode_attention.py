"""Single-token (q_len == 1) decode attention, over a contiguous cache
or a paged one.

Port of paddle_tpu's `ops/pallas/decode_attention.py`. Every decode step
attends one fresh query row per sequence against that sequence's cached
K/V. `decode_attention` takes the cache as one contiguous panel per
sequence (`gpt_decode_fns`' decode_step):

    q        [B, H, D]          fresh query row per sequence (fp32)
    k, v     [B, cap, H, D]     cache panels (rows >= length are garbage)
    lengths  [B] int32          valid prefix per sequence; clamped to
                                [0, cap], and 0 masks every row (the
                                softmax is then uniform over all cap rows)
    out      [B, H, D]

`paged_decode_attention` takes it from a shared page pool addressed
through a per-sequence block table (the engine's step):

    q        [B, H, D]          fresh query row per sequence (fp32)
    k_pool   [P, pt, H, D]      one layer's page pool (pt = page tokens)
    v_pool   [P, pt, H, D]
    tables   [B, W] int32       tables[b, w] = page holding rows
                                [w*pt, (w+1)*pt) of sequence b; unused
                                entries point at the null page 0
    lengths  [B] int32          valid prefix per sequence, 1..W*pt
    out      [B, H, D]

Each entry point dispatches on the tensors' device: a CPU tensor takes
the plain PyTorch version (`decode_attention_reference`,
`paged_decode_attention_reference`), a CUDA tensor launches the
hand-written Hopper kernel (`csrc/decode_attention.cu`,
`csrc/paged_decode_attention.cu`) or raises. ``kernel="reference"``
forces the plain version (for tests and for holding the kernel against
it on the card); any other value raises.

`paged_decode_attention_quant` is the same attention over an int8 pool
(`quant/kv.py`: int8 codes ``[P, pt, H, D]`` plus one fp32 scale per
(page, row, head), ``[P, pt, H]``), with its own plain version and its own
kernel (`csrc/paged_decode_attention_int8.cu`), under the same dispatch
rule.

All three kernels split each (b, h) sequence over a thread-block cluster
of `SPLIT` CTAs (split-KV, one template, `csrc/paged_decode_split.cuh`):
CTA r takes rows [r*len/SPLIT, (r+1)*len/SPLIT), and CTA 0 merges the
partial softmax states in rank order. `split_geometry` gives the paged
kernels' launch, a function of (B, H, D, pt, W) alone, and
`contig_split_geometry` the contiguous kernel's, a function of (B, H, D,
cap) alone, so a CUDA graph of a call stays right when the lengths (and
tables) change in place.

`contig_launches` / `launches` / `quant_launches` count kernel launches
made by this module, so a run can show that its decode path went through
the kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30       # the JAX package's mask constant (_common.py NEG_INF)
MAX_HEAD_DIM = 128    # the kernels keep up to 4 values of a row per lane

# the kernels' split (csrc/paged_decode_split.cuh, mirrored here)
SPLIT = 8                   # kSplit: CTAs per (b, h), one cluster
SPLIT_WARPS = 4             # kWarps: warps per CTA
SPLIT_STAGE_BYTES = 2048    # kStageBytes: one warp's stage of K and V rows
SPLIT_TABLE_BYTES = 8192    # kMaxTableBytes: a CTA's staged table entries

#: Kernel launches made by `decode_attention` in this process.
contig_launches = 0
#: Kernel launches made by `paged_decode_attention` in this process.
launches = 0
#: Kernel launches made by `paged_decode_attention_quant` in this process.
quant_launches = 0

_CFN = None
_FN = None
_QFN = None
_GEOM = {}


def _contig_kernel_fn():
    global _CFN
    if _CFN is None:
        fn = _build.load("decode_attention").decode_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _CFN = fn
    return _CFN


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("paged_decode_attention").paged_decode_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _quant_kernel_fn():
    global _QFN
    if _QFN is None:
        fn = _build.load("paged_decode_attention_int8") \
            .paged_decode_attention_int8
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _QFN = fn
    return _QFN


_GEOMETRY_EXPORTS = {
    "paged": ("paged_decode_attention", "paged_decode_attention_f32_geometry",
              5),
    "int8": ("paged_decode_attention_int8",
             "paged_decode_attention_int8_geometry", 5),
    "contig": ("decode_attention", "decode_attention_f32_geometry", 4)}


def _geometry_fn(kind):
    """The kernel library's own `..._geometry` export for `kind` ("paged",
    "int8" or "contig"), for checking `split_geometry` and
    `contig_split_geometry` against it on the card."""
    if kind not in _GEOM:
        lib, name, n_ints = _GEOMETRY_EXPORTS[kind]
        fn = getattr(_build.load(lib), name)
        fn.argtypes = [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _GEOM[kind] = fn
    return _GEOM[kind]


def _check_split_dims(what, B, H, D):
    _check_head_dim(what, D)
    if min(B, H, D) <= 0 or max(B, H) > 65535:
        raise ValueError(f"{what}: B={B}, H={H} out of the kernels' range")


def _geometry(B, H, D, smem_bytes, elem):
    pairs = 1 if D <= 64 else 2
    return {"grid": (SPLIT, H, B), "cluster": (SPLIT, 1, 1),
            "threads": 32 * SPLIT_WARPS, "smem_bytes": smem_bytes,
            "stage_rows": SPLIT_STAGE_BYTES // (2 * 64 * pairs * elem),
            "workspace_bytes": 0}


def split_geometry(B, H, D, pt, W, int8=False):
    """The paged kernels' launch for static shapes (B, H, D, pt, W): the
    grid (SPLIT, H, B) in clusters of (SPLIT, 1, 1), the threads of a CTA,
    the dynamic shared memory for the most block-table entries a CTA
    stages, the rows of one warp's cp.async stage, and the workspace the
    wrapper allocates (none: the cluster merges in shared memory). It reads
    no lengths and no tables. Raises ValueError for shapes the kernels do
    not take; mirrors csrc/paged_decode_split.cuh `launch_shape`,
    `PagedRows.smem_bytes` and `stage_rows`."""
    what = "paged_decode_attention"
    _check_split_dims(what, B, H, D)
    if min(pt, W) <= 0 or W * pt > 1 << 30:
        raise ValueError(f"{what}: pt={pt}, W={W} out of the kernels' "
                         "range")
    rows = -(-W * pt // SPLIT)              # most rows a CTA takes
    slots = -(-rows // pt) + 1              # most table entries they span
    if 4 * slots > SPLIT_TABLE_BYTES:
        raise ValueError(f"{what}: a block table of W={W} pages of {pt} "
                         f"rows is too wide for the kernels ({slots} "
                         f"entries a CTA, at most {SPLIT_TABLE_BYTES // 4})")
    return _geometry(B, H, D, 4 * slots, 1 if int8 else 4)


def contig_split_geometry(B, H, D, cap):
    """The contiguous kernel's launch for static shapes (B, H, D, cap):
    `split_geometry`'s grid, cluster, threads and stage rows (fp32 rows),
    no dynamic shared memory (no table to stage) and no workspace. It
    reads no lengths. Raises ValueError for shapes the kernel does not
    take; mirrors csrc/paged_decode_split.cuh `launch_shape`,
    `ContiguousRows.smem_bytes` and `stage_rows`."""
    what = "decode_attention"
    _check_split_dims(what, B, H, D)
    if cap <= 0 or cap > 1 << 30:
        raise ValueError(f"{what}: cap={cap} out of the kernel's range")
    return _geometry(B, H, D, 0, 4)


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


def paged_decode_attention_quant_reference(q, k_pool, k_scale, v_pool,
                                           v_scale, tables, lengths):
    """The plain version over an int8 pool: gather the table's pages and
    their scales, dequantize the [B, W*pt, H, D] panel, then the masked
    softmax of `decode_attention_reference`."""
    B, W = tables.shape
    P, pt, H, D = k_pool.shape
    idx = tables.to(k_pool.device, torch.long)
    k = k_pool[idx].float() * k_scale[idx][..., None]
    v = v_pool[idx].float() * v_scale[idx][..., None]
    return decode_attention_reference(q, k.reshape(B, W * pt, H, D),
                                      v.reshape(B, W * pt, H, D), lengths)


def _check_tensors(what, dev, specs):
    """Every (name, tensor, dtype, ndim) in `specs` on `dev`, of that
    dtype and rank, and contiguous; raises otherwise."""
    for name, t, dtype, ndim in specs:
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, q on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{what}: {name} must have {ndim} dims, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _check_head_dim(what, D):
    if D > MAX_HEAD_DIM or D % 2:
        raise ValueError(f"{what}: head_dim {D} must be even and <= "
                         f"{MAX_HEAD_DIM}")


def _check_shapes(what, q, k_pool, v_pool, tables, lengths):
    B, H, D = q.shape
    if k_pool.shape != v_pool.shape or k_pool.shape[2:] != (H, D):
        raise ValueError(f"{what}: pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if tables.shape[0] != B or lengths.shape[0] != B:
        raise ValueError(f"{what}: tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")
    _check_head_dim(what, D)
    if B and H:
        split_geometry(B, H, D, k_pool.shape[1], tables.shape[1])


def _check_contig(q, k, v, lengths):
    what = "decode_attention"
    _check_tensors(what, q.device, (("q", q, torch.float32, 3),
                                    ("k", k, torch.float32, 4),
                                    ("v", v, torch.float32, 4),
                                    ("lengths", lengths, torch.int32, 1)))
    B, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"{what}: caches {tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if lengths.shape[0] != B:
        raise ValueError(f"{what}: lengths {tuple(lengths.shape)} do not "
                         f"match batch {B}")
    if k.shape[1] == 0:
        raise ValueError(f"{what}: the cache has no rows (cap 0)")
    _check_head_dim(what, D)
    if B and H:
        contig_split_geometry(B, H, D, k.shape[1])


def _check(q, k_pool, v_pool, tables, lengths):
    what = "paged_decode_attention"
    _check_tensors(what, q.device, (("q", q, torch.float32, 3),
                                    ("k_pool", k_pool, torch.float32, 4),
                                    ("v_pool", v_pool, torch.float32, 4),
                                    ("tables", tables, torch.int32, 2),
                                    ("lengths", lengths, torch.int32, 1)))
    _check_shapes(what, q, k_pool, v_pool, tables, lengths)


def _check_quant(q, k_pool, k_scale, v_pool, v_scale, tables, lengths):
    what = "paged_decode_attention_quant"
    _check_tensors(what, q.device, (("q", q, torch.float32, 3),
                                    ("k_pool", k_pool, torch.int8, 4),
                                    ("k_scale", k_scale, torch.float32, 3),
                                    ("v_pool", v_pool, torch.int8, 4),
                                    ("v_scale", v_scale, torch.float32, 3),
                                    ("tables", tables, torch.int32, 2),
                                    ("lengths", lengths, torch.int32, 1)))
    _check_shapes(what, q, k_pool, v_pool, tables, lengths)
    if k_scale.shape != k_pool.shape[:3] or v_scale.shape != k_pool.shape[:3]:
        raise ValueError(f"{what}: scales {tuple(k_scale.shape)}/"
                         f"{tuple(v_scale.shape)} do not match pools "
                         f"{tuple(k_pool.shape)}")


def _run(fn, q, args, *dims):
    """Launch `fn` on q's stream over the pointers of `args`, the output,
    B, H, D and the kernel's further shape ints `dims`. Returns (output,
    whether a kernel was launched): an empty batch launches nothing."""
    B, H, D = q.shape
    out = torch.empty_like(q)
    if B == 0 or H == 0 or 0 in dims:
        return out, False
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in args), out.data_ptr(),
                B, H, D, *dims, 1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: "
                           f"cudaError {rc}")
    return out, True


def _launch_contig(q, k, v, lengths):
    global contig_launches
    _check_contig(q, k, v, lengths)
    out, ran = _run(_contig_kernel_fn(), q, (q, k, v, lengths), k.shape[1])
    contig_launches += int(ran)
    return out


def _launch(q, k_pool, v_pool, tables, lengths):
    global launches
    _check(q, k_pool, v_pool, tables, lengths)
    out, ran = _run(_kernel_fn(), q, (q, k_pool, v_pool, tables, lengths),
                    k_pool.shape[1], tables.shape[1])
    launches += int(ran)
    return out


def _launch_quant(q, k_pool, k_scale, v_pool, v_scale, tables, lengths):
    global quant_launches
    _check_quant(q, k_pool, k_scale, v_pool, v_scale, tables, lengths)
    out, ran = _run(_quant_kernel_fn(), q,
                    (q, k_pool, k_scale, v_pool, v_scale, tables, lengths),
                    k_pool.shape[1], tables.shape[1])
    quant_launches += int(ran)
    return out


def _dispatch(what, kernel, q, plain, launch):
    if kernel == "reference":
        return plain()
    if kernel is not None:
        raise ValueError(f"kernel={kernel!r}: expected None or 'reference'")
    if q.device.type == "cpu":
        return plain()
    if q.device.type == "cuda":
        return launch()
    raise ValueError(f"{what}: no kernel for device {q.device}")


def decode_attention(q, k, v, lengths, kernel=None):
    """Decode attention over contiguous cache panels (see module docstring
    for shapes).

    CPU tensors -> the plain PyTorch version; CUDA tensors -> the Hopper
    kernel, or an error. ``kernel="reference"`` forces the plain version
    on any device. The JAX package's ``pallas`` / ``xla`` switch is not
    carried over: any other `kernel` raises `ValueError`."""
    args = (q, k, v, lengths)
    return _dispatch("decode_attention", kernel, q,
                     lambda: decode_attention_reference(*args),
                     lambda: _launch_contig(*args))


def paged_decode_attention(q, k_pool, v_pool, tables, lengths, kernel=None):
    """Paged decode attention (see module docstring for shapes).

    CPU tensors -> the plain PyTorch version; CUDA tensors -> the Hopper
    kernel, or an error. ``kernel="reference"`` forces the plain version
    on any device."""
    args = (q, k_pool, v_pool, tables, lengths)
    return _dispatch("paged_decode_attention", kernel, q,
                     lambda: paged_decode_attention_reference(*args),
                     lambda: _launch(*args))


def paged_decode_attention_quant(q, k_pool, k_scale, v_pool, v_scale,
                                 tables, lengths, kernel=None):
    """Paged decode attention over an int8 pool: k_pool/v_pool
    [P, pt, H, D] int8, k_scale/v_scale [P, pt, H] fp32, the rest as
    `paged_decode_attention`. Same dispatch rule: CPU tensors -> the plain
    version, CUDA tensors -> the Hopper kernel or an error,
    ``kernel="reference"`` -> the plain version."""
    args = (q, k_pool, k_scale, v_pool, v_scale, tables, lengths)
    return _dispatch("paged_decode_attention_quant", kernel, q,
                     lambda: paged_decode_attention_quant_reference(*args),
                     lambda: _launch_quant(*args))
