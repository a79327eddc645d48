"""GPT decoder language model in PyTorch: the decode side and the
training side.

Port of paddle_tpu's `models/gpt.py`. Decode: the configs, the prefill
forward, the contiguous-cache decode step (`gpt_decode_fns`), the paged
decode step, the fused prefill-into-pages, and speculative decoding's
multi-token verify and K-step draft rollout over pages, with the
same math and op order (pre-LN blocks, `_pp_ln`'s
mean / centred variance / sqrt(var + eps), f32 scores, a -1e30 causal mask,
exact gelu, tied LM head), so the same weights give the same logits.
Training: `GPT` (an `nn.Layer` of `Block`s) with `loss` through
`masked_linear_ce`, built from the port's `nn` layers so that AMP casts op
by op as in the JAX package, and attention through
`F.scaled_dot_product_attention` (the flash-attention kernels at
seq_len >= pallas_attention_min_seq).

Weights stay ``[in, out]`` (the JAX package's nn/layer/common.py layout):
every matmul is ``x @ w``, and `torch.nn.Linear` (``[out, in]``) is not
used anywhere — loading a state dict into it would silently transpose.

Parameters are a flat ``{name: tensor}`` dict whose names are the JAX
package's per-block indexed names (``wte.weight``,
``blocks.3.attn.qkv.weight``, ``ln_f.bias``, ...). `params_from_numpy` is
the one function that carries weights across from the JAX package; it
accepts the JAX arrays in either layout (scan-stacked ``blocks.<name>``
with a leading [layers] axis, or indexed ``blocks.<i>.<name>``).
`GPTDecoder` is the same parameters as an `nn.Module`.

int8 serving (the JAX package's `quant/` conventions): a weight quantized
by `quant.ptq.quantize_params` is an int8 tensor under its own name with
an fp32 per-output-channel scale under ``name + "::scale"``; `_qmm` sends
every block matmul whose weight has that sibling through
`ops.kernels.quant_matmul.int8_weight_matmul`. An int8 KV pool is the
``(data int8, scale f32)`` pair of `quant.kv`; the pool helpers below
branch on it, and its attention goes through
`paged_decode_attention_quant`.

MoE configs raise `NotImplementedError`, as in JAX.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..distributed.fleet.utils import recompute
from ..memory.page_allocator import gather_pages, write_pages
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer import Dropout, Embedding, Layer, LayerList, LayerNorm, Linear
from ..ops import basic as ops
from ..ops.kernels.decode_attention import (NEG_INF, decode_attention,
                                            paged_decode_attention,
                                            paged_decode_attention_quant)
from ..ops.kernels.quant_matmul import int8_weight_matmul
from ..quant.kv import dequantize_kv, quantize_kv
from ..quant.ptq import SCALE_SUFFIX, is_quantized


@dataclasses.dataclass
class GPTConfig:
    """Same fields and defaults as the JAX package's GPTConfig, so a
    decode artifact's config JSON loads unchanged. The training-only
    fields (dropout, moe_*, scan_layers, fused_head_ce) are carried for
    that compatibility and do not change the decode math."""
    vocab_size: int = 50304          # 50257 padded to a multiple of 128
    max_seq_len: int = 1024
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    ffn_mult: int = 4
    dropout: float = 0.0
    dtype: str = "float32"
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_aux_coef: float = 0.01
    scan_layers: bool = None
    fused_head_ce: bool = None

    @property
    def head_dim(self):
        return self.hidden // self.heads


def gpt_tiny(**kw):
    return GPTConfig(vocab_size=512, max_seq_len=128, hidden=64, layers=2,
                     heads=4, **kw)


def gpt2_124m(**kw):
    return GPTConfig(hidden=768, layers=12, heads=12, **kw)


def gpt2_345m(**kw):
    return GPTConfig(hidden=1024, layers=24, heads=16, **kw)


def gpt3_1p3b(**kw):
    return GPTConfig(hidden=2048, layers=24, heads=16, max_seq_len=2048, **kw)


# ------------------------------------------------------------ parameters

_BLOCK_SHAPES = (          # relative name -> shape as a function of cfg
    ("ln1.weight", lambda c: (c.hidden,)),
    ("ln1.bias", lambda c: (c.hidden,)),
    ("attn.qkv.weight", lambda c: (c.hidden, 3 * c.hidden)),
    ("attn.qkv.bias", lambda c: (3 * c.hidden,)),
    ("attn.proj.weight", lambda c: (c.hidden, c.hidden)),
    ("attn.proj.bias", lambda c: (c.hidden,)),
    ("ln2.weight", lambda c: (c.hidden,)),
    ("ln2.bias", lambda c: (c.hidden,)),
    ("fc1.weight", lambda c: (c.hidden, c.ffn_mult * c.hidden)),
    ("fc1.bias", lambda c: (c.ffn_mult * c.hidden,)),
    ("fc2.weight", lambda c: (c.ffn_mult * c.hidden, c.hidden)),
    ("fc2.bias", lambda c: (c.hidden,)),
)


def param_shapes(cfg: GPTConfig,
                 quant: Optional[str] = None) -> Dict[str, Tuple[int, ...]]:
    """Every decode parameter's indexed name -> shape. ``quant="int8"``
    adds the ``::scale`` sibling ([out]) of each block matmul weight, the
    weights `quant.ptq.quantize_params` turns into int8."""
    if quant not in (None, "int8"):
        raise ValueError(f"quant={quant!r}: expected None or 'int8'")
    out = {"wte.weight": (cfg.vocab_size, cfg.hidden),
           "wpe.weight": (cfg.max_seq_len, cfg.hidden)}
    for i in range(cfg.layers):
        for rel, shape in _BLOCK_SHAPES:
            out[f"blocks.{i}.{rel}"] = shape(cfg)
            if quant and rel.endswith(".weight") and len(shape(cfg)) == 2:
                out[f"blocks.{i}.{rel}{SCALE_SUFFIX}"] = shape(cfg)[-1:]
    out["ln_f.weight"] = (cfg.hidden,)
    out["ln_f.bias"] = (cfg.hidden,)
    return out


def init_params_numpy(cfg: GPTConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random fp32 weights in the indexed layout, from `seed`: normals of
    std 0.02 for matrices and embeddings, LayerNorm weights 1, biases 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith(".bias"):
            out[name] = np.zeros(shape, np.float32)
        elif len(shape) == 1:                      # LayerNorm weight
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = (rng.standard_normal(shape, np.float32) * 0.02) \
                .astype(np.float32)
    return out


def params_from_numpy(cfg: GPTConfig, arrays: Mapping[str, np.ndarray],
                      device=None) -> Dict[str, torch.Tensor]:
    """Carry JAX-package weights (numpy arrays) into the port's params.

    `arrays` may use either layout of the JAX package: scan-stacked
    (``blocks.attn.qkv.weight`` with a leading [layers] axis) or indexed
    (``blocks.3.attn.qkv.weight``). Returns the indexed layout as tensors
    on `device` (default cuda): fp32, except the int8 weights of a
    quantized artifact (one with ``::scale`` keys, stacked ``[L, out]`` or
    per layer ``[out]``), which stay ``torch.int8`` beside fp32 scales.
    Missing or mis-shaped weights raise, and so does any weight whose
    dtype disagrees with the presence of its scale (an int8 weight read
    as float would give wrong logits without an error)."""
    if cfg.moe_experts > 0:
        raise NotImplementedError("params_from_numpy: MoE blocks have no "
                                  "decode path")
    dev = resolve_device(device)
    flat: Dict[str, np.ndarray] = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        if k.startswith("blocks.") and not re.match(r"blocks\.\d+\.", k):
            rel = k[len("blocks."):]
            if v.shape[0] != cfg.layers:
                raise ValueError(f"{k}: stacked axis {v.shape[0]} != "
                                 f"layers {cfg.layers}")
            for i in range(cfg.layers):
                flat[f"blocks.{i}.{rel}"] = v[i]
        else:
            flat[k] = v
    want = param_shapes(cfg, "int8" if is_quantized(flat) else None)
    missing = sorted(set(want) - set(flat))
    if missing:
        raise KeyError(f"params_from_numpy: missing {missing[:4]}"
                       f"{' ...' if len(missing) > 4 else ''}")
    stray = sorted(k for k in flat if k.endswith(SCALE_SUFFIX)
                   and k not in want)
    if stray:
        raise KeyError(f"params_from_numpy: scales of no quantizable "
                       f"weight: {stray[:4]}")
    out = {}
    for name, shape in want.items():
        a = flat[name]
        if tuple(a.shape) != shape:
            raise ValueError(f"params_from_numpy: {name} has shape "
                             f"{tuple(a.shape)}, want {shape}")
        quantized = name + SCALE_SUFFIX in want
        if not (a.dtype == np.int8 if quantized else a.dtype.kind == "f"):
            raise TypeError(
                f"params_from_numpy: {name} is {a.dtype}, want "
                + ("int8 (it has a scale)" if quantized else "a float"))
        out[name] = torch.tensor(
            a, dtype=torch.int8 if quantized else torch.float32, device=dev)
    return out


def split_decode_params(params: Mapping[str, torch.Tensor], cfg: GPTConfig):
    """Split the flat indexed param dict (`params_from_numpy`'s layout)
    into (embed, [block_i], head) for the decode fns."""
    embed = {k: v for k, v in params.items()
             if k.startswith(("wte.", "wpe."))}
    head = {k: v for k, v in params.items() if k.startswith("ln_f.")}
    blocks = []
    for i in range(cfg.layers):
        pref = f"blocks.{i}."
        blocks.append({k[len(pref):]: v for k, v in params.items()
                       if k.startswith(pref)})
    return embed, blocks, head


class _Weights(nn.Module):
    """A `weight` and, if `bias_shape` is given, a `bias` — the leaf of
    every parameter name (Linear weights are ``[in, out]``)."""

    def __init__(self, shape, bias_shape, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, device=device),
                                   requires_grad=False)
        if bias_shape is not None:
            self.bias = nn.Parameter(torch.empty(bias_shape, device=device),
                                     requires_grad=False)


class _Attn(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        C = cfg.hidden
        self.qkv = _Weights((C, 3 * C), (3 * C,), device)
        self.proj = _Weights((C, C), (C,), device)


class _Block(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        C, F = cfg.hidden, cfg.ffn_mult * cfg.hidden
        self.ln1 = _Weights((C,), (C,), device)
        self.attn = _Attn(cfg, device)
        self.ln2 = _Weights((C,), (C,), device)
        self.fc1 = _Weights((C, F), (F,), device)
        self.fc2 = _Weights((F, C), (C,), device)


class GPTDecoder(nn.Module):
    """The decode parameters as an `nn.Module`; `state_dict()` keys are
    exactly the JAX package's indexed names. Load weights with
    ``load_state_dict(params_from_numpy(cfg, arrays, device))``.
    `forward(tokens [B, T])` is the full causal forward -> logits
    [B, T, V] (the teacher-forcing oracle for the decode path)."""

    def __init__(self, cfg: GPTConfig, eps: float = 1e-5, device=None):
        super().__init__()
        if cfg.moe_experts > 0:
            raise NotImplementedError("GPTDecoder: MoE blocks have no "
                                      "decode path")
        dev = resolve_device(device)
        self.cfg = cfg
        self.eps = float(eps)
        self.wte = _Weights((cfg.vocab_size, cfg.hidden), None, dev)
        self.wpe = _Weights((cfg.max_seq_len, cfg.hidden), None, dev)
        self.blocks = nn.ModuleList(_Block(cfg, dev)
                                    for _ in range(cfg.layers))
        self.ln_f = _Weights((cfg.hidden,), (cfg.hidden,), dev)

    def params(self) -> Dict[str, torch.Tensor]:
        """The flat param dict the decode fns take."""
        return dict(self.state_dict())

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        xf, _, _ = _hidden(self.params(), self.cfg, self.eps,
                           tokens.to(self.wte.weight.device, torch.long))
        return xf @ self.wte.weight.T


# ---------------------------------------------------------------- math

def _pp_ln(x, g, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def _qmm(bp, name, x):
    """Weight matmul over a possibly PTQ-quantized block param dict: ``x @
    w`` when `name` has no ``::scale`` sibling, else the int8-weight matmul
    (`ops.kernels.quant_matmul`: the kernel on the GPU, the plain version
    on the CPU)."""
    s = bp.get(name + SCALE_SUFFIX)
    if s is None:
        return x @ bp[name]
    return int8_weight_matmul(x, bp[name], s)


def _ffn(bp, x, eps):
    h2 = _pp_ln(x, bp["ln2.weight"], bp["ln2.bias"], eps)
    m = torch.nn.functional.gelu(_qmm(bp, "fc1.weight", h2) + bp["fc1.bias"])
    return x + _qmm(bp, "fc2.weight", m) + bp["fc2.bias"]


def _hidden(params, cfg: GPTConfig, eps: float, tokens: torch.Tensor):
    """Causal forward over tokens [B, T] -> (final-LN hidden [B, T, C],
    per-layer K and V panels, each [layers, B, T, heads, head_dim])."""
    embed, blocks, head = split_decode_params(params, cfg)
    B, T = tokens.shape
    D, nh = cfg.head_dim, cfg.heads
    scale = 1.0 / math.sqrt(D)
    pos = torch.arange(T, device=tokens.device)
    x = embed["wte.weight"][tokens] + embed["wpe.weight"][pos]
    causal = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                   device=tokens.device))
    ks, vs = [], []
    for bp in blocks:
        h1 = _pp_ln(x, bp["ln1.weight"], bp["ln1.bias"], eps)
        qkv = _qmm(bp, "attn.qkv.weight", h1) + bp["attn.qkv.bias"]
        q, k, v = qkv.split(cfg.hidden, dim=-1)
        q = q.reshape(B, T, nh, D)
        k = k.reshape(B, T, nh, D)
        v = v.reshape(B, T, nh, D)
        ks.append(k)
        vs.append(v)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        s = s.float().masked_fill(~causal, NEG_INF)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, T, -1)
        x = x + _qmm(bp, "attn.proj.weight", o) + bp["attn.proj.bias"]
        x = _ffn(bp, x, eps)
    xf = _pp_ln(x, head["ln_f.weight"], head["ln_f.bias"], eps)
    return xf, torch.stack(ks), torch.stack(vs)


# An fp32 KV pool is a bare [layers, P, page_tokens, heads, head_dim]
# tensor; the int8 pool (quant/kv.py) is the (data int8, scale f32) pair
# with one scale per (layer, page, row, head). The helpers below branch on
# the pair, so one decode path serves both pool dtypes. Writes go into the
# pool IN PLACE (index_put_, through the allocator's pool ops), where the
# JAX versions return a functionally updated, donated buffer.

def _kv_pool_write(pool, li, page_idx, offset, rows):
    """Scatter fresh fp32 K/V rows at [li, page_idx, offset], in place
    (`li` may be `slice(None)` for an all-layer scatter); an int8 pool
    quantizes the rows per (row, head) first."""
    if isinstance(pool, tuple):
        rows = quantize_kv(rows)
    return write_pages(pool, rows, page_idx, offset=offset, layer=li)


def _kv_pool_layer(pool, li):
    """Layer `li`'s pool view [P, page_tokens, heads, head_dim], or its
    (data, scale) pair."""
    if isinstance(pool, tuple):
        return pool[0][li], pool[1][li]
    return pool[li]


def _kv_pool_take(pool, tables):
    """Block-table gather of the full pool as fp32 rows (`jnp.take(pool,
    tables, axis=1)`; an int8 pool's gathered panel is dequantized):
    tables [B, W] -> [L, B, W, page_tokens, heads, head_dim]."""
    if isinstance(pool, tuple):
        return dequantize_kv(*gather_pages(pool, tables))
    return gather_pages(pool, tables)


def _paged_attend(q, k_layer, v_layer, tables, lengths):
    """Paged decode attention over one layer's pool view; the int8
    variant when the pool is a (data, scale) pair."""
    if isinstance(k_layer, tuple):
        return paged_decode_attention_quant(
            q, k_layer[0], k_layer[1], v_layer[0], v_layer[1], tables,
            lengths)
    return paged_decode_attention(q, k_layer, v_layer, tables, lengths)


def _embed_step(params, cfg: GPTConfig, last_tok, cache_len):
    """One decode step's fresh rows: (x [B, C], pos [B] long), the token
    and position embeddings at positions cache_len, clamped to
    max_seq_len - 1 as in JAX."""
    wte = params["wte.weight"]
    pos = cache_len.to(wte.device, torch.long).clamp(0, cfg.max_seq_len - 1)
    x = wte[last_tok.to(wte.device, torch.long)] + params["wpe.weight"][pos]
    return x, pos


def _step_blocks(params, cfg: GPTConfig, eps: float, x, attend):
    """Every block, the final LayerNorm and the tied head over one decode
    step's fresh rows x [B, C] -> logits [B, V]. `attend(i, q, k_new,
    v_new)` (each [B, heads, head_dim], q dense as the kernels take it)
    writes layer i's new K/V row into the cache and returns the
    attention output."""
    embed, blocks, head = split_decode_params(params, cfg)
    B = x.shape[0]
    shape = (B, cfg.heads, cfg.head_dim)
    for i, bp in enumerate(blocks):
        h1 = _pp_ln(x, bp["ln1.weight"], bp["ln1.bias"], eps)
        qkv = _qmm(bp, "attn.qkv.weight", h1) + bp["attn.qkv.bias"]
        q, k_new, v_new = (t.reshape(shape)
                           for t in qkv.split(cfg.hidden, dim=-1))
        o = attend(i, q.contiguous(), k_new, v_new).reshape(B, -1)
        x = x + _qmm(bp, "attn.proj.weight", o) + bp["attn.proj.bias"]
        x = _ffn(bp, x, eps)
    xf = _pp_ln(x, head["ln_f.weight"], head["ln_f.bias"], eps)
    return xf @ embed["wte.weight"].T


def _prefill_fn(cfg: GPTConfig, eps: float):
    """prefill(params, tokens [B,T], lens [B])
        -> (logits [B,V] at each row's position lens-1,
            k, v [layers, B, T, heads, head_dim])"""
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "gpt_decode_fns: MoE blocks have no KV-decode path yet")

    @torch.no_grad()
    def prefill(params, tokens, lens):
        embed = params["wte.weight"]
        tokens = tokens.to(embed.device, torch.long)
        xf, k, v = _hidden(params, cfg, eps, tokens)
        T = tokens.shape[1]
        last = (lens.to(embed.device, torch.long) - 1).clamp(0, T - 1)
        xl = xf[torch.arange(xf.shape[0], device=xf.device), last]
        return xl @ embed.T, k, v

    return prefill


def gpt_decode_fns(cfg: GPTConfig, eps: float = 1e-5):
    """`(prefill, decode_step)` over a contiguous KV cache.

    prefill(params, tokens [B,T], lens [B])
        -> (logits [B,V] at each row's position lens-1,
            k, v [layers, B, T, heads, head_dim])
    decode_step(params, k, v, last_tok [B] int, cache_len [B] int)
        -> (logits [B,V], k, v)

    The prefill's panel length T is the cache capacity `cap` of every
    later step: a caller pads prompts to a rung of
    `inference.decode.kv_capacity_ladder`. decode_step writes the new
    token's K/V at row cache_len of each sequence, IN PLACE (JAX returns
    updated arrays; here the same tensors come back), then attends rows
    0..cache_len through `ops.kernels.decode_attention.decode_attention`
    (the CUDA kernel on the GPU, the plain version on the CPU). As in JAX,
    cache_len is clamped to max_seq_len - 1 first, and a row at or past
    cap lands on row cap - 1, where XLA's dynamic_update_slice clamps its
    start; the attention then counts every row live. MoE configs raise
    (in `_prefill_fn`), as in JAX.
    """
    @torch.no_grad()
    def decode_step(params, k_cache, v_cache, last_tok, cache_len):
        x, pos = _embed_step(params, cfg, last_tok, cache_len)
        rows = (torch.arange(pos.shape[0], device=pos.device),
                pos.clamp(max=k_cache.shape[2] - 1))
        lengths = (pos + 1).to(torch.int32)   # the row just written is live

        def attend(i, q, k_new, v_new):
            k_cache[i][rows] = k_new
            v_cache[i][rows] = v_new
            return decode_attention(q, k_cache[i], v_cache[i], lengths)

        return _step_blocks(params, cfg, eps, x, attend), k_cache, v_cache

    return _prefill_fn(cfg, eps), decode_step


def gpt_paged_decode_fns(cfg: GPTConfig, eps: float = 1e-5,
                         page_tokens: int = 16):
    """`(prefill, paged_step)` over a PAGED KV cache.

    paged_step(params,
               k_pool, v_pool [layers, P, page_tokens, heads, head_dim]
                              (or int8 (data, scale) pairs),
               tables   [B, W] int32 (unused entries -> null page 0),
               last_tok [B] int,
               cache_len [B] int)
        -> (logits [B,V], k_pool, v_pool)

    The new token's K/V lands at page tables[b, cache_len//pt], row
    cache_len%pt (written into the pools in place; padded batch rows
    carry all-null tables, so their garbage writes fall into the
    reserved null page); attention walks the block table through
    `ops.kernels.decode_attention.paged_decode_attention` (or its int8
    variant) — the CUDA kernel on the GPU, the plain version on the CPU.
    """
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "gpt_paged_decode_fns: MoE blocks have no KV-decode path yet")
    pt = int(page_tokens)

    @torch.no_grad()
    def paged_step(params, k_pool, v_pool, tables, last_tok, cache_len):
        x, pos = _embed_step(params, cfg, last_tok, cache_len)
        tables = tables.to(pos.device, torch.int32)
        W = tables.shape[1]
        page_idx = tables.gather(
            1, torch.clamp(pos // pt, max=W - 1)[:, None])[:, 0].long()
        offset = pos % pt
        lengths = (pos + 1).to(torch.int32)   # the row just written is live

        def attend(i, q, k_new, v_new):
            _kv_pool_write(k_pool, i, page_idx, offset, k_new)
            _kv_pool_write(v_pool, i, page_idx, offset, v_new)
            return _paged_attend(q, _kv_pool_layer(k_pool, i),
                                 _kv_pool_layer(v_pool, i), tables, lengths)

        return _step_blocks(params, cfg, eps, x, attend), k_pool, v_pool

    return _prefill_fn(cfg, eps), paged_step


def gpt_paged_prefill_fns(cfg: GPTConfig, eps: float = 1e-5,
                          page_tokens: int = 16):
    """Fused prefill-into-pages: the prompt's K/V panel (the parallel
    prefill) scattered straight into pool pages, in place.

    paged_prefill(params,
                  k_pool, v_pool [layers, P, page_tokens, heads, head_dim]
                                 (or int8 (data, scale) pairs),
                  toks   [1, R] int (prompt, possibly padded),
                  tables [1, W] int32 (W >= ceil(n / page_tokens)),
                  n      [1]    int (true prompt length))
        -> (logits [1, V], k_pool, v_pool)

    Row r lands at page tables[0, r//pt], offset r%pt; padding rows at
    or past `n` go to the null page, so a short prompt never dirties
    pages it does not own."""
    pt = int(page_tokens)
    prefill = _prefill_fn(cfg, eps)

    @torch.no_grad()
    def paged_prefill(params, k_pool, v_pool, toks, tables, n):
        dev = params["wte.weight"].device
        R = toks.shape[1]
        tables = tables.to(dev, torch.long)
        W = tables.shape[1]
        logits, k, v = prefill(params, toks, n)
        rows = torch.arange(R, device=dev)
        valid = rows < int(n[0])
        slot = torch.clamp(rows // pt, max=W - 1)
        page_idx = torch.where(valid, tables[0, slot],
                               torch.zeros_like(rows))
        offset = rows % pt
        _kv_pool_write(k_pool, slice(None), page_idx, offset, k[:, 0])
        _kv_pool_write(v_pool, slice(None), page_idx, offset, v[:, 0])
        return logits, k_pool, v_pool

    return paged_prefill


# ------------------------------------------------- speculative decoding
#
# The verify and rollout attention are the JAX package's gathered XLA
# compositions (no pallas_call there), so they run as plain PyTorch here;
# their weight matmuls go through `_qmm`, the int8 kernel on a quantized
# artifact.

def _kv_pool_take_layer(pool, li, tables):
    """Layer `li`'s block-table gather as fp32 rows [B, W * page_tokens,
    heads, head_dim] (an int8 pool's rows dequantized)."""
    sub = tuple(t[li:li + 1] for t in pool) if isinstance(pool, tuple) \
        else pool[li:li + 1]
    rows = _kv_pool_take(sub, tables)[0]
    return rows.reshape(rows.shape[0], -1, *rows.shape[3:])


def _window_rows(params, cfg: GPTConfig, pt: int, tables, toks, pos):
    """Fresh rows of tokens toks [B, K] at absolute positions pos [B, K]:
    (x [B, K, C], page_idx [B, K], offset [B, K], pos_c [B, K]), the
    `paged_step` addressing. Positions at or past max_seq_len embed at its
    last row and write to the null page, as in JAX."""
    wte = params["wte.weight"]
    valid = pos < cfg.max_seq_len
    pos_c = pos.clamp(max=cfg.max_seq_len - 1)
    x = wte[toks] + params["wpe.weight"][pos_c]
    slot = (pos_c // pt).clamp(max=tables.shape[1] - 1)
    page_idx = torch.where(valid, tables.gather(1, slot),
                           torch.zeros_like(slot))
    return x, page_idx, pos_c % pt, pos_c


def gpt_paged_verify_fns(cfg: GPTConfig, eps: float = 1e-5,
                         page_tokens: int = 16):
    """Multi-token verify step over a PAGED KV cache — the target side of
    speculative decoding.

    paged_verify(params,
                 k_pool, v_pool [layers, P, page_tokens, heads, head_dim]
                                (or int8 (data, scale) pairs),
                 tables    [B, W]  int (unused entries -> null page 0),
                 toks      [B, K1] int (token at position cache_len + i),
                 cache_len [B]     int)
        -> (logits [B, K1, V], argmax [B, K1] int32, k_pool, v_pool)

    `logits[b, i]` is the next-token distribution after toks[b, :i+1], so
    one call scores every drafted position. The committed prefix (rows <
    cache_len) is gathered from the pool layer by layer, before this
    call writes anything; the K1 fresh rows attend each other directly
    under an in-window causal triangle, with one fp32 softmax over
    [prefix | window] and the -1e30 mask. The window's K/V then lands in
    one all-layer scatter (int8 pools quantize it per row), IN PLACE, at
    page tables[b, pos//pt] row pos%pt; positions at or past max_seq_len
    write to the null page. Accepted rows persist; rejected rows are
    garbage above the rolled-back cache_len, never read again (the
    prefix mask is < cache_len). MoE configs raise, as in JAX."""
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "gpt_paged_verify_fns: MoE blocks have no KV-decode path yet")
    D, nh, pt = cfg.head_dim, cfg.heads, int(page_tokens)
    scale = 1.0 / math.sqrt(D)

    @torch.no_grad()
    def paged_verify(params, k_pool, v_pool, tables, toks, cache_len):
        embed, blocks, head = split_decode_params(params, cfg)
        dev = embed["wte.weight"].device
        toks = toks.to(dev, torch.long)
        tables = tables.to(dev, torch.long)
        cache_len = cache_len.to(dev, torch.long)
        B, K1 = toks.shape
        kcap = tables.shape[1] * pt
        win = torch.arange(K1, device=dev)
        x, page_idx, offset, _ = _window_rows(
            params, cfg, pt, tables, toks, cache_len[:, None] + win[None])
        prefix_live = (torch.arange(kcap, device=dev)[None]
                       < cache_len[:, None])[:, None, None, :]
        win_causal = (win[None, :] <= win[:, None])[None, None]
        k_news, v_news = [], []
        for i, bp in enumerate(blocks):
            h1 = _pp_ln(x, bp["ln1.weight"], bp["ln1.bias"], eps)
            qkv = _qmm(bp, "attn.qkv.weight", h1) + bp["attn.qkv.bias"]
            q, k_new, v_new = (t.reshape(B, K1, nh, D)
                               for t in qkv.split(cfg.hidden, dim=-1))
            k_news.append(k_new)
            v_news.append(v_new)
            keys = _kv_pool_take_layer(k_pool, i, tables)
            vals = _kv_pool_take_layer(v_pool, i, tables)
            sp = torch.einsum("bqhd,bkhd->bhqk", q, keys) * scale
            sp = sp.float().masked_fill(~prefix_live, NEG_INF)
            sw = torch.einsum("bqhd,bkhd->bhqk", q, k_new) * scale
            sw = sw.float().masked_fill(~win_causal, NEG_INF)
            p = torch.softmax(torch.cat([sp, sw], dim=-1), dim=-1) \
                .to(x.dtype)
            o = torch.einsum("bhqk,bkhd->bqhd", p[..., :kcap], vals) \
                + torch.einsum("bhqk,bkhd->bqhd", p[..., kcap:], v_new)
            x = x + _qmm(bp, "attn.proj.weight", o.reshape(B, K1, -1)) \
                + bp["attn.proj.bias"]
            x = _ffn(bp, x, eps)
        _kv_pool_write(k_pool, slice(None), page_idx, offset,
                       torch.stack(k_news))
        _kv_pool_write(v_pool, slice(None), page_idx, offset,
                       torch.stack(v_news))
        xf = _pp_ln(x, head["ln_f.weight"], head["ln_f.bias"], eps)
        logits = xf @ embed["wte.weight"].T
        return (logits, logits.argmax(dim=-1).to(torch.int32), k_pool,
                v_pool)

    return paged_verify


def gpt_paged_rollout_fns(cfg: GPTConfig, eps: float = 1e-5,
                          page_tokens: int = 16):
    """K-step greedy draft rollout over a PAGED KV cache in one call — the
    draft side of speculative decoding.

    paged_rollout(params,
                  k_pool, v_pool [layers, P, page_tokens, heads, head_dim]
                                 (or int8 (data, scale) pairs),
                  tables [B, W] int (unused entries -> null page 0),
                  forced [B, K] int (>= 0: the committed token to consume
                          at step i — catch-up; -1: chain the previous
                          step's own argmax),
                  cache_len [B] int)
        -> (drafts [B, K] int32, k_pool, v_pool)

    Step i consumes one token at position cache_len + i, writes its K/V
    (in place, the `paged_step` addressing; positions at or past
    max_seq_len to the null page), attends over the gathered layer pool
    (rows <= its position) and records the greedy argmax in drafts[b, i].
    forced[:, 0] must be >= 0. JAX's `fori_loop` is a Python loop here;
    the drafts stay on the device until the caller reads them."""
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "gpt_paged_rollout_fns: MoE blocks have no KV-decode path yet")
    pt = int(page_tokens)
    scale = 1.0 / math.sqrt(cfg.head_dim)

    @torch.no_grad()
    def paged_rollout(params, k_pool, v_pool, tables, forced, cache_len):
        dev = params["wte.weight"].device
        forced = forced.to(dev, torch.long)
        tables = tables.to(dev, torch.long)
        base = cache_len.to(dev, torch.long)
        B, K = forced.shape
        rows = torch.arange(tables.shape[1] * pt, device=dev)
        drafts = torch.zeros((B, K), dtype=torch.int32, device=dev)
        prev = forced[:, 0]
        for i in range(K):
            tok = torch.where(forced[:, i] >= 0, forced[:, i], prev)
            x, page_idx, offset, pos_c = _window_rows(
                params, cfg, pt, tables, tok[:, None], (base + i)[:, None])
            live = (rows[None] <= pos_c)[:, None]          # [B, 1, kcap]

            def attend(li, q, k_new, v_new):
                _kv_pool_write(k_pool, li, page_idx[:, 0], offset[:, 0],
                               k_new)
                _kv_pool_write(v_pool, li, page_idx[:, 0], offset[:, 0],
                               v_new)
                keys = _kv_pool_take_layer(k_pool, li, tables)
                vals = _kv_pool_take_layer(v_pool, li, tables)
                s = torch.einsum("bhd,bkhd->bhk", q, keys) * scale
                s = s.float().masked_fill(~live, NEG_INF)
                p = torch.softmax(s, dim=-1).to(vals.dtype)
                return torch.einsum("bhk,bkhd->bhd", p, vals)

            prev = _step_blocks(params, cfg, eps, x[:, 0], attend) \
                .argmax(dim=-1)
            drafts[:, i] = prev.to(torch.int32)
        return drafts, k_pool, v_pool

    return paged_rollout


# ------------------------------------------------------------ training

def masked_linear_ce(h, weight, labels, ignore_index=-100, fused=None):
    """Tied-head CE through `F.linear_cross_entropy` (the [tokens, vocab]
    logits are never kept for the backward), masked as F.cross_entropy's
    ignore_index: ignored rows add 0 to the sum and leave the mean's
    denominator; an all-ignored batch gives 0. The float ops go through
    `ops.basic`, so under AMP O2 they cast as the JAX package's do."""
    C = h.shape[-1]
    lab = labels.reshape(-1)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    rows = F.linear_cross_entropy(ops.reshape(h, [-1, C]), weight, safe,
                                  fused=fused, reduction="none")
    rows = ops.where(valid, rows, ops.zeros_like(rows))
    n_valid = ops.sum(ops.cast(valid, torch.float32))
    n_valid = ops.maximum(n_valid, ops.ones_like(n_valid))
    return ops.divide(ops.sum(rows), n_valid)


class CausalSelfAttention(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = Linear(cfg.hidden, 3 * cfg.hidden)
        self.proj = Linear(cfg.hidden, cfg.hidden)
        self.drop = Dropout(cfg.dropout)

    def forward(self, x):
        B, T, C = x.shape
        H, D = self.cfg.heads, self.cfg.head_dim
        q, k, v = (ops.reshape(t, [B, T, H, D])
                   for t in ops.chunk(self.qkv(x), 3, axis=-1))
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             training=self.training)
        return self.drop(self.proj(ops.reshape(out, [B, T, C])))


class Block(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden)
        self.attn = CausalSelfAttention(cfg)
        self.ln2 = LayerNorm(cfg.hidden)
        self.fc1 = Linear(cfg.hidden, cfg.ffn_mult * cfg.hidden)
        self.fc2 = Linear(cfg.ffn_mult * cfg.hidden, cfg.hidden)
        self.drop = Dropout(cfg.dropout)

    def forward(self, x):
        x = ops.add(x, self.attn(self.ln1(x)))
        h = self.fc2(F.gelu(self.fc1(self.ln2(x))))
        return ops.add(x, self.drop(h))


class GPT(Layer):
    """Pre-LN GPT decoder LM, training side (port of the JAX package's
    `GPT`). forward(ids [B, T]) -> logits [B, T, V]; loss(ids, labels) ->
    the masked tied-head CE. Parameters are created on the default device
    (`set_device`; cuda unless asked otherwise).

    `cfg.scan_layers` is accepted and the blocks always run as a Python
    loop: the JAX package's scan only changes its compile, and its
    `state_dict()` expands the stacked layout to the same per-block names
    this model has. MoE configs raise `NotImplementedError`."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        if cfg.moe_experts > 0:
            raise NotImplementedError("GPT: MoE blocks are not ported to "
                                      "paddle_tpu_torch")
        self.cfg = cfg
        emb_init = I.Normal(0.0, 0.02)                     # GPT-2 init
        self.wte = Embedding(cfg.vocab_size, cfg.hidden, weight_attr=emb_init)
        self.wpe = Embedding(cfg.max_seq_len, cfg.hidden, weight_attr=emb_init)
        self.drop = Dropout(cfg.dropout)
        self.blocks = LayerList(Block(cfg) for _ in range(cfg.layers))
        self.ln_f = LayerNorm(cfg.hidden)
        self.enable_block_recompute(False)

    def enable_block_recompute(self, flag=True, policy=None):
        """Per-block activation recomputation (the strategy compiler's
        protocol): with the flag on, each block runs under
        `distributed.fleet.utils.recompute` with `policy` (a name of
        `RECOMPUTE_POLICIES`), so the backward keeps one block's
        activations at a time; the final LayerNorm and the head stay
        outside. The compiler sets the flag around its forward only."""
        self._recompute_blocks = bool(flag)
        self._recompute_policy = policy
        return self

    def forward_hidden(self, idx):
        """Final-LayerNorm hidden states [B, T, C]: everything but the
        tied LM head."""
        idx = torch.as_tensor(idx, device=self.wte.weight.device).long()
        T = idx.shape[1]
        pos = torch.arange(T, device=idx.device)[None]
        x = self.drop(ops.add(self.wte(idx), self.wpe(pos)))
        for blk in self.blocks:
            x = (recompute(blk, x, checkpoint_policy=self._recompute_policy)
                 if self._recompute_blocks else blk(x))
        return self.ln_f(x)

    def forward(self, idx):
        x = self.forward_hidden(idx)
        return F.linear(x, ops.transpose(self.wte.weight, [1, 0]))

    def loss(self, idx, labels):
        labels = torch.as_tensor(labels, device=self.wte.weight.device)
        return masked_linear_ce(self.forward_hidden(idx), self.wte.weight,
                                labels, fused=self.cfg.fused_head_ce)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len=None) -> int:
        """Train-step (fwd + bwd) FLOPs per token: 6N for the parameter
        matmuls plus 12 * layers * hidden * seq for attention's scores and
        values."""
        c = self.cfg
        return 6 * self.num_params() \
            + 12 * c.layers * c.hidden * (seq_len or c.max_seq_len)

    def load_numpy(self, arrays: Mapping[str, np.ndarray]):
        """Load the JAX GPT's `state_dict()` as numpy arrays (indexed or
        scan-stacked keys) through `params_from_numpy`, the one function
        that reads the JAX package's layouts. Returns self."""
        dev = self.wte.weight.device
        params = params_from_numpy(self.cfg, arrays, device=dev)
        missing, unexpected = self.set_state_dict(params)
        if missing or unexpected:
            raise KeyError(f"GPT.load_numpy: missing {missing[:4]}, "
                           f"unexpected {unexpected[:4]}")
        return self


__all__ = ["GPTConfig", "gpt_tiny", "gpt2_124m", "gpt2_345m", "gpt3_1p3b",
           "GPTDecoder", "init_params_numpy", "params_from_numpy",
           "param_shapes", "split_decode_params", "gpt_decode_fns",
           "gpt_paged_decode_fns",
           "gpt_paged_prefill_fns", "gpt_paged_verify_fns",
           "gpt_paged_rollout_fns", "GPT", "Block", "CausalSelfAttention",
           "masked_linear_ce"]
