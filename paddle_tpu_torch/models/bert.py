"""BERT / ERNIE bidirectional encoder with the tied-embedding MLM head
(port of paddle_tpu's `models/bert.py`; benchmarks/run.py config 3).

`Bert` is the JAX package's layer for layer: token + position + segment
embeddings (each Normal(0, 0.02)), LayerNorm, a pre-LN
`TransformerEncoder` of gelu layers with no final norm, then
``mlm_ln(gelu(mlm_fc(x)))`` and the tied head (``h @ tok.weight.T``).
Attention is non-causal, so from T = `pallas_attention_min_seq` on every
layer runs the flash kernels with ``causal=False``. `mlm_loss` is the
masked tied-head CE of `models.gpt.masked_linear_ce`; at ERNIE's
V = 18048 (below `FUSED_MIN_VOCAB`) that is the unfused head, as in the
JAX package.

Weights: `params_from_numpy` is the one function that reads the JAX
package's layouts, the scan-stacked one (``encoder.layers.<rel>`` with a
leading [layers] axis, the JAX `Bert`'s raw parameters under its default
``scan_layers=True``) and the indexed one (``encoder.layers.<i>.<rel>``,
its `state_dict()`). `cfg.scan_layers` is accepted and the layers always
run as a Python loop (see `nn.layer.transformer`).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer import (Dropout, Embedding, Layer, LayerNorm, Linear,
                        TransformerEncoder, TransformerEncoderLayer)
from .. import ops
from .gpt import masked_linear_ce

__all__ = ["BertConfig", "bert_base", "bert_tiny", "ernie_base", "Bert",
           "Ernie", "param_shapes", "init_params_numpy", "params_from_numpy"]


@dataclasses.dataclass
class BertConfig:
    """Same fields and defaults as the JAX package's BertConfig."""
    vocab_size: int = 30592          # 30522 padded to a multiple of 128
    max_seq_len: int = 512
    type_vocab_size: int = 2
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    ffn_mult: int = 4
    dropout: float = 0.0
    fused_head_ce: bool = None       # None: fused from FUSED_MIN_VOCAB on
    scan_layers: bool = True         # accepted; the port always loops


def bert_base(**kw):
    return BertConfig(**kw)


def bert_tiny(**kw):
    return BertConfig(vocab_size=512, max_seq_len=128, hidden=64, layers=2,
                      heads=4, **kw)


def ernie_base(**kw):
    """ERNIE-base: the BERT-base encoder with ERNIE 1.0's vocabulary of
    18000, padded to a multiple of 128."""
    kw.setdefault("vocab_size", 18048)
    return BertConfig(**kw)


# ------------------------------------------------------------ parameters

_LAYER_SHAPES = (          # relative name -> shape as a function of cfg
    ("self_attn.q_proj.weight", lambda c: (c.hidden, c.hidden)),
    ("self_attn.q_proj.bias", lambda c: (c.hidden,)),
    ("self_attn.k_proj.weight", lambda c: (c.hidden, c.hidden)),
    ("self_attn.k_proj.bias", lambda c: (c.hidden,)),
    ("self_attn.v_proj.weight", lambda c: (c.hidden, c.hidden)),
    ("self_attn.v_proj.bias", lambda c: (c.hidden,)),
    ("self_attn.out_proj.weight", lambda c: (c.hidden, c.hidden)),
    ("self_attn.out_proj.bias", lambda c: (c.hidden,)),
    ("linear1.weight", lambda c: (c.hidden, c.ffn_mult * c.hidden)),
    ("linear1.bias", lambda c: (c.ffn_mult * c.hidden,)),
    ("linear2.weight", lambda c: (c.ffn_mult * c.hidden, c.hidden)),
    ("linear2.bias", lambda c: (c.hidden,)),
    ("norm1.weight", lambda c: (c.hidden,)),
    ("norm1.bias", lambda c: (c.hidden,)),
    ("norm2.weight", lambda c: (c.hidden,)),
    ("norm2.bias", lambda c: (c.hidden,)),
)

_LAYERS = "encoder.layers."


def param_shapes(cfg: BertConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's indexed name -> shape."""
    c = cfg.hidden
    out = {"tok.weight": (cfg.vocab_size, c),
           "pos.weight": (cfg.max_seq_len, c),
           "seg.weight": (cfg.type_vocab_size, c),
           "ln.weight": (c,), "ln.bias": (c,)}
    for i in range(cfg.layers):
        for rel, shape in _LAYER_SHAPES:
            out[f"{_LAYERS}{i}.{rel}"] = shape(cfg)
    out.update({"mlm_ln.weight": (c,), "mlm_ln.bias": (c,),
                "mlm_fc.weight": (c, c), "mlm_fc.bias": (c,)})
    return out


def init_params_numpy(cfg: BertConfig, seed: int = 0) -> Dict[str, np.ndarray]:
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


def params_from_numpy(cfg: BertConfig, arrays: Mapping[str, np.ndarray],
                      device=None) -> Dict[str, torch.Tensor]:
    """Carry JAX-package weights (numpy arrays, scan-stacked or indexed
    layout) into fp32 tensors on `device` (default cuda) under the
    indexed names. A missing, unknown or mis-shaped weight raises."""
    dev = resolve_device(device)
    flat: Dict[str, np.ndarray] = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        if k.startswith(_LAYERS) and not re.match(r"encoder\.layers\.\d+\.",
                                                  k):
            if v.ndim == 0 or v.shape[0] != cfg.layers:
                raise ValueError(f"params_from_numpy: {k} has shape "
                                 f"{v.shape}, want a leading [layers] axis "
                                 f"of {cfg.layers}")
            for i in range(cfg.layers):
                flat[f"{_LAYERS}{i}.{k[len(_LAYERS):]}"] = v[i]
        else:
            flat[k] = v
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(flat))
    stray = sorted(set(flat) - set(want))
    if missing or stray:
        raise KeyError(f"params_from_numpy: missing {missing[:4]}, "
                       f"unknown {stray[:4]}")
    out = {}
    for name, shape in want.items():
        a = flat[name]
        if tuple(a.shape) != shape or a.dtype.kind != "f":
            raise ValueError(f"params_from_numpy: {name} is {a.dtype} "
                             f"{tuple(a.shape)}, want float {shape}")
        out[name] = torch.tensor(a, dtype=torch.float32, device=dev)
    return out


# ----------------------------------------------------------------- model

class Bert(Layer):
    """Encoder + tied-embedding MLM head. forward(ids [B, T]) -> MLM
    logits [B, T, V]; mlm_loss(ids, labels) -> the masked tied-head CE.
    Parameters are created on the default device (`set_device`; cuda
    unless asked otherwise)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        emb_init = I.Normal(0.0, 0.02)
        self.tok = Embedding(cfg.vocab_size, cfg.hidden, weight_attr=emb_init)
        self.pos = Embedding(cfg.max_seq_len, cfg.hidden, weight_attr=emb_init)
        self.seg = Embedding(cfg.type_vocab_size, cfg.hidden,
                             weight_attr=emb_init)
        self.ln = LayerNorm(cfg.hidden)
        self.drop = Dropout(cfg.dropout)
        enc_layer = TransformerEncoderLayer(
            d_model=cfg.hidden, nhead=cfg.heads,
            dim_feedforward=cfg.ffn_mult * cfg.hidden, dropout=cfg.dropout,
            activation="gelu", normalize_before=True)
        self.encoder = TransformerEncoder(enc_layer, num_layers=cfg.layers,
                                          scan_layers=cfg.scan_layers)
        self.mlm_ln = LayerNorm(cfg.hidden)
        self.mlm_fc = Linear(cfg.hidden, cfg.hidden)

    def _on_device(self, t, dtype=None):
        t = torch.as_tensor(t, device=self.tok.weight.device)
        return t if dtype is None else t.to(dtype)

    def forward(self, ids, token_type_ids=None, attn_mask=None):
        h = self.forward_hidden(ids, token_type_ids=token_type_ids,
                                attn_mask=attn_mask)
        return F.linear(h, ops.transpose(self.tok.weight, [1, 0]))

    def forward_hidden(self, ids, token_type_ids=None, attn_mask=None):
        """Post-MLM-transform hidden states [B, T, C]: the tied head's
        input."""
        ids = self._on_device(ids, torch.long)
        B, T = ids.shape
        pos = torch.arange(T, device=ids.device)[None]
        seg = (self._on_device(token_type_ids, torch.long)
               if token_type_ids is not None
               else torch.zeros([B, T], dtype=torch.int64, device=ids.device))
        x = ops.add(ops.add(self.tok(ids), self.pos(pos)), self.seg(seg))
        x = self.drop(self.ln(x))
        mask = self._on_device(attn_mask) if attn_mask is not None else None
        x = self.encoder(x, src_mask=mask)
        return self.mlm_ln(F.gelu(self.mlm_fc(x)))

    def mlm_loss(self, ids, labels, ignore_index=-100, **kw):
        """The tied-head MLM CE over every position whose label is not
        `ignore_index`, through `masked_linear_ce` (fused from V >=
        FUSED_MIN_VOCAB unless `cfg.fused_head_ce` says otherwise)."""
        h = self.forward_hidden(ids, **kw)
        return masked_linear_ce(h, self.tok.weight, self._on_device(labels),
                                ignore_index=ignore_index,
                                fused=self.cfg.fused_head_ce)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len=None) -> int:
        """Train-step (fwd + bwd) FLOPs per token: 6N for the parameter
        matmuls plus 12 * layers * hidden * seq for attention's scores and
        values over the full T x T block."""
        c = self.cfg
        return 6 * self.num_params() \
            + 12 * c.layers * c.hidden * (seq_len or c.max_seq_len)

    def param_shardings(self, params, mesh_axis_tp="tp"):
        """Tensor-parallel PartitionSpecs need a multi-device mesh."""
        raise NotImplementedError(
            "Bert.param_shardings: tensor parallelism is not ported to "
            "paddle_tpu_torch (ROADMAP queue 1 item 7)")

    def load_numpy(self, arrays: Mapping[str, np.ndarray]):
        """Load the JAX Bert's weights as numpy arrays (its raw stacked
        parameters or its indexed `state_dict()`) through
        `params_from_numpy`. Returns self."""
        params = params_from_numpy(self.cfg, arrays,
                                   device=self.tok.weight.device)
        missing, unexpected = self.set_state_dict(params)
        if missing or unexpected:
            raise KeyError(f"Bert.load_numpy: missing {missing[:4]}, "
                           f"unexpected {unexpected[:4]}")
        return self


Ernie = Bert     # ERNIE is the BERT network with its own vocabulary
