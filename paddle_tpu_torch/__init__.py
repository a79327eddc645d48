"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package (`paddle_tpu`) is the reference; this package re-implements
it on PyTorch for an NVIDIA Hopper GPU, one slice at a time. Module names
follow the JAX package so each counterpart is easy to find:

  * `models.gpt`            GPT configs; the contiguous and paged decode
                            forwards; the training `GPT`; weights
                            carried from JAX
  * `framework`             `save` / `load` (the JAX package's pickle
                            format), `ParamAttr`, `param_arrays` /
                            `state_arrays`: a layer's tensors as the flat
                            dicts the decode fns take
  * `memory.page_allocator` refcounted KV page bookkeeping + pool ops
  * `ops.kernels`           hand-written CUDA kernels and their plain
                            PyTorch versions (`decode_attention`,
                            `quant_matmul`, `flash_attention`)
  * `ops.basic`             the generic tensor ops of the training path
  * `quant`                 int8 PTQ of decode weights, int8 KV pages
  * `inference.decode`      the paged-KV continuous-batching DecodeEngine
  * `inference.serve`       the PDI1/PDI2 decode server
  * `nn`, `amp`, `optimizer`, `io`, `static`, `distributed.fleet`, `hapi`
                            the training slice: layers and functionals,
                            gradient clips, op-by-op AMP, SGD / Momentum /
                            Adam / AdamW with LR schedulers, datasets, the
                            strategy and its single-device train step,
                            `Model.fit` / `evaluate` / `predict` / `save` /
                            `load`
  * `metric`, `regularizer` Accuracy / Precision / Recall / Auc; L1Decay /
                            L2Decay
  * `io.checkpoint`         format-2 checkpoint directories (atomic,
                            checksummed), one process

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(or calls ``set_device("cpu")``); without a GPU they raise instead of
carrying on on the CPU. This package imports neither `jax` nor
`paddle_tpu`.
"""

from . import (amp, distributed, framework, hapi, io, metric, models, nn,
               optimizer, regularizer, static)
from .core.device import get_device, set_device
from .framework import ParamAttr, load, save
from .hapi import Model
from .core.flags import get_flags, set_flags
from .core.random import seed

__version__ = "0.1.0"

__all__ = ["amp", "distributed", "framework", "hapi", "io", "metric",
           "models", "nn", "optimizer", "regularizer", "static", "seed",
           "set_device", "get_device", "get_flags", "set_flags", "save",
           "load", "ParamAttr", "Model"]
