"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package (`paddle_tpu`) is the reference; this package re-implements
its serving path on PyTorch for an NVIDIA Hopper GPU, one slice at a time.
Module names follow the JAX package so each counterpart is easy to find:

  * `models.gpt`            GPT configs, the paged decode forward, weights
  * `memory.page_allocator` refcounted KV page bookkeeping + pool ops
  * `ops.kernels`           hand-written CUDA kernels and their plain
                            PyTorch versions (`decode_attention`,
                            `quant_matmul`)
  * `quant`                 int8 PTQ of decode weights, int8 KV pages
  * `inference.decode`      the paged-KV continuous-batching DecodeEngine
  * `inference.serve`       the PDI1/PDI2 decode server

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise instead of carrying on on the CPU. This package
imports neither `jax` nor `paddle_tpu`.
"""

__version__ = "0.1.0"
