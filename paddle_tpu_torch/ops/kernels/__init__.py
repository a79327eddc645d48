"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  * `decode_attention.paged_decode_attention` — CUDA C++
    (`csrc/paged_decode_attention.cu`), replaces paddle_tpu's
    `ops/pallas/decode_attention.py` `_paged_kernel`;
  * `decode_attention.paged_decode_attention_quant` — CUDA C++
    (`csrc/paged_decode_attention_int8.cu`), replaces `_paged_quant_kernel`
    of the same file;
  * `decode_attention.decode_attention` — CUDA C++
    (`csrc/decode_attention.cu`), replaces `_kernel` of the same file; the
    three decode-attention kernels share `csrc/paged_decode_split.cuh`;
  * `quant_matmul.int8_weight_matmul` — CUDA C++
    (`csrc/int8_weight_matmul.cu`), replaces `ops/pallas/quant_matmul.py`
    `_mm_kernel`;
  * `flash_attention.flash_attention` — CUDA C++
    (`csrc/flash_attention_fwd.cu`, `csrc/flash_attention_bwd.cu`, sharing
    `csrc/flash_attention_common.cuh`), replaces
    `ops/pallas/flash_attention.py` `_fwd_kernel`, `_bwd_dq_kernel` and
    `_bwd_dkv_kernel` (two-pass and fused);
  * `fused_ce.fused_linear_cross_entropy` — CUDA C++
    (`csrc/fused_linear_ce_fwd.cu`, `csrc/fused_linear_ce_bwd.cu`, sharing
    `csrc/fused_linear_ce_common.cuh`), replaces `ops/pallas/fused_ce.py`
    `_fwd_kernel`, `_bwd_dx_kernel` and `_bwd_dw_kernel`.

`_build` compiles the `csrc/` sources with nvcc at first use."""
