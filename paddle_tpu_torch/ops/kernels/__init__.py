"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  * `decode_attention.paged_decode_attention` — CUDA C++
    (`csrc/paged_decode_attention.cu`), replaces paddle_tpu's
    `ops/pallas/decode_attention.py` `_paged_kernel`.

`_build` compiles the `csrc/` sources with nvcc at first use."""
