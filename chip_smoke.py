#!/usr/bin/env python3
"""Chip smoke test of paddle_tpu_torch on one NVIDIA GPU (built for H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. environment: card name and power limit, TF32 off, build every
     kernel under ops/kernels/csrc with nvcc (in parallel) and time it;
  2. each kernel against its plain PyTorch version at the shapes the main
     path gives it. Paged decode attention (row 1, split-KV: a cluster of
     8 CTAs per (b, h)): B=8, H=12, D=64, pt=16, W=64 over 12 layers with
     lengths over 1..1024, its edges (length 1, page multiples, W*pt, a
     length-1 row with an all-null table), lengths shorter than the split
     (CTAs with no rows), GPT-3 1.3B's head shape (B=8, H=16, D=128, pt=16,
     W=128) and its edges, D=16, 18 and 128 at a small shape and pools one
     element past an aligned address (narrower copies), max abs error
     <= 1e-5; two calls equal bit for bit; a CUDA graph of one call
     replayed, then replayed again after its lengths and tables changed in
     place, both within the gate; the kernel library's launch geometry
     against decode_attention.split_geometry; registers and spills (the
     build's -Xptxas -v log); kernel, plain and library (gather +
     scaled_dot_product_attention) device times (CUDA events around the
     replay of a CUDA graph of many calls, so the host's launch gaps are
     not counted; the eagerly launched time is printed beside), and the
     memory/compute bound, at the path's shape and at 1.3B's;
 2b. the int8 kernels the same way: int8 paged attention (row 2, the same
     split-KV template) on pools made by quantize_kv at phase 2's cases
     (<= 1e-4 against its plain version, <= 0.05 against the fp32
     attention of the unquantized pools; library = gather + dequantize +
     sdpa), with phase 2's bit-equality, graph, geometry, register and
     timing checks; then the int8-weight matmul: the HMMA count in the
     SASS of both of its tensor-core kernels (the M > 8 tiled kernel and
     the M <= 8 GEMV, which splits K over a thread-block cluster, on an
     exact three-piece bf16 split of x; 0 fails, as does any in the
     split-K reduce), the GEMV's registers and spills (a spill fails) and
     its launch geometry against quant_matmul.gemv_geometry, ragged shapes
     (unaligned operands, K in several passes), then the step's 48 block
     matmuls of the seed-0 GPT-2 weights quantized by quantize_params, at
     M=1, 2, 4 and 8 (the GEMV: two calls bit-equal, a CUDA graph replayed
     after x changed in place) and M=512 (<= 1e-4 against its plain
     version; library = torch.matmul on the fp32 weights; the bound of
     the three bf16 products beside the fp32 one), with one launch of
     each shape timed with its weight in L2; then one paged_prefill of a
     512-token prompt on int8 weights and pages beside the fp32 one, in
     device ms by kernel (the int8 path's time to first token on the
     card);
 2c. the contiguous-cache decode attention kernel (row 3: the split-KV
     template of rows 1-2 with the contiguous row address) against its
     plain version, <= 1e-5 with TF32 off, at the contiguous decode path's
     B=8, H=12, D=64, cap=1024 (lengths over 1..1024), at GPT-3 1.3B's
     head shape (H=16, D=128, cap=2048), at the edge lengths 0, 1, cap
     and cap+5, at lengths shorter than the split (CTAs with no rows), at
     a cap of 5, at D=16 and 128 and at a ragged B=3, cap=32, H=4, D=16;
     two calls equal bit for bit; a CUDA graph of one call replayed, then
     replayed again after its lengths changed in place (0, 1, cap, cap+5
     among them); the library's launch geometry against
     decode_attention.contig_split_geometry; registers and spills (a
     spill fails); kernel, plain and library (scaled_dot_product_attention
     over the [B, H, cap, D] views with a boolean mask of the live rows)
     device times by graph replay, eager beside them, and the bound, at
     the path's shape and the 1.3B shape;
  3. the main path: GPT-2 124M (random weights from seed 0) served by the
     paged DecodeEngine, 8 greedy requests (two sharing a 64-token head),
     every stream done, each token checked against a full forward
     (teacher-forced, within 1e-4 of the max logit), and the kernel's
     launch count equal to layers x decode steps; a steady window of 8
     distinct prompts decoding together gives tokens/s at 8 slots (the
     first window is mixed: a prefix hit feeds its prompt tail through
     the step at batch 1); then (3b) the decode step's time on the host
     clock (two readings) and its device time by kernel (torch.profiler)
     at B=8, 512 tokens per sequence;
  3-int8. the same engine run on save_for_decode(..., quant="int8") weights
     with int8 KV pages (load_for_decode(kv_dtype="int8")): phase 3's 8
     requests and its steady window, every stream done, each token
     checked against a full forward over the dequantized weights (within
     INT8_LOGIT_TOL of the max logit), launch counts equal to layers x
     steps (int8 attention) and 4 x layers x (steps + prefills) (int8
     matmul), page bytes against fp32, and phase 3b's step profile on
     the int8 path; (3c) the host cost of one eager call of what the int8
     step adds (the matmul wrapper beside torch.matmul, quantize_kv);
  3-contig. the contiguous-cache decode path, a user's own generate loop
     over `gpt_decode_fns`: GPT-2 124M on the seed-0 weights, 8 prompts
     of 7-900 tokens padded to the 1024 rung, prefill, then 32 greedy
     decode_steps; every token checked against a full forward (within
     1e-4 of the max logit), the kernel's launch count equal to layers x
     steps, the caches written in place (same shape, same storage); then
     the same on int8 block weights (quantize_params; fp32 caches), held
     to a full forward over the dequantized weights within 1e-4 and to
     4 x layers x (steps + 1) int8-matmul launches (the prefill's
     matmuls go through the kernel too); one decode_step of a port
     GPT(gpt_tiny()) fed through framework.param_arrays against the
     layer's own forward; and (3b-contig) phase 3b's step breakdown on
     this path (B=8, 512 tokens per sequence, cap 1024);
  4. the decode server: a save_for_decode artifact served by
     `python -m paddle_tpu_torch.inference.serve --decode` in a
     subprocess, 4 concurrent wire requests compared with phase 3, its
     own kernel launch count equal to layers x its decode steps, then
     SIGTERM and a clean drain; (4-int8) the same on the int8 artifact
     with --kv-dtype int8, held to the int8 engine and the int8 launch
     formulas;
 4-spec. speculative decoding (SpecDecodeEngine): (a) GPT-2 124M drafting
     for itself (the same seed-0 weights), k=4, 8 slots, 16-token pages,
     phase 3's 8 prompts, on fp32 and on int8 pages: every token within
     LOGIT_TOL (int8 pages: INT8_LOGIT_TOL) of a full forward's max logit,
     acceptance >= SPEC_MIN_ACCEPT, no kernel launched (fp32 weights; the
     verify and rollout attention are plain PyTorch); (b) the serving
     user's command, `serve --decode --draft-model <gpt2_124m> --speculate-k
     4 --draft-quant --metrics-port 0` over gpt2_345m() seed-0 weights
     saved with quant="int8", in a subprocess: 8 greedy requests (phase 3's
     prompts) and a seeded temperature request, concurrently; every greedy
     stream within LOGIT_TOL of a full forward over the dequantized target,
     the sampled stream equal to the in-process plain DecodeEngine's over
     the same artifact (and how many greedy streams equal its streams);
     /metrics scraped: text/plain 0.0.4, accepted + rejected = drafted,
     the acceptance gauge their ratio, tokens_total the tokens streamed,
     rollback releases > 0; the server's int8 matmul launches equal to 4 x
     (12 x (draft steps + draft prefills) + 24 x (verify calls +
     prefills)) from its own counters, and no attention launch; in process
     over the same artifacts, the steady window (8 distinct 128-token
     prompts x 64 tokens) speculative and plain, with acceptance, the k
     each slot ended at and host ms per tick in the rollout and the
     verify (launch counts held to the same formula); a B=8, 512-token
     tick's rollout and verify on the host clock and in device time by
     kernel; and row 4 at gpt2_345m's four block matmuls, against its
     plain version, by graph replay beside its bound and fp32
     torch.matmul: the GEMV at M = 1-6 and 8 (the verify at b_rung (k + 1)
     <= 8, the plain engine at M = b_rung; its route and launch geometry
     checked), the tiled kernel at the verify's M = 8 (k + 1) for k = 1,
     2, 4;
  5. flash attention forward (5) and backward (5b): first the counts of
     HMMA and HGMMA instructions in the SASS of each bf16 (tensor-core)
     flash kernel (cuobjdump -sass on the built library; the kernels run
     on wgmma and TMA, so each instantiation must show HGMMA and no HMMA),
     with each kernel's registers and spills from the build's -Xptxas -v
     log; then
     the kernels against their plain versions, fp32 (the SIMT kernels)
     with TF32 off at B=2, H=4, T=256, D=64 (causal and not; q/k/v as
     chunks of one qkv tensor and as separate tensors), at ragged shapes
     (T=200, D=128 causal and not; T=70, D=16) and at the main path's
     B=16, H=12, T=1024, D=64 causal, within the JAX contract (2e-5
     forward, 5e-4 backward); bf16 (the tensor-core kernels) at the same
     small and ragged shapes, at T=70, D=20 (zero-padded to 24 by the
     wrapper), at T=192 (a multiple of 64 but not of the kernels' 128-row
     tiles; D=64 and 128), with q, k, v strided views of one bf16 qkv
     tensor at T=384, H=3, D=128 (the tensor maps on non-contiguous
     strides), at the main path's shapes and at T=2048, against the plain
     version on the same bf16 tensors, the worst row's RMS error within
     FLASH_BF16_ROW_REL of that row's RMS, a gate the plain version with
     one 64-row tile left out must fail; two runs of the bf16 kernels at
     the main path's shape equal bit for bit; then device times at the
     main path's shapes (graph replay of the forward, the backward and
     each backward kernel alone; eager), the bound, the plain versions
     and PyTorch's flash attention forward (scaled_dot_product_attention)
     and backward (aten._scaled_dot_product_flash_attention_backward) as
     the library yardsticks, and the kernels against the composition sdpa
     takes below the threshold at T=512 and T=1024;
  6. training parity on the card: a narrow GPT (hidden 128, 2 layers, 2
     heads, V=512, T=512) in fp32 with TF32 off against the port on the
     CPU from the same numpy weights (loss within 1e-5, every gradient
     within 1e-4 of its largest value), one launch of each flash kernel
     per layer;
  7. training, full width: GPT-2 124M on the seed-0 numpy weights, driven
     as bench.py drives the JAX package (Model.prepare(Adam(1e-4),
     strategy=amp + use_pure_bf16) then Model.fit at B=16, T=1024): fp32
     parameters and Adam moments, bf16 into attention, every loss finite,
     launch counts of 12 x steps per flash kernel over the timed fits,
     the loss falling on one repeated batch; ms per step (bench.py's
     marginal estimate and CUDA events), tokens/s, MFU against 989
     TFLOP/s, peak memory, and one step's device time by kernel;
 11. (run after 7) the training lifecycle, full width: GPT-2 124M on the
     seed-0 weights, B=16, T=1024, AMP O2, AdamW(LinearWarmup(
     CosineAnnealingDecay(6e-4, T_max=8), 2 warmup steps), beta2=0.95,
     weight_decay=0.1, ClipGradByGlobalNorm(1.0)) with the by-step
     LRScheduler callback (the GPT-3 paper's Appendix B recipe, its
     schedule shortened), Model.fit over 2 epochs of 4 batches with
     eval_data of 2 batches and save_dir under ModelCheckpoint(keep_last=1):
     every loss and eval loss finite, the lr of every step equal to the
     scheduler's own sequence computed on the host, the post-clip global
     norm <= 1.0 (1 + 1e-6) wherever the pre-clip one is above 1.0, flash
     launches 12 x (train steps + eval batches) forward and 12 x train
     steps for dq and dk/dv, and no host sync inside a train step
     (torch.cuda.set_sync_debug_mode("error") around each); final.pdparams
     / .pdopt loaded into a fresh GPT + Model + AdamW bit-equal to the
     trained parameters, AdamW slots and scheduler state; 3 more steps
     from the loaded model and from the original against two runs from the
     original's state (the determinism spread: if those two are bit-equal,
     the resumed run must be too); the same state through
     io.checkpoint.save_checkpoint / load_checkpoint bit-equal and
     validate_checkpoint(deep=True); one AdamW + clip + scheduler step of a
     narrow GPT on the card against the CPU (loss within 1e-5, every
     parameter within 1e-4 of its largest); ms per step on the host clock
     and in device time (torch.profiler), the device us of the clip, of
     the AdamW update and of phase 7's Adam update, and the bytes and
     seconds of one Model.save and one Model.load;
  8. the fused linear-CE kernels (forward, dx, dW): first the HGMMA count
     in the SASS of the bf16 forward and backward kernels (wgmma; 0 fails,
     as does any HMMA or HGMMA in the fp32 SIMT ones), with registers and
     spills;
     then the kernels against their plain versions at the LM head, N=8192,
     H=2048, V=50304: fp32 with TF32 off within the JAX contract
     (rtol/atol 1e-4 for loss, lse and lab; rtol 2e-3, atol 1e-5 for dx
     and dW), bf16 against the plain version on the same bf16 tensors by
     the worst row's RMS error (CE_BF16_ROW_REL), a gate the plain version
     with one 64-wide tile left out must fail, a ragged N=200, H=96, V=700
     in both and a full-width ragged N=1000, H=2048, V=4100 in bf16; two
     bf16 forward, dx and dW calls equal bit for bit; device times by
     graph replay beside the bound, the plain versions, one cuBLAS bf16
     product of the same shape (a yardstick: the forward does one, each
     backward kernel two) and the forward-only composition
     F.cross_entropy(F.linear(x, w).float()), and the head's forward +
     backward as the fused kernels, the unfused head
     (`fused_head_ce=None`) and the library composition (F.linear bf16 +
     F.cross_entropy fp32), with their peak memory;
 8b. the flash kernels at the slice's attention shape, B=4, T=2048, H=16,
     D=128 causal: phase 5's SASS check again (HGMMA and no HMMA in every
     bf16 instantiation, registers and spills), fp32 within the JAX
     contract, bf16 to phase 5's row
     gate with its left-out tile, device times by graph replay of the
     forward, dq and dk/dv beside their bounds and plain versions, torch
     sdpa's forward and aten._scaled_dot_product_flash_attention_backward;
  9. recompute on the card: a narrow GPT (hidden 128, 2 layers, V=512,
     T=512, fused head) in fp32 whose loss and every gradient with
     per-block recompute (dots_saveable, nothing_saveable) equal those
     without, bit for bit, with 2 x layers flash forward launches against
     layers for dq and dk/dv, and one launch of each fused-CE kernel;
 10. the slice, benchmarks/run.py config 5's sequence: GPT-3 1.3B (seed-0
     weights built on the card, 1,315,819,520 parameters) `.bfloat16()`,
     `strategy.recompute`, Momentum(1e-4, 0.9),
     `compile_train_step(loss_method="loss")`, `prog._put_data`,
     `prog.step(ids, ids)` at B=4, T=2048: finite losses falling on the
     repeated batch, launches per step of flash forward 48, dq 24, dk/dv
     24 and each fused-CE kernel 1, bf16 parameters, gradients and
     velocities; ms per step (run.py's `_timed_steps(n_short=1,
     n_long=5)`), tokens/s, MFU against 989 TFLOP/s, peak memory, the
     device time by kernel, and two steps with `fused_head_ce=None`
     beside them;
 12. one JSON line {"kernels": [...]} with every kernel's numbers (eleven
     records: the ten kernels, and the flash dq + dk/dv pair as the TPU's
     fused backward);
 13. last line {"ok": true, "device": {...}}.

Without CUDA, or outside a checkout (no paddle_tpu_torch to import), it
exits non-zero and prints no result. It imports neither jax nor
paddle_tpu.
"""
import json
import math
import os
import queue
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12        # H100 SXM fp32, non-tensor-core
KERNEL_TOL = 1e-5               # kernel vs plain version, max abs error
LOGIT_TOL = 1e-4                # teacher-forced token vs max logit
INT8_KERNEL_TOL = 1e-4          # int8 kernels vs plain (tests/test_quant.py)
INT8_KV_TOL = 0.05              # int8 attention vs fp32 (docs/serving.md)
# int8 KV moves every logit of a stream away from the full forward over
# the same (dequantized) weights. Taking the documented int8-KV tolerance
# INT8_KV_TOL as that per-logit error e, the chosen token's logit is at
# most 2e below the oracle's max (its own error plus the max's), so the
# teacher-forced gap of an int8 stream must stay within 2 * 0.05.
INT8_LOGIT_TOL = 2 * INT8_KV_TOL
MATMULS = ("attn.qkv.weight", "attn.proj.weight", "fc1.weight",
           "fc2.weight")
# the kernels the decode server counts (its DECODE STATS line)
DECODE_KERNELS = ("paged_decode_attention", "paged_decode_attention_int8",
                  "int8_weight_matmul")
BF16_FLOPS_PER_S = 989e12       # H100 SXM bf16 dense tensor-core peak
FLASH_F32_FWD_TOL = 2e-5        # the JAX contract, test_pallas_kernels.py:38
FLASH_F32_BWD_TOL = 5e-4        # test_pallas_kernels.py:60
# bf16 kernels against the plain version run on the same bf16 tensors,
# which rounds the scaled q, P and dS to bf16 where the kernels do. What
# is left between them: fp32 summation order (~1e-6 relative), which now
# and then moves an output across a bf16 rounding boundary (one ulp, at
# most 2^-7 of that element), and the forward's P, rounded against the
# running max where the plain version uses the final one (2^-9 relative
# per term, averaged over the row's keys). The gate is per row (each
# [D] vector of O, dq, dk, dv): the RMS of the error over the RMS of the
# plain row, at most 2^-6, twice what a row has when every element of it
# is one ulp off. Leaving out one 64-key tile moves a row by ~0.25 of its
# RMS; phase 5 measures that and requires it above the gate. lse is fp32
# from the same rounded operands and keeps the fp32 gate.
FLASH_BF16_ROW_REL = 2.0 ** -6


def log(msg):
    print(msg, flush=True)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters, warm=3):
    """Mean device ms of fn(i) over `iters` calls (CUDA events, after
    warm-up)."""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters, warm=3):
    """Mean device ms of fn(i) over `iters` calls captured in one CUDA
    graph and replayed (CUDA events around the replay): the card's own
    time for the calls, without the gaps the host leaves between eager
    launches. `cuda_ms` of a small kernel called from Python measures
    mostly those gaps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warm):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def timings(torch, kernel, plain, library, iters):
    """Device ms of the kernel, its plain version and the library call
    (`graph_ms`), and the kernel's eagerly launched ms (`cuda_ms`, host
    launch gaps included)."""
    return {"ms": graph_ms(torch, kernel, iters),
            "plain_ms": graph_ms(torch, plain, max(iters // 5, 1)),
            "library_ms": graph_ms(torch, library, max(iters // 5, 1)),
            "eager_ms": cuda_ms(torch, kernel, iters)}


# ------------------------------------------------------- phases 2 and 2b

# B, H, D, pt, W of GPT-3 1.3B's heads on 2048-row sequences
PAGED_1P3B = (8, 16, 128, 16, 128)


def make_tables(np, rng, lengths, P, pt, W):
    """Block tables giving every sequence its own random live pages out
    of 1..P-1 (the rest null)."""
    perm = rng.permutation(np.arange(1, P))
    tables = np.zeros((len(lengths), W), np.int32)
    for b, n in enumerate(lengths):
        live = -(-int(n) // pt)
        tables[b, :live] = perm[b * W:b * W + live]
    return tables


class PagedCase:
    """One shape's inputs over L layers: random fp32 pools [L, P, pt, H,
    D] with P = B*W + 1 pages (for int8, their quantize_kv codes and
    scales), q per layer, and block tables giving every sequence its own
    random live pages; `call(li)` runs layer li's wrapper (kernel=None:
    the kernel, "reference": the plain version)."""

    def __init__(self, torch, np, rng, lens, L, pt, H, D, W, int8,
                 null_row=None, keep_fp32=True, misalign=False):
        from paddle_tpu_torch.quant.kv import quantize_kv
        B, P = len(lens), len(lens) * W + 1
        self.B, self.H, self.D, self.pt, self.W = B, H, D, pt, W
        self.lens, self.int8 = lens, int8
        g = torch.Generator(device="cuda").manual_seed(
            int(rng.integers(1 << 30)))
        k = torch.randn((L, P, pt, H, D), generator=g, device="cuda")
        v = torch.randn((L, P, pt, H, D), generator=g, device="cuda")
        self.q = torch.randn((L, B, H, D), generator=g, device="cuda")
        self.tables = torch.from_numpy(
            make_tables(np, rng, lens, P, pt, W)).cuda()
        self.lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        if null_row is not None:
            self.tables[null_row].zero_()
        self.pools = (*quantize_kv(k), *quantize_kv(v)) if int8 else (k, v)
        if misalign:    # K/V one element past an aligned address
            self.pools = tuple(
                t if t.dim() == 4 else torch.empty(
                    t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
                .view(t.shape).copy_(t) for t in self.pools)
        self.fp32 = (k, v) if keep_fp32 or not int8 else None

    def call(self, da, li, kernel=None):
        if self.int8:
            kq, ks, vq, vs = (t[li] for t in self.pools)
            return da.paged_decode_attention_quant(
                self.q[li], kq, ks, vq, vs, self.tables, self.lengths,
                kernel=kernel)
        k, v = self.pools
        return da.paged_decode_attention(self.q[li], k[li], v[li],
                                         self.tables, self.lengths,
                                         kernel=kernel)

    def truth(self, da, li):
        """The fp32 plain version on the unquantized pools."""
        k, v = self.fp32
        return da.paged_decode_attention(self.q[li], k[li], v[li],
                                         self.tables, self.lengths,
                                         kernel="reference")

    def library(self, torch, F, li):
        """Gather the table's pages (and dequantize), then one
        scaled_dot_product_attention with a boolean mask of the live
        rows."""
        from paddle_tpu_torch.quant.kv import dequantize_kv
        B, H, D, S = self.B, self.H, self.D, self.W * self.pt
        idx = self.tables.long()
        if self.int8:
            kq, ks, vq, vs = (t[li] for t in self.pools)
            kk = dequantize_kv(kq[idx], ks[idx])
            vv = dequantize_kv(vq[idx], vs[idx])
        else:
            kk, vv = self.pools[0][li][idx], self.pools[1][li][idx]
        live = (torch.arange(S, device="cuda")[None, :]
                < self.lengths[:, None].long())[:, None, None, :]
        return F.scaled_dot_product_attention(
            self.q[li][:, :, None, :],
            kk.reshape(B, S, H, D).transpose(1, 2),
            vv.reshape(B, S, H, D).transpose(1, 2), attn_mask=live)[:, :, 0]

    def bytes_flops(self):
        """What one call must move and compute on these lengths: q in,
        out, the live K/V rows (int8: codes and a scale per row and
        head), the live table entries and the lengths."""
        B, H, D = self.B, self.H, self.D
        rows = sum(self.lens)
        pages = sum(-(-n // self.pt) for n in self.lens)
        if self.int8:
            return (4 * 2 * B * H * D + 2 * rows * H * (D + 4)
                    + 4 * (pages + B), 6 * rows * H * D)
        return 4 * (2 * B * H * D + 2 * rows * H * D + pages + B), \
            4 * rows * H * D


def graph_replay_errs(torch, np, rng, da, case):
    """Capture one call of layer 0 in a CUDA graph, replay it, then change
    the lengths and the tables in place (new lengths, new pages) and
    replay it again: each replay's max abs error against the plain
    version on the values it ran on."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        case.call(da, 0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = case.call(da, 0)
    errs = []
    for step in range(2):
        if step:
            lens = [int(x) for x in rng.integers(1, case.W * case.pt + 1,
                                                 size=case.B)]
            case.lengths.copy_(torch.tensor(lens, dtype=torch.int32))
            case.tables.copy_(torch.from_numpy(make_tables(
                np, rng, lens, case.B * case.W + 1, case.pt, case.W)))
        graph.replay()
        torch.cuda.synchronize()
        errs.append((out - case.call(da, 0, "reference")).abs().max().item())
    del graph
    return errs


def check_split_geometry(da, int8, tag):
    """The kernel library's own launch geometry against decode_attention.py
    `split_geometry` (what the CPU tests check), shapes it takes and one
    it refuses."""
    import ctypes
    fn = da._geometry_fn("int8" if int8 else "paged")
    shapes = ((8, 12, 64, 16, 64), PAGED_1P3B, (3, 4, 16, 4, 8),
              (1, 1, 2, 1, 1), (8, 12, 64, 16, 20000))
    for shape in shapes:
        out = (ctypes.c_int * 7)()
        rc = fn(*shape, out)
        try:
            g = da.split_geometry(*shape, int8=int8)
            want = [*g["grid"], g["cluster"][0], g["threads"],
                    g["smem_bytes"], g["stage_rows"]]
        except ValueError:
            want = None
        if (rc != 0) != (want is None) or (want and list(out) != want):
            raise RuntimeError(f"{tag} geometry at {shape}: kernel rc {rc} "
                               f"{list(out)}, split_geometry {want}")
    log(f"{tag} split geometry: the kernel's equals split_geometry at "
        f"{len(shapes)} shapes (one refused by both); main path "
        f"{da.split_geometry(8, 12, 64, 16, 64, int8=int8)}")


def log_ptxas(lib, tag, no_spills=()):
    """Each entry function's registers and spills from the build log;
    raises if a function whose name holds one of `no_spills` spills."""
    from paddle_tpu_torch.ops.kernels import _build
    logf = _build.build([lib])[lib].with_suffix(".log")
    if not logf.is_file():
        raise RuntimeError(f"{tag}: no build log for {lib}")
    for fn, res in sorted(ptxas_by_kernel(logf.read_text()).items()):
        log(f"{tag} ptxas {lib} {fn}: registers {res.get('registers')}, "
            f"spill stores {res.get('spill_stores')} B, spill loads "
            f"{res.get('spill_loads')} B, static smem {res.get('smem')} B")
        if any(stem in fn for stem in no_spills) and (
                res.get("spill_stores") or res.get("spill_loads")):
            raise RuntimeError(f"{tag}: {lib} {fn} spills: {res}")


def phase_paged_attention(torch, np, int8):
    """Rows 1 (fp32, phase 2) and 2 (int8, phase 2b): the split-KV paged
    decode-attention kernels against their plain versions at the decode
    path's shape (B=8, H=12, D=64, pt=16, W=64 over 12 layers, seed-0
    lengths), its edges (length 1, page multiples, W*pt, a length-1 row
    with an all-null table), lengths shorter than the split, GPT-3 1.3B's
    head shape and its edges, head dims 16, 18 and 128 at a small shape,
    and pools one element past an aligned address;
    int8 also against the fp32 plain version of the unquantized pools.
    Then two calls bit-equal, a CUDA graph replayed after its lengths and
    tables change in place, the geometry, registers and spills, and the
    times at the path's shape and at 1.3B's."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    tag = "PHASE 2b" if int8 else "PHASE 2"
    name = "paged_decode_attention_int8" if int8 else "paged_decode_attention"
    tol = INT8_KERNEL_TOL if int8 else KERNEL_TOL
    B, H, D, pt, W, L = 8, 12, 64, 16, 64, 12
    bB, bH, bD, bpt, bW = PAGED_1P3B
    rng = np.random.default_rng(0)
    main_len = [int(x) for x in rng.integers(1, W * pt + 1, size=B)]
    big_len = [int(x) for x in rng.integers(1, bW * bpt + 1, size=bB)]
    # tag, lengths, layers, pt, H, D, W, the all-null row; D=18 copies
    # rows 8 (fp32) or 2 (int8) bytes at a time, "misaligned" pools 4 or 1
    cases = (
        ("main", main_len, L, pt, H, D, W, None),
        ("edges", [1, 16, 32, W * pt, 1, 17, 1008, 15], L, pt, H, D, W, 4),
        ("short", [1, 2, 3, 5, 7, 8, 9, 1], 2, pt, H, D, W, None),
        ("1p3b", big_len, 2, bpt, bH, bD, bW, None),
        ("1p3b-edges", [1, 16, bW * bpt, bW * bpt - 1, 1, 3, 129, 7], 2,
         bpt, bH, bD, bW, 4),
        ("d16", [1, 5, 32], 1, 4, 4, 16, 8, None),
        ("d128", [1, 5, 32], 1, 4, 4, 128, 8, None),
        ("d18", [1, 5, 32], 1, 4, 4, 18, 8, None),
        ("misaligned", [1, 5, 32], 2, 4, 4, 64, 8, None))
    errs, errs32 = {}, {}
    for ctag, lens, layers, cpt, ch, cd, cw, null in cases:
        case = PagedCase(torch, np, rng, lens, layers, cpt, ch, cd, cw, int8,
                         null, misalign=ctag == "misaligned")
        err = err32 = 0.0
        for li in range(layers):
            got = case.call(da, li)
            want = case.call(da, li, "reference")
            truth = case.truth(da, li) if int8 else want
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{name} {ctag}: non-finite")
            err = max(err, (got - want).abs().max().item())
            err32 = max(err32, (got - truth).abs().max().item())
        errs[ctag], errs32[ctag] = err, err32
        if ctag == "main":
            a, b = case.call(da, 0), case.call(da, 0)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise RuntimeError(f"{name}: two calls differ")
            graph_errs = graph_replay_errs(torch, np, rng, da, case)
        del case
    err, err32 = max(errs.values()), max(errs32.values())
    if err > tol or max(graph_errs) > tol or (int8 and err32 > INT8_KV_TOL):
        raise RuntimeError(f"{name} max abs err {errs} (gate {tol}), graph "
                           f"replays {graph_errs}, vs fp32 {errs32}")
    by_case = ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
    log(f"{tag} {name} max_abs_err={err:.3e} ({by_case}; gate {tol})"
        + (f" vs_fp32_err={err32:.3e} (gate {INT8_KV_TOL})" if int8 else "")
        + f"; two calls bit-equal; CUDA graph replay {graph_errs[0]:.3e}, "
        f"after the lengths and tables changed in place {graph_errs[1]:.3e}")
    check_split_geometry(da, int8, tag)
    log_ptxas(name, tag)

    def timed(lens, layers, cpt, ch, cd, cw):
        """Times over `layers` pools in turn (past the 50 MB L2, as a
        decode step's layer loop finds them)."""
        case = PagedCase(torch, np, rng, lens, layers, cpt, ch, cd, cw, int8,
                         keep_fp32=False)
        lib_err = (case.library(torch, F, 0)
                   - case.call(da, 0, "reference")).abs().max().item()
        t = timings(torch, lambda i: case.call(da, i % layers),
                    lambda i: case.call(da, i % layers, "reference"),
                    lambda i: case.library(torch, F, i % layers), 240)
        nbytes, flops = case.bytes_flops()
        del case
        torch.cuda.empty_cache()
        return t, lib_err, nbytes, flops

    t, lib_err, nbytes, flops = timed(main_len, L, pt, H, D, W)
    rec = kernel_record(
        name, f"{name}.cu",
        "paddle_tpu/ops/pallas/decode_attention.py:"
        + ("278" if int8 else "156"), err, t["ms"], t["plain_ms"],
        t["library_ms"], nbytes, flops, FP32_FLOPS_PER_S)
    log(f"{tag} {name} B={B} H={H} D={D} pt={pt} W={W} lengths={main_len} "
        f"kernel_ms={t['ms']:.6f} (graph replay; eager launches "
        f"{t['eager_ms']:.6f}) plain_ms={t['plain_ms']:.6f} "
        f"library_ms={t['library_ms']:.6f} (library vs plain err "
        f"{lib_err:.3e}) bound_ms={rec['bound_ms']:.6f} "
        f"({rec['bound_by']}, {nbytes} bytes, {flops} flops) "
        f"kernel_over_bound={t['ms'] / rec['bound_ms']:.2f}x")
    t, lib_err, nbytes, flops = timed(big_len, 4, bpt, bH, bD, bW)
    b_ms, b_by = bound(nbytes, flops, FP32_FLOPS_PER_S)
    log(f"{tag} {name} at GPT-3 1.3B's head shape B={bB} H={bH} D={bD} "
        f"pt={bpt} W={bW} lengths={big_len}: kernel_ms={t['ms']:.6f} "
        f"(graph replay; eager {t['eager_ms']:.6f}) plain_ms="
        f"{t['plain_ms']:.6f} library_ms={t['library_ms']:.6f} (library vs "
        f"plain err {lib_err:.3e}) bound_ms={b_ms:.6f} ({b_by}, {nbytes} "
        f"bytes) kernel_over_bound={t['ms'] / b_ms:.2f}x")
    return rec


GEMV_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))   # K, N


def check_gemv_geometry(qm, tag):
    """The kernel library's own GEMV launch geometry against
    quant_matmul.py `gemv_geometry` (what the CPU tests check): the step's
    four shapes at every batch rung, ragged ones, and shapes both refuse."""
    import ctypes
    fn = qm._geometry_fn()
    shapes = [(M, N, K) for K, N in GEMV_SHAPES for M in (1, 2, 4, 8)]
    shapes += [(1, 45, 37), (3, 770, 768), (2, 16, 20000), (9, 768, 768),
               (0, 768, 768)]
    for M, N, K in shapes:
        out = (ctypes.c_int * 8)()
        rc = fn(M, N, K, out)
        try:
            g = qm.gemv_geometry(M, N, K)
            want = [g["grid"][0], g["grid"][1], g["cluster"][0],
                    g["threads"], g["smem_bytes"], g["strip"], g["k_steps"],
                    g["pass_steps"]]
        except ValueError:
            want = None
        if (rc != 0) != (want is None) or (want and list(out) != want):
            raise RuntimeError(f"{tag} GEMV geometry at M={M} N={N} K={K}: "
                               f"kernel rc {rc} {list(out)}, gemv_geometry "
                               f"{want}")
    log(f"{tag} GEMV geometry: the kernel's equals gemv_geometry at "
        f"{len(shapes)} shapes (two refused by both); the step's shapes "
        + ", ".join(f"{K}x{N}: {qm.gemv_geometry(8, N, K)['grid'][:2]}"
                    for K, N in GEMV_SHAPES))


def gemv_graph_errs(torch, qm, g, x, w, s):
    """Capture one GEMV call in a CUDA graph, replay it, then write new
    values into x in place and replay again: each replay's max abs error
    against the plain version on the values it ran on."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qm.int8_weight_matmul(x, w, s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qm.int8_weight_matmul(x, w, s)
    errs = []
    for step in range(2):
        if step:
            x.copy_(torch.randn(x.shape, generator=g, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        errs.append((out - qm.int8_weight_matmul(
            x, w, s, kernel="reference")).abs().max().item())
    del graph
    return errs


def phase_int8_matmul(torch, np, cfg, qarrays, arrays):
    """The int8-weight matmul over one decode step's 48 block matmuls (12
    layers x qkv, proj, fc1, fc2 of the seed-0 weights), in the step's
    order, so the 85 MB of int8 weights stream from device memory as they
    do in a step; at M=1, 2, 4 and 8 (a decode step at each batch rung:
    the GEMV, a K split in a thread-block cluster on the tensor cores,
    bound by bytes) and M=512 (a prefill of 512 prompt rows: the tiled
    tensor-core kernel, whose bound is its three bf16 products, the fp32
    bound beside it). Before that: the SASS and spills of both kernels,
    ragged shapes (the scalar, bounds-checked staging; several passes
    over K), the GEMV's geometry, two GEMV calls bit-equal and a CUDA
    graph of one replayed after x changed in place. Returns the M=8
    record."""
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    tensor_cores(INT8_TC_KERNELS, "PHASE 2b")
    log_ptxas("int8_weight_matmul", "PHASE 2b", no_spills=INT8_NO_SPILLS)
    check_gemv_geometry(qm, "PHASE 2b")
    ws = []
    for i in range(cfg.layers):
        for rel in MATMULS:
            name = f"blocks.{i}.{rel}"
            ws.append((torch.from_numpy(qarrays[name]).cuda(),
                       torch.from_numpy(qarrays[name + "::scale"]).cuda(),
                       torch.from_numpy(arrays[name]).cuda()))
    g = torch.Generator(device="cuda").manual_seed(3)
    # ragged shapes first: the scalar (unaligned) paths of both kernels,
    # and K in several passes (K=20000 at one 16-column strip). The scales
    # shrink with sqrt(K / 768) past K=768, so every output has the
    # magnitude the absolute gate was set for (a sum of K fp32 products
    # grows as sqrt(K), and so does its rounding)
    errs = {}
    for M, K, N, off in ((1, 37, 45, 0), (3, 768, 770, 0), (8, 36, 48, 0),
                         (2, 1000, 200, 0), (4, 20000, 16, 0),
                         (8, 768, 768, 1), (70, 37, 45, 0),
                         (129, 100, 64, 0)):
        # off=1: x one float past an aligned address (the scalar staging)
        x = torch.randn((M * K + off,), generator=g, device="cuda")[off:] \
            .view(M, K)
        w = torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                          dtype=torch.int8)
        s = torch.rand((N,), generator=g, device="cuda") / 127 \
            * min(1.0, math.sqrt(768 / K))
        got = qm.int8_weight_matmul(x, w, s)
        want = qm.int8_weight_matmul(x, w, s, kernel="reference")
        torch.cuda.synchronize()
        errs[f"{M}x{K}x{N}" + ("+1" if off else "")] = \
            (got - want).abs().max().item()
    err = max(errs.values())
    by_shape = ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
    if err > INT8_KERNEL_TOL:
        raise RuntimeError(f"int8_weight_matmul ragged shapes max abs err "
                           f"{by_shape} (gate {INT8_KERNEL_TOL})")
    log(f"PHASE 2b int8_weight_matmul ragged shapes (M x K x N, +1: x off "
        f"16-byte alignment) max_abs_err={err:.3e} ({by_shape})")
    out = {}
    for M in (1, 2, 4, 8, 512):
        xs = {K: torch.randn((M, K), generator=g, device="cuda")
              for K in {w.shape[0] for w, _, _ in ws}}
        err = 0.0
        for w, s, _ in ws:
            got = qm.int8_weight_matmul(xs[w.shape[0]], w, s)
            want = qm.int8_weight_matmul(xs[w.shape[0]], w, s,
                                         kernel="reference")
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError("int8_weight_matmul: non-finite")
            err = max(err, (got - want).abs().max().item())
        if err > INT8_KERNEL_TOL:
            raise RuntimeError(f"int8_weight_matmul M={M} max abs err {err} "
                               f"> {INT8_KERNEL_TOL}")
        extra = ""
        if M <= qm.GEMV_M:
            for w, s, _ in ws[:len(MATMULS)]:
                x = xs[w.shape[0]]
                a = qm.int8_weight_matmul(x, w, s)
                b = qm.int8_weight_matmul(x, w, s)
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    raise RuntimeError(f"int8_weight_matmul M={M}: two "
                                       f"calls differ")
            w, s, _ = ws[0]
            graph_errs = gemv_graph_errs(torch, qm, g,
                                         xs[w.shape[0]].clone(), w, s)
            if max(graph_errs) > INT8_KERNEL_TOL:
                raise RuntimeError(f"int8_weight_matmul M={M} CUDA graph "
                                   f"replays {graph_errs}")
            extra = (f"; two calls bit-equal; CUDA graph replay "
                     f"{graph_errs[0]:.3e}, after x changed in place "
                     f"{graph_errs[1]:.3e}")

        def step(fn):
            def run(_):
                for w, s, wf in ws:
                    fn(xs[w.shape[0]], w, s, wf)
            return run

        t = timings(
            torch,
            step(lambda x, w, s, wf: qm.int8_weight_matmul(x, w, s)),
            step(lambda x, w, s, wf: qm.int8_weight_matmul(
                x, w, s, kernel="reference")),
            step(lambda x, w, s, wf: torch.matmul(x, wf)), 10)
        ms, plain_ms, library_ms = t["ms"], t["plain_ms"], t["library_ms"]
        nbytes = sum(w.numel() + 4 * (s.numel() + M * w.shape[0]
                                      + M * w.shape[1]) for w, s, _ in ws)
        flops = sum(2 * M * w.numel() + M * w.shape[1] for w, _, _ in ws)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_fp32 = flops / FP32_FLOPS_PER_S * 1e3
        # both kernels run three bf16 products on the tensor cores (the
        # GEMV's 8-row B tile whatever M); the bound counts the M rows
        # the function needs
        t_ops = 3 * 2 * M * sum(w.numel() for w, _, _ in ws) \
            / BF16_FLOPS_PER_S * 1e3
        out[M] = {"name": "int8_weight_matmul", "route": "cuda",
                  "source": "paddle_tpu_torch/ops/kernels/csrc/"
                            "int8_weight_matmul.cu",
                  "replaces": "paddle_tpu/ops/pallas/quant_matmul.py:43",
                  "launches": 0, "max_abs_err": err, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                  "library_ms": library_ms}
        log(f"PHASE 2b int8_weight_matmul M={M} over one step's "
            f"{len(ws)} block matmuls (K x N: 768x2304, 768x768, 768x3072, "
            f"3072x768 per layer) max_abs_err={err:.3e} (gate "
            f"{INT8_KERNEL_TOL}){extra} kernel_ms={ms:.6f} (graph replay; "
            f"eager launches {t['eager_ms']:.6f}) plain_ms={plain_ms:.6f} "
            f"library_ms={library_ms:.6f} (fp32 torch.matmul) "
            f"bound_ms={out[M]['bound_ms']:.6f} ({out[M]['bound_by']}, "
            f"{nbytes} bytes, {flops} flops; 3 bf16 products on the tensor "
            f"cores: {t_ops:.6f}; the fp32 bound 2MKN / 67 TFLOP/s: "
            f"{t_fp32:.6f}) kernel_over_bound={ms / out[M]['bound_ms']:.2f}x")
        for kn in sorted({tuple(w.shape) for w, _, _ in ws}):
            w, s, wf = next(t for t in ws if tuple(t[0].shape) == kn)
            one = graph_ms(torch, lambda _: qm.int8_weight_matmul(
                xs[w.shape[0]], w, s), 50)
            b1 = (w.numel() + 4 * (s.numel() + M * w.shape[0]
                                   + M * w.shape[1])) / HBM_BYTES_PER_S
            f1 = 6 * M * w.numel() / BF16_FLOPS_PER_S
            log(f"PHASE 2b int8_weight_matmul M={M} K x N={kn[0]}x"
                f"{kn[1]} one launch (weight in L2) kernel_ms="
                f"{one:.6f} bound_ms={max(b1, f1) * 1e3:.6f}")
    del ws
    torch.cuda.empty_cache()
    return out[8]


def phase_int8_prefill(torch, cfg, arrays, qarrays, power):
    """The int8 path's time to first token on the card: one paged_prefill
    of a 512-token prompt (seed-0 GPT-2 124M) on int8 weights and int8
    pages, beside the fp32 weights and pages, in device ms by kernel
    (torch.profiler, 3 calls each); the int8 one's 48 matmuls run the
    tensor-core kernel at M=512."""
    from paddle_tpu_torch.models.gpt import (gpt_paged_prefill_fns,
                                             params_from_numpy)
    from paddle_tpu_torch.quant.kv import kv_pool_zeros

    n, pt = 512, 16
    P = n // pt + 1
    prefill = gpt_paged_prefill_fns(cfg, page_tokens=pt)
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, n), generator=g)
    tables = torch.arange(1, P, dtype=torch.int32)[None]
    lens = torch.tensor([n])
    shape = (cfg.layers, P, pt, cfg.heads, cfg.head_dim)
    res = {}
    for name, src, kv in (("fp32", arrays, "float32"),
                          ("int8", qarrays, "int8")):
        params = params_from_numpy(cfg, src, "cuda")
        kp, vp = (kv_pool_zeros(shape, kv, "cuda") for _ in range(2))

        def one():
            logits, _, _ = prefill(params, kp, vp, toks, tables, lens)
            return logits

        logits = one()
        torch.cuda.synchronize()
        if not torch.isfinite(logits).all():
            raise RuntimeError(f"PHASE 2b {name} prefill: non-finite logits")
        prof = profile_kernels(torch, one, 3)
        mm = sum(us for k, (us, _) in prof.items()
                 if "int8_mma_kernel" in k or "int8_splitk" in k)
        res[name] = (sum(us for us, _ in prof.values()) / 1e3, mm / 1e3,
                     logits)
        del params, kp, vp
    err = (res["int8"][2] - res["fp32"][2]).abs().max().item()
    log(f"PHASE 2b prefill [{power}] gpt2_124m, one {n}-token prompt "
        f"through paged_prefill (device ms per call, torch.profiler): fp32 "
        f"weights and pages {res['fp32'][0]:.6f}; int8 weights and pages "
        f"{res['int8'][0]:.6f}, of which the int8 matmul kernels "
        f"{res['int8'][1]:.6f} (48 launches); int8 over fp32 "
        f"{res['int8'][0] / res['fp32'][0]:.2f}x; last-position logits "
        f"int8 vs fp32 max abs diff {err:.3e}")


# ----------------------------------------------------------- phase 2c

def contiguous_attention_inputs(torch, g, L, lengths, cap, H, D):
    """Random q [L, B, H, D] and contiguous caches k, v [L, B, cap, H, D]
    (one per layer), and the lengths as int32."""
    B = len(lengths)
    q = torch.randn((L, B, H, D), generator=g, device="cuda")
    k = torch.randn((L, B, cap, H, D), generator=g, device="cuda")
    v = torch.randn((L, B, cap, H, D), generator=g, device="cuda")
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def contig_graph_errs(torch, np, rng, da, q, k, v, lengths):
    """Capture one decode_attention call in a CUDA graph, replay it, then
    write new lengths in place (0, 1, cap and past it among them) and
    replay again: each replay's max abs error against the plain version on
    the values it ran on."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.decode_attention(q, k, v, lengths)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention(q, k, v, lengths)
    errs = []
    cap = k.shape[1]
    for step in range(2):
        if step:
            lens = [0, 1, cap, cap + 5] + [
                int(x) for x in rng.integers(1, cap + 1,
                                             size=len(lengths) - 4)]
            lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        errs.append((out - da.decode_attention(
            q, k, v, lengths, kernel="reference")).abs().max().item())
    del graph
    return errs


def check_contig_geometry(da, tag):
    """The kernel library's own launch geometry against decode_attention.py
    `contig_split_geometry` (what the CPU tests check), shapes it takes and
    ones it refuses."""
    import ctypes
    fn = da._geometry_fn("contig")
    shapes = ((8, 12, 64, 1024), (8, 16, 128, 2048), (3, 4, 16, 32),
              (1, 1, 2, 1), (4, 4, 64, 5), (8, 12, 63, 1024),
              (8, 12, 64, 0))
    for shape in shapes:
        out = (ctypes.c_int * 7)()
        rc = fn(*shape, out)
        try:
            g = da.contig_split_geometry(*shape)
            want = [*g["grid"], g["cluster"][0], g["threads"],
                    g["smem_bytes"], g["stage_rows"]]
        except ValueError:
            want = None
        if (rc != 0) != (want is None) or (want and list(out) != want):
            raise RuntimeError(f"{tag} geometry at {shape}: kernel rc {rc} "
                               f"{list(out)}, contig_split_geometry {want}")
    log(f"{tag} contiguous split geometry: the kernel's equals "
        f"contig_split_geometry at {len(shapes)} shapes (two refused by "
        f"both); main path {da.contig_split_geometry(8, 12, 64, 1024)}")


def phase_decode_attention(torch, np):
    """Row 3's kernel (contiguous-cache decode attention, the split-KV
    template with the contiguous row address) against its plain version
    at the contiguous decode path's shape, GPT-3 1.3B's head shape, the
    edge lengths 0, 1, cap and cap + 5, lengths shorter than the split
    (CTAs with no rows), a cap shorter than the split, head dims 16 and
    128 at a small shape, and a ragged small case; two calls bit-equal, a
    CUDA graph replayed after its lengths change in place, the geometry,
    registers and spills; then its times at the path's shape, and the
    1.3B shape's."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    B, H, D, cap, L = 8, 12, 64, 1024, 12
    rng = np.random.default_rng(0)
    g = torch.Generator(device="cuda").manual_seed(5)
    main_len = [int(x) for x in rng.integers(1, cap + 1, size=B)]
    big_len = [int(x) for x in rng.integers(1, 2048 + 1, size=B)]
    cases = (("gpt2", main_len, cap, H, D),
             ("gpt2-edges", [0, 1, cap, cap + 5], cap, H, D),
             ("short", [1, 2, 3, 5, 7, 8, 9, 0], cap, H, D),
             ("1p3b", big_len, 2048, 16, 128),
             ("1p3b-edges", [0, 1, 2048, 2048 + 5], 2048, 16, 128),
             ("cap5", [0, 2, 5, 7], 5, 4, 64),
             ("d16", [0, 3, 7, 40], 40, 4, 16),
             ("d128", [0, 3, 7, 40], 40, 4, 128),
             ("ragged", [1, 17, 32], 32, 4, 16))
    errs = {}
    for tag, lens, c, h, d in cases:
        q, k, v, lengths = contiguous_attention_inputs(torch, g, 2, lens, c,
                                                       h, d)
        err = 0.0
        for li in range(2):
            got = da.decode_attention(q[li], k[li], v[li], lengths)
            want = da.decode_attention(q[li], k[li], v[li], lengths,
                                       kernel="reference")
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"decode_attention {tag}: non-finite")
            err = max(err, (got - want).abs().max().item())
        errs[tag] = err
        if tag == "gpt2":
            a = da.decode_attention(q[0], k[0], v[0], lengths)
            b = da.decode_attention(q[0], k[0], v[0], lengths)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise RuntimeError("decode_attention: two calls differ")
            graph_errs = contig_graph_errs(torch, np, rng, da, q[0], k[0],
                                           v[0], lengths)
        del q, k, v
    err = max(errs.values())
    if err > KERNEL_TOL or max(graph_errs) > KERNEL_TOL:
        raise RuntimeError(f"decode_attention max abs err {errs}, graph "
                           f"replays {graph_errs} (gate {KERNEL_TOL})")
    log(f"PHASE 2c decode_attention two calls bit-equal; CUDA graph replay "
        f"{graph_errs[0]:.3e}, after the lengths changed in place (0, 1, "
        f"cap, cap+5 among them) {graph_errs[1]:.3e}")
    check_contig_geometry(da, "PHASE 2c")
    log_ptxas("decode_attention", "PHASE 2c", no_spills=("split_kernel",))

    def timed(lens, c, h, d, layers):
        """Times over `layers` caches in turn (past the 50 MB L2, as a
        decode step's layer loop finds them), and the bound."""
        q, k, v, lengths = contiguous_attention_inputs(torch, g, layers,
                                                       lens, c, h, d)
        live = (torch.arange(c, device="cuda")[None, :]
                < lengths[:, None].long())[:, None, None, :]   # [B,1,1,c]

        def kernel(i):
            li = i % layers
            return da.decode_attention(q[li], k[li], v[li], lengths)

        def plain(i):
            li = i % layers
            return da.decode_attention(q[li], k[li], v[li], lengths,
                                       kernel="reference")

        def library(i):
            li = i % layers
            return F.scaled_dot_product_attention(
                q[li][:, :, None], k[li].transpose(1, 2),
                v[li].transpose(1, 2), attn_mask=live)[:, :, 0]

        lib_err = (library(0) - plain(0)).abs().max().item()
        t = timings(torch, kernel, plain, library, 240)
        rows = sum(min(n, c) for n in lens)
        nbytes = 4 * (2 * len(lens) * h * d    # q in, out
                      + 2 * rows * h * d       # live K and V rows
                      + len(lens))             # lengths
        flops = 4 * rows * h * d               # q.k and p.v, 2 flops each
        del q, k, v
        torch.cuda.empty_cache()
        return t, lib_err, nbytes, flops

    t, lib_err, nbytes, flops = timed(main_len, cap, H, D, L)
    rec = kernel_record(
        "decode_attention", "decode_attention.cu",
        "paddle_tpu/ops/pallas/decode_attention.py:68", err, t["ms"],
        t["plain_ms"], t["library_ms"], nbytes, flops, FP32_FLOPS_PER_S)
    by_case = ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
    log(f"PHASE 2c decode_attention B={B} H={H} D={D} cap={cap} "
        f"lengths={main_len} max_abs_err={err:.3e} ({by_case}; gate "
        f"{KERNEL_TOL}) "
        f"kernel_ms={t['ms']:.6f} (graph replay; eager launches "
        f"{t['eager_ms']:.6f}) plain_ms={t['plain_ms']:.6f} "
        f"library_ms={t['library_ms']:.6f} (sdpa with a boolean mask; "
        f"library vs plain err {lib_err:.3e}) bound_ms="
        f"{rec['bound_ms']:.6f} ({rec['bound_by']}, {nbytes} bytes, {flops} "
        f"flops) kernel_over_bound={t['ms'] / rec['bound_ms']:.2f}x")
    t, lib_err, nbytes, _ = timed(big_len, 2048, 16, 128, 4)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"PHASE 2c decode_attention at GPT-3 1.3B's head shape B=8 H=16 "
        f"D=128 cap=2048 lengths={big_len}: kernel_ms={t['ms']:.6f} "
        f"(graph replay; eager {t['eager_ms']:.6f}) plain_ms="
        f"{t['plain_ms']:.6f} library_ms={t['library_ms']:.6f} (library vs "
        f"plain err {lib_err:.3e}) bound_ms={b_ms:.6f} (bytes) "
        f"kernel_over_bound={t['ms'] / b_ms:.2f}x")
    return rec


# ------------------------------------------------------------ phase 3

def teacher_forced(torch, model, prompt, out):
    """Largest gap between the max logit and the chosen token's logit of a
    full forward over prompt + out, at every generated position."""
    toks = torch.tensor([list(prompt) + list(out)], device="cuda")
    logits = model(toks)[0]
    if not torch.isfinite(logits).all():
        raise RuntimeError("full forward produced non-finite logits")
    rows = logits[len(prompt) - 1:len(prompt) - 1 + len(out)]
    chosen = rows[torch.arange(len(out), device="cuda"),
                  torch.tensor(out, device="cuda")]
    return (rows.max(dim=-1).values - chosen).max().item()


def kernel_counts():
    """Every kernel wrapper's launch count, by kernel name."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_ce as fce
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm
    return {"decode_attention": da.contig_launches,
            "paged_decode_attention": da.launches,
            "paged_decode_attention_int8": da.quant_launches,
            "int8_weight_matmul": qm.launches,
            "flash_attention_fwd": fa.fwd_launches,
            "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.bwd_launches,
            "fused_linear_ce_fwd": fce.fwd_launches,
            "fused_linear_ce_bwd_dx": fce.dx_launches,
            "fused_linear_ce_bwd_dw": fce.dw_launches}


def zero_counts():
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_ce as fce
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm
    da.contig_launches = da.launches = da.quant_launches = qm.launches = 0
    fa.fwd_launches = fa.dq_launches = fa.bwd_launches = 0
    fce.fwd_launches = fce.dx_launches = fce.dw_launches = 0


def expected_counts(cfg, steps, prefills, int8, contig=False):
    """Launches a decode run must show: one attention launch per layer per
    decode step (the contiguous kernel on the contiguous path, else the
    paged one, int8 on int8 pages), on int8 weights one matmul launch per
    block matmul per step and per prefill, and no other kernel."""
    want = {k: 0 for k in kernel_counts()}
    attn = ("decode_attention" if contig
            else "paged_decode_attention_int8" if int8
            else "paged_decode_attention")
    want[attn] = cfg.layers * steps
    if int8:
        want["int8_weight_matmul"] = \
            len(MATMULS) * cfg.layers * (steps + prefills)
    return want


def phase_engine(torch, np, power, cfg, eng, oracle, tol, tag, int8):
    """Serve phase 3's 8 greedy requests (two sharing a 64-token head)
    and then the steady 8-stream window on `eng`; hold every token to the
    full forward of `oracle` (teacher-forced, within `tol` of the max
    logit) and the launch counts to `expected_counts`."""
    rng = np.random.default_rng(1)
    head = [int(t) for t in rng.integers(0, cfg.vocab_size, 64)]
    prompts = []
    for i, n in enumerate((7, 16, 100, 255, 300, 511, 700, 900)):
        tail = [int(t) for t in rng.integers(0, cfg.vocab_size, n)]
        prompts.append(head + tail[:n - 64] if i in (3, 4) else tail)
    max_new = 32
    try:
        zero_counts()
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        outs = [s.result(timeout=600) for s in streams]
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        st = eng.stats()
        steady = steady_window(eng, cfg, rng, int8)
    finally:
        eng.stop()
    if any(len(o) != max_new for o in outs):
        raise RuntimeError(f"short streams: {[len(o) for o in outs]}")
    want = expected_counts(cfg, st["steps"], st["prefills"], int8)
    if counts != want or st["steps"] == 0:
        raise RuntimeError(f"{tag}: kernel launches {counts} != {want} "
                           f"({st['steps']} steps, {st['prefills']} "
                           f"prefills)")
    if st["prefix_cache"]["hits"] < 1:
        raise RuntimeError(f"expected a prefix hit: {st['prefix_cache']}")
    gaps = [teacher_forced(torch, oracle, p, o) for p, o in zip(prompts, outs)]
    if max(gaps) > tol:
        raise RuntimeError(f"{tag}: teacher-forced check failed: gaps {gaps}")
    tokens = sum(len(o) for o in outs)
    step_ms = st["step_seconds"] / st["steps"] * 1e3
    log(f"{tag} engine gpt2_124m kv_dtype={st['kv_dtype']} slots=8 "
        f"page_tokens=16 requests=8 "
        f"prompt_lens={[len(p) for p in prompts]} max_new={max_new} "
        f"streams_done=8 tokens={tokens} steps={st['steps']} "
        f"prefills={st['prefills']} prefix={st['prefix_cache']} "
        f"cow={st['cow_copies']} kernel_launches={counts} "
        f"teacher_forced_max_gap={max(gaps):.3e} (gate {tol})")
    # a mixed window: most of its steps run one stream feeding the
    # prefix hit's prompt tail at batch 1, and yield no token
    log(f"{tag} mixed window [{power}]: wall_s={wall:.6f} "
        f"tokens_per_s={tokens / wall:.3f} ms_per_step={step_ms:.6f} "
        f"tokens_per_step={st['tokens'] - st['prefills']}/{st['steps']} "
        f"(step_seconds={st['step_seconds']:.6f} over {st['steps']} steps, "
        f"step = host->device inputs + 12-layer paged step + logits to "
        f"host)")
    s_prompts, s_outs, s_wall, s_st = steady
    s_gaps = [teacher_forced(torch, oracle, p, o)
              for p, o in zip(s_prompts, s_outs)]
    if max(s_gaps) > tol:
        raise RuntimeError(f"{tag}: steady window teacher-forced check "
                           f"failed: gaps {s_gaps}")
    s_tokens = sum(len(o) for o in s_outs)
    log(f"{tag} steady window [{power}]: 8 distinct "
        f"{len(s_prompts[0])}-token prompts x {len(s_outs[0])} new tokens, "
        f"wall_s={s_wall:.6f} tokens_per_s={s_tokens / s_wall:.3f} "
        f"steps={s_st['steps']} tokens_per_step="
        f"{(s_tokens - s_st['prefills']) / s_st['steps']:.3f} "
        f"ms_per_step={s_st['step_seconds'] / s_st['steps'] * 1e3:.6f} "
        f"prefills={s_st['prefills']} "
        f"prefill_s={s_wall - s_st['step_seconds']:.6f} (wall less steps) "
        f"kernel_launches={s_st['launches']} "
        f"teacher_forced_max_gap={max(s_gaps):.3e}")
    return prompts, outs, counts, gaps


def steady_window(eng, cfg, rng, int8, n=8, plen=128, max_new=64,
                  expect=None):
    """8 streams decoding together: distinct prompts (no prefix hit, so
    no prompt tail goes through the step), all submitted at once. Returns
    (prompts, outputs, wall seconds, stats deltas). The launch counts must
    equal `expect(deltas)` (default: `expected_counts` of the plain
    engine); a speculative engine's deltas carry its `speculate` block's
    counters too."""
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, plen)]
               for _ in range(n)]
    before = eng.stats()
    zero_counts()
    t0 = time.perf_counter()
    streams = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    outs = [s.result(timeout=600) for s in streams]
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    after = eng.stats()
    st = {k: after[k] - before[k] for k in ("steps", "step_seconds",
                                            "prefills", "tokens")}
    for k, v in after.get("speculate", {}).items():
        if isinstance(v, (int, float)) \
                and k not in ("k_max", "acceptance_rate"):
            st[k] = v - before["speculate"][k]
    st["launches"] = launches
    want = expect(st) if expect is not None else \
        expected_counts(cfg, st["steps"], st["prefills"], int8)
    if any(len(o) != max_new for o in outs) or st["steps"] == 0 \
            or launches != want:
        raise RuntimeError(f"steady window: streams "
                           f"{[len(o) for o in outs]}, {st}, launches "
                           f"wanted {want}")
    st["k_final"] = [getattr(s, "spec_k", None) for s in streams]
    return prompts, outs, wall, st


def phase_step_profile(torch, np, cfg, params, power, kv_dtype, tag):
    """Where a decode step's time goes: the 12-layer paged step at B=8,
    every sequence 512 tokens long, timed on the host clock (inputs in,
    logits out, as the engine runs it) and traced with torch.profiler
    for device time by kernel. `params` and `kv_dtype` pick the fp32 or
    the int8 path."""
    from paddle_tpu_torch.models.gpt import gpt_paged_decode_fns
    from paddle_tpu_torch.quant.kv import kv_pool_zeros

    B, pt, W, n = 8, 16, 64, 512
    P = B * W + 1
    _, step = gpt_paged_decode_fns(cfg, page_tokens=pt)
    shape = (cfg.layers, P, pt, cfg.heads, cfg.head_dim)
    kpool = kv_pool_zeros(shape, kv_dtype, "cuda")
    vpool = kv_pool_zeros(shape, kv_dtype, "cuda")
    rng = np.random.default_rng(2)
    tables = np.zeros((B, W), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b in range(B):
        tables[b, :n // pt + 1] = perm[b * W:b * W + n // pt + 1]
    tables = torch.from_numpy(tables)
    ltok = torch.from_numpy(rng.integers(0, cfg.vocab_size, B))
    clen = torch.full((B,), n, dtype=torch.long)

    def one():
        logits, _, _ = step(params, kpool, vpool, tables, ltok, clen)
        return logits.float().cpu()

    step_breakdown(torch, one, power, tag,
                   f"gpt2_124m kv_dtype={kv_dtype} B={B} len={n}")


def step_breakdown(torch, one, power, tag, what):
    """Time the decode step `one` (inputs in, logits out) on the host clock
    (two readings) and trace it with torch.profiler for its device time by
    kernel; log both under `tag`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        one()
    # two readings in one process: how far the host clock spreads here
    iters = 20
    host = []
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(iters):
            one()
        host.append((time.perf_counter() - t0) / iters * 1e3)
    host_ms = min(host)
    steps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            one()
    rows = []
    for ev in prof.key_averages():
        # device-side events only: a CPU op (aten::mm) also reports the
        # time of the kernels it launched, which would count them twice
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / steps, ev.count / steps, ev.key))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3
    top = "; ".join(f"{name[:60]} {us:.1f}us x{cnt:g}"
                    for us, cnt, name in rows[:8])
    log(f"{tag} step breakdown [{power}]: {what} "
        f"host_ms_per_step={host_ms:.6f} (readings "
        f"{', '.join(f'{h:.6f}' for h in host)}) "
        f"device_ms_per_step={dev_ms if rows else 'not measured'} "
        f"device_busy_share="
        f"{(dev_ms / host_ms) if rows else 'not measured'} "
        f"top kernels per step: {top or 'no device events recorded'}")


def phase_host_costs(torch, power):
    """Host microseconds per eager call of what the int8 step adds: the
    int8-weight matmul wrapper (beside the torch.matmul it replaces) and
    quantize_kv of one step's new K rows, at B=8 decode shapes."""
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm
    from paddle_tpu_torch.quant.kv import quantize_kv

    def us(fn, n=2000):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return t

    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((8, 768), generator=g, device="cuda")
    w = torch.randint(-127, 128, (768, 768), generator=g, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((768,), generator=g, device="cuda")
    wf = w.float()
    rows = x.reshape(8, 12, 64)
    zero_counts()
    costs = {"int8_weight_matmul": us(lambda: qm.int8_weight_matmul(x, w, s)),
             "torch.matmul": us(lambda: torch.matmul(x, wf)),
             "quantize_kv": us(lambda: quantize_kv(rows))}
    log(f"PHASE 3c host us per eager call [{power}]: "
        + " ".join(f"{k}={v:.3f}" for k, v in costs.items())
        + " (M=8, K=N=768; quantize_kv of [8, 12, 64] rows, twice per "
          "layer per int8 step)")


# ------------------------------------------------------- phase 3-contig

def phase_contiguous_decode(torch, np, cfg, params, oracle, tag, int8):
    """The contiguous-cache decode path as a user's own generate loop
    drives it: `gpt_decode_fns`' prefill over 8 prompts of distinct
    lengths padded to their capacity rung, then 32 greedy decode_steps.
    Every token held to the full forward of `oracle` (teacher-forced,
    within LOGIT_TOL of the max logit), the launch counts to
    `expected_counts` (one prefill), and the caches written in place."""
    from paddle_tpu_torch.inference.decode import kv_capacity_ladder
    from paddle_tpu_torch.models.gpt import gpt_decode_fns

    rng = np.random.default_rng(3)
    lens = (7, 16, 100, 255, 300, 511, 700, 900)
    steps = 32
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in lens]
    cap = min(r for r in kv_capacity_ladder(cfg.max_seq_len)
              if r >= max(lens) + steps)
    toks = torch.zeros((len(lens), cap), dtype=torch.long)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = torch.tensor(p)
    prefill, step = gpt_decode_fns(cfg)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    logits, k, v = prefill(params, toks.cuda(), torch.tensor(lens).cuda())
    shape, ptrs = tuple(k.shape), (k.data_ptr(), v.data_ptr())
    clen = torch.tensor(lens, device="cuda")
    tok = logits.argmax(-1)
    chosen = [tok]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(steps):
        logits, k2, v2 = step(params, k, v, tok, clen)
        if k2 is not k or v2 is not v:
            raise RuntimeError(f"{tag}: decode_step returned new caches")
        tok = logits.argmax(-1)
        chosen.append(tok)
        clen += 1
    outs = torch.stack(chosen, 1).tolist()          # synchronises
    t2 = time.perf_counter()
    counts = kernel_counts()
    if tuple(k.shape) != shape or (k.data_ptr(), v.data_ptr()) != ptrs:
        raise RuntimeError(f"{tag}: caches moved: {tuple(k.shape)} vs "
                           f"{shape}")
    want = expected_counts(cfg, steps, 1, int8, contig=True)
    if counts != want:
        raise RuntimeError(f"{tag}: kernel launches {counts} != {want}")
    if not torch.isfinite(logits).all():
        raise RuntimeError(f"{tag}: non-finite logits")
    gaps = [teacher_forced(torch, oracle, p, o)
            for p, o in zip(prompts, outs)]
    if max(gaps) > LOGIT_TOL:
        raise RuntimeError(f"{tag}: teacher-forced check failed: gaps "
                           f"{gaps} (gate {LOGIT_TOL})")
    log(f"{tag} gpt_decode_fns gpt2_124m weights="
        f"{'int8' if int8 else 'fp32'} kv=fp32 B={len(lens)} "
        f"prompt_lens={list(lens)} cap={cap} steps={steps} "
        f"tokens_per_stream={len(outs[0])} caches {list(shape)} written in "
        f"place kernel_launches={counts} teacher_forced_max_gap="
        f"{max(gaps):.3e} (gate {LOGIT_TOL}) prefill_s={t1 - t0:.6f} "
        f"ms_per_step={(t2 - t1) / steps * 1e3:.6f} (host clock, greedy "
        f"loop with argmax on the card)")
    del k, v, k2, v2
    torch.cuda.empty_cache()
    return counts


def phase_port_gpt_step(torch, np):
    """One decode_step of a port `GPT(gpt_tiny())` fed through
    `framework.param_arrays`, against that layer's own full forward."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models.gpt import GPT, gpt_decode_fns, gpt_tiny

    ptt.seed(0)
    model = GPT(gpt_tiny())
    model.eval()
    params = framework.param_arrays(model)
    prefill, step = gpt_decode_fns(model.cfg, eps=model.ln_f._epsilon)
    rng = np.random.default_rng(4)
    toks = [int(t) for t in rng.integers(0, model.cfg.vocab_size, 9)]
    padded = torch.zeros((1, 32), dtype=torch.long, device="cuda")
    padded[0, :9] = torch.tensor(toks)
    logits, k, v = prefill(params, padded, torch.tensor([9], device="cuda"))
    last = int(logits[0].argmax())
    zero_counts()
    logits, k, v = step(params, k, v, torch.tensor([last], device="cuda"),
                        torch.tensor([9], device="cuda"))
    counts = kernel_counts()
    with torch.no_grad():
        want = model(torch.tensor([toks + [last]], device="cuda"))[0, -1]
    err = (logits[0] - want).abs().max().item()
    if counts["decode_attention"] != model.cfg.layers or err > LOGIT_TOL:
        raise RuntimeError(f"PHASE 3-contig port GPT: logits err {err} "
                           f"(gate {LOGIT_TOL}), launches {counts}")
    log(f"PHASE 3-contig port GPT(gpt_tiny()) through "
        f"framework.param_arrays: one decode_step vs the layer's forward, "
        f"max abs logit err {err:.3e} (gate {LOGIT_TOL}), decode_attention "
        f"launches {counts['decode_attention']}")


def phase_contiguous_step_profile(torch, np, cfg, params, power):
    """Phase 3b's measurement on the contiguous path: the 12-layer
    decode_step at B=8, every sequence 512 tokens long in a cache of the
    1024 rung."""
    from paddle_tpu_torch.models.gpt import gpt_decode_fns

    B, cap, n = 8, 1024, 512
    _, step = gpt_decode_fns(cfg)
    shape = (cfg.layers, B, cap, cfg.heads, cfg.head_dim)
    k = torch.zeros(shape, device="cuda")
    v = torch.zeros(shape, device="cuda")
    rng = np.random.default_rng(2)
    ltok = torch.from_numpy(rng.integers(0, cfg.vocab_size, B))
    clen = torch.full((B,), n, dtype=torch.long)

    def one():
        logits, _, _ = step(params, k, v, ltok, clen)
        return logits.float().cpu()

    step_breakdown(torch, one, power, "PHASE 3b-contig",
                   f"gpt2_124m contiguous cache B={B} cap={cap} len={n}")


# ------------------------------------------------------------ phase 4

def scrape(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.headers["Content-Type"], r.read().decode()


def metric_value(text, name):
    """The value of a label-less sample in 0.0.4 exposition text."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise RuntimeError(f"/metrics has no sample {name}")


def start_server(args):
    """Start `python -m paddle_tpu_torch.inference.serve <args>` and read
    its stdout on a thread; returns (process, reader thread, line queue,
    log)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.serve", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    out_log = []

    def pump():
        for line in proc.stdout:
            out_log.append(line.rstrip())
            lines.put(line.rstrip())
        lines.put(None)

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    return proc, reader, lines, out_log


def wait_for(lines, out_log, prefix, timeout=300):
    """The port number on the server's first stdout line that starts with
    `prefix` (``SERVING `` or ``METRICS ``)."""
    deadline = time.monotonic() + timeout
    while True:
        line = lines.get(timeout=max(deadline - time.monotonic(), 1))
        if line is None:
            raise RuntimeError(f"server exited before {prefix}:\n"
                               + "\n".join(out_log[-40:]))
        if line.startswith(prefix):
            return int(line.split()[1])


def phase_server(torch, np, cfg, arrays, prompts, outs, oracle_params, tol,
                 tag, int8):
    """Serve `arrays` (int8 weights and pages when `int8`) from the decode
    daemon in a subprocess; 4 concurrent wire requests must give the
    in-process engine's tokens `outs` (or pass the teacher-forced check
    against `oracle_params` within `tol`), and the daemon's own launch
    counts must follow `expected_counts`."""
    from paddle_tpu_torch.inference.decode import save_for_decode
    from paddle_tpu_torch.inference.serve import decode_request
    from paddle_tpu_torch.models.gpt import GPTDecoder

    picks = [0, 2, 4, 6]            # incl. one of the shared-head prompts
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "gpt2_124m")
        save_for_decode(arrays, cfg, 1e-5, prefix,
                        quant="int8" if int8 else None)
        proc, reader, lines, out_log = start_server(
            [prefix, "--decode", "--decode-slots", "8", "--port", "0",
             "--kv-dtype", "int8" if int8 else "float32",
             # a PDI1 request carries no options: it gets this default
             "--decode-max-new", str(len(outs[0]))])
        try:
            port = wait_for(lines, out_log, "SERVING ")
            results, errors = {}, []

            def client(i, trace):
                try:
                    with socket.create_connection(("127.0.0.1", port),
                                                  timeout=600) as s:
                        results[i] = decode_request(
                            s, prompts[i], trace=trace,
                            opts={"max_new_tokens": len(outs[i]),
                                  "temperature": 0.0})
                except Exception as e:      # surfaced below
                    errors.append(f"request {i}: {e!r}")

            threads = [threading.Thread(target=client, args=(i, n != 3))
                       for n, i in enumerate(picks)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            if errors or len(results) != len(picks):
                raise RuntimeError(f"server requests failed: {errors}")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            reader.join(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if rc != 0 or "DRAINED ok=True" not in out_log:
        raise RuntimeError(f"server drain failed rc={rc}:\n"
                           + "\n".join(out_log[-40:]))
    # the server's own counts: its requests went through the kernels on
    # the card, by the launch formulas of expected_counts
    stats = [ln for ln in out_log if ln.startswith("DECODE STATS ")]
    if len(stats) != 1:
        raise RuntimeError("server printed no DECODE STATS line:\n"
                           + "\n".join(out_log[-40:]))
    kv = dict(f.split("=", 1) for f in stats[0].split()[2:])
    srv_steps, srv_prefills = int(kv["steps"]), int(kv["prefills"])
    srv_counts = {k: int(kv[f"{k}_launches"]) for k in DECODE_KERNELS}
    want = {k: v for k, v in expected_counts(cfg, srv_steps, srv_prefills,
                                             int8).items()
            if k in DECODE_KERNELS}
    if not kv["device"].startswith("cuda") or srv_steps == 0 \
            or srv_counts != want \
            or kv["kv_dtype"] != ("int8" if int8 else "float32"):
        raise RuntimeError(f"server kernel launches {srv_counts} != {want} "
                           f"({srv_steps} steps, {srv_prefills} prefills) "
                           f"on {kv['device']}, kv_dtype {kv['kv_dtype']}")
    # the server batches 4 streams where phase 3 batched 8, so fp32 sums
    # may differ in the last bits; a token that differs must still be a
    # max-logit choice of the full forward (within tol)
    model = None
    same = 0
    for i in picks:
        if results[i] == outs[i]:
            same += 1
            continue
        if model is None:
            model = GPTDecoder(cfg, device="cuda")
            model.load_state_dict(oracle_params)
        gap = teacher_forced(torch, model, prompts[i], results[i])
        if len(results[i]) != len(outs[i]) or gap > tol:
            raise RuntimeError(f"server reply {i} ({len(results[i])} "
                               f"tokens) differs from the engine "
                               f"({len(outs[i])} tokens) and fails the "
                               f"teacher-forced check (gap {gap})")
    log(f"{tag} server: 4 concurrent requests (3 PDI2 streams, 1 PDI1) "
        f"on port {port}, kv_dtype={kv['kv_dtype']}, wall_s={wall:.6f}, "
        f"identical_to_engine={same}/4, device={kv['device']} "
        f"steps={srv_steps} prefills={srv_prefills} "
        f"kernel_launches={srv_counts} (= {want}), "
        f"SIGTERM -> DRAINED ok=True rc=0")


# ------------------------------------------------------- phase 4-spec

SPEC_K = 4                  # speculation depth the phase serves at
SPEC_MIN_ACCEPT = 0.9       # a self-draft's acceptance must reach this


def spec_expected_counts(tcfg, dcfg, st, int8):
    """Launches a speculative run must show: on int8 weights one matmul
    launch per block matmul per layer of each model call (the draft per
    rollout step and per draft prefill, the target per verify and per
    prefill), and no other kernel (the verify and rollout attention are
    plain PyTorch)."""
    want = {k: 0 for k in kernel_counts()}
    if int8:
        want["int8_weight_matmul"] = len(MATMULS) * (
            dcfg.layers * (st["draft_steps"] + st["draft_prefills"])
            + tcfg.layers * (st["steps"] + st["prefills"]))
    return want


def spec_tick_ms(st):
    """Host ms a tick in the rollout and in the verify (the engine's own
    clock, each call ending in a copy of its result to the host)."""
    n = max(st["steps"], 1)
    return (st["rollout_seconds"] / n * 1e3, st["verify_seconds"] / n * 1e3)


def phase_spec_self_draft(torch, power, cfg, params, prompts, kv_dtype, tol,
                          tag):
    """(a) GPT-2 124M drafting for itself (the same seed-0 weights), k=4,
    8 slots, 16-token pages, phase 3's 8 prompts: every stream within
    `tol` of the full forward's max logit (teacher-forced), acceptance >=
    SPEC_MIN_ACCEPT, and no kernel launched (fp32 weights; the verify and
    rollout attention are plain)."""
    from paddle_tpu_torch.inference.decode import SpecDecodeEngine
    from paddle_tpu_torch.models.gpt import GPTDecoder

    eng = SpecDecodeEngine(cfg=cfg, params=params, eps=1e-5, draft_cfg=cfg,
                           draft_params=params, speculate_k=SPEC_K,
                           max_slots=8, page_tokens=16, kv_dtype=kv_dtype,
                           device="cuda")
    max_new = 32
    try:
        zero_counts()
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        outs = [s.result(timeout=600) for s in streams]
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        st = eng.stats()
    finally:
        eng.stop()
    sp = st["speculate"]
    want = spec_expected_counts(cfg, cfg, dict(sp, **st), int8=False)
    if any(len(o) != max_new for o in outs) or counts != want:
        raise RuntimeError(f"{tag}: streams {[len(o) for o in outs]}, "
                           f"launches {counts} != {want}")
    oracle = GPTDecoder(cfg, device="cuda")
    oracle.load_state_dict(params)
    gaps = [teacher_forced(torch, oracle, p, o) for p, o in zip(prompts, outs)]
    del oracle
    if max(gaps) > tol:
        raise RuntimeError(f"{tag}: teacher-forced check failed: {gaps}")
    if sp["acceptance_rate"] < SPEC_MIN_ACCEPT:
        raise RuntimeError(f"{tag}: self-draft acceptance "
                           f"{sp['acceptance_rate']} < {SPEC_MIN_ACCEPT}")
    roll_ms, ver_ms = spec_tick_ms(dict(sp, **st))
    log(f"{tag} self-draft [{power}] gpt2_124m -> gpt2_124m k={SPEC_K} "
        f"kv_dtype={kv_dtype} slots=8 page_tokens=16 requests=8 "
        f"max_new={max_new}: streams_done=8 "
        f"teacher_forced_max_gap={max(gaps):.3e} (gate {tol}) "
        f"drafted={sp['drafted']} accepted={sp['accepted']} "
        f"acceptance={sp['acceptance_rate']} (gate {SPEC_MIN_ACCEPT}) "
        f"k_final={[s.spec_k for s in streams]} ticks={st['steps']} "
        f"draft_steps={sp['draft_steps']} prefills={st['prefills']} "
        f"rollback_released={sp['rollback_released']} "
        f"cow={st['cow_copies']} kernel_launches={counts} "
        f"wall_s={wall:.6f} tokens_per_s={8 * max_new / wall:.3f} "
        f"host_ms_per_tick rollout={roll_ms:.6f} verify={ver_ms:.6f}")


def phase_spec_server(torch, np, power, dcfg, darrays, prompts):
    """(b) The serving user's command: gpt2_345m() seed-0 weights saved
    with quant="int8" as the target and gpt2_124m() (phase 3's weights,
    an fp32 artifact) as the draft, served by
    `serve --decode --draft-model ... --speculate-k 4 --draft-quant
    --metrics-port 0` in a subprocess. 8 greedy requests (phase 3's
    prompts) and one seeded temperature request, concurrently. Every
    greedy stream within LOGIT_TOL of the full forward of the dequantized
    target (teacher-forced); the sampled stream equal to the in-process
    plain DecodeEngine's over the same artifact; /metrics consistent
    (accepted + rejected = drafted, the acceptance gauge their ratio,
    tokens_total the tokens streamed, rollback releases > 0); the
    server's int8 matmul launches equal to `spec_expected_counts`. Then,
    in process over the same artifacts: the steady window, spec and
    plain, the tick's rollout and verify profiled, and row 4 at the
    verify's shapes."""
    from paddle_tpu_torch.inference.decode import (load_for_decode,
                                                   save_for_decode)
    from paddle_tpu_torch.inference.serve import decode_request
    from paddle_tpu_torch.models.gpt import (GPTDecoder, gpt2_345m,
                                             init_params_numpy,
                                             params_from_numpy)
    from paddle_tpu_torch.quant.ptq import dequantize_params, quantize_params

    tcfg = gpt2_345m()
    t0 = time.perf_counter()
    tq = quantize_params(init_params_numpy(tcfg, seed=0))
    max_new = 32
    sample = {"temperature": 0.8, "top_k": 50, "seed": 1234}
    s_prompt = prompts[1]
    with tempfile.TemporaryDirectory() as td:
        tp, dp = os.path.join(td, "gpt2_345m_int8"), os.path.join(
            td, "gpt2_124m")
        save_for_decode(tq, tcfg, 1e-5, tp, quant="int8")
        save_for_decode(darrays, dcfg, 1e-5, dp)
        log(f"PHASE 4-spec setup: gpt2_345m seed-0 weights + "
            f"quantize_params + both artifacts "
            f"{time.perf_counter() - t0:.3f}s")
        proc, reader, lines, out_log = start_server(
            [tp, "--decode", "--decode-slots", "8", "--port", "0",
             "--draft-model", dp, "--speculate-k", str(SPEC_K),
             "--draft-quant", "--metrics-port", "0",
             "--decode-max-new", str(max_new)])
        try:
            mport = wait_for(lines, out_log, "METRICS ")
            port = wait_for(lines, out_log, "SERVING ")
            results, errors = {}, []

            def client(i, opts):
                try:
                    with socket.create_connection(("127.0.0.1", port),
                                                  timeout=600) as s:
                        results[i] = decode_request(
                            s, prompts[i] if i < 8 else s_prompt,
                            opts=dict(opts, max_new_tokens=max_new))
                except Exception as e:      # surfaced below
                    errors.append(f"request {i}: {e!r}")

            threads = [threading.Thread(target=client,
                                        args=(i, {"temperature": 0.0}))
                       for i in range(8)]
            threads.append(threading.Thread(target=client,
                                            args=(8, sample)))
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            if errors or len(results) != 9:
                raise RuntimeError(f"spec server requests failed: {errors}")
            ctype, metrics = scrape(mport, "/metrics")
            _, status = scrape(mport, "/statusz")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            reader.join(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if rc != 0 or "DRAINED ok=True" not in out_log:
            raise RuntimeError(f"spec server drain failed rc={rc}:\n"
                               + "\n".join(out_log[-40:]))
        stats = [ln for ln in out_log if ln.startswith("DECODE STATS ")]
        kv = dict(f.split("=", 1) for f in stats[0].split()[2:])
        srv = {"steps": int(kv["steps"]), "prefills": int(kv["prefills"]),
               "draft_steps": int(kv["spec_draft_steps"]),
               "draft_prefills": int(kv["spec_draft_prefills"])}
        srv_counts = {k: int(kv[f"{k}_launches"]) for k in DECODE_KERNELS}
        want = {k: v for k, v in spec_expected_counts(
            tcfg, dcfg, srv, int8=True).items() if k in DECODE_KERNELS}
        if not kv["device"].startswith("cuda") or srv_counts != want \
                or srv["steps"] == 0:
            raise RuntimeError(f"spec server launches {srv_counts} != "
                               f"{want} ({srv}) on {kv['device']}")
        # /metrics against itself and against the streams
        streamed = sum(len(r) for r in results.values())
        m = {n: metric_value(metrics, f"paddle_tpu_decode_{n}")
             for n in ("spec_draft_steps_total",
                       "spec_accepted_tokens_total",
                       "spec_rejected_tokens_total",
                       "spec_acceptance_rate",
                       "page_rollback_released_total", "tokens_total")}
        drafted = int(kv["spec_drafted"])
        accepted = m["spec_accepted_tokens_total"]
        if not ctype.startswith("text/plain; version=0.0.4") \
                or accepted + m["spec_rejected_tokens_total"] != drafted \
                or accepted != int(kv["spec_accepted"]) \
                or abs(m["spec_acceptance_rate"] - accepted / drafted) \
                > 1e-12 \
                or m["tokens_total"] != streamed \
                or m["page_rollback_released_total"] <= 0 \
                or m["spec_draft_steps_total"] != srv["draft_steps"]:
            raise RuntimeError(f"spec server /metrics {m} ({ctype}) "
                               f"against drafted={drafted} "
                               f"streamed={streamed} {kv}")
        spec_status = json.loads(status)["decode"]["speculate"]

        # the teacher-forced gate against the dequantized target
        deq = params_from_numpy(tcfg, dequantize_params(tq), "cuda")
        oracle = GPTDecoder(tcfg, device="cuda")
        oracle.load_state_dict(deq)
        gaps = [teacher_forced(torch, oracle, prompts[i], results[i])
                for i in range(8)]
        del oracle, deq
        torch.cuda.empty_cache()
        if any(len(results[i]) != max_new for i in range(9)) \
                or max(gaps) > LOGIT_TOL:
            raise RuntimeError(f"spec server streams "
                               f"{[len(r) for r in results.values()]}, "
                               f"teacher-forced gaps {gaps}")

        # the plain engine over the same target: the sampled stream, the
        # greedy streams' identity, its steady window
        plain = load_for_decode(tp, device="cuda", max_slots=8,
                                page_tokens=16)
        try:
            p_outs = [plain.submit(prompts[i], max_new_tokens=max_new)
                      .result(timeout=600) for i in range(8)]
            p_sample = plain.submit(s_prompt, max_new_tokens=max_new,
                                    **sample).result(timeout=600)
            # int8 weights on fp32 pages: fp32 attention, int8 matmuls
            _, p_souts, p_wall, p_st = steady_window(
                plain, tcfg, np.random.default_rng(4), int8=True,
                expect=lambda st: dict(
                    expected_counts(tcfg, st["steps"], st["prefills"],
                                    int8=False),
                    int8_weight_matmul=len(MATMULS) * tcfg.layers
                    * (st["steps"] + st["prefills"])))
        finally:
            plain.stop()
        if p_sample != results[8]:
            raise RuntimeError(f"spec server sampled stream {results[8]} "
                               f"!= the plain engine's {p_sample}")
        same = sum(p_outs[i] == results[i] for i in range(8))
        log(f"PHASE 4-spec server [{power}]: target gpt2_345m int8 weights "
            f"(kv float32), draft gpt2_124m --draft-quant, k={SPEC_K}, 8 "
            f"slots; 8 greedy + 1 sampled (T={sample['temperature']}, "
            f"top_k={sample['top_k']}, seed {sample['seed']}) concurrent "
            f"requests on port {port}, METRICS {mport}: wall_s={wall:.6f} "
            f"tokens={streamed} teacher_forced_max_gap={max(gaps):.3e} "
            f"(gate {LOGIT_TOL}) greedy_identical_to_plain={same}/8 "
            f"sampled_equal_to_plain=True device={kv['device']} "
            f"ticks={srv['steps']} prefills={srv['prefills']} "
            f"draft_steps={srv['draft_steps']} draft_prefills="
            f"{srv['draft_prefills']} int8_weight_matmul_launches="
            f"{srv_counts['int8_weight_matmul']} (= {len(MATMULS)} x "
            f"({dcfg.layers} x ({srv['draft_steps']} + "
            f"{srv['draft_prefills']}) + {tcfg.layers} x ({srv['steps']} + "
            f"{srv['prefills']}))), attention launches 0")
        log(f"PHASE 4-spec /metrics: {ctype}; drafted={drafted} "
            f"accepted={accepted:g} rejected="
            f"{m['spec_rejected_tokens_total']:g} acceptance_rate="
            f"{m['spec_acceptance_rate']} tokens_total="
            f"{m['tokens_total']:g} (= streamed) "
            f"page_rollback_released_total="
            f"{m['page_rollback_released_total']:g}; /statusz speculate "
            f"{spec_status}")

        eng = load_for_decode(tp, device="cuda", draft_prefix=dp,
                              speculate_k=SPEC_K, draft_quant=True,
                              max_slots=8, page_tokens=16)
        try:
            s_prompts, s_outs, s_wall, s_st = steady_window(
                eng, tcfg, np.random.default_rng(4), int8=True,
                expect=lambda st: spec_expected_counts(tcfg, dcfg, st,
                                                       int8=True))
        finally:
            eng.stop()
    roll_ms, ver_ms = spec_tick_ms(s_st)
    s_tokens = sum(len(o) for o in s_outs)
    log(f"PHASE 4-spec steady window [{power}]: gpt2_345m int8, 8 distinct "
        f"{len(s_prompts[0])}-token prompts x {len(s_outs[0])} new tokens; "
        f"spec k={SPEC_K}: wall_s={s_wall:.6f} "
        f"tokens_per_s={s_tokens / s_wall:.3f} ticks={s_st['steps']} "
        f"tokens_per_tick={(s_tokens - s_st['prefills']) / s_st['steps']:.3f}"
        f" drafted={s_st['drafted']} accepted={s_st['accepted']} "
        f"k_final={s_st['k_final']} host_ms_per_tick rollout={roll_ms:.6f} "
        f"verify={ver_ms:.6f} kernel_launches={s_st['launches']}; plain: "
        f"wall_s={p_wall:.6f} tokens_per_s="
        f"{sum(len(o) for o in p_souts) / p_wall:.3f} "
        f"steps={p_st['steps']} "
        f"ms_per_step={p_st['step_seconds'] / p_st['steps'] * 1e3:.6f}")
    phase_spec_tick_profile(torch, np, power, tcfg, tq, dcfg, darrays)
    phase_spec_matmul(torch, power, tcfg, tq)


def phase_spec_tick_profile(torch, np, power, tcfg, tq, dcfg, darrays):
    """Where a speculative tick's time goes: the draft rollout (k=4 steps
    of gpt2_124m int8) and the verify (k+1 = 5 positions of gpt2_345m
    int8) at B=8, every sequence 512 tokens long, each timed on the host
    clock and traced for device time by kernel (`step_breakdown`)."""
    from paddle_tpu_torch.models.gpt import (gpt_paged_rollout_fns,
                                             gpt_paged_verify_fns,
                                             params_from_numpy)
    from paddle_tpu_torch.quant.kv import kv_pool_zeros
    from paddle_tpu_torch.quant.ptq import quantize_params

    B, pt, W, n = 8, 16, 64, 512
    P = B * W + 1
    rng = np.random.default_rng(2)
    tables = np.zeros((B, W), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b in range(B):
        tables[b, :n // pt + 1] = perm[b * W:b * W + n // pt + 1]
    tables = torch.from_numpy(tables)
    clen = torch.full((B,), n, dtype=torch.long)
    for cfg, arrays, what in ((dcfg, quantize_params(darrays), "rollout"),
                              (tcfg, tq, "verify")):
        params = params_from_numpy(cfg, arrays, "cuda")
        shape = (cfg.layers, P, pt, cfg.heads, cfg.head_dim)
        kpool = kv_pool_zeros(shape, "float32", "cuda")
        vpool = kv_pool_zeros(shape, "float32", "cuda")
        if what == "rollout":
            fn = gpt_paged_rollout_fns(cfg, page_tokens=pt)
            toks = torch.full((B, SPEC_K), -1, dtype=torch.long)
            toks[:, 0] = torch.from_numpy(rng.integers(0, cfg.vocab_size, B))
        else:
            fn = gpt_paged_verify_fns(cfg, page_tokens=pt)
            toks = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (B, SPEC_K + 1)))

        def one():
            out = fn(params, kpool, vpool, tables, toks, clen)
            return out[1 if what == "verify" else 0].cpu()

        step_breakdown(torch, one, power, f"PHASE 4-spec tick {what}",
                       f"{'gpt2_124m' if what == 'rollout' else 'gpt2_345m'}"
                       f" int8 weights, kv float32, B={B} len={n} "
                       f"{'k' if what == 'rollout' else 'K1'}="
                       f"{toks.shape[1]}")
        del params, kpool, vpool
        torch.cuda.empty_cache()


def phase_spec_matmul(torch, power, tcfg, tq):
    """Row 4 at gpt2_345m's four block matmuls, against its plain version
    (INT8_KERNEL_TOL), timed by graph replay beside its bound and fp32
    torch.matmul on the dequantized weight: the M <= 8 GEMV at M = 1-6
    and 8 (the verify takes it when b_rung (k + 1) <= 8: M = 2, 3, 4, 5,
    6, 8; the plain engine over the same target at M = b_rung), its route
    held to the kernel library's own (no split-K workspace, and its
    launch geometry equal to `gemv_geometry`); then the tiled
    tensor-core kernel at the verify's M = 8 (k + 1) rows for k = 1, 2,
    4."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    g = torch.Generator(device="cuda").manual_seed(5)
    ws = []
    for rel in MATMULS:
        w = torch.from_numpy(tq[f"blocks.0.{rel}"]).cuda()
        s = torch.from_numpy(tq[f"blocks.0.{rel}::scale"]).cuda()
        ws.append((rel, w, s, w.float() * s))
    _, ws_floats = qm._kernel_fn()
    geometry = qm._geometry_fn()
    for M in (1, 2, 3, 4, 5, 6, 8, 16, 24, 40):
        gemv = M <= qm.GEMV_M
        parts = []
        for rel, w, s, wf in ws:
            K, N = w.shape
            if gemv:
                # the launcher takes the GEMV iff it needs no workspace
                out = (ctypes.c_int * 8)()
                rc = geometry(M, N, K, out)
                p = qm.gemv_geometry(M, N, K)
                want = [p["grid"][0], p["grid"][1], p["cluster"][0],
                        p["threads"], p["smem_bytes"], p["strip"],
                        p["k_steps"], p["pass_steps"]]
                if ws_floats(M, N, K) != 0 or rc != 0 \
                        or list(out) != want:
                    raise RuntimeError(
                        f"int8_weight_matmul M={M} {rel}: not the GEMV "
                        f"route (workspace {ws_floats(M, N, K)} floats, "
                        f"geometry rc {rc} {list(out)}, gemv_geometry "
                        f"{want})")
            x = torch.randn((M, K), generator=g, device="cuda")
            got = qm.int8_weight_matmul(x, w, s)
            err = (got - qm.int8_weight_matmul(x, w, s, kernel="reference")
                   ).abs().max().item()
            if not (torch.isfinite(got).all() and err <= INT8_KERNEL_TOL):
                raise RuntimeError(f"int8_weight_matmul M={M} {rel}: max "
                                   f"abs err {err}")
            ms = graph_ms(torch, lambda _: qm.int8_weight_matmul(x, w, s), 50)
            lib = graph_ms(torch, lambda _: torch.matmul(x, wf), 50)
            bound_ms, by = bound(
                w.numel() + 4 * (s.numel() + M * K + M * N),
                3 * 2 * M * w.numel(), BF16_FLOPS_PER_S)
            parts.append(f"{K}x{N} kernel_ms={ms:.6f} "
                         f"bound_ms={bound_ms:.6f} ({by}) "
                         f"library_ms={lib:.6f} err={err:.3e}")
        if gemv:
            what = "the GEMV (route and geometry checked)"
        else:
            what = f"the tiled kernel, the verify's k={M // 8 - 1} at B=8"
        log(f"PHASE 4-spec int8_weight_matmul M={M}, {what} [{power}], "
            f"gpt2_345m K x N, one launch each (graph replay, weight in "
            f"L2; library = fp32 torch.matmul): " + "; ".join(parts))


def phase_spec(torch, np, power, cfg, arrays, params, prompts):
    """Phase 4-spec: speculative decoding, (a) self-draft on fp32 and int8
    pages, (b) the 345M int8 target with a 124M draft through the
    server."""
    phase_spec_self_draft(torch, power, cfg, params, prompts, "float32",
                          LOGIT_TOL, "PHASE 4-spec (a)")
    phase_spec_self_draft(torch, power, cfg, params, prompts, "int8",
                          INT8_LOGIT_TOL, "PHASE 4-spec (a-int8)")
    phase_spec_server(torch, np, power, cfg, arrays, prompts)


# ------------------------------------------------------------ phase 5

def flash_inputs(torch, B, T, H, D, dtype, seed, fused=True):
    """q, k, v [B, T, H, D] (the chunks of one fused qkv tensor when
    `fused`, each copied to its own tensor in `dtype`; with fused="views"
    strided views of one fused qkv tensor in `dtype`, as the model hands
    them to attention) and dO, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fused == "views":
        qkv = torch.randn((B, T, 3 * H * D), generator=g,
                          device="cuda").to(dtype)
        q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    elif fused:
        qkv = torch.randn((B, T, 3 * H * D), generator=g, device="cuda")
        q, k, v = (t.reshape(B, T, H, D).to(dtype)
                   for t in qkv.split(H * D, dim=-1))
    else:
        q, k, v = (torch.randn((B, T, H, D), generator=g,
                               device="cuda").to(dtype) for _ in range(3))
    do = torch.randn((B, T, H, D), generator=g, device="cuda").to(dtype)
    return q, k, v, do


def flash_pairs(T, causal):
    """Live (q, k) pairs of one head: what the work depends on."""
    return T * (T + 1) // 2 if causal else T * T


def rel_err(got, want):
    """Max abs error and the reference's largest magnitude."""
    return ((got.float() - want.float()).abs().max().item(),
            want.float().abs().max().item())


def row_rel_err(got, want):
    """The worst row (last dim) of `want`: RMS of the error over the RMS
    of the row, or over 2^-10 of the whole tensor's RMS where the row is
    smaller (the causal dq of row 0 is zero)."""
    err = (got.float() - want.float()).pow(2).mean(-1)
    ref = want.float().pow(2).mean(-1)
    ref = ref.clamp_min(ref.mean().item() * 2.0 ** -20)
    return (err / ref).max().sqrt().item()


def check_flash(torch, fa, B, T, H, D, dtype, causal, tag, fused=True,
                seed=0):
    """The kernels against the plain versions on the same inputs in
    `dtype`: the forward, and the backward of both from the plain
    forward's (o, lse). Raises unless every output passes its gate: in
    fp32 the max abs error within the JAX contract, in bf16 `row_rel_err`
    within FLASH_BF16_ROW_REL (lse by the fp32 gate). Returns ({output:
    (gated error, max abs error)}, the inputs, the plain (o, lse, dv))."""
    q, k, v, do = flash_inputs(torch, B, T, H, D, dtype, seed, fused)
    if fused == "views" and q.is_contiguous():
        raise RuntimeError(f"{tag}: q is not a strided view")
    o, lse = fa.flash_attention_forward(q, k, v, causal)
    ro, rlse = fa.flash_attention_forward(q, k, v, causal, kernel="reference")
    got = fa.flash_attention_backward(q, k, v, ro, rlse, do, causal)
    want = fa.flash_attention_backward(q, k, v, ro, rlse, do, causal,
                                       kernel="reference")
    torch.cuda.synchronize()
    out = {}
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), (o, lse) + got,
                          (ro, rlse) + want):
        if not torch.isfinite(a).all():
            raise RuntimeError(f"{tag}: {name} non-finite")
        err = rel_err(a, b)[0]
        if dtype == torch.float32 or name == "lse":
            gated = err
            tol = FLASH_F32_FWD_TOL if name in ("o", "lse") \
                else FLASH_F32_BWD_TOL
        else:
            gated, tol = row_rel_err(a, b), FLASH_BF16_ROW_REL
        if not gated <= tol:
            raise RuntimeError(f"{tag}: {name} error {gated} > {tol}")
        out[name] = (gated, err)
    return out, (q, k, v, do), (ro, rlse, want[2])


def dropped_tile_errs(fa, inputs, plain, tile=64):
    """How far the bf16 gate reaches: `row_rel_err` of the plain version
    with one tile left out, against the whole plain version. O of the
    last `tile` rows without keys [0, tile) (the causal attention of the
    sequence less its first tile), and dv of keys [T - 2 tile, T - tile)
    without the last `tile` query rows (the sequence less its last tile,
    whose earlier rows are unchanged under the causal mask)."""
    q, k, v, do = inputs
    ro, rlse, rdv = plain
    T = q.shape[1]
    o_cut, _ = fa.flash_attention_forward(q[:, tile:], k[:, tile:],
                                          v[:, tile:], True,
                                          kernel="reference")
    e_o = row_rel_err(o_cut[:, -tile:], ro[:, -tile:])
    head = slice(0, T - tile)
    _, _, dv_cut = fa.flash_attention_backward(
        q[:, head], k[:, head], v[:, head], ro[:, head],
        rlse[:, head].contiguous(), do[:, head], True, kernel="reference")
    keys = slice(T - 2 * tile, T - tile)
    return {"o": e_o, "dv": row_rel_err(dv_cut[:, keys], rdv[:, keys])}


def flash_group(name):
    """The flash wrapper whose kernel a profiled kernel name is (the fp32
    SIMT or the bf16 tensor-core route), or None."""
    for group, stem in (("flash_attention_fwd", "flash_fwd"),
                        ("flash_attention_bwd_dq", "flash_bwd_dq"),
                        ("flash_attention_bwd_dkv", "flash_bwd_dkv")):
        if re.search(stem + r"(_wgmma)?_kernel", name):
            return group
    return None


def profile_kernels(torch, fn, calls):
    """Device microseconds per call of `fn`, by kernel name
    (torch.profiler, device-side events only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            out[ev.key] = (us / calls, ev.count / calls)
    return out


# the tensor-core kernels, by library, with their count of instantiations:
# phases 2b, 5 and 8 require HMMA or HGMMA instructions in the SASS of each
# instantiation (the int8 matmul: at M > 8 aligned and scalar loads, the
# M <= 8 GEMV one; flash: D <= 64, 128; the CE forward: one; the CE
# backward: dx, dW) and none in the library's other (fp32 or split-K
# reduce, CUDA-core) kernels; the flash kernels run on wgmma, so phase 5
# requires HGMMA and no HMMA in each
INT8_TC_KERNELS = {"int8_weight_matmul": {"int8_mma_kernel": 2,
                                          "int8_gemv_mma_kernel": 1}}
INT8_NO_SPILLS = ("int8_gemv_mma_kernel",)   # phase 2b's spill gate
FLASH_TC_KERNELS = {"flash_attention_fwd": {"flash_fwd_wgmma_kernel": 2},
                    "flash_attention_bwd": {"flash_bwd_dq_wgmma_kernel": 2,
                                            "flash_bwd_dkv_wgmma_kernel": 2}}
CE_TC_KERNELS = {"fused_linear_ce_fwd": {"lce_fwd_mma_kernel": 1},
                 "fused_linear_ce_bwd": {"lce_bwd_mma_kernel": 2}}


def ptxas_by_kernel(text):
    """{entry function: {registers, spill_stores, spill_loads, smem}} from
    an nvcc ``-Xptxas -v`` log."""
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            out[name]["smem"] = int(m.group(1)) if m else 0
    return out


def sass_mma_counts(lib):
    """{kernel function: {"HMMA": n, "HGMMA": n}}, the counts of mma.sync
    and wgmma instructions in the SASS of a built library (cuobjdump -sass,
    from the toolkit beside nvcc)."""
    from paddle_tpu_torch.ops.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            counts[name] = {"HMMA": 0, "HGMMA": 0}
            continue
        m = re.search(r"\b(HG?MMA)\.", ln)
        if name is not None and m:
            counts[name][m.group(1)] += 1
    return counts


def tensor_cores(tc_kernels, tag, only=None):
    """Raises unless every instantiation of the tensor-core kernels of
    `tc_kernels` ({library: {kernel stem: instantiations}}) runs HMMA/HGMMA
    instructions (with `only` = "HGMMA" or "HMMA": that kind and none of
    the other) and the libraries' other (CUDA-core) kernels run none; logs
    each one's counts, registers and spills."""
    from paddle_tpu_torch.ops.kernels import _build
    libs = _build.build(sorted(tc_kernels))
    for lib, kernels in sorted(tc_kernels.items()):
        counts = sass_mma_counts(libs[lib])
        logf = libs[lib].with_suffix(".log")
        ptxas = ptxas_by_kernel(logf.read_text()) if logf.is_file() else {}
        for fn, c in sorted(counts.items()):
            tc = any(kn in fn for kn in kernels)
            res = ptxas.get(fn, {})
            log(f"{tag} SASS {lib} {fn}: {c['HMMA']} HMMA, {c['HGMMA']} "
                f"HGMMA ({'tensor-core route' if tc else 'CUDA-core route'})"
                f"; registers {res.get('registers', '?')}, spill stores "
                f"{res.get('spill_stores', '?')} B, spill loads "
                f"{res.get('spill_loads', '?')} B, static smem "
                f"{res.get('smem', '?')} B")
            if not tc and c["HMMA"] + c["HGMMA"]:
                raise RuntimeError(f"{lib}: CUDA-core kernel {fn} runs "
                                   f"tensor-core instructions: {c}")
        for kn, want in kernels.items():
            found = [c for fn, c in counts.items() if kn in fn]
            kinds = [only] if only else ["HMMA", "HGMMA"]
            ok = len(found) == want and all(
                sum(c[k] for k in kinds) > 0 for c in found)
            if only:
                other = "HMMA" if only == "HGMMA" else "HGMMA"
                ok = ok and not any(c[other] for c in found)
            if not ok:
                raise RuntimeError(
                    f"{lib}: {kn} instantiations' tensor-core instructions: "
                    f"{found} (want {want}, each with "
                    f"{only or 'HMMA or HGMMA'}"
                    f"{' and no ' + other if only else ''})")


def phase_flash(torch, power):
    """Phases 5 and 5b: the bf16 kernels' tensor-core instructions, the
    flash kernels against their plain versions (fp32 with TF32 off and
    bf16 at B=2, H=4, T=256, D=64, causal and not, and at ragged T and D;
    fp32 at the main path's B=16, H=12, T=1024, D=64 causal; bf16 at the
    main path's shapes and at T=2048, where the TPU's backward took two
    passes) and their device times at the main path's shapes beside
    the bound, the plain versions and PyTorch's attention. Returns the
    kernel records: forward, dq, dk/dv, and the two backward kernels as
    the TPU's fused backward (row 8 of PERF.md's table)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.nn.functional.attention import _sdpa_composed
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    tensor_cores(FLASH_TC_KERNELS, "PHASE 5", only="HGMMA")
    # every small case in both types: fp32 takes the SIMT kernels, bf16
    # the tensor-core ones (D=20 takes the wrapper's zero padding to 24)
    cases = []
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        cases += [(f"{name} causal={c} fused_qkv={f}", 2, 256, 4, 64, dtype,
                   c, f, 1) for c in (True, False) for f in (True, False)]
        cases += [(f"{name} ragged T=200 D=128 causal=True", 1, 200, 2, 128,
                   dtype, True, True, 2),
                  (f"{name} ragged T=200 D=128 causal=False", 1, 200, 2,
                   128, dtype, False, True, 10),
                  (f"{name} ragged T=70 D=16 causal=False", 1, 70, 2, 16,
                   dtype, False, True, 3)]
    cases += [("bf16 ragged T=70 D=20 causal=True, D padded to 24", 1, 70,
               2, 20, torch.bfloat16, True, False, 9),
              # a multiple of 64 but not of the kernels' 128-row tiles
              ("bf16 T=192 D=64 causal=True", 2, 192, 4, 64, torch.bfloat16,
               True, True, 11),
              ("bf16 T=192 D=64 causal=False", 2, 192, 4, 64,
               torch.bfloat16, False, True, 12),
              ("bf16 T=192 D=128 causal=True", 2, 192, 2, 128,
               torch.bfloat16, True, True, 13),
              # q, k, v as strided views of one fused qkv tensor at D=128:
              # the tensor maps read them in place
              ("bf16 strided fused-qkv T=384 H=3 D=128 causal=True", 2, 384,
               3, 128, torch.bfloat16, True, "views", 14),
              ("bf16 strided fused-qkv T=384 H=3 D=128 causal=False", 2,
               384, 3, 128, torch.bfloat16, False, "views", 15),
              ("fp32 main B=16 T=1024 H=12 D=64 causal", 16, 1024, 12, 64,
               torch.float32, True, True, 8),
              ("bf16 main B=16 T=1024 H=12 D=64 causal", 16, 1024, 12, 64,
               torch.bfloat16, True, True, 4),
              ("bf16 B=4 T=2048 H=12 D=64 causal", 4, 2048, 12, 64,
               torch.bfloat16, True, True, 5)]
    errs = {}
    for tag, B, T, H, D, dtype, causal, fused, seed in cases:
        errs[tag], inputs, plain = check_flash(
            torch, fa, B, T, H, D, dtype, causal, f"flash {tag}", fused, seed)
        if tag.startswith("bf16 main"):
            reach = dropped_tile_errs(fa, inputs, plain)
        del inputs, plain
        torch.cuda.empty_cache()
    for tag, e in errs.items():
        gated = "max abs err" if tag.startswith("fp32") \
            else "worst row RMS err / row RMS (lse: max abs err)"
        log(f"PHASE 5 flash check {tag}: " + " ".join(
            f"{n}={g:.3e}" for n, (g, _) in e.items()) + f" ({gated}); "
            "max abs err " + " ".join(f"{n}={m:.3e}"
                                      for n, (_, m) in e.items()))
    if min(reach.values()) <= FLASH_BF16_ROW_REL:
        raise RuntimeError(f"flash bf16 gate {FLASH_BF16_ROW_REL} would "
                           f"pass a dropped tile: {reach}")
    log(f"PHASE 5 flash bf16 gate {FLASH_BF16_ROW_REL:.3e} against one "
        f"64-row tile left out of the plain version at T=1024: o (last "
        f"rows, first key tile out) {reach['o']:.3e}, dv (keys before the "
        f"last tile, last query tile out) {reach['dv']:.3e}")
    main = errs["bf16 main B=16 T=1024 H=12 D=64 causal"]

    # timings at the main path's shapes
    B, T, H, D = 16, 1024, 12, 64
    q, k, v, do = flash_inputs(torch, B, T, H, D, torch.bfloat16, 6)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o, lse = fa.flash_attention_forward(q, k, v, True)
    # no atomics anywhere (the dq / dk-dv split): runs repeat bit for bit
    again = fa.flash_attention_forward(q, k, v, True) \
        + fa.flash_attention_backward(q, k, v, o, lse, do, True)
    first = (o, lse) + fa.flash_attention_backward(q, k, v, o, lse, do, True)
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise RuntimeError("flash bf16: two runs of the kernels differ")
    log(f"PHASE 5 flash bf16 B={B} T={T} H={H} D={D} causal: two runs of the "
        f"forward and the backward equal bit for bit")
    del again, first
    t = timings(
        torch, lambda _: fa.flash_attention_forward(q, k, v, True),
        lambda _: fa.flash_attention_forward(q, k, v, True,
                                             kernel="reference"),
        lambda _: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        20)
    lib_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_err = rel_err(lib_o.transpose(1, 2), o)[0]
    pairs = B * H * flash_pairs(T, True)
    elems = B * T * H * D
    nbytes = 4 * 2 * elems + 4 * B * H * T
    flops = 4 * D * pairs
    fwd_rec = kernel_record(
        "flash_attention_fwd", "flash_attention_fwd.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:109",
        main["o"][1], t["ms"], t["plain_ms"], t["library_ms"], nbytes,
        flops, BF16_FLOPS_PER_S)
    log(f"PHASE 5 flash_attention_fwd [{power}] B={B} T={T} H={H} D={D} "
        f"bf16 causal: kernel_ms={t['ms']:.6f} (graph replay; eager "
        f"{t['eager_ms']:.6f}) plain_ms={t['plain_ms']:.6f} "
        f"library_ms={t['library_ms']:.6f} (torch sdpa; vs kernel "
        f"{lib_err:.3e}) bound_ms={fwd_rec['bound_ms']:.6f} "
        f"({fwd_rec['bound_by']}, {nbytes} bytes, {flops} flops) "
        f"kernel_over_bound={t['ms'] / fwd_rec['bound_ms']:.2f}x")

    # phase 5b: the backward, and each of its two kernels
    bwd_ms = graph_ms(torch, lambda _: fa.flash_attention_backward(
        q, k, v, o, lse, do, True), 10)
    bwd_eager = cuda_ms(torch, lambda _: fa.flash_attention_backward(
        q, k, v, o, lse, do, True), 10)
    _, delta, q_s = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True)
    dq_ms = graph_ms(torch, lambda _: fa.flash_attention_bwd_dq(
        q, k, v, o, do, lse, True), 10)
    dkv_ms = graph_ms(torch, lambda _: fa.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, True, q_s=q_s), 10)
    plain_dq = graph_ms(torch, lambda _: fa.flash_attention_bwd_dq(
        q, k, v, o, do, lse, True, kernel="reference"), 2)
    plain_dkv = graph_ms(torch, lambda _: fa.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, True, kernel="reference"), 2)
    # library yardstick for the whole backward: PyTorch's flash attention
    # backward op on the outputs of its forward op, by graph replay
    aten = torch.ops.aten
    qc, kc, vc, doc = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    lib_out = aten._scaled_dot_product_flash_attention(qc, kc, vc, 0.0, True)
    lib_args = (doc, qc, kc, vc) + tuple(lib_out[:6]) + (0.0, True) \
        + tuple(lib_out[6:8])
    lib_dq = aten._scaled_dot_product_flash_attention_backward(*lib_args)[0]
    lib_bwd_err = rel_err(lib_dq.transpose(1, 2), fa.flash_attention_backward(
        q, k, v, o, lse, do, True)[0])[0]
    lib_bwd = graph_ms(torch, lambda _: (
        aten._scaled_dot_product_flash_attention_backward(*lib_args)), 10)
    dq_bytes = 5 * 2 * elems + 4 * B * H * T + 2 * elems + 4 * B * H * T
    dkv_bytes = 4 * 2 * elems + 2 * 4 * B * H * T + 2 * 2 * elems
    dq_rec = kernel_record(
        "flash_attention_bwd_dq", "flash_attention_bwd.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:201",
        main["dq"][1], dq_ms, plain_dq, None, dq_bytes, 6 * D * pairs,
        BF16_FLOPS_PER_S)
    dkv_rec = kernel_record(
        "flash_attention_bwd_dkv", "flash_attention_bwd.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:245",
        max(main["dk"][1], main["dv"][1]), dkv_ms, plain_dkv, None,
        dkv_bytes, 8 * D * pairs, BF16_FLOPS_PER_S)
    all_bytes = 5 * 2 * elems + 4 * B * H * T + 3 * 2 * elems
    all_bound = max(all_bytes / HBM_BYTES_PER_S,
                    10 * D * pairs / BF16_FLOPS_PER_S) * 1e3
    log(f"PHASE 5b flash backward [{power}] B={B} T={T} H={H} D={D} bf16 "
        f"causal: dq+dkv kernel_ms={bwd_ms:.6f} (graph replay; eager "
        f"{bwd_eager:.6f}; each kernel by graph replay: dq {dq_ms:.6f}, "
        f"dkv {dkv_ms:.6f}) plain_ms={plain_dq + plain_dkv:.6f} (dq "
        f"{plain_dq:.6f} + dkv {plain_dkv:.6f}) library_ms={lib_bwd:.6f} "
        f"(aten._scaled_dot_product_flash_attention_backward, graph replay;"
        f" its dq vs the kernel's {lib_bwd_err:.3e}) "
        f"bound_ms={all_bound:.6f} (10 D flops per "
        f"pair, {all_bytes} bytes) kernel_over_bound="
        f"{bwd_ms / all_bound:.2f}x; dq bound {dq_rec['bound_ms']:.6f} "
        f"({dq_rec['bound_by']}), dkv bound {dkv_rec['bound_ms']:.6f} "
        f"({dkv_rec['bound_by']})")
    del qc, kc, vc, doc, lib_out, lib_args, lib_dq
    torch.cuda.empty_cache()

    # kernels against the composition sdpa takes below the threshold, at
    # T=512 and T=1024: forward + backward through autograd
    for Tc in (512, 1024):
        qc, kc, vc, doc = flash_inputs(torch, 16, Tc, 12, 64, torch.bfloat16,
                                       7)
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (qc, kc, vc)]

        def run(attn):
            def go(_):
                out = attn(*leaves)
                torch.autograd.grad(out, leaves, doc)
            return go

        flash_t = cuda_ms(torch, run(lambda a, b, c: fa.flash_attention(
            a, b, c, causal=True)), 5)
        comp_t = cuda_ms(torch, run(lambda a, b, c: _sdpa_composed(
            a, b, c, None, 0.0, True, None)), 5)
        lib_t = cuda_ms(torch, run(lambda a, b, c: F.scaled_dot_product_attention(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
            is_causal=True).transpose(1, 2)), 5)
        log(f"PHASE 5 attention fwd+bwd at T={Tc} [{power}] B=16 H=12 D=64 "
            f"bf16 causal (eager CUDA events): flash kernels "
            f"{flash_t:.6f} ms, composition (_sdpa_composed) {comp_t:.6f} "
            f"ms, torch sdpa {lib_t:.6f} ms")
        del qc, kc, vc, doc, leaves
        torch.cuda.empty_cache()
    del q, k, v, do, o, lse, delta, q_s
    torch.cuda.empty_cache()
    # the TPU's fused backward (emit_dq=True) runs here as the dq kernel
    # then the dk/dv kernel: its record is the pair's, one per backward
    bwd_rec = kernel_record(
        "flash_attention_bwd", "flash_attention_bwd.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:468",
        max(main["dq"][1], main["dk"][1], main["dv"][1]), bwd_ms,
        plain_dq + plain_dkv, lib_bwd, all_bytes, 10 * D * pairs,
        BF16_FLOPS_PER_S)
    return fwd_rec, dq_rec, dkv_rec, bwd_rec


def bound(nbytes, flops, peak):
    """The least ms the card could take, and what bounds it: the bytes
    over the HBM rate or the operations over `peak`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_record(name, src, replaces, err, ms, plain_ms, library_ms, nbytes,
                  flops, peak):
    bound_ms, bound_by = bound(nbytes, flops, peak)
    return {"name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{src}",
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# ------------------------------------------------------------ phase 6

TRAIN_LOSS_TOL = 1e-5      # fp32 loss, card vs CPU (summation order only)
TRAIN_GRAD_REL = 1e-4      # each gradient, as a fraction of its largest


def phase_train_parity(torch, np):
    """A narrow GPT (hidden 128, 2 layers, 2 heads of 64, V=512, T=512, so
    sdpa routes to the flash kernels) on the card in fp32 with TF32 off
    against the port on the CPU from the same numpy weights: the loss and
    every gradient, and one launch of each flash kernel per layer."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig, init_params_numpy

    cfg = GPTConfig(vocab_size=512, max_seq_len=512, hidden=128, layers=2,
                    heads=2)
    arrays = init_params_numpy(cfg, seed=1)
    rng = np.random.default_rng(8)
    ids = rng.integers(0, cfg.vocab_size, (2, 512), dtype=np.int32)
    labels = np.concatenate([ids[:, 1:], ids[:, :1]], axis=1)
    ptt.set_device("cuda")
    gpu = GPT(cfg).load_numpy(arrays)
    ptt.set_device("cpu")
    cpu = GPT(cfg).load_numpy(arrays)
    ptt.set_device("cuda")
    zero_counts()
    loss_gpu = gpu.loss(ids, labels)
    loss_gpu.backward()
    torch.cuda.synchronize()
    counts = kernel_counts()
    loss_cpu = cpu.loss(ids, labels)
    loss_cpu.backward()
    want = {k: 0 for k in counts}
    want.update({"flash_attention_fwd": cfg.layers,
                 "flash_attention_bwd_dq": cfg.layers,
                 "flash_attention_bwd_dkv": cfg.layers})
    if counts != want:
        raise RuntimeError(f"phase 6 launches {counts} != {want}")
    dl = abs(loss_gpu.item() - loss_cpu.item())
    worst = (0.0, "")
    for (name, pg), (_, pc) in zip(gpu.named_parameters(),
                                   cpu.named_parameters()):
        err, ref = rel_err(pg.grad.cpu(), pc.grad)
        worst = max(worst, (err / max(ref, 1e-12), name))
    if dl > TRAIN_LOSS_TOL or worst[0] > TRAIN_GRAD_REL:
        raise RuntimeError(f"phase 6: loss diff {dl} (gate {TRAIN_LOSS_TOL}),"
                           f" worst gradient {worst} (gate {TRAIN_GRAD_REL})")
    log(f"PHASE 6 training parity: GPT hidden=128 layers=2 heads=2 V=512 "
        f"T=512 B=2 fp32 (TF32 off), cuda vs cpu from one set of numpy "
        f"weights: loss {loss_gpu.item():.7f} vs {loss_cpu.item():.7f} "
        f"(diff {dl:.3e}, gate {TRAIN_LOSS_TOL}); worst gradient "
        f"{worst[1]} at {worst[0]:.3e} of its largest (gate "
        f"{TRAIN_GRAD_REL}); launches {counts}")
    del gpu, cpu
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 7

def phase_train(torch, np, power, records):
    """GPT-2 124M trained through Model.prepare(strategy=AMP O2) +
    Model.fit as bench.py drives it (B=16, T=1024, Adam 1e-4), on the
    seed-0 numpy weights; fills in the flash records' launch counts."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.optimizer as opt
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi import callbacks as hapi_cbks
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.models import GPT, GPTConfig
    from paddle_tpu_torch.models.gpt import init_params_numpy
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.nn.functional import attention as attn_mod
    from paddle_tpu_torch.static import InputSpec

    t_setup = time.perf_counter()
    cfg = GPTConfig()
    B, T, n_short, n_long = 16, 1024, 2, 8
    paddle.set_device("gpu")
    paddle.seed(0)
    gpt = GPT(cfg).load_numpy(init_params_numpy(cfg, seed=0))

    class _LMLoss(nn.Layer):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, ids, labels):
            return self.m.loss(ids, labels)

    net = _LMLoss(gpt)
    net.train()
    model = Model(net, inputs=[InputSpec([None, T], "int32"),
                               InputSpec([None, T], "int32")])
    s = DistributedStrategy()
    s.amp = True
    s.amp_configs.use_pure_bf16 = True
    adam = opt.Adam(learning_rate=1e-4, parameters=model.parameters())
    model.prepare(adam, strategy=s)
    rng = np.random.default_rng(0)

    def dataset(n_batches):
        ids = rng.integers(0, cfg.vocab_size, (n_batches * B, T),
                           dtype=np.int32)
        labels = np.concatenate([ids[:, 1:], ids[:, :1]], axis=1)
        return TensorDataset([ids, labels])

    class _Losses(hapi_cbks.Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    def fit(ds):
        """One epoch through Model.fit; the closing float() reads the last
        on-device loss: the epoch's one host sync."""
        cb = _Losses()
        t0 = time.perf_counter()
        model.fit(ds, batch_size=B, epochs=1, verbose=0, shuffle=False,
                  log_freq=10 ** 9, callbacks=[cb])
        last = float(cb.losses[-1])
        return time.perf_counter() - t0, last, cb.losses

    log(f"PHASE 7 setup: GPT-2 124M ({gpt.num_params()} params) + seed-0 "
        f"numpy weights + prepare {time.perf_counter() - t_setup:.3f}s")
    # warm-up, and the dtypes: fp32 params and Adam moments, bf16 into
    # attention (recorded on one extra step)
    fit(dataset(2))
    seen = []
    real = attn_mod.flash_attention
    attn_mod.flash_attention = lambda q, k, v, **kw: (
        seen.append((q.dtype, k.dtype, v.dtype)) or real(q, k, v, **kw))
    try:
        fit(dataset(1))
    finally:
        attn_mod.flash_attention = real
    pdt = {p.dtype for p in gpt.parameters()}
    mdt = {adam.state(p)[m].dtype for p in gpt.parameters()
           for m in ("moment1", "moment2")}
    adt = {d for tri in seen for d in tri}
    if pdt != {torch.float32} or mdt != {torch.float32} \
            or adt != {torch.bfloat16} or len(seen) != cfg.layers:
        raise RuntimeError(f"phase 7 dtypes: params {pdt}, moments {mdt}, "
                           f"attention inputs {adt} over {len(seen)} calls")

    # the main path: count launches over the timed fits only
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    estimates, losses, steps = [], [], 0
    ev = []
    for _ in range(2):
        dt_short, _, ls = fit(dataset(n_short))
        losses += ls
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dt_long, _, ll = fit(dataset(n_long))
        end.record()
        torch.cuda.synchronize()
        ev.append(start.elapsed_time(end) / n_long)
        losses += ll
        steps += n_short + n_long
        delta = (dt_long - dt_short) / (n_long - n_short)
        if delta > 0:
            estimates.append(delta)
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    vals = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in vals) or len(vals) != steps:
        raise RuntimeError(f"phase 7: losses {vals}")
    want = {k: 0 for k in counts}
    want.update({"flash_attention_fwd": cfg.layers * steps,
                 "flash_attention_bwd_dq": cfg.layers * steps,
                 "flash_attention_bwd_dkv": cfg.layers * steps})
    if counts != want:
        raise RuntimeError(f"phase 7 launches {counts} != {want} "
                           f"({steps} forward calls and steps)")
    step_s = min(estimates) if estimates else dt_long / n_long
    tokens_s = B * T / step_s
    mfu = tokens_s * gpt.flops_per_token(T) / BF16_FLOPS_PER_S
    log(f"PHASE 7 training [{power}] GPT-2 124M B={B} T={T} AMP O2 bf16 "
        f"Model.fit: {steps} steps, losses {[round(x, 4) for x in vals]}; "
        f"ms_per_step marginal (bench.py's estimate) {step_s * 1e3:.3f} "
        f"(estimates {[round(e * 1e3, 3) for e in estimates]}), CUDA "
        f"events over the long fits {[round(e, 3) for e in ev]}; "
        f"tokens_per_s {tokens_s:.1f}; MFU {mfu:.4f} (x "
        f"flops_per_token(1024)={gpt.flops_per_token(T)} / 989e12); "
        f"max_memory_allocated {peak} B; launches {counts} "
        f"(= 12 x {steps})")

    # one repeated batch: the loss goes down
    one = dataset(1)
    rep = TensorDataset([np.tile(t, (8, 1)) for t in one.tensors])
    _, _, rl = fit(rep)
    rl = [float(x) for x in rl]
    if not rl[-1] < rl[0]:
        raise RuntimeError(f"phase 7: the loss on one repeated batch did "
                           f"not fall: {rl}")
    log(f"PHASE 7 one batch eight times: losses {rl}")

    # where one step's device time goes
    ids, labels = (t[:B] for t in dataset(1).tensors)
    prof = profile_kernels(torch, lambda: model.train_batch(
        [ids, labels], sync=False), 3)
    total = sum(us for us, _ in prof.values())
    groups = {"flash_attention_fwd": 0.0, "flash_attention_bwd_dq": 0.0,
              "flash_attention_bwd_dkv": 0.0, "gemm": 0.0, "other": 0.0}
    for name, (us, _) in prof.items():
        if flash_group(name):
            groups[flash_group(name)] += us
        elif any(w in name.lower() for w in ("gemm", "xmma", "cutlass",
                                              "nvjet")):
            groups["gemm"] += us
        else:
            groups["other"] += us
    top = "; ".join(f"{n[:70]} {us:.1f}us x{c:g}" for n, (us, c) in sorted(
        prof.items(), key=lambda kv: -kv[1][0])[:12])
    # the LM head (linear_cross_entropy forward + backward) alone, at the
    # step's shapes and dtypes
    x = torch.randn((B * T, cfg.hidden), device="cuda").bfloat16() \
        .requires_grad_(True)
    w = (torch.randn((cfg.vocab_size, cfg.hidden), device="cuda") * 0.02) \
        .bfloat16().requires_grad_(True)
    lab = torch.from_numpy(labels.reshape(-1)).cuda()

    def head(_):
        rows = TF.linear_cross_entropy(x, w, lab, reduction="none")
        torch.autograd.grad(rows.sum(), (x, w))

    head_ms = cuda_ms(torch, head, 3)
    flash_ms = sum(v for k, v in groups.items() if k.startswith("flash")) / 1e3
    log(f"PHASE 7 step breakdown [{power}]: device_ms_per_step "
        f"{total / 1e3:.3f} of which " + ", ".join(
            f"{k} {v / 1e3:.3f}" for k, v in groups.items())
        + f"; LM head (linear_cross_entropy fwd+bwd, fp32 logits) alone "
        f"{head_ms:.3f} ms; the rest of the step (less the flash kernels "
        f"and the LM head) {total / 1e3 - flash_ms - head_ms:.3f} ms; top "
        f"kernels per step: {top}")
    for rec in records:       # the pair's record: one per dq launch
        rec["launches"] = counts[rec["name"] if rec["name"] in counts
                                 else "flash_attention_bwd_dq"]
    del model, net, gpt, adam, x, w
    torch.cuda.empty_cache()


# ----------------------------------------------------------- phase 11

LIFECYCLE_NORM_SLACK = 1e-6    # post-clip global norm <= 1.0 (1 + slack)
LIFECYCLE_PARAM_REL = 1e-4     # narrow step, card vs CPU, of the largest


def lifecycle_optimizer(opt, nn, params, peak=6e-4, clip=1.0, start=0.0):
    """AdamW as the GPT-3 paper's Appendix B sets it (beta2 0.95, weight
    decay 0.1, global-norm clip 1.0, linear warmup then cosine decay),
    the schedule shortened to 2 warmup steps and a cosine of 8."""
    sched = opt.lr.LinearWarmup(opt.lr.CosineAnnealingDecay(peak, T_max=8),
                                warmup_steps=2, start_lr=start, end_lr=peak)
    return opt.AdamW(learning_rate=sched, beta1=0.9, beta2=0.95,
                     weight_decay=0.1, grad_clip=nn.ClipGradByGlobalNorm(clip),
                     parameters=params)


def grad_norm(torch, params):
    """The global norm of the parameters' gradients, on the device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        [p.grad for p in params if p.grad is not None], 2.0,
        dtype=torch.float32)))


def same_state(torch, a, b):
    """Names of the parameters and optimizer slots where Model `a` and `b`
    differ (bit for bit); the scheduler states must be equal too."""
    bad = []
    for (n, p), (_, q) in zip(a.network.named_parameters(),
                              b.network.named_parameters()):
        if not torch.equal(p, q):
            bad.append(n)
        sa, sb = a._optimizer.state(p), b._optimizer.state(q)
        for k, v in sa.items():
            w = sb[k]
            if not (torch.equal(v, w) if isinstance(v, torch.Tensor)
                    else (v == w and type(v) is type(w))):
                bad.append(f"{n}/{k}")
    if a._optimizer._scheduler_state() != b._optimizer._scheduler_state():
        bad.append("LR_Scheduler")
    return bad


def phase_lifecycle_parity(torch, np):
    """One AdamW + clip + scheduler step of a narrow GPT (phase 6's) on the
    card against the same step on the CPU, fp32, TF32 off; the clip is
    active (0.1, below the gradients' norm) and its post-clip norm is
    checked on the card.

    Adam's first step moves every weight by about +-lr whatever the
    gradient's size, and an entry whose gradient is near 0 (or near eps)
    moves by a different fraction of lr on each device, whose summation
    orders differ in such a gradient's last bits. So the peak lr is 1e-5,
    which keeps a whole flip (2 lr) inside the gate next to weights of
    ~0.02, and the biases and LayerNorm shifts, zero in
    `init_params_numpy`, are drawn from N(0, 0.02) like the weights:
    a zero-initialised bias is nothing but its first update, and "within
    1e-4 of its largest" would then measure the gradient's last bits
    against lr itself."""
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.optimizer as opt
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig, init_params_numpy

    cfg = GPTConfig(vocab_size=512, max_seq_len=512, hidden=128, layers=2,
                    heads=2)
    arrays = init_params_numpy(cfg, seed=1)
    rng = np.random.default_rng(9)
    for k, v in arrays.items():
        if k.endswith(".bias"):
            arrays[k] = (rng.standard_normal(v.shape) * 0.02).astype(
                np.float32)
    ids = rng.integers(0, cfg.vocab_size, (2, 512), dtype=np.int32)
    labels = np.concatenate([ids[:, 1:], ids[:, :1]], axis=1)
    out = {}
    for dev in ("cuda", "cpu"):
        ptt.set_device(dev)
        gpt = GPT(cfg).load_numpy(arrays)
        o = lifecycle_optimizer(opt, nn, gpt.parameters(), peak=1e-5,
                                clip=0.1, start=5e-6)
        loss = gpt.loss(ids, labels)
        loss.backward()
        o.step()
        out[dev] = (loss.item(), float(o._grad_clip.global_norm),
                    float(grad_norm(torch, gpt.parameters())),
                    {n: p.detach().cpu() for n, p in gpt.named_parameters()})
    ptt.set_device("cuda")
    (lg, ng, post, pg), (lc, nc, _, pc) = out["cuda"], out["cpu"]
    worst = max((float((pg[n] - pc[n]).abs().max())
                 / max(float(pc[n].abs().max()), 1e-12), n) for n in pc)
    if abs(lg - lc) > TRAIN_LOSS_TOL or worst[0] > LIFECYCLE_PARAM_REL \
            or not ng > 0.1 or post > 0.1 * (1 + LIFECYCLE_NORM_SLACK):
        raise RuntimeError(f"phase 11 narrow step: loss {lg} vs {lc}, worst "
                           f"parameter {worst}, pre-clip norm {ng} (must "
                           f"exceed the clip, 0.1), post-clip {post}")
    log(f"PHASE 11 narrow AdamW + clip + scheduler step, cuda vs cpu (GPT "
        f"hidden=128 layers=2 T=512 fp32, TF32 off): loss {lg:.7f} vs "
        f"{lc:.7f} (gate {TRAIN_LOSS_TOL}); pre-clip norm {ng:.6f} vs "
        f"{nc:.6f}, post-clip on the card {post:.8f} (clip 0.1); worst "
        f"parameter {worst[1]} at {worst[0]:.3e} of its largest (gate "
        f"{LIFECYCLE_PARAM_REL})")


def phase_lifecycle(torch, np, power):
    """GPT-2 124M through the training lifecycle (see the module
    docstring, phase 11)."""
    import copy

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.optimizer as opt
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.framework import param_arrays
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi import callbacks as hapi_cbks
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.io import checkpoint as ckpt
    from paddle_tpu_torch.models import GPT, GPTConfig
    from paddle_tpu_torch.models.gpt import init_params_numpy
    from paddle_tpu_torch.static import InputSpec

    cfg = GPTConfig()
    B, T, n_train, n_eval, epochs = 16, 1024, 4, 2, 2
    paddle.set_device("gpu")
    weights = init_params_numpy(cfg, seed=0)

    class _LMLoss(nn.Layer):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, ids, labels):
            return self.m.loss(ids, labels)

    def build(arrays):
        gpt = GPT(cfg).load_numpy(arrays)
        model = Model(_LMLoss(gpt), inputs=[InputSpec([None, T], "int32"),
                                            InputSpec([None, T], "int32")])
        s = DistributedStrategy()
        s.amp = True
        s.amp_configs.use_pure_bf16 = True
        model.prepare(lifecycle_optimizer(opt, nn, model.parameters()),
                      metrics=None, strategy=s)
        return model

    rng = np.random.default_rng(11)

    def dataset(n_batches):
        ids = rng.integers(0, cfg.vocab_size, (n_batches * B, T),
                           dtype=np.int32)
        labels = np.concatenate([ids[:, 1:], ids[:, :1]], axis=1)
        return TensorDataset([ids, labels])

    class _Steps(hapi_cbks.Callback):
        """Each train step's lr, loss and pre- and post-clip gradient norms
        (device tensors), with the sync check armed around the step."""

        def __init__(self, watched):
            super().__init__()
            self.watched = watched
            self.lrs, self.losses, self.pre, self.post, self.evals = \
                [], [], [], [], []

        def on_train_batch_begin(self, step, logs=None):
            self.lrs.append(self.model._optimizer.get_lr())
            torch.cuda.set_sync_debug_mode("error")

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            self.pre.append(self.model._optimizer._grad_clip.global_norm)
            self.post.append(grad_norm(torch, self.watched))
            torch.cuda.set_sync_debug_mode(0)

        def on_epoch_end(self, epoch, logs=None):
            if "eval_loss" in logs:
                self.evals.append(float(logs["eval_loss"]))

    model = build(weights)
    params = model.parameters()
    train, evald = dataset(n_train), dataset(n_eval)
    rec = _Steps(params)
    with tempfile.TemporaryDirectory() as td:
        zero_counts()
        t0 = time.perf_counter()
        try:
            model.fit(train, eval_data=evald, batch_size=B, epochs=epochs,
                      verbose=0, shuffle=False, save_dir=td,
                      callbacks=[hapi_cbks.LRScheduler(by_step=True),
                                 hapi_cbks.ModelCheckpoint(save_dir=td,
                                                           keep_last=1),
                                 rec])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        fit_s = time.perf_counter() - t0
        counts = kernel_counts()
        files = sorted(os.listdir(td))
        steps = n_train * epochs
        losses = [float(x) for x in rec.losses]
        pre = [float(x) for x in rec.pre]
        post = [float(x) for x in rec.post]
        ref = lifecycle_optimizer(opt, nn, [])._lr_scheduler
        want_lrs = []
        for _ in range(steps):
            want_lrs.append(ref())
            ref.step()
        want = {k: 0 for k in counts}
        want.update({"flash_attention_fwd": cfg.layers * (steps + n_eval *
                                                           epochs),
                     "flash_attention_bwd_dq": cfg.layers * steps,
                     "flash_attention_bwd_dkv": cfg.layers * steps})
        clipped = [(a, b) for a, b in zip(pre, post) if a > 1.0]
        bad = [(a, b) for a, b in clipped
               if not b <= 1.0 * (1 + LIFECYCLE_NORM_SLACK)]
        if len(losses) != steps or not all(
                math.isfinite(x) for x in losses + rec.evals) \
                or len(rec.evals) != epochs:
            raise RuntimeError(f"phase 11: losses {losses}, eval losses "
                               f"{rec.evals}")
        if rec.lrs != want_lrs:
            raise RuntimeError(f"phase 11: lrs {rec.lrs} != the scheduler's "
                               f"{want_lrs}")
        if bad:
            raise RuntimeError(f"phase 11: post-clip norms above 1.0: {bad}")
        if counts != want:
            raise RuntimeError(f"phase 11 launches {counts} != {want}")
        if files != ["1.pdopt", "1.pdparams", "final.pdopt",
                     "final.pdparams"]:
            raise RuntimeError(f"phase 11: save_dir holds {files}")
        log(f"PHASE 11 lifecycle fit [{power}] GPT-2 124M B={B} T={T} AMP O2 "
            f"AdamW(beta2 0.95, wd 0.1) + ClipGradByGlobalNorm(1.0) + "
            f"LinearWarmup(CosineAnnealingDecay(6e-4, T_max=8), 2): "
            f"{epochs} epochs x {n_train} steps + eval of {n_eval} batches, "
            f"{fit_s:.3f}s with saves; losses {[round(x, 4) for x in losses]}"
            f"; eval losses {rec.evals}; lrs {rec.lrs}; pre-clip norms "
            f"{[round(x, 4) for x in pre]}, post-clip {[round(x, 6) for x in post]}"
            f" ({len(clipped)} of {steps} clipped); launches {counts}; no host "
            f"sync in a train step (set_sync_debug_mode error); save_dir "
            f"{files}")

        # resume: the final pair into a fresh GPT + Model + AdamW
        prefix = os.path.join(td, "final")
        nbytes = sum(os.path.getsize(prefix + e)
                     for e in (".pdparams", ".pdopt"))
        model2 = build(init_params_numpy(cfg, seed=1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model2.load(prefix)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model.save(os.path.join(td, "timed"))
        save_s = time.perf_counter() - t0
        diff = same_state(torch, model, model2)
        if diff:
            raise RuntimeError(f"phase 11: reloaded state differs at "
                               f"{diff[:8]}")

        # the same state through a format-2 checkpoint directory
        named = model.network.named_parameters()
        path = os.path.join(td, "step_8")
        t0 = time.perf_counter()
        ckpt.save_checkpoint(path, param_arrays(model.network),
                             model._optimizer.functional_state(named),
                             step=steps,
                             meta={"lr": model._optimizer._scheduler_state()})
        ck_save_s = time.perf_counter() - t0
        ck_bytes = sum(os.path.getsize(os.path.join(path, f))
                       for f in os.listdir(path))
        t0 = time.perf_counter()
        ckpt.validate_checkpoint(path, deep=True)
        p3, st3, _, step3, meta3 = ckpt.load_checkpoint(
            path, device=params[0].device)
        ck_load_s = time.perf_counter() - t0
        bad = [n for n, p in named if not torch.equal(p3[n], p)]
        for n, p in named:
            for k, v in model._optimizer.state(p).items():
                w = st3[n][k]
                if not (torch.equal(v, w) if isinstance(v, torch.Tensor)
                        else float(w) == float(v)):
                    bad.append(f"{n}/{k}")
        if bad or step3 != steps \
                or meta3["lr"] != model._optimizer._scheduler_state():
            raise RuntimeError(f"phase 11 format-2 round trip: {bad[:8]}, "
                               f"step {step3}, meta {meta3}")
        del p3, st3

    # 3 more steps: twice from the original's state (the spread of an
    # uninterrupted run), once from the reloaded model
    more = dataset(3)
    snap = ([p.detach().clone() for p in params],
            copy.deepcopy(model._optimizer._state),
            model._optimizer._scheduler_state())

    def three(m):
        cb = _Steps(m.parameters())
        torch.cuda.synchronize()
        t = time.perf_counter()
        m.fit(more, batch_size=B, epochs=1, verbose=0, shuffle=False,
              callbacks=[hapi_cbks.LRScheduler(by_step=True), cb])
        vals = [float(x) for x in cb.losses]
        dt = (time.perf_counter() - t) / len(vals)
        return vals, [p.detach().clone() for p in m.parameters()], dt

    la, pa, host_s = three(model)
    with torch.no_grad():
        for p, v in zip(params, snap[0]):
            p.copy_(v)
    model._optimizer._state = snap[1]          # keyed by id(param)
    model._optimizer._lr_scheduler.set_state_dict(snap[2])
    lb, pb, _ = three(model)
    lc, pc, _ = three(model2)

    def spread(l1, p1, l2, p2):
        return (max(abs(x - y) for x, y in zip(l1, l2)),
                max(float((x.float() - y.float()).abs().max())
                    for x, y in zip(p1, p2)))

    s_ab, s_ac = spread(la, pa, lb, pb), spread(la, pa, lc, pc)
    if (s_ab == (0.0, 0.0) and s_ac != (0.0, 0.0)) \
            or s_ac[0] > 2 * s_ab[0] or s_ac[1] > 2 * s_ab[1]:
        raise RuntimeError(f"phase 11 resume: resumed vs original {s_ac} "
                           f"(loss, parameter) beyond the determinism spread "
                           f"{s_ab}")
    log(f"PHASE 11 save/resume [{power}]: final.pdparams + .pdopt {nbytes} B;"
        f" Model.save {save_s:.3f}s, Model.load {load_s:.3f}s; the reload "
        f"bit-equal (every parameter, AdamW slot, scheduler state); format-2 "
        f"step_8 {ck_bytes} B, save_checkpoint {ck_save_s:.3f}s, "
        f"validate(deep) + load_checkpoint {ck_load_s:.3f}s, bit-equal; 3 "
        f"more steps: original {la}, again from its state {lb}, from the "
        f"reload {lc}; max |diff| (loss, parameter) original vs again "
        f"{s_ab}, vs reload {s_ac}")
    del model2, pa, pb, pc, snap
    torch.cuda.empty_cache()

    # where the time goes: one step, the clip, AdamW's update, Adam's
    ids, labels = (t[:B] for t in more.tensors)
    prof = profile_kernels(torch, lambda: model.train_batch(
        [ids, labels], sync=False), 2)
    step_us = sum(us for us, _ in prof.values())
    # a step that synced would hold the host until the card caught up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.train_batch([ids, labels], sync=False)
    dispatch_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    done_s = time.perf_counter() - t0
    o = model._optimizer
    pairs = [(p, p.grad) for p in params]
    clip_us = sum(us for us, _ in profile_kernels(
        torch, lambda: o._grad_clip(pairs), 3).values())
    clip, o._grad_clip = o._grad_clip, None
    lr = o.get_lr()
    adam = opt.Adam(learning_rate=1e-4, parameters=params)
    with torch.no_grad():
        adamw_us = sum(us for us, _ in profile_kernels(
            torch, lambda: o._update(lr), 3).values())
        o._grad_clip = clip
        adam._update(1e-4)                   # its moments, made once
        adam_us = sum(us for us, _ in profile_kernels(
            torch, lambda: adam._update(1e-4), 3).values())
    log(f"PHASE 11 step [{power}]: ms_per_step host clock {host_s * 1e3:.3f}"
        f" (3 steps of Model.fit, the lr callback and the checks' norms "
        f"included), device {step_us / 1e3:.3f} (torch.profiler, 2 steps); "
        f"one step returned to the host after {dispatch_s * 1e3:.3f} ms and "
        f"finished on the card after {done_s * 1e3:.3f} ms; "
        f"device us per step: ClipGradByGlobalNorm {clip_us:.1f}, AdamW "
        f"update (decay included) {adamw_us:.1f}, phase 7's Adam update "
        f"{adam_us:.1f}; clip + AdamW "
        f"{(clip_us + adamw_us) / step_us if step_us else float('nan'):.4f}"
        f" of the step")
    del model, adam, o, pairs
    torch.cuda.empty_cache()
    phase_lifecycle_parity(torch, np)


# ------------------------------------------------------------ phase 8

# the LM head of the slice: GPT-3 1.3B at B=4, T=2048 (N = B T rows)
CE_N, CE_H, CE_V = 8192, 2048, 50304
CE_LOSS_TOL = (1e-4, 1e-4)   # rtol, atol: tests/test_pallas_kernels.py:199
CE_GRAD_TOL = (2e-3, 1e-5)   # rtol, atol: tests/test_pallas_kernels.py:206
CE_TILE = 64                 # the bf16 kernels' streamed tile (rows of W
                             # or x) and resident rows per CTA
# bf16 kernels against the plain version run on the same bf16 tensors,
# which rounds dlg and the outputs to bf16 where the kernels do. What is
# left between them: fp32 summation order (~1e-6 relative) in the logits
# and the products, which now and then moves a dlg entry or an output
# across a bf16 rounding boundary (one ulp, at most 2^-7 of that element).
# The gate is per row (each [H] row of dx and of dW): the RMS of the error
# over the RMS of the plain row, at most 2^-6, twice what a row has when
# every element of it is one ulp off, as phase 5's gate for attention.
# Leaving out one 64-wide vocab tile (dx) or one 64-row tile of x (dW)
# from the plain version must fail it: phase 8 measures that. lse, lab and
# the loss are fp32 from the same operands and keep the fp32 contract.
CE_BF16_ROW_REL = 2.0 ** -6


def close_err(got, want, rtol, atol):
    """assert_allclose's rule as one number: the largest |got - want| -
    rtol |want| (the check passes when it is <= atol), and the max abs
    error."""
    d = (got.float() - want.float()).abs()
    return ((d - rtol * want.float().abs()).max().item(), d.max().item())


def ce_inputs(torch, N, H, V, dtype, seed):
    """x [N, H] ~ N(0, 1) (a LayerNorm's output), W [V, H] ~ N(0, 0.02)
    (the GPT init), labels [N] int64, the loss gradient g [N] ~ N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((N, H), generator=g, device="cuda").to(dtype)
    w = (torch.randn((V, H), generator=g, device="cuda") * 0.02).to(dtype)
    lab = torch.randint(0, V, (N,), generator=g, device="cuda")
    gg = torch.randn((N,), generator=g, device="cuda")
    return x, w, lab, gg


def check_ce(torch, fce, N, H, V, dtype, tag, seed):
    """The three kernels against the plain versions on the same inputs in
    `dtype` (the backward from the plain forward's lse). Raises unless
    every output passes its gate: loss, lse and lab by the fp32 contract;
    dx and dW by it in fp32 and by `row_rel_err` within CE_BF16_ROW_REL in
    bf16. Returns ({output: (gated error, max abs error)}, the inputs, the
    plain (dx, dW))."""
    x, w, lab, gg = ce_inputs(torch, N, H, V, dtype, seed)
    lse, lb = fce.fused_ce_forward(x, w, lab)
    rlse, rlb = fce.fused_ce_forward(x, w, lab, kernel="reference")
    got = (fce.fused_ce_bwd_dx(x, w, lab, rlse, gg),
           fce.fused_ce_bwd_dw(x, w, lab, rlse, gg))
    want = (fce.fused_ce_bwd_dx(x, w, lab, rlse, gg, kernel="reference"),
            fce.fused_ce_bwd_dw(x, w, lab, rlse, gg, kernel="reference"))
    torch.cuda.synchronize()
    out = {}
    for name, a, b in zip(("loss", "lse", "lab", "dx", "dw"),
                          (lse - lb, lse, lb) + got,
                          (rlse - rlb, rlse, rlb) + want):
        if not torch.isfinite(a).all():
            raise RuntimeError(f"{tag}: {name} non-finite")
        if name in ("loss", "lse", "lab"):
            gated, err = close_err(a, b, *CE_LOSS_TOL)
            tol = CE_LOSS_TOL[1]
        elif dtype == torch.float32:
            gated, err = close_err(a, b, *CE_GRAD_TOL)
            tol = CE_GRAD_TOL[1]
        else:
            gated, err = row_rel_err(a, b), rel_err(a, b)[0]
            tol = CE_BF16_ROW_REL
        if not gated <= tol:
            raise RuntimeError(f"{tag}: {name} error {gated} > {tol}")
        out[name] = (gated, err)
    return out, (x, w, lab, gg, rlse), want


def ce_dropped_tile_errs(torch, fce, inputs, plain):
    """How far the bf16 gate reaches: `row_rel_err` of the plain dx with
    the CE_TILE-wide vocab tile that holds row 0's label left out, and of
    the plain dW with the first CE_TILE rows of x left out, against the
    whole plain versions."""
    x, w, lab, gg, lse = inputs
    rdx, rdw = plain
    v0 = int(lab[0]) // CE_TILE * CE_TILE
    dlg = fce.dlogits_reference(x, w, lab, lse, gg)
    cut = dlg.clone()
    cut[:, v0:v0 + CE_TILE] = 0
    e_dx = row_rel_err(torch.matmul(cut.float(), w.float()).to(x.dtype), rdx)
    cut.copy_(dlg)
    cut[:CE_TILE] = 0
    e_dw = row_rel_err(torch.matmul(cut.float().t(), x.float()).to(w.dtype),
                       rdw)
    return {"dx": e_dx, "dw": e_dw}


def phase_fused_ce(torch, power):
    """Phase 8: the bf16 kernels' tensor-core instructions, the
    fused linear-CE kernels against their plain versions (fp32 with TF32
    off and bf16 at the slice's N=8192, H=2048, V=50304; a ragged N=200,
    H=96, V=700 in both; bf16 at a full-width ragged N=1000, H=2048,
    V=4100), the bf16 gate's reach, two bf16 forward and backward calls
    equal bit for bit, and device times by graph replay beside the bound,
    the plain versions, one cuBLAS product of the same shape, the forward's
    composition, the unfused head and the nearest library composition.
    Returns the three kernel records."""
    import torch.nn.functional as F
    from paddle_tpu_torch.nn.functional.loss import _LinearCrossEntropy
    from paddle_tpu_torch.ops.kernels import fused_ce as fce

    tensor_cores(CE_TC_KERNELS, "PHASE 8")
    N, H, V = CE_N, CE_H, CE_V
    cases = [("fp32 ragged N=200 H=96 V=700", 200, 96, 700, torch.float32,
              21),
             ("bf16 ragged N=200 H=96 V=700", 200, 96, 700, torch.bfloat16,
              22),
             ("bf16 full-width ragged N=1000 H=2048 V=4100", 1000, 2048,
              4100, torch.bfloat16, 26),
             (f"fp32 main N={N} H={H} V={V}", N, H, V, torch.float32, 23),
             (f"bf16 main N={N} H={H} V={V}", N, H, V, torch.bfloat16, 24)]
    errs = {}
    for tag, n, h, v, dtype, seed in cases:
        errs[tag], inputs, plain = check_ce(torch, fce, n, h, v, dtype,
                                            f"fused CE {tag}", seed)
        if tag.startswith("bf16 main"):
            reach = ce_dropped_tile_errs(torch, fce, inputs, plain)
        del inputs, plain
        torch.cuda.empty_cache()
    for tag, e in errs.items():
        gated = "assert_allclose excess, pass <= atol" if tag.startswith(
            "fp32") else "dx/dw: worst row RMS err / row RMS; loss/lse/lab: " \
            "assert_allclose excess"
        log(f"PHASE 8 fused CE check {tag}: " + " ".join(
            f"{n}={g:.3e}" for n, (g, _) in e.items()) + f" ({gated}); "
            "max abs err " + " ".join(f"{n}={m:.3e}"
                                      for n, (_, m) in e.items()))
    if min(reach.values()) <= CE_BF16_ROW_REL:
        raise RuntimeError(f"fused CE bf16 gate {CE_BF16_ROW_REL} would pass "
                           f"a dropped tile: {reach}")
    log(f"PHASE 8 fused CE bf16 gate {CE_BF16_ROW_REL:.3e} against one "
        f"{CE_TILE}-wide tile left out of the plain version: dx (the vocab "
        f"tile of row 0's label) {reach['dx']:.3e}, dw (the first "
        f"{CE_TILE} rows of x) {reach['dw']:.3e}")
    main = errs[f"bf16 main N={N} H={H} V={V}"]

    # timings at the slice's shapes, bf16
    x, w, lab, gg = ce_inputs(torch, N, H, V, torch.bfloat16, 25)
    lse, _ = fce.fused_ce_forward(x, w, lab)
    t = {}
    for name, kern in (
            ("fwd", lambda k: fce.fused_ce_forward(x, w, lab, kernel=k)),
            ("dx", lambda k: fce.fused_ce_bwd_dx(x, w, lab, lse, gg,
                                                 kernel=k)),
            ("dw", lambda k: fce.fused_ce_bwd_dw(x, w, lab, lse, gg,
                                                 kernel=k))):
        t[name] = graph_ms(torch, lambda _: kern(None), 3)
        t[name + "_plain"] = graph_ms(torch, lambda _: kern("reference"), 1)
        t[name + "_eager"] = cuda_ms(torch, lambda _: kern(None), 2, warm=1)
    same = {name: torch.equal(f(x, w, lab, lse, gg), f(x, w, lab, lse, gg))
            for name, f in (("dx", fce.fused_ce_bwd_dx),
                            ("dw", fce.fused_ce_bwd_dw))}
    f1, f2 = (fce.fused_ce_forward(x, w, lab) for _ in range(2))
    same["fwd"] = all(torch.equal(a, b) for a, b in zip(f1, f2))
    if not all(same.values()):
        raise RuntimeError(f"fused CE bf16 kernels not deterministic: "
                           f"bit-equal over two calls {same}")
    log(f"PHASE 8 fused CE bf16 forward (lse, lab) and backward, two calls "
        f"at N={N} H={H} V={V}: bit-equal {same}")
    # eagerly on the current stream: a graph's side and capture streams
    # would each keep a cuBLAS workspace that phase 10's peak would count
    wt = w.t()
    t["cublas"] = cuda_ms(torch, lambda _: torch.matmul(x, wt), 5, warm=2)
    t["fwd_compose"] = cuda_ms(torch, lambda _: F.cross_entropy(
        F.linear(x, w).float(), lab, reduction="none"), 3, warm=1)
    xl = x.detach().requires_grad_(True)
    wl = w.detach().requires_grad_(True)

    def unfused(_):
        rows = _LinearCrossEntropy.apply(xl, wl, lab)
        torch.autograd.grad(rows, (xl, wl), gg)

    def library(_):
        rows = F.cross_entropy(F.linear(xl, wl).float(), lab,
                               reduction="none")
        torch.autograd.grad(rows, (xl, wl), gg)

    def fused(_):
        rows = fce.fused_linear_cross_entropy(xl, wl, lab)
        torch.autograd.grad(rows, (xl, wl), gg)

    heads = {}
    for name, fn in (("fused", fused), ("unfused", unfused),
                     ("library", library)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(0)
        torch.cuda.synchronize()
        heads[name] = (graph_ms(torch, fn, 2),
                       torch.cuda.max_memory_allocated() - base)
    lib_rows = F.cross_entropy(F.linear(x, w).float(), lab, reduction="none")
    ker_rows = fce.fused_linear_cross_entropy(x, w, lab)
    lib_err = rel_err(lib_rows, ker_rows)[0]
    in_bytes = 2 * N * H + 2 * V * H + 8 * N
    prod = 2 * N * H * V
    recs = (kernel_record(
                "fused_linear_ce_fwd", "fused_linear_ce_fwd.cu",
                "paddle_tpu/ops/pallas/fused_ce.py:66",
                max(main["lse"][1], main["lab"][1]), t["fwd"],
                t["fwd_plain"], None, in_bytes + 8 * N, prod,
                BF16_FLOPS_PER_S),
            kernel_record(
                "fused_linear_ce_bwd_dx", "fused_linear_ce_bwd.cu",
                "paddle_tpu/ops/pallas/fused_ce.py:148", main["dx"][1],
                t["dx"], t["dx_plain"], None, in_bytes + 8 * N + 2 * N * H,
                2 * prod, BF16_FLOPS_PER_S),
            kernel_record(
                "fused_linear_ce_bwd_dw", "fused_linear_ce_bwd.cu",
                "paddle_tpu/ops/pallas/fused_ce.py:178", main["dw"][1],
                t["dw"], t["dw_plain"], None, in_bytes + 8 * N + 2 * V * H,
                2 * prod, BF16_FLOPS_PER_S))
    for rec, name in zip(recs, ("fwd", "dx", "dw")):
        log(f"PHASE 8 {rec['name']} [{power}] N={N} H={H} V={V} bf16: "
            f"kernel_ms={rec['ms']:.6f} (graph replay; eager "
            f"{t[name + '_eager']:.6f}) plain_ms={rec['plain_ms']:.6f} "
            f"bound_ms={rec['bound_ms']:.6f} ({rec['bound_by']}) "
            f"kernel_over_bound={rec['ms'] / rec['bound_ms']:.2f}x "
            f"achieved_tflops={(2 if name != 'fwd' else 1) * prod / rec['ms'] / 1e9:.3f}")
    log(f"PHASE 8 yardstick [{power}]: one cuBLAS bf16 product of the same "
        f"shape, torch.matmul [{N}, {H}] x [{H}, {V}] (fp32 sums, bf16 out; "
        f"the forward does one such product, dx and dW two each): "
        f"{t['cublas']:.6f} ms, {prod / t['cublas'] / 1e9:.3f} TFLOP/s; the "
        f"forward's composition F.cross_entropy(F.linear(x, w).float(), "
        f"reduction='none') {t['fwd_compose']:.6f} ms (CUDA events, eager)")
    log(f"PHASE 8 LM head forward + backward [{power}] N={N} H={H} V={V} "
        f"bf16 (graph replay; peak bytes above the inputs): fused kernels "
        f"{heads['fused'][0]:.6f} ms {heads['fused'][1]} B; unfused "
        f"_LinearCrossEntropy (fused=None at this V) {heads['unfused'][0]:.6f}"
        f" ms {heads['unfused'][1]} B; library F.linear bf16 + "
        f"F.cross_entropy fp32 {heads['library'][0]:.6f} ms "
        f"{heads['library'][1]} B (its loss vs the kernels' {lib_err:.3e}); "
        f"fused over unfused {heads['fused'][0] / heads['unfused'][0]:.2f}x, "
        f"over library {heads['fused'][0] / heads['library'][0]:.2f}x")
    del x, w, wt, lab, gg, lse, xl, wl, lib_rows, ker_rows
    torch.cuda.empty_cache()
    return recs, heads


# ----------------------------------------------------------- phase 8b

def phase_flash_1p3b(torch, power):
    """Phase 8b: the flash kernels at the slice's attention shape, B=4,
    T=2048, H=16, D=128 causal: fp32 (TF32 off) within the JAX contract,
    bf16 to phase 5's row gate (with its left-out tile), and device times
    by graph replay beside the bounds, the plain versions and the library
    calls. Returns the times."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    tensor_cores(FLASH_TC_KERNELS, "PHASE 8b", only="HGMMA")
    B, T, H, D = 4, 2048, 16, 128
    errs = {}
    for tag, dtype, seed in (("fp32", torch.float32, 31),
                             ("bf16", torch.bfloat16, 32)):
        errs[tag], inputs, plain = check_flash(
            torch, fa, B, T, H, D, dtype, True, f"flash 1.3B {tag}",
            True, seed)
        if dtype == torch.bfloat16:
            reach = dropped_tile_errs(fa, inputs, plain)
        del inputs, plain
        torch.cuda.empty_cache()
    if min(reach.values()) <= FLASH_BF16_ROW_REL:
        raise RuntimeError(f"flash bf16 gate {FLASH_BF16_ROW_REL} would pass "
                           f"a dropped tile at D=128: {reach}")
    for tag, e in errs.items():
        log(f"PHASE 8b flash check {tag} B={B} T={T} H={H} D={D} causal: "
            + " ".join(f"{n}={g:.3e}" for n, (g, _) in e.items())
            + " (gated: fp32 max abs err; bf16 worst row RMS err / row RMS,"
            " lse max abs err); max abs err "
            + " ".join(f"{n}={m:.3e}" for n, (_, m) in e.items()))
    log(f"PHASE 8b flash bf16 gate {FLASH_BF16_ROW_REL:.3e} against a left-"
        f"out 64-row tile: o {reach['o']:.3e}, dv {reach['dv']:.3e}")
    q, k, v, do = flash_inputs(torch, B, T, H, D, torch.bfloat16, 33)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o, lse = fa.flash_attention_forward(q, k, v, True)
    _, delta, q_s = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True)
    t = {"fwd": graph_ms(torch, lambda _: fa.flash_attention_forward(
             q, k, v, True), 10),
         "dq": graph_ms(torch, lambda _: fa.flash_attention_bwd_dq(
             q, k, v, o, do, lse, True), 5),
         "dkv": graph_ms(torch, lambda _: fa.flash_attention_bwd_dkv(
             q, k, v, do, lse, delta, True, q_s=q_s), 5),
         "fwd_plain": graph_ms(torch, lambda _: fa.flash_attention_forward(
             q, k, v, True, kernel="reference"), 1),
         "dq_plain": graph_ms(torch, lambda _: fa.flash_attention_bwd_dq(
             q, k, v, o, do, lse, True, kernel="reference"), 1),
         "dkv_plain": graph_ms(torch, lambda _: fa.flash_attention_bwd_dkv(
             q, k, v, do, lse, delta, True, kernel="reference"), 1),
         "sdpa": graph_ms(torch, lambda _: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=True), 10)}
    # the library backward, as phase 5b times it at GPT-2's shape
    aten = torch.ops.aten
    qc, kc, vc, doc = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_out = aten._scaled_dot_product_flash_attention(qc, kc, vc, 0.0, True)
    lib_args = (doc, qc, kc, vc) + tuple(lib_out[:6]) + (0.0, True) \
        + tuple(lib_out[6:8])
    t["bwd_library"] = graph_ms(torch, lambda _: (
        aten._scaled_dot_product_flash_attention_backward(*lib_args)), 5)
    del qc, kc, vc, doc, lib_out, lib_args
    pairs = B * H * flash_pairs(T, True)
    elems = B * T * H * D
    rows = 4 * B * H * T                 # one fp32 value per (b, h, t)

    def bound(nbytes, flops):
        return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3

    fwd_bound = bound(4 * 2 * elems + rows, 4 * D * pairs)
    # dq: q, k, v, O, dO, lse in, dq and delta out; S, dP, dS.K
    dq_bound = bound(6 * 2 * elems + 2 * rows, 6 * D * pairs)
    # dk/dv: q, k, v, dO, lse, delta in, dk and dv out; S, dP, dV, dK
    dkv_bound = bound(6 * 2 * elems + 2 * rows, 8 * D * pairs)
    bwd_bound = bound(8 * 2 * elems + rows, 10 * D * pairs)
    t.update(fwd_bound=fwd_bound, dq_bound=dq_bound, dkv_bound=dkv_bound,
             bwd_bound=bwd_bound)
    log(f"PHASE 8b flash [{power}] B={B} T={T} H={H} D={D} bf16 causal "
        f"(graph replay): fwd {t['fwd']:.6f} ms (bound {fwd_bound:.6f}, "
        f"{t['fwd'] / fwd_bound:.2f}x; plain {t['fwd_plain']:.6f}, torch "
        f"sdpa {t['sdpa']:.6f}); dq {t['dq']:.6f} (bound {dq_bound:.6f}, "
        f"plain {t['dq_plain']:.6f}) + dkv {t['dkv']:.6f} (bound "
        f"{dkv_bound:.6f}, plain {t['dkv_plain']:.6f}) = "
        f"{t['dq'] + t['dkv']:.6f} ms (bound {bwd_bound:.6f}, 10 D flops "
        f"per pair, {(t['dq'] + t['dkv']) / bwd_bound:.2f}x; plain "
        f"{t['dq_plain'] + t['dkv_plain']:.6f}; library "
        f"{t['bwd_library']:.6f}, aten._scaled_dot_product_flash_attention_"
        f"backward); per 1.3B step (24 layers, forward twice under "
        f"recompute) {48 * t['fwd'] + 24 * (t['dq'] + t['dkv']):.3f} ms")
    del q, k, v, do, o, lse, delta, q_s, qt, kt, vt
    torch.cuda.empty_cache()
    return t


# ------------------------------------------------------------ phase 9

def phase_recompute(torch, np):
    """Phase 9: a narrow GPT (hidden 128, 2 layers, 2 heads of 64, V=512,
    T=512, fused_head_ce=True) on the card in fp32 with TF32 off: the loss
    and every gradient with per-block recompute under each policy equal
    those without, bit for bit, and the launch counts show the recomputed
    flash forwards (2 x layers forward launches against layers for dq and
    for dk/dv) and one launch of each fused-CE kernel."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig, init_params_numpy

    cfg = GPTConfig(vocab_size=512, max_seq_len=512, hidden=128, layers=2,
                    heads=2, fused_head_ce=True)
    arrays = init_params_numpy(cfg, seed=3)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, cfg.vocab_size, (2, 512))
    labels = np.roll(ids, -1, axis=1)
    ptt.set_device("cuda")
    out = {}
    for policy in ("off", "dots_saveable", "nothing_saveable"):
        model = GPT(cfg).load_numpy(arrays)
        if policy != "off":
            model.enable_block_recompute(True, policy)
        zero_counts()
        loss = model.loss(ids, labels)
        loss.backward()
        torch.cuda.synchronize()
        model.enable_block_recompute(False)
        out[policy] = (loss.detach(), [p.grad for p in model.parameters()],
                       kernel_counts())
    base_loss, base_grads, base_counts = out["off"]
    for policy, (loss, grads, counts) in out.items():
        want = {k: 0 for k in counts}
        want.update({"flash_attention_fwd": cfg.layers * (
                         1 if policy == "off" else 2),
                     "flash_attention_bwd_dq": cfg.layers,
                     "flash_attention_bwd_dkv": cfg.layers,
                     "fused_linear_ce_fwd": 1, "fused_linear_ce_bwd_dx": 1,
                     "fused_linear_ce_bwd_dw": 1})
        if counts != want:
            raise RuntimeError(f"phase 9 {policy}: launches {counts} != "
                               f"{want}")
        diff = max([(loss - base_loss).abs().item()]
                   + [(a - b).abs().max().item()
                      for a, b in zip(grads, base_grads)])
        if diff != 0.0:
            raise RuntimeError(f"phase 9 {policy}: recompute moved the loss "
                               f"or a gradient by {diff}")
    log(f"PHASE 9 recompute on the card: GPT hidden=128 layers=2 heads=2 "
        f"V=512 T=512 B=2 fp32 fused_head_ce=True: loss "
        f"{base_loss.item():.7f} and every gradient equal bit for bit with "
        f"recompute under dots_saveable and nothing_saveable; launches "
        f"without {base_counts}; with {out['dots_saveable'][2]}")
    del out
    torch.cuda.empty_cache()


# ----------------------------------------------------------- phase 10

def timed_steps(step, n_short=1, n_long=5):
    """benchmarks/run.py's `_timed_steps`: one warm step, then twice a
    window of n_short and one of n_long chained steps, each ended by one
    host read of its last loss; the marginal step seconds (the smaller of
    (long - short) / (n_long - n_short)) and the step count."""
    def run(n):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = step()
        float(out)
        return time.perf_counter() - t0
    run(1)
    estimates, dl = [], None
    for _ in range(2):
        ds = run(n_short)
        dl = run(n_long)
        if dl > ds:
            estimates.append((dl - ds) / (n_long - n_short))
    secs = min(estimates) if estimates else dl / n_long
    return secs, estimates, 1 + 2 * (n_short + n_long)


def phase_slice(torch, np, power, ce_records):
    """Phase 10, the slice: benchmarks/run.py config 5's single-chip
    sequence (run.py:240-297) against paddle_tpu_torch: GPT-3 1.3B with
    seed-0 weights built on the card, pure bf16, per-block recompute,
    Momentum(1e-4, 0.9), compile_train_step(loss_method="loss"),
    _put_data, prog.step(ids, ids) at B=4, T=2048. Gates: finite losses
    falling on the repeated batch, per-step launches (flash forward 48, dq
    24, dk/dv 24, each fused-CE kernel 1), bf16 parameters, gradients and
    velocities. Prints ms per step, tokens/s, MFU, peak memory and the
    device time by kernel; then two steps with fused_head_ce=None beside
    them. Fills in the fused-CE records' launch counts."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.optimizer as opt
    from paddle_tpu_torch.distributed.fleet.compiler import compile_train_step
    from paddle_tpu_torch.distributed.fleet.strategy import \
        DistributedStrategy
    from paddle_tpu_torch.models import GPT, gpt3_1p3b

    t0 = time.perf_counter()
    paddle.set_device("gpu")
    paddle.seed(0)
    model = GPT(gpt3_1p3b(fused_head_ce=True)).bfloat16()
    model.eval()
    s = DistributedStrategy()
    s.recompute = True
    mom = opt.Momentum(learning_rate=1e-4, momentum=0.9,
                       parameters=list(model.parameters()))
    prog = compile_train_step(model, mom, s, loss_method="loss")
    rng = np.random.default_rng(0)
    B, T = 4, 2048
    ids = prog._put_data(
        rng.integers(0, model.cfg.vocab_size, (B, T)).astype(np.int64))
    torch.cuda.synchronize()
    log(f"PHASE 10 setup: GPT-3 1.3B ({model.num_params()} params, bf16) "
        f"on the card + Momentum + compile_train_step "
        f"{time.perf_counter() - t0:.3f}s")
    losses = []

    def step():
        loss = prog.step(ids, ids)
        losses.append(loss)
        return loss

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    step_s, estimates, n = timed_steps(step)
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    vals = [float(x) for x in losses]
    if len(vals) != n or not all(math.isfinite(x) for x in vals) \
            or not vals[-1] < vals[0]:
        raise RuntimeError(f"phase 10: losses {vals} over {n} steps")
    L = model.cfg.layers
    want = {k: 0 for k in counts}
    want.update({"flash_attention_fwd": 2 * L * n,
                 "flash_attention_bwd_dq": L * n,
                 "flash_attention_bwd_dkv": L * n,
                 "fused_linear_ce_fwd": n, "fused_linear_ce_bwd_dx": n,
                 "fused_linear_ce_bwd_dw": n})
    if counts != want:
        raise RuntimeError(f"phase 10 launches {counts} != {want} ({n} "
                           f"steps)")
    dts = {"params": {p.dtype for p in model.parameters()},
           "grads": {p.grad.dtype for p in model.parameters()},
           "velocity": {mom.state(p)["velocity"].dtype
                        for p in model.parameters()}}
    if any(d != {torch.bfloat16} for d in dts.values()):
        raise RuntimeError(f"phase 10 dtypes {dts}")
    tokens_s = B * T / step_s
    fpt = model.flops_per_token(T)
    log(f"PHASE 10 slice [{power}] GPT-3 1.3B B={B} T={T} pure bf16, "
        f"recompute (dots_saveable), Momentum 1e-4, fused_head_ce=True: {n} "
        f"steps on one repeated batch, losses {vals}; ms_per_step marginal "
        f"(run.py's _timed_steps(n_short=1, n_long=5)) {step_s * 1e3:.3f} "
        f"(estimates {[round(e * 1e3, 3) for e in estimates]}); tokens_per_s"
        f" {tokens_s:.1f}; MFU {tokens_s * fpt / BF16_FLOPS_PER_S:.4f} (x "
        f"flops_per_token(2048)={fpt} / 989e12); max_memory_allocated "
        f"{peak} B; launches {counts} (= per step x {n}); dtypes of params, "
        f"grads, velocities: bf16")

    # where one step's device time goes
    prof = profile_kernels(torch, step, 2)
    total = sum(us for us, _ in prof.values())
    groups = {"flash_attention_fwd": 0.0, "flash_attention_bwd_dq": 0.0,
              "flash_attention_bwd_dkv": 0.0, "fused_linear_ce_fwd": 0.0,
              "fused_linear_ce_bwd_dx": 0.0, "fused_linear_ce_bwd_dw": 0.0,
              "gemm": 0.0, "other": 0.0}
    for name, (us, _) in prof.items():
        if flash_group(name):
            groups[flash_group(name)] += us
        elif re.search(r"lce_fwd_(mma_|combine_)?kernel", name):
            groups["fused_linear_ce_fwd"] += us
        elif re.search(r"lce_bwd(_mma)?_kernel", name):
            groups["fused_linear_ce_bwd_dw" if "true" in name
                   else "fused_linear_ce_bwd_dx"] += us
        elif any(w in name.lower() for w in ("gemm", "xmma", "cutlass",
                                              "nvjet")):
            groups["gemm"] += us
        else:
            groups["other"] += us
    top = "; ".join(f"{k[:70]} {us:.1f}us x{c:g}" for k, (us, c) in sorted(
        prof.items(), key=lambda kv: -kv[1][0])[:12])
    flash_ms = sum(v for k, v in groups.items() if k.startswith("flash"))
    head_ms = sum(v for k, v in groups.items() if k.startswith("fused"))
    log(f"PHASE 10 step breakdown [{power}] (torch.profiler, 2 steps): "
        f"device_ms_per_step {total / 1e3:.3f} of which " + ", ".join(
            f"{k} {v / 1e3:.3f}" for k, v in groups.items())
        + f"; flash kernels {flash_ms / 1e3:.3f} ({flash_ms / total:.3f}), "
        f"fused-CE kernels {head_ms / 1e3:.3f} ({head_ms / total:.3f}); "
        f"top kernels per step: {top}")

    # the unfused head (fused_head_ce=None: V=50304 < FUSED_MIN_VOCAB)
    model.cfg.fused_head_ce = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    float(step())
    t1 = time.perf_counter()
    for _ in range(2):
        out = step()
    float(out)
    unf_s = (time.perf_counter() - t1) / 2
    unf_peak = torch.cuda.max_memory_allocated()
    unf_counts = kernel_counts()
    model.cfg.fused_head_ce = True
    if unf_counts["fused_linear_ce_fwd"] != 0 \
            or not all(math.isfinite(float(x)) for x in losses[-3:]):
        raise RuntimeError(f"phase 10 unfused: launches {unf_counts}, "
                           f"losses {[float(x) for x in losses[-3:]]}")
    log(f"PHASE 10 fused_head_ce=None [{power}]: ms_per_step "
        f"{unf_s * 1e3:.3f} (host clock over 2 steps after 1) vs fused "
        f"{step_s * 1e3:.3f}; tokens_per_s {B * T / unf_s:.1f}; MFU "
        f"{B * T / unf_s * fpt / BF16_FLOPS_PER_S:.4f}; "
        f"max_memory_allocated {unf_peak} B vs fused {peak} B; losses "
        f"{[float(x) for x in losses[-3:]]}")
    for rec in ce_records:
        rec["launches"] = counts[rec["name"]]
    del model, mom, prog, ids, losses
    torch.cuda.empty_cache()
    return counts


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; nothing was run")
    import numpy as np

    from paddle_tpu_torch.ops.kernels import _build

    # phase 1: environment and build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    power = gpu_name_and_power()
    log(f"PHASE 1 gpu: {power} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = _build.build(_build.sources())
    log(f"PHASE 1 build: {sorted(libs)} in {time.perf_counter() - t0:.3f}s")
    for name, path in sorted(libs.items()):
        logf = path.with_suffix(".log")
        info = [ln.strip() for ln in (logf.read_text().splitlines()
                                      if logf.is_file() else [])
                if "registers" in ln or "spill" in ln]
        log(f"PHASE 1 ptxas {name}: {' | '.join(info) or 'cached build'}")

    from paddle_tpu_torch.inference.decode import (DecodeEngine,
                                                   kv_page_bytes,
                                                   load_for_decode,
                                                   save_for_decode)
    from paddle_tpu_torch.models.gpt import (GPTDecoder, gpt2_124m,
                                             init_params_numpy,
                                             params_from_numpy)
    from paddle_tpu_torch.quant.ptq import dequantize_params, quantize_params

    records = [phase_paged_attention(torch, np, int8=False),
               phase_paged_attention(torch, np, int8=True)]
    cfg = gpt2_124m()
    t0 = time.perf_counter()
    arrays = init_params_numpy(cfg, seed=0)
    qarrays = quantize_params(arrays)
    log(f"PHASE 2b setup: seed-0 weights + quantize_params "
        f"{time.perf_counter() - t0:.3f}s")
    records.append(phase_int8_matmul(torch, np, cfg, qarrays, arrays))
    phase_int8_prefill(torch, cfg, arrays, qarrays, power)
    records.append(phase_decode_attention(torch, np))

    # phase 3: the fp32 path
    t0 = time.perf_counter()
    params = params_from_numpy(cfg, arrays, "cuda")
    eng = DecodeEngine(cfg=cfg, params=params, eps=1e-5, max_slots=8,
                       page_tokens=16, device="cuda")
    sigs = eng.warmup()
    log(f"PHASE 3 setup: weights+engine+warmup({sigs} step shapes) "
        f"{time.perf_counter() - t0:.3f}s")
    oracle = GPTDecoder(cfg, device="cuda")
    oracle.load_state_dict(params)
    prompts, outs, counts, _ = phase_engine(
        torch, np, power, cfg, eng, oracle, LOGIT_TOL, "PHASE 3", int8=False)
    records[0]["launches"] = counts["paged_decode_attention"]
    del oracle
    phase_step_profile(torch, np, cfg, params, power, "float32", "PHASE 3b")

    # phase 3-int8: int8 weights (a quant="int8" artifact) + int8 pages
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "gpt2_124m_int8")
        save_for_decode(qarrays, cfg, 1e-5, prefix, quant="int8")
        eng8 = load_for_decode(prefix, device="cuda", kv_dtype="int8",
                               max_slots=8, page_tokens=16)
    sigs = eng8.warmup()
    log(f"PHASE 3-int8 setup: save_for_decode(quant='int8') + "
        f"load_for_decode(kv_dtype='int8') + warmup({sigs} step shapes) "
        f"{time.perf_counter() - t0:.3f}s")
    kinds = {str(eng8.params[f"blocks.0.{rel}"].dtype) for rel in MATMULS}
    if kinds != {"torch.int8"}:
        raise RuntimeError(f"int8 engine holds block weights as {kinds}")
    deq = params_from_numpy(cfg, dequantize_params(qarrays), "cuda")
    oracle8 = GPTDecoder(cfg, device="cuda")
    oracle8.load_state_dict(deq)
    prompts8, outs8, counts8, _ = phase_engine(
        torch, np, power, cfg, eng8, oracle8, INT8_LOGIT_TOL,
        "PHASE 3-int8", int8=True)
    del oracle8
    same = sum(a == b for o8, o in zip(outs8, outs) for a, b in zip(o8, o))
    log(f"PHASE 3-int8 tokens equal to phase 3's fp32 streams (same "
        f"prompts): {same}/{sum(len(o) for o in outs)}; page bytes at "
        f"pt=16: int8 {kv_page_bytes(cfg, 16, 'int8')} vs fp32 "
        f"{kv_page_bytes(cfg, 16)}")
    records[1]["launches"] = counts8["paged_decode_attention_int8"]
    records[2]["launches"] = counts8["int8_weight_matmul"]
    phase_step_profile(torch, np, cfg, eng8.params, power, "int8",
                       "PHASE 3b-int8")
    phase_host_costs(torch, power)

    # phase 3-contig: the contiguous-cache decode path (gpt_decode_fns),
    # fp32 weights, then int8 block weights (fp32 caches in both)
    t0 = time.perf_counter()
    oracle = GPTDecoder(cfg, device="cuda")
    oracle.load_state_dict(params)
    counts_c = phase_contiguous_decode(torch, np, cfg, params, oracle,
                                       "PHASE 3-contig", int8=False)
    records[3]["launches"] = counts_c["decode_attention"]
    oracle.load_state_dict(deq)
    phase_contiguous_decode(torch, np, cfg, eng8.params, oracle,
                            "PHASE 3-contig-int8", int8=True)
    del oracle
    phase_port_gpt_step(torch, np)
    phase_contiguous_step_profile(torch, np, cfg, params, power)
    log(f"PHASE 3-contig took {time.perf_counter() - t0:.3f}s")

    phase_server(torch, np, cfg, arrays, prompts, outs, params, LOGIT_TOL,
                 "PHASE 4", int8=False)
    phase_server(torch, np, cfg, qarrays, prompts8, outs8, deq,
                 INT8_LOGIT_TOL, "PHASE 4-int8", int8=True)
    del eng, eng8, deq
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_spec(torch, np, power, cfg, arrays, params, prompts)
    log(f"PHASE 4-spec took {time.perf_counter() - t0:.3f}s")
    del params
    torch.cuda.empty_cache()

    # phases 5-7: the training path
    t0 = time.perf_counter()
    flash_records = phase_flash(torch, power)
    log(f"PHASE 5/5b took {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    phase_train_parity(torch, np)
    log(f"PHASE 6 took {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    phase_train(torch, np, power, flash_records)
    log(f"PHASE 7 took {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    phase_lifecycle(torch, np, power)
    log(f"PHASE 11 took {time.perf_counter() - t0:.3f}s")
    records += list(flash_records)

    # phases 8-10: the GPT-3 1.3B slice (benchmarks/run.py config 5)
    t0 = time.perf_counter()
    ce_records, _ = phase_fused_ce(torch, power)
    log(f"PHASE 8 took {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    phase_flash_1p3b(torch, power)
    log(f"PHASE 8b took {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    phase_recompute(torch, np)
    log(f"PHASE 9 took {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    phase_slice(torch, np, power, ce_records)
    log(f"PHASE 10 took {time.perf_counter() - t0:.3f}s")
    records += list(ce_records)

    for rec in records:
        for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                    "max_abs_err"):
            if rec[key] is not None and not math.isfinite(rec[key]):
                raise RuntimeError(f"{rec['name']}: {key} not finite")
    log(power)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
