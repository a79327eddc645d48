#!/usr/bin/env python3
"""Chip smoke test of paddle_tpu_torch on one NVIDIA GPU (built for H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. environment: card name and power limit, TF32 off, build every
     kernel under ops/kernels/csrc with nvcc (in parallel) and time it;
  2. each kernel against its plain PyTorch version at the shapes the main
     path gives it (paged decode attention: B=8, H=12, D=64, pt=16, W=64,
     P=513, lengths over 1..1024, plus edge cases), max abs error <= 1e-5;
     kernel, plain and library (gather + scaled_dot_product_attention)
     times with CUDA events, and the memory/compute bound;
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
  4. the decode server: a save_for_decode artifact served by
     `python -m paddle_tpu_torch.inference.serve --decode` in a
     subprocess, 4 concurrent wire requests compared with phase 3, its
     own kernel launch count equal to layers x its decode steps, then
     SIGTERM and a clean drain;
  5. one JSON line {"kernels": [...]} with every kernel's numbers;
  6. last line {"ok": true, "device": {...}}.

Without CUDA, or outside a checkout (no paddle_tpu_torch to import), it
exits non-zero and prints no result. It imports neither jax nor
paddle_tpu.
"""
import json
import math
import os
import queue
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12        # H100 SXM fp32, non-tensor-core
KERNEL_TOL = 1e-5               # kernel vs plain version, max abs error
LOGIT_TOL = 1e-4                # teacher-forced token vs max logit


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


# ------------------------------------------------------------ phase 2

def paged_attention_inputs(torch, np, rng, lengths, L, P, pt, H, D, W):
    """A random [L, P, pt, H, D] K/V pool, q per layer, and block tables
    giving every sequence its own random live pages (the rest null)."""
    B = len(lengths)
    g = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    k = torch.randn((L, P, pt, H, D), generator=g, device="cuda")
    v = torch.randn((L, P, pt, H, D), generator=g, device="cuda")
    q = torch.randn((L, B, H, D), generator=g, device="cuda")
    perm = rng.permutation(np.arange(1, P))
    tables = np.zeros((B, W), np.int32)
    for b, n in enumerate(lengths):
        live = -(-int(n) // pt)
        tables[b, :live] = perm[b * W:b * W + live]
    return (q, k, v, torch.from_numpy(tables).cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def phase_paged_attention(torch, np):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    B, H, D, pt, W, P, L = 8, 12, 64, 16, 64, 513, 12
    rng = np.random.default_rng(0)
    main_len = [int(x) for x in rng.integers(1, W * pt + 1, size=B)]
    # edge cases: length 1, exact page multiples, the full W*pt, a
    # padded batch row (length 1, all-null table), one past a page
    edge_len = [1, 16, 32, W * pt, 1, 17, 1008, 15]
    err = 0.0
    for lens in (main_len, edge_len):
        q, k, v, tables, lengths = paged_attention_inputs(
            torch, np, rng, lens, L, P, pt, H, D, W)
        if lens is edge_len:
            tables[4].zero_()
        for li in range(L):
            got = da.paged_decode_attention(q[li], k[li], v[li], tables,
                                            lengths)
            want = da.paged_decode_attention(q[li], k[li], v[li], tables,
                                             lengths, kernel="reference")
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError("paged_decode_attention: non-finite")
            err = max(err, (got - want).abs().max().item())
    if err > KERNEL_TOL:
        raise RuntimeError(f"paged_decode_attention max abs err {err} "
                           f"> {KERNEL_TOL}")

    # timing at the main path's shapes: rotate over the L layers' pools
    # (~300 MB of live K/V) so each launch finds its pages outside L2,
    # as a decode step's layer loop does
    q, k, v, tables, lengths = paged_attention_inputs(
        torch, np, rng, main_len, L, P, pt, H, D, W)
    idx = tables.long()
    live = (torch.arange(W * pt, device="cuda")[None, :]
            < lengths[:, None].long())[:, None, None, :]       # [B,1,1,S]

    def kernel(i):
        li = i % L
        return da.paged_decode_attention(q[li], k[li], v[li], tables,
                                         lengths)

    def plain(i):
        li = i % L
        return da.paged_decode_attention(q[li], k[li], v[li], tables,
                                         lengths, kernel="reference")

    def library(i):
        li = i % L
        kk = k[li][idx].reshape(B, W * pt, H, D).transpose(1, 2)
        vv = v[li][idx].reshape(B, W * pt, H, D).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q[li][:, :, None, :], kk, vv, attn_mask=live)[:, :, 0]

    lib_err = (library(0) - plain(0)).abs().max().item()
    ms = cuda_ms(torch, kernel, 240)
    plain_ms = cuda_ms(torch, plain, 48)
    library_ms = cuda_ms(torch, library, 48)
    rows = sum(main_len)
    pages = sum(-(-n // pt) for n in main_len)
    nbytes = 4 * (2 * B * H * D            # q in, out
                  + 2 * rows * H * D       # live K and V rows
                  + pages + B)             # live table entries, lengths
    flops = 4 * rows * H * D               # q.k and p.v, 2 flops each
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    rec = {"name": "paged_decode_attention", "route": "cuda",
           "source": "paddle_tpu_torch/ops/kernels/csrc/"
                     "paged_decode_attention.cu",
           "replaces": "paddle_tpu/ops/pallas/decode_attention.py:156",
           "launches": 0, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms}
    log(f"PHASE 2 paged_decode_attention B={B} H={H} D={D} pt={pt} W={W} "
        f"P={P} lengths={main_len} max_abs_err={err:.3e} "
        f"(gate {KERNEL_TOL}) kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} "
        f"library_ms={library_ms:.6f} (library vs plain err "
        f"{lib_err:.3e}) bound_ms={rec['bound_ms']:.6f} "
        f"({rec['bound_by']}, {nbytes} bytes, {flops} flops) "
        f"kernel_over_bound={ms / rec['bound_ms']:.2f}x")
    del q, k, v
    torch.cuda.empty_cache()
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


def phase_engine(torch, np, power):
    from paddle_tpu_torch.inference.decode import DecodeEngine
    from paddle_tpu_torch.models.gpt import (GPTDecoder, gpt2_124m,
                                             init_params_numpy,
                                             params_from_numpy)
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_124m()
    t0 = time.perf_counter()
    arrays = init_params_numpy(cfg, seed=0)
    params = params_from_numpy(cfg, arrays, "cuda")
    eng = DecodeEngine(cfg=cfg, params=params, eps=1e-5, max_slots=8,
                       page_tokens=16, device="cuda")
    sigs = eng.warmup()
    log(f"PHASE 3 setup: weights+engine+warmup({sigs} step shapes) "
        f"{time.perf_counter() - t0:.3f}s")
    rng = np.random.default_rng(1)
    head = [int(t) for t in rng.integers(0, cfg.vocab_size, 64)]
    prompts = []
    for i, n in enumerate((7, 16, 100, 255, 300, 511, 700, 900)):
        tail = [int(t) for t in rng.integers(0, cfg.vocab_size, n)]
        prompts.append(head + tail[:n - 64] if i in (3, 4) else tail)
    max_new = 32
    try:
        da.launches = 0
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        outs = [s.result(timeout=600) for s in streams]
        wall = time.perf_counter() - t0
        launches = da.launches
        st = eng.stats()
        steady = steady_window(eng, da, cfg, rng)
    finally:
        eng.stop()
    if any(len(o) != max_new for o in outs):
        raise RuntimeError(f"short streams: {[len(o) for o in outs]}")
    if launches != cfg.layers * st["steps"] or launches == 0:
        raise RuntimeError(f"kernel launches {launches} != layers "
                           f"{cfg.layers} x steps {st['steps']}")
    if st["prefix_cache"]["hits"] < 1:
        raise RuntimeError(f"expected a prefix hit: {st['prefix_cache']}")
    model = GPTDecoder(cfg, device="cuda")
    model.load_state_dict(params)
    gaps = [teacher_forced(torch, model, p, o) for p, o in zip(prompts, outs)]
    if max(gaps) > LOGIT_TOL:
        raise RuntimeError(f"teacher-forced check failed: gaps {gaps}")
    tokens = sum(len(o) for o in outs)
    step_ms = st["step_seconds"] / st["steps"] * 1e3
    log(f"PHASE 3 engine gpt2_124m slots=8 page_tokens=16 requests=8 "
        f"prompt_lens={[len(p) for p in prompts]} max_new={max_new} "
        f"streams_done=8 tokens={tokens} steps={st['steps']} "
        f"prefills={st['prefills']} prefix={st['prefix_cache']} "
        f"cow={st['cow_copies']} kernel_launches={launches} "
        f"teacher_forced_max_gap={max(gaps):.3e} (gate {LOGIT_TOL})")
    # a mixed window: most of its steps run one stream feeding the
    # prefix hit's prompt tail at batch 1, and yield no token
    log(f"PHASE 3 mixed window [{power}]: wall_s={wall:.6f} "
        f"tokens_per_s={tokens / wall:.3f} ms_per_step={step_ms:.6f} "
        f"tokens_per_step={st['tokens'] - st['prefills']}/{st['steps']} "
        f"(step_seconds={st['step_seconds']:.6f} over {st['steps']} steps, "
        f"step = host->device inputs + 12-layer paged step + logits to "
        f"host)")
    s_prompts, s_outs, s_wall, s_st = steady
    gaps = [teacher_forced(torch, model, p, o)
            for p, o in zip(s_prompts, s_outs)]
    if max(gaps) > LOGIT_TOL:
        raise RuntimeError(f"steady window teacher-forced check failed: "
                           f"gaps {gaps}")
    s_tokens = sum(len(o) for o in s_outs)
    log(f"PHASE 3 steady window [{power}]: 8 distinct "
        f"{len(s_prompts[0])}-token prompts x {len(s_outs[0])} new tokens, "
        f"wall_s={s_wall:.6f} tokens_per_s={s_tokens / s_wall:.3f} "
        f"steps={s_st['steps']} tokens_per_step="
        f"{(s_tokens - s_st['prefills']) / s_st['steps']:.3f} "
        f"ms_per_step={s_st['step_seconds'] / s_st['steps'] * 1e3:.6f} "
        f"prefills={s_st['prefills']} "
        f"prefill_s={s_wall - s_st['step_seconds']:.6f} (wall less steps) "
        f"kernel_launches={s_st['launches']} "
        f"teacher_forced_max_gap={max(gaps):.3e}")
    del model
    return cfg, arrays, prompts, outs, launches, params


def steady_window(eng, da, cfg, rng, n=8, plen=128, max_new=64):
    """8 streams decoding together: distinct prompts (no prefix hit, so
    no prompt tail goes through the step), all submitted at once. Returns
    (prompts, outputs, wall seconds, stats deltas)."""
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, plen)]
               for _ in range(n)]
    before = eng.stats()
    da.launches = 0
    t0 = time.perf_counter()
    streams = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    outs = [s.result(timeout=600) for s in streams]
    wall = time.perf_counter() - t0
    after = eng.stats()
    st = {"steps": after["steps"] - before["steps"],
          "step_seconds": after["step_seconds"] - before["step_seconds"],
          "prefills": after["prefills"] - before["prefills"],
          "launches": da.launches}
    if any(len(o) != max_new for o in outs) or st["steps"] == 0 \
            or st["launches"] != cfg.layers * st["steps"]:
        raise RuntimeError(f"steady window: streams "
                           f"{[len(o) for o in outs]}, {st}")
    return prompts, outs, wall, st


def phase_step_profile(torch, np, cfg, params, power):
    """Where a decode step's time goes: the 12-layer paged step at B=8,
    every sequence 512 tokens long, timed on the host clock (inputs in,
    logits out, as the engine runs it) and traced with torch.profiler
    for device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models.gpt import gpt_paged_decode_fns

    B, pt, W, n = 8, 16, 64, 512
    P = B * W + 1
    _, step = gpt_paged_decode_fns(cfg, page_tokens=pt)
    shape = (cfg.layers, P, pt, cfg.heads, cfg.head_dim)
    kpool = torch.zeros(shape, device="cuda")
    vpool = torch.zeros(shape, device="cuda")
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
    log(f"PHASE 3b step breakdown [{power}]: gpt2_124m B={B} len={n} "
        f"host_ms_per_step={host_ms:.6f} (readings "
        f"{', '.join(f'{h:.6f}' for h in host)}) "
        f"device_ms_per_step={dev_ms if rows else 'not measured'} "
        f"device_busy_share="
        f"{(dev_ms / host_ms) if rows else 'not measured'} "
        f"top kernels per step: {top or 'no device events recorded'}")


# ------------------------------------------------------------ phase 4

def phase_server(torch, np, cfg, arrays, prompts, outs, params):
    from paddle_tpu_torch.inference.decode import save_for_decode
    from paddle_tpu_torch.inference.serve import decode_request
    from paddle_tpu_torch.models.gpt import GPTDecoder

    picks = [0, 2, 4, 6]            # incl. one of the shared-head prompts
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "gpt2_124m")
        save_for_decode(arrays, cfg, 1e-5, prefix)
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.inference.serve",
             prefix, "--decode", "--decode-slots", "8", "--port", "0",
             # a PDI1 request carries no options: it gets this default
             "--decode-max-new", str(len(outs[0]))],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        lines: "queue.Queue[str]" = queue.Queue()
        out_log = []

        def pump():
            for line in proc.stdout:
                out_log.append(line.rstrip())
                lines.put(line.rstrip())
            lines.put(None)

        reader = threading.Thread(target=pump, daemon=True)
        reader.start()
        try:
            port = None
            deadline = time.monotonic() + 300
            while port is None:
                line = lines.get(timeout=max(deadline - time.monotonic(), 1))
                if line is None:
                    raise RuntimeError("server exited before SERVING:\n"
                                       + "\n".join(out_log[-40:]))
                if line.startswith("SERVING "):
                    port = int(line.split()[1])
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
    # the server's own counts: its requests went through the kernel on
    # the card, one launch per layer per decode step
    stats = [ln for ln in out_log if ln.startswith("DECODE STATS ")]
    if len(stats) != 1:
        raise RuntimeError("server printed no DECODE STATS line:\n"
                           + "\n".join(out_log[-40:]))
    kv = dict(f.split("=", 1) for f in stats[0].split()[2:])
    srv_steps = int(kv["steps"])
    srv_launches = int(kv["paged_decode_attention_launches"])
    if not kv["device"].startswith("cuda") or srv_steps == 0 \
            or srv_launches != cfg.layers * srv_steps:
        raise RuntimeError(f"server kernel launches {srv_launches} != "
                           f"layers {cfg.layers} x steps {srv_steps} on "
                           f"{kv['device']}")
    # the server batches 4 streams where phase 3 batched 8, so fp32 sums
    # may differ in the last bits; a token that differs must still be a
    # max-logit choice of the full forward (within LOGIT_TOL)
    model = None
    same = 0
    for i in picks:
        if results[i] == outs[i]:
            same += 1
            continue
        if model is None:
            model = GPTDecoder(cfg, device="cuda")
            model.load_state_dict(params)
        gap = teacher_forced(torch, model, prompts[i], results[i])
        if len(results[i]) != len(outs[i]) or gap > LOGIT_TOL:
            raise RuntimeError(f"server reply {i} ({len(results[i])} "
                               f"tokens) differs from the engine "
                               f"({len(outs[i])} tokens) and fails the "
                               f"teacher-forced check (gap {gap})")
    log(f"PHASE 4 server: 4 concurrent requests (3 PDI2 streams, 1 PDI1) "
        f"on port {port}, wall_s={wall:.6f}, identical_to_engine="
        f"{same}/4, device={kv['device']} steps={srv_steps} "
        f"kernel_launches={srv_launches} (= {cfg.layers} x steps), "
        f"SIGTERM -> DRAINED ok=True rc=0")


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

    records = [phase_paged_attention(torch, np)]
    cfg, arrays, prompts, outs, launches, params = phase_engine(
        torch, np, power)
    records[0]["launches"] = launches
    phase_step_profile(torch, np, cfg, params, power)
    phase_server(torch, np, cfg, arrays, prompts, outs, params)

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
