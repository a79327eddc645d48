"""Does a device trace hold every kernel launched while it runs? Traces
GPT-2 124M training steps (B=16, T=1024, AMP O2, Adam, `Model.fit`) in
turns two ways: a bare `torch.profiler.profile` entered just before the
work, and `paddle_tpu_torch.profiler.start_trace`, which returns only
once the device tracer records. Each trace starts with a marker kernel
launched as soon as the trace is on, then the steps. Prints, per trace,
the flash kernels' rows in the trace against their launch counters and
every CUDA launch that has no kernel row, in microseconds from the
marker's launch (negative: before it).

    python3 tools/trace_kernel_loss.py [--turns N] [--steps S]

Needs a GPU; prints the card's name and power limit first."""
import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FLASH = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
         "flash_bwd_dkv_wgmma_kernel")


def launch_counts():
    """The flash wrappers' launch counters (fwd, bwd dq, bwd dkv)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    return [fa.fwd_launches, fa.dq_launches, fa.bwd_launches]


def zero_counts():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    fa.fwd_launches = fa.dq_launches = fa.bwd_launches = 0


def trainer(steps):
    """A warmed-up `fit` over `steps` batches of GPT-2 124M."""
    import numpy as np
    import torch

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.optimizer as opt
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.models import GPT, GPTConfig
    from paddle_tpu_torch.models.gpt import init_params_numpy
    from paddle_tpu_torch.static import InputSpec
    cfg = GPTConfig()
    B, T = 16, 1024
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
    model.prepare(opt.Adam(learning_rate=1e-4,
                           parameters=model.parameters()), strategy=s)
    ids = np.random.default_rng(19).integers(
        0, cfg.vocab_size, (steps * B, T), dtype=np.int32)
    ds = TensorDataset([ids, np.roll(ids, -1, axis=1)])

    def fit():
        model.fit(ds, batch_size=B, epochs=1, verbose=0, shuffle=False,
                  log_freq=10 ** 9)
        torch.cuda.synchronize()
    fit()
    return fit


def traced(fit, bare):
    """One trace: the marker kernel as soon as the trace is on, then
    `fit`. Returns the trace's events."""
    import torch
    from paddle_tpu_torch import profiler
    with tempfile.TemporaryDirectory() as td:
        if bare:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        else:
            profiler.start_trace(td)
        with torch.profiler.record_function("marker"):
            torch.arange(7, device="cuda").cumsum(0)
        fit()
        if bare:
            prof.__exit__(None, None, None)
            path = os.path.join(td, "trace.json")
            prof.export_chrome_trace(path)
        else:
            path = profiler.stop_trace()
        with open(path) as f:
            return json.load(f)["traceEvents"]


def lost(events):
    """(flash rows by kernel, launches with no kernel row in us from the
    marker)."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    rows = {k: sum(k in e["name"] for e in kernels) for k in FLASH}
    have = {e.get("args", {}).get("correlation") for e in kernels}
    mark = min(e["ts"] for e in events if e.get("name") == "marker")
    missing = [round(e["ts"] - mark, 1) for e in events
               if e.get("cat") == "cuda_runtime" and "aunch" in e["name"]
               and e.get("args", {}).get("correlation") not in have]
    return rows, missing


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), torch.__version__,
          torch.version.cuda, flush=True)
    from paddle_tpu_torch.ops.kernels import _build
    _build.build(_build.sources())
    fit = trainer(a.steps)
    bad = {True: 0, False: 0}
    for turn in range(a.turns):
        for bare in (True, False):
            zero_counts()
            rows, missing = lost(traced(fit, bare))
            launched = launch_counts()
            bad[bare] += bool(missing) or list(rows.values()) != launched
            print(f"turn {turn} {'bare profile' if bare else 'start_trace'}"
                  f": flash rows {list(rows.values())}, launched "
                  f"{launched}; launches with no row (us from the marker) "
                  f"{missing}", flush=True)
    print(f"traces that lost a launch: bare profile {bad[True]} of "
          f"{a.turns}, start_trace {bad[False]} of {a.turns}")


if __name__ == "__main__":
    main()
