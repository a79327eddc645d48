"""Where a host-bound fit spends its host time on the card: run.py
config 1's LeNet fit (n=8192, B=256, Adam) with `prefetch_device` on and
off in turns, one epoch of each under cProfile (the functions with the
most time of their own), and the host microseconds of each call the
prefetch makes for one batch (pinning, the side-stream copy, the event,
the wait, `record_stream`) against the synchronous copy.

    python3 tools/fit_host_profile.py [--turns N] [--top K]

Needs a GPU; prints the card's name and power limit first."""
import argparse
import cProfile
import io
import os
import pstats
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def per_call_us(fn, n=200):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=6)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("fit_host_profile: CUDA is not available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.optimizer as opt
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.vision.models import LeNet
    paddle.set_device("gpu")
    paddle.seed(0)
    n, B = 8192, 256
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 1, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, (n, 1)).astype(np.int64)
    ds = TensorDataset([x, y])
    model = Model(LeNet())
    model.prepare(opt.Adam(learning_rate=1e-3,
                           parameters=model.parameters()),
                  paddle.nn.CrossEntropyLoss())
    model.fit(ds, epochs=1, batch_size=B, verbose=0)

    def epoch(prefetch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(ds, epochs=1, batch_size=B, verbose=0,
                  prefetch_device=prefetch)
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    rates = {True: [], False: []}
    for i in range(args.turns):
        for p in ((True, False) if i % 2 == 0 else (False, True)):
            rates[p].append(round(epoch(p), 1))
    print(f"LeNet fit n={n}, B={B}: samples/s with prefetch_device "
          f"{rates[True]}, without {rates[False]} (in turns)", flush=True)
    for p in (True, False):
        prof = cProfile.Profile()
        torch.cuda.synchronize()
        prof.enable()
        for _ in range(3):
            model.fit(ds, epochs=1, batch_size=B, verbose=0,
                      prefetch_device=p)
        torch.cuda.synchronize()
        prof.disable()
        s = io.StringIO()
        st = pstats.Stats(prof, stream=s)
        st.sort_stats("tottime").print_stats(args.top)
        print(f"== cProfile, 3 epochs, prefetch_device={p}: "
              f"{st.total_calls} calls, {st.total_tt:.3f} s", flush=True)
        print(s.getvalue(), flush=True)

    xb = torch.from_numpy(x[:B].copy())
    dev = torch.device("cuda")
    side = torch.cuda.Stream()
    cur = torch.cuda.current_stream()
    pinned = xb.pin_memory()
    on_dev = pinned.to(dev, non_blocking=True)

    def ctx():
        with torch.cuda.stream(side):
            pass

    def event():
        ev = torch.cuda.Event()
        ev.record(side)
        cur.wait_event(ev)

    costs = {
        "pin_memory (800 KB)": lambda: xb.pin_memory(),
        "pinned .to(cuda, non_blocking) on the side stream":
            lambda: _on(side, lambda: pinned.to(dev, non_blocking=True)),
        "pageable .to(cuda, non_blocking) on the side stream":
            lambda: _on(side, lambda: xb.to(dev, non_blocking=True)),
        "pageable .to(cuda, non_blocking)":
            lambda: xb.to(dev, non_blocking=True),
        "pageable .to(cuda) (synchronous)": lambda: xb.to(dev),
        "with torch.cuda.stream(side)": ctx,
        "Event() + record + wait_event": event,
        "record_stream": lambda: on_dev.record_stream(cur),
        "torch.cuda.current_stream()": lambda: torch.cuda.current_stream(
            dev),
    }
    for name, fn in costs.items():
        print(f"host us per call: {name} {per_call_us(fn):.2f}",
              flush=True)


def _on(stream, fn):
    import torch
    with torch.cuda.stream(stream):
        return fn()


if __name__ == "__main__":
    main()
