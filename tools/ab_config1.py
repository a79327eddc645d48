"""Run chip_smoke.py's phase 14(b), benchmarks/run.py config 1 (LeNet
through `Model.fit` with its default arguments, n=8192, B=256), from
several checkouts of the repo in turns, each in a process of its own, so
that their samples/s are compared on one card within one call.

    python3 tools/ab_config1.py [--reps N] ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is the root of a checkout: its own chip_smoke.py, benchmarks/
and paddle_tpu_torch/ are what runs. Every process runs the phase `reps`
times (each a warm and a timed epoch, and an epoch under the profiler)
and prints its lines; the last line is one JSON object
{"runs": [{"root": ..., "samples_per_s": [...]}, ...]}. Needs a GPU."""
import argparse
import json
import os
import subprocess
import sys

CHILD = """
import json, sys
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
if not torch.cuda.is_available():
    sys.exit("ab_config1: CUDA is not available")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
power = cs.gpu_name_and_power()
rates = [cs.phase_config1(torch, np, power)["value"] for _ in range({reps})]
print("AB_RATES " + json.dumps(rates), flush=True)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args()
    runs = []
    for root in args.roots:
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=root)
        p = subprocess.run([sys.executable, "-c",
                            CHILD.format(reps=args.reps)], cwd=root,
                           env=env, capture_output=True, text=True,
                           timeout=900)
        print(f"== {root} (exit {p.returncode})", flush=True)
        print(p.stdout[-4000:], p.stderr[-2000:], sep="\n", flush=True)
        if p.returncode != 0:
            sys.exit(f"ab_config1: the run from {root} failed")
        line = [ln for ln in p.stdout.splitlines()
                if ln.startswith("AB_RATES ")][-1]
        runs.append({"root": root,
                     "samples_per_s": json.loads(line.split(" ", 1)[1])})
    print(json.dumps({"runs": runs}), flush=True)


if __name__ == "__main__":
    main()
