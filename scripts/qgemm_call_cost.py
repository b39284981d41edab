#!/usr/bin/env python3
"""What one call of the chopped GEMM costs at the solver's trailing update.

    python3 scripts/qgemm_call_cost.py [--root DIR] [--rounds 5] [--reps 2000]

On a machine with an NVIDIA GPU. `qgemm_op` is the blocked LU's trailing
update on the main path; its largest shape is (448, 64) x (64, 448), and
a solve calls it from Python once per panel, so the host's cost of a
call counts as much as the device's. This script imports `repro_torch`
from `DIR/src` (default: the checkout it lives in), builds that tree's
kernels, and times `qgemm_op(a, b, fmt)` at that shape in format bf16:
per call with CUDA events around `--reps` back-to-back calls, `--rounds`
times (what a caller in Python sees: the host's cost of issuing a call
where that exceeds the device's), and on the device alone with
torch.profiler (every device kernel of a call). Comparing two trees
takes one process each, in turns in one run (A, B, B, A), since the
card and the host are shared with nothing else only within one run.
Prints one JSON line.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=2000)
    ap.add_argument("--fmt", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qgemm_call_cost: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import library
    from repro_torch.kernels.qmatmul import qgemm_op
    library.load()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(448, 64, generator=g, device=dev)
    b = torch.randn(64, 448, generator=g, device=dev)

    def call():
        return qgemm_op(a, b, args.fmt)
    for _ in range(50):
        call()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(args.rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            call()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / args.reps)
    n = 200
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, k = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (us + e.time_range.elapsed_us(), k + 1)
    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "root": root, "card": card, "shape": "(448, 64) x (64, 448)",
        "fmt": args.fmt, "reps": args.reps,
        "per_call_ms": per_call, "median_per_call_ms":
        statistics.median(per_call),
        # A session may drop a record: each kernel's mean per operation.
        "device_ms": sum(us / c * max(1, round(c / n))
                         for us, c in kernels.values()) / 1e3,
        "device_kernels": {k: {"ms_per_call": us / n / 1e3, "count": c}
                           for k, (us, c) in kernels.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
