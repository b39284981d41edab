#!/usr/bin/env python3
"""What one GMRES-IR solve of the main path costs, for one tree or two in
turns.

    python3 scripts/solve_cost.py [--root DIR] [--solves 3]
    python3 scripts/solve_cost.py --ab DIR_A DIR_B

On a machine with an NVIDIA GPU. With `--root` (default: the checkout it
lives in) it imports `repro_torch` from `DIR/src`, builds that tree's
kernels, and measures chip_smoke's phase-6 solves: the strict one (the
smallest system of the main path's set, n_pad 128) and the blocked one
(the largest, n_pad 512), action (bf16, tf32, fp32, fp64), after a
warm-up solve each: the wall time of `--solves` solves (each one) and
the chop kernel's launches in one, then under torch.profiler one
solve's device busy time (the sum of its device operations' durations)
and the number of those operations. Before the
solves it times `chop_op` at a 0-dim tensor and at (512, 512), format
bf16: per call with CUDA events around 2000 back-to-back calls, and on
the device from torch.profiler. Prints one JSON line.

The wall time of a solve is the host's (the device is busy a tenth of
it) and moves between calls of the same code, so a before/after figure
comes only from `--ab`: it runs the script once for each tree, one
process each, in turns A, B, B, A, and prints each run's line and, per
metric, the mean of each tree's two runs. To compare with another
commit, `git archive` it into `_checkout/<name>` (gitignored) and pass
that directory.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACTION = [2, 4, 5, 6]


def card_line():
    return subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def profile_device(fn, sessions=3):
    """(device busy ms, device operations) of one call of fn; None when no
    profiler session records device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if times:
            return sum(times) / 1e3, len(times)
    return None


def per_call_ms(fn, reps=2000):
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def one_tree(root, solves):
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.core.batching import pad_to_bucket
    from repro_torch.data.matrices import generate_dense_set
    from repro_torch.kernels import library
    from repro_torch.kernels.chop import chop_op
    from repro_torch.solvers import IRConfig, gmres_ir
    library.load()
    dev = torch.device("cuda", 0)
    out = {"root": root, "card": card_line()}
    g = torch.Generator(device=dev).manual_seed(0)
    for label, x in (("0-dim", torch.ones((), device=dev)),
                     ("(512, 512)", torch.randn(512, 512, generator=g,
                                                device=dev))):
        prof = profile_device(lambda x=x: [chop_op(x, 2) for _ in range(50)])
        out[f"chop {label}"] = {
            "ms_per_call": per_call_ms(lambda x=x: chop_op(x, 2)),
            "device_ms": None if prof is None else prof[0] / prof[1]}
    systems = generate_dense_set(8, np.random.default_rng(2),
                                 n_range=(100, 500))
    cfg = IRConfig(tau=1e-6)
    cases = (("strict", min(systems, key=lambda s: s.n)),
             ("blocked", max(systems, key=lambda s: s.n)))
    for label, s in cases:
        A, b, x = pad_to_bucket(s)

        def solve(A=A, b=b, x=x):
            return gmres_ir(A, b, x, ACTION, cfg, device=dev)
        library.reset_launches()
        stats = solve()
        torch.cuda.synchronize()
        chop_launches = library.LAUNCHES["chop"]
        walls = []
        for _ in range(solves):
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[label] = {"n_pad": int(A.shape[0]), "wall_ms": walls,
                      "median_wall_ms": statistics.median(walls),
                      "status": int(stats.status),
                      "n_gmres": int(stats.n_gmres),
                      "ferr": float(stats.ferr),
                      "chop_launches": chop_launches}
    for label, s in cases:
        A, b, x = pad_to_bucket(s)
        prof = profile_device(lambda: gmres_ir(A, b, x, ACTION, cfg,
                                               device=dev))
        out[label]["device_busy_ms"] = None if prof is None else prof[0]
        out[label]["device_operations"] = None if prof is None else prof[1]
    return out


def ab(dir_a, dir_b, solves):
    runs = []
    for root in (dir_a, dir_b, dir_b, dir_a):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--root", root, "--solves", str(solves)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    summary = {}
    for tree, idx in (("A", (0, 3)), ("B", (1, 2))):
        r = [runs[i] for i in idx]
        summary[tree] = {"root": r[0]["root"]}
        for key in ("strict", "blocked"):
            for m in ("median_wall_ms", "device_busy_ms",
                      "device_operations", "chop_launches"):
                vals = [x[key][m] for x in r if x[key][m] is not None]
                summary[tree][f"{key} {m}"] = \
                    statistics.mean(vals) if vals else None
        for key in ("chop 0-dim", "chop (512, 512)"):
            for m in ("ms_per_call", "device_ms"):
                vals = [x[key][m] for x in r if x[key][m] is not None]
                summary[tree][f"{key} {m}"] = \
                    statistics.mean(vals) if vals else None
    print(json.dumps({"card": runs[0]["card"], "order": "A B B A",
                      "mean_of_two_runs": summary}))
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--ab", nargs=2, metavar=("DIR_A", "DIR_B"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("solve_cost: no CUDA device", file=sys.stderr)
        return 2
    if args.ab:
        return ab(*(os.path.abspath(d) for d in args.ab), args.solves)
    print(json.dumps(one_tree(os.path.abspath(args.root), args.solves)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
