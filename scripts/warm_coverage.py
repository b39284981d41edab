#!/usr/bin/env python3
"""Do a bucket's warm batches launch every kernel instance a live flush
launches?

    python3 scripts/warm_coverage.py [--chunk 4] [--flushes 8] [--seed 0]

On a machine with an NVIDIA GPU, from the root of a checkout, in one
process. For each solver (GMRES-IR on the dense generator, CG-IR on the
sparse SPD one at log10 kappa 2..6), carrier (float32, float64) and
bucket (128 strict, 512 blocked), over the reduced action space: it runs
the task's warm batches one by one (`tasks.base.LinearSystemTask
.warm_rows` under `warm_actions`, as `precompile_bucket` stacks them)
and records the kernel instances each launched for the first time
(`kernels.library.COLD_LAUNCHES`); then `--flushes` live flushes of 1
to `--chunk` rows of the bucket's systems through the task's
`solve_rows`, every other one with all rows under one action, the rest
under drawn actions, and records what they launched for the first time.
An earlier case's instances stay warm for the later ones, as in a server
process that serves several buckets.

Prints the card's name and power limit, then one JSON line a case: the
warm batches' action rows, the instances each added and its rows'
inner iterations, the seconds of the warm batches and of the flushes,
and `live_cold`, the instances the live flushes launched for the first
time (none when the warm batches cover them).
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import reduced_action_space  # noqa: E402
from repro_torch.data.matrices import (generate_dense_set,  # noqa: E402
                                       generate_sparse_set)
from repro_torch.kernels import library  # noqa: E402
from repro_torch.tasks import CGIRTask, GMRESIRTask  # noqa: E402
from repro_torch.tasks.base import stack_fixed  # noqa: E402

CASES = [(solver, carrier, bucket)
         for solver in ("gmres", "cg") for carrier in ("float32", "float64")
         for bucket in (128, 512)]


def systems(solver, bucket, rng, count):
    n_range = (bucket - 28, bucket - 1)
    if solver == "gmres":
        return generate_dense_set(count, rng, n_range=n_range)
    return generate_sparse_set(count, rng, n_range=n_range, lambda_s=0.01,
                               log10_kappa_range=(2.0, 6.0))


def keys(start):
    return [[str(f) for f in k] for k in library.COLD_LAUNCHES[start:]]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--flushes", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("warm_coverage: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    library.load()
    space = reduced_action_space()
    rng = np.random.default_rng(args.seed)
    for solver, carrier, bucket in CASES:
        task = (GMRESIRTask if solver == "gmres" else CGIRTask)(
            action_space=space, carrier_dtype=carrier)
        low = task.lowerable_for(bucket)
        blocked = dict(low.statics)["cfg"].blocking.use_blocked(bucket)
        row = task.warm_rows(bucket)
        warm = []
        t0 = time.perf_counter()
        for idx in task.warm_actions(bucket, args.chunk, blocked):
            c0 = library.cold_launch_count()
            A, b, x, acts, _ = stack_fixed(
                [row] * len(idx), [space.actions[a] for a in idx], len(idx))
            stats = low(A, b, x, acts)
            torch.cuda.synchronize()
            warm.append({"actions": idx, "new": len(keys(c0)),
                         "inner": [int(v) for v in stats[3].tolist()]})
        warm_s = time.perf_counter() - t0
        rows = [task.prepare(s)
                for s in systems(solver, bucket, rng, 4 * args.chunk)]
        c0 = library.cold_launch_count()
        t0 = time.perf_counter()
        k = 0
        for f in range(args.flushes):
            size = f % args.chunk + 1
            part = [rows[(k + j) % len(rows)] for j in range(size)]
            k += size
            a = rng.integers(0, space.n_actions, size=size)
            if f % 2:
                a[:] = a[0]
            task.solve_rows(part, [space.actions[i] for i in a], args.chunk)
        torch.cuda.synchronize()
        live_s = time.perf_counter() - t0
        print(json.dumps({"case": f"{solver} {carrier} {bucket}",
                          "warm": warm, "warm_s": warm_s,
                          "live_s": live_s, "live_cold": keys(c0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
