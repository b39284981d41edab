#!/usr/bin/env python3
"""One card split into shards: the sharded executor's threads, timed.

    python3 scripts/shard_threads.py [--shards 4] [--rounds 2] [--carrier float32]

On a machine with an NVIDIA GPU. `ShardedExecutor` runs one host thread
a device: shards on one device run in turn on that device's thread
(`core.executor._run_shards`). This script puts `--shards` shards on
cuda:0 through the device-list seam (`core.executor.mesh_devices`) and
times the engine's `prefill_all` (GMRES-IR on two of chip_smoke phase
4's dense systems, n 307 and 357, under four actions: one 8-row chunk,
2 rows a shard) three ways, in turns (A B C C B A, `--rounds` times):
A the local executor (one 8-row call), B the executor's rule (the shards
in turn on one thread), C a thread a shard (the rule replaced). Every
way must give the same outcomes. Prints the card, each run's wall and
one JSON line with the medians.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))


def thread_a_shard(jobs):
    """`_run_shards` with a thread for every shard, whatever its device."""
    results = [None] * len(jobs)

    def work(i):
        dev, fn = jobs[i]
        with torch.cuda.device(dev):
            results[i] = fn()

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(1, len(jobs))]
    for t in threads:
        t.start()
    work(0)
    for t in threads:
        t.join()
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--carrier", default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("shard_threads: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import (AutotuneEngine, LocalExecutor,
                                  ShardedExecutor, reduced_action_space)
    from repro_torch.core import executor as EX
    from repro_torch.data.matrices import generate_dense_set
    from repro_torch.kernels import library
    from repro_torch.solvers import IRConfig
    from repro_torch.tasks import GMRESIRTask
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    library.load()
    dev = torch.device("cuda", 0)
    space = reduced_action_space(subsample=4)
    systems = sorted(generate_dense_set(8, np.random.default_rng(2),
                                        n_range=(100, 500)),
                     key=lambda s: s.n)[2:4]
    rule = EX._run_shards
    EX.mesh_devices = lambda t: [dev] * args.shards

    def run(way):
        ex = LocalExecutor() if way == "A" else ShardedExecutor(
            data=args.shards)
        EX._run_shards = thread_a_shard if way == "C" else rule
        task = GMRESIRTask(systems, space, IRConfig(tau=1e-6), device=dev,
                           carrier_dtype=args.carrier, executor=ex)
        eng = AutotuneEngine(task, chunk=8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.prefill_all()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return wall, [(o.status, {k: np.float64(v).tobytes()
                                  for k, v in o.metrics.items()})
                      for o in (eng.outcome(i, a)
                                for i in range(len(systems))
                                for a in range(space.n_actions))]

    walls = {w: [] for w in "ABC"}
    want = None
    for way in "ABCCBA" * args.rounds:
        wall, out = run(way)
        if want is None:
            want = out
        if out != want:
            print(f"shard_threads: way {way} changed the outcomes",
                  file=sys.stderr)
            return 1
        walls[way].append(wall)
        print(f"{way} {wall:.4f} s", flush=True)
    print(json.dumps({
        "card": card, "shards": args.shards, "carrier": args.carrier,
        "rows": len(systems) * space.n_actions,
        "local_s": statistics.median(walls["A"]),
        "in_turn_s": statistics.median(walls["B"]),
        "thread_a_shard_s": statistics.median(walls["C"]),
        "walls": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
