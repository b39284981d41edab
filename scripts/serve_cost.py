#!/usr/bin/env python3
"""What the online server's request stream costs on the card.

    python3 scripts/serve_cost.py [--requests 16] [--max-batch 4]

On a machine with an NVIDIA GPU, from the root of a checkout. It trains
chip_smoke's phase-4 policy (the dense set of seed 2, n in [100, 500],
the reduced action space, W1, 4 episodes), publishes it into a
`PolicyRegistry` in a temporary directory, and serves chip_smoke's
stream B (`generate_dense_set(16, rng(4), n_range=(100, 500))`, buckets
128..512, arriving as one burst) through `repro_torch.service.
AutotuneServer` twice, each time from the published policy: once on the
real clock (wall, requests/s, latency p50/p99, each flush's rows and
seconds) and once under torch.profiler (the device busy time, the sum
of its device operations' durations, and their number). The busy share
is the busy time over the first run's wall. Prints the card's name and
power limit, then one JSON line.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line():
    return subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True,
                          timeout=60).stdout.strip()


def device_busy(fn, sessions=3):
    """(device busy ms, device operations, result) of one call of fn;
    busy and operations None when no profiler session records device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if times:
            return sum(times) / 1e3, len(times), out
    return None, None, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_cost: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.core import (AutotuneEngine, TrainConfig, W1,
                                  reduced_action_space, train_policy)
    from repro_torch.data.matrices import generate_dense_set
    from repro_torch.kernels import library
    from repro_torch.obs import MetricsRegistry, Observability
    from repro_torch.service import (AutotuneServer, BatcherConfig,
                                     PolicyRegistry)
    from repro_torch.solvers import IRConfig
    from repro_torch.tasks import GMRESIRTask
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    library.load()
    cfg = IRConfig(tau=1e-6)
    train = GMRESIRTask(generate_dense_set(8, np.random.default_rng(2),
                                           n_range=(100, 500)),
                        reduced_action_space(), cfg, device=dev)
    policy, _ = train_policy(AutotuneEngine(train, chunk=8), W1,
                             TrainConfig(episodes=4, n_bins=(4, 4), seed=0))
    reqs = generate_dense_set(args.requests, np.random.default_rng(4),
                              n_range=(100, 500))
    out = {"requests": args.requests, "max_batch": args.max_batch,
           "n": sorted(s.n for s in reqs)}
    with tempfile.TemporaryDirectory() as root:
        reg = PolicyRegistry(root)
        reg.promote(reg.publish(policy))

        def serve():
            server = AutotuneServer(
                reg, GMRESIRTask(ir_cfg=cfg, device=dev), W1,
                BatcherConfig(max_batch=args.max_batch), seed=0,
                obs=Observability(registry=MetricsRegistry()))
            flushes = []
            pump = server.batcher.pump

            def recording_pump(force=False):
                done = pump(force)
                flushes.extend(done)
                return done
            server.batcher.pump = recording_pump
            for sys_ in reqs:
                server.submit(sys_)
            server.drain()
            torch.cuda.synchronize()
            server.obs.close()
            return server, flushes

        library.reset_launches()
        t0 = time.perf_counter()
        server, flushes = serve()
        wall = time.perf_counter() - t0
        tel = server.telemetry.snapshot()
        out.update(wall_s=wall, requests_per_s=args.requests / wall,
                   latency_s=tel["latency_s"],
                   latency_s_per_bucket=tel["latency_s_per_bucket"],
                   status_counts=tel["status_counts"],
                   launches=dict(library.LAUNCHES),
                   flushes=[{"bucket": f.bucket, "requests": len(f.req_ids),
                             "rows": f.n_rows, "solve_s": f.solve_s}
                            for f in flushes])
        t0 = time.perf_counter()
        busy, ops, _ = device_busy(serve, sessions=1)
        out.update(profiled_wall_s=time.perf_counter() - t0,
                   device_busy_ms=busy, device_operations=ops,
                   busy_share=(busy / (wall * 1e3)
                               if busy is not None else None))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
