#!/usr/bin/env python3
"""What the online server's request stream costs on the card.

    python3 scripts/serve_cost.py [--requests 16] [--max-batch 4]
    python3 scripts/serve_cost.py --http [--requests 16] [--hold-gil]

On a machine with an NVIDIA GPU, from the root of a checkout. It trains
chip_smoke's phase-4 policy (the dense set of seed 2, n in [100, 500],
the reduced action space, W1, 4 episodes) and publishes it into a
`PolicyRegistry` in a temporary directory.

Without --http it serves chip_smoke's stream B (`generate_dense_set(16,
rng(4), n_range=(100, 500))`, buckets 128..512, arriving as one burst)
through `repro_torch.service.AutotuneServer` twice, each time from the
published policy: once on the real clock (wall, requests/s, latency
p50/p99, each flush's rows and seconds) and once under torch.profiler
(the device busy time, the sum of its device operations' durations, and
their number). The busy share is the busy time over the first run's
wall.

With --http it serves the first --requests systems of chip_smoke phase
11's stream (`generate_dense_set` of `HTTP_SEED`, n in [100, 500]) over
`serve_http` on 127.0.0.1, through a `ShadowServer` on
`GMRESIRTask(carrier_dtype="float64")` on the card (bucket_step 128,
max_batch 4, no rollout), each shape on a front door of its own from
the published policy: "one_at_a_time" (fire-and-poll and sync in turns,
as phase 11's stages) and "burst" (phase 11's burst: one client thread a
request, half sync and half fire-and-poll, all started together, in a
client process of their own, `chip_smoke.wire_burst`), each on the real
clock and then under torch.profiler for its busy share; then
"burst_in_process", the same burst with its client threads in this
process, beside the front door's event loop and worker (on the real
clock; a request that fails is counted, not raised). --hold-gil then
runs "burst_in_process_hold_gil": the same, with the kernel library
loaded through `ctypes.PyDLL`, so that no launch releases the
interpreter lock.

Prints the card's name and power limit, then one JSON line.
"""
import argparse
import collections
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


def hold_gil(library):
    """Reload the kernel library through ctypes.PyDLL: its launches keep
    the interpreter lock (ctypes.CDLL drops and retakes it on every
    call)."""
    import ctypes
    lib = ctypes.PyDLL(library.load()._name)
    for name, args in library._SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
    with library._LOCK:
        library._LIB = lib
        library._ENTRIES.clear()


def serve_stream_b(args, reg, cfg, dev, out):
    from repro_torch.core import W1
    from repro_torch.data.matrices import generate_dense_set
    from repro_torch.kernels import library
    from repro_torch.obs import MetricsRegistry, Observability
    from repro_torch.service import AutotuneServer, BatcherConfig
    from repro_torch.tasks import GMRESIRTask
    reqs = generate_dense_set(args.requests, np.random.default_rng(4),
                              n_range=(100, 500))
    out.update(max_batch=args.max_batch, n=sorted(s.n for s in reqs))

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


def serve_over_http(args, reg, cfg, dev, out):
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from repro_torch.core import W1
    from repro_torch.data.matrices import generate_dense_set
    from repro_torch.kernels import library
    from repro_torch.service import BatcherConfig, ShadowServer
    from repro_torch.service.http import HttpConfig, serve_http
    from repro_torch.tasks import GMRESIRTask
    seed, _ = cs.HTTP_SEED
    reqs = generate_dense_set(args.requests, np.random.default_rng(seed),
                              n_range=cs.HTTP_N)
    bodies = [cs.sys_body(s) for s in reqs]
    out["n"] = sorted(s.n for s in reqs)

    def serve(shape):
        """(wire seconds of the answered requests, errors, HTTP codes,
        seconds from the first request to the last answer)."""
        shadow = ShadowServer(
            reg, GMRESIRTask(ir_cfg=cfg, device=dev, carrier_dtype="float64",
                             bucket_step=128, min_bucket=128), W1,
            BatcherConfig(max_batch=cs.SERVE_MAX_BATCH, bucket_step=128,
                          min_bucket=128), seed=0, obs=False)
        fd = serve_http(shadow, cfg=HttpConfig(max_n=512,
                                               flush_interval_s=0.002))
        codes = collections.Counter()
        try:
            if shape == "one_at_a_time":
                t0 = time.perf_counter()
                wire = [cs.wire_solve(fd.url, b, sync=i % 2 == 1,
                                      codes=codes)[1]
                        for i, b in enumerate(bodies)]
                seconds = time.perf_counter() - t0
                errors = []
            else:
                rows, codes, seconds = cs.wire_burst(
                    fd.url, bodies, in_process=shape != "burst")
                wire = [sec for _, sec, err in rows if err is None]
                errors = [err for _, _, err in rows if err is not None]
            torch.cuda.synchronize()
        finally:
            fd.close()
        return wire, errors, codes, seconds

    shapes = ["one_at_a_time", "burst", "burst_in_process"]
    if args.hold_gil:
        shapes.append("burst_in_process_hold_gil")
    for shape in shapes:
        if shape.endswith("hold_gil"):
            hold_gil(library)
        library.reset_launches()
        wire, errors, codes, wall = serve(shape.replace("_hold_gil", ""))
        row = {"wall_s": wall, "answered": len(wire),
               "requests_per_s": len(wire) / wall,
               "wire_p50_s": cs.pct(wire, 50),
               "wire_p99_s": cs.pct(wire, 99),
               "failed": len(errors), "errors": errors,
               "codes": dict(codes),
               "launches": {k: v for k, v in library.LAUNCHES.items() if v}}
        if shape in ("one_at_a_time", "burst"):
            t0 = time.perf_counter()
            busy, ops, _ = device_busy(lambda: serve(shape), sessions=1)
            row.update(profiled_wall_s=time.perf_counter() - t0,
                       device_busy_ms=busy, device_operations=ops,
                       busy_share=(busy / (wall * 1e3)
                                   if busy is not None else None))
        out[shape] = row
        print(shape, json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--http", action="store_true")
    ap.add_argument("--hold-gil", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_cost: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.core import (AutotuneEngine, TrainConfig, W1,
                                  reduced_action_space, train_policy)
    from repro_torch.data.matrices import generate_dense_set
    from repro_torch.kernels import library
    from repro_torch.service import PolicyRegistry
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
    out = {"requests": args.requests}
    with tempfile.TemporaryDirectory() as root:
        reg = PolicyRegistry(root)
        reg.promote(reg.publish(policy))
        if args.http:
            serve_over_http(args, reg, cfg, dev, out)
        else:
            serve_stream_b(args, reg, cfg, dev, out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
