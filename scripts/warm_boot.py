#!/usr/bin/env python3
"""One fresh server process on the card: boot, serve, count the cold
steps.

    python3 scripts/warm_boot.py [--warmup none|sync|background]
        [--carrier float64] [--buckets 128 512] [--requests 5]
        [--seed 21] [--max-batch 4] [--actions 0,20,34,1]
        [--repeats 2] [--cache-dir DIR]

On a machine with an NVIDIA GPU, from the root of a checkout. It builds
an `AutotuneServer` over `GMRESIRTask(carrier_dtype=--carrier)` on the
card (bucket_step and min_bucket 128, `max_batch` --max-batch) from a
seeded policy (a 2-bin discretizer on the paper's features of the
requests, a Q-table drawn from the seed), with ``warmup=`` --warmup over
--buckets and ``compile_cache_dir=`` --cache-dir (None: the library's
default build directory), and waits until it reports ready (the
background sweep's end). Then it serves --requests dense systems a
bucket (`generate_dense_set`, n in [bucket - 28, bucket - 1]) one at a
time, the first of each bucket first, each submitted and drained on its
own (a one-row flush); with --actions, the first --max-batch requests
of the first bucket go in one flush instead, each under the action
given (the selection overridden): a batch that mixes the GEMM's routes.
Then it serves the first request of each bucket again, --repeats times,
under the action it took the first time: the same work in a warm
process, beside which the first request's latency is read.

It prints one line, ``RESULT`` and a JSON object: the seconds from the
start of the process to the imports' end, the constructor's, and the
boot to ready (constructor and warmup); the warmup's report; per
request its bucket, latency (submit to response, the server's clock),
and the kernel instances launched for the first time
(`kernels.library.COLD_LAUNCHES`), the nvcc runs, the cells run for the
first time (`core.executor`) and the dispatchers built during it;
`cache_stats()`; and a digest of the outcomes (action, status and every
metric's bits), equal across processes that served the same requests
whatever their warmup.
"""
import argparse
import hashlib
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (Discretizer, QTable, aot,  # noqa: E402
                              reduced_action_space)
from repro_torch.core import executor as EX  # noqa: E402
from repro_torch.core.features import PAPER_FEATURES  # noqa: E402
from repro_torch.core.policy import PrecisionPolicy  # noqa: E402
from repro_torch.data import generate_dense_set  # noqa: E402
from repro_torch.kernels import library  # noqa: E402
from repro_torch.obs import Observability, MetricsRegistry  # noqa: E402
from repro_torch.service import AutotuneServer, BatcherConfig  # noqa: E402
from repro_torch.tasks import GMRESIRTask  # noqa: E402


def requests(buckets, count, seed):
    """`count` dense systems a bucket, the first of each bucket first."""
    rng = np.random.default_rng(seed)
    per = [generate_dense_set(count, rng, n_range=(b - 28, b - 1))
           for b in buckets]
    return [s for k in range(count) for s in (p[k] for p in per)]


def policy(task, systems, space, seed):
    feats = np.stack([task.feature_of(s) for s in systems])
    disc = Discretizer.fit(feats, [2] * len(PAPER_FEATURES))
    qt = QTable(disc.n_states, space.n_actions)
    qt.Q = np.random.default_rng(seed).normal(size=qt.Q.shape)
    return PrecisionPolicy(space, disc, qt)


class ForcedServer(AutotuneServer):
    """The server with its next selections given (`forced`): the
    epsilon-greedy draw still happens, its action is replaced."""

    forced: list = []

    def select_action(self, features):
        state, action, eps, explore = super().select_action(features)
        if self.forced:
            return state, self.forced.pop(0), eps, False
        return state, action, eps, explore


def counts():
    return (library.cold_launch_count(), library.CACHE["misses"],
            EX.executor_compile_count(), len(EX._WRAPPED))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--warmup", default="none",
                    choices=("none", "sync", "background"))
    ap.add_argument("--carrier", default="float64")
    ap.add_argument("--buckets", type=int, nargs="+", default=[128, 512])
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--seed", type=int, default=21)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--actions", default=None)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--cache-dir", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("warm_boot: no CUDA device", file=sys.stderr)
        return 2
    t_imports = time.perf_counter() - T_START
    space = reduced_action_space()
    systems = requests(args.buckets, args.requests, args.seed)
    task = GMRESIRTask(action_space=space, carrier_dtype=args.carrier)
    cfg = BatcherConfig(max_batch=args.max_batch, max_wait_s=60.0,
                        bucket_step=128, min_bucket=128)
    forced = ([int(a) for a in args.actions.split(",")]
              if args.actions else [])
    t0 = time.perf_counter()
    srv = ForcedServer(policy(task, systems, space, args.seed), task,
                       batcher_cfg=cfg, seed=args.seed,
                       obs=Observability(registry=MetricsRegistry()),
                       warmup=None if args.warmup == "none" else args.warmup,
                       warmup_buckets=args.buckets,
                       compile_cache_dir=args.cache_dir)
    t_ctor = time.perf_counter() - t0
    if srv.warmup is not None and hasattr(srv.warmup, "wait"):
        srv.warmup.wait()
    t_ready = time.perf_counter() - t0
    srv.forced = list(forced)
    firsts = {}
    for s in systems:
        firsts.setdefault(task.bucket_key(s), s)
    served, queue = [], list(systems)
    while queue:
        group = [queue.pop(0)]
        if srv.forced:
            first = task.bucket_key(group[0])
            while len(group) < len(forced) and queue and \
                    task.bucket_key(queue[0]) == first:
                group.append(queue.pop(0))
        before = counts()
        ids = [srv.submit(s) for s in group]
        srv.drain()
        torch.cuda.synchronize()
        after = counts()
        for rid in ids:
            r = srv.poll(rid)
            served.append({"bucket": r.bucket, "latency_s": r.latency_s,
                           "rows": len(ids),
                           "cold_launches": after[0] - before[0],
                           "nvcc_runs": after[1] - before[1],
                           "cold_cells": after[2] - before[2],
                           "wrap_builds": after[3] - before[3],
                           "outcome": [int(r.action), int(r.record.status),
                                       {k: np.float64(v).tobytes().hex()
                                        for k, v in sorted(
                                            r.record.metrics.items())}]})
    first_action = {}
    for q in served:
        first_action.setdefault(q["bucket"], q["outcome"][0])
    repeats = []
    for _ in range(args.repeats):
        for b, s in firsts.items():
            before = counts()
            srv.forced = [first_action[b]]
            rid = srv.submit(s)
            srv.drain()
            torch.cuda.synchronize()
            r = srv.poll(rid)
            repeats.append({"bucket": r.bucket, "latency_s": r.latency_s,
                            "cold_launches": counts()[0] - before[0]})
    digest = hashlib.sha256(json.dumps(
        [s["outcome"] for s in served]).encode()).hexdigest()[:16]
    rep = srv.warmup_state()
    print("RESULT " + json.dumps({
        "warmup": args.warmup, "carrier": args.carrier,
        "device": torch.cuda.get_device_name(0),
        "imports_s": t_imports, "constructor_s": t_ctor,
        "boot_to_ready_s": t_ready, "ready": bool(srv.ready),
        "report": rep and {k: rep[k] for k in
                           ("done", "elapsed_s", "errors",
                            "warmed_buckets")},
        "requests": [{k: v for k, v in s.items() if k != "outcome"}
                     for s in served],
        "repeats": repeats,
        "cache": aot.cache_stats(), "digest": digest,
        "cold_launches_in_process": library.cold_launch_count()}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
