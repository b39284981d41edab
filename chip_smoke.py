#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure ends the run with a non-zero exit and no result line):

  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from src/repro_torch/csrc (one nvcc run);
  3. hold each kernel against its plain torch version on the card, at the
     main path's shapes (n_pad 128..512, qgemm with K = 64), for all seven
     format ids: chop, qmv and trisolve bit for bit; qgemm within
     ulp_fmt(|want|) + Kp 2^-24 sum_k |a_ik||b_kj| per element (two
     summation orders of the same products plus one flipped output
     rounding);
  4. run the main path on the card: the paper's dense generator
     (n in [100, 500], buckets 128..512), the reduced action space, W1,
     `train_policy` for a few episodes, then `evaluate_policy`, with every
     kernel's launch count set to 0 just before and read just after (each
     must be > 0); then check one strict and one blocked solve on the card
     against the same solve on the CPU;
  5. time each kernel at those shapes: per call with CUDA events around
     back-to-back calls (`ms`, what a caller in Python sees) and its
     device time alone from torch.profiler (`device_ms`); beside it the
     plain version, a one-call PyTorch yardstick where one exists, and
     the kernel's bound (bytes over 3.35 TB/s or float32 operations
     over 67 TFLOP/s, the larger);
  6. profile one strict and one blocked solve: wall time, device busy
     time and the kernels that take it.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or run
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
N_PADS = (128, 256, 384, 512)
SEED = 2                       # 8 systems covering buckets 128..512
N_SYSTEMS = 8
EPISODES = 4

KERNELS = {
    "chop": ("src/repro_torch/csrc/chop.cu",
             "src/repro/kernels/chop/chop.py:48"),
    "qmv": ("src/repro_torch/csrc/qmv.cu",
            "src/repro/kernels/qmatmul/qmatmul.py:89"),
    "qgemm": ("src/repro_torch/csrc/qgemm.cu",
              "src/repro/kernels/qmatmul/qmatmul.py:113"),
    "trisolve": ("src/repro_torch/csrc/trisolve.cu",
                 "src/repro/kernels/trisolve/trisolve.py:57"),
}


def say(*args):
    print(*args, flush=True)


class Failed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise Failed(what)


def card_line():
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def abs_err(a, b):
    fin = torch.isfinite(a) & torch.isfinite(b)
    d = (a.double() - b.double()).abs()
    d = torch.where(fin, d, torch.where(same_bits_mask(a, b),
                                        torch.zeros_like(d),
                                        torch.full_like(d, float("inf"))))
    return float(d.max()) if d.numel() else 0.0


def same_bits_mask(a, b):
    return a.contiguous().view(torch.int32) == b.contiguous().view(torch.int32)


def ulp_fmt(y, fid):
    from repro_torch.precision import FORMAT_LIST
    f = FORMAT_LIST[fid]
    t, emin = min(f.t, 24), max(f.emin, -126)
    ay = y.double().abs()
    e = torch.floor(torch.log2(torch.where(ay > 0, ay, torch.ones_like(ay))))
    e = torch.clamp(torch.where(ay > 0, e, torch.full_like(e, emin)),
                    min=emin)
    return torch.pow(2.0, e - t + 1)


def stratified(n, dev, seed):
    """n float32 values: every exponent field, both signs, plus specials."""
    rng = np.random.default_rng(seed)
    exps = rng.integers(0, 256, n, dtype=np.uint32)
    pats = (rng.integers(0, 2, n, dtype=np.uint32) << 31) | (exps << 23) \
        | rng.integers(0, 1 << 23, n, dtype=np.uint32)
    x = pats.view(np.float32).copy()
    x[:11] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 448.0,
              464.0, 57344.0, 61440.0]
    return torch.from_numpy(x).to(dev)


def factor_like(n, dev, seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)) * 0.3
    M[np.diag_indices(n)] = rng.choice([-1.0, 1.0], n) * (2.0 + rng.random(n))
    return torch.tensor(M, dtype=torch.float32, device=dev)


def check_kernels(dev):
    """Phase 3: every kernel against its plain version on the card."""
    from repro_torch.kernels.chop import chop_op, chop_ref
    from repro_torch.kernels.qmatmul import qgemm_op, qgemm_ref, qmv_op, \
        qmv_ref
    from repro_torch.kernels.trisolve import trisolve_op, trisolve_ref
    from repro_torch.precision import FORMAT_LIST, chop
    err = {k: 0.0 for k in KERNELS}
    fids = range(len(FORMAT_LIST))
    g = torch.Generator().manual_seed(0)
    for n in N_PADS:
        A = (torch.randn(n, n, generator=g) * 10.0 ** torch.randint(
            -3, 4, (n, n), generator=g)).to(dev)
        v = torch.randn(n, generator=g).to(dev)
        s = stratified(n * n, dev, n).reshape(n, n)
        Lu = factor_like(n, dev, n)
        for fid in fids:
            for x in (A, v, s):
                got, want = chop_op(x, fid), chop_ref(x, fid)
                check(same_bits(got, want), f"chop n={n} fid={fid}")
                err["chop"] = max(err["chop"], abs_err(got, want))
            for chop_out in (True, False):
                got = qmv_op(A, v, fid, chop_out=chop_out)
                want = qmv_ref(A, v, fid, chop_out=chop_out)
                check(same_bits(got, want), f"qmv n={n} fid={fid}")
                err["qmv"] = max(err["qmv"], abs_err(got, want))
            for lower in (True, False):
                got = trisolve_op(Lu, v, fid, lower=lower, block=128)
                want = trisolve_ref(Lu, v, fid, lower=lower, block=128)
                check(same_bits(got, want),
                      f"trisolve n={n} lower={lower} fid={fid}")
                err["trisolve"] = max(err["trisolve"], abs_err(got, want))
        torch.cuda.synchronize()
    # qgemm at the blocked LU's trailing updates: (n_pad - k1, 64) x
    # (64, n_pad - k1) for k1 = 64, 128, ... (largest 448 at n_pad 512).
    for m in (448, 320, 192, 64):
        a = torch.randn(m, 64, generator=g).to(dev)
        b = torch.randn(64, m, generator=g).to(dev)
        for fid in fids:
            got, want = qgemm_op(a, b, fid), qgemm_ref(a, b, fid)
            ac, bc = chop(a, fid).double(), chop(b, fid).double()
            bound = 128 * 2.0 ** -24 * (ac.abs() @ bc.abs()) + ulp_fmt(want,
                                                                        fid)
            diff = (got.double() - want.double()).abs()
            check(bool(((got == want) | (diff <= bound)).all()),
                  f"qgemm m={m} fid={fid} outside the order tolerance")
            err["qgemm"] = max(err["qgemm"], abs_err(got, want))
    torch.cuda.synchronize()
    return err


def run_main_path(dev):
    """Phase 4: the bandit loop on the card, counting kernel launches."""
    from repro_torch.core import (AutotuneEngine, TrainConfig, W1,
                                  evaluate_policy, reduced_action_space,
                                  train_policy)
    from repro_torch.data.matrices import generate_dense_set
    from repro_torch.kernels import library
    from repro_torch.solvers import IRConfig
    from repro_torch.tasks import GMRESIRTask
    t0 = time.perf_counter()
    systems = generate_dense_set(N_SYSTEMS, np.random.default_rng(SEED),
                                 n_range=(100, 500))
    task = GMRESIRTask(systems, reduced_action_space(), IRConfig(tau=1e-6),
                       device=dev)
    engine = AutotuneEngine(task, chunk=8)
    buckets = sorted({task.bucket_key(s) for s in systems})
    say(f"main path: {N_SYSTEMS} systems, n = "
        f"{sorted(s.n for s in systems)}, buckets {buckets}, set-up "
        f"{time.perf_counter() - t0:.1f} s")
    check(buckets == list(N_PADS), f"buckets {buckets}")

    library.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    policy, hist = train_policy(engine, W1, TrainConfig(
        episodes=EPISODES, n_bins=(4, 4), seed=0))
    t1 = time.perf_counter()
    ev = evaluate_policy(policy, engine, tau_base=1e-6)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(library.LAUNCHES)
    say(f"train_policy: {EPISODES} episodes, {hist.n_solves} solves, "
        f"{t1 - t0:.1f} s; evaluate_policy: {t2 - t1:.1f} s")
    say("episode reward:", [round(r, 3) for r in hist.episode_reward])
    say("format usage per solve:", ev["usage_per_solve"])
    say("kernels", json.dumps(launches))
    for name in KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched")
    for i, a in ev["actions"]:
        o = engine.outcome(i, a)
        check(o.status in (0, 1, 2, 3), f"status {o.status}")
        if o.status != 3:
            check(np.isfinite(o.ferr) and np.isfinite(o.nbe),
                  f"non-finite ferr/nbe on a solve that did not fail: {o}")
    check(all(np.isfinite(ev["ferr"])), "evaluation ferr")
    return launches, systems


def check_against_cpu(systems, dev):
    """Phase 4b: one strict and one blocked solve, card vs CPU (float32
    carrier, plain versions). The strict path is pinned op for op, so it
    must agree bit for bit; the blocked path has the LU's unpinned dots
    (cuBLAS and the qgemm kernel vs the CPU's matmul), so it is held to
    equal status and iteration counts and ferr/nbe within 1e-3 relative,
    on an action whose factorization format (bf16) rounds every dot."""
    from repro_torch.core.batching import pad_to_bucket
    from repro_torch.solvers import IRConfig, gmres_ir
    cfg = IRConfig(tau=1e-6)
    strict = min(systems, key=lambda s: s.n)
    blocked = min((s for s in systems if s.n > 256), key=lambda s: s.n)
    for sys_, action, exact in ((strict, [2, 4, 5, 6], True),
                                (blocked, [2, 4, 5, 5], False)):
        A, b, x = pad_to_bucket(sys_)
        t0 = time.perf_counter()
        gpu = gmres_ir(A, b, x, action, cfg, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cpu = gmres_ir(A, b, x, action, cfg, device="cpu",
                       carrier_dtype="float32")
        t2 = time.perf_counter()
        say(f"n_pad={A.shape[0]} action={action}: card "
            f"{[float(v) for v in gpu]} ({t1 - t0:.2f} s), cpu "
            f"{[float(v) for v in cpu]} ({t2 - t1:.2f} s)")
        for f in ("status", "n_outer", "n_gmres"):
            check(int(getattr(gpu, f)) == int(getattr(cpu, f)),
                  f"{f} card vs cpu at n_pad={A.shape[0]}")
        if exact:
            for f, g_, c_ in zip(gpu._fields, gpu, cpu):
                check(torch.equal(g_.cpu(), c_), f"{f} card vs cpu, strict")
        else:
            for f in ("ferr", "nbe"):
                g_, c_ = float(getattr(gpu, f)), float(getattr(cpu, f))
                check(abs(g_ - c_) <= 1e-3 * abs(c_),
                      f"{f} card vs cpu, blocked: {g_} vs {c_}")


def time_ms(fn, reps, warmup=2):
    for _ in range(warmup):
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


def device_kernels(fn, reps):
    """Run fn reps times under torch.profiler; return {kernel name: total
    device microseconds} over the CUDA-side events, their count, and the
    wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out, count = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
            count += 1
    check(sum(out.values()) > 0, "profiler saw no device time")
    return out, count, wall


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def time_kernels(dev):
    """Phase 5: each kernel at the main path's largest shape, format bf16."""
    from repro_torch.kernels.chop import chop_op, chop_ref
    from repro_torch.kernels.qmatmul import qgemm_op, qgemm_ref, qmv_op, \
        qmv_ref
    from repro_torch.kernels.trisolve import trisolve_op, trisolve_ref
    from repro_torch.precision import chop
    fid, n, m = 2, 512, 448
    g = torch.Generator().manual_seed(1)
    A = torch.randn(n, n, generator=g).to(dev)
    v = torch.randn(n, generator=g).to(dev)
    a = torch.randn(m, 64, generator=g).to(dev)
    b = torch.randn(64, m, generator=g).to(dev)
    Lu = factor_like(n, dev, 7)
    Ac, vc, ac, bc = (chop(t, fid) for t in (A, v, a, b))
    rows = {}
    rows["chop"] = (lambda: chop_op(A, fid), lambda: chop_ref(A, fid), None,
                    2 * n * n * 4, 0, f"x ({n}, {n})")
    rows["qmv"] = (lambda: qmv_op(A, v, fid), lambda: qmv_ref(A, v, fid),
                   lambda: torch.mv(Ac, vc), (n * n + 2 * n) * 4,
                   2 * n * n, f"A ({n}, {n}) x v ({n},)")
    rows["qgemm"] = (lambda: qgemm_op(a, b, fid),
                     lambda: qgemm_ref(a, b, fid),
                     lambda: torch.matmul(ac, bc),
                     (2 * m * 64 + m * m) * 4, 2 * m * m * 64,
                     f"({m}, 64) x (64, {m})")
    rows["trisolve"] = (lambda: trisolve_op(Lu, v, fid, lower=True),
                        lambda: trisolve_ref(Lu, v, fid, lower=True),
                        None, (n * (n - 1) // 2 + 2 * n) * 4, n * (n - 1),
                        f"Lu ({n}, {n}), lower, block 128")
    out = {}
    for name, (kern, plain, lib, nbytes, flops, shape) in rows.items():
        ms = time_ms(kern, 200)
        plain_ms = time_ms(plain, 3 if name == "trisolve" else 50, warmup=1)
        lib_ms = time_ms(lib, 200) if lib is not None else None
        # Device time alone (the per-call times above include the host's
        # cost of issuing the call when that exceeds the kernel's).
        dev_ms = sum(device_kernels(kern, 50)[0].values()) / 50 / 1e3
        lib_dev_ms = (sum(device_kernels(lib, 50)[0].values()) / 50 / 1e3
                      if lib is not None else None)
        b_ms, b_by = bound(nbytes, flops)
        out[name] = (ms, plain_ms, lib_ms, b_ms, b_by, dev_ms, lib_dev_ms)
        say(f"time {name} [{shape}, bf16]: kernel {ms:.4f} ms per call, "
            f"{dev_ms:.4f} ms on the device; plain {plain_ms:.4f} ms; "
            "library " + ("-" if lib_ms is None else
                          f"{lib_ms:.4f} ms per call, {lib_dev_ms:.4f} ms "
                          "on the device")
            + f"; bound {b_ms:.6f} ms ({b_by})")
    return out


def profile_solves(systems, dev):
    """Phase 6: where a solve's time goes — one strict (n_pad 128) and one
    blocked (n_pad 512) solve under the profiler, after a warm-up solve."""
    from repro_torch.core.batching import pad_to_bucket
    from repro_torch.solvers import IRConfig, gmres_ir
    cfg = IRConfig(tau=1e-6)
    for sys_ in (min(systems, key=lambda s: s.n),
                 max(systems, key=lambda s: s.n)):
        A, b, x = pad_to_bucket(sys_)
        action = [2, 4, 5, 6]

        def solve():
            return gmres_ir(A, b, x, action, cfg, device=dev)
        solve()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kern, count, wall_prof = device_kernels(solve, 1)
        busy = sum(kern.values()) / 1e3
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
        say(f"profile n_pad={A.shape[0]} action={action}: wall {wall * 1e3:.1f}"
            f" ms ({wall_prof * 1e3:.1f} ms under the profiler), device busy "
            f"{busy:.1f} ms = {100 * busy / (wall * 1e3):.1f}% of the wall "
            f"without the profiler; {count} device operations; "
            "top kernels (ms): "
            + "; ".join(f"{k[:40]} {v / 1e3:.2f}" for k, v in top))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "src", "repro_torch", "csrc")):
        print("chip_smoke: run from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(root, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    try:
        card = card_line()
        say(card)
        from repro_torch.kernels import library
        library.load()
        built = library.BUILD_SECONDS
        say("build: " + (f"nvcc {built:.1f} s" if built is not None else
                         "found an existing build")
            + f" ({library.library_path().name})")
        t0 = time.perf_counter()
        err = check_kernels(dev)
        say(f"kernel checks passed in {time.perf_counter() - t0:.1f} s, "
            f"max abs err {err}")
        launches, systems = run_main_path(dev)
        check_against_cpu(systems, dev)
        timing = time_kernels(dev)
        profile_solves(systems, dev)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        ms, plain_ms, lib_ms, b_ms, b_by, dev_ms, lib_dev_ms = timing[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms,
                        "device_ms": dev_ms,
                        "library_device_ms": lib_dev_ms})
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
