#!/usr/bin/env python3
"""The chain bound of the blocked trisolve, from latencies measured on the
card.

    python3 scripts/chain_bound.py [N_PAD] [BLOCK] [--dtype float64]
                                        # default 512 128, float32

The blocked solve's diagonal blocks are a chain of n_pad dependent rows.
In each row only one product waits for the row before (the one with
y[r - 1]); after it the algorithm cannot avoid: that product's rounding
(chop(L y)), the log2(block) adds on its path through the fixed tree,
the subtraction's rounding (chop(t - s)) and, for the upper solve, the
division and its rounding (chop(v / d)). The bound is n_pad times the
sum of their latencies. `chain_probe.cu` measures each latency with
clock64() over a dependent chain in one warp (format bf16, with values
that are never bf16 values, so every chop rounds), and the SM clock from
the same kernel's cycles over its CUDA-event time. The division counts
at its fastest exact form known here, `quotient` of chop_core.cuh with
1 / d prepared ahead (d is known before the chain reaches its row); the
IEEE division `__fdiv_rn` is printed beside it. On the float64 carrier
(`--dtype float64`, `bound(..., dtype=torch.float64)`) every operation
is the double one (chop_f64, `__dadd_rn`, ...) and the division is
`__ddiv_rn` itself: float64 has no wider type for `quotient`'s
reciprocal. `bound(n_pad, block)` is what chip_smoke prints beside the
bytes bound; this script prints it alone.
"""
import ctypes
import math
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(ROOT, "scripts", "chain_probe.cu")
REPS = 4096
# 1 + 2^-10 + 2^-20: products, differences and quotients of values near 1
# with it are never bf16 values, so every chop takes its full rounding
# path, and the chains stay near 1.
C = 1.0 + 2.0 ** -10 + 2.0 ** -20
OPS = ("add", "shuffle+add", "chop(mul)", "chop(sub)", "chop(fdiv)",
       "chop(div)")


def latencies(dtype=torch.float32):
    """({operation: cycles}, SM clock in GHz) measured on cuda:0 on the
    carrier `dtype`."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import library
    from repro_torch.precision.chop import fmt_params
    from pathlib import Path
    path = library.build(library.NVCC_FLAGS + ("-I", str(library.CSRC)),
                         [Path(PROBE)])
    lib = ctypes.CDLL(str(path))
    f64 = dtype == torch.float64
    probe = lib.repro_chain_probe_f64 if f64 else lib.repro_chain_probe
    probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + \
        [ctypes.c_int] * 3 + [ctypes.c_ulonglong if f64 else ctypes.c_uint,
                              ctypes.c_int,
                              ctypes.c_double if f64 else ctypes.c_float,
                              ctypes.c_void_p]
    out = torch.empty(32, dtype=dtype, device="cuda")
    cyc = torch.zeros(len(OPS), dtype=torch.int64, device="cuda")
    t, emin, xmax_bits, sat = fmt_params(2, dtype)
    stream = torch.cuda.current_stream().cuda_stream
    best = None
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = probe(out.data_ptr(), cyc.data_ptr(), REPS, t, emin, xmax_bits,
                   int(sat), C, stream)
        end.record()
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"chain probe launch failed: CUDA error {rc}")
        c = cyc.tolist()
        ghz = sum(c) / (start.elapsed_time(end) * 1e6)
        if best is None or sum(c) < sum(best[0]):
            best = (c, ghz)
    c, ghz = best
    return {op: c[i] / REPS for i, op in enumerate(OPS)}, ghz


def bound(n_pad: int, block: int, lat=None, ghz=None, dtype=torch.float32):
    """{"lower": ms, "upper": ms, "text": the arithmetic} of the chain
    bound at n_pad rows with `block`-wide trees on the carrier `dtype`."""
    if lat is None:
        lat, ghz = latencies(dtype)
    levels = int(math.log2(block))
    lower = lat["chop(mul)"] + levels * lat["add"] + lat["chop(sub)"]
    upper = lower + lat["chop(div)"]
    ms = {k: n_pad * v / (ghz * 1e6) for k, v in (("lower", lower),
                                                   ("upper", upper))}
    div = "chop(__ddiv_rn)" if dtype == torch.float64 else \
        "chop(div) with 1 / d ahead, chop(__fdiv_rn) " \
        f"{lat['chop(fdiv)']:.1f}"
    text = (f"{str(dtype)[6:]}: n_pad {n_pad} x (chop(mul) "
            f"{lat['chop(mul)']:.1f} + "
            f"{levels} x add {lat['add']:.1f} + chop(sub) "
            f"{lat['chop(sub)']:.1f} = {lower:.1f} cycles; upper + "
            f"chop(div) {lat['chop(div)']:.1f} = {upper:.1f}) at "
            f"{ghz:.3f} GHz: lower {ms['lower']:.4f} ms, upper "
            f"{ms['upper']:.4f} ms (latencies: clock64() over {REPS} "
            f"dependent operations in one warp, scripts/chain_probe.cu; "
            f"{div}; a shuffle-and-add level "
            f"{lat['shuffle+add']:.1f} cycles)")
    return dict(ms, text=text, cycles=lat, ghz=ghz)


def main():
    if not torch.cuda.is_available():
        print("chain_bound: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    dtype = torch.float32
    if "--dtype" in args:
        k = args.index("--dtype")
        dtype = getattr(torch, args[k + 1])
        del args[k:k + 2]
    n_pad = int(args[0]) if len(args) > 0 else 512
    block = int(args[1]) if len(args) > 1 else 128
    print(bound(n_pad, block, dtype=dtype)["text"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
