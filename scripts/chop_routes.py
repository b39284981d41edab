#!/usr/bin/env python3
"""Device time of each route of the chop kernel, by size and form.

    python3 scripts/chop_routes.py [--reps 200] [--define NAME=VALUE ...]

On a machine with an NVIDIA GPU. For n from 64 to 2^20 float32 elements,
times three forms of `kernels.chop.chop_expr_op` at format bf16 on dense,
16-byte aligned vectors: "x" (chop(a)), "sub" (chop(a - b)) and
"sub_mul" (chop(a - chop(b c))), each forced onto every route that takes
it ("block" up to `BLOCK_MAX` elements, "vector", "strided"), and
reports each one's mean device time per launch from torch.profiler (the
route bound `BLOCK_MAX` and the vector route's block size and unroll
come from this table). `--define` builds `csrc/chop.cu` alone with
`-DNAME=VALUE` added to the port's flags and times that build (the
vector route's CHOP_VEC_THREADS and CHOP_VEC_UNROLL); one process per
variant. Prints one JSON line beside the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (64, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536,
         131072, 262144, 1 << 20)
FORMS = ("x", "sub", "sub_mul")


def device_us(fn, reps):
    """Mean device time of one launch, microseconds (every device kernel
    of the `reps` calls); None when no profiler session records one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if times:
            return sum(times) / len(times)
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--define", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chop_routes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import library
    from repro_torch.kernels.chop import ARITY, BLOCK_MAX, ROUTES, \
        chop_expr_op
    if args.define:
        library.use(library.build(
            library.NVCC_FLAGS + tuple("-D" + d for d in args.define),
            [library.CSRC / "chop.cu"]))
    else:
        library.load()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for n in SIZES:
        ops = [torch.randn(n, generator=g, device=dev) for _ in range(3)]
        for route in ROUTES:
            if route == "block" and n > BLOCK_MAX:
                continue
            row = {"n": n, "route": route}
            for form in FORMS:
                mine = ops[:ARITY[form]]
                row[form + "_us"] = device_us(
                    lambda: chop_expr_op(form, *mine, fmt_id=2, route=route),
                    args.reps)
            rows.append(row)
    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "reps": args.reps,
                      "defines": args.define, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
