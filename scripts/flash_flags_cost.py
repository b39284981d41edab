#!/usr/bin/env python3
"""What the port's exactness build flags cost the flash attention kernel.

    python3 scripts/flash_flags_cost.py     # from the root of a checkout,
                                            # on a machine with an NVIDIA GPU

The port builds every kernel with one set of flags: `-fmad=false` and no
`--use_fast_math`, which the chopped kernels need for their bits. Flash
attention does not need them. On its SIMT route the dot products spell
out fmaf and on its wgmma route they are the tensor cores' own, so what
the flags cost it is the accurate tanhf and the IEEE division of the
per-score softmax step (and, on SIMT, expf). This script builds
csrc/flash_attention.cu alone twice through
`repro_torch.kernels.library`, with the port's flags and with
`-fmad=true --use_fast_math`, both at once. It then times
`flash_attention_op` on each build, on each route (`ROUTES`' wgmma for
bf16, and SIMT through `route="simt"`), at chip_smoke's full-width bf16
cases (a), (b) and (c) with CUDA events, in turns (port, fast, fast,
port), and prints the largest difference between the two outputs and
the card's name and power limit.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

CASES = (   # (name, B, S, Hq, Hkv, D, keyword arguments of the op)
    ("a gemma2-9b local", 1, 8192, 16, 8, 256,
     dict(kind="local", window=4096, softcap=50.0)),
    ("b gemma2-9b global", 1, 8192, 16, 8, 256, dict(kind="attn")),
    ("c llama4-scout chunked", 1, 16384, 40, 8, 128,
     dict(kind="chunked", chunk=8192)),
)


def main():
    if not torch.cuda.is_available():
        print("flash_flags_cost: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import library
    from repro_torch.kernels.flash_attention import flash_attention_op
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    port = library.NVCC_FLAGS
    fast = tuple(f for f in port if f != "-fmad=false") + (
        "-fmad=true", "--use_fast_math")
    cu = [library.CSRC / "flash_attention.cu"]
    with ThreadPoolExecutor(2) as pool:
        paths = dict(zip(("port", "fast"), pool.map(
            lambda flags: library.build(flags, cu), (port, fast))))
    g = torch.Generator(device="cuda").manual_seed(4)
    for (name, b, s, hq, hkv, d, case), route in (
            (c, r) for c in CASES for r in ("wgmma", "simt")):
        q, k, v = (torch.randn(b, s, h, d, generator=g, device="cuda",
                               dtype=torch.bfloat16) for h in (hq, hkv, hkv))
        outs, times = {}, {key: [] for key in paths}
        for key in paths:                               # warm-up
            library.use(paths[key])
            outs[key] = flash_attention_op(q, k, v, route=route, **case)
        for key in ("port", "fast", "fast", "port"):
            library.use(paths[key])
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(3):
                flash_attention_op(q, k, v, route=route, **case)
            end.record()
            torch.cuda.synchronize()
            times[key].append(start.elapsed_time(end) / 3)
        diff = float((outs["port"].float() - outs["fast"].float()).abs()
                     .max())
        print(f"{name}, {route}: port flags {times['port']} ms, fast math "
              f"{times['fast']} ms; max |port - fast| {diff}", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
