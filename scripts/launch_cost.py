#!/usr/bin/env python3
"""What each step of the chop wrapper's launch path costs on the host.

    python3 scripts/launch_cost.py [--root DIR] [--reps 20000]

On a machine with an NVIDIA GPU. A chop of a 0-dim float32 tensor, or
of one fused with the operation that produces it, is the most frequent
call of the solver's main path, and its time is the host's: the device
finishes the kernel long before the next call is issued. This script
imports `repro_torch` from `DIR/src` (default: the checkout it lives
in), builds that tree's kernels, and times on the host clock, as the
mean of `--reps` calls after a warm-up:

  * whole calls: `chop_op` and `CudaBackend.chop` of a 0-dim tensor, and,
    where the tree has `chop_expr`, `CudaBackend.chop_expr` as the
    solver calls it (a 0-dim product, a 0-dim `sub_div` into a slot of
    a vector, a masked product of 128 elements), beside one torch
    multiply of two 0-dim tensors and a compare and `torch.where`;
  * the steps of the wrapper one at a time, each where the tree has it:
    the operand checks, the layout, `data_ptr`, the output's allocation
    (`new_empty`, `torch.empty_like`), the format's arguments, the raw
    stream, the argument buffer and its `pack_into`, the ctypes call of
    the entry with an empty output (which returns before any launch) and
    with one launch, `library.check_cuda`, the device context,
    `torch.cuda.current_device`, and `library.count_launch`.

Prints one JSON line, the microseconds per call of each step beside the
card's name and power limit.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def per_call_us(fn, reps):
    for _ in range(min(reps, 1000)):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def chop_expr_steps(x, v):
    """The steps of this tree's `chop_expr_op` on a 0-dim product."""
    from repro_torch.kernels import library
    from repro_torch.kernels.chop import ops
    lib = library.load()
    entry = lib.repro_chop_expr
    buf, addr = ops._buffer()
    empty = ctypes.create_string_buffer(ops._ARGS.size)
    fmt = library.fmt_args(2)
    stream = library.raw_stream(0)

    # A tree whose struct carries the carrier's code after the format
    # (the float64 carrier's `DTYPE_CODES`) takes one more field; one
    # with batches (224 bytes) the row count and four batch strides after
    # the live range, and the ids and the format table after the stream.
    carrier = (0,) if hasattr(ops, "DTYPE_CODES") else ()
    batched = ops._ARGS.size == 224
    batch = (1, 0, 0, 0, 0) if batched else ()
    rows = (0, 0) if batched else ()

    def packed(M, into=buf):
        ops._ARGS.pack_into(into, 0, x.data_ptr(), 0, 0, x.data_ptr(), 0,
                            0, 0, 0, 0, v.data_ptr(), 0, 0, M, 1, 0, 1,
                            *batch, stream, *rows, 3, 0, *fmt, *carrier)
    steps = {
        "check_operands": lambda: ops.check_operands("mul", x, x, None),
        "_check_tensors": lambda: ops._check_tensors((x, x)),
        "expr_layout": lambda: ops.expr_layout((x, x)),
        "x.data_ptr()": x.data_ptr,
        "x.new_empty(())": lambda: x.new_empty(()),
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "library.fmt_args": lambda: library.fmt_args(2),
        "library.raw_stream": lambda: library.raw_stream(0),
        "argument buffer": ops._buffer,
        "pack_into": lambda: packed(1),
    }
    packed(0, empty)
    steps["ctypes call, empty output"] = \
        lambda: entry(ctypes.addressof(empty))

    def one_launch():
        packed(1)
        entry(addr)
    steps["pack_into + ctypes call, one launch"] = one_launch
    steps["library.call_packed, one launch"] = \
        lambda: library.call_packed("repro_chop_expr", "chop", 0, addr)
    return steps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("launch_cost: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels import library
    from repro_torch.kernels.chop import chop_op
    from repro_torch.precision import CudaBackend
    library.load()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    x = torch.ones((), device=dev)
    v = torch.ones(128, device=dev)
    bk = CudaBackend()

    def device_context():
        with torch.cuda.device(dev):
            pass
    steps = {
        "chop_op, 0-dim": lambda: chop_op(x, 2),
        "CudaBackend.chop, 0-dim": lambda: bk.chop(x, 2),
    }
    if hasattr(bk, "chop_expr"):
        steps.update({
            "CudaBackend.chop_expr mul, 0-dim":
                lambda: bk.chop_expr("mul", x, x, fmt_id=2),
            "CudaBackend.chop_expr sub_div into v[5]":
                lambda: bk.chop_expr("sub_div", x, x, x, fmt_id=2,
                                     out=v[5]),
            "CudaBackend.chop_expr mul, (128,), live (0, 64)":
                lambda: bk.chop_expr("mul", v, v, fmt_id=2, live=(0, 64)),
        })
        steps.update(chop_expr_steps(x, v))
    steps.update({
        "torch mul, 0-dim": lambda: x * x,
        "v > 0, then torch.where, (128,)": lambda: torch.where(v > 0, v, x),
        "library.check_cuda": lambda: library.check_cuda("chop", x),
        "torch.cuda.device context": device_context,
        "torch.cuda.current_device": torch.cuda.current_device,
        "library.count_launch": lambda: library.count_launch("chop", "x"),
    })
    out = {name: per_call_us(fn, args.reps) for name, fn in steps.items()}
    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"root": root, "card": card, "reps": args.reps,
                      "us_per_call": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
