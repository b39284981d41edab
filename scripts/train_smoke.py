#!/usr/bin/env python3
"""chip_smoke's phase 15, LM training on the card, alone.

    python3 scripts/train_smoke.py [a] [b] [c]

On a machine with an NVIDIA GPU, from the root of a checkout. It prints
the card's name and power limit, builds the kernels (one nvcc process a
source), sets the matmul flags chip_smoke sets (no TF32, no reduced
precision reductions) and runs the parts of phase 15 named (all three
by default): (a) granite-3-2b at full width and depth, the gradient
against the plain attention's, `adamw_update` and one layer's attention
backward timed, three train steps and a fourth under torch.profiler;
(b) the smoke config's 40 float32 steps, card against CPU, and one step
under an emulated e4m3 policy; (c) the launcher killed after its step-6
checkpoint, resumed, against an uninterrupted run. Each part prints its
lines as chip_smoke does and then its summary as a JSON object; a
failed check ends the run with exit code 1.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(parts):
    if not torch.cuda.is_available():
        print("train_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    from repro_torch.kernels import library
    dev = torch.device("cuda", 0)
    runs = {"a": lambda: cs.run_train_full(dev),
            "b": lambda: cs.run_train_smoke(dev),
            "c": cs.run_train_launch}
    try:
        cs.say(cs.card_line())
        library.load()
        for part in parts or sorted(runs):
            cs.say(json.dumps({part: runs[part]()}, default=float))
    except cs.Failed as e:
        print(f"train_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
