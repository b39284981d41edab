"""Learning-rate schedules (port of `repro.train.schedule`)."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, peak_lr: float, warmup: int, total: int,
                       floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to `peak_lr`, then a cosine down to
    `floor_frac * peak_lr` at `total`: a float32 0-dim tensor on the
    device of `step` (a tensor or a Python number), in the reference's
    float32 operation order."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = peak_lr * (floor_frac + (1 - floor_frac)
                     * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
