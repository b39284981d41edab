"""Wrapper of the CUDA chop kernel (`csrc/chop.cu`), the port of
`repro/kernels/chop/chop.py::chop_pallas`.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version (`ref.chop_ref`). Format parameters are runtime arguments, so one
build serves every format id (DESIGN.md §3.4).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import library
from repro_torch.precision.chop import fmt_params

from .ref import chop_ref


def chop_op(x: torch.Tensor, fmt_id) -> torch.Tensor:
    """Round `x` (float32, any shape) to the format of the runtime id."""
    if x.device.type == "cpu":
        return chop_ref(x, fmt_id)
    library.check_cuda("chop", x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    t, emin, xmax_bits, sat = fmt_params(fmt_id, torch.float32)
    library.call("repro_chop_f32", "chop", x.device, x.data_ptr(),
                 out.data_ptr(), x.numel(), t, emin, xmax_bits, int(sat),
                 library.stream_of(x))
    library.count_launch("chop", "elementwise")
    return out
