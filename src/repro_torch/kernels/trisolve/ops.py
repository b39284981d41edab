"""Wrapper of the CUDA blocked-trisolve kernel (`csrc/trisolve.cu`), the
port of `repro/kernels/trisolve/trisolve.py::trisolve_pallas`.

One thread block runs the whole blocked substitution in one launch. The
identity padding of `ref.pad_unit` happens inside the kernel (entries
past n read as the identity, the rhs as 0), so no padded copy of the
factor is made. A CUDA tensor launches the kernel or raises; a CPU
tensor runs the plain version. Unlike the TPU kernel (`MAX_N`), the
factor streams from device memory, so every n is taken.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import library
from repro_torch.precision.chop import fmt_params

from .ref import trisolve_ref

# Shared memory the kernel asks for: the solution vector (n_pad), the
# diagonal block (block^2), the off-diagonal rhs (block) and one tree
# buffer of `block` floats per warp (8 warps).
SMEM_LIMIT = 232448


def smem_bytes(n: int, block: int) -> int:
    n_pad = -(-n // block) * block
    return 4 * (n_pad + block * block + block + 8 * block)


def trisolve_op(Lu: torch.Tensor, b: torch.Tensor, fmt_id, *,
                lower: bool, block: int = 128) -> torch.Tensor:
    """Blocked triangular solve on the combined (n, n) LU factor; b: (n,)."""
    if Lu.device.type == "cpu":
        return trisolve_ref(Lu, b, fmt_id, lower=lower, block=block)
    library.check_cuda("trisolve", Lu, b)
    n = Lu.shape[-1]
    if Lu.dim() != 2 or Lu.shape[0] != n or b.shape != (n,):
        raise ValueError(f"trisolve: shapes {tuple(Lu.shape)}, "
                         f"{tuple(b.shape)}")
    if block < 1 or smem_bytes(n, block) > SMEM_LIMIT:
        raise ValueError(f"trisolve: n={n}, block={block} needs "
                         f"{smem_bytes(n, block)} B of shared memory")
    y = torch.empty_like(b)
    if n == 0:
        return y
    t, emin, xmax_bits, sat = fmt_params(fmt_id, torch.float32)
    rc = library.load().repro_trisolve_f32(
        Lu.data_ptr(), b.data_ptr(), y.data_ptr(), n, block, int(lower),
        t, emin, xmax_bits, int(sat), library.stream_of(Lu))
    library.check(rc, "trisolve")
    library.count_launch("trisolve")
    return y
