"""Plain torch versions of the chopped matvec and GEMM kernels (ports of
`repro.kernels.qmatmul.ref.qmv_ref` / `qgemm_ref`).

K is zero-padded to a multiple of LANE = 128 before the reduction. That
padding is part of the reduction contract, not a TPU layout choice: the
fixed `tree_sum` over Kp is a different tree from one over K
(DESIGN.md §6.2), and the CUDA qmv kernel reduces over the same Kp.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.precision.chop import chop, fma_barrier, tree_sum

LANE = 128


def padded_k(K: int) -> int:
    return -(-K // LANE) * LANE


def qmv_ref(a: torch.Tensor, v: torch.Tensor, fmt_id,
            chop_out: bool = True) -> torch.Tensor:
    """Fused chopped matvec: operands rounded to the format, products
    summed per row by the fixed halving tree over the lane-padded K in
    the carrier, result optionally rounded. Bit-exact against `qmv_ref`
    of the JAX package, on any float carrier."""
    K = a.shape[-1]
    pad = padded_k(K) - K
    ac = chop(F.pad(a, (0, pad)), fmt_id)
    vc = chop(F.pad(v, (0, pad)), fmt_id)
    out = tree_sum(fma_barrier(ac * vc[None, :]), dim=1)
    return chop(out, fmt_id) if chop_out else out


def qgemm_ref(a: torch.Tensor, b: torch.Tensor, fmt_id,
              chop_out: bool = True) -> torch.Tensor:
    """Chopped GEMM: K zero-padded to the LANE multiple, operands rounded,
    ONE carrier matmul, result optionally rounded. The matmul's summation
    order is the library's, as `jnp.dot`'s is XLA's (DESIGN.md §6.2), so
    this is held to a tolerance, not to bits."""
    K = a.shape[-1]
    pad = padded_k(K) - K
    ap = chop(F.pad(a, (0, pad)), fmt_id)
    bp = chop(F.pad(b, (0, 0, 0, pad)), fmt_id)
    out = ap @ bp
    return chop(out, fmt_id) if chop_out else out
