"""Plain torch versions of the chopped matvec and GEMM kernels (ports of
`repro.kernels.qmatmul.ref.qmv_ref`, `qgemm_ref`, `qmatmul_ref` and
`qmatmul_ref_blocked`), and `pack_ref`, the plain version of the
chopped GEMM's operand pack on the tensor-core route.

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
    of the JAX package, on any float carrier. Batched: a (B, M, K) and v
    (B, K) -> (B, M), with one format id or one per row."""
    K = a.shape[-1]
    pad = padded_k(K) - K
    ac = chop(F.pad(a, (0, pad)), fmt_id)
    vc = chop(F.pad(v, (0, pad)), fmt_id)
    out = tree_sum(fma_barrier(ac * vc.unsqueeze(-2)), dim=-1)
    return chop(out, fmt_id) if chop_out else out


def qgemm_ref(a: torch.Tensor, b: torch.Tensor, fmt_id,
              chop_out: bool = True) -> torch.Tensor:
    """Chopped GEMM: K zero-padded to the LANE multiple, operands rounded,
    ONE carrier matmul, result optionally rounded. The matmul's summation
    order is the library's, as `jnp.dot`'s is XLA's (DESIGN.md §6.2), so
    this is held to a tolerance, not to bits. Batched: (B, M, K) x
    (B, K, N) -> (B, M, N), with one format id or one per row, each row's
    product the 2-D matmul of that row."""
    K = a.shape[-1]
    pad = padded_k(K) - K
    ap = chop(F.pad(a, (0, pad)), fmt_id)
    bp = chop(F.pad(b, (0, 0, 0, pad)), fmt_id)
    out = rowwise_matmul(ap, bp)
    return chop(out, fmt_id) if chop_out else out


def rowwise_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, and for (B, M, K) x (B, K, N) operands the 2-D product of
    each row, stacked, so that a row's bits do not depend on the batch it
    is solved in: torch's batched matmul takes a loop of its own below
    400 multiply-adds a row on the CPU where the 2-D matmul calls the
    BLAS, and cuBLAS's batched product picks its kernel by the batch's
    size (on the H100 its rows differ from the 2-D products, and its
    first row between batches of 1 and 8)."""
    if a.dim() != 3:
        return a @ b
    if a.shape[0] == 1:
        return (a[0] @ b[0]).unsqueeze(0)
    return torch.stack([x @ y for x, y in zip(a, b)]) if len(a) else \
        a.new_empty((0, a.shape[1], b.shape[2]))


def qmatmul_ref(a: torch.Tensor, b: torch.Tensor, fmt_id,
                chop_out: bool = True) -> torch.Tensor:
    """Chopped matmul of any float operands: cast to float32, rounded to
    the format, one float32 matmul, result optionally rounded."""
    a32 = chop(a.to(torch.float32), fmt_id)
    b32 = chop(b.to(torch.float32), fmt_id)
    out = a32 @ b32
    return chop(out, fmt_id) if chop_out else out


def qmatmul_ref_blocked(a: torch.Tensor, b: torch.Tensor, fmt_id, bk: int,
                        chop_out: bool = True) -> torch.Tensor:
    """The K-blocked accumulation order of `qmatmul_op`'s kernel: operands
    cast to float32 and rounded, a float32 partial product per block of
    `bk` along K, added into the accumulator block after block, result
    optionally rounded. K must be a multiple of `bk` (the op pads)."""
    K = a.shape[1]
    if K % bk:
        raise ValueError(f"qmatmul_ref_blocked: K={K} is not a multiple "
                         f"of bk={bk}")
    a32 = chop(a.to(torch.float32), fmt_id)
    b32 = chop(b.to(torch.float32), fmt_id)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, K, bk):
        acc = acc + a32[:, k0:k0 + bk] @ b32[k0:k0 + bk, :]
    return chop(acc, fmt_id) if chop_out else acc


def pack_ref(x: torch.Tensor, fmt_id) -> torch.Tensor:
    """The GEMM's operand pack on one float32 tensor: chop(x) cast to the
    type `ops.ROUTES` gives the format (exact for the tensor-core
    formats). float32 (tf32, and the FFMA formats) keeps the chopped bits,
    with a NaN made quiet as the pack kernel makes it, so that the
    tensor cores, which read a tf32 operand's top 19 bits, still see a
    NaN. The tests hold the premise of the tensor-core route with it;
    nothing on the main path calls it."""
    from .ops import ROUTES     # ops imports this module
    dtype = ROUTES[int(fmt_id)][0]
    c = chop(x, fmt_id)
    if dtype == torch.float32:
        return torch.where(torch.isnan(c), torch.full_like(c, float("nan")),
                           c)
    return c.to(dtype)
