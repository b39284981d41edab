"""LU factorization with partial pivoting, in emulated precision u_f.

Port of `repro.solvers.lu`. Strict mode (default, paper-faithful) is the
chopped right-looking LU: one rank-1 trailing update per column, products
and subtraction results rounded to the format, the single product of
each entry accumulated in the carrier. Blocked mode factors panels of
`block` columns strictly (pivoting restricted to the panel), forms the
panel's U12 row block by a strict block forward substitution and applies
the trailing update A22 -= L21 @ U12 as ONE chopped GEMM through
`backend.chop_matmul` (the qgemm kernel on the GPU). `lu_factor_auto`
picks the path by size (DESIGN.md §6.4).

The format id is a python int. Failure signalling (the paper's
`f_penalty` failure source): a zero pivot or a non-finite entry sets
`fail`, a 0-d bool tensor on the factor's device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.precision import backend_for

from .blocking import resolve_blocking


class LUFactors(NamedTuple):
    lu: torch.Tensor      # combined: strictly-lower L (unit diag), upper U
    perm: torch.Tensor    # row permutation: P A = L U, (PA)[i] = A[perm[i]]
    fail: torch.Tensor    # bool: zero pivot or non-finite (overflow) factor


def _pivot_swap(A, perm, rows, k):
    """Partial pivoting on column k: swap row k with the first row >= k of
    largest magnitude (torch.argmax returns the first maximum, as
    jnp.argmax does)."""
    mag = torch.where(rows >= k, A[:, k].abs(),
                      torch.full_like(A[:, k], -float("inf")))
    p = torch.argmax(mag)
    kp = torch.stack((rows[k], p))
    A[kp] = A[kp.flip(0)]
    perm[kp] = perm[kp.flip(0)]


def _eliminate(A, k, k1, safe, fmt_id, bk):
    """Column k's elimination, in place, over the columns [k, k1): the
    factors chop(A[i, k] / pivot) stored in column k below the diagonal,
    then the rank-1 update A[i, j] = chop(A[i, j] - chop(factor_i
    A[k, j])) of the rows i > k and the columns k < j < k1. The
    reference writes the update as `where(upd, chop(A - prod), A)` over
    the whole matrix and stores the factors afterwards; the block
    A[k+1:, k+1:k1] is exactly where `upd` holds, so each is one
    `chop_expr` into its own view (on the GPU one launch each)."""
    col = A[k + 1:, k]
    bk.chop_expr("div", col, safe, fmt_id=fmt_id, out=col)
    trail = A[k + 1:, k + 1:k1]
    bk.chop_expr("sub_mul", trail, col[:, None], A[k, k + 1:k1],
                 fmt_id=fmt_id, out=trail)


def lu_factor(A: torch.Tensor, fmt_id, backend=None) -> LUFactors:
    """Chopped right-looking LU with partial pivoting. A: (n, n) carrier."""
    bk = backend or backend_for(A.device)
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    one = torch.ones((), dtype=A.dtype, device=A.device)
    A = bk.chop(A, fmt_id).clone()
    perm = rows.clone()
    pivmin = torch.full((), float("inf"), dtype=A.dtype, device=A.device)
    for k in range(n):
        _pivot_swap(A, perm, rows, k)
        pivot = A[k, k]
        pivmin = torch.minimum(pivmin, pivot.abs())
        safe = torch.where(pivot == 0, one, pivot)
        _eliminate(A, k, n, safe, fmt_id, bk)
    fail = (pivmin == 0) | ~torch.isfinite(A).all()
    return LUFactors(A, perm, fail)


def lu_factor_blocked(A: torch.Tensor, fmt_id, block: int = 64,
                      backend=None) -> LUFactors:
    """Blocked variant: strict panel factorization + one chopped-GEMM
    trailing update per panel through `backend.chop_matmul`. Pivoting is
    restricted to the panel. Sizes that are not a block multiple are
    identity-padded internally; the factors are sliced back to (n, n)."""
    from repro_torch.kernels.trisolve.ref import identity_pad

    bk = backend or backend_for(A.device)
    n = A.shape[-1]
    n_pad = -(-n // block) * block
    dev, dt = A.device, A.dtype
    rows = torch.arange(n_pad, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    # Identity tail (shared convention with the blocked trisolve): it
    # factors trivially and never couples back into the leading block.
    A = bk.chop(identity_pad(A, n_pad), fmt_id).clone()
    perm = rows.clone()
    pivmin = torch.full((), float("inf"), dtype=dt, device=dev)
    tri = torch.tril(torch.ones((block, block), dtype=torch.bool,
                                device=dev), -1)
    for k0 in range(0, n_pad, block):
        k1 = k0 + block
        for k in range(k0, k1):
            # Strict rank-1 elimination of column k, with the update
            # restricted to the panel window [k0, k1).
            _pivot_swap(A, perm, rows, k)
            pivot = A[k, k]
            pivmin = torch.minimum(pivmin, pivot.abs())
            safe = torch.where(pivot == 0, one, pivot)
            _eliminate(A, k, k1, safe, fmt_id, bk)
        m = n_pad - k1
        if m == 0:
            continue
        Lpan = torch.where(tri, A[k0:k1, k0:k1], zero)
        A12 = A[k0:k1, k1:]
        # U12 = (I + Lpan)^{-1} A12 by strict block forward substitution.
        # The (1, block) @ (block, m) product is a plain matmul, as the
        # JAX package leaves it to XLA outside any kernel.
        U12 = torch.zeros((block, m), dtype=dt, device=dev)
        for i in range(block):
            acc = bk.chop(Lpan[i:i + 1, :] @ U12, fmt_id)
            bk.chop_expr("sub", A12[i:i + 1, :], acc, fmt_id=fmt_id,
                         out=U12[i:i + 1, :])
        # Trailing update: A22 -= L21 @ U12 as ONE chopped GEMM, the
        # subtraction stored in place.
        prod = bk.chop_matmul(A[k1:, k0:k1], U12, fmt_id)
        A22 = A[k1:, k1:]
        bk.chop_expr("sub", A22, prod, fmt_id=fmt_id, out=A22)
        A[k0:k1, k1:] = U12
    A = A[:n, :n].contiguous()
    perm = perm[:n].contiguous()
    fail = (pivmin == 0) | ~torch.isfinite(A).all()
    return LUFactors(A, perm, fail)


def lu_factor_auto(A: torch.Tensor, fmt_id, backend=None,
                   blocking=None) -> LUFactors:
    """Size-dispatched factorization: blocked panel LU at and above the
    policy threshold, the strict paper-faithful loop below."""
    pol = resolve_blocking(blocking)
    if pol.use_blocked(A.shape[-1]):
        return lu_factor_blocked(A, fmt_id, block=pol.lu_block,
                                 backend=backend)
    return lu_factor(A, fmt_id, backend=backend)
