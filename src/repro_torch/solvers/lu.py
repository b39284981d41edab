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

Every function takes one system, A (n, n), or a batch of them, A
(B, n, n), factored in one program: each row picks its own pivot and
swaps its own rows, and every rounding is one launch over all rows, each
row in its own format. The format is one id, or one per row
(`precision.rows`).

Failure signalling (the paper's `f_penalty` failure source): a zero pivot
or a non-finite entry sets `fail`, a bool tensor on the factor's device,
0-dim for one system and (B,) for a batch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.precision import backend_for, row_formats

from .blocking import resolve_blocking


class LUFactors(NamedTuple):
    lu: torch.Tensor      # combined: strictly-lower L (unit diag), upper U
    perm: torch.Tensor    # row permutation: P A = L U, (PA)[i] = A[perm[i]]
    fail: torch.Tensor    # bool: zero pivot or non-finite (overflow) factor


def _pivot_swap(A, perm, rows, base, k):
    """Partial pivoting on column k of every row of the batch: swap row k
    with the first row >= k of largest magnitude (torch.argmax returns
    the first maximum, as jnp.argmax does). The swap indexes the rows of
    the batch's stacked matrices, A (B n, n) and perm (B n,), with the
    linear row indices base + (k, p) (`_row_base`)."""
    col = A[:, :, k]
    mag = torch.where(rows >= k, col.abs(), torch.full_like(col,
                                                            -float("inf")))
    p = torch.argmax(mag, dim=1)
    kp = torch.stack((rows[k].expand_as(p), p), dim=1)
    if base is not None:
        kp = kp + base
    pk = kp.flip(1)
    A2, perm2 = A.view(-1, A.shape[-1]), perm.view(-1)
    A2[kp] = A2[pk]
    perm2[kp] = perm2[pk]


def _row_base(B, n, device):
    """The first linear row of each batch row's matrix in the stacked
    (B n, n) view (None for one row: no offset)."""
    return None if B == 1 else torch.arange(B, device=device)[:, None] * n


def _eliminate(A, k, k1, safe, fmt_id, bk):
    """Column k's elimination, in place, over the columns [k, k1): the
    factors chop(A[i, k] / pivot) stored in column k below the diagonal,
    then the rank-1 update A[i, j] = chop(A[i, j] - chop(factor_i
    A[k, j])) of the rows i > k and the columns k < j < k1. The
    reference writes the update as `where(upd, chop(A - prod), A)` over
    the whole matrix and stores the factors afterwards; the block
    A[k+1:, k+1:k1] is exactly where `upd` holds, so each is one
    `chop_expr` into its own view (on the GPU one launch each, over every
    row of the batch)."""
    col = A[:, k + 1:, k]
    bk.chop_expr("div", col, safe[:, None], fmt_id=fmt_id, out=col)
    trail = A[:, k + 1:, k + 1:k1]
    bk.chop_expr("sub_mul", trail, col[:, :, None], A[:, k, None, k + 1:k1],
                 fmt_id=fmt_id, out=trail)


def _batched(A, fmt_id):
    """(A as a batch, its per-row formats, whether A was one system)."""
    single = A.dim() == 2
    A = A[None] if single else A
    return A, row_formats(fmt_id, A.shape[0], A.device), single


def _result(A, perm, fail, single) -> LUFactors:
    if single:
        return LUFactors(A[0], perm[0], fail[0])
    return LUFactors(A, perm, fail)


def lu_factor(A: torch.Tensor, fmt_id, backend=None) -> LUFactors:
    """Chopped right-looking LU with partial pivoting. A: (n, n) or
    (B, n, n) carrier."""
    bk = backend or backend_for(A.device)
    A, fmt, single = _batched(A, fmt_id)
    B, n = A.shape[0], A.shape[-1]
    rows = torch.arange(n, device=A.device)
    base = _row_base(B, n, A.device)
    one = torch.ones((), dtype=A.dtype, device=A.device)
    A = bk.chop(A, fmt).clone()
    perm = rows.repeat(B, 1)
    pivmin = torch.full((B,), float("inf"), dtype=A.dtype, device=A.device)
    for k in range(n):
        _pivot_swap(A, perm, rows, base, k)
        pivot = A[:, k, k]
        pivmin = torch.minimum(pivmin, pivot.abs())
        safe = torch.where(pivot == 0, one, pivot)
        _eliminate(A, k, n, safe, fmt, bk)
    fail = (pivmin == 0) | ~torch.isfinite(A).flatten(1).all(1)
    return _result(A, perm, fail, single)


def lu_factor_blocked(A: torch.Tensor, fmt_id, block: int = 64,
                      backend=None) -> LUFactors:
    """Blocked variant: strict panel factorization + one chopped-GEMM
    trailing update per panel through `backend.chop_matmul`. Pivoting is
    restricted to the panel. Sizes that are not a block multiple are
    identity-padded internally; the factors are sliced back to (n, n)."""
    from repro_torch.kernels.qmatmul.ref import rowwise_matmul
    from repro_torch.kernels.trisolve.ref import identity_pad

    bk = backend or backend_for(A.device)
    A, fmt, single = _batched(A, fmt_id)
    B, n = A.shape[0], A.shape[-1]
    n_pad = -(-n // block) * block
    dev, dt = A.device, A.dtype
    rows = torch.arange(n_pad, device=dev)
    base = _row_base(B, n_pad, dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    # Identity tail (shared convention with the blocked trisolve): it
    # factors trivially and never couples back into the leading block.
    A = bk.chop(identity_pad(A, n_pad), fmt).clone()
    perm = rows.repeat(B, 1)
    pivmin = torch.full((B,), float("inf"), dtype=dt, device=dev)
    tri = torch.tril(torch.ones((block, block), dtype=torch.bool,
                                device=dev), -1)
    for k0 in range(0, n_pad, block):
        k1 = k0 + block
        for k in range(k0, k1):
            # Strict rank-1 elimination of column k, with the update
            # restricted to the panel window [k0, k1).
            _pivot_swap(A, perm, rows, base, k)
            pivot = A[:, k, k]
            pivmin = torch.minimum(pivmin, pivot.abs())
            safe = torch.where(pivot == 0, one, pivot)
            _eliminate(A, k, k1, safe, fmt, bk)
        m = n_pad - k1
        if m == 0:
            continue
        Lpan = torch.where(tri, A[:, k0:k1, k0:k1], zero)
        A12 = A[:, k0:k1, k1:]
        # U12 = (I + Lpan)^{-1} A12 by strict block forward substitution.
        # The (1, block) @ (block, m) product is a plain matmul, as the
        # JAX package leaves it to XLA outside any kernel: each row's own
        # 2-D product (`rowwise_matmul`: a batched matmul's bits depend
        # on the batch's size).
        U12 = torch.zeros((B, block, m), dtype=dt, device=dev)
        for i in range(block):
            acc = bk.chop(rowwise_matmul(Lpan[:, i:i + 1, :], U12), fmt)
            bk.chop_expr("sub", A12[:, i, :], acc[:, 0], fmt_id=fmt,
                         out=U12[:, i, :])
        # Trailing update: A22 -= L21 @ U12 as ONE chopped GEMM over the
        # batch, the subtraction stored in place.
        prod = bk.chop_matmul(A[:, k1:, k0:k1], U12, fmt)
        A22 = A[:, k1:, k1:]
        bk.chop_expr("sub", A22, prod, fmt_id=fmt, out=A22)
        A[:, k0:k1, k1:] = U12
    A = A[:, :n, :n].contiguous()
    perm = perm[:, :n].contiguous()
    fail = (pivmin == 0) | ~torch.isfinite(A).flatten(1).all(1)
    return _result(A, perm, fail, single)


def lu_factor_auto(A: torch.Tensor, fmt_id, backend=None,
                   blocking=None) -> LUFactors:
    """Size-dispatched factorization: blocked panel LU at and above the
    policy threshold, the strict paper-faithful loop below."""
    pol = resolve_blocking(blocking)
    if pol.use_blocked(A.shape[-1]):
        return lu_factor_blocked(A, fmt_id, block=pol.lu_block,
                                 backend=backend)
    return lu_factor(A, fmt_id, backend=backend)
