"""Chopped triangular solves (forward/backward substitution).

Port of `repro.solvers.triangular`. Strict path (below the blocking
threshold), per row: products rounded to the format, row dot summed in
the carrier by the fixed `tree_sum`, one rounding on the subtraction and
one on the division. The division rounds twice by design: the numerator
is a stored value and so is the quotient (DESIGN.md §3.5). Each row is
two `backend.chop_expr` calls (on the GPU two launches of the chop
kernel): the products with the unsolved positions stored as +0 (a live
range), and the subtraction (and division) stored straight into the
solution's slot.

Blocked path (at and above `blocking.min_n`): the whole solve goes to
`backend.chop_trisolve` — the trisolve kernel on the GPU, its plain
version on the CPU (kernels/trisolve; DESIGN.md §6.4).

Every solve takes one right-hand side, b (n,) with LU (n, n), or a batch,
b (B, n) with LU (B, n, n), each row in its own format (`precision.rows`):
the strict paths round every row's step in one launch, the blocked ones
are one trisolve launch over the batch.
"""
from __future__ import annotations

import torch

from repro_torch.precision import backend_for, row_formats, tree_sum

from .blocking import resolve_blocking


def _batched(LU, b, fmt_id):
    """(LU, b) as a batch, their per-row formats, and whether b was one
    right-hand side."""
    single = b.dim() == 1
    if single:
        LU, b = LU[None], b[None]
    return LU, b, row_formats(fmt_id, b.shape[0], b.device), single


def solve_unit_lower(LU: torch.Tensor, b: torch.Tensor, fmt_id,
                     backend=None, blocking=None) -> torch.Tensor:
    """Solve L y = b where L is unit-lower (strict lower triangle of LU)."""
    bk = backend or backend_for(LU.device)
    n = LU.shape[-1]
    pol = resolve_blocking(blocking)
    LU, b, fmt, single = _batched(LU, b, fmt_id)
    if pol.use_blocked(n):
        y = bk.chop_trisolve(LU, b, fmt, lower=True,
                             block=pol.trisolve_block)
        return y[0] if single else y
    b = bk.chop(b, fmt)
    y = torch.zeros_like(b)
    for i in range(n):
        prods = bk.chop_expr("mul", LU[:, i], y, fmt_id=fmt, live=(0, i))
        bk.chop_expr("sub", b[:, i], tree_sum(prods), fmt_id=fmt,
                     out=y[:, i])
    return y[0] if single else y


def solve_upper(LU: torch.Tensor, y: torch.Tensor, fmt_id,
                backend=None, blocking=None) -> torch.Tensor:
    """Solve U x = y where U is the upper triangle (incl. diagonal) of LU."""
    bk = backend or backend_for(LU.device)
    n = LU.shape[-1]
    pol = resolve_blocking(blocking)
    LU, y, fmt, single = _batched(LU, y, fmt_id)
    if pol.use_blocked(n):
        x = bk.chop_trisolve(LU, y, fmt, lower=False,
                             block=pol.trisolve_block)
        return x[0] if single else x
    one = torch.ones((), dtype=y.dtype, device=y.device)
    y = bk.chop(y, fmt)
    x = torch.zeros_like(y)
    for i in range(n - 1, -1, -1):
        row = LU[:, i]
        prods = bk.chop_expr("mul", row, x, fmt_id=fmt, live=(i + 1, n))
        s = tree_sum(prods)
        diag = row[:, i]
        safe = torch.where(diag == 0, one, diag)
        # Double rounding by design: stored numerator, then stored
        # quotient (see module docstring).
        bk.chop_expr("sub_div", y[:, i], s, safe, fmt_id=fmt, out=x[:, i])
    return x[0] if single else x


def permute(v: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """P v: v[perm] of one vector, v[k, perm[k]] of each row of a batch."""
    return v[perm] if v.dim() == 1 else torch.gather(v, 1, perm)


def lu_solve(LU: torch.Tensor, perm: torch.Tensor, b: torch.Tensor,
             fmt_id, backend=None, blocking=None) -> torch.Tensor:
    """Solve A x = b given chopped LU factors: x = U \\ (L \\ (P b))."""
    bk = backend or backend_for(LU.device)
    y = solve_unit_lower(LU, permute(b, perm), fmt_id, backend=bk,
                         blocking=blocking)
    return solve_upper(LU, y, fmt_id, backend=bk, blocking=blocking)
