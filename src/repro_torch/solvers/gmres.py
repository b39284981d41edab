"""Left-preconditioned MGS-GMRES in emulated precision u_g.

Port of `repro.solvers.gmres`. Solves M^{-1} A z = M^{-1} r with M = LU
(the chopped factors from lu.py), entirely in precision u_g: the operator
(fused chopped matvec + two triangular solves), modified Gram-Schmidt and
the Givens least-squares recurrence, with op-level rounding to the
format; accumulations in the carrier (DESIGN.md §3.5).

The rounding ops dispatch through the device's backend: `chop_mv` is the
qmv kernel on the GPU, and every rounding, alone or with the one or two
operations that produce its value (`chop_expr`: `chop(w v)`,
`chop(w - chop(h v))` stored in place, the back-substitution's
`chop(chop(g - s) / d)` stored in y's slot), one launch of the chop
kernel. The JAX `while_loop` becomes a python loop that reads its `done`
flag from the device once per iteration.

Givens step: `cs*h_i + sn*h_{i+1}` and `sqrt(h_j^2 + h_{j+1}^2)` are
plain multiplies and adds here, never fused. XLA may contract them into
FMAs; any bit difference between the packages that traces to these
lines is that unpinned contraction.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.precision import backend_for, tree_sum

from .blocking import resolve_blocking
from .carrier import carrier_norm
from .triangular import solve_unit_lower, solve_upper


class GMRESResult(NamedTuple):
    z: torch.Tensor        # solution update
    iters: int             # inner iterations performed
    res_rel: torch.Tensor  # final relative (preconditioned) residual estimate
    fail: bool             # non-finite breakdown


def chop_mv(A: torch.Tensor, v: torch.Tensor, fmt_id,
            backend=None) -> torch.Tensor:
    """Fused chopped matvec: operands rounded to the format, accumulation
    in the carrier, result rounded. Operands are coerced to the backend's
    carrier dtype."""
    bk = backend or backend_for(A.device)
    A, v = bk.coerce(A, v)
    return bk.chop_mv(A, v, fmt_id)


def _precond(LU, perm, v, fmt_id, backend, blocking=None):
    # M^{-1} v: the two triangular solves take the blocked
    # `chop_trisolve` path above the size threshold (DESIGN.md §6.4).
    y = solve_unit_lower(LU, v[perm], fmt_id, backend=backend,
                         blocking=blocking)
    return solve_upper(LU, y, fmt_id, backend=backend, blocking=blocking)


def gmres_precond(A_g: torch.Tensor, LU: torch.Tensor, perm: torch.Tensor,
                  r: torch.Tensor, fmt_g, *, m_max: int, tol: float,
                  backend=None, blocking=None) -> GMRESResult:
    """A_g: the system matrix pre-chopped to u_g. r: outer residual."""
    bk = backend or backend_for(r.device)
    pol = resolve_blocking(blocking)
    A_g, LU, r = bk.coerce(A_g, LU, r)
    n = r.shape[-1]
    dt, dev = r.dtype, r.device
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)

    def chop(x):
        return bk.chop(x, fmt_g)

    chop_expr = functools.partial(bk.chop_expr, fmt_id=fmt_g)

    def apply_op(v):
        return _precond(LU, perm, bk.chop_mv(A_g, v, fmt_g), fmt_g, bk, pol)

    rhat = _precond(LU, perm, chop(r), fmt_g, bk, pol)
    beta = carrier_norm(rhat)
    ok0 = bool(torch.isfinite(beta) & (beta > 0))
    beta_safe = beta if ok0 else one
    V = torch.zeros((m_max + 1, n), dtype=dt, device=dev)
    if ok0:
        V[0] = chop_expr("div", rhat, beta_safe)
    R = torch.zeros((m_max + 1, m_max), dtype=dt, device=dev)
    cs = torch.zeros((m_max,), dtype=dt, device=dev)
    sn = torch.zeros((m_max,), dtype=dt, device=dev)
    g = torch.zeros((m_max + 1,), dtype=dt, device=dev)
    g[0] = beta
    tiny = torch.tensor(1e-300 if dt == torch.float64 else 1e-30,
                        dtype=dt, device=dev)
    res_prev = torch.full((), float("inf"), dtype=dt, device=dev)
    j = 0
    done = not ok0
    while not done and j < m_max:
        w = apply_op(V[j])
        h = torch.zeros((m_max + 1,), dtype=dt, device=dev)
        for i in range(j + 1):
            vi = V[i]
            hij = chop(tree_sum(chop_expr("mul", w, vi)))
            chop_expr("sub_mul", w, hij, vi, out=w)
            h[i] = hij
        hn = carrier_norm(w)
        happy = hn <= tiny
        hn_safe = torch.where(happy, one, hn)
        V[j + 1] = torch.where(happy, torch.zeros_like(w),
                               chop_expr("div", w, hn_safe))
        h[j + 1] = hn
        for i in range(j):
            hi, hi1 = h[i].clone(), h[i + 1].clone()
            h[i] = chop(cs[i] * hi + sn[i] * hi1)
            h[i + 1] = chop(-sn[i] * hi + cs[i] * hi1)
        hj, hj1 = h[j].clone(), h[j + 1].clone()
        denom = torch.sqrt(hj * hj + hj1 * hj1)
        dsafe = torch.where(denom == 0, one, denom)
        c, s = hj / dsafe, hj1 / dsafe
        cs[j] = c
        sn[j] = s
        h[j] = chop(denom)
        h[j + 1] = zero
        R[:, j] = h
        gj = g[j].clone()
        g[j] = chop_expr("mul", c, gj)
        g[j + 1] = chop_expr("mul", -s, gj)

        res = g[j + 1].abs()
        fin = torch.isfinite(res) & torch.isfinite(h).all()
        # Stall cut: a useless preconditioner makes the residual plateau;
        # give up once per-iteration reduction falls under 5% past a
        # warmup.
        stalled = (j >= 4) & (res > 0.95 * res_prev)
        done = bool(happy | (res <= tol * beta) | stalled | ~fin)
        res_prev = res
        j += 1

    # Back-substitute R y = g on the leading j x j block (rows >= j of y
    # stay zero, as the reference's masked loop leaves them).
    y = torch.zeros((m_max,), dtype=dt, device=dev)
    for row in range(j - 1, -1, -1):
        rrow = R[row]
        prods = chop_expr("mul", rrow, y, live=(row + 1, m_max))
        ssum = tree_sum(prods)
        diag = rrow[row]
        dsafe = torch.where(diag == 0, one, diag)
        chop_expr("sub_div", g[row], ssum, dsafe, out=y[row])
    z = chop(tree_sum(chop_expr("mul", V[:m_max], y[:, None]), dim=0))

    res_rel = g[j].abs() / beta_safe
    fail = (not ok0) or not bool(torch.isfinite(z).all())
    if fail:
        z = torch.zeros_like(z)
    return GMRESResult(z, j, res_rel, fail)
