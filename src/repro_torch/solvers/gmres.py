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
kernel.

`gmres_precond` takes one system or a batch (A_g, LU (B, n, n), perm, r
(B, n)), each row in its own format (`precision.rows`), and runs the
batch as the JAX package's vmapped `while_loop` runs it: the rows that
are live share the iteration j and advance together, every launch covers
every row, and a row that is done (or that the caller marks inactive)
keeps V, R, cs, sn, g and its residual from then on. The loop reads its
stopping flags from the device once per Arnoldi step, for the whole
batch. The back-substitution runs each row on its own leading j x j
block (rows >= j of y stay +0, as in the reference's masked loop).

Givens step: `cs*h_i + sn*h_{i+1}` and `sqrt(h_j^2 + h_{j+1}^2)` are
plain multiplies and adds here, never fused. XLA may contract them into
FMAs; any bit difference between the packages that traces to these
lines is that unpinned contraction.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.precision import backend_for, row_formats, tree_sum

from .blocking import resolve_blocking
from .carrier import carrier_norm
from .triangular import permute, solve_unit_lower, solve_upper


class GMRESResult(NamedTuple):
    z: torch.Tensor        # solution update
    iters: object          # inner iterations performed (numpy (B,) batched)
    res_rel: torch.Tensor  # final relative (preconditioned) residual estimate
    fail: object           # non-finite breakdown (numpy (B,) batched)


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
    y = solve_unit_lower(LU, permute(v, perm), fmt_id, backend=backend,
                         blocking=blocking)
    return solve_upper(LU, y, fmt_id, backend=backend, blocking=blocking)


def _rotate(c, s, hi, hi1):
    """The Givens rotation of (hi, hi1) before its rounding: (c hi + s
    hi1, -s hi + c hi1), each product rounded to the carrier, then the
    sum. The reference computes the same expressions unrounded and
    leaves them to XLA, which on the CPU may contract a product into the
    add as an FMA (ROADMAP.md Queue 3); the port never contracts."""
    return c * hi + s * hi1, -s * hi + c * hi1


def _sum_squares(a, b):
    """a^2 + b^2 of the Givens norm, each square rounded, then the sum
    (the reference's `hj * hj + hj1 * hj1`, which XLA may contract)."""
    return a * a + b * b


def _masked(mask):
    """A store into the carry that keeps the rows outside `mask` (a (B,)
    device bool, None when every row is live)."""
    def store(dst, val):
        if mask is None:
            dst.copy_(val)
        else:
            m = mask.view(-1, *(1,) * (val.dim() - 1))
            dst.copy_(torch.where(m, val, dst))
    return store


def gmres_precond(A_g: torch.Tensor, LU: torch.Tensor, perm: torch.Tensor,
                  r: torch.Tensor, fmt_g, *, m_max: int, tol: float,
                  backend=None, blocking=None, active=None) -> GMRESResult:
    """A_g: the system matrix pre-chopped to u_g. r: outer residual.

    One system (r (n,): `iters` an int, `fail` a bool) or a batch (r
    (B, n): `iters` and `fail` numpy arrays of the rows'). `active`
    (numpy bool (B,)) marks the rows to solve; the others are done from
    the start and their z is meaningless."""
    bk = backend or backend_for(r.device)
    pol = resolve_blocking(blocking)
    A_g, LU, r = bk.coerce(A_g, LU, r)
    single = r.dim() == 1
    if single:
        A_g, LU, perm, r = A_g[None], LU[None], perm[None], r[None]
    fmt = row_formats(fmt_g, r.shape[0], r.device)
    res = _gmres(A_g, LU, perm, r, fmt, m_max, tol, bk, pol, active)
    if single:
        return GMRESResult(res.z[0], int(res.iters[0]), res.res_rel[0],
                           bool(res.fail[0]))
    return res


def _gmres(A_g, LU, perm, r, fmt, m_max, tol, bk, pol, active):
    B, n = r.shape
    dt, dev = r.dtype, r.device
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)

    def chop(x):
        return bk.chop(x, fmt)

    chop_expr = functools.partial(bk.chop_expr, fmt_id=fmt)

    def apply_op(v):
        return _precond(LU, perm, bk.chop_mv(A_g, v, fmt), fmt, bk, pol)

    rhat = _precond(LU, perm, chop(r), fmt, bk, pol)
    beta = carrier_norm(rhat)
    ok0_dev = torch.isfinite(beta) & (beta > 0)
    ok0 = ok0_dev.cpu().numpy()
    beta_safe = beta if ok0.all() else torch.where(ok0_dev, beta, one)
    V = torch.zeros((B, m_max + 1, n), dtype=dt, device=dev)
    if ok0.any():
        _masked(None if ok0.all() else ok0_dev)(
            V[:, 0], chop_expr("div", rhat, beta_safe[:, None]))
    R = torch.zeros((B, m_max + 1, m_max), dtype=dt, device=dev)
    cs = torch.zeros((B, m_max), dtype=dt, device=dev)
    sn = torch.zeros((B, m_max), dtype=dt, device=dev)
    g = torch.zeros((B, m_max + 1), dtype=dt, device=dev)
    g[:, 0] = beta
    tiny = torch.tensor(1e-300 if dt == torch.float64 else 1e-30,
                        dtype=dt, device=dev)
    res_prev = torch.full((B,), float("inf"), dtype=dt, device=dev)
    if active is None or active.all():
        done, live_dev = ~ok0, ok0_dev
    else:
        done = ~(ok0 & active)
        live_dev = ok0_dev & torch.as_tensor(active, device=dev)
    j = np.zeros(B, dtype=np.int64)
    jj = 0                      # the live rows' j
    while not done.all() and jj < m_max:
        live = ~done
        store = _masked(None if live.all() else live_dev)
        w = apply_op(V[:, jj])
        h = torch.zeros((B, m_max + 1), dtype=dt, device=dev)
        for i in range(jj + 1):
            vi = V[:, i]
            hij = chop(tree_sum(chop_expr("mul", w, vi)))
            chop_expr("sub_mul", w, hij[:, None], vi, out=w)
            h[:, i] = hij
        hn = carrier_norm(w)
        happy = hn <= tiny
        hn_safe = torch.where(happy, one, hn)
        store(V[:, jj + 1], torch.where(happy[:, None], torch.zeros_like(w),
                                        chop_expr("div", w, hn_safe[:, None])))
        h[:, jj + 1] = hn
        for i in range(jj):
            r0, r1 = _rotate(cs[:, i], sn[:, i], h[:, i].clone(),
                             h[:, i + 1].clone())
            h[:, i] = chop(r0)
            h[:, i + 1] = chop(r1)
        hj, hj1 = h[:, jj].clone(), h[:, jj + 1].clone()
        denom = torch.sqrt(_sum_squares(hj, hj1))
        dsafe = torch.where(denom == 0, one, denom)
        c, s = hj / dsafe, hj1 / dsafe
        store(cs[:, jj], c)
        store(sn[:, jj], s)
        h[:, jj] = chop(denom)
        h[:, jj + 1] = zero
        store(R[:, :, jj], h)
        gj = g[:, jj].clone()
        store(g[:, jj], chop_expr("mul", c, gj))
        g1 = chop_expr("mul", -s, gj)
        store(g[:, jj + 1], g1)

        res = g1.abs()
        fin = torch.isfinite(res) & torch.isfinite(h).all(-1)
        # Stall cut: a useless preconditioner makes the residual plateau;
        # give up once per-iteration reduction falls under 5% past a
        # warmup.
        stalled = (jj >= 4) & (res > 0.95 * res_prev)
        stop_dev = happy | (res <= tol * beta) | stalled | ~fin
        stop = stop_dev.cpu().numpy()
        if live.all():
            res_prev = res
        else:
            res_prev = torch.where(live_dev, res, res_prev)
        j[live] += 1
        done_next = done | (live & stop)
        if (done_next != done).any() and not done_next.all():
            live_dev = live_dev & ~stop_dev
        done = done_next
        jj += 1

    # Back-substitute R y = g on each row's leading j x j block (rows >= j
    # of y stay +0, as the reference's masked loop leaves them).
    y = torch.zeros((B, m_max), dtype=dt, device=dev)
    j_dev = None
    for row in range(int(j.max(initial=0)) - 1, -1, -1):
        rrow = R[:, row]
        prods = chop_expr("mul", rrow, y, live=(row + 1, m_max))
        ssum = tree_sum(prods)
        diag = rrow[:, row]
        dsafe = torch.where(diag == 0, one, diag)
        chop_expr("sub_div", g[:, row], ssum, dsafe, out=y[:, row])
        if (j <= row).any():
            if j_dev is None:
                j_dev = torch.as_tensor(j, device=dev)
            y[:, row] = torch.where(j_dev > row, y[:, row], zero)
    z = chop(tree_sum(chop_expr("mul", V[:, :m_max], y[:, :, None]), dim=1))

    if (j == j[0]).all():
        g_j = g[:, int(j[0])]
    else:
        if j_dev is None:
            j_dev = torch.as_tensor(j, device=dev)
        g_j = g.gather(1, j_dev[:, None])[:, 0]
    res_rel = g_j.abs() / beta_safe
    fail_dev = ~torch.isfinite(z).all(-1)
    if not ok0.all():
        fail_dev = fail_dev | ~ok0_dev
    fail = fail_dev.cpu().numpy()
    if fail.any():
        z = torch.where(fail_dev[:, None], torch.zeros_like(z), z)
    return GMRESResult(z, j, res_rel, fail)
