"""Preconditioned-CG iterative refinement (CG-IR) with per-step precisions.

Port of `repro.solvers.cg`: the outer refinement loop of `ir.gmres_ir`
(`ir._refine`, shared), with the correction equation A z = r solved by
LU-preconditioned conjugate gradients in the working precision u_g
instead of GMRES. Intended for SPD systems (`data.matrices.sparse_spd`);
a breakdown of the CG recurrence (non-positive curvature p^T A p,
non-finite iterates) takes the explicit failure path, as an overflowed
LU does in GMRES-IR.

Action a = (u_f, u, u_g, u_r), four format ids with GMRES-IR's roles:
  u_f : LU factorization (used as the CG preconditioner M = LU)
  u   : solution update x_{i+1} = x_i + z_i
  u_g : CG working precision (matvec, preconditioner solves, dots)
  u_r : residual computation r_i = b - A x_i

Every rounding dispatches through the device's backend, as in
`gmres.py`: `q = A_g p` is `chop_mv` (the qmv kernel on the GPU); a dot
is `chop(tree_sum(chop(a b)))`, its products one `chop_expr("mul")`;
`alpha` and `beta` are `chop_expr("div")`; `r - chop(alpha q)` is
"sub_mul", and `z + chop(alpha p)` and `y + chop(beta p)` are
"add_mul", each one launch of the chop kernel on the GPU with the
operations that produce it. The preconditioner solves are
`triangular.lu_solve` (the trisolve kernel on the blocked path). The
JAX `while_loop` becomes a python loop that reads its stopping flags
from the device once per CG iteration, stacked into one `.tolist()`.

Entry points run on CUDA unless the caller passes `device="cpu"`, under
`torch.inference_mode`. `cg_ir_batch` is a loop over rows, each row the
single solve: per row it gives what the JAX package's vmapped program
gives, since a vmapped `while_loop` freezes each row's carry once that
row is done.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.precision import backend_for, tree_sum

from .blocking import DEFAULT_BLOCKING, BlockingPolicy, resolve_blocking
from .carrier import carrier_norm
from .ir import CONVERGED, FAILED, MAXITER, STAGNATED, _prepare, _refine
from .triangular import lu_solve


@dataclasses.dataclass(frozen=True)
class CGConfig:
    tau: float = 1e-6          # convergence tolerance (benchmark parameter)
    i_max: int = 10            # max outer (refinement) iterations
    m_max: int = 50            # max inner CG iterations
    tol_inner: float = 1e-4    # CG relative residual tolerance
    stag_tol: float = 0.9      # stagnation threshold on ||z_i||/||z_{i-1}||
    # Blocked LU/trisolve engagement (DESIGN.md §6.4).
    blocking: BlockingPolicy = DEFAULT_BLOCKING


class CGStats(NamedTuple):
    ferr: torch.Tensor         # normwise relative forward error (Eq. 17)
    nbe: torch.Tensor          # normwise relative backward error (Eq. 17)
    n_outer: torch.Tensor      # refinement iterations performed
    n_cg: torch.Tensor         # total inner CG iterations
    status: torch.Tensor       # CONVERGED/STAGNATED/MAXITER/FAILED
    res_norm: torch.Tensor     # final ||b - A x||_inf


class PCGResult(NamedTuple):
    z: torch.Tensor            # solution update
    iters: int                 # inner iterations performed
    fail: bool                 # breakdown (non-SPD curvature / non-finite)


def _dot(a, b, fmt_id, bk):
    """Dot product with format-rounded products, carrier accumulation in
    the fixed `tree_sum` order (DESIGN.md §7.3), the sum rounded."""
    return bk.chop(tree_sum(bk.chop_expr("mul", a, b, fmt_id=fmt_id)),
                   fmt_id)


def pcg(A_g: torch.Tensor, LU: torch.Tensor, perm: torch.Tensor,
        r: torch.Tensor, fmt_g, *, m_max: int, tol: float, backend=None,
        blocking=None) -> PCGResult:
    """LU-preconditioned CG on A z = r, entirely in precision u_g.

    A_g: the system matrix pre-chopped to u_g; LU/perm: chopped factors
    of A in u_f, used as the (fixed) preconditioner."""
    bk = backend or backend_for(r.device)
    pol = resolve_blocking(blocking)
    A_g, LU, r = bk.coerce(A_g, LU, r)
    one = torch.ones((), dtype=r.dtype, device=r.device)
    chop_expr = functools.partial(bk.chop_expr, fmt_id=fmt_g)

    rin = bk.chop(r, fmt_g)
    beta0 = carrier_norm(rin)
    z = torch.zeros_like(rin)
    if not bool(torch.isfinite(beta0) & (beta0 > 0)):
        return PCGResult(z, 0, True)
    p = lu_solve(LU, perm, rin, fmt_g, backend=bk, blocking=pol)
    rho = _dot(rin, p, fmt_g, bk)
    stop = tol * beta0
    j, fail, done = 0, False, False
    while not done and j < m_max:
        q = bk.chop_mv(A_g, p, fmt_g)
        pq = _dot(p, q, fmt_g, bk)
        # Non-positive curvature: A (or the chopped recurrence) stopped
        # behaving SPD — a genuine CG breakdown, not mere stagnation.
        breakdown = (pq <= 0) | ~torch.isfinite(pq)
        alpha = chop_expr("div", rho, torch.where(breakdown, one, pq))
        z_new = chop_expr("add_mul", z, alpha, p)
        rin = chop_expr("sub_mul", rin, alpha, q)
        res = carrier_norm(rin)
        y = lu_solve(LU, perm, rin, fmt_g, backend=bk, blocking=pol)
        rho_new = _dot(rin, y, fmt_g, bk)
        beta = chop_expr("div", rho_new, torch.where(rho == 0, one, rho))
        p = chop_expr("add_mul", y, beta, p)
        rho = rho_new
        finite = torch.isfinite(z_new).all() & torch.isfinite(res) \
            & torch.isfinite(rho_new)
        fail, converged = torch.stack((breakdown | ~finite,
                                       res <= stop)).tolist()
        if not fail:
            z = z_new
        done = fail or converged
        j += 1
    if fail or not bool(torch.isfinite(z).all()):
        return PCGResult(torch.zeros_like(z), j, True)
    return PCGResult(z, j, False)


def _cg_ir_impl(A, b, x_true, action, cfg: CGConfig, bk) -> CGStats:
    def inner(A_g, lu, r, ug):
        return pcg(A_g, lu.lu, lu.perm, r, ug, m_max=cfg.m_max,
                   tol=cfg.tol_inner, backend=bk, blocking=cfg.blocking)
    return CGStats(*_refine(A, b, x_true, action, cfg, bk, inner))


@torch.inference_mode()
def cg_ir(A, b, x_true, action, cfg: CGConfig = CGConfig(), *,
          device=None, carrier_dtype=None) -> CGStats:
    """Solve A x = b with CG-IR under precision action (u_f, u, u_g, u_r).

    A: (n, n) (SPD), b and x_true: (n,), as numpy arrays or tensors;
    action: four format ids. Runs on CUDA (the kernels, on the float32
    carrier or, with `carrier_dtype="float64"`, the float64 one) unless
    `device="cpu"` (the plain versions, carrier = the inputs' dtype or
    `carrier_dtype`). Raises when CUDA is asked for and absent, and for a
    carrier the CUDA kernels do not take.
    """
    bk, (A, b, x_true) = _prepare((A, b, x_true), device, carrier_dtype)
    return _cg_ir_impl(A, b, x_true, np.asarray(action).tolist(), cfg, bk)


@torch.inference_mode()
def cg_ir_batch(A, b, x_true, actions, cfg: CGConfig = CGConfig(), *,
                device=None, carrier_dtype=None) -> CGStats:
    """Batched CG-IR over rows: A (B, n, n), b/x_true (B, n), actions
    (B, 4). Each row is the single solve; the stats are stacked."""
    bk, (A, b, x_true) = _prepare((A, b, x_true), device, carrier_dtype)
    acts = np.asarray(actions).tolist()
    rows = [_cg_ir_impl(A[k], b[k], x_true[k], acts[k], cfg, bk)
            for k in range(A.shape[0])]
    return CGStats(*(torch.stack(f) for f in zip(*rows)))


# Status codes shared with ir.py / core.task.
__all__ = ["CGConfig", "CGStats", "PCGResult", "pcg", "cg_ir",
           "cg_ir_batch", "CONVERGED", "STAGNATED", "MAXITER", "FAILED"]
