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
`triangular.lu_solve` (the trisolve kernel on the blocked path).

`pcg` takes one system or a batch, each row in its own format, and runs
the batch as the JAX package's vmapped `while_loop` runs it: the live
rows advance together, every launch covers every row, a row that is
done keeps its carry (z, r, p, rho), and the loop reads its stopping
flags from the device once per CG iteration for the whole batch, stacked
into one copy.

Entry points run on CUDA unless the caller passes `device="cpu"`, under
`torch.inference_mode`. `cg_ir_batch` is one call of that program over
the bucket's rows (`ir._refine`); `cg_ir` is its batch of one.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.precision import backend_for, row_formats, tree_sum

from .blocking import DEFAULT_BLOCKING, BlockingPolicy, resolve_blocking
from .carrier import carrier_norm
from .ir import (CONVERGED, FAILED, MAXITER, STAGNATED, _prepare,
                 _refine_batch, batch_lowerable)
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
    iters: object              # inner iterations (numpy (B,) batched)
    fail: object               # breakdown (non-SPD curvature / non-finite)


def _dot(a, b, fmt_id, bk):
    """Dot product with format-rounded products, carrier accumulation in
    the fixed `tree_sum` order (DESIGN.md §7.3), the sum rounded."""
    return bk.chop(tree_sum(bk.chop_expr("mul", a, b, fmt_id=fmt_id)),
                   fmt_id)


def pcg(A_g: torch.Tensor, LU: torch.Tensor, perm: torch.Tensor,
        r: torch.Tensor, fmt_g, *, m_max: int, tol: float, backend=None,
        blocking=None, active=None) -> PCGResult:
    """LU-preconditioned CG on A z = r, entirely in precision u_g.

    A_g: the system matrix pre-chopped to u_g; LU/perm: chopped factors
    of A in u_f, used as the (fixed) preconditioner. One system (r (n,):
    `iters` an int, `fail` a bool) or a batch (r (B, n): numpy arrays of
    the rows'); `active` (numpy bool (B,)) marks the rows to solve, the
    others are done from the start."""
    bk = backend or backend_for(r.device)
    pol = resolve_blocking(blocking)
    A_g, LU, r = bk.coerce(A_g, LU, r)
    single = r.dim() == 1
    if single:
        A_g, LU, perm, r = A_g[None], LU[None], perm[None], r[None]
    fmt = row_formats(fmt_g, r.shape[0], r.device)
    res = _pcg(A_g, LU, perm, r, fmt, m_max, tol, bk, pol, active)
    if single:
        return PCGResult(res.z[0], int(res.iters[0]), bool(res.fail[0]))
    return res


def _pcg(A_g, LU, perm, r, fmt, m_max, tol, bk, pol, active):
    B = r.shape[0]
    dev = r.device
    one = torch.ones((), dtype=r.dtype, device=dev)
    chop_expr = functools.partial(bk.chop_expr, fmt_id=fmt)

    rin = bk.chop(r, fmt)
    beta0 = carrier_norm(rin)
    z = torch.zeros_like(rin)
    ok_dev = torch.isfinite(beta0) & (beta0 > 0)
    ok = ok_dev.cpu().numpy()
    j = np.zeros(B, dtype=np.int64)
    fail = ~ok
    if active is None or active.all():
        done, live_dev = ~ok, ok_dev
    else:
        done = ~(ok & active)
        live_dev = ok_dev & torch.as_tensor(active, device=dev)
    if done.all():
        return PCGResult(z, j, fail)
    p = lu_solve(LU, perm, rin, fmt, backend=bk, blocking=pol)
    rho = _dot(rin, p, fmt, bk)
    stop = tol * beta0
    jj = 0
    while not done.all() and jj < m_max:
        live = ~done
        mask = None if live.all() else live_dev
        q = bk.chop_mv(A_g, p, fmt)
        pq = _dot(p, q, fmt, bk)
        # Non-positive curvature: A (or the chopped recurrence) stopped
        # behaving SPD — a genuine CG breakdown, not mere stagnation.
        breakdown = (pq <= 0) | ~torch.isfinite(pq)
        alpha = chop_expr("div", rho, torch.where(breakdown, one, pq))
        z_new = chop_expr("add_mul", z, alpha[:, None], p)
        rin_new = chop_expr("sub_mul", rin, alpha[:, None], q)
        res = carrier_norm(rin_new)
        y = lu_solve(LU, perm, rin_new, fmt, backend=bk, blocking=pol)
        rho_new = _dot(rin_new, y, fmt, bk)
        beta = chop_expr("div", rho_new, torch.where(rho == 0, one, rho))
        p_new = chop_expr("add_mul", y, beta[:, None], p)
        finite = torch.isfinite(z_new).all(-1) & torch.isfinite(res) \
            & torch.isfinite(rho_new)
        flags_dev = torch.stack((breakdown | ~finite, res <= stop))
        fail_now, converged = flags_dev.cpu().numpy()
        # A row that failed keeps its z; a done row keeps its whole carry.
        keep = live & ~fail_now
        if keep.all():
            z = z_new
        else:
            z = torch.where((live_dev & ~flags_dev[0])[:, None], z_new, z)
        if mask is None:
            rin, p, rho = rin_new, p_new, rho_new
        else:
            rin = torch.where(mask[:, None], rin_new, rin)
            p = torch.where(mask[:, None], p_new, p)
            rho = torch.where(mask, rho_new, rho)
        fail = np.where(live, fail_now, fail)
        j[live] += 1
        done_next = done | (live & (fail_now | converged))
        if (done_next != done).any() and not done_next.all():
            live_dev = live_dev & ~(flags_dev[0] | flags_dev[1])
        done = done_next
        jj += 1
    bad_dev = ~torch.isfinite(z).all(-1)
    if fail.any():
        bad_dev = bad_dev | torch.as_tensor(fail, device=dev)
    bad = bad_dev.cpu().numpy()
    if bad.any():
        z = torch.where(bad_dev[:, None], torch.zeros_like(z), z)
    return PCGResult(z, j, bad)


def _cg_ir_impl(A, b, x_true, actions, cfg: CGConfig, bk) -> CGStats:
    """CG-IR over one system or a batch (`ir._refine`)."""
    def inner(A_g, lu, r, ug, active):
        return pcg(A_g, lu.lu, lu.perm, r, ug, m_max=cfg.m_max,
                   tol=cfg.tol_inner, backend=bk, blocking=cfg.blocking,
                   active=active)
    return CGStats(*_refine_batch(A, b, x_true, actions, cfg, bk, inner))


@torch.inference_mode()
def cg_ir(A, b, x_true, action, cfg: CGConfig = CGConfig(), *,
          device=None, carrier_dtype=None) -> CGStats:
    """Solve A x = b with CG-IR under precision action (u_f, u, u_g, u_r).

    A: (n, n) (SPD), b and x_true: (n,), as numpy arrays or tensors;
    action: four format ids. Runs on CUDA (the kernels, on the float32
    carrier or, with `carrier_dtype="float64"`, the float64 one) unless
    `device="cpu"` (the plain versions, carrier = the inputs' dtype or
    `carrier_dtype`). Raises when CUDA is asked for and absent, and for a
    carrier the CUDA kernels do not take. The batched program at B = 1.
    """
    bk, (A, b, x_true) = _prepare((A, b, x_true), device, carrier_dtype)
    return _cg_ir_impl(A, b, x_true, action, cfg, bk)


@torch.inference_mode()
def cg_ir_batch(A, b, x_true, actions, cfg: CGConfig = CGConfig(), *,
                device=None, carrier_dtype=None) -> CGStats:
    """Batched CG-IR: A (B, n, n), b/x_true (B, n), actions (B, 4), one
    program over the rows (module docstring)."""
    bk, (A, b, x_true) = _prepare((A, b, x_true), device, carrier_dtype)
    return _cg_ir_impl(A, b, x_true, actions, cfg, bk)


@torch.inference_mode()
def _cg_ir_batch_entry(A, b, x_true, actions, *, cfg, backend, device):
    """`cg_ir_batch` over arrays already on `device` in the carrier."""
    return _cg_ir_impl(A, b, x_true, actions, cfg, backend)


def cg_ir_batch_lowerable(cfg: CGConfig = CGConfig(), device=None,
                          carrier_dtype=None):
    """`cg_ir_batch` as a `core.executor.LowerableCall`, keyed by (cfg,
    device, carrier) as `ir.gmres_ir_batch_lowerable` (DESIGN.md §12)."""
    return batch_lowerable(_cg_ir_batch_entry, cfg, device, carrier_dtype)


# Status codes shared with ir.py / core.task.
__all__ = ["CGConfig", "CGStats", "PCGResult", "pcg", "cg_ir",
           "cg_ir_batch", "cg_ir_batch_lowerable", "CONVERGED",
           "STAGNATED", "MAXITER", "FAILED"]
