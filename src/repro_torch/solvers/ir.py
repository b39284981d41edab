"""GMRES-based iterative refinement (paper Alg. 2) with per-step precisions.

Port of `repro.solvers.ir`. Action a = (u_f, u, u_g, u_r), four format ids:
  u_f : LU factorization (+ its use as the GMRES preconditioner's factors)
  u   : solution update x_{i+1} = x_i + z_i
  u_g : GMRES working precision (operator, MGS, Givens)
  u_r : residual computation r_i = b - A x_i

Stopping criteria (paper Eqs. 14-16):
  converged : ||z_i||_inf / ||x_{i+1}||_inf <= max(tau, u_work(u))
  stagnated : ||z_i||_inf / ||z_{i-1}||_inf >= stag_tol
  max-iter  : i >= i_max
plus the failure path (LU overflow / zero pivot / non-finite GMRES).
x0 = 0 by default (the paper's iteration accounting), init="lu" for the
literal Alg. 2 variant.

Entry points run on CUDA unless the caller passes `device="cpu"`; the
device picks the backend (`precision.backend_for`). They run under
`torch.inference_mode` (a solve records no gradients), which also trims
the host's cost of each operator. The refinement loop (`_refine`, which
CG-IR in `cg.py` shares: only the inner solver differs) reads its
stopping flags from the device once per outer iteration.
`gmres_ir_batch` is a loop over rows, each row the single solve: per row
it gives what the JAX package's vmapped program gives, since a vmapped
`while_loop` freezes each row's carry once that row is done.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.precision import (backend_for, resolve_device,
                                   rounding_unit, tree_sum)

from .blocking import DEFAULT_BLOCKING, BlockingPolicy
from .carrier import carrier_residual
from .gmres import chop_mv, gmres_precond
from .lu import lu_factor_auto
from .triangular import lu_solve


@dataclasses.dataclass(frozen=True)
class IRConfig:
    tau: float = 1e-6          # convergence tolerance (benchmark parameter)
    i_max: int = 10            # max outer (refinement) iterations
    m_max: int = 40            # max inner GMRES iterations
    tol_inner: float = 1e-4    # GMRES relative residual tolerance
    stag_tol: float = 0.9      # Eq. 15 stagnation threshold
    init: str = "zero"         # "zero" (paper accounting) | "lu" (Alg.2 l.2)
    # Blocked LU/trisolve engagement (DESIGN.md §6.4).
    blocking: BlockingPolicy = DEFAULT_BLOCKING


# Solver outcome status codes.
CONVERGED, STAGNATED, MAXITER, FAILED = 0, 1, 2, 3


class SolveStats(NamedTuple):
    ferr: torch.Tensor         # normwise relative forward error (Eq. 17)
    nbe: torch.Tensor          # normwise relative backward error (Eq. 17)
    n_outer: torch.Tensor      # refinement iterations performed
    n_gmres: torch.Tensor      # total inner GMRES iterations
    status: torch.Tensor       # CONVERGED/STAGNATED/MAXITER/FAILED
    res_norm: torch.Tensor     # final ||b - A x||_inf


def _inf_norm(v):
    return v.abs().max()


def _refine(A, b, x_true, action, cfg, bk, inner, init: str = "zero"):
    """The outer refinement loop of GMRES-IR and CG-IR: factor A in u_f,
    then per iteration the residual in u_r, the correction from
    `inner(A_g, lu, r, u_g)` (an object with `z`, `iters` and `fail`),
    and the update in u, until one of the stopping criteria holds.
    Returns (ferr, nbe, n_outer, n_inner, status, res_norm)."""
    dt, dev = A.dtype, A.device
    uf, u, ug, ur = (int(f) for f in action)

    lu = lu_factor_auto(A, uf, backend=bk, blocking=cfg.blocking)
    A_g = bk.chop(A, ug)
    A_r = bk.chop(A, ur)
    b_r = bk.chop(b, ur)

    if init == "lu":
        x0 = lu_solve(lu.lu, lu.perm, b, uf, backend=bk,
                      blocking=cfg.blocking)
        x = torch.where(torch.isfinite(x0), x0, torch.zeros_like(x0))
    else:
        x = torch.zeros_like(b)

    conv_tol = torch.maximum(torch.tensor(cfg.tau, dtype=dt, device=dev),
                             rounding_unit(u, dt, dev))
    znorm_prev = torch.full((), float("inf"), dtype=dt, device=dev)
    i, n_inner, status = 0, 0, MAXITER
    lu_fail = bool(lu.fail)
    done = lu_fail
    while not done:
        r = bk.chop_expr("sub", b_r, chop_mv(A_r, x, ur, backend=bk),
                         fmt_id=ur)
        step = inner(A_g, lu, r, ug)
        z = bk.chop(step.z, u)
        x_new = bk.chop_expr("add", x, z, fmt_id=u)
        znorm = _inf_norm(z)
        xnorm = _inf_norm(x_new)
        flags = torch.stack((znorm <= conv_tol * xnorm,
                             znorm >= cfg.stag_tol * znorm_prev,
                             torch.isfinite(x_new).all())).tolist()
        converged = flags[0]
        stagnated = i > 0 and flags[1]
        hit_max = i + 1 >= cfg.i_max
        failed = step.fail or not flags[2]
        if failed:
            status = FAILED
        elif converged:
            status = CONVERGED
        elif stagnated:
            status = STAGNATED
        elif hit_max:
            status = MAXITER
        done = converged or stagnated or hit_max or failed
        if not failed:
            x = x_new
        znorm_prev = znorm
        i += 1
        n_inner += step.iters
    if lu_fail:
        status = FAILED

    # Final metrics in the carrier, Eq. 17, with the pinned residual
    # schedule (see solvers/carrier.py).
    res_norm = _inf_norm(carrier_residual(A, b, x))
    normA = tree_sum(A.abs(), dim=1).max()
    ferr = _inf_norm(x - x_true) / _inf_norm(x_true)
    nbe = res_norm / (normA * _inf_norm(x) + _inf_norm(b))
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    ferr = torch.where(torch.isfinite(ferr), ferr, inf)
    nbe = torch.where(torch.isfinite(nbe), nbe, inf)
    ints = torch.tensor([i, n_inner, status], dtype=torch.int32)
    return ferr, nbe, ints[0], ints[1], ints[2], res_norm


def _gmres_ir_impl(A, b, x_true, action, cfg: IRConfig, bk) -> SolveStats:
    def inner(A_g, lu, r, ug):
        return gmres_precond(A_g, lu.lu, lu.perm, r, ug, m_max=cfg.m_max,
                             tol=cfg.tol_inner, backend=bk,
                             blocking=cfg.blocking)
    return SolveStats(*_refine(A, b, x_true, action, cfg, bk, inner,
                               cfg.init))


def _prepare(tensors, device, carrier_dtype):
    dev = resolve_device(device)
    bk = backend_for(dev, carrier_dtype)
    out = tuple(torch.as_tensor(np.asarray(t) if not torch.is_tensor(t)
                                else t, device=dev) for t in tensors)
    return bk, bk.coerce(*out)


@torch.inference_mode()
def gmres_ir(A, b, x_true, action, cfg: IRConfig = IRConfig(), *,
             device=None, carrier_dtype=None) -> SolveStats:
    """Solve A x = b with GMRES-IR under precision action (u_f, u, u_g, u_r).

    A: (n, n), b and x_true: (n,), as numpy arrays or tensors; action:
    four format ids. Runs on CUDA (the kernels, on the float32 carrier or,
    with `carrier_dtype="float64"`, the float64 one) unless `device="cpu"`
    (the plain versions, carrier = the inputs' dtype or `carrier_dtype`).
    Raises when CUDA is asked for and absent, and for a carrier the CUDA
    kernels do not take.
    """
    bk, (A, b, x_true) = _prepare((A, b, x_true), device, carrier_dtype)
    return _gmres_ir_impl(A, b, x_true, np.asarray(action).tolist(), cfg, bk)


@torch.inference_mode()
def gmres_ir_batch(A, b, x_true, actions, cfg: IRConfig = IRConfig(), *,
                   device=None, carrier_dtype=None) -> SolveStats:
    """Batched GMRES-IR over rows: A (B, n, n), b/x_true (B, n), actions
    (B, 4). Each row is the single solve; the stats are stacked."""
    bk, (A, b, x_true) = _prepare((A, b, x_true), device, carrier_dtype)
    acts = np.asarray(actions).tolist()
    rows = [_gmres_ir_impl(A[k], b[k], x_true[k], acts[k], cfg, bk)
            for k in range(A.shape[0])]
    return SolveStats(*(torch.stack(f) for f in zip(*rows)))
