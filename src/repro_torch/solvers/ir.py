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
the host's cost of each operator.

A batch is one program, as the JAX package's vmap runs it
(`_gmres_ir_batch_jit`): the refinement loop (`_refine`, which CG-IR in
`cg.py` shares: only the inner solver differs) takes the B rows of a
bucket, each under its own action (every role a column of per-row format
ids, `precision.rows`). The live rows advance together and every launch
covers every row; a row whose LU failed is FAILED and done from the
start; a row that is done keeps x, its counts and its status bit for
bit. The loop reads all rows' stopping flags from the device once per
outer iteration. `gmres_ir` is that program at B = 1.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.precision import (RowFormats, backend_for, resolve_device,
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
    """||v||_inf of each row."""
    return v.abs().amax(-1)


def _refine(A, b, x_true, actions, cfg, bk, inner, init: str = "zero"):
    """The outer refinement loop of GMRES-IR and CG-IR over a batch, A
    (B, n, n), b and x_true (B, n), actions (B, 4): factor A in u_f,
    then per iteration the residual in u_r, the correction from
    `inner(A_g, lu, r, u_g, active)` (an object with `z` (B, n), and
    `iters` and `fail` numpy arrays of the rows'; `active` marks the
    live rows) and the update in u, until one of the stopping criteria
    holds for every row. Returns (ferr, nbe, n_outer, n_inner, status,
    res_norm), each (B,); the three counts int32 on the host."""
    dt, dev = A.dtype, A.device
    B = A.shape[0]
    acts = np.asarray(actions, dtype=np.int32).reshape(B, 4)
    uf, u, ug, ur = (RowFormats(acts[:, k], dev) for k in range(4))

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
    znorm_prev = torch.full((B,), float("inf"), dtype=dt, device=dev)
    i = np.zeros(B, dtype=np.int64)
    n_inner = np.zeros(B, dtype=np.int64)
    status = np.full(B, MAXITER, dtype=np.int64)
    lu_fail = lu.fail.cpu().numpy()
    done = lu_fail.copy()
    live_dev = None if not done.any() else torch.as_tensor(~done,
                                                           device=dev)
    while not done.all():
        live = ~done
        r = bk.chop_expr("sub", b_r, chop_mv(A_r, x, ur, backend=bk),
                         fmt_id=ur)
        step = inner(A_g, lu, r, ug, live)
        z = bk.chop(step.z, u)
        x_new = bk.chop_expr("add", x, z, fmt_id=u)
        znorm = _inf_norm(z)
        xnorm = _inf_norm(x_new)
        flags = torch.stack((znorm <= conv_tol * xnorm,
                             znorm >= cfg.stag_tol * znorm_prev,
                             torch.isfinite(x_new).all(-1))).cpu().numpy()
        converged = flags[0]
        stagnated = (i > 0) & flags[1]
        hit_max = i + 1 >= cfg.i_max
        failed = step.fail | ~flags[2]
        status = np.where(live, np.select(
            [failed, converged, stagnated, hit_max],
            [FAILED, CONVERGED, STAGNATED, MAXITER], status), status)
        # A row that failed keeps its x; a done row keeps everything.
        keep = live & ~failed
        done_next = done | (live & (converged | stagnated | hit_max
                                    | failed))
        if live_dev is None:
            znorm_prev = znorm
        else:
            znorm_prev = torch.where(live_dev, znorm, znorm_prev)
        if keep.all():
            x = x_new
        else:
            x = torch.where(torch.as_tensor(keep, device=dev)[:, None],
                            x_new, x)
        if (done_next != done).any() and not done_next.all():
            live_dev = torch.as_tensor(~done_next, device=dev)
        i[live] += 1
        n_inner[live] += step.iters[live]
        done = done_next
    status[lu_fail] = FAILED

    # Final metrics in the carrier, Eq. 17, with the pinned residual
    # schedule (see solvers/carrier.py).
    res_norm = _inf_norm(carrier_residual(A, b, x))
    normA = tree_sum(A.abs(), dim=-1).amax(-1)
    ferr = _inf_norm(x - x_true) / _inf_norm(x_true)
    nbe = res_norm / (normA * _inf_norm(x) + _inf_norm(b))
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    ferr = torch.where(torch.isfinite(ferr), ferr, inf)
    nbe = torch.where(torch.isfinite(nbe), nbe, inf)
    ints = torch.tensor(np.stack((i, n_inner, status)), dtype=torch.int32)
    return ferr, nbe, ints[0], ints[1], ints[2], res_norm


def _refine_batch(A, b, x_true, actions, cfg, bk, inner):
    """`_refine` over a batch, or over one system (A (n, n): the batch of
    one, each field returned 0-dim)."""
    single = A.dim() == 2
    if single:
        A, b, x_true = A[None], b[None], x_true[None]
    out = _refine(A, b, x_true, np.asarray(actions), cfg, bk, inner,
                  getattr(cfg, "init", "zero"))
    return tuple(f[0] for f in out) if single else out


def _gmres_ir_impl(A, b, x_true, actions, cfg: IRConfig, bk) -> SolveStats:
    """GMRES-IR over one system or a batch."""
    def inner(A_g, lu, r, ug, active):
        return gmres_precond(A_g, lu.lu, lu.perm, r, ug, m_max=cfg.m_max,
                             tol=cfg.tol_inner, backend=bk,
                             blocking=cfg.blocking, active=active)
    return SolveStats(*_refine_batch(A, b, x_true, actions, cfg, bk, inner))


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
    kernels do not take. The batched program at B = 1.
    """
    bk, (A, b, x_true) = _prepare((A, b, x_true), device, carrier_dtype)
    return _gmres_ir_impl(A, b, x_true, action, cfg, bk)


@torch.inference_mode()
def gmres_ir_batch(A, b, x_true, actions, cfg: IRConfig = IRConfig(), *,
                   device=None, carrier_dtype=None) -> SolveStats:
    """Batched GMRES-IR: A (B, n, n), b/x_true (B, n), actions (B, 4),
    one program over the rows (module docstring); each field (B,)."""
    bk, (A, b, x_true) = _prepare((A, b, x_true), device, carrier_dtype)
    return _gmres_ir_impl(A, b, x_true, actions, cfg, bk)


@torch.inference_mode()
def _gmres_ir_batch_entry(A, b, x_true, actions, *, cfg, backend, device):
    """`gmres_ir_batch` over arrays already on `device` in the carrier."""
    return _gmres_ir_impl(A, b, x_true, actions, cfg, backend)


def batch_lowerable(entry, cfg, device=None, carrier_dtype=None):
    """A batched entry point (`entry(A, b, x_true, actions, *, cfg,
    backend, device)`) in `core.executor.LowerableCall` form: `prepare`
    moves the arrays to the device in one copy each and casts them to
    the backend's carrier, as the plain entry point does, and the call is
    keyed by value by (entry, cfg, backend, device). `prepare` takes
    another device of the same type as `device=` (a mesh shard's,
    `LowerableCall.on`)."""
    from repro_torch.core.executor import LowerableCall
    dev = resolve_device(device)
    bk = backend_for(dev, carrier_dtype)

    def prepare(A, b, x_true, actions, device=dev):
        return (*bk.coerce(*(torch.as_tensor(
            t if torch.is_tensor(t) else np.asarray(t), device=device)
            for t in (A, b, x_true))), actions)

    return LowerableCall(entry, (("cfg", cfg), ("backend", bk),
                                 ("device", dev)), prepare)


def gmres_ir_batch_lowerable(cfg: IRConfig = IRConfig(), device=None,
                             carrier_dtype=None):
    """`gmres_ir_batch` as a `core.executor.LowerableCall` (DESIGN.md
    §12): two tasks over equal (cfg, device, carrier) give equal calls,
    so they share one dispatcher and its warm cells."""
    return batch_lowerable(_gmres_ir_batch_entry, cfg, device,
                           carrier_dtype)
