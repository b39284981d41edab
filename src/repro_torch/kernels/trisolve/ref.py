"""Plain torch version of the blocked trisolve kernel (port of
`repro.kernels.trisolve.ref`).

`_trisolve_core` is the blocked substitution semantics of the JAX
package's `_trisolve_core`, op for op (DESIGN.md §6.4). For block row i:

  * off-diagonal tiles are chopped matvecs: products rounded to the
    format, per-tile row sums by the fixed `tree_sum`, added *unrounded*
    to a carrier accumulator in increasing tile order;
  * one rounding on the off-diagonal subtraction `t = chop(b_i - acc)`;
  * the diagonal block is solved by the strict row loop: products
    rounded, masked carrier `tree_sum`, one rounding on the subtraction
    and (upper) a second on the division.

The CUDA kernel (`csrc/trisolve.cu`) runs the same sequence of roundings
and sums, so the two agree bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.precision.chop import chop, tree_sum


def _trisolve_core(Lu: torch.Tensor, b2d: torch.Tensor, chop_fn, *,
                   lower: bool, block: int) -> torch.Tensor:
    """Blocked forward/backward substitution on the combined LU matrix.

    Lu: (B, n, n) carrier, n % block == 0. Lower solves read the strictly
    lower triangle with an implicit unit diagonal; upper solves read the
    upper triangle including the diagonal. b2d: (B, n), one right-hand
    side a row of the batch. chop_fn: the elementwise round-to-format
    closure (per row when the rows' formats differ). Returns y: (B, n).
    """
    n = Lu.shape[-1]
    nb = n // block
    B = b2d.shape[0]
    dev, dt = Lu.device, Lu.dtype
    Luc = chop_fn(Lu)
    bc = chop_fn(b2d)
    idx = torch.arange(block, device=dev)
    rr = idx[:, None]
    cc = idx[None, :]
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    y = torch.zeros_like(bc)
    for bi in range(nb):
        i = bi if lower else nb - 1 - bi
        r0 = i * block
        acc = torch.zeros((B, block), dtype=dt, device=dev)
        for j in (range(0, i) if lower else range(i + 1, nb)):
            tile = Luc[:, r0:r0 + block, j * block:(j + 1) * block]
            yj = y[:, None, j * block:(j + 1) * block]
            acc = acc + tree_sum(chop_fn(tile * yj), dim=-1)
        t = chop_fn(bc[:, r0:r0 + block] - acc)

        diag = Luc[:, r0:r0 + block, r0:r0 + block]
        # Mask to the triangle the solve reads (the unit diagonal of a
        # lower solve is implicit and never multiplied).
        tri = torch.where(rr > cc if lower else rr <= cc, diag, zero)
        yb = torch.zeros((B, block), dtype=dt, device=dev)
        for rloc in range(block):
            r = rloc if lower else block - 1 - rloc
            prods = chop_fn(tri[:, r, :] * yb)
            mask = (idx < r) if lower else (idx > r)
            s = tree_sum(torch.where(mask, prods, zero), dim=-1)
            val = chop_fn(t[:, r] - s)
            if not lower:
                d = tri[:, r, r]
                val = chop_fn(val / torch.where(d == 0, one, d))
            yb[:, r] = val
        y[:, r0:r0 + block] = yb
    return y


def identity_pad(M: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Zero-extend a square matrix (or each of a batch of them) to n_pad
    with ones on the padded diagonal: the solution-preserving padding
    shared by the blocked trisolve and the blocked LU."""
    n = M.shape[-1]
    if n_pad == n:
        return M
    Mp = F.pad(M, (0, n_pad - n, 0, n_pad - n))
    tail = torch.arange(n, n_pad, device=M.device)
    Mp[..., tail, tail] = 1
    return Mp


def pad_unit(Lu: torch.Tensor, b: torch.Tensor, n_pad: int):
    """Identity-extend (Lu, b) to n_pad: padded diagonal 1, padded rhs 0.
    The padded rows solve 1*y = 0 and never couple back."""
    n = Lu.shape[-1]
    if n_pad == n:
        return Lu, b
    return identity_pad(Lu, n_pad), F.pad(b, (0, n_pad - n))


def trisolve_ref(Lu: torch.Tensor, b: torch.Tensor, fmt_id, *,
                 lower: bool, block: int = 128) -> torch.Tensor:
    """Blocked triangular solve on the combined LU matrix, any float
    carrier. b: (n,); returns (n,). Batched: Lu (B, n, n) and b (B, n)
    -> (B, n), with one format id or one per row."""
    n = Lu.shape[-1]
    n_pad = -(-n // block) * block
    Lp, bp = pad_unit(Lu, b, n_pad)
    if Lp.dim() == 2:
        Lp, bp = Lp[None], bp.reshape(1, n_pad)
    out = _trisolve_core(Lp, bp, lambda x: chop(x, fmt_id), lower=lower,
                         block=block)
    return out[..., :n] if b.dim() == 2 else out[0, :n]
