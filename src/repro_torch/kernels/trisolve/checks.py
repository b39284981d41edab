"""How the blocked trisolve is checked, in one place for `chip_smoke.py`
and the tests: `trisolve_lanes`, a plain model of the "shfl" kernel's
order, and `special_system`, factors and right-hand sides at the edges.
Nothing on the main path calls it.

`trisolve_lanes` reorganises the solve as the kernel does: the tiles of a
block row summed ahead of its chain, each tile row by the lane tree
(`kernels.lanes.lane_tree_sum`, lane 0's value, which a worker warp
keeps); the accumulator folded in tile order from 0 (acc = ((0 + T_first)
+ ...)); then the diagonal block's chain row by row, each row's masked
products (+0 where masked, and added) summed by the lane tree and read
on the lane that owns the row (r % 32), which rounds the subtraction
(and the division). The tests hold it bit for bit against `trisolve_ref`
of both packages, and plant faults through `tree` and `fold`.
"""
from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from repro_torch.kernels.lanes import lane_tree_sum
from repro_torch.precision import FORMAT_LIST, chop

from .ref import pad_unit


def lane_sum(p: torch.Tensor, live: torch.Tensor | None,
             lane: int) -> torch.Tensor:
    """A row's sum as the kernel's warp forms it on `lane` (`live`, the
    mask of the products that are not a masked +0, plays no part: the
    kernel adds those +0 like any other)."""
    return lane_tree_sum(p, lane=lane)


def fold_from_zero(tiles: list[torch.Tensor], width: int) -> torch.Tensor:
    """The carrier accumulator over a block row's tile sums, in tile
    order, starting from +0."""
    acc = torch.zeros(width, dtype=torch.float32)
    for t in tiles:
        acc = acc + t
    return acc


def trisolve_lanes(Lu: torch.Tensor, b: torch.Tensor, fmt_id, *,
                   lower: bool, block: int = 128,
                   tree: Callable = lane_sum,
                   fold: Callable = fold_from_zero) -> torch.Tensor:
    """The blocked solve of float32 (n, n) `Lu` and (n,) `b` on the CPU,
    in the order of the "shfl" kernel; `trisolve_ref` bit for bit."""
    n = Lu.shape[-1]
    n_pad = -(-n // block) * block
    Lp, bp = pad_unit(Lu, b, n_pad)
    Luc, bc = chop(Lp, fmt_id), chop(bp, fmt_id)
    nb, W = n_pad // block, block
    idx = torch.arange(W)
    keep = idx[:, None] > idx[None, :] if lower else \
        idx[:, None] <= idx[None, :]
    zero = torch.zeros(())
    y = torch.zeros(n_pad)
    for s in range(nb):
        i = s if lower else nb - 1 - s
        rows = slice(i * W, (i + 1) * W)
        # The worker warps: every tile row by the lane tree, lane 0.
        sums = [tree(chop(Luc[rows, j * W:(j + 1) * W]
                          * y[j * W:(j + 1) * W], fmt_id), None, 0)
                for j in (range(i) if lower else range(i + 1, nb))]
        t = chop(bc[rows] - fold(sums, W), fmt_id)
        D = torch.where(keep, Luc[rows, rows], zero)
        # The chain warp: row after row, the owner lane's sum.
        yb = torch.zeros(W)
        for q in range(W):
            r = q if lower else W - 1 - q
            live = idx < r if lower else idx > r
            p = torch.where(live, chop(D[r] * yb, fmt_id), zero)
            val = chop(t[r] - tree(p, live, r % 32), fmt_id)
            if not lower:
                d = D[r, r]
                val = chop(val / torch.where(d == 0, torch.ones(()), d),
                           fmt_id)
            yb[r] = val
        y[rows] = yb
    return y[:n]


def special_system(kind: str, fid: int, n: int, seed: int):
    """A float32 combined factor (n, n) and rhs (n,) at an edge:
    "signed zeros": b all -0, the factor positive, with 10% of the
    entries of every other row -0 (the diagonal too), so that products,
    tile sums and rows are all -0 or mix -0 and +0; "nan" and "inf": a
    few NaN or +-inf entries in the factor (both triangles) and in b;
    "subnormal": b in format `fid`'s subnormal range and float32's, the
    factor O(1)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)) * 0.3
    M[np.diag_indices(n)] = rng.choice([-1.0, 1.0], n) * (2.0 + rng.random(n))
    b = rng.standard_normal(n)
    if kind == "signed zeros":
        M = np.abs(M)
        M[(rng.random((n, n)) < 0.1) & (np.arange(n)[:, None] % 2 == 1)] = \
            -0.0
        b[:] = -0.0
    elif kind in ("nan", "inf"):
        bad = np.nan if kind == "nan" else np.inf
        M[rng.random((n, n)) < 2.0 / max(n, 1)] = bad
        M *= np.sign(rng.standard_normal((n, n)))
        b[rng.integers(0, n, max(n // 100, 1))] = bad
    elif kind == "subnormal":
        b *= 2.0 ** (max(FORMAT_LIST[fid].emin, -126) - 1)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return (torch.from_numpy(M.astype(np.float32)),
            torch.from_numpy(b.astype(np.float32)))
