"""The order in which the "shfl" routes of the qmv and trisolve kernels
sum, as plain torch: a model of the register tree of
`csrc/chop_core.cuh`, held bit for bit against `tree_sum` of both
packages on the CPU (`tests/test_torch_tree_model.py`). Nothing on the
main path calls it; the card holds the kernels themselves against the
plain versions.

A warp holds a width-n row with n = 32 J as lane l's registers
x[l + 32 j], j < J. While J is even, a level of `tree_sum`'s halving tree
(fold the upper half onto the lower half) adds two registers of one lane.
At width 32 the xor butterfly adds on every lane its own value and its
partner's (lane l ^ o, o = 16, 8, 4, 2, 1): lanes below o add as the tree
does, the others with the operands swapped, so lane 0 ends with the
tree's root in the tree's order. A power of two below 32 starts the
butterfly at half its width. Any other width (an odd multiple of 32
after the in-lane levels, such as 384 -> 96, or a width that is no
multiple of 32) finishes with the halving tree in shared memory, every
level explicit; every lane reads the same root.

`special_matvec` makes operands that tell the orders apart: signed
zeros, NaN, infinities and subnormals.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.precision import FORMAT_LIST

WARP = 32
# Operands at the edges (`special_matvec`, `trisolve.checks.special_system`).
SPECIAL_KINDS = ("signed zeros", "nan", "inf", "subnormal")


def butterfly_offsets(width: int) -> tuple[int, ...]:
    """The shuffle offsets of a row of `width` lanes (a power of two up
    to 32): width / 2, ..., 1."""
    return tuple(1 << k for k in reversed(range(width.bit_length() - 1)))


def halving_tree(x: torch.Tensor) -> torch.Tensor:
    """The halving tree over the last axis with every level explicit, odd
    widths parking their last element in a tail added at the end: the
    shared-memory tree `warp_tree_sum` of the kernels."""
    n = x.shape[-1]
    if n == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    tail = None
    while n > 1:
        m = n // 2
        if n % 2:
            last = x[..., n - 1]
            tail = last if tail is None else tail + last
        x = x[..., :m] + x[..., m:2 * m]
        n = m
    return x[..., 0] if tail is None else x[..., 0] + tail


def lane_tree_sum(x: torch.Tensor, dim: int = -1, *, lane: int = 0,
                  offsets: Sequence[int] | None = None) -> torch.Tensor:
    """Sum along `dim` as a warp of the "shfl" kernels does, and return
    what lane `lane` holds: the in-lane levels, then the xor butterfly
    (`offsets`, default `butterfly_offsets`), or the shared-memory tail.
    Lane 0's value is `tree_sum`'s bit for bit; every lane's is on the
    card, which has one NaN."""
    x = torch.movedim(x, dim, -1)
    n = x.shape[-1]
    if n % WARP == 0 and n > 0:
        v = x.reshape(*x.shape[:-1], n // WARP, WARP)   # v[..., j, l]
        while v.shape[-2] % 2 == 0:
            h = v.shape[-2] // 2
            v = v[..., :h, :] + v[..., h:, :]
        if v.shape[-2] > 1:      # an odd multiple of 32 left: the tail
            return halving_tree(v.reshape(*v.shape[:-2], -1))
        w, width = v[..., 0, :], WARP
    elif n > 0 and n & (n - 1) == 0:
        w, width = x, n
    else:
        return halving_tree(x)
    idx = torch.arange(width, device=x.device)
    for o in (butterfly_offsets(width) if offsets is None else offsets):
        w = w + w[..., idx ^ o]
    return w[..., lane % width]


def special_matvec(kind: str, fid: int, M: int, K: int, seed: int):
    """Float32 operands (A (M, K), v (K,)) of qmv at an edge:
    "signed zeros": v all -0 and A positive with 10% of its entries -0,
    so that a row sums -0 products, or -0 and +0 ones; "nan" and "inf":
    A and v with a few NaN or +-inf entries; "subnormal": products in
    format `fid`'s subnormal range and float32's."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    v = rng.standard_normal(K).astype(np.float32)
    if kind == "signed zeros":
        a = np.abs(a)
        a[rng.random((M, K)) < 0.1] = -0.0
        v[:] = -0.0
    elif kind in ("nan", "inf"):
        bad = np.float32(np.nan if kind == "nan" else np.inf)
        a[rng.random((M, K)) < 0.01] = bad
        a *= np.sign(rng.standard_normal((M, K))).astype(np.float32)
        v[rng.integers(0, K, max(K // 64, 1))] = bad
    elif kind == "subnormal":
        emin = max(FORMAT_LIST[fid].emin, -126)
        a *= np.float32(2.0 ** (emin // 2))
        v *= np.float32(2.0 ** (emin - emin // 2 - 1))
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return torch.from_numpy(a), torch.from_numpy(v)
