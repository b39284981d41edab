"""Unrounded carrier math with a pinned schedule (DESIGN.md §6.2, §7.3).

Port of `repro.solvers.carrier`: the GMRES residual norms and the final
Eq. 17 metrics sum in the carrier with the fixed `tree_sum` order, so
their bits match the JAX package's. Both take one system or a batch
(A (B, n, n), vectors (B, n)): each row's value is its own system's.
"""
from __future__ import annotations

import torch

from repro_torch.precision import fma_barrier, tree_sum


def carrier_residual(A: torch.Tensor, b: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """b - A x with a pinned row-sum schedule (the Eq. 17 epilogue)."""
    return b - tree_sum(fma_barrier(A * x.unsqueeze(-2)), dim=-1)


def carrier_norm(v: torch.Tensor) -> torch.Tensor:
    """||v||_2 with a pinned square-then-sum schedule (of each row of a
    batch)."""
    return torch.sqrt(tree_sum(fma_barrier(v * v), dim=-1))
