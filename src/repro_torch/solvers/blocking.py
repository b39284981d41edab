"""Blocking policy for the factorization/substitution hot path.

The strict row-loop LU and triangular solves are paper-faithful but
O(n) sequential; above a size threshold the solvers switch to the
blocked variants (panel-pivoted LU with a chopped-GEMM trailing update,
block-triangular substitution with fused chopped-matvec off-diagonal
tiles — DESIGN.md §6.4). The policy is a tiny frozen dataclass so it
hashes by value and rides inside `IRConfig`. A copy of
`repro.solvers.blocking`.

Defaults: sizes are bucketed to multiples of 128 by `tasks.base`, so
`trisolve_block=128` divides every bucketed size that crosses the
`min_n=256` threshold and `lu_block=64` keeps the panel cheap while the
trailing GEMM (lane-padded K, DESIGN.md §6.2) does the O(n^3) work.
Non-multiple sizes still take the blocked path — both blocked kernels
identity-pad to the next block multiple internally.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BlockingPolicy:
    """When and how the blocked factorization/substitution path engages.

    min_n: systems with n >= min_n take the blocked path (strict below).
    lu_block: LU panel width (strict panel, chopped-GEMM trailing update).
    trisolve_block: block-triangular substitution tile size.
    enabled: False forces the strict row-loop path at every size.
    """

    min_n: int = 256
    lu_block: int = 64
    trisolve_block: int = 128
    enabled: bool = True

    def use_blocked(self, n: int) -> bool:
        return self.enabled and n >= self.min_n


DEFAULT_BLOCKING = BlockingPolicy()
STRICT_ONLY = BlockingPolicy(enabled=False)


def resolve_blocking(blocking) -> BlockingPolicy:
    """None -> the default policy (mirrors `precision.resolve_backend`)."""
    return DEFAULT_BLOCKING if blocking is None else blocking
