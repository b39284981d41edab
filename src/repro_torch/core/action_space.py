"""Joint precision action space + the paper's monotone reduction (Eq. 11-12).

An action is a k-tuple of precisions (one per computational step), ordered so
that u_1' <= u_2' <= ... <= u_k' by significand bits (for GMRES-IR:
u_f <= u <= u_g <= u_r). The reduced space has C(m+k-1, k) elements
(Eq. 12): 35 for m=4, k=4, an ~86% cut of the 256-action product space.
A copy of `repro.core.action_space`.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.precision.formats import (FORMAT_ID, FORMATS,
                                           SOLVER_LADDER, SOLVER_LADDER_FP8)


@dataclasses.dataclass(frozen=True)
class ActionSpace:
    ladder: Tuple[str, ...]      # precision names, increasing significand
    k: int                       # number of precision-controlled steps
    actions: np.ndarray          # (n_actions, k) global format ids
    ladder_idx: np.ndarray       # (n_actions, k) indices into `ladder`

    @property
    def n_actions(self) -> int:
        return self.actions.shape[0]

    def names(self, a: int) -> Tuple[str, ...]:
        return tuple(self.ladder[i] for i in self.ladder_idx[a])

    def significand_bits(self, a: int) -> Tuple[int, ...]:
        return tuple(FORMATS[n].t for n in self.names(a))


def reduced_size(m: int, k: int) -> int:
    """Eq. 12: C(m+k-1, k)."""
    return math.comb(m + k - 1, k)


def reduced_action_space(ladder: Sequence[str] = tuple(SOLVER_LADDER),
                         k: int = 4,
                         subsample: Optional[int] = None,
                         seed: int = 0) -> ActionSpace:
    """All non-decreasing k-tuples over the ladder (Eq. 11).

    `subsample`: optionally keep only this many actions (the paper further
    prunes to ~1/4 of the valid combinations); the full/best (all-lowest,
    all-highest) extremes are always retained so the agent can reach both the
    cheapest and the reference configuration.
    """
    m = len(ladder)
    combos = list(itertools.combinations_with_replacement(range(m), k))
    assert len(combos) == reduced_size(m, k)
    idx = np.asarray(combos, dtype=np.int32)
    if subsample is not None and subsample < len(combos):
        rng = np.random.default_rng(seed)
        keep = {0, len(combos) - 1}
        rest = [i for i in range(len(combos)) if i not in keep]
        keep |= set(rng.choice(rest, size=subsample - len(keep),
                               replace=False).tolist())
        idx = idx[sorted(keep)]
    actions = np.asarray([[FORMAT_ID[ladder[i]] for i in row] for row in idx],
                         dtype=np.int32)
    return ActionSpace(tuple(ladder), k, actions, idx)


def fp8_reduced_action_space(k: int = 4,
                             subsample: Optional[int] = None,
                             seed: int = 0) -> ActionSpace:
    """The fp8-extended reduced space: the `SOLVER_LADDER`-derived Eq. 11
    construction over `SOLVER_LADDER_FP8` (e5m2/e4m3 prepended as the
    cheapest rungs). m=6, k=4 gives C(9, 4) = 126 monotone actions —
    `subsample` prunes as in the paper while always keeping the
    all-e5m2 and all-fp64 extremes. The fp8 formats saturate on
    overflow, so u_f = fp8 arms fail soft (clamped factors -> more
    refinement) instead of hard (inf-poisoned LU)."""
    return reduced_action_space(tuple(SOLVER_LADDER_FP8), k,
                                subsample=subsample, seed=seed)


def full_action_space(ladder: Sequence[str] = tuple(SOLVER_LADDER),
                      k: int = 4) -> ActionSpace:
    """Unreduced m^k product space (for ablations)."""
    m = len(ladder)
    combos = list(itertools.product(range(m), repeat=k))
    idx = np.asarray(combos, dtype=np.int32)
    actions = np.asarray([[FORMAT_ID[ladder[i]] for i in row] for row in idx],
                         dtype=np.int32)
    return ActionSpace(tuple(ladder), k, actions, idx)


def is_monotone(action_ladder_idx: Sequence[int]) -> bool:
    return all(a <= b for a, b in zip(action_ladder_idx,
                                      action_ladder_idx[1:]))
