"""Tabular contextual-bandit learner (paper Alg. 1 / §3.2).

Q: S_d x A -> R with the incremental estimator Q += alpha (R - Q) (Eq. 6),
epsilon-greedy action selection (Eq. 5) with linear decay (Eq. 13), and
optional 1/N(s,a) learning-rate schedule (Alg. 1 line 13).

The Q-table is tiny (|S_d| * |A| floats). A copy of `repro.core.bandit`:
the numpy generator makes exploration match the JAX package's for a seed.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np


def epsilon_schedule(episode: int, total: int, eps_min: float) -> float:
    """Eq. 13/26: linear decay from 1.0, floored at eps_min."""
    return max(eps_min, 1.0 - episode / total)


@dataclasses.dataclass
class QTable:
    n_states: int
    n_actions: int
    alpha: Optional[float] = 0.5   # None => 1/N(s,a) schedule
    seed: int = 0

    def __post_init__(self):
        self.Q = np.zeros((self.n_states, self.n_actions))
        self.N = np.zeros((self.n_states, self.n_actions), dtype=np.int64)
        self.rng = np.random.default_rng(self.seed)

    # -- policy ------------------------------------------------------------
    def greedy(self, s: int) -> int:
        """argmax_a Q(s, a), ties broken toward the HIGHEST action index.

        Actions are ordered by increasing precision (Eq. 11 reduction), so an
        unvisited state (all-zero Q row) resolves to the all-highest-
        precision action — the numerically safe fallback the paper observes
        its agent learning on ill-conditioned data (§5.3).
        """
        q = self.Q[s]
        return int(len(q) - 1 - np.argmax(q[::-1]))

    def select(self, s: int, eps: float) -> int:
        """Eq. 5 epsilon-greedy."""
        if self.rng.random() < eps:
            return int(self.rng.integers(self.n_actions))
        return self.greedy(s)

    def visited(self, s: int) -> bool:
        return bool(self.N[s].sum() > 0)

    # -- learning ----------------------------------------------------------
    def update(self, s: int, a: int, r: float) -> float:
        """Eq. 6/27. Returns the reward-prediction error before the update."""
        rpe = r - self.Q[s, a]
        self.N[s, a] += 1
        alpha = self.alpha if self.alpha is not None else 1.0 / self.N[s, a]
        self.Q[s, a] += alpha * rpe
        return float(rpe)

    # -- persistence -------------------------------------------------------
    @staticmethod
    def _npz_path(path: str) -> str:
        # np.savez appends ".npz" when the suffix is absent; normalize so
        # save(p) and load(p) always agree on the on-disk name.
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path: str) -> None:
        np.savez(self._npz_path(path), Q=self.Q, N=self.N,
                 meta=json.dumps({"n_states": self.n_states,
                                  "n_actions": self.n_actions,
                                  "alpha": self.alpha,
                                  "seed": self.seed}))

    @classmethod
    def load(cls, path: str) -> "QTable":
        z = np.load(cls._npz_path(path), allow_pickle=False)
        meta = json.loads(str(z["meta"]))
        qt = cls(meta["n_states"], meta["n_actions"], meta["alpha"],
                 meta["seed"])
        qt.Q = z["Q"]
        qt.N = z["N"]
        return qt
