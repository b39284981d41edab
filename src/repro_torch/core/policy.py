"""Trained precision-selection policy: Q-table + discretizer + action space
(a copy of `repro.core.policy`)."""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.core.action_space import ActionSpace, reduced_action_space
from repro_torch.core.bandit import QTable
from repro_torch.core.discretize import Discretizer


@dataclasses.dataclass
class PrecisionPolicy:
    action_space: ActionSpace
    discretizer: Discretizer
    qtable: QTable

    def state_of(self, features: np.ndarray) -> int:
        return int(self.discretizer(np.asarray(features)))

    @property
    def safe_action(self) -> int:
        """The known-safe all-fp64 arm: the highest action index. Action
        spaces order arms lowest→highest precision, and `QTable.greedy`
        breaks ties toward the highest index, so this is exactly the arm
        a zeroed (never-trained) Q-row resolves to — the breaker's
        degradation target (DESIGN.md §11.2) coincides with the
        untrained-policy default by construction."""
        return self.action_space.n_actions - 1

    def _nearest_visited(self, s: int) -> int:
        """Nearest visited state in bin coordinates (L2).

        Prop. 1 justifies nearest-bin generalization: the expected-reward
        Lipschitz bound degrades linearly with the bin distance, so the
        closest visited cell is the minimum-regret surrogate for a cell the
        training set never reached. Falls back to `s` itself (whose all-zero
        Q row resolves to the highest-precision action) when nothing was
        visited at all.
        """
        visited = np.where(self.qtable.N.sum(axis=1) > 0)[0]
        if len(visited) == 0 or s in visited:
            return s
        nb = np.asarray(self.discretizer.n_bins)
        def coords(flat):
            out = []
            for b in nb[::-1]:
                out.append(flat % b)
                flat = flat // b
            return np.stack(out[::-1], axis=-1)
        d = np.linalg.norm(coords(visited) - coords(np.asarray([s])), axis=1)
        return int(visited[int(np.argmin(d))])

    def predict(self, features: np.ndarray) -> Tuple[int, np.ndarray]:
        """Greedy inference (Eq. 7), with nearest-visited-bin fallback."""
        s = self.state_of(features)
        if not self.qtable.visited(s):
            s = self._nearest_visited(s)
        a = self.qtable.greedy(s)
        return a, self.action_space.actions[a]

    def predict_names(self, features: np.ndarray) -> Tuple[str, ...]:
        a, _ = self.predict(features)
        return self.action_space.names(a)

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        self.qtable.save(os.path.join(path, "qtable.npz"))
        meta = {
            "discretizer": self.discretizer.to_dict(),
            "ladder": list(self.action_space.ladder),
            "k": self.action_space.k,
            "ladder_idx": self.action_space.ladder_idx.tolist(),
        }
        with open(os.path.join(path, "policy.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "PrecisionPolicy":
        qt = QTable.load(os.path.join(path, "qtable.npz"))
        with open(os.path.join(path, "policy.json")) as f:
            meta = json.load(f)
        space = reduced_action_space(tuple(meta["ladder"]), meta["k"])
        # Restore any subsampling by matching ladder_idx rows.
        want = np.asarray(meta["ladder_idx"], dtype=np.int32)
        if want.shape != space.ladder_idx.shape or \
                not np.array_equal(want, space.ladder_idx):
            keep = [i for i, row in enumerate(space.ladder_idx.tolist())
                    if row in want.tolist()]
            space = ActionSpace(space.ladder, space.k,
                                space.actions[keep], space.ladder_idx[keep])
        disc = Discretizer.from_dict(meta["discretizer"])
        return cls(space, disc, qt)
