"""The autotuning engine of the offline loop (port of `repro.core.engine`).

`AutotuneEngine` owns what the bandit-autotuning loop needs, for any
`TunableTask`:

  * the **solve cache** — deterministic tasks make (instance, action)
    outcomes reusable; cache misses are grouped per shape bucket into
    calls of at most `chunk` rows to `task.solve_rows`,
  * **epsilon-greedy selection** — by discretized state (offline Alg. 3,
    with pre-drawn coins for predictive prefetching),
  * **Q-updates** — the Eq. 6 incremental update against the attached
    policy's Q-table, returning the reward-prediction error.

The engine never imports a solver: everything algorithm-specific flows
through the task's `solve_rows` / `reward` hooks. The JAX engine's
fault-injection, metrics and executor hooks, its ad-hoc solve cache, its
selection by raw features (the online path) and its AOT warmup are not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.bandit import QTable
from repro_torch.core.discretize import Discretizer
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.task import Outcome, TunableTask


class AutotuneEngine:
    def __init__(self, task: TunableTask, reward_cfg=None,
                 chunk: int = 32, seed: int = 0,
                 policy: Optional[PrecisionPolicy] = None):
        self.task = task
        self.reward_cfg = reward_cfg
        self.chunk = chunk
        self.policy = policy
        self._rng = np.random.default_rng(seed)
        self._prepared: Dict[int, object] = {}   # instance idx -> rows
        self._cache: Dict[Tuple[int, int], Outcome] = {}
        self.n_solves = 0       # solver rows run
        self.n_requests = 0     # reward lookups

    # -- task facade -------------------------------------------------------
    @property
    def instances(self):
        return self.task.instances

    @property
    def features(self) -> np.ndarray:
        return self.task.features

    @property
    def action_space(self):
        return self.task.action_space

    @property
    def kappas(self):
        """Condition estimates when the task provides them (linear-system
        tasks do); None otherwise."""
        return getattr(self.task, "kappas", None)

    # -- solve cache -------------------------------------------------------
    def _prep(self, i: int):
        if i not in self._prepared:
            self._prepared[i] = self.task.prepare(self.task.instances[i])
        return self._prepared[i]

    def solve_pairs(self, pairs: Iterable[Tuple[int, int]]) -> None:
        """Batch-solve all uncached (instance, action) pairs, grouped by
        bucket, at most `chunk` rows per `solve_rows` call."""
        miss = sorted({(int(i), int(a)) for i, a in pairs
                       if (int(i), int(a)) not in self._cache})
        by_bucket: Dict[int, List[Tuple[int, int]]] = {}
        for p in miss:
            key = self.task.bucket_key(self.task.instances[p[0]])
            by_bucket.setdefault(key, []).append(p)
        for bucket, plist in sorted(by_bucket.items()):
            for c0 in range(0, len(plist), self.chunk):
                chunk_pairs = plist[c0:c0 + self.chunk]
                outs = self.task.solve_rows(
                    [self._prep(i) for i, _ in chunk_pairs],
                    [self.action_space.actions[a] for _, a in chunk_pairs],
                    self.chunk)
                self.n_solves += len(chunk_pairs)
                for p, out in zip(chunk_pairs, outs):
                    self._cache[p] = out

    def outcome(self, i: int, a: int) -> Outcome:
        if (i, a) not in self._cache:
            self.solve_pairs([(i, a)])
        return self._cache[(i, a)]

    def reward_for(self, outcome: Outcome, action_idx: int, instance,
                   cfg=None) -> float:
        """Task reward for an already-observed outcome."""
        cfg = cfg if cfg is not None else self.reward_cfg
        return self.task.reward(outcome, int(action_idx), instance, cfg)

    def reward(self, i: int, a: int, cfg=None) -> float:
        """Reward for applying action `a` to instance `i` (offline path)."""
        self.n_requests += 1
        return self.reward_for(self.outcome(i, a), a,
                               self.task.instances[i], cfg)

    def prefill_all(self) -> None:
        """Exhaustive (instance x action) sweep."""
        self.solve_pairs([(i, a) for i in range(len(self.task.instances))
                          for a in range(self.action_space.n_actions)])

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    # -- selection + learning ---------------------------------------------
    def fit_policy(self, n_bins, alpha=0.5, seed: int = 0
                   ) -> PrecisionPolicy:
        """Fresh policy: discretizer fit on the task's feature matrix plus
        an all-zero Q-table. Attached as this engine's live policy."""
        disc = Discretizer.fit(self.features, n_bins)
        qt = QTable(disc.n_states, self.action_space.n_actions, alpha, seed)
        self.policy = PrecisionPolicy(self.action_space, disc, qt)
        return self.policy

    @property
    def qtable(self) -> QTable:
        return self.policy.qtable

    def greedy(self, state: int) -> int:
        return self.policy.qtable.greedy(int(state))

    def select(self, state: int, eps: float, *, explore: Optional[bool]
               = None, rand_action: Optional[int] = None
               ) -> Tuple[int, bool]:
        """Epsilon-greedy by discretized state.

        `explore`/`rand_action` may be pre-drawn by the caller (the
        offline trainer draws them at episode start so greedy picks can
        be prefetched in one batched solve); left None, the engine's own
        rng draws them.
        """
        if explore is None:
            explore = bool(self._rng.random() < eps)
        if explore:
            action = (int(rand_action) if rand_action is not None else
                      int(self._rng.integers(self.action_space.n_actions)))
        else:
            action = self.greedy(state)
        return action, bool(explore)

    def update(self, state: int, action: int, r: float) -> float:
        """Eq. 6 Q-update; returns the pre-update reward-prediction
        error."""
        return self.policy.qtable.update(int(state), int(action), float(r))
