"""The single autotuning engine shared by offline training and online
serving (port of `repro.core.engine`).

`AutotuneEngine` owns the three things every bandit-autotuning loop
needs, for any `TunableTask`:

  * the **solve cache** — deterministic tasks make (instance, action)
    outcomes reusable; cache misses are grouped per shape bucket into
    calls of `chunk` rows (rounded to the executor's granularity) to
    `task.solve_rows`, and ad-hoc instances outside the task's set
    (`solve_adhoc`) take the same route,
  * **epsilon-greedy selection** — by discretized state (offline Alg. 3,
    with pre-drawn coins for predictive prefetching) or by raw features
    (online serving, with the nearest-visited-bin greedy fallback),
  * **Q-updates** — the Eq. 6 incremental update against the attached
    policy's Q-table, returning the reward-prediction error.

The engine never imports a solver: everything algorithm-specific flows
through the task's `solve_rows` / `reward` hooks. `core.autotune`
(offline) and `service.server` (online) are both thin drivers over this
class. The fault sites ``engine.solve`` and ``solver.outcome`` and the
solve-cache counters (on the port's default metrics registry) are those
of the JAX engine, and so is its AOT warmup (`precompile`, DESIGN.md
§12: the task's warm batches through the executor's dispatcher).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import faults
from repro_torch.core.bandit import QTable
from repro_torch.core.discretize import Discretizer
from repro_torch.core.executor import resolve_executor
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.task import Outcome, TunableTask


def _count(name: str, help: str, amount: float = 1.0, **labels) -> None:
    """Fail-open counter against the port's process-default metrics
    registry (`repro_torch.obs`): the solve-cache stats describe the
    process, not one server."""
    try:
        from repro_torch.obs.metrics import default_registry
        fam = default_registry().counter(name, help,
                                         tuple(sorted(labels)))
        (fam.labels(**labels) if labels else fam).inc(amount)
    except Exception:
        pass


class AutotuneEngine:
    def __init__(self, task: TunableTask, reward_cfg=None,
                 chunk: int = 32, seed: int = 0,
                 policy: Optional[PrecisionPolicy] = None,
                 executor=None):
        self.task = task
        self.reward_cfg = reward_cfg
        self.chunk = chunk
        self.policy = policy
        # An explicit `executor` is pushed onto the task (the server does
        # the same); the engine's chunks follow its granularity.
        if executor is not None:
            self.task.executor = resolve_executor(executor)
        self.executor = resolve_executor(
            getattr(self.task, "executor", None))
        self._rng = np.random.default_rng(seed)
        self._prepared: Dict[int, object] = {}   # instance idx -> rows
        self._cache: Dict[Tuple[int, int], Outcome] = {}
        # Ad-hoc solve cache: keyed by (id(instance), action) with the
        # instance pinned alongside the outcome so the id can never be
        # recycled while the entry lives.
        self._adhoc: Dict[Tuple[int, int], Tuple[object, Outcome]] = {}
        self.n_solves = 0       # real solver rows
        # Padding rows run: none, as the port's tasks solve only the rows
        # they are given (the JAX tasks pad each call to `chunk` rows).
        self.n_pad_solves = 0
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

    def _solve_chunks(self, bucket: int, items: list, prep, store) -> None:
        """`task.solve_rows` over `items` in chunks of the executor's
        granularity, each behind the ``engine.solve`` fault site, with
        every outcome passed through ``solver.outcome`` and handed to
        `store(item, outcome)` as its chunk completes. `prep(item)`
        gives (prepared rows, action index)."""
        chunk = self.executor.preferred_chunk(self.chunk, bucket)
        _count("repro_engine_cache_misses_total",
               "Uncached (instance, action) pairs solved by the "
               "engine's solve cache.", len(items),
               task=getattr(self.task, "name", "unknown"), bucket=bucket)
        for c0 in range(0, len(items), chunk):
            part = items[c0:c0 + chunk]
            faults.maybe_raise("engine.solve", bucket=bucket)
            rows = [prep(item) for item in part]
            outs = self.task.solve_rows(
                [r for r, _ in rows],
                [self.action_space.actions[a] for _, a in rows], chunk)
            self.n_solves += len(part)
            for item, (_, a), out in zip(part, rows, outs):
                store(item, faults.corrupt_outcome(
                    "solver.outcome", out, bucket=bucket,
                    action_row=self.action_space.actions[a]))

    def solve_pairs(self, pairs: Iterable[Tuple[int, int]]) -> None:
        """Batch-solve all uncached (instance, action) pairs, grouped by
        bucket."""
        miss = sorted({(int(i), int(a)) for i, a in pairs
                       if (int(i), int(a)) not in self._cache})
        if not miss:
            return
        by_bucket: Dict[int, List[Tuple[int, int]]] = {}
        for p in miss:
            key = self.task.bucket_key(self.task.instances[p[0]])
            by_bucket.setdefault(key, []).append(p)
        for bucket, plist in sorted(by_bucket.items()):
            self._solve_chunks(bucket, plist,
                               lambda p: (self._prep(p[0]), p[1]),
                               self._cache.__setitem__)
        _count("repro_engine_solve_rows_total",
               "Real rows solved through the engine cache.", len(miss),
               task=getattr(self.task, "name", "unknown"))

    def outcome(self, i: int, a: int) -> Outcome:
        if (i, a) not in self._cache:
            self.solve_pairs([(i, a)])
        return self._cache[(i, a)]

    def solve_adhoc(self, pairs: Sequence[Tuple[object, int]]
                    ) -> List[Outcome]:
        """Batch-solve (instance, action) pairs for instances *outside*
        ``task.instances`` — trajectory replay and serving-style
        one-offs. Same bucketed chunked route as `solve_pairs`, outcomes
        returned in input order and cached."""
        miss: Dict[Tuple[int, int], Tuple[object, int]] = {}
        for inst, a in pairs:
            key = (id(inst), int(a))
            if key not in self._adhoc and key not in miss:
                miss[key] = (inst, int(a))
        by_bucket: Dict[int, List[Tuple[Tuple[int, int],
                                        Tuple[object, int]]]] = {}
        for key, (inst, a) in miss.items():
            bucket = self.task.bucket_key(inst)
            by_bucket.setdefault(bucket, []).append((key, (inst, a)))
        for bucket, plist in sorted(by_bucket.items()):
            self._solve_chunks(
                bucket, plist,
                lambda item: (self.task.prepare(item[1][0]), item[1][1]),
                lambda item, out: self._adhoc.__setitem__(
                    item[0], (item[1][0], out)))
        return [self._adhoc[(id(inst), int(a))][1] for inst, a in pairs]

    def outcome_for_instance(self, instance, action_idx: int) -> Outcome:
        """Outcome of one ad-hoc (instance, action) solve (cached)."""
        return self.solve_adhoc([(instance, int(action_idx))])[0]

    def reward_for(self, outcome: Outcome, action_idx: int, instance,
                   cfg=None) -> float:
        """Task reward for an already-observed outcome (online path)."""
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

    def precompile(self, buckets: Optional[Sequence[int]] = None
                   ) -> List[Tuple[int, bool]]:
        """AOT-warm the solve cache's cells (DESIGN.md §12): for each
        bucket, run the task's warm batches at this engine's chunk
        through the dispatcher `solve_pairs` uses, so a warm engine runs
        nothing new. Buckets default to the task's instance buckets.
        Returns (bucket, warmed) pairs; warmed=False: the task has no
        dispatchable form, and that bucket warms on its first solve."""
        fn = getattr(self.task, "precompile_bucket", None)
        if fn is None:
            return []
        if buckets is None:
            buckets = sorted({self.task.bucket_key(s)
                              for s in self.task.instances})
        return [(int(b), bool(fn(int(b), self.chunk))) for b in buckets]

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    def summarize(self) -> Dict[str, float]:
        """Solver-work accounting: real rows vs fixed-shape padding
        waste, plus the per-device view (per-device counts are totals /
        devices). The port's tasks run no padding rows, so `n_pad_solves`
        is 0, and a shard holds the ceiling or the floor of its chunk's
        rows / devices: `rows_per_device` is the ceiling of the total,
        the rows of the fullest device when one bucket's rows were split
        (its chunks are multiples of the data axis but the last)."""
        d = max(1, self.executor.device_count())
        total = self.n_solves + self.n_pad_solves
        return {"n_solves": self.n_solves,
                "n_pad_solves": self.n_pad_solves,
                "n_requests": self.n_requests,
                "cache_size": self.cache_size,
                "n_devices": d,
                "rows_per_device": -(-total // d),
                "n_solves_per_device": self.n_solves / d,
                "n_pad_solves_per_device": self.n_pad_solves / d}

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

    def select_for_features(self, features: np.ndarray, eps: float
                            ) -> Tuple[int, int, bool]:
        """(state, action, explore) from raw features: the online path.
        Greedy picks go through `PrecisionPolicy.predict`, i.e. the
        nearest-visited-bin fallback (Prop. 1)."""
        state = self.policy.state_of(features)
        explore = bool(self._rng.random() < eps)
        if explore:
            action = int(self._rng.integers(self.action_space.n_actions))
        else:
            action, _ = self.policy.predict(features)
        return state, int(action), explore

    def update(self, state: int, action: int, r: float) -> float:
        """Eq. 6 Q-update; returns the pre-update reward-prediction
        error."""
        return self.policy.qtable.update(int(state), int(action), float(r))
