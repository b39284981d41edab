"""High-level training / evaluation API (paper Alg. 3), task-agnostic.

`train_policy` is an *exact* implementation of Algorithm 3 — sequential
per-instance epsilon-greedy selection and Q-updates — with a predictive
batching trick: at each episode start the epsilon coins and random actions
are pre-drawn and the greedy actions under the episode-start Q are
pre-solved, so nearly every reward lookup hits the solve cache while the
update order/semantics stay exactly the paper's. Intra-episode Q changes
that flip an argmax fall back to an on-demand solve (rare).

All entry points accept any `TunableTask` or an already-built
`AutotuneEngine`. Port of `repro.core.autotune` (`train_policy`,
`evaluate_policy`, `evaluate_fixed_action`), plus
`policy_from_reference`, which builds this package's policy from the JAX
package's trained arrays (the weights carried across).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.action_space import ActionSpace
from repro_torch.core.bandit import QTable, epsilon_schedule
from repro_torch.core.discretize import Discretizer
from repro_torch.core.engine import AutotuneEngine
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.rewards import RewardConfig
from repro_torch.core.task import coerce_task
from repro_torch.precision.formats import FORMAT_LIST
from repro_torch.solvers.metrics import summarize


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    episodes: int = 100
    alpha: Optional[float] = 0.5    # None => 1/N(s,a)
    eps_min: float = 0.02
    n_bins: Sequence[int] = (10, 10)
    seed: int = 0
    prefill: bool = False           # exhaustive (i,a) sweep before training


@dataclasses.dataclass
class TrainHistory:
    episode_reward: List[float] = dataclasses.field(default_factory=list)
    episode_rpe: List[float] = dataclasses.field(default_factory=list)
    epsilon: List[float] = dataclasses.field(default_factory=list)
    unique_solves: List[int] = dataclasses.field(default_factory=list)
    wall_time_s: float = 0.0
    n_solves: int = 0        # solver rows executed


def as_engine(task_or_engine) -> AutotuneEngine:
    """Coerce a TunableTask (or a solver config object) into an engine;
    pass engines through untouched."""
    if isinstance(task_or_engine, AutotuneEngine):
        return task_or_engine
    return AutotuneEngine(coerce_task(task_or_engine))


def train_policy(task, reward_cfg: RewardConfig,
                 cfg: TrainConfig = TrainConfig()) -> tuple:
    """Algorithm 3 on the task's training instances."""
    t0 = time.time()
    engine = as_engine(task)
    n_sys = len(engine.instances)
    policy = engine.fit_policy(cfg.n_bins, cfg.alpha, cfg.seed)
    states = np.asarray(policy.discretizer(engine.features))
    rng = np.random.default_rng(cfg.seed + 1)
    hist = TrainHistory()

    if cfg.prefill:
        engine.prefill_all()

    for t in range(cfg.episodes):
        eps = epsilon_schedule(t, cfg.episodes, cfg.eps_min)
        coins = rng.random(n_sys) < eps
        rand_a = rng.integers(engine.action_space.n_actions, size=n_sys)
        # Predictive prefetch: random picks + episode-start greedy picks.
        prefetch = [(i, int(rand_a[i])) for i in range(n_sys) if coins[i]]
        prefetch += [(i, engine.greedy(int(states[i])))
                     for i in range(n_sys) if not coins[i]]
        engine.solve_pairs(prefetch)

        ep_rewards, ep_rpes = [], []
        for i in range(n_sys):                      # Alg. 3 lines 6-21
            s = int(states[i])
            a, _ = engine.select(s, eps, explore=bool(coins[i]),
                                 rand_action=int(rand_a[i]))
            r = engine.reward(i, a, reward_cfg)
            rpe = engine.update(s, a, r)
            ep_rewards.append(r)
            ep_rpes.append(abs(rpe))
        hist.episode_reward.append(float(np.mean(ep_rewards)))
        hist.episode_rpe.append(float(np.mean(ep_rpes)))
        hist.epsilon.append(eps)
        hist.unique_solves.append(engine.cache_size)

    hist.wall_time_s = time.time() - t0
    hist.n_solves = engine.n_solves
    return policy, hist


def _collect(engine: AutotuneEngine, picks):
    """Metric arrays for a list of (instance, action) picks.

    The evaluation drivers (unlike training) summarize per condition
    range, so they require linear-system-style tasks: outcomes carrying
    "ferr"/"nbe"/"n_outer" (+ the task's `inner_iter_metric`) and a
    `kappas` attribute on the task. Custom tasks without these should
    summarize their own outcomes via `engine.outcome`.
    """
    if getattr(engine.task, "kappas", None) is None:
        raise TypeError(
            f"task {getattr(engine.task, 'name', type(engine.task).__name__)!r}"
            " has no `kappas`; evaluate_policy only "
            "summarizes linear-system tasks — collect outcomes via "
            "AutotuneEngine.outcome for custom tasks")
    outs = [engine.outcome(i, a) for i, a in picks]
    inner_key = getattr(engine.task, "inner_iter_metric", "n_gmres")
    ferr = np.array([o.metrics["ferr"] for o in outs])
    nbe = np.array([o.metrics["nbe"] for o in outs])
    n_outer = np.array([o.metrics["n_outer"] for o in outs])
    n_inner = np.array([o.metrics[inner_key] for o in outs])
    return ferr, nbe, n_outer, n_inner


def evaluate_policy(policy: PrecisionPolicy, task, tau_base: float) -> Dict:
    """Greedy inference (Alg. 3 line 23) over the task's instances,
    summarized per condition range (paper table columns)."""
    engine = as_engine(task)
    n_sys = len(engine.instances)
    picks = []
    for i in range(n_sys):
        a, _ = policy.predict(engine.features[i])
        picks.append((i, a))
    engine.solve_pairs(picks)
    ferr, nbe, n_outer, n_inner = _collect(engine, picks)
    kappa = engine.kappas
    table = summarize(ferr, nbe, n_outer, n_inner, kappa, tau_base)
    # Per-step precision usage frequencies (paper Fig. 2 / Table 5).
    usage = np.zeros((len(policy.action_space.ladder),))
    per_range_usage = {}
    names = list(policy.action_space.ladder)
    lad = policy.action_space.ladder_idx
    for rng_name, (lo, hi) in {
            "low": (1e0, 1e3), "medium": (1e3, 1e6),
            "high": (1e6, 1e9), "vhigh": (1e9, 1e12)}.items():
        sel = [(i, a) for (i, a) in picks if lo <= kappa[i] < hi]
        if not sel:
            continue
        counts = np.zeros(len(names))
        for _, a in sel:
            for step in lad[a]:
                counts[step] += 1
        per_range_usage[rng_name] = dict(
            zip(names, (counts / len(sel)).round(3).tolist()))
    for _, a in picks:
        for step in lad[a]:
            usage[step] += 1
    return {
        "table": table,
        "actions": picks,
        "ferr": ferr, "nbe": nbe,
        "n_outer": n_outer, "n_inner": n_inner,
        # legacy alias (pre-TunableTask callers read the GMRES name)
        "n_gmres": n_inner,
        "usage_per_solve": dict(zip(names, (usage / n_sys).round(3).tolist())),
        "usage_per_range": per_range_usage,
    }


def evaluate_fixed_action(task, action_idx: int, tau_base: float) -> Dict:
    """Baseline evaluation: every instance under one action (e.g. the
    all-FP64 action, the paper's baseline column)."""
    engine = as_engine(task)
    picks = [(i, action_idx) for i in range(len(engine.instances))]
    engine.solve_pairs(picks)
    ferr, nbe, n_outer, n_inner = _collect(engine, picks)
    return {"table": summarize(ferr, nbe, n_outer, n_inner, engine.kappas,
                               tau_base),
            "ferr": ferr, "nbe": nbe, "n_outer": n_outer,
            "n_inner": n_inner, "n_gmres": n_inner}


def policy_from_reference(Q, N, mins, maxs, n_bins, actions,
                          alpha: Optional[float] = 0.5,
                          seed: int = 0) -> PrecisionPolicy:
    """This package's `PrecisionPolicy` from the JAX package's trained
    arrays: Q-table `Q` and visit counts `N` (n_states, n_actions), the
    discretizer's `mins`/`maxs`/`n_bins`, and the action table `actions`
    (n_actions, k) of format ids. The ladder is the sorted set of format
    ids the table uses (ids order formats by precision)."""
    actions = np.asarray(actions, np.int32)
    fids = sorted(set(actions.ravel().tolist()))
    ladder = tuple(FORMAT_LIST[f].name for f in fids)
    ladder_idx = np.searchsorted(np.asarray(fids), actions).astype(np.int32)
    space = ActionSpace(ladder, actions.shape[1], actions, ladder_idx)
    disc = Discretizer(np.asarray(mins, np.float64),
                       np.asarray(maxs, np.float64),
                       tuple(int(b) for b in n_bins))
    Q = np.asarray(Q, np.float64)
    N = np.asarray(N, np.int64)
    if Q.shape != (disc.n_states, space.n_actions) or N.shape != Q.shape:
        raise ValueError(f"Q-table {Q.shape} / visit counts {N.shape} do "
                         f"not match {disc.n_states} states x "
                         f"{space.n_actions} actions")
    qt = QTable(disc.n_states, space.n_actions, alpha, seed)
    qt.Q = Q.copy()
    qt.N = N.copy()
    return PrecisionPolicy(space, disc, qt)
