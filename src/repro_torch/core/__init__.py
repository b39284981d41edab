"""The paper's primary contribution: contextual-bandit precision autotuning
(port of `repro.core`).

  * `task.py` — the `TunableTask` protocol + `Outcome`; concrete tasks
    live in `repro_torch.tasks` (GMRES-IR, CG-IR).
  * `engine.py` — `AutotuneEngine`: the learning loop (solve cache,
    epsilon-greedy selection, Q-updates).
  * `autotune.py` — Alg. 3 `train_policy` / `evaluate_policy`, the
    fixed-action baseline `evaluate_fixed_action`, and
    `policy_from_reference`.
  * Framework pieces: action space (Eq. 11-12), discretizer (Eq. 19-20),
    rewards (Eq. 21-25), tabular bandit (Eq. 5-6), policy persistence,
    and the batching layer.
  * `env.py` — the deprecated `GMRESIREnv` shim (engine + GMRES-IR task
    fused, kept for pre-TunableTask call sites).
  * `executor.py` + `aot.py` — the solve dispatch and the AOT warmup of
    a server's buckets (DESIGN.md §7, §12).
"""
from .action_space import (ActionSpace, fp8_reduced_action_space,
                           full_action_space, is_monotone,
                           reduced_action_space, reduced_size)
from .autotune import (TrainConfig, TrainHistory, as_engine,
                       evaluate_fixed_action, evaluate_policy,
                       policy_from_reference, train_policy)
from .bandit import QTable, epsilon_schedule
from .batching import (SolveRecord, bucket_of, pad_to_bucket,
                       records_from_stats, solve_fixed_batch)
from . import aot
from .discretize import Discretizer
from .engine import AutotuneEngine
from .env import GMRESIREnv
from .executor import (LocalExecutor, LowerableCall, ShardedExecutor,
                       SolveExecutor, available_executors, computation_key,
                       default_executor, executor_compile_count,
                       executor_compile_log, register_executor,
                       resolve_executor, set_default_executor)
from .policy import PrecisionPolicy
from .rewards import (RewardConfig, W1, W2, accuracy_term, penalty_term,
                      precision_term, reward, reward_batch)
from .task import (CONVERGED, FAILED, MAXITER, STAGNATED, Outcome,
                   TunableTask, coerce_task, is_tunable_task)

__all__ = [
    "ActionSpace", "fp8_reduced_action_space", "full_action_space",
    "is_monotone", "reduced_action_space", "reduced_size",
    "TrainConfig", "TrainHistory", "as_engine", "evaluate_fixed_action",
    "evaluate_policy", "policy_from_reference", "train_policy",
    "QTable", "epsilon_schedule", "Discretizer", "AutotuneEngine",
    "GMRESIREnv",
    "SolveRecord", "bucket_of", "pad_to_bucket", "records_from_stats",
    "solve_fixed_batch", "PrecisionPolicy",
    "RewardConfig", "W1", "W2", "accuracy_term", "penalty_term",
    "precision_term", "reward", "reward_batch", "Outcome", "TunableTask",
    "coerce_task", "is_tunable_task", "CONVERGED", "STAGNATED", "MAXITER",
    "FAILED", "LocalExecutor", "LowerableCall", "ShardedExecutor",
    "SolveExecutor",
    "resolve_executor", "default_executor", "set_default_executor",
    "register_executor", "available_executors", "aot",
    "computation_key", "executor_compile_count", "executor_compile_log",
]
