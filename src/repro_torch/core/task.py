"""Solver-agnostic `TunableTask` API.

The paper claims the contextual-bandit autotuner "can be extended to
general algorithms"; this module is that claim as an interface. A task
packages everything algorithm-specific — its instances, per-instance
features, the precision `ActionSpace`, a batched solver, and a reward
hook — behind a small protocol, so one `AutotuneEngine` (`core.engine`)
can train any algorithm. A copy of `repro.core.task`.

This module is deliberately dependency-light: numpy only, no solver
imports. Concrete tasks live in `repro_torch.tasks` and bind the solver
substrate (`repro_torch.solvers`) to this interface.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Dict, List, Protocol, Sequence,
                    runtime_checkable)

import numpy as np

# Outcome status codes — every solver in repro_torch.solvers follows this
# convention, so tasks can translate stats to Outcomes without mapping.
CONVERGED, STAGNATED, MAXITER, FAILED = 0, 1, 2, 3


def bucket_of(n: int, step: int = 128, minimum: int = 128) -> int:
    """Smallest multiple of `step` (floored at `minimum`) that holds n."""
    return max(minimum, ((n + step - 1) // step) * step)


@dataclasses.dataclass
class Outcome:
    """Host-side result of applying one action to one instance.

    Generalizes the GMRES-IR `SolveRecord`: `status` uses the shared
    status codes above, `cost` is the task's scalar work measure (e.g.
    total inner solver iterations), and `metrics` carries every
    task-specific scalar (ferr, nbe, iteration counts, ...). Metrics
    are also readable as attributes (``outcome.ferr``), which keeps
    `SolveRecord`-era call sites working unchanged.
    """
    status: int
    cost: float
    metrics: Dict[str, float]

    def __getattr__(self, name: str):
        # Guard dunders and `metrics` itself: during unpickling/copy the
        # instance exists before `metrics` is set, and falling through to
        # `self.metrics` would recurse into this method forever.
        if name.startswith("__") or name == "metrics":
            raise AttributeError(name)
        try:
            return self.metrics[name]
        except KeyError:
            raise AttributeError(
                f"Outcome has no field or metric {name!r}") from None

    @property
    def ok(self) -> bool:
        return int(self.status) != FAILED


@runtime_checkable
class TunableTask(Protocol):
    """What the autotuning engine and server need from an algorithm.

    Attributes
    ----------
    name : str
        Stable identifier (telemetry, registries, benchmark rows).
    action_space : ActionSpace
        The joint precision action space the bandit selects from.
    instances : Sequence
        Training/evaluation instances (may be empty for serving-only
        tasks — the online server streams instances through
        `feature_of`/`prepare`/`solve_rows` without an instance set).
    features : np.ndarray
        (len(instances), d) context-feature matrix.
    """

    name: str
    action_space: Any
    instances: Sequence[Any]

    @property
    def features(self) -> np.ndarray: ...

    def feature_of(self, instance) -> np.ndarray:
        """Context-feature vector for one instance."""
        ...

    def bucket_key(self, instance) -> int:
        """Shape-bucket key: instances sharing a key are padded to one
        size and solved together."""
        ...

    def prepare(self, instance):
        """Device-ready padded row(s) for one instance (cacheable)."""
        ...

    def solve_rows(self, rows: Sequence, action_rows: Sequence,
                   chunk: int) -> List[Outcome]:
        """Batch-apply `action_rows[i]` to prepared `rows[i]`.

        All rows share one bucket; at most `chunk` rows come per call.
        Returns one `Outcome` per input row.
        """
        ...

    def reward(self, outcome: Outcome, action_idx: int, instance,
               cfg) -> float:
        """Scalar reward for `outcome` under reward config `cfg`."""
        ...


def is_tunable_task(obj) -> bool:
    """Structural check (protocol isinstance is unreliable for
    non-method members)."""
    return all(callable(getattr(obj, m, None)) for m in
               ("feature_of", "bucket_key", "prepare", "solve_rows",
                "reward"))


def coerce_task(obj, *, action_space=None, bucket_step=None,
                min_bucket=None):
    """Return `obj` if it already implements `TunableTask`; otherwise
    adapt a solver-config object (an `IRConfig`, a `CGConfig`, or None
    for the default) via `repro_torch.tasks.adapt_legacy`.

    The import is deferred so this module — and everything built only
    on the protocol, like `core.engine` — stays free of solver
    dependencies.
    """
    if obj is not None and is_tunable_task(obj):
        return obj
    from repro_torch import tasks  # deferred: binds solver adapters
    return tasks.adapt_legacy(obj, action_space=action_space,
                              bucket_step=bucket_step,
                              min_bucket=min_bucket)
