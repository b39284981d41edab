"""Deprecated GMRES-IR environment — thin shim over the TunableTask API
(port of `repro.core.env`).

`GMRESIREnv` predates the solver-agnostic redesign: it was a GMRES-only
fusion of what is now `tasks.gmres_ir.GMRESIRTask` (the algorithm) and
`core.engine.AutotuneEngine` (the cache + learning loop). It survives as
an engine subclass so historical call sites — `GMRESIREnv(systems,
space, ir_cfg)` into `train_policy` / `PolicyRegistry.warm_start` — keep
working. New code should build a task directly:

    task = GMRESIRTask(systems, space, ir_cfg)       # repro_torch.tasks
    policy, hist = train_policy(task, reward_cfg)    # same trainer

Like the task, it solves on CUDA unless `device="cpu"` is given, and on
the task's carrier (`carrier_dtype`).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

from repro_torch.core.action_space import ActionSpace
from repro_torch.core.engine import AutotuneEngine
from repro_torch.core.rewards import RewardConfig
from repro_torch.core.task import Outcome

if TYPE_CHECKING:   # data.matrices imports core.features, so core first
    from repro_torch.data.matrices import LinearSystem


class GMRESIREnv(AutotuneEngine):
    def __init__(self, systems: Sequence[LinearSystem],
                 action_space: ActionSpace, ir_cfg,
                 chunk: int = 32, bucket_step: int = 128,
                 device=None, carrier_dtype=None):
        # Deferred import keeps `repro_torch.core` importable before
        # `repro_torch.tasks` finishes initializing (and vice versa).
        from repro_torch.tasks.gmres_ir import GMRESIRTask
        task = GMRESIRTask(systems, action_space, ir_cfg,
                           bucket_step=bucket_step, device=device,
                           carrier_dtype=carrier_dtype)
        super().__init__(task, chunk=chunk)
        self.ir_cfg = ir_cfg

    # -- legacy accessors --------------------------------------------------
    @property
    def systems(self):
        return self.task.instances

    def record(self, i: int, a: int) -> Outcome:
        """Legacy name for `outcome` (the Outcome's metrics are readable
        as attributes, matching the old SolveRecord fields)."""
        return self.outcome(i, a)

    def reward(self, i: int, a: int, cfg: RewardConfig) -> float:
        return super().reward(i, a, cfg)
