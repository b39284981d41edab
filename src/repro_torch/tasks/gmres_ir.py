"""GMRES-IR as a `TunableTask` — the paper's original workload (port of
`repro.tasks.gmres_ir`).

`solve_rows` calls `core.batching.solve_fixed_batch`, which dispatches
the rows of a chunk or a flush through the task's executor as one
`solvers.gmres_ir_batch` program on the task's device, and lifts each
`SolveRecord` into the solver-agnostic `Outcome`. `lowerable_for` gives
AOT warmup the same (cfg, device, carrier)-keyed call. Buckets at or above
`ir_cfg.blocking.min_n` (256 by default) factor with the blocked LU and
solve with the blocked trisolve (DESIGN.md §6.4), at the panel width
of `solver_cfg_for` (the startup sweep's when `tune_blocking` is on).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.action_space import ActionSpace
from repro_torch.core.batching import SolveRecord, solve_fixed_batch
from repro_torch.core.task import Outcome
from repro_torch.data.matrices import LinearSystem
from repro_torch.solvers.ir import IRConfig, gmres_ir_batch_lowerable
from repro_torch.tasks.base import LinearSystemTask


def outcome_of_record(rec: SolveRecord) -> Outcome:
    """Lift a GMRES-IR `SolveRecord` into a generic `Outcome`."""
    return Outcome(status=int(rec.status), cost=float(rec.n_gmres),
                   metrics={"ferr": float(rec.ferr), "nbe": float(rec.nbe),
                            "n_outer": int(rec.n_outer),
                            "n_gmres": int(rec.n_gmres),
                            "res_norm": float(rec.res_norm)})


class GMRESIRTask(LinearSystemTask):
    name = "gmres_ir"
    inner_iter_metric = "n_gmres"

    def __init__(self, systems: Sequence[LinearSystem] = (),
                 action_space: Optional[ActionSpace] = None,
                 ir_cfg: IRConfig = IRConfig(),
                 bucket_step: int = 128, min_bucket: int = 128,
                 device=None, tune_blocking: bool = False,
                 carrier_dtype=None, executor=None):
        super().__init__(systems, action_space, bucket_step, min_bucket,
                         device=device, tune_blocking=tune_blocking,
                         carrier_dtype=carrier_dtype, executor=executor)
        self.ir_cfg = ir_cfg

    def solve_rows(self, rows, action_rows: Sequence[np.ndarray],
                   chunk: int) -> List[Outcome]:
        cfg = self.solver_cfg_for(self.ir_cfg, rows[0][0].shape[-1])
        recs = solve_fixed_batch([r[0] for r in rows], [r[1] for r in rows],
                                 [r[2] for r in rows], action_rows, cfg,
                                 device=self.device,
                                 carrier_dtype=self.carrier_dtype,
                                 executor=self.executor)
        return [outcome_of_record(r) for r in recs]

    def lowerable_for(self, n_pad: int):
        """The (cfg, device, carrier)-keyed call `solve_rows` dispatches
        through, so warmup prepares the dispatcher live traffic finds."""
        return gmres_ir_batch_lowerable(
            self.solver_cfg_for(self.ir_cfg, int(n_pad)), self.device,
            self.carrier_dtype)
