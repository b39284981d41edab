"""CG-IR as a `TunableTask` (port of `repro.tasks.cg_ir`): the same
bandit and engine as GMRES-IR; only the batched solver and the work
metric differ. Intended for SPD systems (`data.matrices.sparse_spd`);
on indefinite matrices the CG recurrence breaks down and the reward's
failure path takes over.

`solve_rows` stacks the rows of one bucket and dispatches them through
the task's executor as one `solvers.cg_ir_batch` program on the task's
device (`lowerable_for`, the call AOT warmup prepares) under
`solver_cfg_for(cg_cfg, n_pad)`: buckets at or above
`cg_cfg.blocking.min_n` factor with the blocked LU and apply the
preconditioner with the blocked trisolve (DESIGN.md §6.4).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.action_space import ActionSpace
from repro_torch.core.task import Outcome
from repro_torch.data.matrices import LinearSystem
from repro_torch.solvers.cg import CGConfig, cg_ir_batch_lowerable
from repro_torch.tasks.base import LinearSystemTask, stack_fixed


class CGIRTask(LinearSystemTask):
    name = "cg_ir"
    inner_iter_metric = "n_cg"

    def __init__(self, systems: Sequence[LinearSystem] = (),
                 action_space: Optional[ActionSpace] = None,
                 cg_cfg: CGConfig = CGConfig(),
                 bucket_step: int = 128, min_bucket: int = 128,
                 device=None, tune_blocking: bool = False,
                 carrier_dtype=None, executor=None):
        super().__init__(systems, action_space, bucket_step, min_bucket,
                         device=device, tune_blocking=tune_blocking,
                         carrier_dtype=carrier_dtype, executor=executor)
        self.cg_cfg = cg_cfg

    def solve_rows(self, rows, action_rows: Sequence[np.ndarray],
                   chunk: int) -> List[Outcome]:
        A, b, x, acts, k = stack_fixed(rows, action_rows, len(rows))
        stats = self.executor.dispatch(self.lowerable_for(A.shape[-1]),
                                       (A, b, x, acts), A.shape[-1])
        # One copy to the host for the float fields; the counts are
        # host tensors already.
        ferr, nbe, res = torch.stack((stats.ferr, stats.nbe,
                                      stats.res_norm)).cpu().numpy()
        n_outer, n_cg, status = (f.numpy() for f in (
            stats.n_outer, stats.n_cg, stats.status))
        return [Outcome(status=int(status[j]), cost=float(n_cg[j]),
                        metrics={"ferr": float(ferr[j]),
                                 "nbe": float(nbe[j]),
                                 "n_outer": int(n_outer[j]),
                                 "n_cg": int(n_cg[j]),
                                 "res_norm": float(res[j])})
                for j in range(k)]

    def lowerable_for(self, n_pad: int):
        """The (cfg, device, carrier)-keyed call `solve_rows` dispatches
        through, so warmup prepares the dispatcher live traffic finds."""
        return cg_ir_batch_lowerable(
            self.solver_cfg_for(self.cg_cfg, int(n_pad)), self.device,
            self.carrier_dtype)
