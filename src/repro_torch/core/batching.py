"""Size-bucketing, padding and the batch-solve layer (port of
`repro.core.batching`).

Systems are identity-padded to a size bucket (solution preserving, see
`data.matrices.pad_system`), stacked, and dispatched through the task's
`SolveExecutor` (`core.executor`) as one `solvers.gmres_ir_batch`
program over the rows, each under its own action, every launch covering
every row (`solvers.ir`). The solver rides as a `LowerableCall`
(`gmres_ir_batch_lowerable`), which keys the dispatcher by value and
gives AOT warmup (`core.aot`, `tasks.base.precompile_bucket`) the very
dispatcher and cells a live batch runs through.

The rows are the live ones only: unlike the JAX package, a batch is not
padded to a fixed `chunk` (`tasks.base.stack_fixed`), since nothing here
compiles per shape and a padding row would add work to every launch.
Buckets at or above `ir_cfg.blocking.min_n` run the blocked LU and
trisolve (DESIGN.md §6.4).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.core.executor import resolve_executor
from repro_torch.core.task import bucket_of
from repro_torch.solvers.ir import IRConfig, gmres_ir_batch_lowerable

__all__ = ["SolveRecord", "bucket_of", "pad_to_bucket",
           "records_from_stats", "solve_fixed_batch"]


@dataclasses.dataclass
class SolveRecord:
    """Host-side scalar outcome of one (system, action) GMRES-IR solve."""
    ferr: float
    nbe: float
    n_outer: int
    n_gmres: int
    status: int
    res_norm: float


def pad_to_bucket(system, bucket_step: int = 128, minimum: int = 128):
    """(A, b, x) identity-padded to the system's size bucket."""
    from repro_torch.data.matrices import pad_system
    return pad_system(system, bucket_of(system.n, bucket_step, minimum))


def records_from_stats(stats, count: int) -> List[SolveRecord]:
    """First `count` rows of a batched SolveStats as host SolveRecords
    (one device-to-host copy per field)."""
    ferr, nbe, n_outer, n_gmres, status, res = (
        f.detach().cpu().numpy() for f in stats)
    return [SolveRecord(float(ferr[j]), float(nbe[j]), int(n_outer[j]),
                        int(n_gmres[j]), int(status[j]), float(res[j]))
            for j in range(count)]


def solve_fixed_batch(A_rows: Sequence[np.ndarray],
                      b_rows: Sequence[np.ndarray],
                      x_rows: Sequence[np.ndarray],
                      action_rows: Sequence[np.ndarray],
                      ir_cfg: IRConfig, *, device=None,
                      carrier_dtype=None, executor=None
                      ) -> List[SolveRecord]:
    """One `gmres_ir_batch` dispatch over already-padded rows that share
    one padded size, on `device` (in `carrier_dtype`), through `executor`
    (None: the default, local). Returns one SolveRecord per row."""
    from repro_torch.tasks.base import stack_fixed
    rows = list(zip(A_rows, b_rows, x_rows))
    A, b, x, acts, k = stack_fixed(rows, action_rows, len(rows))
    stats = resolve_executor(executor).dispatch(
        gmres_ir_batch_lowerable(ir_cfg, device, carrier_dtype),
        (A, b, x, acts), A.shape[-1])
    return records_from_stats(stats, k)
