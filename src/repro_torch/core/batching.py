"""Size-bucketing, padding and the batch-solve layer (port of
`repro.core.batching`).

Systems are identity-padded to a size bucket (solution preserving, see
`data.matrices.pad_system`), stacked, moved to the task's device in one
copy and solved by `solvers.gmres_ir_batch`: one batched, masked program
over the rows, each under its own action, every launch covering every
row (`solvers.ir`). The rows are the live ones only: nothing is padded to
a fixed batch size yet (the JAX package's `stack_fixed` and its
lowerable batch programs come with AOT warmup). Buckets at or above
`ir_cfg.blocking.min_n` run the blocked LU and trisolve (DESIGN.md §6.4).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.core.task import bucket_of
from repro_torch.solvers.ir import IRConfig, gmres_ir_batch

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
                      carrier_dtype=None) -> List[SolveRecord]:
    """One `gmres_ir_batch` call over already-padded rows that share one
    padded size (on `device`, in `carrier_dtype` on the CPU). Returns one
    SolveRecord per row."""
    A = np.stack(A_rows)
    b = np.stack(b_rows)
    x = np.stack(x_rows)
    acts = np.stack([np.asarray(a, np.int32) for a in action_rows])
    stats = gmres_ir_batch(A, b, x, acts, ir_cfg, device=device,
                           carrier_dtype=carrier_dtype)
    return records_from_stats(stats, len(A_rows))
