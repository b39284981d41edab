"""Concrete `TunableTask`s of the torch port: GMRES-IR and CG-IR.

`adapt_legacy` coerces a bare solver config (an `IRConfig` or a
`CGConfig`, or None for the GMRES-IR default) into a task;
`core.task.coerce_task` defers here so the engine never imports a
solver."""
from __future__ import annotations

from .base import LinearSystemTask
from .cg_ir import CGIRTask
from .gmres_ir import GMRESIRTask, outcome_of_record


def adapt_legacy(obj=None, *, action_space=None, bucket_step=None,
                 min_bucket=None):
    """Adapt a solver-config object (an `IRConfig`, a `CGConfig`, or None
    for the default) into a `TunableTask` on the default device."""
    from repro_torch.solvers.cg import CGConfig
    from repro_torch.solvers.ir import IRConfig
    kw = dict(action_space=action_space,
              bucket_step=bucket_step if bucket_step is not None else 128,
              min_bucket=min_bucket if min_bucket is not None else 128)
    if obj is None:
        return GMRESIRTask(**kw)
    if isinstance(obj, IRConfig):
        return GMRESIRTask(ir_cfg=obj, **kw)
    if isinstance(obj, CGConfig):
        return CGIRTask(cg_cfg=obj, **kw)
    raise TypeError(f"cannot adapt {type(obj).__name__} into a TunableTask; "
                    "pass a TunableTask, an IRConfig, or a CGConfig")


__all__ = ["LinearSystemTask", "GMRESIRTask", "CGIRTask", "adapt_legacy",
           "outcome_of_record"]
