"""Mixed-precision linear-solver substrate of the torch port (GMRES-IR and
CG-IR)."""
from .block_autotune import sweep_lu_block, tuned_blocking
from .blocking import (DEFAULT_BLOCKING, STRICT_ONLY, BlockingPolicy,
                       resolve_blocking)
from .cg import (CGConfig, CGStats, PCGResult, cg_ir, cg_ir_batch,
                 cg_ir_batch_lowerable, pcg)
from .gmres import GMRESResult, chop_mv, gmres_precond
from .ir import (CONVERGED, FAILED, MAXITER, STAGNATED, IRConfig, SolveStats,
                 gmres_ir, gmres_ir_batch, gmres_ir_batch_lowerable)
from .lu import LUFactors, lu_factor, lu_factor_auto, lu_factor_blocked
from .metrics import (CONDITION_RANGES, bucket_by_condition, eps_max,
                      success_rate, summarize)
from .triangular import lu_solve, solve_unit_lower, solve_upper

__all__ = [
    "GMRESResult", "chop_mv", "gmres_precond", "IRConfig", "SolveStats",
    "gmres_ir", "gmres_ir_batch", "gmres_ir_batch_lowerable", "CGConfig",
    "CGStats", "PCGResult", "pcg", "cg_ir", "cg_ir_batch",
    "cg_ir_batch_lowerable", "LUFactors", "lu_factor",
    "lu_factor_auto", "lu_factor_blocked", "lu_solve",
    "solve_unit_lower", "solve_upper",
    "BlockingPolicy", "DEFAULT_BLOCKING", "STRICT_ONLY", "resolve_blocking",
    "sweep_lu_block", "tuned_blocking",
    "CONVERGED", "STAGNATED", "MAXITER", "FAILED",
    "CONDITION_RANGES", "bucket_by_condition", "eps_max", "success_rate",
    "summarize",
]
