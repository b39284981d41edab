from .ops import trisolve_op
from .ref import identity_pad, pad_unit, trisolve_ref

__all__ = ["identity_pad", "pad_unit", "trisolve_op", "trisolve_ref"]
