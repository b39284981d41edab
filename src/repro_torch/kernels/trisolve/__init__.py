from .ops import ROUTES, trisolve_op, trisolve_route
from .ref import identity_pad, pad_unit, trisolve_ref

__all__ = ["ROUTES", "identity_pad", "pad_unit", "trisolve_op",
           "trisolve_ref", "trisolve_route"]
