from .ops import BLOCK_MAX, ROUTES, chop_expr_op, chop_op, chop_route
from .ref import ARITY, FORMS, chop_expr_ref, chop_ref

__all__ = ["chop_op", "chop_ref", "chop_expr_op", "chop_expr_ref",
           "chop_route", "FORMS", "ARITY", "ROUTES", "BLOCK_MAX"]
