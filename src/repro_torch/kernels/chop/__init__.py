from .ops import (BLOCK_MAX, ROUTES, chop_expr_op, chop_op, chop_route,
                  chop_sr_op)
from .ref import ARITY, FORMS, chop_expr_ref, chop_ref, chop_sr_ref

__all__ = ["chop_op", "chop_ref", "chop_expr_op", "chop_expr_ref",
           "chop_route", "chop_sr_op", "chop_sr_ref", "FORMS", "ARITY",
           "ROUTES", "BLOCK_MAX"]
