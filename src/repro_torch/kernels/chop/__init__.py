from .ops import chop_op
from .ref import chop_ref

__all__ = ["chop_op", "chop_ref"]
