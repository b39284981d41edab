from .ops import qgemm_op, qmv_op
from .ref import LANE, qgemm_ref, qmv_ref

__all__ = ["LANE", "qgemm_op", "qgemm_ref", "qmv_op", "qmv_ref"]
