from .ops import qgemm_op, qmatmul_op, qmv_op
from .ref import LANE, qgemm_ref, qmatmul_ref, qmatmul_ref_blocked, qmv_ref

__all__ = ["LANE", "qgemm_op", "qgemm_ref", "qmatmul_op", "qmatmul_ref",
           "qmatmul_ref_blocked", "qmv_op", "qmv_ref"]
