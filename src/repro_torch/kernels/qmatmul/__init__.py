from .ops import QMV_ROUTES, ROUTES, qgemm_op, qmatmul_op, qmv_op, qmv_route
from .ref import (LANE, pack_ref, qgemm_ref, qmatmul_ref, qmatmul_ref_blocked,
                  qmv_ref)

__all__ = ["LANE", "QMV_ROUTES", "ROUTES", "pack_ref", "qgemm_op", "qgemm_ref",
           "qmatmul_op", "qmatmul_ref", "qmatmul_ref_blocked", "qmv_op",
           "qmv_ref", "qmv_route"]
