from .ops import HEAD_DIMS, ROUTES, WGMMA_BK, flash_attention_op
from .ref import NEG_INF, flash_ref

__all__ = ["HEAD_DIMS", "NEG_INF", "ROUTES", "WGMMA_BK",
           "flash_attention_op", "flash_ref"]
