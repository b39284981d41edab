from .ops import HEAD_DIMS, flash_attention_op
from .ref import NEG_INF, flash_ref

__all__ = ["HEAD_DIMS", "NEG_INF", "flash_attention_op", "flash_ref"]
