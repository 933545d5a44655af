from .kernel import fused_ce, fused_ce_bwd
from .ops import fused_ce_op
from .ref import ce_bwd_ref, ce_ref, ce_rows_ref

__all__ = ["ce_bwd_ref", "ce_ref", "ce_rows_ref", "fused_ce", "fused_ce_bwd", "fused_ce_op"]
