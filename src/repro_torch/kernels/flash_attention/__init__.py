from .kernel import (flash_attention_bwd, flash_attention_bwd_dkv, flash_attention_bwd_dq,
                     flash_attention_fwd)
from .ops import flash_attention
from .ref import (attention_bwd_dkv_ref, attention_bwd_dq_ref, attention_bwd_ref,
                  attention_ref, attention_with_lse_ref, lse_ref)

__all__ = ["attention_bwd_dkv_ref", "attention_bwd_dq_ref", "attention_bwd_ref",
           "attention_ref", "attention_with_lse_ref", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_fwd", "lse_ref"]
