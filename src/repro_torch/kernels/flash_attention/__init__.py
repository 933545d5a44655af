from .kernel import flash_attention_fwd
from .ref import attention_ref, attention_with_lse_ref, lse_ref

__all__ = ["attention_ref", "attention_with_lse_ref", "flash_attention_fwd",
           "lse_ref"]
