from .ops import FlashAttentionFn, flash_attention, flash_attention_bwd
from .ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["FlashAttentionFn", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_attention_ref"]
