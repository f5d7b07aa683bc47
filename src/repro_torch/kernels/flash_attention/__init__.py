from .ops import flash_attention
from .ref import attention_reference, bf16_flash_limit

__all__ = ["flash_attention", "attention_reference", "bf16_flash_limit"]
