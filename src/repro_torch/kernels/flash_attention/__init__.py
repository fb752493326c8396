from .ops import flash_attention, flash_attention_bwd  # noqa: F401
