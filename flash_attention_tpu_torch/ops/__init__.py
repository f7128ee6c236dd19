"""Kernel wrappers (CUDA on the card, plain PyTorch on the CPU) and
exact attention references."""

from flash_attention_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_fwd,
)
from flash_attention_tpu_torch.ops.reference import (
    attention_baseline,
    attention_reference,
)

__all__ = [
    "attention_reference",
    "attention_baseline",
    "flash_attention",
    "flash_attention_fwd",
]
