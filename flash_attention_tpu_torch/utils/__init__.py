"""Error metrics and weight conversion."""

from flash_attention_tpu_torch.utils.data import (
    BatchLoader,
    TokenShardDataset,
    write_token_shard,
)
from flash_attention_tpu_torch.utils.metrics import (
    VerifyReport,
    max_abs_error,
    symmetric_relative_error,
    verify,
)

__all__ = [
    "BatchLoader",
    "TokenShardDataset",
    "write_token_shard",
    "symmetric_relative_error",
    "max_abs_error",
    "verify",
    "VerifyReport",
]
