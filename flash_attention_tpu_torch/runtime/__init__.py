"""Paged KV caches (native page allocator) and the continuous-batching
serving engine."""

from flash_attention_tpu_torch.runtime.allocator import make_allocator
from flash_attention_tpu_torch.runtime.engine import (
    Completion,
    Engine,
    Request,
)
from flash_attention_tpu_torch.runtime.kv_cache import (
    LayeredPagedKVCache,
    PagedKVCache,
)

__all__ = [
    "make_allocator",
    "Completion",
    "Engine",
    "Request",
    "LayeredPagedKVCache",
    "PagedKVCache",
]
