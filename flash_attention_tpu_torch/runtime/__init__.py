"""Paged KV cache (native page allocator) and the continuous-batching
serving engine."""
