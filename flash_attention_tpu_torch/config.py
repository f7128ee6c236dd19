"""Shape helpers, kernel limits and device resolution for the CUDA port.

The JAX package searches block sizes against the TPU's VMEM budget
(`flash_attention_tpu/config.py`). On Hopper the kernels use fixed tiles
sized to shared memory and registers instead (compile-time constants of
csrc/*.cu: B1 128 q rows by 128 kv rows, 64 x 64 at D = 256; B2 128 q
rows a block against kv tiles of 64, B3 128 kv rows a block against q
tiles of 64, both 64 rows a block at D = 256 (fp32: 64-row tiles, 32
above D = 64); B4 and B5 256 threads per (sequence, kv head) over groups
of at most 16 query rows); what the Python wrappers
must check against is mirrored here, and `select_block_sizes` returns
B1's tile.
"""

from __future__ import annotations

import dataclasses

import torch

SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)

# The JAX package's lane width (its tiles and the FA1 tile law round to
# it); the study kernels' plain versions clamp block sizes by it as the
# JAX kernels do.
LANES = 128


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Query and key/value tile rows of a forward kernel (the JAX
    package's `BlockSizes` keyword, forward fields only: B2 / B3 have
    fixed tiles). On the CPU the plain versions tile by them, or are
    untiled (B1); on the card a kernel takes only the tiles it was
    compiled for and raises ValueError for others."""
    block_q: int = 64
    block_kv: int = 64


def b1_tile(dtype, head_dim: int) -> tuple[int, int]:
    """(block_q, block_kv) of B1 as compiled (csrc/flash_fwd.cuh Cfg,
    csrc/flash_fwd_f32.cu Smem32): fp16 / bf16 128 x 128, 64 x 64 at
    D = 256; fp32 64 x 64, 32 x 64 at D = 256."""
    if dtype == torch.float32:
        return (32, 64) if head_dim > 128 else (64, 64)
    return (64, 64) if head_dim > 128 else (128, 128)


def select_block_sizes(seq_q: int, seq_kv: int, head_dim: int, *,
                       dtype=torch.bfloat16, causal: bool = False,
                       vmem_budget=None, candidates=None) -> BlockSizes:
    """B1's tile for this dtype and head dim (`b1_tile`), so that passing
    it back as `block_sizes=` works on the card. The JAX package's
    signature; its search of a TPU's VMEM budget has no counterpart on
    this card, where the tile is fixed when the kernel is compiled, so
    the lengths, `causal`, `vmem_budget` and `candidates` are not
    read."""
    return BlockSizes(*b1_tile(dtype, head_dim))

# Head dims the CUDA kernels are instantiated for (csrc/*.cu): all of
# them.
CUDA_HEAD_DIMS = SUPPORTED_HEAD_DIMS


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def resolve_device(device) -> torch.device:
    """The port's entry points run on the card unless the caller names
    the CPU. A CUDA device on a host without one raises; nothing falls
    back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev
