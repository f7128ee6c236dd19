"""Shape helpers, kernel limits and device resolution for the CUDA port.

The JAX package searches block sizes against the TPU's VMEM budget
(`flash_attention_tpu/config.py`). On Hopper the kernels use fixed tiles
sized to shared memory and registers instead (compile-time constants of
csrc/*.cu: B1, B2 and B3 64-row q and kv tiles, B4 256 threads per
(sequence, kv head)); what the Python wrappers must check against is
mirrored here.
"""

from __future__ import annotations

import torch

SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)

# Head dims the CUDA kernels are instantiated for (csrc/*.cu).
CUDA_HEAD_DIMS = (64, 128)

# B4 (csrc/paged_decode.cu) takes at most this many query rows (GQA
# group x folded positions) per (sequence, kv head) block.
PAGED_MAX_ROWS = 16


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
