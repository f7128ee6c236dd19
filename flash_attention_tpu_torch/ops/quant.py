"""Weight storage types and their widening (port of the weight part of
`flash_attention_tpu/ops/quant.py`).

The JAX package widens fp8 codes with an integer bit-plant
(`tile_to_f32`, `tile_to_bf16`) because its TPU has no fp8 units. Torch
has the two fp8 formats as dtypes, and the card converts them natively
(`__nv_fp8_e4m3` / `__nv_fp8_e5m2` in `csrc/quant_matmul.cu`): both are
bit-exact with the bit-plant on every finite code, subnormals included.

NaN and inf codes differ on purpose: the bit-plant decodes them as large
finite values, torch and the card as NaN / inf. Quantization never emits
them (`quantize_weight` clips to the finite maximum), so no weight holds
one.

The quantized KV cache (`QuantizedTensor`, `quantize_kv`,
`dequantize_kv`) arrives with the quantized-KV slice.
"""

from __future__ import annotations

import torch

# Largest finite magnitude per weight storage dtype.
_QMAX = {
    torch.int8: 127.0,
    torch.float8_e4m3fn: 448.0,
    torch.float8_e5m2: 57344.0,
}


def tile_to_f32(tile: torch.Tensor) -> torch.Tensor:
    """Widen an int8 / fp8 tensor to float32 (exact on every int8 value
    and every finite fp8 code)."""
    if tile.dtype not in _QMAX:
        raise TypeError(f"expected int8 or fp8 storage, got {tile.dtype}")
    return tile.float()


def widen_scaled(codes: torch.Tensor, scale: torch.Tensor,
                 dtype) -> torch.Tensor:
    """codes (int8 / fp8 values, or int4 nibbles unpacked to int8) times
    `scale` (broadcast) in fp32, rounded once to `dtype`: the
    dequantization of every quantized weight. int8 codes take one pass
    (torch multiplies in fp32 and rounds on the store); fp8 codes widen
    first, as torch does not promote fp8."""
    if codes.dtype != torch.int8:
        codes = tile_to_f32(codes)
    scale = scale.float()
    out = torch.empty(torch.broadcast_shapes(codes.shape, scale.shape),
                      dtype=dtype, device=codes.device)
    return torch.mul(codes, scale, out=out)


def tile_to_bf16(tile: torch.Tensor) -> torch.Tensor:
    """Widen to bfloat16; exact, since every int8 value and every finite
    e4m3 / e5m2 value is a bfloat16 number."""
    return tile_to_f32(tile).to(torch.bfloat16)
