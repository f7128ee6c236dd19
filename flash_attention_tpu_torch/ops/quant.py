"""Quantized storage: int8 / fp8 widening and the quantized KV cache (port
of `flash_attention_tpu/ops/quant.py`).

The JAX package widens fp8 codes with an integer bit-plant
(`tile_to_f32`, `tile_to_bf16`) because its TPU has no fp8 units. Torch
has the two fp8 formats as dtypes, and the card converts them natively
(`__nv_fp8_e4m3` / `__nv_fp8_e5m2`, `csrc/common.cuh` `widen`): both are
bit-exact with the bit-plant on every finite code, subnormals included.

NaN and inf codes differ on purpose: the bit-plant decodes them as large
finite values, torch and the card as NaN / inf. Quantization never emits
them (`quantize_weight` clips to the finite maximum), so no weight holds
one.

KV quantization (`quantize_kv`): scales per (head, 128-token block,
channel), so a token's append touches one scale row and RoPE's
per-channel spread gets its own scale. The order of operations is the
JAX package's, so the codes are bit-equal: the fp32 absmax over the
block, scale = max(absmax / qmax, 1e-8), x / scale, then for int8 round
half to even and clip to +-127, for fp8 a plain round-to-nearest cast.
"""

from __future__ import annotations

import dataclasses

import torch

from flash_attention_tpu_torch.ops import _cuda

QUANT_BLOCK = 128   # tokens per scale block

# Largest finite magnitude per storage dtype.
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


def quantize_blocks(xf: torch.Tensor, dtype, dim: int, *,
                    divide: bool = False):
    """Quantize fp32 `xf` in blocks along `dim` (each block already its
    own axis): returns (codes in `dtype` shaped as xf, scales with `dim`
    kept as size 1). The one quantizer of every KV path (quantize_kv,
    the paged caches' writes, flushes and quantize()).

    absmax / qmax is taken as absmax times the fp32 reciprocal of qmax,
    which is what XLA compiles that division into inside the JAX
    package's jitted quantizers; `divide` divides instead, as its eager
    PagedKVCache.quantize does. The two differ in the last bit of some
    scales, so each path takes its JAX counterpart's form."""
    qmax = _QMAX[dtype]
    absmax = xf.abs().amax(dim=dim, keepdim=True)
    ratio = (absmax / qmax if divide
             else absmax * torch.tensor(1.0 / qmax, dtype=torch.float32))
    scale = torch.clamp(ratio, min=1e-8)
    q = xf / scale
    if dtype == torch.int8:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q.to(dtype), scale


@dataclasses.dataclass
class QuantizedTensor:
    """values: [B, H, S, D] in int8 / fp8; scales: [B, H, S/QUANT_BLOCK,
    D] fp32 such that dequant(values)[b,h,s,d] = values * scales[b,h,
    s//128,d]."""

    values: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device


def quantize_kv(x: torch.Tensor, *, dtype=torch.int8) -> QuantizedTensor:
    """Quantize a [B, H, S, D] tensor to int8 / fp8 with block-channel
    scales. S must be a multiple of QUANT_BLOCK (pad the cache, not the
    data)."""
    b, h, s, d = x.shape
    if s % QUANT_BLOCK:
        raise ValueError(f"seq {s} must be a multiple of {QUANT_BLOCK}")
    if dtype not in _QMAX:
        raise TypeError(f"KV storage must be int8 or fp8, got {dtype}")
    xf = x.float().reshape(b, h, s // QUANT_BLOCK, QUANT_BLOCK, d)
    codes, scale = quantize_blocks(xf, dtype, 3)
    return QuantizedTensor(values=codes.reshape(b, h, s, d),
                           scales=scale[..., 0, :])


def dequantize_blocks(codes: torch.Tensor, scales: torch.Tensor,
                      dtype) -> torch.Tensor:
    """codes [..., nb, QUANT_BLOCK, D] times their block's scale row
    scales [..., nb, D] in fp32, rounded once to `dtype`: the one
    dequantization of quantized KV (caches, paged pools, flushes), and
    what every quantized kernel fuses."""
    return widen_scaled(codes, scales[..., None, :], dtype)


def dequantize_kv(qt: QuantizedTensor, dtype=torch.bfloat16):
    """A QuantizedTensor back to a dense [B, H, S, D] tensor in `dtype`
    (dequantize_blocks; the plain versions' first step)."""
    b, h, s, d = qt.values.shape
    codes = qt.values.reshape(b, h, s // QUANT_BLOCK, QUANT_BLOCK, d)
    return dequantize_blocks(codes, qt.scales, dtype).reshape(b, h, s, d)


def quantization_error(x: torch.Tensor, *, dtype=torch.int8) -> float:
    """Round-trip max-abs error of quantize_kv / dequantize_kv."""
    back = dequantize_kv(quantize_kv(x, dtype=dtype), dtype=torch.float32)
    return float((back - x.float()).abs().max())


def is_dense(t) -> bool:
    """A floating tensor wider than one byte (not int8 / fp8 codes)."""
    return isinstance(t, torch.Tensor) and t.dtype.is_floating_point \
        and t.element_size() > 1


def split_kv(k, v):
    """(k values, v values, k scales, v scales) of a dense pair (scales
    None) or a QuantizedTensor pair; a mixed pair raises ValueError, bare
    int8 / fp8 tensors (codes without their scales) TypeError."""
    quantized = isinstance(k, QuantizedTensor)
    if quantized != isinstance(v, QuantizedTensor):
        raise ValueError("k and v must both be quantized or both dense")
    if quantized:
        return k.values, v.values, k.scales, v.scales
    if not (is_dense(k) and is_dense(v)):
        raise TypeError(f"int8 / fp8 K/V come as QuantizedTensor (codes "
                        f"with their scales), got {k.dtype} / {v.dtype} "
                        f"tensors")
    return k, v, None, None


def check_quant_cuda(kernel, values, scales):
    """What a quantized CUDA branch takes: k and v codes of one int8 /
    fp8 storage, fp32 scales, all on one device, contiguous and 16-byte
    aligned. Returns the storage code (csrc/common.cuh)."""
    kv, vv = values
    store = _cuda.STORE_CODES.get(kv.dtype)
    if store is None or vv.dtype != kv.dtype:
        raise TypeError(f"{kernel} takes k and v codes of one int8 / fp8 "
                        f"storage (got {kv.dtype}, {vv.dtype})")
    dev = kv.get_device()   # an int: cheaper to compare than torch.device
    for name, t in (("k codes", kv), ("v codes", vv),
                    ("k scales", scales[0]), ("v scales", scales[1])):
        if name.endswith("scales") and t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} must be fp32, got {t.dtype}")
        if t.get_device() != dev or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be contiguous, "
                             f"16-byte aligned and on {kv.device}")
    return store
