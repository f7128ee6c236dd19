"""One-token decode attention over contiguous caches (port of
`flash_attention_tpu/ops/decode.py`).

`flash_decode` launches the hand-written CUDA kernel `csrc/decode.cu`
(B5, the port of the Pallas `_decode_kernel`) on CUDA tensors and runs
`flash_decode_plain`, the same function in plain PyTorch, on CPU
tensors. A CUDA tensor launches the kernel or raises.

q: [B, Hq, D], one new query per sequence; k, v: [B, Hkv, S, D] dense
caches, or both `QuantizedTensor`s (int8 / fp8 codes with fp32 scales
[B, Hkv, S/128, D]; S a multiple of 128); lengths: [B] live positions
per sequence. The GQA group of each kv head is read together, so each
cached row is read once. With a sliding window only positions >=
lengths[b] - window are visible (and read). A quantized cache is
widened in the kernel: each code times its block's scale in fp32,
rounded to q's dtype before the product (the JAX kernel's `_dequant`).
"""

from __future__ import annotations

import math

import torch

from flash_attention_tpu_torch.config import CUDA_HEAD_DIMS
from flash_attention_tpu_torch.ops import _cuda
from flash_attention_tpu_torch.ops.flash import INIT_M, acc_dtype
from flash_attention_tpu_torch.ops.quant import (
    QUANT_BLOCK,
    QuantizedTensor,
    check_quant_cuda,
    dequantize_kv,
    split_kv,
)

# Launches of the B5 kernel (incremented only where it is launched), and
# of those, the launches that took its window branch and those over
# quantized caches.
decode_launches = 0
decode_window_launches = 0
decode_quant_launches = 0
# Launches of B5 with an fp32 q (dense fp32 caches or any quantized
# storage; also counted in decode_launches).
decode_fp32_launches = 0


def masked_softmax(s, lengths, starts=None, qpos_spread=1):
    """Scaled scores s [B, Hkv, R, S] -> (p, l, lse): probabilities over
    positions < lengths[b] (and, with window starts, >= starts[b] + (r %
    qpos_spread) for row r) against the row max, their sum l [..., 1]
    and the LSE [..., 1] (INIT_M / scale-free: the caller substitutes
    INIT_M * scale where l == 0). The softmax of B4's and B5's plain
    versions."""
    col = torch.arange(s.shape[-1], device=s.device)
    bad = col >= lengths.long().to(s.device)[:, None, None, None]
    if starts is not None:
        row = torch.arange(s.shape[2], device=s.device) % qpos_spread
        lo = starts.long().to(s.device)[:, None, None, None] \
            + row[None, None, :, None]
        bad = bad | (col < lo)
    s = s.masked_fill(bad, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    return p, l, m_safe + torch.log(l_safe)


def finish_rows(o, l, lse, shape, dtype, scale, return_lse):
    """Normalise the PV sums o by l (a row that sees nothing gives O = 0
    and LSE = INIT_M * scale) and reshape to [B, Hq, D] in `dtype`."""
    o = (o / torch.where(l > 0, l, torch.ones_like(l))).reshape(shape)
    o = o.to(dtype)
    if not return_lse:
        return o
    lse = torch.where(l > 0, lse, torch.full_like(l, INIT_M * scale))
    return o, lse.reshape(shape[:2])


def flash_decode_plain(q, k, v, lengths, *, scale, return_lse=False,
                       starts=None, qpos_spread=1):
    """B5's function in plain PyTorch: fp32 scores and softmax over
    positions < lengths[b], probabilities rounded to v's dtype for the PV
    product (the JAX kernels' numerics; the CUDA kernels take q, k and v
    of one dtype). With `starts` [B] (window starts, may be negative)
    row r of each kv head's group sees only positions >= starts[b] + (r
    % qpos_spread). Returns o [B, Hq, D] in q's dtype, or (o, lse [B, Hq]
    fp32) with return_lse; a row that sees nothing gives O = 0 and LSE =
    INIT_M * scale. Quantized caches are dequantized to q's dtype first
    (flash_decode). fp64 inputs compute in fp64 (the reference of the
    fp32 kernels' gate on the card)."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    acc = acc_dtype(q.dtype)
    qg = q.reshape(b, hkv, hq // hkv, d).to(acc)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.to(acc)) * scale
    p, l, lse = masked_softmax(s, lengths, starts, qpos_spread)
    o = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).to(acc), v.to(acc))
    return finish_rows(o, l, lse, q.shape, q.dtype, scale, return_lse)


def _check_decode_cuda(q, k, v, lengths, *, k_scales, v_scales) -> int:
    """What B5 takes (it launches nothing): an fp16 / bf16 / fp32 q over
    caches of its dtype or over int8 / fp8 codes with fp32 scales, a
    built head dim, int32 lengths, one device, contiguous. Returns the
    storage code (csrc/common.cuh)."""
    if k_scales is not None:
        if q.dtype not in _cuda.DTYPE_CODES:
            raise TypeError(f"B5 takes an fp16/bf16/fp32 q (got "
                            f"{q.dtype})")
        store = check_quant_cuda("B5", (k, v), (k_scales, v_scales))
    elif q.dtype not in _cuda.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"B5 takes fp16/bf16/fp32 q and caches of one "
                        f"dtype (got {q.dtype}, {k.dtype}, {v.dtype})")
    else:
        store = 0
    if q.shape[-1] not in CUDA_HEAD_DIMS:
        raise NotImplementedError(
            f"B5 is built for head dims {CUDA_HEAD_DIMS}, got "
            f"{q.shape[-1]}")
    if lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return store


def _flash_decode_cuda(q, k, v, lengths, *, scale, window=None,
                       k_scales=None, v_scales=None):
    global decode_launches, decode_window_launches, decode_quant_launches
    global decode_fp32_launches
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    quantized = k_scales is not None
    store = _check_decode_cuda(q, k, v, lengths, k_scales=k_scales,
                               v_scales=v_scales)
    o = torch.empty_like(q)
    if b == 0:
        return o
    code = _cuda.lib().fa_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None, lengths.data_ptr(),
        o.data_ptr(), b, hq, hkv, s, d, int(window or 0), scale,
        _cuda.DTYPE_CODES[q.dtype], store, _cuda.stream_handle(q.device))
    decode_launches += 1
    decode_window_launches += window is not None
    decode_quant_launches += quantized
    decode_fp32_launches += q.dtype == torch.float32
    _cuda.check(code, "decode")
    return o


def flash_decode(q, k, v, lengths, *, scale=None, window=None):
    """Single-step decode attention.

    q: [B, Hq, D]; k, v: [B, Hkv, S, D] bf16/fp16 caches (fp32 on the
    CPU) or both QuantizedTensor (int8 / fp8 codes, fp32 scales [B, Hkv,
    S/128, D]); lengths: [B] int32 live prefix per sequence (<= S);
    window: attend only positions >= lengths[b] - window (Mistral-style
    local attention; older chunks are not read). Returns [B, Hq, D] in
    q's dtype. The TPU kernel's `block_kv` has no counterpart: B5 walks
    the prefix in chunks of 256 positions.
    """
    if window is not None and window < 1:
        raise ValueError("window must be >= 1")
    kv, vv, ks, vs = split_kv(k, v)
    b, hq, d = q.shape
    _, hkv, s, _ = kv.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if vv.shape != kv.shape or kv.shape[0] != b or kv.shape[3] != d \
            or lengths.shape != (b,):
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(kv.shape)} v {tuple(vv.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    if ks is not None:
        want = (b, hkv, s // QUANT_BLOCK, d)
        if s % QUANT_BLOCK or tuple(ks.shape) != want \
                or tuple(vs.shape) != want:
            raise ValueError(f"quantized caches need S % {QUANT_BLOCK} == 0 "
                             f"and scales {want}, got S={s}, "
                             f"{tuple(ks.shape)} / {tuple(vs.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.is_cuda:
        return _flash_decode_cuda(q, kv, vv, lengths, scale=float(scale),
                                  window=window, k_scales=ks, v_scales=vs)
    if q.device.type == "cpu":
        if ks is not None:
            kv, vv = dequantize_kv(k, q.dtype), dequantize_kv(v, q.dtype)
        starts = None if window is None else lengths - window
        return flash_decode_plain(q, kv, vv, lengths, scale=float(scale),
                                  starts=starts)
    raise ValueError(f"unsupported device {q.device}")


def decode_reference(q, k, v, lengths, *, scale=None, window=None):
    """Exact decode reference: positions >= lengths[b] (and, with a
    window, positions < lengths[b] - window) masked, fp32 softmax, output
    in q's dtype. A length-0 row gives O = 0 here, where the JAX
    reference's softmax over nothing gives NaN. Quantized caches are
    dequantized to fp32 first."""
    split_kv(k, v)
    if isinstance(k, QuantizedTensor):
        k, v = (dequantize_kv(t, torch.float32) for t in (k, v))
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kk = torch.repeat_interleave(k.float(), hq // hkv, dim=1)
    vv = torch.repeat_interleave(v.float(), hq // hkv, dim=1)
    sc = torch.einsum("bhd,bhsd->bhs", q.float(), kk) * scale
    pos = torch.arange(s, device=q.device)[None, None, :]
    lens = lengths.long()[:, None, None]
    bad = pos >= lens
    if window is not None:
        bad = bad | (pos < lens - window)
    sc = sc.masked_fill(bad, float("-inf"))
    p = torch.softmax(sc, dim=-1).nan_to_num(0.0)
    return torch.einsum("bhs,bhsd->bhd", p, vv).to(q.dtype)


def decode_cost(lengths, hq, hkv, d, itemsize, window=None,
                kv_itemsize=None):
    """(flops, bytes) B5 must do at least for these lengths: each
    visible position's K and V rows (the last `window` of them under a
    window) read once per kv head, q and the lengths read once, O
    written once. With `kv_itemsize` (1 for int8 / fp8 caches) the K/V
    rows count at that width, plus the fp32 scale row of every 128-token
    block that holds a visible position."""
    spans = [(0 if window is None else max(int(x) - window, 0), int(x))
             for x in lengths]
    tokens = sum(hi - lo for lo, hi in spans)
    b = len(lengths)
    flops = 4 * hq * tokens * d
    nbytes = 2 * b * hq * d * itemsize + 4 * b
    if kv_itemsize is None:
        nbytes += 2 * hkv * tokens * d * itemsize
    else:
        blocks = sum(-(-hi // QUANT_BLOCK) - lo // QUANT_BLOCK
                     for lo, hi in spans if hi > lo)
        nbytes += 2 * hkv * d * (tokens * kv_itemsize + 4 * blocks)
    return flops, nbytes
