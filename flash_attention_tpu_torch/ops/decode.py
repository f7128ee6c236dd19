"""One-token decode attention over contiguous caches (port of
`flash_attention_tpu/ops/decode.py`).

`flash_decode` launches the hand-written CUDA kernel `csrc/decode.cu`
(B5, the port of the Pallas `_decode_kernel`) on CUDA tensors and runs
`flash_decode_plain`, the same function in plain PyTorch, on CPU
tensors. A CUDA tensor launches the kernel or raises.

q: [B, Hq, D], one new query per sequence; k, v: [B, Hkv, S, D] dense
caches; lengths: [B] live positions per sequence. The GQA group of each
kv head is read together, so each cached row is read once. The
quantized (int8 / fp8 `QuantizedTensor`) caches and the sliding window
arrive with the quantized-KV and window slices and raise until then.
"""

from __future__ import annotations

import math

import torch

from flash_attention_tpu_torch.config import CUDA_HEAD_DIMS, PAGED_MAX_ROWS
from flash_attention_tpu_torch.ops import _cuda
from flash_attention_tpu_torch.ops.flash import INIT_M

# Launches of the B5 kernel (incremented only where it is launched).
decode_launches = 0


def flash_decode_plain(q, k, v, lengths, *, scale, return_lse=False):
    """B5's function in plain PyTorch: fp32 scores and softmax over
    positions < lengths[b], probabilities rounded to q's dtype for the PV
    product (the kernel's numerics). Returns o [B, Hq, D] in q's dtype,
    or (o, lse [B, Hq] fp32) with return_lse; a length-0 row gives O = 0
    and LSE = INIT_M * scale. k and v may be any float dtype (the paged
    plain version hands over gathered fp32 copies)."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * scale
    col = torch.arange(s.shape[-1], device=s.device)
    s = s.masked_fill(col >= lengths.long()[:, None, None, None],
                      float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bhgs,bhsd->bhgd", p.to(q.dtype).float(),
                     v.float()) / l_safe
    o = o.reshape(b, hq, d).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(l > 0, m_safe + torch.log(l_safe),
                      torch.full_like(l, INIT_M * scale))
    return o, lse.reshape(b, hq)


def _flash_decode_cuda(q, k, v, lengths, *, scale):
    global decode_launches
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    if q.dtype not in _cuda.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"B5 takes fp16/bf16 q and caches of one dtype "
                        f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    if d not in CUDA_HEAD_DIMS:
        raise NotImplementedError(
            f"B5 is built for head dims {CUDA_HEAD_DIMS}, got {d}")
    if hq // hkv > PAGED_MAX_ROWS:
        raise NotImplementedError(
            f"B5 takes at most {PAGED_MAX_ROWS} query heads per kv head, "
            f"got {hq // hkv}")
    if lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    o = torch.empty_like(q)
    if b == 0:
        return o
    code = _cuda.lib().fa_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), b, hq, hkv, s, d, scale, _cuda.DTYPE_CODES[q.dtype],
        _cuda.stream_handle(q.device))
    decode_launches += 1
    _cuda.check(code, "decode")
    return o


def _is_dense(t) -> bool:
    return isinstance(t, torch.Tensor) and t.dtype.is_floating_point \
        and t.element_size() > 1


def flash_decode(q, k, v, lengths, *, scale=None, window=None):
    """Single-step decode attention.

    q: [B, Hq, D]; k, v: [B, Hkv, S, D] bf16/fp16 caches (fp32 on the
    CPU); lengths: [B] int32 live prefix per sequence (<= S). Returns
    [B, Hq, D] in q's dtype. The TPU kernel's `block_kv` has no
    counterpart: B5 walks the prefix in chunks of 256 positions.
    """
    if window is not None:
        raise NotImplementedError(
            "windowed decode arrives with the window slice")
    if not (_is_dense(k) and _is_dense(v)):
        raise NotImplementedError(
            "quantized caches arrive with the quantized-KV slice")
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d \
            or lengths.shape != (b,):
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.is_cuda:
        return _flash_decode_cuda(q, k, v, lengths, scale=float(scale))
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths, scale=float(scale))
    raise ValueError(f"unsupported device {q.device}")


def decode_reference(q, k, v, lengths, *, scale=None, window=None):
    """Exact decode reference: positions >= lengths[b] (and, with a
    window, positions < lengths[b] - window) masked, fp32 softmax, output
    in q's dtype. A length-0 row gives O = 0 here, where the JAX
    reference's softmax over nothing gives NaN."""
    if not (_is_dense(k) and _is_dense(v)):
        raise NotImplementedError(
            "quantized caches arrive with the quantized-KV slice")
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


def decode_cost(lengths, hq, hkv, d, itemsize):
    """(flops, bytes) B5 must do at least for these lengths: each live
    position's K and V rows read once per kv head, q and the lengths
    read once, O written once."""
    tokens = sum(int(x) for x in lengths)
    b = len(lengths)
    flops = 4 * hq * tokens * d
    nbytes = (2 * hkv * tokens * d * itemsize + 2 * b * hq * d * itemsize
              + 4 * b)
    return flops, nbytes
