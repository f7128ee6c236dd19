"""One-token decode attention over contiguous caches (port of
`flash_attention_tpu/ops/decode.py`).

`flash_decode` launches the hand-written CUDA kernel `csrc/decode.cu`
(B5, the port of the Pallas `_decode_kernel`) on CUDA tensors and runs
`flash_decode_plain`, the same function in plain PyTorch, on CPU
tensors. A CUDA tensor launches the kernel or raises.

B4 and B5 share two bodies (`decode_body` picks one before the launch):
fp16 / bf16 queries run the split body of `csrc/decode_sm90.cuh` --
each (sequence, kv head, 16 query rows) cut into `split_plan` blocks
over its visible positions, tensor-core products, and the splits'
partials merged in split order inside the launch, in a scratch area
cached per (device, stream) (`_cuda.scratch`) -- and fp32 queries the
first body (`csrc/decode_core.cuh`, FFMA products). `split_share` is
the kernel's share arithmetic and `split_merge_plain` its algorithm in
plain PyTorch (per-split partials merged in split order), the twin the
CPU tests hold to the JAX kernels.

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

from flash_attention_tpu_torch.config import CUDA_HEAD_DIMS, cdiv
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
# fp16 / bf16 launches of B5 on the first body (also counted in
# decode_launches): none since the split body takes every fp16 / bf16
# cache; the gate that a routing change would trip.
decode_first_body_launches = 0

# The bodies of B4 / B5 and their C codes, and the split body's shape
# (csrc/decode_sm90.cuh): a block is SPLIT_WARPS warps over SPLIT_ROWS
# query rows, each warp taking SPLIT_SLAB tokens at a time.
BODY_CODES = {"first": 0, "split": 1}
SPLIT_SLAB = 16
SPLIT_ROWS = 16
SPLIT_WARPS = 4
MAX_SPLITS = 64        # kMaxSplits
SM_COUNT = 132         # the H100's SMs


def resident_blocks(d) -> int:
    """Blocks of the split body the card holds at once: two an SM (each
    block's shared memory is kept under half an SM's), one at D = 256."""
    return SM_COUNT * (1 if d > 128 else 2)


def decode_body(dtype, page_size=None) -> str:
    """The body a B4 / B5 launch runs: "split" (decode_sm90.cuh) for
    fp16 / bf16 queries -- B4's pools with a page size that is a
    multiple of SPLIT_SLAB, every quantized pool among them -- else
    "first" (decode_core.cuh): fp32 queries, and B4 fp16 / bf16 over
    dense pools of another page size."""
    if dtype == torch.float32:
        return "first"
    if page_size is not None and page_size % SPLIT_SLAB:
        return "first"
    return "split"


def split_plan(units, max_tokens, d) -> int:
    """Blocks per unit (one (sequence, kv head, row group)) of the split
    body at head dim d when a unit sees at most `max_tokens` positions:
    as many as the card holds at once (resident_blocks; one wave: a
    block more would wait for a whole block's time), but no more than
    leave each split a slab per warp of max_tokens (the visible range's
    start may cut a slab: one more counts), and at most MAX_SPLITS. From
    shapes alone: no value on the card is read."""
    slabs = cdiv(max(int(max_tokens), 0), SPLIT_SLAB) + 1
    most = max(1, min(MAX_SPLITS, slabs // SPLIT_WARPS))
    return max(1, min(most, resident_blocks(d) // max(int(units), 1)))


def split_share(length, start, split, splits) -> tuple[int, int]:
    """Positions [lo, hi) split `split` of `splits` reads for a sequence
    of `length` positions whose lowest visible position is `start`
    (None or negative: 0): the visible range, from `start` rounded down
    to a slab, cut into slabs and shared evenly, as the kernel computes
    it (decode_sm90.cuh `attend`). Empty: lo == hi."""
    lo = max(start or 0, 0) // SPLIT_SLAB * SPLIT_SLAB
    n = cdiv(length - lo, SPLIT_SLAB) if length > lo else 0
    s0, s1 = n * split // splits, n * (split + 1) // splits
    hi = min(length, lo + s1 * SPLIT_SLAB)
    lo = lo + s0 * SPLIT_SLAB
    return lo, max(lo, hi)


# Launch plans by shape (launch_plan): a decode step repeats its shapes,
# so the body, the split count and the scratch are worked out once. A
# serving run meets a few thousand shapes at most (batch x table width);
# past MAX_PLANS the cache starts again.
_plans: dict = {}
MAX_PLANS = 4096


def launch_plan(key, dtype, page_size, units, max_tokens, d, device,
                stream):
    """(body, splits, workspace address, counters address, the scratch
    tensors) of a B4 / B5 launch whose shape `key` names, stored in
    _plans[key] (the callers look there first; the key holds everything
    the plan depends on): the body (decode_body), and for the split
    body the split count (split_plan) and, with more than one split,
    units x splits x SPLIT_ROWS x (D + 2) fp32 partials and stats and one
    counter a unit (_cuda.scratch; the plan holds the tensors, so its
    addresses stay valid when the stream's scratch grows)."""
    body = decode_body(dtype, page_size)
    splits, held = 1, (None, None)
    if body == "split":
        splits = split_plan(units, max_tokens, d)
        if splits > 1:
            held = _cuda.scratch(device, stream,
                                 units * splits * SPLIT_ROWS * (d + 2),
                                 units)
    ptrs = tuple(None if t is None else t.data_ptr() for t in held)
    if len(_plans) >= MAX_PLANS:
        _plans.clear()
    _plans[key] = plan = (body, splits, *ptrs, held)
    return plan


def hidden(s, lengths, starts=None, qpos_spread=1):
    """The positions of scores s [B, Hkv, R, S] their row does not see:
    >= lengths[b], and with window starts < starts[b] + (r % qpos_spread)
    for row r."""
    col = torch.arange(s.shape[-1], device=s.device)
    bad = col >= lengths.long().to(s.device)[:, None, None, None]
    if starts is not None:
        row = torch.arange(s.shape[2], device=s.device) % qpos_spread
        lo = starts.long().to(s.device)[:, None, None, None] \
            + row[None, None, :, None]
        bad = bad | (col < lo)
    return bad


def masked_softmax(s, lengths, starts=None, qpos_spread=1):
    """Scaled scores s [B, Hkv, R, S] -> (p, l, lse): probabilities over
    positions < lengths[b] (and, with window starts, >= starts[b] + (r %
    qpos_spread) for row r) against the row max, their sum l [..., 1]
    and the LSE [..., 1] (INIT_M / scale-free: the caller substitutes
    INIT_M * scale where l == 0). The softmax of B4's and B5's plain
    versions."""
    s = s.masked_fill(hidden(s, lengths, starts, qpos_spread), float("-inf"))
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


def split_merge_plain(s, bad, lengths, starts, splits, pv, shape, dtype,
                      scale, return_lse):
    """The split body's algorithm in plain PyTorch: scaled scores s [B,
    Hkv, R, S] (`bad`: positions a row does not see) cut into `splits`
    shares per sequence (split_share); each share's partial -- its max m
    (at least INIT_M * scale, the neutral partial of an empty share), l
    and the PV sum pv(p) of its probabilities -- then merged in split
    order: weights exp(m_sp - m), l = sum of weighted l, O = sum of
    weighted partials / l (O = 0 and LSE = INIT_M * scale where l == 0).
    `pv` maps probabilities [B, Hkv, R, S] (zero outside the share) to
    [B, Hkv, R, D] in fp32 with the caller's roundings."""
    b, n = s.shape[0], s.shape[-1]
    neutral = INIT_M * scale
    col = torch.arange(n, device=s.device)
    parts = []
    for sp in range(splits):
        share = torch.zeros((b, n), dtype=torch.bool, device=s.device)
        for i in range(b):
            lo, hi = split_share(int(lengths[i]), None if starts is None
                                 else int(starts[i]), sp, splits)
            share[i] = (col >= lo) & (col < hi)
        sc = s.masked_fill(bad | ~share[:, None, None, :], float("-inf"))
        m = sc.amax(dim=-1, keepdim=True).clamp(min=neutral)
        p = torch.exp(sc - m)
        parts.append((m, p.sum(dim=-1, keepdim=True), pv(p)))
    m = torch.stack([x[0] for x in parts]).amax(dim=0)
    l = o = 0
    for m_sp, l_sp, o_sp in parts:
        w = torch.exp(m_sp - m)
        l = l + w * l_sp
        o = o + w * o_sp
    return finish_rows(o, l, m + torch.log(torch.where(l > 0, l, 1)), shape,
                       dtype, scale, return_lse)


def flash_decode_split_plain(q, k, v, lengths, *, scale, splits,
                             return_lse=False, starts=None, qpos_spread=1):
    """flash_decode_plain computed as the split body computes it
    (split_merge_plain over `splits` shares), on dense caches."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    acc = acc_dtype(q.dtype)
    qg = q.reshape(b, hkv, hq // hkv, d).to(acc)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.to(acc)) * scale

    def pv(p):
        return torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).to(acc),
                            v.to(acc))

    return split_merge_plain(
        s, hidden(s, lengths, starts, qpos_spread), lengths, starts,
        splits, pv, q.shape, q.dtype, scale, return_lse)


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
    dev = q.get_device()   # an int: cheaper to compare than torch.device
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return store


def _flash_decode_cuda(q, k, v, lengths, *, scale, window=None,
                       k_scales=None, v_scales=None):
    global decode_launches, decode_window_launches, decode_quant_launches
    global decode_fp32_launches, decode_first_body_launches
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    quantized = k_scales is not None
    store = _check_decode_cuda(q, k, v, lengths, k_scales=k_scales,
                               v_scales=v_scales)
    o = torch.empty_like(q)
    if b == 0:
        return o
    stream = _cuda.stream_handle(q.device)
    key = (q.dtype, b, hq, hkv, s, d, window, q.get_device(), stream)
    plan = _plans.get(key) or launch_plan(
        key, q.dtype, None, b * hkv * cdiv(hq // hkv, SPLIT_ROWS),
        s if window is None else min(s, window), d, q.device, stream)
    body, splits, ws, counters = plan[:4]
    code = _cuda.lib().fa_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None, lengths.data_ptr(),
        o.data_ptr(), b, hq, hkv, s, d, int(window or 0), scale,
        _cuda.DTYPE_CODES[q.dtype], store, BODY_CODES[body], splits, ws,
        counters, stream)
    fp32 = q.dtype == torch.float32
    decode_launches += 1
    decode_window_launches += window is not None
    decode_quant_launches += quantized
    decode_fp32_launches += fp32
    decode_first_body_launches += body == "first" and not fp32
    _cuda.check(code, "decode")
    return o


def flash_decode(q, k, v, lengths, *, scale=None, window=None):
    """Single-step decode attention.

    q: [B, Hq, D]; k, v: [B, Hkv, S, D] bf16/fp16 caches (fp32 on the
    CPU) or both QuantizedTensor (int8 / fp8 codes, fp32 scales [B, Hkv,
    S/128, D]); lengths: [B] int32 live prefix per sequence (<= S);
    window: attend only positions >= lengths[b] - window (Mistral-style
    local attention; older chunks are not read). Returns [B, Hq, D] in
    q's dtype. The TPU kernel's `block_kv` has no counterpart: the
    split body cuts the visible positions into slabs of 16 across
    `split_plan` blocks (the first body walks chunks of 256).
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
