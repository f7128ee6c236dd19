"""Flash attention forward and backward (port of
`flash_attention_tpu/ops/flash.py`).

`flash_attention_fwd` launches the hand-written CUDA kernel
`csrc/flash_fwd.cu` (B1, the port of the Pallas `_fwd_kernel`, with its
segment-id and sliding-window branches); `flash_attention_bwd` launches
`csrc/flash_bwd.cu` (B2, dQ, the port of `_bwd_dq_kernel`, then B3,
dK/dV, the port of `_bwd_dkv_kernel`, each with the same segment-id and
window branches). On CPU tensors each runs its plain PyTorch version
(`flash_attention_fwd_plain`, `flash_attention_bwd_plain`). A CUDA
tensor never reaches a plain version: it launches the kernel or raises.
`flash_attention` binds the two as a `torch.autograd.Function` (the JAX
package's `custom_vjp`). B1 also takes fp32 inputs (dense K/V; both
products in full fp32, as the JAX kernel's Precision.HIGHEST), and
`flash_attention_fwd_split` runs it as the two passes of the causal
split (the JAX kernel's `strict_below` / `diag_band` branches); B2 / B3
take fp16, bf16 and fp32 (FFMA products) with every mask.

Masks combine as in the JAX kernels: with segment ids a column is
invisible where the q and kv ids differ; under `causal` where col > row +
offset; under `window` (which requires causal) where col <= row + offset
- window. The backward applies the same masks.

K and V may be `QuantizedTensor`s (int8 / fp8 codes with fp32 scales
[B, Hkv, Nk/128, D]) in the forward (`flash_attention_fwd`,
`flash_attention_quantized`): B1 widens each code times its block's
scale in fp32 and rounds it to q's dtype as it loads a tile (the JAX
kernel's `_dequant_tile`), so K/V are read at code width. Gradients
through a quantized cache are not defined: `flash_attention` and the
backward take dense K/V only.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from flash_attention_tpu_torch.config import (
    CUDA_HEAD_DIMS,
    SUPPORTED_HEAD_DIMS,
    b1_tile,
)
from flash_attention_tpu_torch.ops import _cuda
from flash_attention_tpu_torch.ops.quant import (
    QUANT_BLOCK,
    QuantizedTensor,
    check_quant_cuda,
    dequantize_kv,
    split_kv,
)

# Running-max initializer and the LSE of a row that sees nothing: rows
# with no visible key export O = 0 and a finite LSE of INIT_M * scale,
# which every LSE merge weights exactly 0 (same contract as the JAX
# kernels).
INIT_M = -1e37

# Launches of the B1, B2 and B3 kernels (each incremented only where its
# kernel is launched).
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0
# Launches of B1 that took its segment-id branch, of B1 that took its
# window branch, and of B1 over quantized K/V (each also counted in
# flash_fwd_launches).
flash_fwd_segment_launches = 0
flash_fwd_window_launches = 0
flash_fwd_quant_launches = 0
# Launches of B1 on fp32 inputs, and of its causal split's bulk and band
# passes (flash_attention_fwd_split; each also counted in
# flash_fwd_launches).
flash_fwd_fp32_launches = 0
flash_fwd_split_bulk_launches = 0
flash_fwd_split_band_launches = 0
# Launches of B2 and of B3 with segment ids and with a window (each also
# counted in flash_bwd_dq_launches / flash_bwd_dkv_launches).
flash_bwd_dq_segment_launches = 0
flash_bwd_dkv_segment_launches = 0
flash_bwd_dq_window_launches = 0
flash_bwd_dkv_window_launches = 0
# Launches of B2 and of B3 on fp32 inputs (each also counted in
# flash_bwd_dq_launches / flash_bwd_dkv_launches).
flash_bwd_dq_fp32_launches = 0
flash_bwd_dkv_fp32_launches = 0


def acc_dtype(dtype):
    """The plain versions' accumulation type: fp64 for fp64 inputs (the
    reference of the fp32 kernels' gate on the card), else fp32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


@dataclasses.dataclass
class SegmentIds:
    """Segment ids, q [B, Nq] and kv [B, Nk] int32: attention is masked
    wherever the q and kv ids differ (packed documents; the chunked
    prefill's prefix mask)."""
    q: torch.Tensor
    kv: torch.Tensor


def _dense_kv(k, v):
    """Dense K/V for the differentiable paths: quantized ones are
    forward-only (flash_attention_quantized)."""
    if isinstance(k, QuantizedTensor) or isinstance(v, QuantizedTensor):
        raise TypeError("gradients through a quantized K/V cache are not "
                        "defined: use flash_attention_quantized (forward "
                        "only)")
    split_kv(k, v)


def _check_args(q, k, v, segment_ids, causal, scale, offset, window):
    batch, hq, nq, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"head_dim {d} not in supported set {SUPPORTED_HEAD_DIMS}")
    if k.shape[0] != batch or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    hkv, nk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if scale <= 0:
        raise ValueError("softmax scale must be positive (the kernels "
                         "track the row max on unscaled scores)")
    if offset is None:
        offset = nk - nq
    if causal and offset < 0:
        raise ValueError("causal attention requires Nq <= Nk (offset >= 0)")
    if window is not None:
        if not causal:
            raise ValueError("sliding window requires causal=True")
        if window < 1:
            raise ValueError("window must be >= 1")
    if segment_ids is not None and (
            tuple(segment_ids.q.shape) != (batch, nq)
            or tuple(segment_ids.kv.shape) != (batch, nk)):
        raise ValueError(
            f"segment id shapes {tuple(segment_ids.q.shape)}/"
            f"{tuple(segment_ids.kv.shape)} must be ({batch},{nq}) / "
            f"({batch},{nk})")
    return float(scale), int(offset)


def _visible_mask(nq, nk, causal, offset, device, window=None,
                  segment_ids=None):
    """Where row r sees column c: [Nq, Nk] bool, [B, 1, Nq, Nk] with
    segment ids, or None when every pair is visible."""
    visible = None
    if causal:
        row = torch.arange(nq, device=device)[:, None]
        col = torch.arange(nk, device=device)[None, :]
        visible = col <= row + offset
        if window is not None:
            visible = visible & (col > row + offset - window)
    if segment_ids is not None:
        same = (segment_ids.q.to(device)[:, None, :, None]
                == segment_ids.kv.to(device)[:, None, None, :])
        visible = same if visible is None else same & visible
    return visible


def flash_attention_fwd_plain(q, k, v, *, causal=False, scale, offset,
                              window=None, segment_ids=None):
    """B1's function in plain PyTorch: fp32 scores and softmax
    statistics, probabilities rounded to the input dtype for the PV
    product (the kernel's numerics), LSE [B, Hq, Nq] fp32. A row that
    sees nothing gives O = 0 and LSE = INIT_M * scale."""
    visible = _visible_mask(q.shape[2], k.shape[2], causal, offset,
                            q.device, window, segment_ids)
    return _masked_fwd_plain(q, k, v, scale, visible)


def _masked_fwd_plain(q, k, v, scale, visible):
    """flash_attention_fwd_plain under a boolean mask (where row r sees
    column c; None for every pair). fp64 inputs compute in fp64 (the
    reference of the fp32 kernel's gate on the card)."""
    hq, hkv = q.shape[1], k.shape[1]
    acc = acc_dtype(q.dtype)
    kk = torch.repeat_interleave(k, hq // hkv, dim=1).to(acc)
    vv = torch.repeat_interleave(v, hq // hkv, dim=1).to(acc)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), kk) * scale
    if visible is not None:
        s = s.masked_fill(~visible, float("-inf"))
    m = s.amax(dim=-1, keepdim=True) if s.shape[-1] else \
        s.new_full(s.shape[:-1] + (1,), float("-inf"))
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).to(acc), vv) / l_safe
    lse = torch.where(l > 0, m_safe + torch.log(l_safe),
                      torch.full_like(l, INIT_M * scale))[..., 0]
    return o.to(q.dtype), lse.to(acc)


def _check_cuda_inputs(kernel, q, k, v, **more):
    """What every CUDA entry point takes: q, k, v (and `more`) of one
    dtype among fp16 / bf16 / fp32 (_cuda.DTYPE_CODES), a built head
    dim, one device, contiguous."""
    tensors = dict(q=q, k=k, v=v, **more)
    codes = _cuda.DTYPE_CODES
    if q.dtype not in codes or any(
            t.dtype != q.dtype for t in tensors.values()):
        names = "/".join(str(dt).split(".")[-1] for dt in codes)
        raise TypeError(f"{kernel} takes {names} inputs of one dtype "
                        f"(got {[str(t.dtype) for t in tensors.values()]})")
    if q.shape[-1] not in CUDA_HEAD_DIMS:
        raise NotImplementedError(
            f"{kernel} is built for head dims {CUDA_HEAD_DIMS}, got "
            f"{q.shape[-1]}")
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is not on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _segment_ptrs(segment_ids, device):
    """(q ids, kv ids) data pointers for B1, or (None, None)."""
    if segment_ids is None:
        return None, None
    ptrs = []
    for name, t in (("q", segment_ids.q), ("kv", segment_ids.kv)):
        if t.dtype != torch.int32 or t.device != device \
                or not t.is_contiguous():
            raise TypeError(f"segment ids ({name}) must be contiguous "
                            f"int32 on {device}")
        ptrs.append(t.data_ptr())
    return tuple(ptrs)


# The split pass codes of csrc/flash_fwd.cuh (kSplitBulk, kSplitBand).
SPLIT_BULK, SPLIT_BAND = 1, 2


def _flash_fwd_cuda(q, k, v, *, causal, scale, offset, window=None,
                    segment_ids=None, k_scales=None, v_scales=None,
                    split=0, band=0):
    global flash_fwd_launches, flash_fwd_segment_launches
    global flash_fwd_window_launches, flash_fwd_quant_launches
    global flash_fwd_fp32_launches, flash_fwd_split_bulk_launches
    global flash_fwd_split_band_launches
    batch, hq, nq, d = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    quantized = k_scales is not None
    if quantized:
        _check_cuda_inputs("B1", q, q, q)
        if q.dtype == torch.float32:
            raise TypeError("B1 over quantized K/V takes an fp16/bf16 q "
                            "(got float32)")
        store = check_quant_cuda("B1", (k, v), (k_scales, v_scales))
    else:
        _check_cuda_inputs("B1", q, k, v)
        store = 0
    qseg, kvseg = _segment_ptrs(segment_ids, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((batch, hq, nq), dtype=torch.float32,
                      device=q.device)
    if batch == 0 or hq == 0 or nq == 0:
        return o, lse
    lib = _cuda.lib()
    code = lib.fa_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None, o.data_ptr(),
        lse.data_ptr(), qseg, kvseg, batch, hq, hkv, nq, nk, d,
        int(causal), offset, int(window or 0), split, band, scale,
        _cuda.DTYPE_CODES[q.dtype], store,
        _cuda.stream_handle(q.device))
    flash_fwd_launches += 1
    flash_fwd_segment_launches += segment_ids is not None
    flash_fwd_window_launches += window is not None
    flash_fwd_quant_launches += quantized
    flash_fwd_fp32_launches += q.dtype == torch.float32
    flash_fwd_split_bulk_launches += split == SPLIT_BULK
    flash_fwd_split_band_launches += split == SPLIT_BAND
    _cuda.check(code, "flash_fwd")
    return o, lse


def _check_block_sizes(q, block_sizes):
    """On the card B1 takes only the tile it is compiled for (ValueError
    naming it); on the CPU any tile is accepted and changes nothing
    (B1's plain version is untiled)."""
    if block_sizes is None or not q.is_cuda:
        return
    tile = b1_tile(q.dtype, q.shape[-1])
    got = (block_sizes.block_q, block_sizes.block_kv)
    if got != tile:
        raise ValueError(
            f"B1 on the card is compiled for (block_q, block_kv) = {tile} "
            f"at head dim {q.shape[-1]} and {q.dtype}; got {got} "
            "(select_block_sizes gives the compiled tile)")


def _split_pass(nq, nk, causal, offset, window, segment_ids, strict_below,
                diag_band):
    """(split code, band) of a call that asks for one pass of the causal
    split, with the JAX kernel's guards and messages; (0, 0) otherwise."""
    if diag_band is not None:
        if not causal or window is not None or segment_ids is not None \
                or offset != 0 or nq != nk:
            raise ValueError(
                "diag_band requires plain causal self-attention "
                "(no window/segments/padding, Nq == Nk)")
        if diag_band % SPLIT_TILE or nq % diag_band:
            raise ValueError(
                f"diag_band={diag_band} must be a multiple of B1's "
                f"{SPLIT_TILE}-row q tile and divide Nq={nq}")
        return SPLIT_BAND, diag_band
    if strict_below is not None:
        if causal or window is not None or segment_ids is not None \
                or offset != 0:
            raise ValueError(
                "strict_below composes with none of causal/window/"
                "segments/padding/offset (it IS the mask)")
        if strict_below % SPLIT_TILE:
            raise ValueError(
                f"strict_below band {strict_below} must be a multiple of "
                f"B1's {SPLIT_TILE}-row q tile")
        return SPLIT_BULK, strict_below
    return 0, 0


def flash_attention_fwd(q, k, v, segment_ids=None, *, causal=False,
                        scale=None, block_sizes=None, offset=None,
                        window=None, save_residuals=True, strict_below=None,
                        diag_band=None):
    """Forward flash attention. Returns (o, lse) with lse the fp32
    log-sum-exp per row, [B, Hq, Nq] (the JAX kernel's lane-replicated
    [..., 128] layout is a TPU device and is not kept); lse is None when
    save_residuals is False.

    q: [B, Hq, Nq, D]; k, v: [B, Hkv, Nk, D] with Hkv | Hq, dense or
    both QuantizedTensor (scales [B, Hkv, Nk/128, D]). Causal
    visibility is col <= row + offset, offset defaulting to Nk - Nq (it
    may exceed Nk - Nq, as the rolling-buffer prefill's offset = Nk);
    `window` hides col <= row + offset - window; `segment_ids`
    (SegmentIds) hide pairs whose ids differ. `block_sizes` must be B1's
    compiled tile on the card (`select_block_sizes`).

    The two passes of the causal split (flash_attention_fwd_split), each
    on its own: `strict_below=w` (non-causal, offset 0) lets row r see
    columns [0, (r // w) * w) only, `diag_band=w` (causal
    self-attention, Nq == Nk divisible by w) columns [(r // w) * w, r];
    w a multiple of B1's 64-row q tile. A row that sees nothing gives
    O = 0 and LSE = INIT_M * scale.
    """
    kv, vv, ks, vs = split_kv(k, v)
    scale, offset = _check_args(q, kv, vv, segment_ids, causal, scale,
                                offset, window)
    if ks is not None:
        b, hkv, nk, d = kv.shape
        want = (b, hkv, nk // QUANT_BLOCK, d)
        if nk % QUANT_BLOCK or tuple(ks.shape) != want \
                or tuple(vs.shape) != want:
            raise ValueError(f"quantized K/V need Nk % {QUANT_BLOCK} == 0 "
                             f"and scales {want}, got Nk={nk}, "
                             f"{tuple(ks.shape)} / {tuple(vs.shape)}")
    nq, nk = q.shape[2], kv.shape[2]
    split, band = _split_pass(nq, nk, causal, offset, window, segment_ids,
                              strict_below, diag_band)
    kw = dict(causal=causal, scale=scale, offset=offset, window=window,
              segment_ids=segment_ids)
    if q.is_cuda:
        _check_block_sizes(q, block_sizes)
        o, lse = _flash_fwd_cuda(q, kv, vv, k_scales=ks, v_scales=vs,
                                 split=split, band=band, **kw)
    elif q.device.type == "cpu":
        if ks is not None:
            kv, vv = dequantize_kv(k, q.dtype), dequantize_kv(v, q.dtype)
        if split:
            visible = _split_masks(nq, nk, band, q.device)[split - 1]
            o, lse = _masked_fwd_plain(q, kv, vv, scale, visible)
        else:
            o, lse = flash_attention_fwd_plain(q, kv, vv, **kw)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return o, (lse if save_residuals else None)


# B1's q tile: the causal split's band must be a multiple of it.
SPLIT_TILE = 64


def _split_masks(nq, nk, band, device):
    """(bulk, band) visibility [Nq, Nk] of the causal split: row r's bulk
    pass sees columns [0, (r // band) * band), its band pass columns
    [(r // band) * band, r]."""
    row = torch.arange(nq, device=device)[:, None]
    col = torch.arange(nk, device=device)[None, :]
    start = row // band * band
    return col < start, (col >= start) & (col <= row)


def merge_lse(o_a, lse_a, o_b, lse_b):
    """Two partial attentions over disjoint column sets merged by their
    LSEs (fp32, [B, Hq, N]): returns (o in o_a's dtype, lse). A part
    whose rows saw nothing (LSE = INIT_M * scale) weighs exactly 0.
    Elementwise, as the JAX package merges outside its kernels
    (flash.py:697-709)."""
    m = torch.maximum(lse_a, lse_b)
    wa, wb = torch.exp(lse_a - m), torch.exp(lse_b - m)
    den = wa + wb
    o = ((o_a.float() * wa[..., None] + o_b.float() * wb[..., None])
         / den[..., None]).to(o_a.dtype)
    return o, m + torch.log(den)


def flash_attention_fwd_split_plain(q, k, v, *, scale, band):
    """flash_attention_fwd_split's function in plain PyTorch: B1's plain
    version under the bulk and band masks, then the LSE merge."""
    bulk, diag = _split_masks(q.shape[2], k.shape[2], band, q.device)
    o_b, lse_b = _masked_fwd_plain(q, k, v, scale, bulk)
    o_d, lse_d = _masked_fwd_plain(q, k, v, scale, diag)
    return merge_lse(o_b, lse_b, o_d, lse_d)


def flash_attention_fwd_split(q, k, v, *, scale=None, band=2048,
                              save_residuals=False):
    """Two-pass causal forward (the JAX package's
    `flash_attention_fwd_split`, flash.py:664): a mask-free bulk pass
    over the kv columns below each q tile's `band`-wide diagonal band,
    then a causal pass over the band only, merged by their LSEs: the
    `strict_below` and `diag_band` passes of flash_attention_fwd. On CUDA
    tensors these are two B1 launches (each a kv-loop bound in B1's
    body: the bulk pass's loop ends at (q0 / band) * band, the band
    pass's covers [(q0 / band) * band, + band)); on CPU tensors the
    plain version. Returns (o, lse or None); lse fp32 [B, Hq, N].

    Needs Nq == Nk divisible by `band`, as the JAX function does, and
    `band` a multiple of B1's 64-row q tile (ValueError otherwise)."""
    _dense_kv(k, v)
    nq, nk = q.shape[2], k.shape[2]
    if nq != nk or nq % band:
        raise ValueError(
            f"split forward needs Nq == Nk divisible by band "
            f"(got {nq}/{nk}, band {band})")
    o_b, lse_b = flash_attention_fwd(q, k, v, scale=scale, offset=0,
                                     strict_below=band)
    o_d, lse_d = flash_attention_fwd(q, k, v, causal=True, scale=scale,
                                     offset=0, diag_band=band)
    o, lse = merge_lse(o_b, lse_b, o_d, lse_d)
    return o, (lse if save_residuals else None)


def _bwd_delta(o, do):
    """delta = rowsum(dO * O) in fp32, [B, Hq, Nq]: computed before the
    backward kernels, as the JAX package does in XLA outside its Pallas
    kernels (flash.py:879-881)."""
    acc = acc_dtype(o.dtype)
    return (do.to(acc) * o.to(acc)).sum(dim=-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=False,
                              scale, offset, window=None, segment_ids=None):
    """B2 and B3's function in plain PyTorch: the recompute backward
    with the kernels' roundings. P = exp(s*scale - lse) is exactly 0 on
    hidden pairs (causal, window and segment-id masks as in the
    forward; by select, so a row that sees no key yields zero
    gradients), dP = dO V^T, dS = P (dP - delta) scale with delta =
    rowsum(dO O) in fp32, dQ = dS K, dK = dS^T Q, dV = P^T dO; P is
    rounded to dO's dtype before the dV product and dS to the input
    dtype before the dQ and dK products. GQA gradients are summed over
    the q heads of each group. Returns (dq, dk, dv) in the inputs'
    dtypes; fp64 inputs compute in fp64."""
    batch, hq, nq, d = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    group = hq // hkv
    acc = acc_dtype(q.dtype)
    kk = torch.repeat_interleave(k, group, dim=1).to(acc)
    vv = torch.repeat_interleave(v, group, dim=1).to(acc)
    qf, dof = q.to(acc), do.to(acc)
    delta = _bwd_delta(o, do)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kk)
    p = torch.exp(s * scale - lse[..., None])
    visible = _visible_mask(nq, nk, causal, offset, q.device, window,
                            segment_ids)
    if visible is not None:
        p = torch.where(visible, p, torch.zeros_like(p))
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vv)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).to(acc), dof)
    dk = dk.reshape(batch, hkv, group, nk, d).sum(dim=2)
    dv = dv.reshape(batch, hkv, group, nk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _launch_bwd(entry, q, k, v, do, lse, delta, outs, *, causal, scale,
                offset, window=None, segment_ids=None):
    batch, hq, nq, d = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    qseg, kvseg = _segment_ptrs(segment_ids, q.device)
    return getattr(_cuda.lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
        qseg, kvseg, batch, hq, hkv, nq, nk, d, int(causal), offset,
        int(window or 0), scale, _cuda.DTYPE_CODES[q.dtype],
        _cuda.stream_handle(q.device))


def _bwd_dq_cuda(q, k, v, do, lse, delta, **kw):
    """Launch B2; returns dq. kw: causal, scale, offset, window,
    segment_ids."""
    global flash_bwd_dq_launches, flash_bwd_dq_segment_launches
    global flash_bwd_dq_window_launches, flash_bwd_dq_fp32_launches
    dq = torch.empty_like(q)
    code = _launch_bwd("fa_flash_bwd_dq", q, k, v, do, lse, delta, (dq,),
                       **kw)
    flash_bwd_dq_launches += 1
    flash_bwd_dq_fp32_launches += q.dtype == torch.float32
    flash_bwd_dq_segment_launches += kw.get("segment_ids") is not None
    flash_bwd_dq_window_launches += kw.get("window") is not None
    _cuda.check(code, "flash_bwd_dq")
    return dq


def _bwd_dkv_cuda(q, k, v, do, lse, delta, **kw):
    """Launch B3; returns (dk, dv). kw as _bwd_dq_cuda's."""
    global flash_bwd_dkv_launches, flash_bwd_dkv_segment_launches
    global flash_bwd_dkv_window_launches, flash_bwd_dkv_fp32_launches
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    code = _launch_bwd("fa_flash_bwd_dkv", q, k, v, do, lse, delta,
                       (dk, dv), **kw)
    flash_bwd_dkv_launches += 1
    flash_bwd_dkv_fp32_launches += q.dtype == torch.float32
    flash_bwd_dkv_segment_launches += kw.get("segment_ids") is not None
    flash_bwd_dkv_window_launches += kw.get("window") is not None
    _cuda.check(code, "flash_bwd_dkv")
    return dk, dv


def _flash_bwd_cuda(q, k, v, o, lse, do, *, causal, scale, offset,
                    window=None, segment_ids=None):
    batch, hq, nq, _ = q.shape
    nk = k.shape[2]
    _check_cuda_inputs("B2/B3", q, k, v, o=o, do=do)
    if lse.shape != (batch, hq, nq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous fp32 [B, Hq, Nq] "
                         f"tensor on {q.device}")
    _segment_ptrs(segment_ids, q.device)
    if not batch * hq * nq * nk:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = _bwd_delta(o, do)
    kw = dict(causal=causal, scale=scale, offset=offset, window=window,
              segment_ids=segment_ids)
    dq = _bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk, dv = _bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, segment_ids=None, *,
                        causal=False, scale=None, offset=None,
                        window=None):
    """Recompute backward: returns (dq, dk, dv) for the forward's o and
    fp32 lse [B, Hq, Nq] and the output cotangent do, under the
    forward's masks (causal, offset, window, segment_ids). Launches B2
    (dQ) then B3 (dK/dV) on CUDA tensors; runs flash_attention_bwd_plain
    on CPU tensors."""
    _dense_kv(k, v)
    scale, offset = _check_args(q, k, v, segment_ids, causal, scale,
                                offset, window)
    kw = dict(causal=causal, scale=scale, offset=offset, window=window,
              segment_ids=segment_ids)
    if q.is_cuda:
        return _flash_bwd_cuda(q, k, v, o, lse, do, **kw)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    raise ValueError(f"unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """The port of the JAX `custom_vjp` (flash.py:1056-1090): the
    forward saves q, k, v, o and the fp32 LSE; the backward recomputes
    P from them (B2, B3) under the same causal, window and segment-id
    masks."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, offset, window, segment_ids):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_fwd(q, k, v, segment_ids, causal=causal,
                                     scale=scale, offset=offset,
                                     window=window, save_residuals=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.offset = causal, scale, offset
        ctx.window, ctx.segment_ids = window, segment_ids
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), ctx.segment_ids,
            causal=ctx.causal, scale=ctx.scale, offset=ctx.offset,
            window=ctx.window)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, segment_ids=None, *, causal: bool = False,
                    scale: float | None = None, block_sizes=None,
                    offset: int | None = None, window: int | None = None):
    """Differentiable flash attention (public API): B1 forward, B2/B3
    backward on CUDA tensors, their plain versions on CPU tensors.

    q: [B, Hq, Nq, D]; k, v: [B, Hkv, Nk, D] with Hkv | Hq. Masks as in
    flash_attention_fwd, in the forward and the backward; quantized K/V
    raise TypeError (flash_attention_quantized is forward-only).
    `block_sizes` must be B1's compiled tile on the card (B2 / B3 have
    fixed tiles).
    """
    _dense_kv(k, v)
    scale, offset = _check_args(q, k, v, segment_ids, causal, scale,
                                offset, window)
    _check_block_sizes(q, block_sizes)
    return _FlashAttention.apply(q, k, v, causal, scale, offset, window,
                                 segment_ids)


def flash_attention_quantized(q, k, v, *, causal: bool = False,
                              scale: float | None = None, block_sizes=None,
                              offset: int | None = None):
    """Forward-only flash attention over an int8 / fp8-quantized KV cache
    (QuantizedTensor k and v): B1 with the dequantization fused into its
    tile loads, so K/V are read at code width. Returns O [B, Hq, Nq, D]
    in q's dtype; no autograd."""
    if not (isinstance(k, QuantizedTensor) and isinstance(v, QuantizedTensor)):
        raise TypeError("flash_attention_quantized takes QuantizedTensor "
                        "k and v (ops/quant.py quantize_kv)")
    with torch.no_grad():
        o, _ = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                   block_sizes=block_sizes, offset=offset,
                                   save_residuals=False)
    return o


def _visible_counts(batch, nq, nk, causal, offset=None, window=None,
                    segment_ids=None):
    """(visible (row, col) pairs, kv columns that some row sees), each
    summed over the batch: the work these inputs need, not the most the
    shapes allow."""
    if offset is None:
        offset = nk - nq
    if segment_ids is not None:
        vis = _visible_mask(nq, nk, causal, offset, segment_ids.q.device,
                            window, segment_ids)[:, 0]
        return int(vis.sum()), int(vis.any(dim=1).sum())
    if not causal:
        return batch * nq * nk, batch * nk * (nq > 0)
    r = torch.arange(nq, dtype=torch.int64)
    hi = (r + offset + 1).clamp(0, nk)
    lo = ((r + offset - window + 1).clamp(0, nk) if window is not None
          else torch.zeros_like(r))
    n = (hi - lo).clamp(min=0)
    live = n > 0
    cols = int(hi[live].max() - lo[live].min()) if bool(live.any()) else 0
    return batch * int(n.sum()), batch * cols


def fwd_cost(batch, hq, hkv, nq, nk, d, causal, itemsize, *, offset=None,
             window=None, segment_ids=None, kv_itemsize=None):
    """(flops, bytes) B1 must do at least: the QK^T and PV products over
    the visible (row, col) pairs, q and the kv rows some row sees read
    once (and the segment ids), O and LSE written once. With
    `kv_itemsize` (1 for int8 / fp8 K/V) the kv rows count at that
    width, plus one fp32 scale row per 128 of them."""
    pairs, cols = _visible_counts(batch, nq, nk, causal, offset, window,
                                  segment_ids)
    flops = 4 * hq * pairs * d
    kv_bytes = (itemsize * d * 2 * hkv * cols if kv_itemsize is None
                else 2 * hkv * d * (kv_itemsize * cols
                                    + 4 * -(-cols // QUANT_BLOCK)))
    nbytes = (itemsize * d * 2 * hq * nq * batch + kv_bytes
              + 4 * batch * hq * nq)
    if segment_ids is not None:
        nbytes += 4 * batch * (nq + nk)
    return flops, nbytes


def bwd_cost(batch, hq, hkv, nq, nk, d, causal, itemsize, *, offset=None,
             window=None, segment_ids=None):
    """((flops, bytes) of B2, (flops, bytes) of B3): the least each must
    do over the visible (row, col) pairs. B2 recomputes S and dP and
    forms dQ (6 D FLOPs a pair), reading q, dO, LSE and delta once and
    the k, v rows some row sees once, and writing dq once; B3 recomputes
    S and dP and forms dK and dV (8 D FLOPs a pair), reading the same
    and writing dk and dv once (and the segment ids, where given)."""
    pairs, cols = _visible_counts(batch, nq, nk, causal, offset, window,
                                  segment_ids)
    pairs *= hq
    stats = 8 * batch * hq * nq                  # fp32 LSE and delta
    if segment_ids is not None:
        stats += 4 * batch * (nq + nk)
    kv_read = itemsize * d * 2 * hkv * cols
    dq = (6 * d * pairs,
          itemsize * batch * d * 3 * hq * nq + kv_read + stats)
    dkv = (8 * d * pairs,
           itemsize * batch * d * (2 * hq * nq + 2 * hkv * nk) + kv_read
           + stats)
    return dq, dkv
