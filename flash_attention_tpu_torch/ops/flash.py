"""Flash attention forward (port of `flash_attention_tpu/ops/flash.py`).

`flash_attention_fwd` launches the hand-written CUDA kernel
`csrc/flash_fwd.cu` (B1, the port of the Pallas `_fwd_kernel`) on CUDA
tensors and runs `flash_attention_fwd_plain`, the same function in plain
PyTorch, on CPU tensors. A CUDA tensor never reaches the plain version:
it launches the kernel or raises.

This slice is forward-only (the serving path). Sliding windows, segment
ids, quantized KV and the backward kernels arrive with later slices and
raise NotImplementedError until then.
"""

from __future__ import annotations

import math

import torch

from flash_attention_tpu_torch.config import (
    CUDA_HEAD_DIMS,
    SUPPORTED_HEAD_DIMS,
)
from flash_attention_tpu_torch.ops import _cuda

# Running-max initializer and the LSE of a row that sees nothing: rows
# with no visible key export O = 0 and a finite LSE of INIT_M * scale,
# which every LSE merge weights exactly 0 (same contract as the JAX
# kernels).
INIT_M = -1e37

# Launches of the B1 kernel (incremented only where it is launched).
flash_fwd_launches = 0


def _check_args(q, k, v, segment_ids, causal, scale, offset, window):
    if segment_ids is not None:
        raise NotImplementedError(
            "segment_ids arrive with the chunked-prefill/prefix-cache "
            "slice")
    if window is not None:
        raise NotImplementedError(
            "sliding-window attention arrives with the window slice")
    if not (k.dtype.is_floating_point and v.dtype.is_floating_point) \
            or k.element_size() == 1:
        raise NotImplementedError(
            "quantized KV arrives with the quantized-KV slice")
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
    return float(scale), int(offset)


def flash_attention_fwd_plain(q, k, v, *, causal=False, scale, offset):
    """B1's function in plain PyTorch: fp32 scores and softmax
    statistics, probabilities rounded to the input dtype for the PV
    product (the kernel's numerics), LSE [B, Hq, Nq] fp32."""
    hq, hkv = q.shape[1], k.shape[1]
    kk = torch.repeat_interleave(k, hq // hkv, dim=1).float()
    vv = torch.repeat_interleave(v, hq // hkv, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if causal:
        nq, nk = s.shape[-2], s.shape[-1]
        row = torch.arange(nq, device=s.device)[:, None]
        col = torch.arange(nk, device=s.device)[None, :]
        s = s.masked_fill(col > row + offset, float("-inf"))
    m = s.amax(dim=-1, keepdim=True) if s.shape[-1] else \
        s.new_full(s.shape[:-1] + (1,), float("-inf"))
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), vv) / l_safe
    lse = torch.where(l > 0, m_safe + torch.log(l_safe),
                      torch.full_like(l, INIT_M * scale))[..., 0]
    return o.to(q.dtype), lse


def _flash_fwd_cuda(q, k, v, *, causal, scale, offset):
    global flash_fwd_launches
    batch, hq, nq, d = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    if q.dtype not in _cuda.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"B1 takes fp16/bf16 q, k, v of one dtype "
                        f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    if d not in CUDA_HEAD_DIMS:
        raise NotImplementedError(
            f"B1 is built for head dims {CUDA_HEAD_DIMS}, got {d}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must be on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    o = torch.empty_like(q)
    lse = torch.empty((batch, hq, nq), dtype=torch.float32,
                      device=q.device)
    if batch == 0 or hq == 0 or nq == 0:
        return o, lse
    lib = _cuda.lib()
    code = lib.fa_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), batch, hq, hkv, nq, nk, d, int(causal), offset,
        scale, _cuda.DTYPE_CODES[q.dtype], _cuda.stream_handle(q.device))
    flash_fwd_launches += 1
    _cuda.check(code, "flash_fwd")
    return o, lse


def flash_attention_fwd(q, k, v, segment_ids=None, *, causal=False,
                        scale=None, offset=None, window=None,
                        save_residuals=True):
    """Forward flash attention. Returns (o, lse) with lse the fp32
    log-sum-exp per row, [B, Hq, Nq] (the JAX kernel's lane-replicated
    [..., 128] layout is a TPU device and is not kept); lse is None when
    save_residuals is False.

    q: [B, Hq, Nq, D]; k, v: [B, Hkv, Nk, D] with Hkv | Hq. Causal
    visibility is col <= row + offset, offset defaulting to Nk - Nq.
    """
    scale, offset = _check_args(q, k, v, segment_ids, causal, scale,
                                offset, window)
    if q.is_cuda:
        o, lse = _flash_fwd_cuda(q, k, v, causal=causal, scale=scale,
                                 offset=offset)
    elif q.device.type == "cpu":
        o, lse = flash_attention_fwd_plain(q, k, v, causal=causal,
                                           scale=scale, offset=offset)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return o, (lse if save_residuals else None)


def flash_attention(q, k, v, segment_ids=None, *, causal: bool = False,
                    scale: float | None = None, offset: int | None = None,
                    window: int | None = None):
    """Flash attention (public API), forward only in this slice: the
    backward kernels arrive with the training slice, so inputs that
    require grad raise instead of returning an output that silently
    carries no gradient."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention backward (kernels B2/B3) arrives with the "
            "training slice; call under torch.no_grad() for inference")
    o, _ = flash_attention_fwd(q, k, v, segment_ids, causal=causal,
                               scale=scale, offset=offset, window=window,
                               save_residuals=False)
    return o


def fwd_cost(batch, hq, hkv, nq, nk, d, causal, itemsize):
    """(flops, bytes) B1 must do at least: the QK^T and PV products over
    the visible (row, col) pairs, each input read once, O and LSE written
    once."""
    if causal:
        offset = nk - nq
        pairs = sum(max(0, min(nk, r + offset + 1)) for r in range(nq))
    else:
        pairs = nq * nk
    flops = 4 * batch * hq * pairs * d
    nbytes = (itemsize * batch * d * (2 * hq * nq + 2 * hkv * nk)
              + 4 * batch * hq * nq)
    return flops, nbytes

