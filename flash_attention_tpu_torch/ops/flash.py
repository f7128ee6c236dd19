"""Flash attention forward and backward (port of
`flash_attention_tpu/ops/flash.py`).

`flash_attention_fwd` launches the hand-written CUDA kernel
`csrc/flash_fwd.cu` (B1, the port of the Pallas `_fwd_kernel`);
`flash_attention_bwd` launches `csrc/flash_bwd.cu` (B2, dQ, the port of
`_bwd_dq_kernel`, then B3, dK/dV, the port of `_bwd_dkv_kernel`). On CPU
tensors each runs its plain PyTorch version (`flash_attention_fwd_plain`,
`flash_attention_bwd_plain`). A CUDA tensor never reaches a plain
version: it launches the kernel or raises. `flash_attention` binds the
two as a `torch.autograd.Function` (the JAX package's `custom_vjp`).

Sliding windows, segment ids and quantized KV arrive with later slices
and raise NotImplementedError until then.
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

# Launches of the B1, B2 and B3 kernels (each incremented only where its
# kernel is launched).
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0


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


def _visible_mask(nq, nk, causal, offset, device):
    """[Nq, Nk] bool, True where row r sees column c (c <= r + offset
    when causal), or None when every pair is visible."""
    if not causal:
        return None
    row = torch.arange(nq, device=device)[:, None]
    col = torch.arange(nk, device=device)[None, :]
    return col <= row + offset


def flash_attention_fwd_plain(q, k, v, *, causal=False, scale, offset):
    """B1's function in plain PyTorch: fp32 scores and softmax
    statistics, probabilities rounded to the input dtype for the PV
    product (the kernel's numerics), LSE [B, Hq, Nq] fp32."""
    hq, hkv = q.shape[1], k.shape[1]
    kk = torch.repeat_interleave(k, hq // hkv, dim=1).float()
    vv = torch.repeat_interleave(v, hq // hkv, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    visible = _visible_mask(s.shape[-2], s.shape[-1], causal, offset,
                            s.device)
    if visible is not None:
        s = s.masked_fill(~visible, float("-inf"))
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


def _check_cuda_inputs(kernel, q, k, v, **more):
    """What every CUDA entry point takes: fp16/bf16 q, k, v (and `more`)
    of one dtype, a built head dim, one device, contiguous."""
    tensors = dict(q=q, k=k, v=v, **more)
    if q.dtype not in _cuda.DTYPE_CODES or any(
            t.dtype != q.dtype for t in tensors.values()):
        raise TypeError(f"{kernel} takes fp16/bf16 inputs of one dtype "
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


def _flash_fwd_cuda(q, k, v, *, causal, scale, offset):
    global flash_fwd_launches
    batch, hq, nq, d = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    _check_cuda_inputs("B1", q, k, v)
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


def _bwd_delta(o, do):
    """delta = rowsum(dO * O) in fp32, [B, Hq, Nq]: computed before the
    backward kernels, as the JAX package does in XLA outside its Pallas
    kernels (flash.py:879-881)."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=False,
                              scale, offset):
    """B2 and B3's function in plain PyTorch: the recompute backward
    with the kernels' roundings. P = exp(s*scale - lse) is exactly 0 on
    hidden pairs (by select, so a row that sees no key yields zero
    gradients), dP = dO V^T, dS = P (dP - delta) scale with delta =
    rowsum(dO O) in fp32, dQ = dS K, dK = dS^T Q, dV = P^T dO; P is
    rounded to dO's dtype before the dV product and dS to the input
    dtype before the dQ and dK products. GQA gradients are summed over
    the q heads of each group. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    batch, hq, nq, d = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    group = hq // hkv
    kk = torch.repeat_interleave(k, group, dim=1).float()
    vv = torch.repeat_interleave(v, group, dim=1).float()
    qf, dof = q.float(), do.float()
    delta = _bwd_delta(o, do)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kk)
    p = torch.exp(s * scale - lse[..., None])
    visible = _visible_mask(nq, nk, causal, offset, q.device)
    if visible is not None:
        p = torch.where(visible, p, torch.zeros_like(p))
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vv)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), dof)
    dk = dk.reshape(batch, hkv, group, nk, d).sum(dim=2)
    dv = dv.reshape(batch, hkv, group, nk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _launch_bwd(entry, q, k, v, do, lse, delta, outs, *, causal, scale,
                offset):
    batch, hq, nq, d = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    return getattr(_cuda.lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
        batch, hq, hkv, nq, nk, d, int(causal), offset, scale,
        _cuda.DTYPE_CODES[q.dtype], _cuda.stream_handle(q.device))


def _bwd_dq_cuda(q, k, v, do, lse, delta, *, causal, scale, offset):
    """Launch B2; returns dq."""
    global flash_bwd_dq_launches
    dq = torch.empty_like(q)
    code = _launch_bwd("fa_flash_bwd_dq", q, k, v, do, lse, delta, (dq,),
                       causal=causal, scale=scale, offset=offset)
    flash_bwd_dq_launches += 1
    _cuda.check(code, "flash_bwd_dq")
    return dq


def _bwd_dkv_cuda(q, k, v, do, lse, delta, *, causal, scale, offset):
    """Launch B3; returns (dk, dv)."""
    global flash_bwd_dkv_launches
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    code = _launch_bwd("fa_flash_bwd_dkv", q, k, v, do, lse, delta,
                       (dk, dv), causal=causal, scale=scale, offset=offset)
    flash_bwd_dkv_launches += 1
    _cuda.check(code, "flash_bwd_dkv")
    return dk, dv


def _flash_bwd_cuda(q, k, v, o, lse, do, *, causal, scale, offset):
    batch, hq, nq, _ = q.shape
    nk = k.shape[2]
    _check_cuda_inputs("B2/B3", q, k, v, o=o, do=do)
    if lse.shape != (batch, hq, nq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous fp32 [B, Hq, Nq] "
                         f"tensor on {q.device}")
    if not batch * hq * nq * nk:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = _bwd_delta(o, do)
    kw = dict(causal=causal, scale=scale, offset=offset)
    dq = _bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk, dv = _bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, segment_ids=None, *,
                        causal=False, scale=None, offset=None,
                        window=None):
    """Recompute backward: returns (dq, dk, dv) for the forward's o and
    fp32 lse [B, Hq, Nq] and the output cotangent do. Launches B2 (dQ)
    then B3 (dK/dV) on CUDA tensors; runs flash_attention_bwd_plain on
    CPU tensors."""
    scale, offset = _check_args(q, k, v, segment_ids, causal, scale,
                                offset, window)
    if q.is_cuda:
        return _flash_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                               scale=scale, offset=offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do,
                                         causal=causal, scale=scale,
                                         offset=offset)
    raise ValueError(f"unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """The port of the JAX `custom_vjp` (flash.py:1056-1090): the
    forward saves q, k, v, o and the fp32 LSE; the backward recomputes
    P from them (B2, B3)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, offset):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                     offset=offset, save_residuals=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.offset = causal, scale, offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            scale=ctx.scale, offset=ctx.offset)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, segment_ids=None, *, causal: bool = False,
                    scale: float | None = None, offset: int | None = None,
                    window: int | None = None):
    """Differentiable flash attention (public API): B1 forward, B2/B3
    backward on CUDA tensors, their plain versions on CPU tensors.

    q: [B, Hq, Nq, D]; k, v: [B, Hkv, Nk, D] with Hkv | Hq. Causal
    visibility is col <= row + offset, offset defaulting to Nk - Nq.
    """
    scale, offset = _check_args(q, k, v, segment_ids, causal, scale,
                                offset, window)
    return _FlashAttention.apply(q, k, v, causal, scale, offset)


def _visible_pairs(nq, nk, causal):
    """(row, col) pairs that attend, with the default offset Nk - Nq."""
    if not causal:
        return nq * nk
    offset = nk - nq
    return sum(max(0, min(nk, r + offset + 1)) for r in range(nq))


def fwd_cost(batch, hq, hkv, nq, nk, d, causal, itemsize):
    """(flops, bytes) B1 must do at least: the QK^T and PV products over
    the visible (row, col) pairs, each input read once, O and LSE written
    once."""
    pairs = _visible_pairs(nq, nk, causal)
    flops = 4 * batch * hq * pairs * d
    nbytes = (itemsize * batch * d * (2 * hq * nq + 2 * hkv * nk)
              + 4 * batch * hq * nq)
    return flops, nbytes


def bwd_cost(batch, hq, hkv, nq, nk, d, causal, itemsize):
    """((flops, bytes) of B2, (flops, bytes) of B3): the least each must
    do over the visible (row, col) pairs. B2 recomputes S and dP and
    forms dQ (6 D FLOPs a pair), reading q, dO, k, v, LSE and delta once
    and writing dq once; B3 recomputes S and dP and forms dK and dV (8 D
    FLOPs a pair), reading q, dO, k, v, LSE and delta once and writing
    dk and dv once."""
    pairs = batch * hq * _visible_pairs(nq, nk, causal)
    stats = 8 * batch * hq * nq                  # fp32 LSE and delta
    dq = (6 * d * pairs,
          itemsize * batch * d * (2 * hq * nq + 2 * hkv * nk + hq * nq)
          + stats)
    dkv = (8 * d * pairs,
           itemsize * batch * d * (2 * hq * nq + 4 * hkv * nk) + stats)
    return dq, dkv

