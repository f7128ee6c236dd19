"""Exact attention references in plain PyTorch (port of
`flash_attention_tpu/ops/reference.py`).

All math runs in float32 with full-precision matmuls; these are the
ground truth the kernels are held against. Layout: q [B, Hq, Nq, D],
k/v [B, Hkv, Nk, D] with Hkv | Hq; query head h reads kv head
h // (Hq // Hkv). Causal masking hides kv positions col > row + offset
with offset = Nk - Nq.
"""

from __future__ import annotations

import torch


def _expand_kv_heads(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    num_kv_heads = k.shape[1]
    if num_kv_heads == num_q_heads:
        return k
    if num_q_heads % num_kv_heads:
        raise ValueError(
            f"Hq={num_q_heads} not a multiple of Hkv={num_kv_heads}")
    return torch.repeat_interleave(k, num_q_heads // num_kv_heads, dim=1)


def _scores(q, k, scale):
    k = _expand_kv_heads(k, q.shape[1])
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale


def _causal_mask(s, offset: int, window: int | None = None):
    nq, nk = s.shape[-2], s.shape[-1]
    row = torch.arange(nq, device=s.device)[:, None]
    col = torch.arange(nk, device=s.device)[None, :]
    bad = col > row + offset
    if window is not None:
        bad = bad | (col <= row + offset - window)
    return s.masked_fill(bad, float("-inf"))


def attention_reference(q, k, v, *, causal: bool = False,
                        scale: float | None = None,
                        window: int | None = None):
    """Exact attention in fp32, one-shot softmax; output in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if window is not None and not causal:
        raise ValueError("sliding window requires causal=True")
    s = _scores(q, k, scale)
    if causal:
        s = _causal_mask(s, s.shape[-1] - s.shape[-2], window)
    p = torch.softmax(s, dim=-1)
    v = _expand_kv_heads(v, q.shape[1]).float()
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def attention_reference_with_lse(q, k, v, *, causal: bool = False,
                                 scale: float | None = None):
    """Exact attention that also returns the fp32 log-sum-exp rows
    [B, Hq, Nq]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, scale)
    if causal:
        s = _causal_mask(s, s.shape[-1] - s.shape[-2])
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    v = _expand_kv_heads(v, q.shape[1]).float()
    o = torch.einsum("bhqk,bhkd->bhqd", p / l, v)
    return o.to(q.dtype), (m + torch.log(l))[..., 0]



def attention_baseline(q, k, v, *, causal: bool = False,
                       scale: float | None = None):
    """Two-pass exact softmax in fp32 (pass 1 the row max, pass 2 exp,
    sum and the weighted sum), written as the naive baseline is: a plain
    einsum, as the JAX package leaves it to XLA (no kernel). Output in
    q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, scale)
    if causal:
        s = _causal_mask(s, s.shape[-1] - s.shape[-2])
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    v = _expand_kv_heads(v, q.shape[1]).float()
    return torch.einsum("bhqk,bhkd->bhqd", p / l, v).to(q.dtype)


def attention_lowp_baseline(q, k, v, *, causal: bool = False,
                            scale: float | None = None):
    """Low-precision baseline with the flash kernels' numerics: fp32
    scores and softmax statistics, probabilities rounded to the input
    dtype for the PV product (fp32 accumulation). The yardstick of the
    3x-error gate for bf16 / fp16 kernels."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, scale)
    if causal:
        s = _causal_mask(s, s.shape[-1] - s.shape[-2])
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    v = _expand_kv_heads(v, q.shape[1])
    pv = torch.einsum("bhqk,bhkd->bhqd", (p / l).to(q.dtype).float(),
                      v.float())
    return pv.to(q.dtype)
