"""Token sampling (port of `flash_attention_tpu/models/sampling.py`).

Greedy decoding is argmax (first index of the maximum, as jnp.argmax).
Temperature sampling draws from an explicit torch.Generator; its random
stream differs from jax.random's, so only greedy transcripts are
comparable across the two packages.
"""

from __future__ import annotations

import torch


def apply_top_p(logits, top_p):
    """Nucleus filter: keep the smallest descending-sorted set whose
    cumulative mass reaches p (the argmax always survives). `top_p` is a
    scalar or a per-row [B] tensor; rows with p <= 0 or p >= 1 pass
    through unfiltered."""
    p = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device)
    if p.ndim == 1:
        p = p[:, None]
    active = (p > 0.0) & (p < 1.0)
    p_eff = torch.where(active, p, torch.ones_like(p))
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep = (csum - probs) < p_eff
    thr = torch.where(keep, sorted_logits,
                      torch.full_like(sorted_logits, float("inf")))
    thr = thr.amin(dim=-1, keepdim=True)
    return logits.masked_fill(active & (logits < thr), float("-inf"))


def sample(logits, generator: torch.Generator | None = None, *,
           temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0):
    """logits [B, vocab] -> token ids [B] (int32). temperature 0 =
    greedy; top_k keeps the k best, top_p (nucleus) the smallest set
    reaching mass p."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    if 0.0 < top_p < 1.0:
        logits = apply_top_p(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def generate(params, prompt_tokens, cfg, *, max_new_tokens: int,
             max_len: int | None = None, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 0.0,
             generator: torch.Generator | None = None):
    """Simple generate loop over the contiguous cache: prefill, then one
    decode_step (attention on B5) per further token -- a Python loop in
    place of the JAX version's lax.scan. prompt_tokens: [B, T] on the
    parameters' device. Returns int32 [B, max_new_tokens]."""
    from flash_attention_tpu_torch.models.llama import (
        decode_step, init_kv_cache, prefill,
    )

    b, t = prompt_tokens.shape
    if max_len is None:
        max_len = t + max_new_tokens
    max_len = -(-max_len // 128) * 128    # the JAX package's cache length
    device = params["embed"].device
    cache = init_kv_cache(cfg, b, max_len, device=device)
    tokens = torch.as_tensor(prompt_tokens, device=device).long()
    logits, cache, lengths = prefill(params, tokens, cfg, cache)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    tok = sample(logits, generator, **kw)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache, lengths = decode_step(params, tok.long(), cfg, cache,
                                             lengths)
        tok = sample(logits, generator, **kw)
        out.append(tok)
    return torch.stack(out, dim=1)
