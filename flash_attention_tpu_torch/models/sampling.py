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


def _categorical(logits, generator):
    """One draw per row from softmax(logits) by the Gumbel-max trick, as
    jax.random.categorical draws (a -inf logit is never drawn); no host
    sync on the card."""
    u = torch.rand(logits.shape, generator=generator,
                   device=logits.device).clamp_(min=1e-20)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def speculative_sample(logits, tokens, temps, top_ps, generator=None, *,
                       all_greedy: bool | None = None):
    """Rejection-scheme speculative sampling over one multi-token verify
    dispatch, for a deterministic (point-mass) draft:

      * position i's target p_i = softmax of the (temperature + nucleus)
        filtered logits; draft d_{i+1} is accepted with probability
        p_i(d_{i+1});
      * at the first rejection a the correction token is drawn from p_a
        with the draft token masked out and renormalised;
      * if every draft is accepted, a bonus token is drawn from p_k.

    The emitted tokens follow sequential sampling from p exactly; greedy
    rows (temps <= 0) accept by argmax equality. The draws come from
    `generator` (a torch.Generator on the logits' device), so sampled
    rows keep the sampling law of the JAX version, not its tokens.

    logits [B, k+1, V] (position i predicts the token after input i);
    tokens [B, k+1] int ([next_token, k drafts]); temps, top_ps [B] fp32
    tensors on the logits' device. `all_greedy` (from the requests'
    temperatures, which the host holds) takes the greedy path without
    looking at `temps`: an all-greedy batch neither sorts nor softmaxes
    the vocabulary. When it is None it is read from `temps` (a host sync
    for a tensor on the card).

    Returns (out [B, k+1] int32, accepted [B] int32): row b emits
    out[b, :accepted[b] + 1].
    """
    b, kp1, v = logits.shape
    k = kp1 - 1
    dev = logits.device
    logits = logits.float()
    tokens = tokens.long()
    greedy = torch.argmax(logits, dim=-1)                      # [B, k+1]
    drafts = tokens[:, 1:]                                     # [B, k]
    if all_greedy is None:
        all_greedy = bool((torch.as_tensor(temps) <= 0.0).all())

    def emit(accepted, corr):
        pos = torch.arange(kp1, device=dev)[None, :]
        dpad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
        out = torch.where(pos == accepted[:, None], corr[:, None], dpad)
        return out.to(torch.int32), accepted.to(torch.int32)

    def first_rejection(acc):
        # Accepted drafts: the leading run of accepts (k = all accepted).
        if not k:
            return torch.zeros(b, dtype=torch.long, device=dev)
        return torch.cumprod(acc.long(), dim=1).sum(dim=1)

    if all_greedy:
        accepted = first_rejection(greedy[:, :k] == drafts)
        return emit(accepted, greedy.gather(1, accepted[:, None])[:, 0])

    temps = temps.to(dev, torch.float32)
    tsafe = temps.clamp(min=1e-6)[:, None, None]
    filt = apply_top_p((logits / tsafe).reshape(b * kp1, v),
                       top_ps.to(dev).repeat_interleave(kp1)
                       ).reshape(b, kp1, v)
    is_greedy = temps <= 0.0                                   # [B]
    if k:
        p = torch.softmax(filt[:, :k], dim=-1)
        p_draft = p.gather(2, drafts[..., None])[..., 0]       # [B, k]
        u = torch.rand((b, k), generator=generator, device=dev)
        acc = torch.where(is_greedy[:, None], greedy[:, :k] == drafts,
                          u < p_draft)
    accepted = first_rejection(acc if k else None)
    # Correction at position `accepted`: p_a without the draft token on a
    # rejection, p_k itself when every draft was accepted.
    filt_a = filt.gather(1, accepted[:, None, None].expand(b, 1, v))[:, 0]
    if k:
        d_a = tokens.gather(1, (accepted + 1).clamp(max=k)[:, None])[:, 0]
        hit = torch.zeros_like(filt_a, dtype=torch.bool).scatter_(
            1, d_a[:, None], True)
        filt_a = filt_a.masked_fill(hit & (accepted < k)[:, None],
                                    float("-inf"))
    corr = torch.where(is_greedy, greedy.gather(1, accepted[:, None])[:, 0],
                       _categorical(filt_a, generator))
    return emit(accepted, corr)


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
