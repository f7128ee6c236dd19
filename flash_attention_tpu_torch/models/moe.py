"""Mixture-of-Experts model family, single-device serving path (port of
`flash_attention_tpu/models/moe.py`).

Each layer's dense MLP becomes a router (fp32 [d, E]) and per-expert
SwiGLU stacks w_gate / w_up [E, d, ffn], w_down [E, ffn, d]; the
parameter dict keeps the JAX package's layout, so JAX trees carry across
(utils/convert.py). The FFN dispatches on the `router` key
(models/llama.py `_mlp_block`), so every serving path -- `prefill_kv`,
`decode_step_paged_multi` under the `Engine`, `prefill` / `decode_step`
under `generate` -- runs MoE models unchanged.

Two routings, as in the JAX package:

  * "capacity": GShard top-k routing with a static per-expert capacity;
    dispatch and combine are dense one-hot [n, E, C] cubes, a token that
    overflows its expert is dropped and its gate renormalised away;
  * "dropless" (the serving path): a dispatch of at least
    GROUPED_MIN_TOKENS tokens (FA_TPU_GROUPED_MIN_TOKENS, read per call)
    sorts its top-k choices by expert and runs the grouped kernel B9
    (ops/grouped.py) three times; a smaller one, every decode step among
    them, runs the capacity cubes with capacity = n, which drop nothing.

Expert-parallel placements (`ep_axis`, `expert_shard_axis`) raise: they
arrive with the multi-device slice, with MoE training
(`moe_loss_fn`, `make_moe_train_step`, `moe_param_shardings`).
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.nn.functional as F

from flash_attention_tpu_torch.config import resolve_device
from flash_attention_tpu_torch.models.llama import (
    LlamaConfig,
    _attention_block,
    _mm,
    rmsnorm,
)
from flash_attention_tpu_torch.models.quantized import (
    EXPERT_STACK_TYPES,
    Int4ExpertStack,
    QuantizedExpertStack,
)
from flash_attention_tpu_torch.ops.grouped import (
    grouped_int4_matmul,
    grouped_matmul,
    grouped_quant_matmul,
)

_MULTI_DEVICE = ("expert-parallel placement (ep_axis / expert_shard_axis) "
                 "arrives with the multi-device slice")


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    load_balance_coef: float = 1e-2
    router_z_coef: float = 1e-3
    # "capacity" (one-hot cubes, drops on overflow) or "dropless"
    # (sort-by-expert + grouped kernel B9 for large dispatches).
    routing: str = "capacity"

    @staticmethod
    def tiny_moe(**kw) -> "MoEConfig":
        return MoEConfig(
            vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=512, n_experts=8, top_k=2, **kw)

    @staticmethod
    def mixtral_8x7b(**kw) -> "MoEConfig":
        """Mixtral-8x7B-class shapes (8 experts, top-2). Any field may be
        overridden (n_layers=16 fits a bf16 tree on one 80 GB card)."""
        base = dict(
            vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, ffn_dim=14336, n_experts=8, top_k=2)
        base.update(kw)
        return MoEConfig(**base)


def expert_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Static per-expert slot count, rounded up to a multiple of 8."""
    c = math.ceil(cfg.top_k * n_tokens * cfg.capacity_factor
                  / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def init_moe_params(cfg: MoEConfig, seed: int = 0, *,
                    device="cuda") -> dict:
    """Llama-style init with each layer's MLP replaced by a router and
    per-expert SwiGLU stacks [E, ...], from a seeded torch.Generator on
    `device`. The draws differ from jax.random's for the same seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, hd, f, e = cfg.dim, cfg.head_dim, cfg.ffn_dim, cfg.n_experts

    def normal(shape, fan_in, dtype):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(dtype)

    def dense(shape, fan_in):
        return normal(shape, fan_in, cfg.dtype)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=dev)

    embed = dense((cfg.vocab_size, d), d)
    lm_head = dense((d, cfg.vocab_size), d)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "attn_norm": ones(d),
            "wq": dense((d, cfg.n_heads, hd), d),
            "wk": dense((d, cfg.n_kv_heads, hd), d),
            "wv": dense((d, cfg.n_kv_heads, hd), d),
            "wo": dense((cfg.n_heads, hd, d), cfg.n_heads * hd),
            "mlp_norm": ones(d),
            # The router stays fp32: gate order is precision-sensitive.
            "router": normal((d, e), d, torch.float32),
            "w_gate": dense((e, d, f), d),
            "w_up": dense((e, d, f), d),
            "w_down": dense((e, f, d), f),
        })
    return {"embed": embed, "layers": layers, "final_norm": ones(d),
            "lm_head": lm_head}


def _one_hot(idx, n: int, dtype):
    """jax.nn.one_hot: an index outside [0, n) gives an all-zero row
    (F.one_hot would fault on it)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def router_logits(flat, router):
    """flat @ router in true fp32. A TF32 product would flip expert
    choices, so TF32 is off for this product whatever the process's
    matmul setting."""
    if not flat.is_cuda:
        return flat.float() @ router
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return flat.float() @ router
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def route_tokens(logits, top_k: int, capacity: int):
    """GShard top-k capacity routing.

    logits: [n, E] fp32 router scores. Returns (dispatch [n, E, C] {0, 1},
    combine [n, E, C] gate weights, aux dict). Lower-k choices take slot
    priority; a choice whose expert is full is dropped and its gate
    renormalised away over the surviving choices. Ties go to the lowest
    expert index (torch.argmax, as jnp.argmax)."""
    n, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    masked = probs
    choices, gates = [], []
    for _ in range(top_k):
        oh = _one_hot(torch.argmax(masked, dim=-1), e, probs.dtype)
        gates.append((probs * oh).sum(dim=-1))
        choices.append(oh)
        masked = masked * (1.0 - oh)

    def slots(oh, counts):
        # Slot = the expert's running fill + this token's rank among
        # same-choice tokens (exclusive prefix count).
        pos = torch.cumsum(oh, dim=0) - oh + counts[None, :]
        slot = (pos * oh).sum(dim=-1).to(torch.int32)
        # one_hot of an out-of-capacity slot is all-zero: the drop.
        return oh[:, :, None] * _one_hot(slot, capacity, probs.dtype)[:, None]

    counts = torch.zeros(e, dtype=torch.float32, device=logits.device)
    dispatch = torch.zeros((n, e, capacity), dtype=probs.dtype,
                           device=logits.device)
    kept_gates = []
    for oh, gate in zip(choices, gates):
        d_k = slots(oh, counts)
        dispatch = dispatch + d_k
        kept_gates.append(gate * d_k.sum(dim=(1, 2)))
        counts = counts + oh.sum(dim=0)

    denom = sum(kept_gates) + 1e-9
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros_like(counts)
    for oh, kg in zip(choices, kept_gates):
        combine = combine + (kg / denom)[:, None, None] * slots(oh, counts)
        counts = counts + oh.sum(dim=0)

    # Switch load-balance loss over top-1 assignments; router z-loss.
    aux = {
        "load_balance": e * (choices[0].mean(dim=0)
                             * probs.mean(dim=0)).sum(),
        "router_z": (torch.logsumexp(logits, dim=-1) ** 2).mean(),
        "dropped_frac": 1.0 - dispatch.sum() / (n * len(choices)),
    }
    return dispatch, combine, aux


# Dispatch size from which the dropless path sorts and runs B9; smaller
# dispatches take the drop-free one-hot cubes. The JAX package's value,
# kept for parity (where the crossover lies on an H100 is reported by
# chip_smoke.py). FA_TPU_GROUPED_MIN_TOKENS overrides it, read per call.
GROUPED_MIN_TOKENS = 4096


def dropless_dispatch_path(n_tokens: int) -> str:
    """'grouped' (sort-by-expert + B9) for a dispatch of at least the
    threshold, 'onehot' (drop-free capacity cubes) below it."""
    thr = int(os.environ.get("FA_TPU_GROUPED_MIN_TOKENS",
                             GROUPED_MIN_TOKENS))
    return "grouped" if n_tokens >= thr else "onehot"


def moe_mlp(layer, x, cfg: MoEConfig, ep_axis=None, expert_shard_axis=None,
            capacity=None):
    """Capacity-routed expert MLP, every expert on this device. x:
    [B, T, d]. Returns (y, aux). `capacity` overrides the
    capacity-factor formula; capacity=n (the token count) drops
    nothing: the dropless path's small-dispatch route."""
    if ep_axis is not None or expert_shard_axis is not None:
        raise NotImplementedError(_MULTI_DEVICE)
    b, t, d = x.shape
    n = b * t
    flat = rmsnorm(x, layer["mlp_norm"], cfg.norm_eps).reshape(n, d)
    logits = router_logits(flat, layer["router"])
    if capacity is None:
        capacity = expert_capacity(n, cfg)
    else:
        capacity = max(8, -(-int(capacity) // 8) * 8)
    dispatch, combine, aux = route_tokens(logits, cfg.top_k, capacity)
    xs = torch.einsum("nec,nd->ecd", dispatch.to(flat.dtype), flat)
    g = _expert_stack_mm(xs, layer["w_gate"])
    u = _expert_stack_mm(xs, layer["w_up"])
    ys = _expert_stack_mm(F.silu(g) * u, layer["w_down"])
    y = torch.einsum("nec,ecd->nd", combine.to(flat.dtype), ys)
    return y.reshape(b, t, d), aux


def route_topk(logits, top_k: int):
    """Dropless top-k routing: softmax probabilities, the top-k experts
    per token (ties to the lowest index, as lax.top_k), kept gates
    renormalised. Returns (gates [n, k] fp32, experts [n, k] int32)."""
    probs = torch.softmax(logits, dim=-1)
    masked = probs.clone()
    experts = []
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=-1)
        experts.append(idx)
        masked.scatter_(1, idx[:, None], float("-inf"))
    experts = torch.stack(experts, dim=1)
    gates = torch.gather(probs, 1, experts)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates, experts.to(torch.int32)


def _expert_stack_mm(xs, w, group_sizes=None, base=None):
    """Expert products. Capacity path (group_sizes None): xs [E, C, d]
    batched against the stack, a quantized stack dequantized whole.
    Grouped path: xs [M, d] expert-sorted rows through B9, dequantizing
    in the kernel; rows outside [base, base + sum(group_sizes)) give 0."""
    if group_sizes is None:
        if isinstance(w, EXPERT_STACK_TYPES):
            w = w.dequant(xs.dtype)
        return torch.einsum("ecd,edf->ecf", xs, w)
    if isinstance(w, Int4ExpertStack):
        return grouped_int4_matmul(xs, group_sizes, w.packed, w.scales,
                                   base=base)
    if isinstance(w, QuantizedExpertStack):
        return grouped_quant_matmul(xs, group_sizes, w.q, w.scale,
                                    base=base)
    return grouped_matmul(xs, group_sizes, w, base=base)


def moe_mlp_grouped(layer, x, cfg: MoEConfig, expert_shard_axis=None):
    """Dropless expert MLP by sort-by-expert + the grouped kernel B9.

    x: [B, T, d]. Returns (y, aux) like moe_mlp. Every top-k assignment
    computes; one stable argsort over the n*k expert ids orders the rows,
    the combine gathers through the inverse permutation. Nothing leaves
    the device: group sizes and offsets are device tensors."""
    if expert_shard_axis is not None:
        raise NotImplementedError(_MULTI_DEVICE)
    b, t, d = x.shape
    n = b * t
    k = cfg.top_k
    flat = rmsnorm(x, layer["mlp_norm"], cfg.norm_eps).reshape(n, d)
    logits = router_logits(flat, layer["router"])
    gates, experts = route_topk(logits, k)

    flat_e = experts.reshape(-1)                          # [n*k]
    perm = torch.argsort(flat_e, stable=True)             # sorted <- flat
    xs = flat[perm // k]                                  # [n*k, d]
    # bincount without a host sync (torch.bincount reads the max).
    group_sizes = _one_hot(flat_e, cfg.n_experts, torch.int32).sum(dim=0)

    g = _expert_stack_mm(xs, layer["w_gate"], group_sizes)
    u = _expert_stack_mm(xs, layer["w_up"], group_sizes)
    a = F.silu(g) * u
    yd = _expert_stack_mm(a.to(flat.dtype), layer["w_down"], group_sizes)

    inv = torch.empty_like(perm)                          # flat -> sorted
    inv[perm] = torch.arange(n * k, device=perm.device)
    ys = yd[inv.reshape(n, k)]                            # [n, k, d]
    y = (ys * gates.to(ys.dtype)[..., None]).sum(dim=1)
    probs = torch.softmax(logits, dim=-1)
    aux = {
        "load_balance": cfg.n_experts * (
            _one_hot(experts[:, 0], cfg.n_experts, torch.float32
                     ).mean(dim=0) * probs.mean(dim=0)).sum(),
        "router_z": (torch.logsumexp(logits, dim=-1) ** 2).mean(),
        "dropped_frac": torch.zeros((), dtype=torch.float32,
                                    device=x.device),
    }
    return y.reshape(b, t, d), aux


def moe_forward(params, tokens, cfg: MoEConfig, *, positions=None,
                ep_axis=None):
    """Logits [B, T, vocab] and the mean aux dict over layers. Dropless
    routing runs moe_mlp_grouped at every dispatch size, as in the JAX
    package (the serving paths dispatch by size in `_mlp_block`).
    Forward only: `remat` arrives with MoE training."""
    if ep_axis is not None:
        raise NotImplementedError(_MULTI_DEVICE)
    t = tokens.shape[1]
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=tokens.device)
    x = params["embed"][tokens]
    totals = {"load_balance": 0.0, "router_z": 0.0, "dropped_frac": 0.0}

    def layer_fn(x, layer):
        a, _ = _attention_block(layer, x, cfg, positions)
        x = x + a
        if cfg.routing == "dropless":
            y, aux = moe_mlp_grouped(layer, x, cfg)
        else:
            y, aux = moe_mlp(layer, x, cfg)
        return x + y, aux

    for layer in params["layers"]:
        x, aux = layer_fn(x, layer)
        totals = {key: totals[key] + aux[key] for key in totals}
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _mm("btd,dv->btv", x, params["lm_head"])
    return logits, {key: v / cfg.n_layers for key, v in totals.items()}
