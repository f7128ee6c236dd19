"""Llama-class decoder-only transformer in PyTorch (port of
`flash_attention_tpu/models/llama.py`, serving and dense training
paths).

Architecture: RMSNorm -> GQA attention (interleaved RoPE on q/k) ->
residual -> RMSNorm -> SwiGLU MLP -> residual; untied output head.
Parameters are a plain dict in the JAX package's layout (wq [d, H, hd],
wk/wv [d, Hkv, hd], wo [H, hd, d], w_gate/w_up [d, ffn], w_down
[ffn, d], embed [vocab, d], lm_head [d, vocab]), so JAX trees carry
across unchanged (utils/convert.py). Prefill and training attention run
the B1 flash kernel, and its backward the B2/B3 kernels; chunked prefill
(`prefill_chunk_step`, and `prefill_window_chunk_step` with a rolling
buffer for sliding-window models) runs B1 twice per layer with segment
ids and windows, LSE-merged; paged decode attention runs the B4 paged
kernel over the read-only pages (with per-sequence window starts under a
window) plus plain attention over the dense hot tail, merged by their
log-sum-exps; contiguous-cache decode (`decode_step`, used by
`sampling.generate`) runs B5. Weight products go through `_mm`: dense weights are torch
matmuls, as the JAX package leaves them to XLA (or B8 under
FA_TPU_DENSE_PALLAS_MM), quantized weights (models/quantized.py) run the
B6 / B7 kernels. A layer with a `router` is an MoE layer
(models/moe.py), whose expert products run the grouped kernel B9.

Tensor parallelism (`tp_axis=`, Megatron's layout as in the JAX
package): `serving_param_shardings` splits q / k / v and wo over heads,
the MLP over ffn and lm_head over the vocab; each rank runs the serving
paths on its shard (head counts come from the local weights and caches)
and one sum all-reduce after each row-parallel product plus one tiled
all-gather of the logits (parallel/collectives.py) stitch the result
back. `tp_axis` is the tensor-parallel process group (`mesh.get_group(
"tp")`) where JAX names a mesh axis inside `shard_map`; None is one
device. Every rank of the group makes the same call on the same
replicated inputs (SPMD).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from flash_attention_tpu_torch.config import resolve_device
from flash_attention_tpu_torch.models.quantized import (
    QUANT_LEAF_TYPES,
    _weight_einsum,
)
from flash_attention_tpu_torch.ops.decode import flash_decode
from flash_attention_tpu_torch.ops.flash import (
    SegmentIds,
    flash_attention,
    flash_attention_fwd,
)
from flash_attention_tpu_torch.ops.paged import paged_flash_decode
from flash_attention_tpu_torch.ops.quant_matmul import dense_matmul
from flash_attention_tpu_torch.parallel.collectives import (
    all_gather_tiled,
    all_reduce_sum,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    # Sliding-window attention; None = full causal attention.
    window: int | None = None
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test-scale config."""
        base = dict(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                    n_kv_heads=2, ffn_dim=512)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama3_1b(**kw) -> "LlamaConfig":
        """1B-class serving workhorse: the JAX package's preset (16 heads
        of dim 128, 8 kv heads, same parameter count as Llama-3.2-1B)."""
        base = dict(vocab_size=128256, dim=2048, n_layers=16, n_heads=16,
                    n_kv_heads=8, ffn_dim=8192)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        base = dict(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                    n_kv_heads=8, ffn_dim=14336)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def mistral_7b(**kw) -> "LlamaConfig":
        """Mistral-7B-class shapes with the 4096-token sliding window."""
        base = dict(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                    n_kv_heads=8, ffn_dim=14336, rope_theta=10000.0,
                    window=4096)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama3_70b(**kw) -> "LlamaConfig":
        base = dict(vocab_size=128256, dim=8192, n_layers=80, n_heads=64,
                    n_kv_heads=8, ffn_dim=28672)
        base.update(kw)
        return LlamaConfig(**base)


# --- parameters ---------------------------------------------------------


def init_params(cfg: LlamaConfig, seed: int = 0, *, device="cuda") -> dict:
    """He-style init from a seeded torch.Generator on `device`, params in
    cfg.dtype. The draws differ from jax.random's for the same seed;
    tests that compare the two packages carry one tree across with
    utils/convert.params_from_jax."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, hd = cfg.dim, cfg.head_dim

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(cfg.dtype)

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
            "w_gate": dense((d, cfg.ffn_dim), d),
            "w_up": dense((d, cfg.ffn_dim), d),
            "w_down": dense((cfg.ffn_dim, d), cfg.ffn_dim),
        })
    return {"embed": embed, "layers": layers, "final_norm": ones(d),
            "lm_head": lm_head}


def serving_param_shardings(cfg: LlamaConfig, tp_size: int) -> dict:
    """Specs for TP serving (Engine under a mesh; port of the JAX
    function): Megatron's column / row split, where each decode product
    is local to a shard and one all-reduce a block stitches the residual
    stream back: attention q / k / v and wo over heads (tp must divide
    n_kv_heads, so each shard owns whole KV-head groups and its slice of
    the paged pools), the MLP's gate / up / down over ffn, lm_head over
    the vocab (the logits all-gather at the end). Embeddings and norms
    replicate. A spec is a tuple of mesh-axis names and None per dim,
    JAX's `tuple(PartitionSpec(...))`; the tree has the parameters'
    structure. An MoE config (n_experts) gets JAX's expert layout (the
    stacks' expert dim over tp, the router replicated; tp must divide
    n_experts): each rank serves its band of experts."""
    if cfg.n_kv_heads % tp_size:
        raise ValueError(
            f"tp={tp_size} must divide n_kv_heads={cfg.n_kv_heads}")
    layer = {
        "attn_norm": (),
        "wq": (None, "tp", None),
        "wk": (None, "tp", None),
        "wv": (None, "tp", None),
        "wo": ("tp", None, None),
        "mlp_norm": (),
        "w_gate": (None, "tp"),
        "w_up": (None, "tp"),
        "w_down": ("tp", None),
    }
    n_experts = getattr(cfg, "n_experts", 0)
    if n_experts:
        if n_experts % tp_size:
            raise ValueError(
                f"tp={tp_size} must divide n_experts={n_experts}")
        layer = {**layer, "router": (),
                 "w_gate": ("tp",), "w_up": ("tp",), "w_down": ("tp",)}
    return {
        "embed": (),
        "layers": [layer] * cfg.n_layers,
        "final_norm": (),
        "lm_head": (None, "tp"),
    }


def param_shardings(cfg: LlamaConfig, tp_size: int | None = None) -> dict:
    """Training specs (port of the JAX function): tp over heads / ffn,
    fsdp over the other large dim. When tp does not divide n_kv_heads
    (GQA with few KV heads on a wide tp axis), the KV projections
    replicate their head dim, as in JAX."""
    kv_tp = "tp" if (tp_size is None or cfg.n_kv_heads % tp_size == 0) \
        else None
    layer = {
        "attn_norm": (),
        "wq": ("fsdp", "tp", None),
        "wk": ("fsdp", kv_tp, None),
        "wv": ("fsdp", kv_tp, None),
        "wo": ("tp", None, "fsdp"),
        "mlp_norm": (),
        "w_gate": ("fsdp", "tp"),
        "w_up": ("fsdp", "tp"),
        "w_down": ("tp", "fsdp"),
    }
    return {
        "embed": ("tp", "fsdp"),
        "layers": [layer] * cfg.n_layers,
        "final_norm": (),
        "lm_head": ("fsdp", "tp"),
    }


# --- building blocks -----------------------------------------------------


class _PsumReduce(torch.autograd.Function):
    """Megatron's reduce-from-region: forward sums over the group;
    backward passes the cotangent unchanged (the reduced output is the
    same on every rank, so each rank's local branch receives it as it
    is)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _TpCopy(torch.autograd.Function):
    """Megatron's copy-to-region: forward is the identity; backward sums
    the cotangent over the group (a replicated activation consumed by
    every rank's local products has the sum of their partials as its
    gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce_sum(ct, ctx.group), None


def _psum(x, tp_axis):
    """Row-parallel reduction: the identity for tp_axis None, else a sum
    over the group (forward all-reduce, backward identity)."""
    return x if tp_axis is None else _PsumReduce.apply(x, tp_axis)


def tp_copy(x, tp_axis):
    """Identity forward; backward all-reduces over `tp_axis`. Placed
    where a replicated activation enters a tensor-parallel region, so the
    gradients of the local products stay exact."""
    return x if tp_axis is None else _TpCopy.apply(x, tp_axis)


def _mm(spec, x, w):
    """Weight einsum, dispatched on the weight's type as in the JAX
    package: a QuantizedWeight or Int4Weight (models/quantized.py) runs
    its fused-dequant kernel (B6 / B7) for at most 1024 activation rows;
    a dense tensor runs torch.einsum (cuBLAS on the card, as XLA's dot on
    the TPU) -- or, with FA_TPU_DENSE_PALLAS_MM set (read per call), the
    weight-streaming kernel B8 for at most 1024 rows. MoE expert stacks
    never come here: models/moe.py `_expert_stack_mm` runs them."""
    if isinstance(w, QUANT_LEAF_TYPES):
        return w.einsum(spec, x)
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"_mm takes a tensor or a quantized weight, not "
            f"{type(w).__name__} (expert stacks go through "
            f"models/moe.py _expert_stack_mm)")
    if os.environ.get("FA_TPU_DENSE_PALLAS_MM") and w.ndim >= 2:
        return _weight_einsum(_DensePallasWeight(w, spec), spec, x)
    return torch.einsum(spec, x, w)


class _DensePallasWeight:
    """Gives a dense weight the quantized-weight einsum protocol
    (orig_shape / n_contract / _matmul2d), so _weight_einsum's 2D
    normalisation is reused: skinny activations stream through B8
    (ops/quant_matmul.py dense_matmul), wide ones stay on torch.matmul."""

    def __init__(self, w, spec):
        ins, _ = spec.split("->")
        xs, ws = ins.split(",")
        self.orig_shape = tuple(w.shape)
        self.n_contract = sum(1 for c in ws if c in xs)
        k = math.prod(w.shape[: self.n_contract])
        self._w2 = w.reshape(k, -1)

    def _matmul2d(self, x2):
        if x2.shape[0] <= 1024:
            return dense_matmul(x2, self._w2)
        return x2 @ self._w2


def rmsnorm(x, w, eps):
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w


@functools.lru_cache(maxsize=8)
def _rope_freqs(d: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(d: int, theta: float, device: torch.device):
    # Kept per device: a copy from host memory on every call would wait
    # for the card's queue (a host sync per layer on the decode path).
    return torch.from_numpy(_rope_freqs(d, theta)).to(device)


def rope(x, positions, theta):
    """Interleaved rotary embedding (pairs x[..., 0::2], x[..., 1::2]).
    x: [B, H, T, D]; positions: [B, T] or [T]."""
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, float(theta), x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[:, None, :, None].float() * freqs     # [B,1,T,D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _attention_block(layer, x, cfg, positions, attn_impl=None,
                     tp_axis=None):
    """Full-sequence attention block (prefill). Returns
    (out [B, T, dim], (k, v)) with k, v [B, Hkv, T, D]. Under tp the
    heads are this rank's shard and the wo product sums over the
    group."""
    h = tp_copy(rmsnorm(x, layer["attn_norm"], cfg.norm_eps), tp_axis)
    q = _mm("btd,dhk->bhtk", h, layer["wq"])
    k = _mm("btd,dhk->bhtk", h, layer["wk"])
    v = _mm("btd,dhk->bhtk", h, layer["wv"]).contiguous()
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if attn_impl is None:
        attn_impl = functools.partial(flash_attention, causal=True,
                                      window=cfg.window)
    o = attn_impl(q, k, v)
    return _psum(_mm("bhtk,hkd->btd", o, layer["wo"]), tp_axis), (k, v)


def _mlp_block(layer, x, cfg, tp_axis=None):
    """FFN block (JAX `llama.py:347-387`). A layer carrying a `router` key
    is a mixture-of-experts layer (models/moe.py; `cfg` is then a
    MoEConfig): this is what lets every path (forward, prefill_kv,
    decode_step_paged_multi, prefill, decode_step) run MoE models without
    a parallel code path. Dropless routing dispatches by size: at least
    GROUPED_MIN_TOKENS tokens (FA_TPU_GROUPED_MIN_TOKENS, read per call)
    sort by expert and run the grouped kernel B9, smaller dispatches --
    every decode step -- the drop-free one-hot cubes (capacity = n).
    Under tp the ffn is this rank's shard and w_down's product sums over
    the group; an MoE layer's stacks hold this rank's band of experts
    (serving_param_shardings) and every route passes the group as
    `expert_shard_axis`: one all-reduce a block either way."""
    if "router" in layer:
        from flash_attention_tpu_torch.models.moe import (
            dropless_dispatch_path, moe_mlp, moe_mlp_grouped,
        )

        if getattr(cfg, "routing", "capacity") == "dropless":
            n = x.shape[0] * x.shape[1]
            if dropless_dispatch_path(n) == "grouped":
                return moe_mlp_grouped(layer, x, cfg,
                                       expert_shard_axis=tp_axis)[0]
            return moe_mlp(layer, x, cfg, expert_shard_axis=tp_axis,
                           capacity=n)[0]
        return moe_mlp(layer, x, cfg, expert_shard_axis=tp_axis)[0]
    h = tp_copy(rmsnorm(x, layer["mlp_norm"], cfg.norm_eps), tp_axis)
    gate = _mm("btd,df->btf", h, layer["w_gate"])
    up = _mm("btd,df->btf", h, layer["w_up"])
    return _psum(_mm("btf,fd->btd", F.silu(gate) * up, layer["w_down"]),
                 tp_axis)


def forward(params, tokens, cfg: LlamaConfig, *, positions=None,
            remat: bool = False, attn_impl=None):
    """Logits [B, T, vocab] for token ids [B, T] (causal training /
    prefill path). Differentiable: it builds an autograd graph when a
    parameter requires grad (call it under torch.no_grad() for
    inference). `remat` recomputes each layer's activations in the
    backward pass instead of keeping them (torch.utils.checkpoint, the
    port of jax.checkpoint). `attn_impl(q, k, v)` replaces the flash
    kernels (e.g. a plain reference for teacher-forced checks)."""
    t = tokens.shape[1]
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32,
                                 device=tokens.device)
    # F.embedding, not indexing: its gradient sums each token's rows in
    # a fixed order (an index's backward accumulates in a thread-dependent
    # order on the CPU, so two runs of one step could differ in the last
    # bit).
    x = F.embedding(tokens, params["embed"])

    def layer_fn(x, layer):
        a, _ = _attention_block(layer, x, cfg, positions,
                                attn_impl=attn_impl)
        x = x + a
        return x + _mlp_block(layer, x, cfg)

    for layer in params["layers"]:
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                layer_fn, x, layer, use_reentrant=False)
        else:
            x = layer_fn(x, layer)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _mm("btd,dv->btv", x, params["lm_head"])


def loss_fn(params, tokens, cfg: LlamaConfig, *, remat: bool = False,
            attn_impl=None):
    """Mean next-token cross-entropy over tokens [B, T] (fp32 logits for
    the softmax), a 0-d fp32 tensor."""
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    logits = forward(params, tokens[:, :-1], cfg, remat=remat,
                     attn_impl=attn_impl).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def param_leaves(params) -> list:
    """The parameter tensors in a fixed order (dict keys sorted, list
    entries in order), independent of how the dict was built: the order
    an optimizer and its state_dict see."""
    if isinstance(params, dict):
        return [t for key in sorted(params)
                for t in param_leaves(params[key])]
    if isinstance(params, (list, tuple)):
        return [t for item in params for t in param_leaves(item)]
    return [params]


def make_train_step(cfg: LlamaConfig, *, remat: bool = False):
    """step(params, optimizer, tokens) -> loss: one optimizer step on the
    next-token loss. `optimizer` is a torch.optim.Optimizer over
    param_leaves(params), which must require grad.

    The JAX step returns new (params, opt_state) trees; this one updates
    the parameters and the optimizer's state in place, so a step holds
    one copy of each instead of two. The loss comes back as a 0-d
    tensor on the parameters' device, without a host sync."""

    def step(params, optimizer, tokens):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, cfg, remat=remat)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


# --- decode path ----------------------------------------------------------


def _lm_head_logits(params, last, tp_axis=None):
    """The lm_head product; under tp the vocab is column-sharded and the
    full logits row reassembles with a tiled all-gather on axis 1."""
    logits = _mm("bd,dv->bv", last, params["lm_head"])
    if tp_axis is not None:
        logits = all_gather_tiled(logits, tp_axis, dim=1)
    return logits


@torch.no_grad()
def prefill_kv(params, tokens, cfg: LlamaConfig, *, true_len=None,
               tp_axis=None):
    """Prompt forward for paged serving: (logits at the last real token
    [B, vocab], ks, vs) with ks/vs [n_layers, B, Hkv, T, D]. `true_len`
    ([B] or int) marks the real prompt length of right-padded `tokens`;
    padded KV positions are garbage the caller must not page in. Under
    tp, ks / vs hold this rank's KV heads, as its pools do."""
    b, t = tokens.shape
    positions = torch.arange(t, dtype=torch.int32, device=tokens.device)
    x = params["embed"][tokens]
    ks, vs = [], []
    for layer in params["layers"]:
        a, (k, v) = _attention_block(layer, x, cfg, positions,
                                     tp_axis=tp_axis)
        ks.append(k)
        vs.append(v)
        x = x + a
        x = x + _mlp_block(layer, x, cfg, tp_axis=tp_axis)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if true_len is None:
        last = x[:, -1]
    else:
        idx = torch.as_tensor(true_len, dtype=torch.long,
                              device=x.device) - 1
        idx = idx.expand(b)
        last = x[torch.arange(b, device=x.device), idx]
    return (_lm_head_logits(params, last, tp_axis), torch.stack(ks),
            torch.stack(vs))


def _lse_merge(o_a, lse_a, o_b, lse_b):
    """Merge two attention partials over disjoint key sets by their
    fp32 log-sum-exps (a side that saw nothing has LSE INIT_M * scale
    and weight exactly 0). o: [B, H, T, D]; lse: [B, H, T]."""
    lse = torch.logaddexp(lse_a, lse_b)
    return (o_a.float() * torch.exp(lse_a - lse)[..., None]
            + o_b.float() * torch.exp(lse_b - lse)[..., None])


def _last_real_row(x, true_count):
    idx = (torch.as_tensor(true_count, dtype=torch.long, device=x.device)
           .expand(x.shape[0]) - 1).clamp(min=0)
    return x[torch.arange(x.shape[0], device=x.device), idx]


@torch.no_grad()
def prefill_chunk_step(params, tokens, cfg: LlamaConfig, k_bufs, v_bufs,
                       prefix_len, true_count, tp_axis=None):
    """One chunk of an incremental (chunked) prefill, batched across
    requests (each row at its own prefix depth).

    Attention for a chunk runs B1 twice per layer and LSE-merges them:
    causal self-attention over the C new rows, and non-causal attention
    over the whole padded KV buffer [T] with positions >= prefix_len[b]
    hidden by segment ids (data, not shape: every chunk of every prompt
    length shares one kernel shape per (B, C, T)).

    tokens: [B, C] ids (garbage-padded past the prompt on the last
    chunk); k_bufs, v_bufs: [L, B, Hkv, T, D] prompt KV buffers, updated
    IN PLACE (row b's chunk KV lands at prefix_len[b]; the JAX version
    returns updated copies); prefix_len, true_count: [B] (or scalar)
    tokens already processed / real tokens in this chunk (logits are
    read at row true_count - 1). Under tp the buffers hold this rank's
    KV heads. Returns (logits [B, vocab], k_bufs, v_bufs).
    """
    b, c = tokens.shape
    t_bucket = k_bufs.shape[3]
    dev = tokens.device
    prefix_len = torch.as_tensor(prefix_len, dtype=torch.int32,
                                 device=dev).expand(b).contiguous()
    ar = torch.arange(c, dtype=torch.int32, device=dev)
    positions = prefix_len[:, None] + ar[None, :]
    # Prefix mask: kv ids flip to 1 at prefix_len; q ids stay 0.
    seg = SegmentIds(
        torch.zeros((b, c), dtype=torch.int32, device=dev),
        (torch.arange(t_bucket, dtype=torch.int32, device=dev)[None, :]
         >= prefix_len[:, None]).to(torch.int32))
    x = params["embed"][tokens]
    new_ks, new_vs = [], []
    for li, layer in enumerate(params["layers"]):
        h = rmsnorm(x, layer["attn_norm"], cfg.norm_eps)
        q = _mm("btd,dhk->bhtk", h, layer["wq"])
        k = _mm("btd,dhk->bhtk", h, layer["wk"])
        v = _mm("btd,dhk->bhtk", h, layer["wv"])
        q = rope(q, positions, cfg.rope_theta).contiguous()
        k = rope(k, positions, cfg.rope_theta).contiguous()
        v = v.contiguous()
        new_ks.append(k)
        new_vs.append(v)
        o_s, lse_s = flash_attention_fwd(q, k, v, causal=True, offset=0)
        o_p, lse_p = flash_attention_fwd(
            q, k_bufs[li].to(q.dtype), v_bufs[li].to(q.dtype), seg,
            causal=False)
        o = _lse_merge(o_s, lse_s, o_p, lse_p)
        x = x + _psum(_mm("bhtk,hkd->btd", o.to(x.dtype), layer["wo"]),
                      tp_axis)
        x = x + _mlp_block(layer, x, cfg, tp_axis=tp_axis)
    # Per-row KV landing offsets: row b's chunk goes to positions
    # prefix_len[b] + [0, C) of every layer's buffer.
    bidx = torch.arange(b, device=dev)[:, None]
    cols = (prefix_len[:, None] + ar[None, :]).long()
    for bufs, new in ((k_bufs, new_ks), (v_bufs, new_vs)):
        # Indexed view [B, C, L, Hkv, D] (advanced indices on dims 1, 3).
        bufs[:, bidx, :, cols, :] = torch.stack(new).permute(
            1, 3, 0, 2, 4).to(bufs.dtype)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _lm_head_logits(params, _last_real_row(x, true_count),
                           tp_axis), k_bufs, v_bufs


@torch.no_grad()
def prefill_window_chunk_step(params, tokens, cfg: LlamaConfig, k_roll,
                              v_roll, prefix_len, true_count, tp_axis=None):
    """One chunk of an incremental prefill for a sliding-window model,
    batched across requests.

    The prefill context is a fixed-width rolling buffer holding the last
    W_b >= window positions, so prefill reads O(window) KV per chunk and
    the prompt length never enters the shapes. Attention per chunk is B1
    twice per layer, LSE-merged: causal self-attention over the C new
    rows with the model window, and attention over the roll buffer,
    whose column j holds absolute position prefix_len[b] - W_b + j: q row
    i sees column j iff j >= i + 1 + (W_b - window), the causal kernel
    with offset = W_b (never masks) and window = window. Columns below
    position 0 (the buffer not yet full) are hidden by segment ids.
    After attention the buffer rolls left by C and the chunk's KV
    appends.

    tokens: [B, C]; k_roll, v_roll: [L, B, Hkv, W_b, D] with W_b >=
    window and >= C; prefix_len, true_count and tp_axis as in
    prefill_chunk_step. Returns (logits [B, vocab], k_roll, v_roll) (new
    buffers).
    """
    b, c = tokens.shape
    w_b = k_roll.shape[3]
    if cfg.window is None:
        raise ValueError("prefill_window_chunk_step needs cfg.window")
    if w_b < cfg.window or w_b < c:
        raise ValueError(f"roll buffer {w_b} must be >= window "
                         f"{cfg.window} and chunk {c}")
    dev = tokens.device
    prefix_len = torch.as_tensor(prefix_len, dtype=torch.int32,
                                 device=dev).expand(b).contiguous()
    positions = prefix_len[:, None] + torch.arange(
        c, dtype=torch.int32, device=dev)[None, :]
    seg = SegmentIds(
        torch.zeros((b, c), dtype=torch.int32, device=dev),
        (torch.arange(w_b, dtype=torch.int32, device=dev)[None, :]
         < w_b - prefix_len[:, None]).to(torch.int32))
    x = params["embed"][tokens]
    new_ks, new_vs = [], []
    for li, layer in enumerate(params["layers"]):
        h = rmsnorm(x, layer["attn_norm"], cfg.norm_eps)
        q = _mm("btd,dhk->bhtk", h, layer["wq"])
        k = _mm("btd,dhk->bhtk", h, layer["wk"])
        v = _mm("btd,dhk->bhtk", h, layer["wv"])
        q = rope(q, positions, cfg.rope_theta).contiguous()
        k = rope(k, positions, cfg.rope_theta).contiguous()
        v = v.contiguous()
        new_ks.append(k)
        new_vs.append(v)
        o_s, lse_s = flash_attention_fwd(q, k, v, causal=True, offset=0,
                                         window=cfg.window)
        o_p, lse_p = flash_attention_fwd(
            q, k_roll[li].to(q.dtype), v_roll[li].to(q.dtype), seg,
            causal=True, offset=w_b, window=cfg.window)
        o = _lse_merge(o_s, lse_s, o_p, lse_p)
        x = x + _psum(_mm("bhtk,hkd->btd", o.to(x.dtype), layer["wo"]),
                      tp_axis)
        x = x + _mlp_block(layer, x, cfg, tp_axis=tp_axis)
    k_roll = torch.cat([k_roll[:, :, :, c:],
                        torch.stack(new_ks).to(k_roll.dtype)], dim=3)
    v_roll = torch.cat([v_roll[:, :, :, c:],
                        torch.stack(new_vs).to(v_roll.dtype)], dim=3)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _lm_head_logits(params, _last_real_row(x, true_count),
                           tp_axis), k_roll, v_roll


def _tail_attention(q, kt, vt, tail_pos, scale):
    """Exact fp32 attention of q [B, Hkv, G, T, D] over the dense tail
    kt/vt [B, Hkv, S, D]: query t sees tail rows [0, tail_pos + t].
    Returns (o [B, Hkv, G, T, D] f32, lse [B, Hkv, G, T] f32)."""
    s = torch.einsum("bhgtd,bhsd->bhgts", q.float(), kt.float()) * scale
    S, T = s.shape[-1], s.shape[3]
    col = torch.arange(S, device=s.device)[None, None, None, None, :]
    row = torch.arange(T, device=s.device)[None, None, None, :, None]
    limit = tail_pos.long()[:, None, None, None, None] + row
    s = s.masked_fill(col > limit, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgts,bhsd->bhgtd", p / l, vt.float())
    return o, (m + torch.log(l))[..., 0]


def decode_step_paged(params, token, cfg: LlamaConfig, k_pages, v_pages,
                      k_tails, v_tails, page_tables, paged_lens, tail_pos,
                      k_scales=None, v_scales=None, paged_bases=None,
                      tp_axis=None):
    """One decode step over token [B]; see decode_step_paged_multi.
    Returns (logits [B, vocab], k_tails, v_tails)."""
    logits, k_tails, v_tails = decode_step_paged_multi(
        params, token[:, None], cfg, k_pages, v_pages, k_tails, v_tails,
        page_tables, paged_lens, tail_pos, k_scales=k_scales,
        v_scales=v_scales, paged_bases=paged_bases, tp_axis=tp_axis)
    return logits[:, 0], k_tails, v_tails


@torch.no_grad()
def decode_step_paged_multi(params, tokens, cfg: LlamaConfig, k_pages,
                            v_pages, k_tails, v_tails, page_tables,
                            paged_lens, tail_pos, k_scales=None,
                            v_scales=None, paged_bases=None, tp_axis=None):
    """T-token decode step over tokens [B, T].

    Position t of sequence b sits at paged_bases + paged_lens + tail_pos
    + t. Tokens [0, paged_lens[b]) live in the read-only pages (k_pages /
    v_pages: per-layer [Hkv, P, page_size, D]); recent tokens live in
    the dense per-slot tail (k_tails / v_tails: per-layer
    [B, Hkv, TAIL, D]). This step's K/V are written into the tails IN
    PLACE at rows tail_pos[b] + t (the JAX version returns updated
    copies; torch can scatter in place). All T queries read the paged
    prefix identically, so the paged kernel sees them folded into the
    GQA group (t fastest); causality among the new positions lives in
    the tail mask. Dead slots carry paged_lens 0 and tail_pos 0.

    `paged_bases` [B] (default zeros) counts front-evicted tokens of a
    sliding-window sequence: the page table and paged_lens are in STORED
    coordinates while RoPE positions are absolute. Under a window the
    paged kernel gets each sequence's lowest visible stored position,
    max(paged_lens + tail_pos + 1 - window, 0) (the base cancels), and
    folded query t adds t in-kernel; the window must exceed the tail, so
    every tail row stays visible.

    `k_scales` / `v_scales` (per-layer [Hkv, P, page_size/128, D] fp32)
    mark int8 / fp8 pages; they go to the paged kernel beside the pools
    (its default body, as the JAX step passes no fold_scales).

    Under tp (`tp_axis` the group, with serving_param_shardings' shards
    and pools, tails and scales holding this rank's KV heads) every
    product and the attention run on the local heads; one all-reduce a
    block and an all-gather of the logits on axis 2 reassemble the
    result.

    Returns (logits [B, T, vocab], k_tails, v_tails).
    """
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    if k_scales is None:
        k_scales = v_scales = [None] * cfg.n_layers
    if cfg.window is not None and cfg.window <= k_tails[0].shape[2]:
        raise ValueError(
            f"window={cfg.window} must exceed the tail buffer "
            f"({k_tails[0].shape[2]}) so tail tokens stay visible")
    b, t_new = tokens.shape
    hkv = k_tails[0].shape[1]            # this rank's kv heads under tp
    group = cfg.n_heads // cfg.n_kv_heads
    hd = cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    if paged_bases is None:
        paged_bases = torch.zeros_like(paged_lens)
    ar = torch.arange(t_new, dtype=torch.int32, device=tokens.device)
    positions = (paged_bases + paged_lens + tail_pos)[:, None] + ar[None]
    bidx = torch.arange(b, device=tokens.device)[:, None]      # [B, 1]
    trow = tail_pos.long()[:, None] + ar.long()[None]          # [B, T]
    win_starts = None
    if cfg.window is not None:
        win_starts = (paged_lens + tail_pos + 1 - cfg.window).clamp(
            min=0).to(torch.int32)
    x = params["embed"][tokens]                                # [B, T, D]
    for layer, kp, vp, kt, vt, ksc, vsc in zip(
            params["layers"], k_pages, v_pages, k_tails, v_tails, k_scales,
            v_scales):
        h = rmsnorm(x, layer["attn_norm"], cfg.norm_eps)
        q = _mm("btd,dhk->bhtk", h, layer["wq"])
        k = _mm("btd,dhk->bhtk", h, layer["wk"])
        v = _mm("btd,dhk->bhtk", h, layer["wv"])
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        # Advanced indices on dims 0 and 2 are not adjacent, so the
        # indexed view is [B, T, Hkv, D], the same as JAX's .at[] set.
        kt[bidx, :, trow, :] = k.transpose(1, 2).to(kt.dtype)
        vt[bidx, :, trow, :] = v.transpose(1, 2).to(vt.dtype)

        qg = q.reshape(b, hkv, group, t_new, hd)
        o_p, lse_p = paged_flash_decode(
            qg.reshape(b, hkv * group * t_new, hd), kp, vp, page_tables,
            paged_lens, k_scales=ksc, v_scales=vsc, scale=scale,
            window_starts=win_starts, qpos_spread=t_new, return_lse=True)
        o_p = o_p.reshape(b, hkv, group, t_new, hd).float()
        lse_p = lse_p.reshape(b, hkv, group, t_new)
        o_t, lse_t = _tail_attention(qg, kt, vt, tail_pos, scale)
        o = _lse_merge(o_p, lse_p, o_t, lse_t)
        o = o.reshape(b, hkv * group, t_new, hd).to(x.dtype)
        x = x + _psum(_mm("bhtk,hkd->btd", o, layer["wo"]), tp_axis)
        x = x + _mlp_block(layer, x, cfg, tp_axis=tp_axis)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _mm("btd,dv->btv", x, params["lm_head"])
    if tp_axis is not None:
        logits = all_gather_tiled(logits, tp_axis, dim=2)
    return logits, k_tails, v_tails


# --- contiguous-cache decode (sampling.generate) ---------------------------


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
                  *, device="cuda"):
    """Contiguous per-layer caches [(k, v)] of [B, Hkv, S, D] zeros
    (paged serving uses runtime/kv_cache.py instead)."""
    dev = resolve_device(device)
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return [(torch.zeros(shape, dtype=dtype, device=dev),
             torch.zeros(shape, dtype=dtype, device=dev))
            for _ in range(cfg.n_layers)]


@torch.no_grad()
def prefill(params, tokens, cfg: LlamaConfig, cache):
    """Run the prompt [B, T] through the model, writing its K/V into
    positions [0, T) of `cache` IN PLACE (the JAX version returns updated
    copies). Returns (logits at the last token [B, vocab], cache,
    lengths [B] int32)."""
    b, t = tokens.shape
    positions = torch.arange(t, dtype=torch.int32, device=tokens.device)
    x = params["embed"][tokens]
    for layer, (ck, cv) in zip(params["layers"], cache):
        a, (k, v) = _attention_block(layer, x, cfg, positions)
        ck[:, :, :t] = k.to(ck.dtype)
        cv[:, :, :t] = v.to(cv.dtype)
        x = x + a
        x = x + _mlp_block(layer, x, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _mm("bd,dv->bv", x[:, -1], params["lm_head"])
    lengths = torch.full((b,), t, dtype=torch.int32, device=tokens.device)
    return logits, cache, lengths


def _xla_cache_attention(q, ck, cv, lengths, scale, window=None):
    """Masked attention of q [B, Hq, D] over contiguous caches
    [B, Hkv, S, D], visible positions [max(0, len - window), len), in
    plain torch (fp32 softmax). The JAX package keeps this path out of
    its Pallas kernel so XLA can scatter into the cache in place; here it
    is `decode_step(use_flash=False)`."""
    b, hq, d = q.shape
    hkv = ck.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, ck.float()) * scale
    col = torch.arange(ck.shape[2], device=q.device)[None, None, None, :]
    lens = lengths.long()[:, None, None, None]
    bad = col >= lens
    if window is not None:
        bad = bad | (col < lens - window)
    p = torch.softmax(s.masked_fill(bad, float("-inf")), dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p, cv.float())
    return o.reshape(b, hq, d)


@torch.no_grad()
def decode_step(params, token, cfg: LlamaConfig, cache, lengths, *,
                use_flash: bool = True):
    """One decode step over token [B] with the contiguous cache: the new
    token's K/V is written at position lengths[b] of each layer's cache
    IN PLACE (the JAX version returns updated copies), then attention
    runs B5 (ops/decode.py flash_decode) over lengths + 1 positions, or
    plain torch with use_flash=False. Returns (logits [B, vocab], cache,
    lengths + 1)."""
    b = token.shape[0]
    positions = lengths[:, None]                      # [B, 1]
    x = params["embed"][token][:, None]               # [B, 1, D]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    bidx = torch.arange(b, device=token.device)
    pos = lengths.long()
    for layer, (ck, cv) in zip(params["layers"], cache):
        h = rmsnorm(x, layer["attn_norm"], cfg.norm_eps)
        q = _mm("btd,dhk->bhtk", h, layer["wq"])
        k = _mm("btd,dhk->bhtk", h, layer["wk"])
        v = _mm("btd,dhk->bhtk", h, layer["wv"])
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        ck[bidx, :, pos] = k[:, :, 0].to(ck.dtype)
        cv[bidx, :, pos] = v[:, :, 0].to(cv.dtype)
        if use_flash:
            o = flash_decode(q[:, :, 0].contiguous(), ck, cv, lengths + 1,
                             window=cfg.window)[:, :, None]
        else:
            o = _xla_cache_attention(
                q[:, :, 0], ck, cv, lengths + 1, scale,
                window=cfg.window).to(x.dtype)[:, :, None]
        x = x + _mm("bhtk,hkd->btd", o, layer["wo"])
        x = x + _mlp_block(layer, x, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _mm("bd,dv->bv", x[:, 0], params["lm_head"])
    return logits, cache, lengths + 1
