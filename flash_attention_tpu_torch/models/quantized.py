"""Weight-only quantization for the Llama family (port of the dense part
of `flash_attention_tpu/models/quantized.py`).

A quantized weight is a plain dataclass of tensors that stands where the
dense tensor stood in the parameter dict, with the same logical shape
(`orig_shape`; its first `n_contract` dims are the contracted ones):

  * `QuantizedWeight`: int8 / fp8 q [K, F] and one fp32 scale per output
    channel [F];
  * `Int4Weight`: packed int4 [K/2, F] (byte j = logical rows 2j and
    2j + 1) and fp32 scales per 128 rows and channel [K/128, F].

Every weight product of the model goes through `models/llama.py:_mm`,
which hands a quantized weight its einsum: the product is normalised to
2D and runs the B6 / B7 kernel (`ops/quant_matmul.py`) for at most
`_KERNEL_MAX_ROWS` activation rows, where it is bound by the weight's
bytes. Above that, as in the JAX package, the weight is dequantized once
and the product goes to a dense matmul, where the tensor cores and not
the bytes are the limit: a dispatch by shape, not a fallback.

The MoE expert stacks hold one weight per expert, [E, K, F] (contraction
in the middle): `QuantizedExpertStack` (int8 / fp8 q [E, K, F], fp32
scales [E, F]) and `Int4ExpertStack` (packed [E, K/2, F], scales
[E, K/128, F]). They never reach `_mm`: models/moe.py `_expert_stack_mm`
runs them through the grouped kernel B9 (ops/grouped.py) or, on the
one-hot path, dequantizes them whole, as the JAX package does.

Tensor parallelism: `expand_param_shardings` lays one logical spec per
weight (models/llama.py `serving_param_shardings`) onto the packed
leaves and their scales, and `parallel/mesh.py:shard_params` cuts each
rank's slice. A sharded weight is a weight of its own, whose
`orig_shape` is its LOCAL logical shape (the port holds no global
array), so `_weight_einsum` needs no case for local widths.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from flash_attention_tpu_torch.config import resolve_device
from flash_attention_tpu_torch.ops.quant import _QMAX, widen_scaled
from flash_attention_tpu_torch.ops.quant_matmul import (
    INT4_GROUP,
    int4_dequant,
    int4_matmul,
    quant_matmul,
    quantize_weight,
    quantize_weight_int4,
)

# At most this many activation rows run the fused-dequant kernels (bound
# by the weight's bytes); wider products dequantize once and run dense.
_KERNEL_MAX_ROWS = 1024


@dataclasses.dataclass
class QuantizedWeight:
    """int8 / fp8 weight q [K, F] with per-output-channel fp32 scale [F].
    The first n_contract dims of orig_shape are the contraction dims."""

    q: torch.Tensor
    scale: torch.Tensor
    orig_shape: tuple
    n_contract: int

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.scale.numel() * 4

    def dequant(self, dtype=torch.bfloat16):
        return widen_scaled(self.q, self.scale, dtype).reshape(
            self.orig_shape)

    def _matmul2d(self, x2):
        if x2.shape[0] <= _KERNEL_MAX_ROWS:
            return quant_matmul(x2, self.q, self.scale)
        # Wide products: dequantize, then a dense matmul (JAX: jnp.dot).
        return x2 @ widen_scaled(self.q, self.scale, x2.dtype)

    def einsum(self, spec, x):
        """torch.einsum(spec, x, dense weight) with the fused dequant."""
        return _weight_einsum(self, spec, x)


@dataclasses.dataclass
class Int4Weight:
    """Packed int4 weight [K/2, F] (row-pair nibbles) with group-wise
    per-channel fp32 scales [K/INT4_GROUP, F]."""

    packed: torch.Tensor
    scales: torch.Tensor
    orig_shape: tuple
    n_contract: int

    @property
    def nbytes(self) -> int:
        return self.packed.numel() + self.scales.numel() * 4

    def dequant(self, dtype=torch.bfloat16):
        return int4_dequant(self.packed, self.scales, dtype).reshape(
            self.orig_shape)

    def _matmul2d(self, x2):
        if x2.shape[0] <= _KERNEL_MAX_ROWS:
            return int4_matmul(x2, self.packed, self.scales)
        # Wide products: dequantize, then a dense matmul (JAX: jnp.dot).
        return x2 @ int4_dequant(self.packed, self.scales, x2.dtype)

    def einsum(self, spec, x):
        return _weight_einsum(self, spec, x)


QUANT_LEAF_TYPES = (QuantizedWeight, Int4Weight)


@dataclasses.dataclass
class QuantizedExpertStack:
    """Per-expert int8 / fp8 weights q [E, K, F] with per-(expert,
    output channel) fp32 scales [E, F]."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def orig_shape(self) -> tuple:
        return tuple(self.q.shape)

    @property
    def nbytes(self) -> int:
        return self.q.numel() + self.scale.numel() * 4

    def dequant(self, dtype=torch.bfloat16):
        return widen_scaled(self.q, self.scale[:, None, :], dtype)


@dataclasses.dataclass
class Int4ExpertStack:
    """Per-expert packed int4 weights [E, K/2, F] (row-pair nibbles) with
    group-wise fp32 scales [E, K/INT4_GROUP, F]; logical_k = K."""

    packed: torch.Tensor
    scales: torch.Tensor
    logical_k: int

    @property
    def orig_shape(self) -> tuple:
        e, _, f = self.packed.shape
        return (e, self.logical_k, f)

    @property
    def nbytes(self) -> int:
        return self.packed.numel() + self.scales.numel() * 4

    def dequant(self, dtype=torch.bfloat16):
        return int4_dequant(self.packed, self.scales, dtype)


EXPERT_STACK_TYPES = (QuantizedExpertStack, Int4ExpertStack)


def _weight_einsum(w, spec, x):
    """Einsum plumbing shared by the weight classes (and the dense B8
    adapter in models/llama.py): normalise to a 2D [rows, contract] x
    [contract, out] product and restore the logical layout. A
    tensor-parallel shard carries its local orig_shape
    (parallel/mesh.py shard_params), so the layout restored is the
    shard's: the JAX function's branch for a local width under a global
    orig_shape has no counterpart here."""
    ins, out = spec.split("->")
    xs, ws = ins.split(",")
    contract = [c for c in ws if c in xs]
    wout = [c for c in ws if c not in xs]
    if list(ws) != contract + wout:
        raise ValueError(f"contraction dims must lead in {spec!r}")
    xkeep = [c for c in xs if c not in contract]
    perm = [xs.index(c) for c in xkeep + contract]
    xt = x.permute(perm)
    keep_shape = tuple(xt.shape[: len(xkeep)])
    x2 = xt.reshape(math.prod(keep_shape), -1)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    y2 = w._matmul2d(x2)
    y = y2.reshape(*keep_shape, *w.orig_shape[w.n_contract:])
    cur = xkeep + wout
    return y.permute([cur.index(c) for c in out])


def quantize_tensor(w, n_contract: int, dtype=torch.int8):
    """Quantize a weight whose first n_contract dims are contracted:
    int8 / fp8 -> QuantizedWeight, "int4" -> Int4Weight, on w's device
    (numpy on the host in between, as the JAX package does)."""
    shape = tuple(w.shape)
    k = math.prod(shape[:n_contract])
    f = math.prod(shape[n_contract:])
    device = w.device if isinstance(w, torch.Tensor) else "cpu"
    w2 = (w.detach().to("cpu", torch.float32) if isinstance(w, torch.Tensor)
          else np.asarray(w, np.float32)).reshape(k, f)
    if dtype == "int4":
        packed, scales = quantize_weight_int4(w2)
        return Int4Weight(packed=packed.to(device), scales=scales.to(device),
                          orig_shape=shape, n_contract=n_contract)
    q, scale = quantize_weight(w2, dtype=dtype)
    return QuantizedWeight(q=q.to(device), scale=scale.to(device),
                           orig_shape=shape, n_contract=n_contract)


# First-n-contract-dims per llama weight name (llama.py init_params).
_LAYER_SPECS = {
    "wq": 1, "wk": 1, "wv": 1,       # [d, h, k]
    "wo": 2,                          # [h, k, d]
    "w_gate": 1, "w_up": 1, "w_down": 1,
}


def quantize_params(params: dict, *, quantize_lm_head: bool = True,
                    dtype=torch.int8) -> dict:
    """Weight-only int8 / fp8 / "int4" quantization of a llama parameter
    dict. Norms and the embedding gather stay dense."""
    out = dict(params)
    out["layers"] = [
        {name: (quantize_tensor(w, _LAYER_SPECS[name], dtype=dtype)
                if name in _LAYER_SPECS else w)
         for name, w in layer.items()}
        for layer in params["layers"]
    ]
    if quantize_lm_head:
        out["lm_head"] = quantize_tensor(params["lm_head"], 1, dtype=dtype)
    return out


def quantize_expert_stack(w, dtype=torch.int8):
    """Quantize an [E, K, F] expert stack (contraction in the middle) on
    w's device, with the JAX package's arithmetic and bytes: int8 rounds
    half to even, fp8 clips to the finite maximum and converts (round to
    nearest even), "int4" quantizes per 128 rows and channel.
    int8 / fp8 -> QuantizedExpertStack, "int4" -> Int4ExpertStack."""
    w = torch.as_tensor(w).detach().float()
    e, k, f = w.shape
    if dtype == "int4":
        if k % INT4_GROUP:
            raise ValueError(f"K={k} must be a multiple of {INT4_GROUP}")
        g = w.reshape(e, k // INT4_GROUP, INT4_GROUP, f)
        scale = torch.clamp_min(g.abs().amax(dim=2) / 7.0, 1e-12)
        q = torch.clamp(torch.round(g / scale[:, :, None, :]), -7, 7
                        ).to(torch.int32).reshape(e, k, f)
        lo = q[:, 0::2] & 0xF
        hi = q[:, 1::2] & 0xF
        packed = ((hi << 4) | lo).to(torch.uint8).view(torch.int8)
        return Int4ExpertStack(packed=packed, scales=scale, logical_k=k)
    if dtype not in _QMAX:
        raise TypeError(f"dtype must be int8, fp8 or 'int4', got {dtype}")
    qmax = _QMAX[dtype]
    scale = torch.clamp_min(w.abs().amax(dim=1) / qmax, 1e-12)   # [E, F]
    q = w / scale[:, None, :]
    if dtype == torch.int8:
        q = torch.round(q)
    return QuantizedExpertStack(q=torch.clamp(q, -qmax, qmax).to(dtype),
                                scale=scale)


_EXPERT_STACK_KEYS = ("w_gate", "w_up", "w_down")


def quantize_moe_params(params: dict, *, quantize_lm_head: bool = True,
                        dtype=torch.int8) -> dict:
    """Weight-only quantization of an MoE parameter dict
    (models/moe.py init_moe_params): attention projections as in
    quantize_params, expert stacks per expert, the router stays fp32."""
    out = dict(params)
    out["layers"] = [
        {name: (quantize_expert_stack(w, dtype=dtype)
                if name in _EXPERT_STACK_KEYS
                else quantize_tensor(w, _LAYER_SPECS[name], dtype=dtype)
                if name in _LAYER_SPECS else w)
         for name, w in layer.items()}
        for layer in params["layers"]
    ]
    if quantize_lm_head:
        out["lm_head"] = quantize_tensor(params["lm_head"], 1, dtype=dtype)
    return out


def _draw_quantized(gen, dev, dtype, lead, kk, f, fan_in):
    """Random codes and constant scales for a quantized weight of logical
    shape [*lead, kk, f] whose dequantized values have std
    ~1/sqrt(fan_in). Returns (codes, scales): int4 packed [*lead, kk/2,
    f] with scales [*lead, kk/128, f]; int8 / fp8 [*lead, kk, f] with
    scales [*lead, f]."""
    if dtype == "int4":
        # Random packed nibbles; uniform int4 in [-8, 7] has std ~4.64,
        # so a constant scale restores 1/sqrt(fan_in).
        packed = torch.randint(0, 256, (*lead, kk // 2, f), generator=gen,
                               device=dev, dtype=torch.uint8)
        scales = torch.full((*lead, kk // INT4_GROUP, f),
                            1.0 / (4.64 * math.sqrt(fan_in)),
                            dtype=torch.float32, device=dev)
        return packed.view(torch.int8), scales
    if dtype == torch.int8:
        q = torch.randint(-127, 128, (*lead, kk, f), generator=gen,
                          device=dev, dtype=torch.int8)
        # Uniform int8 has std 127/sqrt(3).
        s = math.sqrt(3.0) / (127.0 * math.sqrt(fan_in))
    else:
        # fp8: N(0, (qmax/4)^2) values (4-sigma clip range).
        qmax = _QMAX[dtype]
        w = torch.randn((*lead, kk, f), generator=gen, device=dev,
                        dtype=torch.float32) * (qmax / 4)
        q = w.clamp_(-qmax, qmax).to(dtype)
        s = 4.0 / (qmax * math.sqrt(fan_in))
    return q, torch.full((*lead, f), s, dtype=torch.float32, device=dev)


def init_quantized_params(cfg, seed: int = 0, dtype=torch.int8, *,
                          device="cuda") -> dict:
    """A quantized parameter dict drawn directly on `device` from a
    seeded torch.Generator, never building the dense tree (16 GB in bf16
    at 8B). Statistics match quantize_params(init_params(...)): the
    dequantized weights have std ~ 1/sqrt(fan_in). The draws differ from
    jax.random's for the same seed."""
    return _init_quantized(cfg, seed, dtype, device, moe=False)


def init_quantized_moe_params(cfg, seed: int = 0, dtype="int4", *,
                              device="cuda") -> dict:
    """init_quantized_params for an MoE model (models/moe.py MoEConfig):
    expert stacks drawn as QuantizedExpertStack / Int4ExpertStack codes
    with constant scales (dequantized std ~ 1/sqrt(fan_in)), the router
    dense fp32. A Mixtral-8x7B bf16 tree (93 GB) fits no card; its int4
    tree is 25 GB. Each storage draws its own codes (fp8 as fp8), where
    the JAX package draws int8 codes for every dtype but int4."""
    return _init_quantized(cfg, seed, dtype, device, moe=True)


def _init_quantized(cfg, seed, dtype, device, *, moe: bool) -> dict:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, hd, ffn = cfg.dim, cfg.head_dim, cfg.ffn_dim

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(cfg.dtype)

    def qdense(shape, fan_in, n_contract):
        kk = math.prod(shape[:n_contract])
        f = math.prod(shape[n_contract:])
        codes, scales = _draw_quantized(gen, dev, dtype, (), kk, f, fan_in)
        cls = Int4Weight if dtype == "int4" else QuantizedWeight
        return cls(codes, scales, orig_shape=tuple(shape),
                   n_contract=n_contract)

    def qstack(kk, f, fan_in):
        e = cfg.n_experts
        codes, scales = _draw_quantized(gen, dev, dtype, (e,), kk, f, fan_in)
        if dtype == "int4":
            return Int4ExpertStack(codes, scales, logical_k=kk)
        return QuantizedExpertStack(codes, scales)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=dev)

    embed = dense((cfg.vocab_size, d), d)
    lm_head = qdense((d, cfg.vocab_size), d, 1)
    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": ones(d),
            "wq": qdense((d, cfg.n_heads, hd), d, 1),
            "wk": qdense((d, cfg.n_kv_heads, hd), d, 1),
            "wv": qdense((d, cfg.n_kv_heads, hd), d, 1),
            "wo": qdense((cfg.n_heads, hd, d), cfg.n_heads * hd, 2),
            "mlp_norm": ones(d),
        }
        if moe:
            # The router stays fp32: gate order is precision-sensitive.
            layer["router"] = torch.randn(
                (d, cfg.n_experts), generator=gen, device=dev,
                dtype=torch.float32) / math.sqrt(d)
            layer.update(w_gate=qstack(d, ffn, d), w_up=qstack(d, ffn, d),
                         w_down=qstack(ffn, d, ffn))
        else:
            layer.update(w_gate=qdense((d, ffn), d, 1),
                         w_up=qdense((d, ffn), d, 1),
                         w_down=qdense((ffn, d), ffn, 1))
        layers.append(layer)
    return {"embed": embed, "layers": layers, "final_norm": ones(d),
            "lm_head": lm_head}


def expand_param_shardings(params, pspecs):
    """Leaf-level specs for a (possibly quantized) parameter tree (port of
    the JAX function).

    `pspecs` carries one logical spec per weight (a tuple of axis names
    and None over orig_shape, e.g. llama.serving_param_shardings). A
    quantized weight expands it onto its leaves: the axis named on the
    contracted group shards the packed rows (and the int4 group scales),
    the axis named on the output group shards the columns (and the
    per-channel scales). The packed layout flattens each group with its
    leading dim outermost, so a named axis is legal only on a group's
    leading dim (true of every llama layout: wq / wk / wv heads, wo
    heads, the mlp's ffn, lm_head's vocab); anything else raises
    ValueError, as in JAX. A dense MoE expert stack [E, ...] takes its
    spec as it is; a quantized one (QuantizedExpertStack, Int4ExpertStack)
    raises ValueError, the JAX function's limit (it cannot map a spec onto
    an expert stack).

    Returns a tree congruent with `params`: a quantized weight becomes
    the same class holding specs (`q` / `scale`, `packed` / `scales`)
    and its orig_shape, a tensor its spec."""

    def expand(w, spec):
        if isinstance(w, EXPERT_STACK_TYPES):
            raise ValueError(
                f"{type(w).__name__}: a quantized expert stack takes no "
                "sharding spec. The JAX package's expand_param_shardings "
                "(models/quantized.py:519-541) cannot map a spec onto an "
                "expert stack either, so quantized MoE trees are not "
                "served under a mesh; shard a dense [E, ...] stack")
        if not isinstance(w, QUANT_LEAF_TYPES):
            return tuple(spec)
        full = tuple(spec) + (None,) * (len(w.orig_shape) - len(spec))
        cgrp, fgrp = full[: w.n_contract], full[w.n_contract:]
        for grp in (cgrp, fgrp):
            if any(a is not None for a in grp[1:]):
                raise ValueError(
                    "quantized weights shard only on each group's "
                    f"leading dim; got {spec} for shape {w.orig_shape} "
                    f"(n_contract={w.n_contract})")
        k_ax = cgrp[0] if cgrp else None
        f_ax = fgrp[0] if fgrp else None
        if isinstance(w, Int4Weight):
            return Int4Weight(packed=(k_ax, f_ax), scales=(k_ax, f_ax),
                              orig_shape=w.orig_shape,
                              n_contract=w.n_contract)
        return QuantizedWeight(q=(k_ax, f_ax), scale=(f_ax,),
                               orig_shape=w.orig_shape,
                               n_contract=w.n_contract)

    return map_with_specs(expand, params, pspecs)


def map_with_specs(fn, params, specs):
    """fn(leaf, spec) over a parameter tree (dicts and lists of tensors or
    quantized weights) and a spec tree of its structure whose leaves are
    spec tuples (or, where expanded, quantized weights holding them)."""
    if isinstance(params, dict):
        return {k: map_with_specs(fn, v, specs[k]) for k, v in params.items()}
    if isinstance(params, list):
        if len(params) != len(specs):
            raise ValueError(f"{len(params)} entries against "
                             f"{len(specs)} specs")
        return [map_with_specs(fn, v, s) for v, s in zip(params, specs)]
    return fn(params, specs)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def params_nbytes(params) -> int:
    """Bytes the parameters hold: quantized weights their storage and
    scales, dense tensors their own."""
    return sum(leaf.nbytes for leaf in _leaves(params))


def logical_param_count(params) -> int:
    """Number of logical model parameters: a quantized weight or expert
    stack counts its unpacked orig_shape (an int4 8B tree is still an 8B
    model), a dense tensor its size."""
    return sum(math.prod(leaf.orig_shape)
               if isinstance(leaf, QUANT_LEAF_TYPES + EXPERT_STACK_TYPES)
               else leaf.numel()
               for leaf in _leaves(params))
