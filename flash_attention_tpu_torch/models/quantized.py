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

The MoE expert stacks (`QuantizedExpertStack`, `Int4ExpertStack`,
`quantize_moe_params`, `init_quantized_moe_params`) arrive with the MoE
slice and `expand_param_shardings` with the multi-device slice.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from flash_attention_tpu_torch.config import resolve_device
from flash_attention_tpu_torch.ops.quant import _QMAX, tile_to_f32
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
        w = tile_to_f32(self.q) * self.scale[None, :]
        return w.to(dtype).reshape(self.orig_shape)

    def _matmul2d(self, x2):
        if x2.shape[0] <= _KERNEL_MAX_ROWS:
            return quant_matmul(x2, self.q, self.scale)
        # Wide products: dequantize, then a dense matmul (JAX: jnp.dot).
        wdq = (tile_to_f32(self.q) * self.scale[None, :]).to(x2.dtype)
        return x2 @ wdq

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


def _weight_einsum(w, spec, x):
    """Einsum plumbing shared by the weight classes (and the dense B8
    adapter in models/llama.py): normalise to a 2D [rows, contract] x
    [contract, out] product and restore the logical layout."""
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


def init_quantized_params(cfg, seed: int = 0, dtype=torch.int8, *,
                          device="cuda") -> dict:
    """A quantized parameter dict drawn directly on `device` from a
    seeded torch.Generator, never building the dense tree (16 GB in bf16
    at 8B). Statistics match quantize_params(init_params(...)): the
    dequantized weights have std ~ 1/sqrt(fan_in). The draws differ from
    jax.random's for the same seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, hd = cfg.dim, cfg.head_dim
    qmax = 7.0 if dtype == "int4" else _QMAX[dtype]

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(cfg.dtype)

    def qdense(shape, fan_in, n_contract):
        kk = math.prod(shape[:n_contract])
        f = math.prod(shape[n_contract:])
        if dtype == "int4":
            # Random packed nibbles; uniform int4 in [-8, 7] has std
            # ~4.64, so a constant scale restores 1/sqrt(fan_in).
            packed = torch.randint(0, 256, (kk // 2, f), generator=gen,
                                   device=dev, dtype=torch.uint8)
            scales = torch.full((kk // INT4_GROUP, f),
                                1.0 / (4.64 * math.sqrt(fan_in)),
                                dtype=torch.float32, device=dev)
            return Int4Weight(packed=packed.view(torch.int8), scales=scales,
                              orig_shape=tuple(shape),
                              n_contract=n_contract)
        if dtype == torch.int8:
            q = torch.randint(-127, 128, (kk, f), generator=gen, device=dev,
                              dtype=torch.int8)
            # Uniform int8 has std 127/sqrt(3).
            s = math.sqrt(3.0) / (127.0 * math.sqrt(fan_in))
        else:
            # fp8: N(0, (qmax/4)^2) values (4-sigma clip range).
            w = torch.randn((kk, f), generator=gen, device=dev,
                            dtype=torch.float32) * (qmax / 4)
            q = w.clamp_(-qmax, qmax).to(dtype)
            s = 4.0 / (qmax * math.sqrt(fan_in))
        scale = torch.full((f,), s, dtype=torch.float32, device=dev)
        return QuantizedWeight(q=q, scale=scale, orig_shape=tuple(shape),
                               n_contract=n_contract)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=dev)

    embed = dense((cfg.vocab_size, d), d)
    lm_head = qdense((d, cfg.vocab_size), d, 1)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "attn_norm": ones(d),
            "wq": qdense((d, cfg.n_heads, hd), d, 1),
            "wk": qdense((d, cfg.n_kv_heads, hd), d, 1),
            "wv": qdense((d, cfg.n_kv_heads, hd), d, 1),
            "wo": qdense((cfg.n_heads, hd, d), cfg.n_heads * hd, 2),
            "mlp_norm": ones(d),
            "w_gate": qdense((d, cfg.ffn_dim), d, 1),
            "w_up": qdense((d, cfg.ffn_dim), d, 1),
            "w_down": qdense((cfg.ffn_dim, d), cfg.ffn_dim, 1),
        })
    return {"embed": embed, "layers": layers, "final_norm": ones(d),
            "lm_head": lm_head}


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
    """Number of logical model parameters: a quantized weight counts its
    unpacked orig_shape (an int4 8B tree is still an 8B model), a dense
    tensor its size."""
    return sum(math.prod(leaf.orig_shape)
               if isinstance(leaf, QUANT_LEAF_TYPES) else leaf.numel()
               for leaf in _leaves(params))
