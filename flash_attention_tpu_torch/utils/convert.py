"""Carry JAX-package parameters into the port.

The port keeps the JAX package's parameter layout (wq [d, H, hd],
wk/wv [d, Hkv, hd], wo [H, hd, d], w_gate/w_up [d, ffn], w_down
[ffn, d], embed [vocab, d], lm_head [d, vocab], norms [d]), so a tree
converts leaf by leaf with no transposes. The caller hands over numpy
arrays (e.g. `jax.tree.map(np.asarray, params)`); this module imports
neither JAX nor the JAX package.

After that map a quantized weight of the JAX package is still its class,
now holding numpy leaves. It is recognised by its fields: q / scale /
orig_shape / n_contract becomes a `QuantizedWeight`, packed / scales /
orig_shape / n_contract an `Int4Weight` (models/quantized.py); the MoE
expert stacks, q / scale without n_contract a `QuantizedExpertStack`,
packed / scales / logical_k an `Int4ExpertStack`. Dense expert stacks
[E, K, F] and the fp32 router are plain arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from flash_attention_tpu_torch.config import resolve_device
from flash_attention_tpu_torch.models.quantized import (
    Int4ExpertStack,
    Int4Weight,
    QuantizedExpertStack,
    QuantizedWeight,
)

# ml_dtypes' numpy dtypes with no numpy counterpart: reinterpret the
# payload through an unsigned view of the same width.
_VIEWED = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def _leaf(x, device: torch.device) -> torch.Tensor:
    arr = np.array(x)          # a private, writable copy
    if arr.dtype.name in _VIEWED:
        raw, dtype = _VIEWED[arr.dtype.name]
        return torch.from_numpy(arr.view(raw)).view(dtype).to(device)
    return torch.from_numpy(arr).to(device)


def _has(node, *fields) -> bool:
    return all(hasattr(node, f) for f in fields)


def params_from_jax(tree, device="cuda"):
    """Nested dicts/lists/tuples of numpy arrays (and quantized weights
    holding them) -> the same structure of torch tensors (and the port's
    weight classes) on `device`, dtypes preserved."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        if _has(node, "q", "scale", "orig_shape", "n_contract"):
            return QuantizedWeight(
                q=_leaf(node.q, dev), scale=_leaf(node.scale, dev),
                orig_shape=tuple(node.orig_shape),
                n_contract=int(node.n_contract))
        if _has(node, "packed", "scales", "orig_shape", "n_contract"):
            return Int4Weight(
                packed=_leaf(node.packed, dev),
                scales=_leaf(node.scales, dev),
                orig_shape=tuple(node.orig_shape),
                n_contract=int(node.n_contract))
        if _has(node, "q", "scale"):
            return QuantizedExpertStack(q=_leaf(node.q, dev),
                                        scale=_leaf(node.scale, dev))
        if _has(node, "packed", "scales", "logical_k"):
            return Int4ExpertStack(packed=_leaf(node.packed, dev),
                                   scales=_leaf(node.scales, dev),
                                   logical_k=int(node.logical_k))
        return _leaf(node, dev)

    return conv(tree)
