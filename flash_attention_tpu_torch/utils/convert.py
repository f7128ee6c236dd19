"""Carry JAX-package parameters into the port.

The port keeps the JAX package's parameter layout (wq [d, H, hd],
wk/wv [d, Hkv, hd], wo [H, hd, d], w_gate/w_up [d, ffn], w_down
[ffn, d], embed [vocab, d], lm_head [d, vocab], norms [d]), so a tree
converts leaf by leaf with no transposes. The caller hands over numpy
arrays (e.g. `jax.tree.map(np.asarray, params)`); this module imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from flash_attention_tpu_torch.config import resolve_device


def _leaf(x, device: torch.device) -> torch.Tensor:
    arr = np.array(x)          # a private, writable copy
    if arr.dtype.name == "bfloat16":
        # numpy has no native bfloat16; reinterpret the 16-bit payload.
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(tree, device="cuda"):
    """Nested dicts/lists/tuples of numpy arrays -> the same structure of
    torch tensors on `device`, dtypes preserved."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return _leaf(node, dev)

    return conv(tree)
