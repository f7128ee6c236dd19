"""Implementation registry and head-dim dispatch (port of
`flash_attention_tpu/ops/dispatch.py`).

One place that maps an implementation name to a callable, preserving the
reference's study structure for the comparison harness (`cli compare`):
exact baselines, the naive kernel, FA1, FA2 in-loop, two fixed-tile
entries and the flagship. On CUDA tensors every kernel entry launches a
hand-written kernel (B10a-c, B1); the baselines are plain einsums on
either device, as the JAX package leaves them to XLA.

`attention_reference_dispatch` aliases the flagship (the reference
aliases its small-tile kernel the same way).
"""

from __future__ import annotations

from typing import Callable

from flash_attention_tpu_torch.config import SUPPORTED_HEAD_DIMS
from flash_attention_tpu_torch.ops.flash import flash_attention
from flash_attention_tpu_torch.ops.reference import (
    attention_baseline,
    attention_reference,
)
from flash_attention_tpu_torch.ops.variants import (
    flash_attention_fa1,
    flash_attention_fa2_inloop,
    naive_attention_pallas,
)


def _reject_causal(name, kw):
    if kw.pop("causal", False):
        raise ValueError(
            f"{name} is a non-causal study kernel (the CUDA FA1s have no "
            "causal path); use 'flash' or 'fa2_inloop'")
    return kw


def _fa1_o_only(q, k, v, **kw):
    return flash_attention_fa1(q, k, v, **_reject_causal("fa1", kw))[0]


def _fixed_tile(name: str, head_dim: int) -> Callable:
    """Standalone fixed-tile study entry (the reference keeps two
    frozen-tile kernels outside its dispatch path, at d64 and d32): the
    head dim is gated the way those kernels hard-code theirs. It runs B1,
    whose tiles are fixed when the kernels are built (`config.b1_tile`;
    the JAX package pins its BlockSizes instead)."""

    def impl(q, k, v, **kw):
        if q.shape[-1] != head_dim:
            raise ValueError(
                f"{name} is fixed to head_dim {head_dim} "
                f"(got {q.shape[-1]}); use 'flash' for dispatched tiles")
        return flash_attention(q, k, v, **kw)

    return impl


IMPLEMENTATIONS: dict[str, Callable] = {
    # exact baselines (plain einsums)
    "baseline_xla": attention_baseline,
    "reference_exact": attention_reference,
    # study kernels (B10c, B10a, B10b)
    "naive_pallas": lambda q, k, v, **kw: naive_attention_pallas(
        q, k, v, **_reject_causal("naive_pallas", kw)),
    "fa1": _fa1_o_only,
    "fa2_inloop": flash_attention_fa2_inloop,
    # standalone fixed-tile entries (B1)
    "flash_fixed_d64": _fixed_tile("flash_fixed_d64", 64),
    "flash_fixed_d32": _fixed_tile("flash_fixed_d32", 32),
    # flagship (B1)
    "flash": flash_attention,
}

# Which impls support the causal flag.
CAUSAL_CAPABLE = {"baseline_xla", "reference_exact", "fa2_inloop", "flash",
                  "flash_fixed_d64", "flash_fixed_d32"}


def get_attention_impl(name: str) -> Callable:
    if name not in IMPLEMENTATIONS:
        raise ValueError(
            f"unknown implementation {name!r}; available: "
            f"{sorted(IMPLEMENTATIONS)}")
    return IMPLEMENTATIONS[name]


def attention_reference_dispatch(q, k, v, **kw):
    """Alias of the flagship kernel (the reference's alias pattern)."""
    return flash_attention(q, k, v, **kw)


def validate_head_dim(head_dim: int) -> None:
    """Runtime head-dim gate (the reference's switch over head-dim
    instantiations aborts on unsupported dims the same way)."""
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"Unsupported head_dim {head_dim}; supported: "
            f"{SUPPORTED_HEAD_DIMS}")
