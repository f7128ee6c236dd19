"""Multi-device: the process group and mesh, and ring attention
(sequence parallelism) over B1 / B2 / B3."""

from flash_attention_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from flash_attention_tpu_torch.parallel.ring import (
    make_ring_attention,
    ring_attention,
    zigzag_inverse,
    zigzag_order,
)

__all__ = [
    "make_mesh",
    "mesh_shape_for",
    "ring_attention",
    "make_ring_attention",
    "zigzag_order",
    "zigzag_inverse",
]
