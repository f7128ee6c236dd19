"""Multi-device: the process group and mesh, ring attention (sequence
parallelism) over B1 / B2 / B3, and pipeline training (GPipe, 1F1B).
Expert parallelism lives with its model (models/moe.py
`make_moe_train_step`, `moe_param_shardings`), as in the JAX package."""

from flash_attention_tpu_torch.parallel.mesh import (
    axes_group,
    make_mesh,
    mesh_shape_for,
)
from flash_attention_tpu_torch.parallel.pipeline import (
    make_pp_loss,
    make_pp_train_step,
    merge_pipeline_params,
    pipeline_shardings,
    split_pipeline_params,
)
from flash_attention_tpu_torch.parallel.ring import (
    make_ring_attention,
    ring_attention,
    zigzag_inverse,
    zigzag_order,
)

__all__ = [
    "make_mesh",
    "mesh_shape_for",
    "axes_group",
    "ring_attention",
    "make_ring_attention",
    "zigzag_order",
    "zigzag_inverse",
    "make_pp_train_step",
    "make_pp_loss",
    "split_pipeline_params",
    "merge_pipeline_params",
    "pipeline_shardings",
]
