"""Llama-class model and token sampling."""

from flash_attention_tpu_torch.models.llama import (
    LlamaConfig,
    forward,
    init_params,
    loss_fn,
    make_train_step,
    param_shardings,
)
from flash_attention_tpu_torch.models.moe import (
    MoEConfig,
    init_moe_params,
    make_moe_train_step,
    moe_forward,
    moe_loss_fn,
    moe_param_shardings,
)

__all__ = [
    "LlamaConfig",
    "init_params",
    "forward",
    "loss_fn",
    "make_train_step",
    "param_shardings",
    "MoEConfig",
    "init_moe_params",
    "moe_forward",
    "moe_loss_fn",
    "make_moe_train_step",
    "moe_param_shardings",
]
