"""flash_attention_tpu_torch — the PyTorch/CUDA port of flash_attention_tpu.

The JAX package beside it is the reference: this package keeps its
names and parameter layout, imports neither JAX nor the JAX package,
and replaces each Pallas TPU kernel on a ported path with a kernel
written by hand for Hopper (sm_90a), next to a plain PyTorch version of
the same function. Entry points run on the card unless the caller
passes device="cpu"; CPU tensors take the plain versions.

Layering (bottom-up):
    config.py   shape helpers, kernel tile constants, device resolution
    utils/      error metrics and gates, JAX-layout weight conversion,
                token shards and batch loader, checkpoints
    csrc/       CUDA sources of the kernels (built at first use)
    ops/        kernel wrappers + plain versions: flash forward and
                backward, paged decode, exact references
    models/     Llama-class model (prefill, paged decode, loss and train
                step), sampling, the Trainer
    runtime/    native page allocator, paged KV cache, serving engine
"""

__version__ = "0.1.0"
