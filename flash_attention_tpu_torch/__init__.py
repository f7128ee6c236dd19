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
                token shards and batch loader, checkpoints, the
                benchmark harness (bench.py)
    csrc/       CUDA sources of the kernels (built at first use)
    ops/        kernel wrappers + plain versions: flash forward and
                backward (and its causal split), paged and contiguous
                decode, quantized KV, the study variants (FA1, FA2
                in-loop, naive) and their registry, exact references
    parallel/   process group + device mesh (torch.distributed), ring
                attention (sequence parallelism) over B1 / B2 / B3
    models/     Llama-class model (prefill, paged decode, loss and train
                step), sampling, the Trainer
    runtime/    native page allocator, paged KV caches, serving engine
    scripts/    the probes, the multi-host launcher and its workers
    cli.py      the kernel-study harness (verify, compare, perf,
                max-batch, profile)
"""

from flash_attention_tpu_torch.config import BlockSizes, select_block_sizes
from flash_attention_tpu_torch.ops.flash import (
    SegmentIds,
    flash_attention,
    flash_attention_quantized,
)
from flash_attention_tpu_torch.ops.quant import (
    QuantizedTensor,
    dequantize_kv,
    quantize_kv,
)
from flash_attention_tpu_torch.ops.reference import (
    attention_baseline,
    attention_reference,
)

__version__ = "0.1.0"

__all__ = [
    "attention_reference",
    "attention_baseline",
    "flash_attention",
    "flash_attention_quantized",
    "SegmentIds",
    "QuantizedTensor",
    "quantize_kv",
    "dequantize_kv",
    "BlockSizes",
    "select_block_sizes",
    "__version__",
]
