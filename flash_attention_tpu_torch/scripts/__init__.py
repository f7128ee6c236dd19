"""The probes of the JAX package's `scripts/` on the port's kernels: each
module is an entry point (`python -m flash_attention_tpu_torch.scripts.
<name>`) with a `main(argv)` and a `run(...)` that returns its rows, and
holds the wrapper of its own hand-written CUDA kernel."""
