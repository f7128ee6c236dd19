"""Multi-host decode worker (counterpart of the JAX package's
`tests/multihost_worker.py`).

    python -m flash_attention_tpu_torch.scripts.launch_multihost \\
        --simulate N --device cpu -- \\
        -m flash_attention_tpu_torch.scripts.multihost_worker OUT \\
        [--params FILE]

Each rank decodes `LlamaConfig.tiny` (fp32) greedily with dense
contiguous caches (`prefill`, then `decode_step`) over its own
PER_HOST_BATCH sequences of a batch split by rank (weak scaling: the
batch grows with the ranks; the first sequences are the same seeded
prompts at any rank count). Params are replicated: drawn from seed 0,
or loaded from FILE (`torch.save`d, e.g. a JAX tree carried across with
`utils/convert.params_from_jax`). The transcripts are all-gathered, an
8-float all-reduce is timed, and rank 0 writes JSON with the JAX
worker's keys: num_processes, global_devices, batch, decode_steps,
tokens_per_s, psum_us and transcript ([batch, 1 + DECODE_STEPS]: the
prefill's greedy token, then one per step). The device comes from
FA_TPU_DEVICE (the launcher's `--device`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from flash_attention_tpu_torch.models.llama import (
    LlamaConfig,
    decode_step,
    init_kv_cache,
    init_params,
    prefill,
)
from flash_attention_tpu_torch.parallel.mesh import initialize_distributed

PER_HOST_BATCH = 4
DECODE_STEPS = 16
PROMPT = 32
PSUM_ITERS = 20


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode(params, cfg, tokens, device) -> torch.Tensor:
    """Greedy transcript [B, 1 + DECODE_STEPS] of prompts [B, PROMPT]."""
    cache = init_kv_cache(cfg, tokens.shape[0], PROMPT + DECODE_STEPS,
                          dtype=cfg.dtype, device=device)
    logits, cache, lengths = prefill(params, tokens, cfg, cache)
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    for _ in range(DECODE_STEPS):
        logits, cache, lengths = decode_step(params, tok, cfg, cache,
                                             lengths)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flash_attention_tpu_torch.scripts.multihost_worker")
    ap.add_argument("out")
    ap.add_argument("--params", default=None,
                    help="torch.save'd parameter tree (default: "
                         "init_params(tiny fp32, seed 0))")
    args = ap.parse_args(argv)
    device = torch.device(os.environ.get("FA_TPU_DEVICE", "cuda"))
    initialize_distributed(device=device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    grouped = dist.is_initialized()
    nproc = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    if args.params:
        params = torch.load(args.params, map_location=device,
                            weights_only=True)
    else:
        params = init_params(cfg, seed=0, device=device)
    batch = PER_HOST_BATCH * nproc
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (batch, PROMPT)).astype(np.int32)
    mine = torch.from_numpy(
        tokens[rank * PER_HOST_BATCH:(rank + 1) * PER_HOST_BATCH]).to(device)

    decode(params, cfg, mine, device)                    # warm-up
    if grouped:
        dist.barrier()
    _sync(device)
    t0 = time.perf_counter()
    local = decode(params, cfg, mine, device)
    _sync(device)
    dt = time.perf_counter() - t0

    psum_us = None
    if grouped:
        parts = [torch.empty_like(local) for _ in range(nproc)]
        dist.all_gather(parts, local)
        transcript = torch.cat(parts)
        # Whole-call time of a tiny all-reduce: an upper bound on the
        # collective's latency (gloo over loopback on the CPU).
        x = torch.ones(8, device=device)
        dist.all_reduce(x)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(PSUM_ITERS):
            dist.all_reduce(x)
        _sync(device)
        psum_us = (time.perf_counter() - t0) / PSUM_ITERS * 1e6
    else:
        transcript = local

    if rank == 0:
        with open(args.out, "w") as f:
            json.dump({
                "num_processes": nproc,
                "global_devices": nproc,
                "batch": batch,
                "decode_steps": DECODE_STEPS,
                "tokens_per_s": batch * DECODE_STEPS / dt,
                "psum_us": psum_us,
                "transcript": transcript.cpu().tolist(),
            }, f)
    print(f"proc {rank}/{nproc}: {batch * DECODE_STEPS / dt:.1f} tok/s",
          flush=True)
    if grouped:
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
