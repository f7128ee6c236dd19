"""What the probes share: the card's peak rates for bounds, the default
timer (utils/bench.measure: CUDA events around chains of calls on the
card, the host clock on the CPU), the printed row and the body P1 / P3
launch."""

from __future__ import annotations

from typing import Callable

import torch

from flash_attention_tpu_torch.ops.quant_matmul import tma_ready
from flash_attention_tpu_torch.utils.bench import measure

# H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    at the bf16 tensor-core rate and the bytes at the HBM rate."""
    t_ops, t_mem = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops > t_mem else "bytes")


def default_timer(device: torch.device) -> Callable[[Callable], float]:
    """ms per call of fn() by utils/bench.measure on `device` (3 warm-up
    calls, the mean of 5 chains of 4 calls)."""
    anchor = torch.empty(1, device=device)

    def timer(fn):
        return measure(lambda _: fn(), anchor, warmup=3, iters=5,
                       inner=4).mean_ms

    return timer


def row(name: str, ms: float, gb_bytes: float, cost: tuple, *,
        plain_ms=None, library_ms=None, out=print, **extra) -> dict:
    """One probe row, printed as the JAX probe prints it (name, us, GB/s
    over `gb_bytes`, the JAX probe's byte count), then the bound over
    `cost` = (flops, bytes the function must move) and the plain
    version's and the library call's times where given. Returns the row
    as a dict (times in ms)."""
    bms, by = bound_ms(*cost)
    gbps = gb_bytes / (ms * 1e-3) / 1e9
    line = (f"{name:44s} {ms * 1e3:9.1f} us  {gbps:7.1f} GB/s  bound "
            f"{bms * 1e3:.1f} us ({by})")
    if plain_ms is not None:
        line += f"  plain {plain_ms * 1e3:.1f} us"
    if library_ms is not None:
        line += f"  library {library_ms * 1e3:.1f} us"
    out(line)
    return dict(name=name, ms=ms, gbps=gbps, bound_ms=bms, bound_by=by,
                plain_ms=plain_ms, library_ms=library_ms, **extra)


def device_line(device: torch.device) -> str:
    if device.type == "cuda":
        return f"device: {torch.cuda.get_device_name(device)}"
    return "device: cpu (plain PyTorch versions; times are the host's)"


def int4_probe_body(x, packed, scales) -> str:
    """The body a P1 or P3 launch runs, decided before it: "decode" (the
    split-K decode body of csrc/matmul_sm90.cuh, x in 64-row slices, any
    M) when TMA can address x [M, K], the packed int4 weight [K/2, F] and
    its scales [K/128, F] (ops/quant_matmul.py tma_ready: 16-byte aligned
    bases, K % 8 and F % 16), else "first" (the probe's first body over
    csrc/matmul_core.cuh, e.g. at F = 5000)."""
    return "decode" if tma_ready(x, packed, "int4", scales) else "first"
