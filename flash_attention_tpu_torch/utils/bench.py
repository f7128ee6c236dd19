"""Benchmark harness: latency, throughput models, peak memory, max-batch
(port of `flash_attention_tpu/utils/bench.py`).

  - `measure`: CUDA events around chains of launches when the arguments
    lie on the card (the reference's CUDA-event timing); the host clock
    only when the caller passed CPU tensors;
  - analytic FLOPs `4*B*H*Nq*Nk*D` and the minimum HBM traffic of a flash
    kernel;
  - peak memory (`torch.cuda.max_memory_allocated`) and the max-batch
    OOM search.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import torch


@dataclasses.dataclass
class Timing:
    mean_s: float
    std_s: float
    min_s: float
    iters: int
    warmup: int

    @property
    def mean_ms(self) -> float:
        return self.mean_s * 1e3

    def __str__(self):
        return (f"{self.mean_ms:.3f} ms ± {self.std_s * 1e3:.3f} ms "
                f"(min {self.min_s * 1e3:.3f} ms, n={self.iters})")


def _device_of(args, kwargs) -> torch.device:
    for x in (*args, *kwargs.values()):
        if isinstance(x, torch.Tensor):
            return x.device
    raise ValueError("measure needs a tensor argument to know its device")


def measure(fn: Callable, *args, warmup: int = 5, iters: int = 10,
            inner: int = 16, **kwargs) -> Timing:
    """Time `fn(*args, **kwargs)`: each of `iters` samples is a chain of
    `inner` calls divided by `inner`, after `warmup` calls. On the card
    the chain sits between two CUDA events (device time, no host sync
    inside); on the CPU between two host-clock readings."""
    device = _device_of(args, kwargs)
    for _ in range(max(warmup, 1)):
        fn(*args, **kwargs)
    samples = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        events = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn(*args, **kwargs)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize(device)
        samples = [s.elapsed_time(e) * 1e-3 / inner for s, e in events]
    elif device.type == "cpu":
        for _ in range(iters):
            t0 = time.perf_counter()
            for _ in range(inner):
                fn(*args, **kwargs)
            samples.append((time.perf_counter() - t0) / inner)
    else:
        raise ValueError(f"unsupported device {device}")
    return Timing(
        mean_s=statistics.fmean(samples),
        std_s=statistics.stdev(samples) if len(samples) > 1 else 0.0,
        min_s=min(samples),
        iters=iters,
        warmup=warmup,
    )


# --- analytic models ------------------------------------------------------


def attention_flops(batch, q_heads, q_len, kv_len, head_dim,
                    causal: bool = False) -> int:
    """2 matmuls x 2 flops: 4*B*H*Nq*Nk*D; causal halves the useful work."""
    total = 4 * batch * q_heads * q_len * kv_len * head_dim
    return total // 2 if causal else total


def attention_hbm_bytes(batch, q_heads, kv_heads, q_len, kv_len, head_dim,
                        itemsize: int = 2) -> int:
    """Minimum HBM traffic of a flash kernel: read Q/K/V once, write O."""
    q = batch * q_heads * q_len * head_dim
    kv = 2 * batch * kv_heads * kv_len * head_dim
    return (2 * q + kv) * itemsize


@dataclasses.dataclass
class BenchReport:
    """One benchmark row (the reference's printed report card)."""

    name: str
    config: dict
    timing: Timing
    tflops_per_s: float
    gb_per_s: float

    def line(self) -> str:
        return (f"{self.name:24s} {self.timing.mean_ms:10.3f} ms "
                f"{self.tflops_per_s:8.2f} TFLOP/s {self.gb_per_s:8.1f} GB/s")


def bench_attention(name: str, fn: Callable, q, k, v, *, causal=False,
                    warmup=5, iters=10, inner=5, **kwargs) -> BenchReport:
    batch, hq, nq, d = q.shape
    _, hkv, nk, _ = k.shape
    t = measure(fn, q, k, v, warmup=warmup, iters=iters, inner=inner,
                **kwargs)
    flops = attention_flops(batch, hq, nq, nk, d, causal)
    nbytes = attention_hbm_bytes(batch, hq, hkv, nq, nk, d,
                                 q.element_size())
    return BenchReport(
        name=name,
        config=dict(batch=batch, q_heads=hq, kv_heads=hkv, q_len=nq,
                    kv_len=nk, head_dim=d, causal=causal,
                    dtype=str(q.dtype)),
        timing=t,
        tflops_per_s=flops / t.mean_s / 1e12,
        gb_per_s=nbytes / t.mean_s / 1e9,
    )


# --- memory ---------------------------------------------------------------


def peak_memory_bytes(device=None) -> int | None:
    """Peak bytes allocated on the card since the last reset, None
    without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.max_memory_allocated(device)


def find_max_batch(make_and_run: Callable[[int], None], *, start: int = 1,
                   limit: int = 1 << 16) -> int:
    """Exponential-growth + binary-search OOM probe. `make_and_run(batch)`
    must allocate, run and synchronize; a `torch.cuda.OutOfMemoryError`
    marks failure (the cache is emptied after it); any other error is
    raised."""

    def fits(b: int) -> bool:
        try:
            make_and_run(b)
            return True
        except torch.cuda.OutOfMemoryError:
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            return False

    if not fits(start):
        return 0
    lo = start
    hi = start * 2
    while hi <= limit and fits(hi):
        lo, hi = hi, hi * 2
    # Doubling may overshoot a non-power-of-two limit; the binary search
    # still has to cover (lo, limit].
    hi = min(hi, limit + 1)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return lo
