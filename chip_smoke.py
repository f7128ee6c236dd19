#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flash_attention_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   compile the port's CUDA kernels (csrc/*.cu) and the native
             page allocator from the sources in this checkout; print
             nvcc's ptxas report and one line of registers and spill
             per B2 / B3 instantiation, per instantiation of the B6-B9
             Hopper bodies (csrc/matmul_sm90.cuh), of their fp32 FFMA
             body (csrc/matmul_f32.cuh) and of B4 / B5's split body
             (csrc/decode_sm90.cuh);
  2. check   hold each kernel against its plain PyTorch version on the
             card in bf16 at the serving shapes (B1, B4) and the training
             shape (B2, B3), and in fp16/bf16 at small shapes for its
             other instantiations (the low-precision gate: kernel error
             <= 3x the plain version's error in the same dtype against an
             fp32 reference, LSE within 1e-3); B2/B3 must also give
             identical bits on a rerun (their small shapes include a
             window over Nq < Nk at GQA 4/1 and ragged 77 x 131 rows at
             D = 256); B1 causal and B10c at q [1, 32,
             8192, 128] and B1 at ragged lengths across its tile edges
             (check_flash_long);
  3. time    each kernel, its plain version and (where one exists) the
             one PyTorch call that computes the same function, with CUDA
             events; the bound is the larger of bytes / 3.35 TB/s and
             FLOPs / 989 TFLOP/s (H100 SXM data sheet);
  3b. study the kernel-study harness: B10a (FA1, o / m / l), B10b (FA2
             in-loop, causal and not, GQA 32/8) and B10c (naive two-pass)
             against their plain versions at q [1, 32, 8192, 128] bf16
             (check_study_long) and at every compiled tile in bf16 /
             fp16 / fp32 at (1, 8, 2048, D = 32..256), B10a at ragged
             lengths (both tiles; the fp16 / bf16 16 x 16 body of
             csrc/study_sm80.cuh at every D, and the fp32 body of
             csrc/study_f32.cuh on both of its row counts, their launch
             counters exact; check_fa1_tiles times both fp16 / bf16
             tiles, check_study_fp32 the fp32 rows of B10a-c with a
             rerun for identical bits) and B10b causal with
             Nq < Nk, with B1 on fp32
             inputs (the 3x gate against fp32, fp64 for fp32 inputs; LSE
             within 1e-3, B10a's m and l too); B1's
             causal split (flash_attention_fwd_split, band 512 and 2048)
             against its plain version and single-pass B1; each timed
             beside its bound (fp32 at the 67 TFLOP/s FFMA rate) and
             SDPA; then the harness through its entry point: `cli
             verify` with the reference's defaults (fp32, then bf16 on
             the 16 x 16 body), `compare` at
             1,32,8192,{128,64,32} bf16 (non-causal, then causal) and
             1,8,2048,128 fp32 (every cross-check pair PASS, no failure
             but the fixed-tile entries' head-dim ValueError), `perf
             --causal --bwd` at its defaults, every launch counter exact;
  3c. fp32_api B1-B9 on fp32 inputs through the public calls
             (flash_attention forward and backward, paged_flash_decode
             over fp32 and int8 pools, flash_decode, quant_matmul,
             int4_matmul, dense_matmul, grouped_matmul,
             grouped_int4_matmul), every fp32 counter exact (the fp32
             FFMA body of B6-B9 too);
  3d. probes the port's probes (flash_attention_tpu_torch/scripts) at
             the JAX scripts' shapes through their run(): P1's int4
             unpack variants v1 / v2 on B7's split-K decode body (3x
             gate against the fp32 dequant reference, each against its
             own plain version; identical bits on a rerun), also at 200
             rows and on the first body (F = 5000), P2's int8 paged
             bodies with v2 on the tensor cores (the quantized-branch
             gates on O and LSE), P3's fused int4 lm_head + argmax on
             the same body (values on the 3x rule with B7's bf16 logits
             as the baseline, ids equal to the plain version's where the
             top-2 gap exceeds 4e; 200 rows; exact ties and an
             all-negative row at every chunk width on V = 5000, the
             first body, and V = 5008); launch counts exact, the P1 / P3
             first-body counters 0 at the probes' shapes;
  4. serve   the continuous-batching Engine on LlamaConfig.llama3_1b at
             full width and depth from seeded random weights, counting
             kernel launches, and hold every greedy transcript to a
             teacher-forced forward with plain attention;
  5. profile a few decode steps of the same engine with torch.profiler:
             device time by kernel and the device's busy share;
  6. train   the Trainer on LlamaConfig.llama3_1b at full width and depth
             (bf16, remat, AdamW) at batch 4 x 2048 from a seeded token
             shard: 8 steps with finite, falling loss and exactly 32 B1 /
             16 B2 / 16 B3 launches a step, an exact resume from a
             checkpoint, one profiled step (device time by kernel), and
             the kernel path held to the plain path;
  7. serve8b the Engine on LlamaConfig.llama3_8b at full width, cut to
             LLAMA_8B_LAYERS of its 32 layers for the time limit, on
             int4 (B7) and int8 (B6) weights drawn on the card by
             init_quantized_params: 16 greedy requests, exact launch
             counts, transcripts held to a teacher-forced forward on the
             dequantized weights; 8 profiled decode steps; the same
             requests on bf16 weights as the cuBLAS yardstick, then on
             the same bf16 weights with int8 and with e4m3 KV pages (B4's
             quantized branch at every decode step; the band widened by
             the logit gap of a forward whose K/V go through
             quantize_kv / dequantize_kv), KV bytes and B4's profiled
             device time per step against the bf16-KV run; the
             perplexity-delta gate (32 teacher-forced decode steps after
             a 1024-token prefill through int8 / e4m3 pages against bf16
             ones, |delta ppl| <= 0.05 max(ppl, 1)); and the
             quantized-KV API: a 2048-token forward attending int8 K/V
             through flash_attention_quantized (B1), each layer's last
             row again through flash_decode (B5) and B4's fold_scales
             body;
  8. generate sampling.generate on the int4 8B tree (B5 attention,
             exact launch counts, the same teacher-forced band);
  9. mixtral  the Engine on MoEConfig.mixtral_8x7b (dropless routing) at
             full width on int4 and int8 weights drawn on the
             card by init_quantized_moe_params, then the int4 tree with
             FA_TPU_GROUPED_MIN_TOKENS=1 (B9 at every decode step), then
             bf16 weights (each tree cut to MIXTRAL_*_LAYERS of its 32
             layers for the time limit): 8 greedy
             requests of 300-4600 tokens, exact B9 / B7 / B6 / B1 / B4
             launch counts, transcripts held to a teacher-forced forward
             with plain attention and a plain per-expert MoE, 8 profiled
             decode steps each; between the int4 runs, one int4 MoE layer
             timed through the one-hot cubes and the grouped path at
             16-8192 tokens (the card's crossover, reported);
 10. mistral  the Engine on LlamaConfig.mistral_7b (sliding window 4096)
             at full width in bf16, cut to MISTRAL_LAYERS of its 32
             layers for the time limit, weights drawn on the card:
             8 greedy requests of 700-12000 tokens in two waves (the
             second's four share a 3072-token prefix with a finished
             first-wave request), served with monolithic prefill and
             again with prefill_chunk=512 and the prefix cache (the
             rolling-buffer path); exact B1 / B4 launch counts, every
             transcript held to a teacher-forced forward with plain
             windowed attention, live pages of every windowed sequence
             within pages_for(window + page + tail) at every step, the
             prefix-cache accounting exact; 8 profiled decode steps; the
             chunked run again on int8 KV pages (window starts over
             quantized pools, the requantizing flush, the prefix cache
             gathering through the scales, eviction of quantized pages)
             with the widened band; then sampling.generate on 4 x
             5000-token prompts (B5's window);
 11. train_mistral  the Trainer on LlamaConfig.mistral_7b (window 4096)
             at full width cut to MISTRAL_TRAIN_LAYERS layers (58 GB of
             bf16 state at 32), batch 1 x 8192 from a seeded token shard:
             4 steps with finite, falling loss and exactly 2 B1 and 1 B2
             and B3 launches a layer a step, every one on its window
             branch; an exact
             resume from a checkpoint; one profiled step; the kernel
             path held to the plain path over two layers; then one
             segmented gradient through flash_attention(...,
             SegmentIds(...), window=4096) at Mistral's shape (one
             launch each of B1, B2 and B3 with segment ids) and
             moe_loss_fn forward and backward on MoEConfig.tiny_moe.
The 1B serve phase also runs one prefill with FA_TPU_DENSE_PALLAS_MM=1
(B8: exactly 7 launches per layer + 1, logits within the bf16 gate of
the cuBLAS path) and serves its requests again with prefill_chunk=256
and the prefix cache (B1 with segment ids, 2 launches per layer per
chunk dispatch). Kernel checks (phase 2) cover B5 at the generate
shape and B6 (int8, e4m3, e5m2), B7 and B8 at the 8B decode step's four
shapes (M = 16) and its prefill shapes (M = 1024), 64 and 65 rows (the
decode threshold), ragged shapes (the first body) and fp16 on both
Hopper bodies, with identical bits on a rerun of the split-K decode
body and the wrapper's host time a call; B9 on all five storages at
Mixtral's expert shapes with 16 and 8192 expert-sorted rows, a ragged
shape, a base band with rows past the data, experts that straddle the
128-row tiles (bf16 and fp16) and fp16; every B6-B9 case checks which
body it took through the first-body counter, which every model phase
holds at 0 (NO_BRANCHES); B4 and B5 on the split body
(csrc/decode_sm90.cuh) rerun for identical bits in every check, timed
with their device time alone and the wrapper's host time a call, B4 at
Mistral's serving decode step (bf16 and int8 pools) and on bf16 pools at
the 8B decode shape, the split body's edges (more splits than live
slabs, window starts that empty most splits, D = 256, pages of 40 on the
first body: check_split_edges), and their first-body counters held at 0
on every model phase; and the
window and segment-id branches at Mistral's shapes: B1's chunk-prefix
attention (segment ids), roll-buffer attention (offset, window, segment
ids) and windowed self-attention, B4 with window starts and 1 or 4
folded positions, B5 with a window (rows that see nothing must come
back O = 0 with LSE = INIT_M * scale), and the int8 / e4m3 / e5m2
branches: B4 at the 8B decode shape (and its int8 fold_scales body) and
with window starts at Mistral's shape, B5 at the generate shape and
windowed, B1 causal at T = 8192, each held to the fp32 reference over
the dequantized K/V under the same 3x gate (O and LSE) and, row by row,
to its bf16 plain version (error within 2^-5 of the row's max |O|, LSE
within 1e-3), on caches whose 128-token blocks differ in scale by
orders of magnitude; then B2 / B3's window and
segment-id branches at Mistral's training shape (q [1, 32, 8192, 128]:
window 4096, packed documents with the window, and q rows in a
document no kv column shares, whose dq must be exactly 0), timed beside
SDPA's backward with the same boolean mask; head dims 32 and 256 on
B1-B5 (bf16 timed, fp16 and int8 checked); B4 and B5 at 32 and 64 query
rows per kv head; and B2-B9 on fp32 inputs against fp64 (the 3x gate),
timed beside their bound at the 67 TFLOP/s FFMA rate or in bytes and
their library call: B2 / B3 at (1, 8, 2048, D = 64 / 128 / 256) causal
and with a window and segment ids, B4 at check_paged's shape over fp32
and int8 pools (and fold_scales), B5 at the generate shape over fp32 and
int8 caches, B6 / B7 / B8 at 16 and 1024 rows of 4096 x 14336 and 1024
rows of 14336 x 4096, B9 on five storages at Mixtral's expert shapes
with 16 rows (each B6-B9 case rerun for identical bits, the FFMA body's
launch counter exact), and B6-B9 at ragged fp32 shapes.

Prints information lines, then one JSON line describing the kernels,
then the card's name and power limit, and last one JSON line
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
no CUDA device is present or any phase fails.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12        # dense bf16 tensor-core rate, H100 SXM
PEAK_FP32_FLOPS = 67e12         # fp32 FFMA rate outside the tensor cores
PEAK_HBM_BYTES = 3.35e12        # HBM3 bandwidth, H100 SXM
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_info(build_log: str) -> dict:
    """{mangled kernel name: {"regs", "spill", "warn"}} from nvcc's
    `-Xptxas -v` report."""
    info, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            cur = m.group(1)
            info.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            info[cur]["spill"] = f"spill {m.group(1)} / {m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info[cur]["regs"] = f"{m.group(1)} registers"
        if "wgmma" in line and "serialized" in line:
            info[cur]["warn"] = "wgmma serialized"
    return info


def ptxas_rows(build_log: str, name_part: str) -> list[str]:
    """One line per kernel of nvcc's `-Xptxas -v` report whose mangled
    name holds `name_part`: its dtype, head dim and mask flag, registers
    a thread, spill stores / loads, and any wgmma serialization ptxas
    reported for it."""
    rows = []
    for mangled, v in ptxas_info(build_log).items():
        if name_part not in mangled:
            continue
        kernel = re.search(rf"(?<=\d)({re.escape(name_part)}[a-z0-9_]*?)I",
                           mangled)
        dtype = ("bf16" if "bfloat16" in mangled else
                 "fp16" if "6__half" in mangled else
                 "fp32" if "IfLi" in mangled or "_f32I" in mangled else "?")
        d = re.search(r"Li(\d+)E", mangled)
        rows.append(" ".join(filter(None, (
            kernel.group(1) if kernel else mangled, dtype,
            f"D={d.group(1)}" if d else "",
            "masked" if "Lb1E" in mangled else "dense",
            v.get("regs", "? registers"), v.get("spill", ""),
            v.get("warn", "")))))
    return rows


STORAGE_NAMES = {0: "dense", 1: "int8", 2: "e4m3", 3: "e5m2", 4: "int4",
                 5: "int4 offset-binary", 6: "int4 offset-binary + 128"}


def matmul_ptxas_rows(build_log: str) -> list[str]:
    """One line per instantiation of csrc/matmul_sm90.cuh's kernel
    (mm_sm90<T, storage, NP, grouped, epilogue>): B6-B8 prefill (NP =
    0), decode (NP = 16 / 64), B9, or the probes on the decode body (P1
    v1 / v2 by storage, P3 by its argmax epilogue), its dtype and
    storage, registers a thread and spill stores / loads."""
    rows = []
    for mangled, v in ptxas_info(build_log).items():
        m = re.search(r"mm_sm90I(\w+?)Li(\d+)ELi(\d+)ELb([01])ELi(\d+)E",
                      mangled)
        if m is None:
            continue
        storage, np_ = int(m.group(2)), int(m.group(3))
        grouped, argmax = m.group(4) == "1", m.group(5) == "1"
        rows.append(" ".join(filter(None, (
            f"P3 decode NP={np_} argmax" if argmax
            else f"P1 v{7 - storage} decode NP={np_}" if storage in (5, 6)
            else "B9" if grouped else "B6-B8 prefill" if np_ == 0
            else f"B6-B8 decode NP={np_}",
            "bf16" if "bfloat16" in m.group(1) else "fp16",
            STORAGE_NAMES[int(m.group(2))], v.get("regs", "? registers"),
            v.get("spill", ""), v.get("warn", "")))))
    return sorted(rows)


def split_ptxas_rows(build_log: str) -> list[str]:
    """One line per instantiation of csrc/decode_sm90.cuh's kernels
    (paged_split_kernel<Windowed, storage, Fold, T, D> for B4,
    contiguous_split_kernel<Windowed, storage, T, D> for B5): window,
    storage, dtype, head dim, registers a thread and spill stores /
    loads."""
    rows = []
    for mangled, v in ptxas_info(build_log).items():
        m = re.search(r"(paged|contiguous)_split_kernelILb([01])ELi(\d+)E"
                      r"(?:Lb([01])E)?(\w+?)Li(\d+)E", mangled)
        if m is None:
            continue
        rows.append(" ".join(filter(None, (
            "B4" if m.group(1) == "paged" else "B5",
            "window" if m.group(2) == "1" else "dense",
            STORAGE_NAMES[int(m.group(3))]
            + (" fold" if m.group(4) == "1" else ""),
            "bf16" if "bfloat16" in m.group(5) else "fp16",
            f"D={m.group(6)}", v.get("regs", "? registers"),
            v.get("spill", "")))))
    return sorted(rows)


def matmul_f32_ptxas_rows(build_log: str) -> list[str]:
    """One line per instantiation of csrc/matmul_f32.cuh's kernel
    (mm_f32<rows, storage, grouped>): B6-B8 or B9, the tile's rows, the
    storage, registers a thread and spill stores / loads."""
    rows = []
    for mangled, v in ptxas_info(build_log).items():
        m = re.search(r"mm_f32ILi(\d+)ELi(\d)ELb([01])E", mangled)
        if m is None:
            continue
        rows.append(" ".join(filter(None, (
            "B9" if m.group(3) == "1" else "B6-B8", f"{m.group(1)} rows",
            STORAGE_NAMES[int(m.group(2))], v.get("regs", "? registers"),
            v.get("spill", "")))))
    return sorted(rows, key=lambda r: (r.split()[0], int(r.split()[1]), r))


def study_f32_ptxas_rows(build_log: str) -> list[str]:
    """One line per instantiation of csrc/study_f32.cuh's kernel
    (study_f32<Kind, G, D, Wide>): the study kernel and its tile, head
    dim, q rows a block, registers a thread and spill stores / loads."""
    rows = []
    for mangled, v in ptxas_info(build_log).items():
        m = re.search(r"study_f32ILi(\d)ELi(\d+)ELi(\d+)ELb([01])E",
                      mangled)
        if m is None:
            continue
        kind, g, d = (int(x) for x in m.groups()[:3])
        rows.append(" ".join(filter(None, (
            ("B10a %dx%d" % (g, g), "B10b", "B10c")[kind], f"D={d}",
            f"{64 if m.group(4) == '1' and d <= 128 else 32} rows",
            v.get("regs", "? registers"), v.get("spill", "")))))
    return sorted(rows)


def flash_f32_ptxas_rows(build_log: str) -> list[str]:
    """One line per instantiation of csrc/flash_fwd_f32.cuh's kernel
    (flash_fwd_f32_kernel<D, Masked>): B1 fp32, head dim, q rows a
    block, whether it carries the window / segment-id masks, registers a
    thread and spill stores / loads."""
    rows = []
    for mangled, v in ptxas_info(build_log).items():
        m = re.search(r"flash_fwd_f32_kernelILi(\d+)ELb([01])E", mangled)
        if m is None:
            continue
        d = int(m.group(1))
        rows.append(" ".join(filter(None, (
            f"D={d}", f"{64 if d <= 128 else 32} rows",
            "masked" if m.group(2) == "1" else "dense",
            v.get("regs", "? registers"), v.get("spill", "")))))
    return sorted(rows, key=lambda r: (int(r.split()[0][2:]), r))


def p2_ptxas_rows(build_log: str) -> list[str]:
    """The line of csrc/probe_paged_int8.cu's kernel (P2 v2): registers a
    thread and spill stores / loads."""
    return [" ".join(filter(None, (v.get("regs", "? registers"),
                                   v.get("spill", ""))))
            for mangled, v in ptxas_info(build_log).items()
            if "paged_int8_v2_kernel" in mangled]


def bound_ms(flops: float, nbytes: float,
             peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops = flops / peak
    t_mem = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops > t_mem
                                     else "bytes")


class L2Flush:
    """Writes a buffer larger than the 50 MB L2 before each timed launch,
    so each kernel finds its inputs in HBM as the engine does (its pools
    and weights far exceed L2)."""

    def __init__(self):
        self.buf = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self):
        self.buf.zero_()


def time_ms(fn, flush: L2Flush, iters: int = 25, warmup: int = 3) -> float:
    """Median of `iters` CUDA-event timings of fn() after `warmup` calls,
    each launch preceded (outside the events) by an L2 flush."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_ms(fn, flush: L2Flush, iters: int = 25, warmup: int = 3) -> float:
    """time_ms with the host's launch cost taken out: the card first
    spins for 20 ms (torch.cuda._sleep), so the host has queued every
    timed launch before the first one starts, and each pair of events
    brackets the kernel alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(35_000_000)
    pairs = []
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def randn(rng, shape, dtype, std=1.0):
    return torch.from_numpy(
        rng.normal(0.0, std, shape).astype(np.float32)).to("cuda", dtype)


def fp32_copy(params) -> dict:
    """A detached fp32 copy of a Llama parameter dict: the weights of the
    fp32 reference forward the bf16 paths are held to."""
    return {"embed": params["embed"].detach().float(),
            "lm_head": params["lm_head"].detach().float(),
            "final_norm": params["final_norm"].detach().float(),
            "layers": [{k: w.detach().float() for k, w in layer.items()}
                       for layer in params["layers"]]}


# --- phase 2/3: kernels ---------------------------------------------------


def check_flash(rng, flush, results):
    from flash_attention_tpu_torch.ops import flash
    from flash_attention_tpu_torch.utils.metrics import (
        max_abs_error, verify_low_precision,
    )

    hq, hkv, d = 16, 8, 128
    scale = 1.0 / math.sqrt(d)
    for t in (512, 1000):
        q = randn(rng, (1, hq, t, d), torch.bfloat16)
        k = randn(rng, (1, hkv, t, d), torch.bfloat16)
        v = randn(rng, (1, hkv, t, d), torch.bfloat16)
        o, lse = flash.flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        o_lo, lse_lo = flash.flash_attention_fwd_plain(
            q, k, v, causal=True, scale=scale, offset=0)
        o_hi, lse_hi = flash.flash_attention_fwd_plain(
            q.float(), k.float(), v.float(), causal=True, scale=scale,
            offset=0)
        torch.cuda.synchronize()
        ok, kerr, berr = verify_low_precision(o, o_hi, o_lo)
        lse_err = max_abs_error(lse, lse_hi)
        finite = bool(torch.isfinite(lse).all()) and \
            bool(torch.isfinite(o.float()).all())
        log(f"check B1 flash_fwd T={t}: kernel_err={kerr:.3e} "
            f"bf16_plain_err={berr:.3e} lse_err={lse_err:.3e} "
            f"finite={finite}")
        if not (ok and finite and lse_err <= 1e-3):
            raise AssertionError(f"B1 flash_fwd failed its gate at T={t}")
        err_vs_plain = max_abs_error(o, o_lo)

        def kern():
            flash.flash_attention_fwd(q, k, v, causal=True)

        def plain():
            flash.flash_attention_fwd_plain(q, k, v, causal=True,
                                            scale=scale, offset=0)

        def library():
            torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)

        ms = time_ms(kern, flush)
        plain_ms = time_ms(plain, flush)
        lib_ms = time_ms(library, flush)
        flops, nbytes = flash.fwd_cost(1, hq, hkv, t, t, d, True, 2)
        bms, by = bound_ms(flops, nbytes)
        log(f"time  B1 flash_fwd T={t}: kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={bms:.4f} ({by}) "
            f"achieved={flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
        results[("flash", t)] = dict(
            max_abs_err=err_vs_plain, ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=lib_ms,
            shape=f"q(1,{hq},{t},{d}) kv(1,{hkv},{t},{d}) causal bf16")


def _bwd_gate(what, got, hi, lo):
    """The low-precision gate on (dq, dk, dv): each kernel gradient's
    error against the fp32 reference within 3x the plain version's in
    the same dtype (floored at one ulp), all finite. Returns the
    kernel's max-abs difference from the plain version per gradient."""
    from flash_attention_tpu_torch.utils.metrics import (
        max_abs_error, verify_low_precision,
    )

    parts, failed = [], []
    for name, g, g_hi, g_lo in zip(("dq", "dk", "dv"), got, hi, lo):
        ok, kerr, berr = verify_low_precision(g, g_hi, g_lo)
        finite = bool(torch.isfinite(g.float()).all())
        parts.append(f"{name} kernel_err={kerr:.3e} plain_err={berr:.3e}"
                     + ("" if finite else " NOT FINITE"))
        if not (ok and finite):
            failed.append(name)
    log(f"check {what}: " + "; ".join(parts))
    if failed:
        raise AssertionError(f"{what}: {failed} failed the gate")
    return [max_abs_error(g, g_lo) for g, g_lo in zip(got, lo)]


def by_kv_group(fn, q, k, v, *rows, **kw):
    """fn(q, k, v, *rows, **kw) on one kv head and its group of q heads
    at a time (rows: per-q-head tensors such as o, lse, do), each output
    concatenated along the head dim: the same arithmetic per head as one
    call over all heads, with one group's fp32 score tensors (~1 GB each
    at T = 8192, where all 32 heads' would be 8.6 GB)."""
    g = q.shape[1] // k.shape[1]
    outs = []
    for h in range(k.shape[1]):
        heads = slice(h * g, (h + 1) * g)
        outs.append(fn(q[:, heads], k[:, h:h + 1], v[:, h:h + 1],
                       *(r[:, heads] for r in rows), **kw))
    return tuple(torch.cat(x, dim=1) for x in zip(*outs))


def plain_fwd_bwd(q, k, v, do, **kw):
    """The plain forward, then the plain backward on its o and LSE
    (flash_attention_fwd_plain, flash_attention_bwd_plain), by kv group."""
    from flash_attention_tpu_torch.ops import flash

    o, lse = by_kv_group(flash.flash_attention_fwd_plain, q, k, v, **kw)
    return by_kv_group(flash.flash_attention_bwd_plain, q, k, v, o, lse, do,
                       **kw)


def _bwd_case(rng, dt, b, hq, hkv, nq, nk, d, causal, offset=None,
              **mask):
    """Kernel, plain (same dtype) and reference (fp32, fp64 for fp32
    inputs) backward of one case, with
    the forward's o and LSE from B1 (the kernel path) or from the plain
    forward (the plain paths); `mask`: window, segment_ids. The kernel
    runs twice: both runs must give identical bits."""
    from flash_attention_tpu_torch.ops import flash

    q = randn(rng, (b, hq, nq, d), dt)
    k = randn(rng, (b, hkv, nk, d), dt)
    v = randn(rng, (b, hkv, nk, d), dt)
    do = randn(rng, (b, hq, nq, d), dt)
    sc = 1.0 / math.sqrt(d)
    off = nk - nq if offset is None else offset
    kw = dict(causal=causal, scale=sc, offset=off, **mask)
    # The private launchers take any offset (negative ones make rows that
    # see no key); the public API rejects causal offsets below 0.
    o, lse = flash._flash_fwd_cuda(q, k, v, **kw)
    got = flash._flash_bwd_cuda(q, k, v, o, lse, do, **kw)
    again = flash._flash_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    lo = plain_fwd_bwd(q, k, v, do, **kw)
    hi = plain_fwd_bwd(*(x.to(_hi(dt)) for x in (q, k, v, do)), **kw)
    torch.cuda.synchronize()
    if not deterministic:
        raise AssertionError("B2/B3 gave different bits on a rerun")
    return (q, k, v, o, lse, do), got, hi, lo


def check_flash_bwd(rng, flush, results):
    """B2 and B3 at the training shape of the 1B model (batch 4, 2048
    tokens, 16 q / 8 kv heads of 128, causal, bf16): gate, determinism,
    times. B1 is timed at the same shape (its training launches)."""
    from flash_attention_tpu_torch.ops import flash

    b, hq, hkv, t, d = 4, 16, 8, 2048, 128
    kw = dict(causal=True, scale=1.0 / math.sqrt(d), offset=0)
    case, got, hi, lo = _bwd_case(rng, torch.bfloat16, b, hq, hkv, t, t, d,
                                  True)
    errs = _bwd_gate(f"B2/B3 flash_bwd q({b},{hq},{t},{d}) "
                     f"kv({b},{hkv},{t},{d}) causal bf16, deterministic",
                     got, hi, lo)
    del got, hi, lo
    timed = _bwd_timed("causal", case, flush, None, **kw)
    results["bwd_dq"] = dict(timed["dq"], max_abs_err=errs[0])
    results["bwd_dkv"] = dict(timed["dkv"], max_abs_err=max(errs[1:]))
    q, k, v = case[:3]

    ms = time_ms(lambda: flash.flash_attention_fwd(q, k, v, causal=True),
                 flush)
    p_ms = time_ms(lambda: flash.flash_attention_fwd_plain(q, k, v, **kw),
                   flush)
    l_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), flush)
    flops, nbytes = flash.fwd_cost(b, hq, hkv, t, t, d, True, 2)
    bms, by = bound_ms(flops, nbytes)
    log(f"time  B1 flash_fwd at the training shape: kernel_ms={ms:.4f} "
        f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} bound_ms={bms:.4f} "
        f"({by}) achieved={flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
    results["flash_train"] = dict(
        ms=ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bms, bound_by=by,
        shape=f"q({b},{hq},{t},{d}) kv({b},{hkv},{t},{d}) causal bf16")


def check_paged(rng, flush, results):
    from flash_attention_tpu_torch.ops import paged
    from flash_attention_tpu_torch.ops.flash import INIT_M
    from flash_attention_tpu_torch.utils.metrics import (
        max_abs_error, verify_low_precision,
    )

    b, hq, hkv, d, ps = 8, 16, 8, 128, 256
    scale = 1.0 / math.sqrt(d)
    lengths = np.array([1, 1500, 0, 600, 255, 257, 1024, 777], np.int32)
    need = [-(-int(n) // ps) for n in lengths]
    width = 8
    num_pages = 1 + sum(need) + 5          # page 0 is the scratch page
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((b, width), np.int32)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[at:at + n]
        at += n
    kp = randn(rng, (hkv, num_pages, ps, d), torch.bfloat16)
    vp = randn(rng, (hkv, num_pages, ps, d), torch.bfloat16)
    q = randn(rng, (b, hq, d), torch.bfloat16)
    tbl = torch.from_numpy(table).cuda()
    lens = torch.from_numpy(lengths).cuda()
    o, lse = paged.paged_flash_decode(q, kp, vp, tbl, lens,
                                      return_lse=True)
    torch.cuda.synchronize()
    o_lo, _ = paged.paged_flash_decode_plain(q, kp, vp, tbl, lens,
                                             scale=scale)
    o_hi, lse_hi = paged.paged_flash_decode_plain(
        q.float(), kp.float(), vp.float(), tbl, lens, scale=scale)
    torch.cuda.synchronize()
    ok, kerr, berr = verify_low_precision(o, o_hi, o_lo)
    lse_err = max_abs_error(lse, lse_hi)
    dead = 2
    dead_ok = (bool((o[dead] == 0).all())
               and bool((lse[dead] == INIT_M * scale).all()))
    finite = bool(torch.isfinite(lse).all())
    log(f"check B4 paged_decode B={b} lens={lengths.tolist()}: "
        f"kernel_err={kerr:.3e} bf16_plain_err={berr:.3e} "
        f"lse_err={lse_err:.3e} dead_row_ok={dead_ok} finite={finite}")
    if not (ok and finite and dead_ok and lse_err <= 1e-3):
        raise AssertionError("B4 paged_decode failed its gate")
    err_vs_plain = max_abs_error(o, o_lo)

    def kern():
        return paged.paged_flash_decode(q, kp, vp, tbl, lens,
                                        return_lse=True)

    same_bits("B4 paged_decode", kern, (o, lse))

    def plain():
        paged.paged_flash_decode_plain(q, kp, vp, tbl, lens, scale=scale)

    ms = time_ms(kern, flush)
    plain_ms = time_ms(plain, flush)
    flops, nbytes = paged.paged_decode_cost(lengths, hq, hkv, d, 2, ps)
    bms, by = bound_ms(flops, nbytes)
    log(f"time  B4 paged_decode: kernel_ms={ms:.4f} plain_ms="
        f"{plain_ms:.4f} library_ms=null (no single PyTorch call "
        f"computes attention over a page table) bound_ms={bms:.4f} "
        f"({by}) achieved={nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
    results["paged"] = dict(
        max_abs_err=err_vs_plain, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None,
        shape=f"q({b},{hq},{d}) pools({hkv},{num_pages},{ps},{d}) "
              f"lens {int(lengths.min())}-{int(lengths.max())} bf16")
    host_row("B4 paged_decode", kern, flush, results["paged"])


# --- phase 4: serve ----------------------------------------------------------


def serve() -> dict:
    """Serve 8 greedy requests on the 1B model at full width and depth
    and hold each transcript to a teacher-forced plain-attention
    forward. Returns the kernels' launch counts from the serving run."""
    import dataclasses

    from flash_attention_tpu_torch.models.llama import (
        LlamaConfig, forward, init_params,
    )
    from flash_attention_tpu_torch.ops.reference import attention_reference
    from flash_attention_tpu_torch.runtime.engine import Engine, Request

    cfg = LlamaConfig.llama3_1b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in [params["embed"], params["lm_head"]]
                   + [w for layer in params["layers"]
                      for w in layer.values()])
    log(f"serve: llama3_1b ({cfg.n_layers} layers, dim {cfg.dim}, "
        f"{cfg.n_heads}q/{cfg.n_kv_heads}kv x {cfg.head_dim}, ffn "
        f"{cfg.ffn_dim}, vocab {cfg.vocab_size}) {n_params / 1e9:.3f} B "
        f"params bf16 from seed {SEED} in "
        f"{time.perf_counter() - t0:.2f} s")
    eng = Engine(params, cfg, max_batch=8, num_pages=64, page_size=256,
                 tail_size=16, seed=SEED)
    log(f"serve: page allocator {type(eng.cache.allocator).__name__}")
    # Warm-up request (cuBLAS handles, allocator build); not counted.
    eng.run([Request(prompt=[1, 2, 3], max_new_tokens=2)])
    torch.cuda.synchronize()

    rng = np.random.default_rng(SEED + 1)
    lens = [100, 180, 250, 333, 420, 512, 600, 700]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
    eng.stats = type(eng.stats)()
    reset_counts()
    t0 = time.perf_counter()
    comps = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    launches = {"flash": got["flash"], "paged": got["paged"]}
    st = eng.stats
    log(f"serve: {len(comps)} completions in {wall:.3f} s; prefill "
        f"{st.prefill_tokens} tokens in {st.prefill_s:.4f} s; decode "
        f"{st.decode_tokens} tokens in {st.decode_steps} steps, "
        f"{st.decode_s:.4f} s = {st.decode_tokens_per_s:.1f} tok/s; "
        f"ttft {st.ttft_percentiles()}; peak pages {st.peak_pages}; "
        f"tail flushes (every {eng.cache.tail_size} tokens) "
        f"{st.flush_s:.4f} s")
    want_flash = cfg.n_layers * len(reqs)
    want_paged = cfg.n_layers * st.decode_steps
    log(f"serve: launches flash_fwd={launches['flash']} (want "
        f"{want_flash} = {cfg.n_layers}/prefill), paged_decode="
        f"{launches['paged']} (want {want_paged} = {cfg.n_layers}/step); "
        f"branch launches {[got[k] for k in NO_BRANCHES]} (want 0)")
    if launches["flash"] != want_flash or launches["paged"] != want_paged \
            or any(got[k] for k in NO_BRANCHES) or st.decode_steps == 0:
        raise AssertionError("kernel launch counts off the serving path")
    if sorted(c.request_id for c in comps) != sorted(
            r.request_id for r in reqs) or any(
            len(c.tokens) != 32 or c.finish_reason != "length"
            for c in comps):
        raise AssertionError("serving returned incomplete transcripts")

    # Teacher-forced check. e = max |bf16 - fp32| logit error of the
    # plain-attention forward on each transcript. If the engine's bf16
    # logits are within e of the fp32 ones too, the token it chose has
    # a plain-forward logit within 4e of the plain-forward max.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = fp32_copy(params)

    def plain_attn(q, k, v):
        return attention_reference(q, k, v, causal=True)

    by_id = {c.request_id: c for c in comps}
    err, gaps = 0.0, []
    for req in reqs:
        c = by_id[req.request_id]
        t = len(req.prompt)
        toks = torch.tensor(req.prompt + c.tokens[:-1], device="cuda")[None]
        with torch.no_grad():
            lg = forward(params, toks, cfg, attn_impl=plain_attn)[0, t - 1:]
            lg32 = forward(params32, toks, cfg32,
                           attn_impl=plain_attn)[0, t - 1:]
        err = max(err, float((lg.float() - lg32).abs().max()))
        chosen = lg.float()[torch.arange(len(c.tokens)), torch.tensor(
            c.tokens, device="cuda")]
        gaps.append(float((lg.float().amax(-1) - chosen).max()))
    delta = 4.0 * err
    log(f"serve: teacher-forced check: bf16 logit error e={err:.4f}, "
        f"delta=4e={delta:.4f}, worst chosen-token gap to the max logit "
        f"per request {[round(g, 4) for g in gaps]}")
    if not all(np.isfinite(gaps)) or max(gaps) > delta:
        raise AssertionError("a transcript left the teacher-forced band")
    launches["dense"] = dense_pallas_path(params, params32, cfg, cfg32,
                                          plain_attn)
    del params32
    launches["chunked"] = serve_chunked_1b(params, cfg, prompts)
    profile_decode(eng, prompts, Request)
    return launches


def serve_chunked_1b(params, cfg, prompts) -> dict:
    """The 1B serve phase's requests again with prefill_chunk=256 and the
    prefix cache (prefill_chunk_step: B1 with segment ids), then four
    prompts sharing the first 512 tokens of the 700-token one (cached at
    its install). Gates: 32 B1 per chunk dispatch and 16 B4 per decode
    step, every page back, prefix_cached_tokens > 0 and prefill tokens
    equal to the prompts' minus the cached ones, and the teacher-forced
    band. Returns the launch counts."""
    rng = np.random.default_rng(SEED + 10)
    shared = prompts[-1][:512]
    waves = [[(p, 32) for p in prompts],
             [(shared + rng.integers(0, cfg.vocab_size, k).tolist(), 32)
              for k in (60, 150, 240, 300)]]
    n = cfg.n_layers
    _, run = serve_stack(
        "serve[chunked 256 + prefix cache]", params, cfg, waves,
        dict(max_batch=8, num_pages=64, page_size=256, tail_size=16,
             prefill_chunk=256, prefix_cache=True),
        lambda st: dict(flash=2 * n * st.prefill_chunks,
                        flash_seg=n * st.prefill_chunks,
                        paged=n * st.decode_steps))
    st = run["stats"]
    total = sum(len(p) for w in waves for p, _ in w)
    log(f"serve[chunked]: prefix cache {st.prefix_cached_tokens} tokens, "
        f"prefill tokens {st.prefill_tokens} of {total} prompt tokens")
    if not (st.prefix_cached_tokens > 0
            and st.prefill_tokens == total - st.prefix_cached_tokens):
        raise AssertionError("serve[chunked]: prefix-cache accounting off")
    teacher_forced(params, cfg, [p for w in waves for p, _ in w],
                   run["transcripts"], "serve[chunked]")
    gc.collect()
    torch.cuda.empty_cache()
    return run["launches"]


def dense_pallas_path(params, params32, cfg, cfg32, plain_attn) -> int:
    """B8 on the model path: one prefill_kv of the 1B model at T = 512
    with FA_TPU_DENSE_PALLAS_MM=1 (read per call by models/llama.py _mm)
    launches B8 exactly 7 times per layer plus once for the lm_head, and
    its last-token logits stay within the bf16 gate of the default
    (cuBLAS) path against the fp32 plain-attention forward. Returns the
    B8 launches."""
    import os

    from flash_attention_tpu_torch.models.llama import forward, prefill_kv
    from flash_attention_tpu_torch.ops import quant_matmul as qm
    from flash_attention_tpu_torch.utils.metrics import verify_low_precision

    rng = np.random.default_rng(SEED + 3)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, 512))).cuda()
    default = prefill_kv(params, tokens, cfg)[0]
    os.environ["FA_TPU_DENSE_PALLAS_MM"] = "1"
    try:
        qm.dense_matmul_launches = 0
        qm.matmul_first_body_launches = 0
        got = prefill_kv(params, tokens, cfg)[0]
        torch.cuda.synchronize()
        launches = qm.dense_matmul_launches
        first = qm.matmul_first_body_launches
    finally:
        del os.environ["FA_TPU_DENSE_PALLAS_MM"]
    with torch.no_grad():
        ref = forward(params32, tokens, cfg32, attn_impl=plain_attn)[:, -1]
    ok, kerr, berr = verify_low_precision(got, ref, default)
    want = 7 * cfg.n_layers + 1
    log(f"b8 path: prefill_kv T=512 with FA_TPU_DENSE_PALLAS_MM=1: B8 "
        f"launches {launches} (want {want}), {first} on the first body "
        f"(want 0); last-token logit error vs fp32 {kerr:.4e}, default "
        f"cuBLAS path's {berr:.4e} (gate 3x)")
    if launches != want or first or not ok:
        raise AssertionError("the B8 path failed its gate")
    return launches


def profile_decode(eng, prompts, request_cls, what: str = "decode steps",
                   new: int = 10) -> dict:
    """Where a decode step's time goes: torch.profiler over 8 engine
    decode steps of the same prompts after their prefill (a chunked
    engine steps until no prompt is left prefilling; `new` tokens per
    request keep every slot live through the window), device time by
    kernel and the device's busy share of the window. Returns device ms
    per step by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.submit(request_cls(prompt=p, max_new_tokens=new))
    eng.step()                      # admission + prefill + first decode
    while eng.pending or eng.prefilling:
        eng.step()
    torch.cuda.synchronize()
    steps = 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()
    return report_profile(prof, wall, steps, what)


def report_profile(prof, wall, steps, what) -> dict:
    """Device time by kernel over a profiled window of `steps` steps and
    the device's busy share of its wall time. Returns device ms per step
    by kernel name (empty when the profiler saw no device time)."""
    rows = []
    for evt in prof.key_averages():
        # Kernel events only: CPU-side ops also carry the device time of
        # the kernels they launched, and device-side annotation ranges
        # (e.g. Optimizer.step) span kernels listed on their own; either
        # would count that time twice.
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(evt, "is_user_annotation", False):
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    if not rows:
        log("profile: the profiler recorded no device time (not measured)")
        return {}
    log(f"profile: {steps} {what}, wall {wall * 1e3 / steps:.3f} "
        f"ms/step, device busy {busy_us / 1e3 / steps:.3f} ms/step = "
        f"{busy_us / 1e6 / wall:.3f} of wall")
    for dev_us, key, count in rows[:10]:
        log(f"profile:   {dev_us / 1e3 / steps:8.4f} ms/step  "
            f"{count // steps:5d} launches/step  {key[:90]}")
    by_kernel = {}
    for dev_us, key, _ in rows:
        by_kernel[key] = by_kernel.get(key, 0.0) + dev_us / 1e3 / steps
    by_kernel["busy"] = busy_us / 1e3 / steps
    return by_kernel


def kernel_ms(profile: dict, name: str) -> float | None:
    """Device ms per step of the kernels whose name contains `name`."""
    hits = [v for k, v in profile.items() if name in k]
    return sum(hits) if hits else None


def b4_ms(profile: dict) -> float | None:
    """B4's device ms per step: its split body (paged_split_kernel) and
    its first body (paged_decode_kernel)."""
    hits = [v for k, v in profile.items()
            if "paged_split_kernel" in k or "paged_decode_kernel" in k]
    return sum(hits) if hits else None


# --- phase 7: serve 8B on quantized weights, generate ---------------------

# One prompt over 1024 tokens: its prefill bucket (2048 rows) takes the
# wide dequantize path for the layer products.
PROMPT_LENS_8B = [256, 300, 333, 400, 480, 512, 600, 640, 700, 777, 800,
                  900, 960, 1000, 1024, 1100]

def _counters() -> dict:
    """name -> (module, attribute) of every serving kernel's launch
    count."""
    from flash_attention_tpu_torch.ops import (
        decode, flash, grouped, paged, quant_matmul, variants,
    )
    from flash_attention_tpu_torch.scripts import (
        probe_int4_variants as p1, probe_lmhead_argmax as p3,
        probe_paged_int8 as p2,
    )

    return {"flash": (flash, "flash_fwd_launches"),
            "flash_seg": (flash, "flash_fwd_segment_launches"),
            "flash_win": (flash, "flash_fwd_window_launches"),
            "flash_quant": (flash, "flash_fwd_quant_launches"),
            "bwd_dq": (flash, "flash_bwd_dq_launches"),
            "bwd_dkv": (flash, "flash_bwd_dkv_launches"),
            "bwd_dq_seg": (flash, "flash_bwd_dq_segment_launches"),
            "bwd_dkv_seg": (flash, "flash_bwd_dkv_segment_launches"),
            "bwd_dq_win": (flash, "flash_bwd_dq_window_launches"),
            "bwd_dkv_win": (flash, "flash_bwd_dkv_window_launches"),
            "paged": (paged, "paged_decode_launches"),
            "paged_win": (paged, "paged_decode_window_launches"),
            "paged_quant": (paged, "paged_decode_quant_launches"),
            "paged_fold": (paged, "paged_decode_fold_launches"),
            "paged_first_body": (paged, "paged_decode_first_body_launches"),
            "decode": (decode, "decode_launches"),
            "decode_win": (decode, "decode_window_launches"),
            "decode_quant": (decode, "decode_quant_launches"),
            "decode_first_body": (decode, "decode_first_body_launches"),
            "quant": (quant_matmul, "quant_matmul_launches"),
            "int4": (quant_matmul, "int4_matmul_launches"),
            "dense": (quant_matmul, "dense_matmul_launches"),
            "grouped": (grouped, "grouped_matmul_launches"),
            "matmul_first_body": (quant_matmul,
                                  "matmul_first_body_launches"),
            "flash_fp32": (flash, "flash_fwd_fp32_launches"),
            "flash_split_bulk": (flash, "flash_fwd_split_bulk_launches"),
            "flash_split_band": (flash, "flash_fwd_split_band_launches"),
            "fa1": (variants, "fa1_launches"),
            "fa1_tile16": (variants, "fa1_tile16_launches"),
            "study_f32": (variants, "study_f32_launches"),
            "fa2": (variants, "fa2_inloop_launches"),
            "naive": (variants, "naive_launches"),
            "bwd_dq_fp32": (flash, "flash_bwd_dq_fp32_launches"),
            "bwd_dkv_fp32": (flash, "flash_bwd_dkv_fp32_launches"),
            "paged_fp32": (paged, "paged_decode_fp32_launches"),
            "decode_fp32": (decode, "decode_fp32_launches"),
            "quant_fp32": (quant_matmul, "quant_matmul_fp32_launches"),
            "int4_fp32": (quant_matmul, "int4_matmul_fp32_launches"),
            "dense_fp32": (quant_matmul, "dense_matmul_fp32_launches"),
            "grouped_fp32": (grouped, "grouped_matmul_fp32_launches"),
            "matmul_ffma": (quant_matmul, "matmul_ffma_launches"),
            "p1_v1": (p1, "v1_launches"),
            "p1_v2": (p1, "v2_launches"),
            "p1_first_body": (p1, "first_body_launches"),
            "p2_v2": (p2, "paged_int8_v2_launches"),
            "p3": (p3, "lmhead_argmax_launches"),
            "p3_first_body": (p3, "first_body_launches")}


# The branch counters (each launch also counts in its kernel's total): B1
# with segment ids, with a window, over int8 / fp8 K/V, on fp32 inputs,
# its causal split's bulk and band passes; B2 and B3 with segment ids and
# with a window; B4 with window starts, over int8 / fp8 pools, with the
# fold_scales body; B5 with a window, over int8 / fp8 caches; and the
# study kernels B10a-c; B2-B9 on fp32 inputs; the probes' kernels (P1
# v1 / v2, P2 v2, P3, and P1 / P3 on their first body); B6-B9 on their
# first body (fp16 / bf16 operands
# TMA cannot address); B4 and B5 on their first body (fp16 / bf16 launches
# the split body of decode_sm90.cuh does not take). Zero on every path
# that serves a model without a
# window, chunked prefill or quantized KV, and on every serving path for
# B2/B3; the fp32, split, study, probe and first-body counters are zero
# on every model path.
FP32_COUNTERS = ("bwd_dq_fp32", "bwd_dkv_fp32", "paged_fp32", "decode_fp32",
                 "quant_fp32", "int4_fp32", "dense_fp32", "grouped_fp32",
                 "matmul_ffma")
PROBE_COUNTERS = ("p1_v1", "p1_v2", "p1_first_body", "p2_v2", "p3",
                  "p3_first_body")
NO_BRANCHES = dict.fromkeys(("flash_seg", "flash_win", "flash_quant",
                             "flash_fp32", "flash_split_bulk",
                             "flash_split_band", "fa1", "fa1_tile16",
                             "study_f32", "fa2", "naive",
                             "bwd_dq_seg", "bwd_dkv_seg", "bwd_dq_win",
                             "bwd_dkv_win", "paged_win", "paged_quant",
                             "paged_fold", "decode_win", "decode_quant",
                             "matmul_first_body", "paged_first_body",
                             "decode_first_body", *FP32_COUNTERS,
                             *PROBE_COUNTERS), 0)


def reset_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {key: getattr(mod, attr, 0)
            for key, (mod, attr) in _counters().items()}


def teacher_forced(params, cfg, prompts, transcripts, what,
                   mlp=None, attn=None, kv_dtype=None) -> dict:
    """Hold greedy transcripts to a teacher-forced forward with plain
    attention on the dequantized weights (PR 1's band): e = max |bf16 -
    fp32| logit error of that forward over the generated positions; the
    token each transcript chose must have a bf16 plain-forward logit
    within 4e of the max. Each layer is dequantized inside the forward
    (an fp32 copy of the 8B model would take 32 GB) and each sequence
    runs alone (the plain attention of a 4600-token sequence holds 3 GB
    of fp32 scores). `mlp(layer, x, cfg)` replaces the FFN block (the
    plain MoE of the Mixtral phases); the router stays fp32. `attn(q, k,
    v)` replaces the plain causal attention (the windowed phases). With
    `kv_dtype` (a quantized-KV engine) a third, bf16 forward passes each
    layer's K/V through quantize_kv / dequantize_kv in 128-token blocks
    from position 0, as the engine's pages hold them; e_kv = max |that -
    the bf16 forward| and the band is 4(e + e_kv). Returns e, e_kv and
    the worst gap."""
    from flash_attention_tpu_torch.models.llama import (
        _attention_block, _mlp_block, rmsnorm,
    )
    from flash_attention_tpu_torch.models.quantized import (
        EXPERT_STACK_TYPES, QUANT_LEAF_TYPES,
    )
    from flash_attention_tpu_torch.ops.quant import (
        QUANT_BLOCK, dequantize_kv, quantize_kv,
    )
    from flash_attention_tpu_torch.ops.reference import attention_reference

    mlp = mlp or _mlp_block

    def plain_attn(q, k, v):
        return attention_reference(q, k, v, causal=True)

    plain_attn = attn or plain_attn

    def qdq(x):
        t = x.shape[2]
        xp = torch.nn.functional.pad(x, (0, 0, 0, (-t) % QUANT_BLOCK))
        return dequantize_kv(quantize_kv(xp, dtype=kv_dtype),
                             x.dtype)[:, :, :t]

    def kvq_attn(q, k, v):
        return plain_attn(q, qdq(k), qdq(v))

    def dense(name, w, dtype):
        if isinstance(w, QUANT_LEAF_TYPES + EXPERT_STACK_TYPES):
            return w.dequant(dtype)
        return w if name == "router" else w.to(dtype)

    variants = {"bf16": (torch.bfloat16, plain_attn),
                "fp32": (torch.float32, plain_attn)}
    if kv_dtype is not None:
        variants["kvq"] = (torch.bfloat16, kvq_attn)
    dev = params["embed"].device
    seqs = [torch.tensor(list(p) + list(t[:-1]), device=dev)[None]
            for p, t in zip(prompts, transcripts)]
    xs = {name: [params["embed"][s].to(dt) for s in seqs]
          for name, (dt, _) in variants.items()}
    with torch.no_grad():
        for layer in params["layers"]:
            for name, (dt, fn) in variants.items():
                lay = {k: dense(k, w, dt) for k, w in layer.items()}
                for i, s in enumerate(seqs):
                    pos = torch.arange(s.shape[1], dtype=torch.int32,
                                       device=dev)
                    x = xs[name][i]
                    a, _ = _attention_block(lay, x, cfg, pos, attn_impl=fn)
                    x = x + a
                    xs[name][i] = x + mlp(lay, x, cfg)
                del lay
        logits = {}
        for name, (dt, _) in variants.items():
            head = dense("lm_head", params["lm_head"], dt)
            norm = params["final_norm"].to(dt)
            logits[name] = torch.stack([
                (rmsnorm(x[0, len(p) - 1:len(p) - 1 + len(t)], norm,
                         cfg.norm_eps) @ head).float()
                for x, p, t in zip(xs[name], prompts, transcripts)])
    lg = logits["bf16"]
    diff = (lg - logits["fp32"]).abs()
    err = float(diff.max())
    err_kv = (float((logits["kvq"] - lg).abs().max()) if kv_dtype is not None
              else 0.0)
    chosen = torch.tensor([list(t) for t in transcripts], device=dev)
    gaps = (lg.amax(-1) - lg.gather(-1, chosen[..., None])[..., 0]).amax(-1)
    gaps = gaps.tolist()
    agree = float((logits["fp32"].argmax(-1) == chosen).float().mean())
    delta = 4.0 * (err + err_kv)
    log(f"{what}: teacher-forced check: bf16 logit error e={err:.4f} "
        f"(mean {float(diff.mean()):.4f})"
        + (f", quantized-KV logit gap e_kv={err_kv:.4f}" if kv_dtype
           is not None else "")
        + f", delta={'4(e+e_kv)' if kv_dtype is not None else '4e'}="
        f"{delta:.4f}, worst chosen-token gap to the max logit per request "
        f"{[round(g, 4) for g in gaps]}; chosen = fp32 argmax at "
        f"{agree:.3f} of positions (reported)")
    if not all(np.isfinite(gaps)) or max(gaps) > delta:
        raise AssertionError(f"{what}: a transcript left the "
                             f"teacher-forced band")
    return dict(e=err, e_kv=err_kv, worst_gap=max(gaps))


KV_KINDS = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn}
ENGINE_8B = dict(max_batch=16, num_pages=96, page_size=256, tail_size=16)


def kv_bytes(cache) -> dict:
    """Bytes of the KV pages (codes), their scale pools, and what the
    same pages take in bf16."""
    codes = 2 * sum(t.numel() * t.element_size() for t in cache.k_pools)
    scales = (0 if cache.k_scale_pools is None else
              2 * sum(t.numel() * 4 for t in cache.k_scale_pools))
    bf16 = 2 * sum(t.numel() * 2 for t in cache.k_pools)
    return dict(codes=codes, scales=scales, bf16=bf16,
                hbm_bytes=cache.hbm_bytes)


def serve_8b(kind: str, params, cfg, kv=None) -> dict:
    """Serve 16 greedy requests (prompts of 256-1100 tokens, 32 new tokens
    each) on LlamaConfig.llama3_8b at full width through
    serve_stack: "int4" and "int8" weight trees from init_quantized_params
    (drawn on the card), or "bf16" init_params weights, with bf16 KV or,
    with `kv`, int8 / e4m3 KV pages. Gates: exact launch counts (B7 / B6
    7 per layer + the lm_head per decode step and per prefill bucket of
    at most 1024 rows, 1 for the lm_head of a wider prefill; B1 / B4 as
    in the 1B phase; with quantized KV every B4 launch on its quantized
    branch), every page back, and for quantized weights or KV the
    teacher-forced band. Profiles 8 decode steps (except int8 weights);
    int4 also runs the generate phase."""
    from flash_attention_tpu_torch.runtime.engine import Request, _bucket

    kv_name = {v: k for k, v in KV_KINDS.items()}.get(kv)
    what = f"serve8b[{kind}" + (f", {kv_name} KV]" if kv else "]")
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS_8B]
    n = cfg.n_layers
    per = 7 * n + 1
    small = sum(_bucket(k) <= 1024 for k in PROMPT_LENS_8B)

    def counts(st):
        want = dict(flash=n * len(prompts), paged=n * st.decode_steps)
        if kind != "bf16":
            mine = "int4" if kind == "int4" else "quant"
            want[mine] = per * (st.decode_steps + small) \
                + (len(prompts) - small)
        if kv is not None:
            want["paged_quant"] = n * st.decode_steps
        return want

    eng, run = serve_stack(what, params, cfg, [[(p, 32) for p in prompts]],
                           dict(ENGINE_8B, kv_quant_dtype=kv), counts)
    st = run["stats"]
    out = dict(decode_tok_s=st.decode_tokens_per_s, prefill_s=st.prefill_s,
               ttft=st.ttft_percentiles(), decode_steps=st.decode_steps,
               launches=run["launches"], peak_bytes=run["peak_bytes"],
               book_s=st.book_s)
    if kv is not None:
        out["kv_bytes"] = kv_bytes(eng.cache)
        log(f"{what}: KV pages {out['kv_bytes']['codes']} bytes of codes + "
            f"{out['kv_bytes']['scales']} bytes of scales, against "
            f"{out['kv_bytes']['bf16']} bytes in bf16 (hbm_bytes, pages "
            f"and tails without the scales: {out['kv_bytes']['hbm_bytes']})")
    if kind != "bf16" or kv is not None:
        out["band"] = teacher_forced(params, cfg, prompts,
                                     run["transcripts"], what, kv_dtype=kv)
    gc.collect()
    torch.cuda.empty_cache()
    if kind != "int8":
        prof = profile_decode(eng, prompts, Request, f"{what} decode steps")
        out["b4_ms_per_step"] = b4_ms(prof)
        out["busy_ms_per_step"] = prof.get("busy")
    if kind == "int4":
        out["generate"] = generate_8b(params, cfg, eng, Request)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ppl_delta_8b(params, cfg, kv) -> dict:
    """The perplexity-delta gate (tests/test_quant_serving.py:110) at full
    width: teacher-forced NLL of 32 decode steps after a 1024-token
    prefill, through a LayeredPagedKVCache with `kv` pages against a
    bf16 one (tail 16, flushed when full); |delta ppl| <= 0.05 max(ppl,
    1). B4 runs once per layer per step, on its quantized branch for the
    quantized cache. With random weights the logits are flat and the
    perplexity near the vocabulary size."""
    from flash_attention_tpu_torch.models.llama import (
        decode_step_paged, prefill_kv,
    )
    from flash_attention_tpu_torch.runtime.kv_cache import LayeredPagedKVCache

    t0, steps = 1024, 32
    rng = np.random.default_rng(SEED + 11)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, t0 + steps + 1)
                              ).cuda()
    with torch.no_grad():
        _, ks, vs = prefill_kv(params, tokens[None, :t0], cfg)
    nll = {}
    for name, dt in (("bf16", None), ("quant", kv)):
        cache = LayeredPagedKVCache(
            n_layers=cfg.n_layers, kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, num_pages=8, page_size=256, max_seqs=1,
            tail_size=16, dtype=cfg.dtype, quant_dtype=dt)
        sid = cache.add_sequence(ks[:, 0], vs[:, 0])
        reset_counts()
        out, tail = [], 0
        for i in range(steps):
            tables, lens = cache.batch_state([sid], 8)
            logits, _, _ = decode_step_paged(
                params, tokens[t0 + i:t0 + i + 1], cfg, cache.k_pools,
                cache.v_pools, cache.k_tails, cache.v_tails, tables, lens,
                torch.tensor([tail], dtype=torch.int32, device="cuda"),
                k_scales=cache.k_scale_pools, v_scales=cache.v_scale_pools)
            logp = torch.log_softmax(logits.float(), dim=-1)
            out.append(-logp[0, tokens[t0 + i + 1]])
            tail += 1
            if tail >= cache.tail_size:
                cache.flush_tails([sid], [tail])
                tail = 0
        nll[name] = float(torch.stack(out).mean())
        got = read_counts()
        want = dict(got, **NO_BRANCHES, paged=cfg.n_layers * steps,
                    flash=0, decode=0, quant=0, int4=0, dense=0, grouped=0)
        want["paged_quant"] = cfg.n_layers * steps if dt else 0
        if got != want:
            raise AssertionError(f"ppl gate: launches {got}, want {want}")
        del cache
    ppl_d, ppl_q = math.exp(nll["bf16"]), math.exp(nll["quant"])
    delta, limit = abs(ppl_q - ppl_d), 0.05 * max(ppl_d, 1.0)
    kv_name = {v: k for k, v in KV_KINDS.items()}[kv]
    log(f"ppl gate[{kv_name} KV]: llama3_8b, {steps} teacher-forced decode "
        f"steps after a {t0}-token prefill: NLL bf16 KV {nll['bf16']:.5f} "
        f"(ppl {ppl_d:.2f}), {kv_name} KV {nll['quant']:.5f} (ppl "
        f"{ppl_q:.2f}); |delta ppl| {delta:.4f} <= {limit:.4f} (random "
        f"weights: flat logits, ppl near the vocabulary size)")
    if not delta <= limit:
        raise AssertionError(f"ppl gate[{kv_name} KV] failed")
    return dict(nll_bf16=nll["bf16"], nll_quant=nll["quant"], ppl_bf16=ppl_d,
                ppl_quant=ppl_q, delta=delta, limit=limit)


def quant_api_8b(params, cfg) -> dict:
    """The quantized-KV attention API at full width (no engine
    path of the JAX package calls it): a 2048-token forward of the bf16
    llama3_8b whose every layer attends over its K/V quantized to int8 by
    quantize_kv, through flash_attention_quantized (B1's int8 branch);
    each layer's last row is recomputed from the same QuantizedTensor
    caches by flash_decode (B5's int8 branch) and from them as 8 pages of
    256 by paged_flash_decode with fold_scales (B4's fold body). Gates:
    exactly one launch of each per layer; the three last rows within
    0.05 of each other; the logits finite and within 1.0 of the plain
    forward on the dequantized K/V (a sanity bound: both are bf16). So
    this phase gates launch counts and the kernels' agreement with each
    other; each kernel is held to its plain version in phase 2."""
    from flash_attention_tpu_torch.models.llama import forward
    from flash_attention_tpu_torch.ops.decode import flash_decode
    from flash_attention_tpu_torch.ops.flash import flash_attention_quantized
    from flash_attention_tpu_torch.ops.paged import paged_flash_decode
    from flash_attention_tpu_torch.ops.quant import dequantize_kv, quantize_kv
    from flash_attention_tpu_torch.ops.reference import attention_reference

    t = 2048
    rng = np.random.default_rng(SEED + 12)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, t))).cuda()
    last_gap = []

    ps = 256
    table = torch.arange(t // ps, dtype=torch.int32, device="cuda")[None]
    lengths = torch.full((1,), t, dtype=torch.int32, device="cuda")

    def pages(qt):
        """A [1, Hkv, T, D] QuantizedTensor as pools of T / ps pages in
        order (codes [Hkv, T/ps, ps, D], scales [Hkv, T/ps, ps/128, D])."""
        _, hkv, _, d = qt.shape
        return (qt.values[0].reshape(hkv, t // ps, ps, d),
                qt.scales[0].reshape(hkv, t // ps, ps // 128, d))

    def quant_attn(q, k, v):
        kq, vq = quantize_kv(k), quantize_kv(v)
        o = flash_attention_quantized(q, kq, vq, causal=True)
        ql = q[:, :, -1].contiguous()
        o5 = flash_decode(ql, kq, vq, lengths)
        (kp, ks), (vp, vs) = pages(kq), pages(vq)
        o4 = paged_flash_decode(ql, kp, vp, table, lengths, k_scales=ks,
                                v_scales=vs, fold_scales=True)
        last_gap.append(max(max_abs(o5, o[:, :, -1]), max_abs(o4, o5)))
        return o

    def plain_qdq(q, k, v):
        return attention_reference(q, dequantize_kv(quantize_kv(k)),
                                   dequantize_kv(quantize_kv(v)),
                                   causal=True)

    reset_counts()
    with torch.no_grad():
        lg = forward(params, tokens, cfg, attn_impl=quant_attn)[0].float()
    torch.cuda.synchronize()
    got = read_counts()
    n = cfg.n_layers
    want = dict(got, **NO_BRANCHES)
    want.update(flash=n, flash_quant=n, decode=n, decode_quant=n, paged=n,
                paged_quant=n, paged_fold=n, quant=0, int4=0, dense=0,
                grouped=0)
    with torch.no_grad():
        ref = forward(params, tokens, cfg, attn_impl=plain_qdq)[0].float()
    err = float((lg - ref).abs().max())
    log(f"quant_api[8b int8 KV]: forward T={t}: launches {got} (want "
        f"{want}); last row of B5 vs B1 and of B4 fold_scales (the cache as "
        f"{t // ps} pages of {ps}) vs B5, max |diff| {max(last_gap):.3e}; "
        f"logits "
        f"vs the plain forward on the dequantized K/V max |diff| {err:.4f}")
    if got != want or max(last_gap) > 0.05 or not math.isfinite(err) \
            or err > 1.0:
        raise AssertionError("quant_api: launch counts or outputs off")
    return dict(launches=got, b5_vs_b1=max(last_gap), logit_err=err)


# Depth of the 8B trees: 8 of 32 layers keep the whole script well inside
# its time limit; every layer runs the same kernels at the same shapes.
LLAMA_8B_LAYERS = 8


def serve_8b_phase() -> dict:
    """Phase 7: llama3_8b (cut to LLAMA_8B_LAYERS layers) on int4 and int8 weights, then on bf16 weights
    with bf16 KV (the yardstick), int8 KV and e4m3 KV, the perplexity-
    delta gate for both KV storages and the quantized-KV API drive."""
    from flash_attention_tpu_torch.models.llama import (
        LlamaConfig, init_params,
    )
    from flash_attention_tpu_torch.models.quantized import (
        init_quantized_params, logical_param_count, params_nbytes,
    )

    cfg = LlamaConfig.llama3_8b(n_layers=LLAMA_8B_LAYERS,
                                dtype=torch.bfloat16)
    out = {}
    for kind in ("int4", "int8", "bf16"):
        t0 = time.perf_counter()
        if kind == "bf16":
            params = init_params(cfg, seed=SEED)
        else:
            params = init_quantized_params(
                cfg, SEED, "int4" if kind == "int4" else torch.int8)
        torch.cuda.synchronize()
        log(f"serve8b[{kind}]: llama3_8b ({cfg.n_layers} layers, dim "
            f"{cfg.dim}, {cfg.n_heads}q/{cfg.n_kv_heads}kv x {cfg.head_dim}, "
            f"ffn {cfg.ffn_dim}, vocab {cfg.vocab_size}) "
            f"{logical_param_count(params) / 1e9:.3f} B logical params, "
            f"{params_nbytes(params) / 1e9:.3f} GB of weights, seed {SEED}, "
            f"built on the card in {time.perf_counter() - t0:.2f} s")
        out[kind] = serve_8b(kind, params, cfg)
        if kind == "bf16":
            for name, dt in KV_KINDS.items():
                out[f"kv_{name}"] = serve_8b(kind, params, cfg, kv=dt)
            out["ppl"] = {name: ppl_delta_8b(params, cfg, dt)
                          for name, dt in KV_KINDS.items()}
            out["quant_api"] = quant_api_8b(params, cfg)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    b4 = {k: out[k].get("b4_ms_per_step") for k in ("bf16", "kv_int8",
                                                     "kv_e4m3")}
    log(f"serve8b: decode tok/s at batch 16 -- int4 "
        f"{out['int4']['decode_tok_s']:.1f}, int8 "
        f"{out['int8']['decode_tok_s']:.1f}, bf16 (cuBLAS yardstick) "
        f"{out['bf16']['decode_tok_s']:.1f}, bf16 with int8 KV "
        f"{out['kv_int8']['decode_tok_s']:.1f}, with e4m3 KV "
        f"{out['kv_e4m3']['decode_tok_s']:.1f}; B4 device ms per decode "
        f"step (profiled) bf16 / int8 / e4m3 KV {b4}; peak memory GiB "
        f"{ {k: round(out[k]['peak_bytes'] / 2**30, 2) for k in ('bf16', 'kv_int8', 'kv_e4m3')} }")
    return out


def generate_8b(params, cfg, eng, request_cls) -> dict:
    """sampling.generate on the int4 8B tree: 4 prompts of 512 tokens, 32
    new tokens. B5 launches once per layer per decode step (31 steps);
    B7 7 per layer + the lm_head per decode step and once for the
    prefill's lm_head (its 2048-row layer products take the wide path).
    Transcripts are held to the teacher-forced band; how many equal the
    engine's on the same prompts is reported."""
    from flash_attention_tpu_torch.models.sampling import generate

    rng = np.random.default_rng(SEED + 5)
    prompts = rng.integers(0, cfg.vocab_size, (4, 512))
    new = 32
    reset_counts()
    t0 = time.perf_counter()
    out = generate(params, torch.from_numpy(prompts).cuda(), cfg,
                   max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    steps = new - 1
    per = 7 * cfg.n_layers + 1
    want = dict(got, **NO_BRANCHES, decode=cfg.n_layers * steps,
                int4=per * steps + 1, flash=cfg.n_layers, paged=0, quant=0,
                dense=0, grouped=0)
    transcripts = out.tolist()
    log(f"generate: 4 x 512-token prompts, {new} new tokens in "
        f"{wall:.3f} s ({4 * new / wall:.1f} tok/s including prefill); "
        f"launches {got} (want {want})")
    if got != want or out.shape != (4, new):
        raise AssertionError("generate: kernel launch counts off the path")
    teacher_forced(params, cfg, prompts.tolist(), transcripts, "generate")
    comps = eng.run([request_cls(prompt=p, max_new_tokens=new)
                     for p in prompts.tolist()])
    same = sum(c.tokens == t for c, t in zip(comps, transcripts))
    log(f"generate: {same} of 4 transcripts equal the int4 engine's on the "
        f"same prompts (reported, not gated)")
    return dict(launches=got, wall_s=wall, equal_to_engine=same)


# --- phase 9: serve Mixtral-8x7B (MoE, dropless) on B9 ---------------------

# Two prompts in buckets of at most 1024 rows (attention products on
# B7 / B6, one-hot MoE), one in the 2048 bucket (the wide dequantize
# path and the one-hot cubes), four in the 4096 bucket and one in the
# 8192 bucket (the MoE on B9: 8192 and 16384 expert-sorted rows).
PROMPT_LENS_MIXTRAL = [300, 640, 1000, 1500, 2200, 2900, 3600, 4600]


def moe_mlp_plain(layer, x, cfg):
    """The dropless MoE FFN in plain PyTorch, expert by expert: each
    token's top-k experts by softmax probability of the fp32 router
    logits (torch.topk), gates renormalised; no sort, no one-hot cubes,
    no kernel. The teacher-forced reference of the Mixtral phases."""
    from flash_attention_tpu_torch.models.llama import rmsnorm

    b, t, d = x.shape
    flat = rmsnorm(x, layer["mlp_norm"], cfg.norm_eps).reshape(b * t, d)
    probs = torch.softmax(flat.float() @ layer["router"], dim=-1)
    gates, experts = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(flat)
    for e in range(cfg.n_experts):
        tok, slot = torch.nonzero(experts == e, as_tuple=True)
        if tok.numel():
            h = flat[tok]
            a = (torch.nn.functional.silu(h @ layer["w_gate"][e])
                 * (h @ layer["w_up"][e]))
            y.index_add_(0, tok, (a @ layer["w_down"][e])
                         * gates[tok, slot, None].to(y.dtype))
    return y.reshape(b, t, d)


def crossover(layer, cfg) -> list:
    """One Mixtral MoE layer on int4 stacks through the drop-free one-hot
    cubes (moe_mlp, capacity = n) and through the grouped path
    (moe_mlp_grouped: sort + B9) at dispatches of 16-8192 tokens: where
    the grouped path starts to win on this card. The dispatch threshold
    stays the JAX package's 4096 (reported, not changed)."""
    from flash_attention_tpu_torch.models.moe import moe_mlp, moe_mlp_grouped

    flush = L2Flush()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    rows = []
    for n in (16, 512, 2048, 4096, 8192):
        x = torch.randn((1, n, cfg.dim), generator=gen,
                        device="cuda").to(cfg.dtype)
        onehot = time_ms(lambda: moe_mlp(layer, x, cfg, capacity=n), flush,
                         iters=5, warmup=1)
        grouped = time_ms(lambda: moe_mlp_grouped(layer, x, cfg), flush,
                          iters=5, warmup=1)
        log(f"crossover: n={n} tokens: one-hot {onehot:.3f} ms, grouped "
            f"{grouped:.3f} ms (one int4 Mixtral MoE layer; grouped/one-hot "
            f"{grouped / onehot:.3f})")
        rows.append(dict(n=n, onehot_ms=onehot, grouped_ms=grouped))
        del x
        torch.cuda.empty_cache()
    return rows


def serve_mixtral(kind, params, cfg, forced=False) -> dict:
    """Serve 8 greedy requests (prompts of 300-4600 tokens, 32 new tokens
    each) on a Mixtral tree through serve_stack (max_batch 8, pages of
    256, tail 16); `forced` sets FA_TPU_GROUPED_MIN_TOKENS=1 for the run
    (the grouped path at every dispatch, decode included). Gates: exact
    launch counts of B9, B7 / B6, B1 and B4 worked out from the code,
    every page back, and every transcript inside the teacher-forced band
    (plain attention, plain dropless MoE, weights dequantized one layer
    at a time). Profiles 8 decode steps. Returns the run's numbers."""
    import os

    from flash_attention_tpu_torch.models.moe import dropless_dispatch_path
    from flash_attention_tpu_torch.runtime.engine import Request, _bucket

    what = f"serve_mixtral[{kind}{' forced' if forced else ''}]"
    rng = np.random.default_rng(SEED + 6)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS_MIXTRAL]
    engine_kw = dict(max_batch=8, num_pages=96, page_size=256, tail_size=16)
    n = cfg.n_layers
    per = 4 * n + 1          # wq, wk, wv, wo per layer + the lm_head
    buckets = [_bucket(k) for k in PROMPT_LENS_MIXTRAL]
    small = sum(b <= 1024 for b in buckets)

    def counts(st):
        # Read inside the run: the dispatch threshold follows the env.
        grouped_prefills = sum(dropless_dispatch_path(b) == "grouped"
                               for b in buckets)
        grouped_steps = (st.decode_steps if dropless_dispatch_path(
            engine_kw["max_batch"]) == "grouped" else 0)
        want = dict(flash=n * len(prompts), paged=n * st.decode_steps,
                    grouped=3 * n * (grouped_prefills + grouped_steps))
        if kind in ("int4", "int8"):
            want["int4" if kind == "int4" else "quant"] = \
                per * (st.decode_steps + small) + (len(prompts) - small)
        log(f"{what}: B9 3 per MoE layer per grouped dispatch: "
            f"{grouped_prefills} prefills, {grouped_steps} decode steps; "
            f"B7/B6 {per} per decode step and per prefill of at most 1024 "
            f"rows ({small}), 1 per wider prefill")
        return want

    if forced:
        os.environ["FA_TPU_GROUPED_MIN_TOKENS"] = "1"
    try:
        eng, run = serve_stack(what, params, cfg,
                               [[(p, 32) for p in prompts]], engine_kw,
                               counts)
        st = run["stats"]
        out = dict(decode_tok_s=st.decode_tokens_per_s,
                   prefill_s=st.prefill_s, ttft=st.ttft_percentiles(),
                   decode_steps=st.decode_steps, launches=run["launches"],
                   transcripts=run["transcripts"])
        teacher_forced(params, cfg, prompts, out["transcripts"], what,
                       mlp=moe_mlp_plain)
        gc.collect()
        torch.cuda.empty_cache()
        profile_decode(eng, prompts, Request, f"{what} decode steps")
    finally:
        if forced:
            del os.environ["FA_TPU_GROUPED_MIN_TOKENS"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Depth of the Mixtral trees: 4 of their 32 layers each keep the whole
# script well inside its time limit (a bf16 tree of 16 layers is the most
# that fits one card, 93 GB at 32); every layer runs the same kernels at
# the same shapes.
MIXTRAL_BF16_LAYERS = 4
MIXTRAL_INT8_LAYERS = 4
MIXTRAL_INT4_LAYERS = 4


def mixtral() -> dict:
    """Phase 9: Mixtral-8x7B (MoEConfig.mixtral_8x7b, dropless routing)
    at full width on int4 and int8 trees from init_quantized_moe_params
    (cut to MIXTRAL_INT4_LAYERS / MIXTRAL_INT8_LAYERS layers), the int4
    tree again with the grouped path forced, and a
    bf16 tree cut to MIXTRAL_BF16_LAYERS layers; between the int4 runs
    the crossover report. Returns each run's numbers."""
    from flash_attention_tpu_torch.models.moe import (
        MoEConfig, init_moe_params,
    )
    from flash_attention_tpu_torch.models.quantized import (
        init_quantized_moe_params, logical_param_count, params_nbytes,
    )

    out = {}
    for kind in ("int4", "int8", "bf16"):
        layers = {"bf16": MIXTRAL_BF16_LAYERS, "int4": MIXTRAL_INT4_LAYERS,
                  "int8": MIXTRAL_INT8_LAYERS}[kind]
        cfg = MoEConfig.mixtral_8x7b(
            routing="dropless", dtype=torch.bfloat16, n_layers=layers)
        t0 = time.perf_counter()
        if kind == "bf16":
            params = init_moe_params(cfg, seed=SEED)
        else:
            params = init_quantized_moe_params(
                cfg, SEED, "int4" if kind == "int4" else torch.int8)
        torch.cuda.synchronize()
        log(f"mixtral[{kind}]: MoEConfig.mixtral_8x7b ({cfg.n_layers} "
            f"layers, dim {cfg.dim}, {cfg.n_heads}q/{cfg.n_kv_heads}kv x "
            f"{cfg.head_dim}, ffn {cfg.ffn_dim}, {cfg.n_experts} experts "
            f"top-{cfg.top_k}, vocab {cfg.vocab_size}, dropless) "
            f"{logical_param_count(params) / 1e9:.3f} B logical params, "
            f"{params_nbytes(params) / 1e9:.3f} GB of weights, seed {SEED}, "
            f"built on the card in {time.perf_counter() - t0:.2f} s")
        key = kind
        out[key] = serve_mixtral(kind, params, cfg)
        if kind == "int4":
            out["crossover"] = crossover(params["layers"][0], cfg)
            out["int4_forced"] = serve_mixtral(kind, params, cfg,
                                               forced=True)
            same = sum(a == b for a, b in zip(
                out["int4"]["transcripts"], out["int4_forced"]["transcripts"]))
            log(f"mixtral[int4]: {same} of 8 forced-grouped transcripts "
                f"equal the default run's (reported, not gated: the two "
                f"dropless paths agree only to rounding)")
            out["int4_forced"]["equal_to_default"] = same
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


# --- phase 10: Mistral-7B, the windowed serving stack ------------------------

MISTRAL_PREFIX = 3072            # the shared system prompt (12 pages of 256)
# Prompt lengths of the two waves; every second-wave prompt and the last
# of the first wave are the shared prefix plus a suffix of this length.
MISTRAL_WAVES = ((12000, 5000, 700, 428), (1000, 128, 2000, 5000))
MISTRAL_ENGINE = dict(max_batch=8, num_pages=192, page_size=256,
                      tail_size=16)
MISTRAL_CHUNK = 512
GENERATE_WINDOWED_PROMPT = 5000


def windowed_plain_attn(window, block=1024):
    """Plain windowed causal attention (ops/reference.py, fp32 scores) in
    query blocks of `block` rows, each against only the key rows its
    window can reach: a 12k-token sequence never holds its full score
    matrix."""
    from flash_attention_tpu_torch.ops.reference import attention_reference

    def attn(q, k, v):
        t = q.shape[2]
        out = []
        for r0 in range(0, t, block):
            r1 = min(t, r0 + block)
            lo = max(0, r0 - window + 1)
            out.append(attention_reference(
                q[:, :, r0:r1], k[:, :, lo:r1], v[:, :, lo:r1], causal=True,
                window=window))
        return torch.cat(out, dim=2)

    return attn


def serve_waves(eng, waves, request_cls, poll=None) -> list:
    """Submit each wave of (prompt, max_new_tokens) and step the engine
    until it drains before the next; `poll(eng)` after every step.
    Returns the completions in submission order."""
    out = []
    for wave in waves:
        reqs = [request_cls(prompt=p, max_new_tokens=n) for p, n in wave]
        for r in reqs:
            eng.submit(r)
        done = []
        while eng.pending or eng.prefilling or eng.num_active:
            done += eng.step()
            if poll is not None:
                poll(eng)
        by_id = {c.request_id: c for c in done}
        out += [by_id[r.request_id] for r in reqs]
    return out


def live_page_poll(peaks, from_first_flush=False):
    """A poll that records each live sequence's stored pages per step.
    With `from_first_flush` a sequence is recorded only once a tail
    flush (which evicts the pages below the window) has run while it was
    live -- the monolithic install pages in the whole prompt, as the JAX
    engine's does. A slot's tail shrinks only at a flush. Sequences are
    told apart by request and branch (the engine reuses seq ids)."""
    last_tail, flushed = {}, set()

    def poll(eng):
        for s in eng.slots:
            if s is None:
                continue
            key = (s.request.request_id, s.branch)
            if s.tail < last_tail.get(key, 0):
                flushed.add(key)
            last_tail[key] = s.tail
            if from_first_flush and key not in flushed:
                continue
            peaks.append(eng.cache.pages_for(
                max(eng.cache.length(s.seq_id), 1))
                - eng.cache.allocator.base(s.seq_id))
    return poll


def serve_stack(what, params, cfg, waves, engine_kw, counts_fn, poll=None):
    """One engine run of `waves` with its launch counts, stats and
    transcripts. `counts_fn(stats)` gives the wanted launch counts from
    the run's decode steps and chunk dispatches; they must be exact, the
    transcripts complete and every page back at the end."""
    from flash_attention_tpu_torch.runtime.engine import Engine, Request

    eng = Engine(params, cfg, seed=SEED, **engine_kw)
    eng.run([Request(prompt=[1, 2, 3], max_new_tokens=2)])     # warm-up
    torch.cuda.synchronize()
    free0 = eng.cache.free_pages
    eng.stats = type(eng.stats)()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    comps = serve_waves(eng, waves, Request, poll)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    st = eng.stats
    want = dict(got, **NO_BRANCHES,
                **{k: 0 for k in ("decode", "quant", "int4", "dense",
                                  "grouped")})
    want.update(counts_fn(st))
    peak = torch.cuda.max_memory_allocated()
    log(f"{what}: {len(comps)} completions in {wall:.3f} s; prefill "
        f"{st.prefill_tokens} tokens ({st.prefix_cached_tokens} from the "
        f"prefix cache, {st.prefill_chunks} chunk dispatches) in "
        f"{st.prefill_s:.4f} s; decode {st.decode_tokens} tokens in "
        f"{st.decode_steps} steps, {st.decode_s:.4f} s = "
        f"{st.decode_tokens_per_s:.1f} tok/s; ttft "
        f"{st.ttft_percentiles()}; peak pages {st.peak_pages}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; launches {got} "
        f"(want {want})")
    if got != want or st.decode_steps == 0:
        raise AssertionError(f"{what}: kernel launch counts off the path")
    if any(len(c.tokens) != n or c.finish_reason != "length"
           for c, (_, n) in zip(comps, [x for w in waves for x in w])):
        raise AssertionError(f"{what}: incomplete transcripts")
    if eng.cache.free_pages != free0:
        raise AssertionError(f"{what}: {free0 - eng.cache.free_pages} "
                             f"pages not returned")
    return eng, dict(transcripts=[c.tokens for c in comps], launches=got,
                     stats=copy.deepcopy(st), wall_s=wall,
                     peak_bytes=peak)


# Depth of the served Mistral tree: 8 of its 32 layers keep the whole
# script well inside its time limit.
MISTRAL_LAYERS = 8


def mistral() -> dict:
    """Phase 10: LlamaConfig.mistral_7b (sliding window 4096) at full
    width in bf16, cut to MISTRAL_LAYERS layers, weights drawn on the
    card. Eight greedy
    requests of 700-12000 tokens in two waves (the second wave's four
    share the 3072-token prefix of a first-wave request, which has
    finished by then), served with monolithic prefill and again with
    prefill_chunk=512 and the prefix cache (the rolling-buffer path);
    then windowed generate. Gates: exact B1 / B4 / B5 launch counts,
    every transcript inside the teacher-forced band of a plain windowed
    forward, live pages within the O(window) bound (the chunked run's at
    every step, the monolithic run's from each sequence's first tail
    flush on), every page back, prefix_cached_tokens > 0 and prefill
    tokens lower by exactly that much."""
    from flash_attention_tpu_torch.models.llama import LlamaConfig, init_params
    from flash_attention_tpu_torch.runtime.engine import Request

    cfg = LlamaConfig.mistral_7b(n_layers=MISTRAL_LAYERS,
                                 dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in [params["embed"], params["lm_head"]]
                   + [w for layer in params["layers"]
                      for w in layer.values()])
    log(f"mistral: mistral_7b ({cfg.n_layers} layers, dim {cfg.dim}, "
        f"{cfg.n_heads}q/{cfg.n_kv_heads}kv x {cfg.head_dim}, ffn "
        f"{cfg.ffn_dim}, vocab {cfg.vocab_size}, window {cfg.window}) "
        f"{n_params / 1e9:.3f} B params bf16 from seed {SEED} in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED + 8)

    def draw(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    prefix = draw(MISTRAL_PREFIX)
    new = 32
    first, second = MISTRAL_WAVES
    waves = [[(draw(k), new) for k in first[:-1]]
             + [(prefix + draw(first[-1]), new)],
             [(prefix + draw(k), new) for k in second]]
    prompts = [p for w in waves for p, _ in w]
    log(f"mistral: prompts {[len(p) for p in prompts]} (the last four "
        f"share the fourth's {MISTRAL_PREFIX}-token prefix; "
        f"{sum(len(p) > cfg.window for p in prompts)} deeper than the "
        f"window, {sum(len(p) < cfg.window < len(p) + new for p in prompts)}"
        f" crossing it while decoding)")
    n = cfg.n_layers
    base_kw = MISTRAL_ENGINE
    mono_peaks, chunk_peaks = [], []
    eng_m, mono = serve_stack(
        "mistral[monolithic]", params, cfg, waves, base_kw,
        lambda st: dict(flash=n * len(prompts), flash_win=n * len(prompts),
                        paged=n * st.decode_steps,
                        paged_win=n * st.decode_steps),
        poll=live_page_poll(mono_peaks, from_first_flush=True))
    eng_c, chunked = serve_stack(
        f"mistral[chunked {MISTRAL_CHUNK} + prefix cache]", params, cfg,
        waves, dict(base_kw, prefill_chunk=MISTRAL_CHUNK, prefix_cache=True),
        lambda st: dict(flash=2 * n * st.prefill_chunks,
                        flash_win=2 * n * st.prefill_chunks,
                        flash_seg=n * st.prefill_chunks,
                        paged=n * st.decode_steps,
                        paged_win=n * st.decode_steps),
        poll=live_page_poll(chunk_peaks))
    profile_chunked_prefill(eng_c, prompts[0], Request)
    gc.collect()
    torch.cuda.empty_cache()
    prof = profile_decode(eng_c, prompts, Request,
                          "mistral[chunked] decode steps", new=48)
    chunked["b4_ms_per_step"] = b4_ms(prof)
    del eng_c
    gc.collect()
    torch.cuda.empty_cache()
    quant_peaks = []
    eng_q, chunked_q = serve_stack(
        f"mistral[int8 KV, chunked {MISTRAL_CHUNK} + prefix cache]", params,
        cfg, waves, dict(base_kw, prefill_chunk=MISTRAL_CHUNK,
                         prefix_cache=True, kv_quant_dtype=torch.int8),
        lambda st: dict(flash=2 * n * st.prefill_chunks,
                        flash_win=2 * n * st.prefill_chunks,
                        flash_seg=n * st.prefill_chunks,
                        paged=n * st.decode_steps,
                        paged_win=n * st.decode_steps,
                        paged_quant=n * st.decode_steps),
        poll=live_page_poll(quant_peaks))
    chunked_q["kv_bytes"] = kv_bytes(eng_q.cache)
    log(f"mistral[int8 KV]: KV pages {chunked_q['kv_bytes']['codes']} bytes "
        f"of codes + {chunked_q['kv_bytes']['scales']} bytes of scales, "
        f"against {chunked_q['kv_bytes']['bf16']} bytes in bf16")
    sq = chunked_q["stats"]
    bound = eng_m.cache.pages_for(cfg.window + eng_m.cache.page_size
                                  + eng_m.cache.tail_size)
    if max(quant_peaks) > bound or not (
            sq.prefix_cached_tokens > 0 and sq.prefill_tokens
            == sum(len(p_) for p_ in prompts) - sq.prefix_cached_tokens):
        raise AssertionError("mistral[int8 KV]: live pages or prefix-cache "
                             "accounting off")
    log(f"mistral[int8 KV]: live pages max {max(quant_peaks)} (bound "
        f"{bound}); prefix cache {sq.prefix_cached_tokens} tokens; decode "
        f"{sq.decode_tokens_per_s:.1f} tok/s; ttft "
        f"{sq.ttft_percentiles()}")
    attn_w = windowed_plain_attn(cfg.window)
    chunked_q["band"] = teacher_forced(
        params, cfg, prompts, chunked_q["transcripts"], "mistral[int8 KV]",
        attn=attn_w, kv_dtype=torch.int8)
    gc.collect()
    torch.cuda.empty_cache()
    prof = profile_decode(eng_q, prompts, Request,
                          "mistral[int8 KV] decode steps", new=48)
    chunked_q["b4_ms_per_step"] = b4_ms(prof)
    del eng_q
    gc.collect()
    torch.cuda.empty_cache()
    sm, sc = mono["stats"], chunked["stats"]
    log(f"mistral: live pages per windowed sequence (bound {bound} = "
        f"pages_for(window + page + tail)): chunked max {max(chunk_peaks)} "
        f"over {len(chunk_peaks)} polls, every step; monolithic max "
        f"{max(mono_peaks)} over {len(mono_peaks)} polls, from each "
        f"sequence's first flush on (the install pages in the whole prompt); "
        f"prefix cache {sc.prefix_cached_tokens} tokens, prefill tokens "
        f"{sm.prefill_tokens} -> {sc.prefill_tokens}")
    if max(chunk_peaks) > bound or max(mono_peaks) > bound:
        raise AssertionError("mistral: a windowed sequence held more than "
                             "O(window) pages")
    if not (sc.prefix_cached_tokens > 0 and sc.prefill_tokens
            == sm.prefill_tokens - sc.prefix_cached_tokens):
        raise AssertionError("mistral: prefix-cache accounting is off")
    same = sum(a == b for a, b in zip(mono["transcripts"],
                                      chunked["transcripts"]))
    log(f"mistral: {same} of {len(prompts)} chunked transcripts equal the "
        f"monolithic run's (reported, not gated: the LSE merges of chunked "
        f"prefill round differently in bf16); ttft monolithic "
        f"{sm.ttft_percentiles()}, chunked {sc.ttft_percentiles()} "
        f"(indicative); decode tok/s {sm.decode_tokens_per_s:.1f} / "
        f"{sc.decode_tokens_per_s:.1f}")
    pairs = {}
    for run in (mono, chunked):
        for p, t in zip(prompts, run["transcripts"]):
            pairs.setdefault((tuple(p), tuple(t)), (p, t))
    attn = attn_w
    teacher_forced(params, cfg, [p for p, _ in pairs.values()],
                   [t for _, t in pairs.values()], "mistral", attn=attn)
    gc.collect()
    torch.cuda.empty_cache()
    prof = profile_decode(eng_m, prompts, Request, "mistral decode steps")
    mono["b4_ms_per_step"] = b4_ms(prof)
    log(f"mistral: B4 device ms per decode step (profiled, chunked + "
        f"prefix cache, the same requests and new=48) bf16 KV "
        f"{chunked['b4_ms_per_step']}, int8 KV "
        f"{chunked_q['b4_ms_per_step']}; monolithic bf16 KV (new=10) "
        f"{mono['b4_ms_per_step']}")
    del eng_m
    gc.collect()
    torch.cuda.empty_cache()
    gen = generate_windowed(params, cfg, attn)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(monolithic=mono, chunked=chunked, chunked_int8=chunked_q,
                equal=same, generate=gen, chunk_peak_pages=max(chunk_peaks),
                mono_peak_pages=max(mono_peaks))


def profile_chunked_prefill(eng, prompt, request_cls) -> None:
    """Where a chunk dispatch's time goes: torch.profiler over 4
    prefill-only engine steps of one long prompt on an otherwise idle
    engine (each step is one chunk dispatch), after the first."""
    from torch.profiler import ProfilerActivity, profile

    eng.submit(request_cls(prompt=prompt, max_new_tokens=2))
    eng.step()
    torch.cuda.synchronize()
    steps = 4
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()
    report_profile(prof, wall, steps,
                   f"chunk dispatches of {eng.prefill_chunk} (one "
                   f"{len(prompt)}-token prompt)")


def generate_windowed(params, cfg, attn) -> dict:
    """sampling.generate on the Mistral tree: 4 prompts of 5000 tokens,
    32 new tokens: one windowed B1 per layer for the prefill, B5's window
    branch once per layer per decode step; the teacher-forced band."""
    from flash_attention_tpu_torch.models.sampling import generate

    rng = np.random.default_rng(SEED + 9)
    prompts = rng.integers(0, cfg.vocab_size, (4, GENERATE_WINDOWED_PROMPT))
    new = 32
    reset_counts()
    t0 = time.perf_counter()
    out = generate(params, torch.from_numpy(prompts).cuda(), cfg,
                   max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    want = dict(got, **NO_BRANCHES)
    want.update(decode=cfg.n_layers * (new - 1),
                decode_win=cfg.n_layers * (new - 1), flash=cfg.n_layers,
                flash_win=cfg.n_layers, paged=0, quant=0, int4=0, dense=0,
                grouped=0)
    log(f"generate[windowed]: 4 x {prompts.shape[1]}-token prompts, {new} "
        f"new tokens in "
        f"{wall:.3f} s ({4 * new / wall:.1f} tok/s including prefill); "
        f"launches {got} (want {want})")
    if got != want or out.shape != (4, new):
        raise AssertionError("generate[windowed]: kernel launch counts off "
                             "the path")
    teacher_forced(params, cfg, prompts.tolist(), out.tolist(),
                   "generate[windowed]", attn=attn)
    return dict(launches=got, wall_s=wall)


# --- phase 6: train ----------------------------------------------------------


class _PlainFlash(torch.autograd.Function):
    """Causal attention, under the model's window if it has one, through
    the plain forward and backward versions (flash_attention_fwd_plain /
    flash_attention_bwd_plain, by kv group) on any device: the reference
    the kernel path is held to."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        from flash_attention_tpu_torch.ops import flash

        ctx.kw = dict(causal=True, scale=1.0 / math.sqrt(q.shape[-1]),
                      offset=0, window=window)
        o, lse = by_kv_group(flash.flash_attention_fwd_plain, q, k, v,
                             **ctx.kw)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        from flash_attention_tpu_torch.ops import flash

        q, k, v, o, lse = ctx.saved_tensors
        return by_kv_group(flash.flash_attention_bwd_plain, q, k, v, o, lse,
                           do, **ctx.kw) + (None,)


def plain_attn_for(cfg):
    """attn_impl(q, k, v) for loss_fn: _PlainFlash under cfg's window."""
    return lambda q, k, v: _PlainFlash.apply(q, k, v, cfg.window)


def _loss_and_grad_norm(params, tokens, cfg, attn_impl):
    from flash_attention_tpu_torch.models.llama import loss_fn, param_leaves

    leaves = param_leaves(params)
    loss = loss_fn(params, tokens, cfg, remat=True, attn_impl=attn_impl)
    grads = torch.autograd.grad(loss, leaves)
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    return float(loss.detach()), float(norm)


def compare_train_paths(params, cfg, tokens) -> None:
    """One loss and gradient at batch 1 x T through the kernels (B1,
    B2, B3), through the plain versions in bf16, and through the plain
    versions on an fp32 copy of the same weights. The kernel path's loss
    and gradient-norm errors against fp32 must stay within 3x the bf16
    plain path's (floored at one bf16 ulp), the rule the kernels are
    held to one by one."""
    import dataclasses

    from flash_attention_tpu_torch.models.llama import param_leaves

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    lk, gk = _loss_and_grad_norm(params, tokens, cfg, None)
    lp, gp = _loss_and_grad_norm(params, tokens, cfg, plain_attn_for(cfg))
    params32 = fp32_copy(params)
    for leaf in param_leaves(params32):
        leaf.requires_grad_(True)
    l32, g32 = _loss_and_grad_norm(params32, tokens, cfg32,
                                   plain_attn_for(cfg))
    del params32
    ulp = torch.finfo(torch.bfloat16).eps
    loss_tol = 3 * max(abs(lp - l32), ulp * abs(l32))
    norm_tol = 3 * max(abs(gp / g32 - 1), ulp)
    log(f"train: kernel vs plain at batch 1 x {tokens.shape[1] - 1}: "
        f"loss kernel={lk:.6f} plain_bf16={lp:.6f} fp32={l32:.6f}; "
        f"|kernel - fp32|={abs(lk - l32):.3e} tolerance={loss_tol:.3e} "
        f"(3 x max(|plain_bf16 - fp32|, bf16 ulp x loss)); grad norm "
        f"kernel={gk:.6f} plain_bf16={gp:.6f} fp32={g32:.6f}; "
        f"|kernel/fp32 - 1|={abs(gk / g32 - 1):.3e} "
        f"tolerance={norm_tol:.3e} (3 x max(|plain_bf16/fp32 - 1|, "
        f"bf16 ulp))")
    if not (math.isfinite(lk) and math.isfinite(gk)
            and abs(lk - l32) <= loss_tol
            and abs(gk / g32 - 1) <= norm_tol):
        raise AssertionError("the kernel training path left the bf16 band")


def state_fingerprint(tr) -> list:
    """Two exact integer sums per tensor of a Trainer's parameters and
    optimizer state (the bits as integers, plain and position-weighted):
    equal fingerprints mean equal state, without a second copy of it on
    the card or the host."""
    from flash_attention_tpu_torch.models.llama import param_leaves

    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for t in (param_leaves(tr.params)
              + param_leaves(tr.optimizer.state_dict()["state"])):
        t = t.detach().reshape(-1)
        if t.is_floating_point():
            t = t.view(ints[t.element_size()])
        x = t.long()
        w = torch.arange(x.numel(), device=x.device) % 65521 + 1
        out.append((int(x.sum()), int((x * w).sum())))
    return out


def train(what, cfg, batch, seq, steps, compare_layers=None) -> dict:
    """Train `cfg` at full width (bf16, remat, AdamW lr 1e-4 with
    weight_decay 1e-4 passed explicitly) on a seeded token shard read
    through BatchLoader at batch x seq: `steps` steps on one repeated
    batch with exactly 2 B1 launches per layer (remat recomputes the
    forward), 1 B2 and 1 B3 a step, all of them on the window branch
    under cfg.window and none on it otherwise; finite and falling loss;
    a checkpoint at the last step resumed exactly into a fresh Trainer
    (another init seed) after the first is freed (state fingerprints
    equal, the next step's loss bit-equal); one profiled step; the
    kernel path against the plain path at batch 1 over the first
    `compare_layers` layers (all when None). Returns the launch counts
    of the `steps` steps."""
    import dataclasses
    import functools
    import pathlib
    import tempfile

    from flash_attention_tpu_torch.models.llama import param_leaves
    from flash_attention_tpu_torch.models.trainer import (
        Trainer, TrainerConfig,
    )
    from flash_attention_tpu_torch.utils.data import (
        BatchLoader, TokenShardDataset, write_token_shard,
    )

    opt = functools.partial(torch.optim.AdamW, lr=1e-4, weight_decay=1e-4)
    rng = np.random.default_rng(SEED + 2)
    n, win = cfg.n_layers, cfg.window is not None
    want_step = dict(flash=2 * n, bwd_dq=n, bwd_dkv=n, flash_win=2 * n * win,
                     bwd_dq_win=n * win, bwd_dkv_win=n * win)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "data").mkdir()
        write_token_shard(tmp / "data" / "000.tok", rng.integers(
            0, cfg.vocab_size, 2 * batch * (seq + 1)))
        ds = TokenShardDataset(tmp / "data", seq_len=seq + 1)
        loader = BatchLoader(ds, batch=batch, seed=SEED)
        first, second = next(loader), next(loader)
        loader.close()

        tc = TrainerConfig(ckpt_dir=str(tmp / "ckpt"), ckpt_every=10 ** 9,
                           remat=True)
        t0 = time.perf_counter()
        tr = Trainer(cfg, opt, trainer_cfg=tc, seed=SEED)
        torch.cuda.synchronize()
        log(f"{what}: Trainer ({n} layers, bf16 params, remat, AdamW lr "
            f"1e-4 weight_decay 1e-4, window {cfg.window}) built in "
            f"{time.perf_counter() - t0:.2f} s; batch {batch} x seq {seq} "
            f"from a seeded token shard via BatchLoader")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, times, per_step = [], [], []
        for _ in range(steps):
            before = read_counts()
            t0 = time.perf_counter()
            loss = tr.train_step(first)
            losses.append(float(loss))          # syncs
            times.append(time.perf_counter() - t0)
            after = read_counts()
            per_step.append({k: after[k] - before[k] for k in after})
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        step_s = statistics.median(times[1:])
        want = dict(per_step[0], **NO_BRANCHES,
                    **{k: 0 for k in ("paged", "decode", "quant", "int4",
                                      "dense", "grouped")})
        want.update(want_step)
        log(f"{what}: losses {[round(x, 4) for x in losses]}")
        log(f"{what}: {steps} steps, first {times[0] * 1e3:.1f} ms, median "
            f"of the rest {step_s * 1e3:.1f} ms/step = "
            f"{batch * seq / step_s:.0f} tokens/s; peak "
            f"max_memory_allocated {peak / 2**30:.2f} GiB")
        nonzero = [{k: v for k, v in p.items() if v} for p in per_step]
        log(f"{what}: launches per step {nonzero}; want {want_step}")
        if any(p != want for p in per_step):
            raise AssertionError(f"{what}: kernel launch counts off the "
                                 f"train step")
        if not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"{what}: training loss is not finite and "
                                 f"falling")

        t0 = time.perf_counter()
        tr.save()
        save_s = time.perf_counter() - t0
        saved = state_fingerprint(tr)
        la = float(tr.train_step(second))
        # The step after that also reads the restored optimizer state
        # and the first resumed update (shown, not gated).
        la2 = float(tr.train_step(first))
        profile_train_step(tr, second)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed = Trainer(cfg, opt, trainer_cfg=tc, seed=SEED + 1)
        load_s = time.perf_counter() - t0
        if resumed.step_num != steps:
            raise AssertionError(f"resumed at step {resumed.step_num}")
        same_state = state_fingerprint(resumed) == saved
        lb = float(resumed.train_step(second))
        lb2 = float(resumed.train_step(first))
        log(f"{what}: checkpoint at step {steps} (saved in {save_s:.1f} s, "
            f"restored in {load_s:.1f} s) resumed into a fresh Trainer "
            f"(other init seed): parameters and optimizer state identical "
            f"{same_state}; step {steps + 1} loss {la:.6f} vs {lb:.6f}; "
            f"step {steps + 2} loss {la2:.6f} vs {lb2:.6f}")
        if not same_state or la != lb:
            raise AssertionError(f"{what}: resume is not exact")
    params = resumed.params
    del resumed                     # the optimizer state
    for leaf in param_leaves(params):
        leaf.grad = None
    if compare_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=compare_layers)
        params = dict(params, layers=params["layers"][:compare_layers])
    gc.collect()
    torch.cuda.empty_cache()
    one = torch.as_tensor(first[:1], device="cuda")
    compare_train_paths(params, cfg, one)
    return launches


def profile_train_step(tr, tokens) -> None:
    """Where a train step's time goes: torch.profiler over one step,
    device time by kernel and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        tr.train_step(tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, 1, "train step")


def check_variants(rng) -> None:
    """The other instantiations the wrappers accept (fp16, head dim 64,
    up to 16 query rows per kv head, causal offsets, ragged lengths),
    held to the same gates at small shapes. Untimed."""
    from flash_attention_tpu_torch.ops import flash, paged
    from flash_attention_tpu_torch.utils.metrics import (
        max_abs_error, verify_low_precision,
    )

    # (dtype, hq, hkv, nq, nk, d, causal)
    for dt, hq, hkv, nq, nk, d, causal in (
            (torch.float16, 4, 2, 77, 131, 64, True),
            (torch.float16, 4, 4, 65, 65, 128, False),
            (torch.bfloat16, 8, 2, 100, 300, 128, True),
            (torch.bfloat16, 2, 1, 1, 40, 64, True)):
        q = randn(rng, (2, hq, nq, d), dt)
        k = randn(rng, (2, hkv, nk, d), dt)
        v = randn(rng, (2, hkv, nk, d), dt)
        sc, off = 1.0 / math.sqrt(d), nk - nq
        o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
        o_lo, _ = flash.flash_attention_fwd_plain(
            q, k, v, causal=causal, scale=sc, offset=off)
        o_hi, lse_hi = flash.flash_attention_fwd_plain(
            q.float(), k.float(), v.float(), causal=causal, scale=sc,
            offset=off)
        ok, kerr, berr = verify_low_precision(o, o_hi, o_lo)
        lse_err = max_abs_error(lse, lse_hi)
        log(f"check B1 variant {dt} q({hq},{nq},{d}) kv({hkv},{nk}) "
            f"causal={causal}: kernel_err={kerr:.3e} "
            f"plain_err={berr:.3e} lse_err={lse_err:.3e}")
        if not (ok and lse_err <= 1e-3):
            raise AssertionError("B1 variant failed its gate")

    ps = 64
    for dt, hq, hkv, d in ((torch.float16, 12, 2, 64),
                           (torch.bfloat16, 32, 2, 128),
                           (torch.float16, 4, 4, 128)):
        lengths = np.array([0, 1, 63, 64, 65, 300], np.int32)
        need = [-(-int(n) // ps) for n in lengths]
        num_pages = 1 + sum(need)
        perm = rng.permutation(np.arange(1, num_pages))
        table = np.zeros((len(lengths), 64), np.int32)
        at = 0
        for i, n in enumerate(need):
            table[i, :n] = perm[at:at + n]
            at += n
        kp = randn(rng, (hkv, num_pages, ps, d), dt)
        vp = randn(rng, (hkv, num_pages, ps, d), dt)
        q = randn(rng, (len(lengths), hq, d), dt)
        tbl = torch.from_numpy(table).cuda()
        lens = torch.from_numpy(lengths).cuda()
        sc = 1.0 / math.sqrt(d)
        o, lse = paged.paged_flash_decode(q, kp, vp, tbl, lens,
                                          return_lse=True)
        o_lo, _ = paged.paged_flash_decode_plain(q, kp, vp, tbl, lens,
                                                 scale=sc)
        o_hi, lse_hi = paged.paged_flash_decode_plain(
            q.float(), kp.float(), vp.float(), tbl, lens, scale=sc)
        ok, kerr, berr = verify_low_precision(o, o_hi, o_lo)
        lse_err = max_abs_error(lse, lse_hi)
        log(f"check B4 variant {dt} rows={hq // hkv} d={d} page {ps} "
            f"lens={lengths.tolist()}: kernel_err={kerr:.3e} "
            f"plain_err={berr:.3e} lse_err={lse_err:.3e}")
        if not (ok and lse_err <= 1e-3 and bool((o[0] == 0).all())):
            raise AssertionError("B4 variant failed its gate")
    torch.cuda.synchronize()

    # B2/B3: (dtype, b, hq, hkv, nq, nk, d, causal, offset); each also
    # checks that a rerun gives identical bits.
    for dt, b, hq, hkv, nq, nk, d, causal, offset in (
            (torch.float16, 2, 4, 2, 256, 256, 128, True, None),
            (torch.bfloat16, 2, 4, 2, 200, 200, 64, True, None),
            (torch.bfloat16, 1, 4, 4, 300, 300, 128, False, None),
            (torch.bfloat16, 1, 8, 2, 1000, 1000, 128, True, None),
            (torch.bfloat16, 1, 4, 2, 100, 333, 128, True, None),
            (torch.float16, 1, 4, 4, 77, 131, 64, False, None),
            (torch.bfloat16, 1, 2, 1, 130, 130, 128, True, -70)):
        _, got, hi, lo = _bwd_case(rng, dt, b, hq, hkv, nq, nk, d, causal,
                                   offset)
        off = nk - nq if offset is None else offset
        _bwd_gate(f"B2/B3 variant {dt} q({hq},{nq},{d}) kv({hkv},{nk}) "
                  f"causal={causal} offset={off}", got, hi, lo)
        if offset is not None and offset < 0:
            # Rows 0..-offset-1 see no key: zero dq, nothing in dk/dv.
            if not bool((got[0][:, :, :-offset] == 0).all()):
                raise AssertionError("B2 gave a dead row a gradient")
    # Edges of the Hopper bodies: a window over Nq < Nk (offset Nk - Nq)
    # at GQA 4/1 in fp16 (B3 streams four q heads per kv block), and
    # ragged lengths that are multiples of neither 64 nor 32 at D = 256
    # (B3's two column passes).
    for dt, hq, hkv, nq, nk, d, mask in (
            (torch.float16, 4, 1, 200, 333, 128, dict(window=150)),
            (torch.bfloat16, 4, 2, 77, 131, 256, {})):
        _, got, hi, lo = _bwd_case(rng, dt, 1, hq, hkv, nq, nk, d, True,
                                   **mask)
        _bwd_gate(f"B2/B3 variant {dt} q({hq},{nq},{d}) kv({hkv},{nk}) "
                  f"causal=True offset={nk - nq} {mask or 'no window'}",
                  got, hi, lo)
    torch.cuda.synchronize()


# Std of the stored codes of each weight kind as init_quantized_params
# draws them (uniform int8, N(0, (qmax/4)^2) fp8).
CODE_STD = {torch.int8: 127.0 / math.sqrt(3.0),
            torch.float8_e4m3fn: 448.0 / 4,
            torch.float8_e5m2: 57344.0 / 4}


def rand_weight(kind, k, f, gen):
    """A random [k, f] weight on the card in `kind` storage (int8, the
    fp8 formats, "int4" packed or "dense" bf16), drawn as
    init_quantized_params draws them with per-channel scales spread
    around 1/sqrt(k) / code std. Returns (the product's weight args, the
    dense bf16 weight they stand for: the library yardstick's)."""
    from flash_attention_tpu_torch.ops import quant_matmul as qm

    def spread(*shape):
        return 0.5 + torch.rand(shape, generator=gen, device="cuda")

    if kind == "dense":
        w = (torch.randn((k, f), generator=gen, device="cuda")
             / math.sqrt(k)).to(torch.bfloat16)
        return (w,), w
    if kind == "int4":
        packed = torch.randint(0, 256, (k // 2, f), generator=gen,
                               device="cuda", dtype=torch.uint8)
        packed = packed.view(torch.int8)
        scales = spread(k // qm.INT4_GROUP, f) / (4.64 * math.sqrt(k))
        return (packed, scales), qm.int4_dequant(packed, scales,
                                                 torch.bfloat16)
    if kind == torch.int8:
        q = torch.randint(-127, 128, (k, f), generator=gen, device="cuda",
                          dtype=torch.int8)
    else:
        qmax = 4 * CODE_STD[kind]
        q = (torch.randn((k, f), generator=gen, device="cuda")
             * CODE_STD[kind]).clamp_(-qmax, qmax).to(kind)
    scale = spread(f) / (CODE_STD[kind] * math.sqrt(k))
    return (q, scale), (q.float() * scale).to(torch.bfloat16)


def _matmul_fns(kind):
    """(kernel wrapper, plain version, cost) of the product for a weight
    kind."""
    from flash_attention_tpu_torch.ops import quant_matmul as qm

    if kind == "int4":
        return qm.int4_matmul, qm.int4_matmul_plain, qm.int4_matmul_cost
    if kind == "dense":
        return qm.dense_matmul, qm.dense_matmul_plain, qm.dense_matmul_cost
    return qm.quant_matmul, qm.quant_matmul_plain, qm.quant_matmul_cost


# Where B6-B8 live: the Hopper bodies' header and their instantiations,
# and the entry with the first body (fp32, operands TMA cannot address).
MATMUL_SOURCES = dict(
    source="flash_attention_tpu_torch/csrc/matmul_sm90.cuh",
    sources=["flash_attention_tpu_torch/csrc/matmul_sm90_bf16.cu",
             "flash_attention_tpu_torch/csrc/matmul_sm90_f16.cu",
             "flash_attention_tpu_torch/csrc/matmul_decode_bf16.cu",
             "flash_attention_tpu_torch/csrc/matmul_decode_f16.cu",
             "flash_attention_tpu_torch/csrc/quant_matmul.cu (entry; first "
             "body over matmul_core.cuh)"])
MATMUL_KINDS = {"B6 int8": torch.int8, "B6 e4m3": torch.float8_e4m3fn,
                "B6 e5m2": torch.float8_e5m2, "B7 int4": "int4",
                "B8 dense": "dense"}
# The timed B6-B8 shapes: the 8B decode step's w_gate / w_up, w_down, wq /
# wo and wk / wv at 16 rows, then w_gate and w_down at 1024 prefill rows.
MATMUL_TIMED = [(16, 4096, 14336), (16, 14336, 4096), (16, 4096, 4096),
                (16, 4096, 1024), (1024, 4096, 14336), (1024, 14336, 4096)]


def first_body_count():
    """The first-body launch counter (fp16 / bf16 B6-B9 launches whose
    operands TMA cannot address), or None in a package without it."""
    from flash_attention_tpu_torch.ops import quant_matmul as qm

    return getattr(qm, "matmul_first_body_launches", None)


def expected_body(m, dtype, aligned, grouped=False):
    """The body a launch should take (quant_matmul.matmul_body), or None
    in a package without the routing rule."""
    from flash_attention_tpu_torch.ops import quant_matmul as qm

    route = getattr(qm, "matmul_body", None)
    return None if route is None else route(m, dtype, aligned=aligned,
                                            grouped=grouped)


def check_first_body(what, before, body):
    """The first-body counter rose by one exactly when `body` is the
    first body (skipped in a package without the counter)."""
    after = first_body_count()
    if after is None or body is None:
        return
    if after - before != (body == "first"):
        raise AssertionError(f"{what}: first-body launches {after - before} "
                             f"for body {body}")


def host_us_per_call(fn, calls=1000) -> float:
    """The wrapper's host time a call: `calls` calls without a sync,
    time.perf_counter (the queue drains afterwards)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def check_quant_matmul(rng, flush, results):
    """B6 (int8, e4m3, e5m2), B7 and B8 against their plain versions
    under the low-precision gate at the 8B decode step's shapes (M = 16:
    w_gate / w_up 4096 x 14336, w_down 14336 x 4096, wq / wo 4096 x
    4096, wk / wv 4096 x 1024) and prefill shapes (M = 1024 of w_gate and
    w_down), 64 and 65 rows (one each side of the decode threshold), a
    ragged shape (the first body: no TMA row stride) and fp16 on both
    Hopper bodies; each decode-body case again with identical bits. The
    8B shapes are timed beside their bound, their plain time and
    torch.matmul on the dense bf16 weight of the same shape (the product
    the quantized weight replaces; for B8 the same function), and the
    wrapper's host time a call at 16 x 4096 x 14336 int4. Inputs come
    from the check's own seeded generator (rng is unused)."""
    from flash_attention_tpu_torch.utils.metrics import (
        max_abs_error, verify_low_precision,
    )

    del rng
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    for label, kind in MATMUL_KINDS.items():
        fn, plain, cost = _matmul_fns(kind)
        ragged = (3, 384, 257) if kind == "int4" else (3, 130, 257)
        cases = [(m, k, f, torch.bfloat16) for m, k, f in MATMUL_TIMED] + [
            (64, 1024, 512, torch.bfloat16), (65, 1024, 512, torch.bfloat16),
            (*ragged, torch.bfloat16), (16, 512, 384, torch.float16),
            (200, 512, 384, torch.float16)]
        rows = []
        for m, k, f, dt in cases:
            args, wdense = rand_weight(kind, k, f, gen)
            if kind == "dense":
                args = (args[0].to(dt),)
            x = (torch.randn((m, k), generator=gen, device="cuda")).to(dt)
            aligned = (m, k, f) != ragged
            body = expected_body(m, dt, aligned)
            before = first_body_count()
            got = fn(x, *args)
            torch.cuda.synchronize()
            check_first_body(f"{label} {m}x{k}x{f}", before, body)
            lo = plain(x, *args)
            hi = plain(x.float(), *((args[0].float(),) if kind == "dense"
                                    else args))
            ok, kerr, berr = verify_low_precision(got, hi, lo)
            finite = bool(torch.isfinite(got.float()).all())
            same = True
            if m <= 64:
                same = torch.equal(fn(x, *args), got)
            log(f"check {label} {m}x{k}x{f} {dt} ({body} body): kernel_err="
                f"{kerr:.3e} plain_err={berr:.3e} finite={finite}"
                + (f" rerun_identical={same}" if m <= 64 else ""))
            if not (ok and finite and same):
                raise AssertionError(f"{label} failed its gate at "
                                     f"{m}x{k}x{f} {dt}")
            if (m, k, f) not in MATMUL_TIMED:
                continue
            wd = wdense.to(dt)
            ms = time_ms(lambda: fn(x, *args), flush)
            dev_ms = device_ms(lambda: fn(x, *args), flush)
            plain_ms = time_ms(lambda: plain(x, *args), flush)
            lib_ms = time_ms(lambda: torch.matmul(x, wd), flush)
            flops, nbytes = cost(m, k, f)
            bms, by = bound_ms(flops, nbytes)
            log(f"time  {label} {m}x{k}x{f}: kernel_ms={ms:.4f} (device "
                f"alone {dev_ms:.4f}) plain_ms="
                f"{plain_ms:.4f} library_ms={lib_ms:.4f} (torch.matmul, "
                f"dense bf16 weight) bound_ms={bms:.4f} ({by}) achieved="
                f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s "
                f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
            rows.append(dict(shape=f"x({m},{k}) w({k},{f})", body=body,
                             max_abs_err=max_abs_error(got, lo), ms=ms,
                             device_ms=dev_ms, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by, library_ms=lib_ms))
            if kind == "int4" and (m, k, f) == (16, 4096, 14336):
                us = host_us_per_call(lambda: fn(x, *args))
                log(f"host  {label} {m}x{k}x{f}: {us:.2f} us a call (1000 "
                    f"calls, no sync)")
                results["host B7 int4"] = dict(
                    shape=f"x({m},{k}) w({k},{f})", host_us=us,
                    ms=us * 1e-3)
            del args, wdense, wd
        results[label] = rows


# B9 storages: the dense bf16 stack and the quantized ones.
GROUPED_KINDS = {"B9 dense": "dense", "B9 int8": torch.int8,
                 "B9 e4m3": torch.float8_e4m3fn,
                 "B9 e5m2": torch.float8_e5m2, "B9 int4": "int4"}
N_EXPERTS = 8


def rand_stack(kind, e, k, f, gen):
    """A random [e, k, f] expert stack on the card in `kind` storage, one
    rand_weight per expert. Returns the product's weight args."""
    per = [rand_weight(kind, k, f, gen)[0] for _ in range(e)]
    return tuple(torch.stack(parts) for parts in zip(*per))


def skewed_sizes(rng, m, e):
    """Group sizes summing to m, skewed (Dirichlet 0.5 shares) with
    expert 3 empty, as int32 on the card."""
    p = rng.dirichlet(np.full(e, 0.5))
    p[3] = 0.0
    sizes = rng.multinomial(m, p / p.sum())
    return torch.tensor(sizes, dtype=torch.int32, device="cuda")


def _grouped_fns(kind):
    """(kernel wrapper, plain version, cost storage) of B9 for a kind."""
    from flash_attention_tpu_torch.ops import grouped as gm

    if kind == "int4":
        return gm.grouped_int4_matmul, gm.grouped_int4_matmul_plain, "int4"
    if kind == "dense":
        return gm.grouped_matmul, gm.grouped_matmul_plain, "dense"
    return (gm.grouped_quant_matmul, gm.grouped_quant_matmul_plain,
            "int8" if kind == torch.int8 else "fp8")


def library_grouped(x, sizes, w, flush):
    """torch._grouped_mm on the dense stack w (bf16, or fp32 for the fp32
    rows) with the same int32 offsets: the library yardstick, timed only
    (never called by the port). Returns (ms or None, what was timed or
    why not)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch._grouped_mm is absent from this torch"
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    try:
        fn(x, w, offs=offs)
        torch.cuda.synchronize()
    except RuntimeError as exc:
        return None, f"torch._grouped_mm refused: {str(exc)[:200]}"
    kind = {torch.bfloat16: "bf16", torch.float32: "fp32"}.get(w.dtype,
                                                               w.dtype)
    return (time_ms(lambda: fn(x, w, offs=offs), flush),
            f"torch._grouped_mm, dense {kind} stack")


# B9's straddle case: 600 rows over 8 experts whose boundaries (100, 130,
# 330, 407, 557, 577) fall inside 128-row tiles, expert 3 empty and
# expert 6 (rows 557-576) inside one tile.
STRADDLE_SIZES = [100, 30, 200, 0, 77, 150, 20, 23]


def check_grouped(rng, flush, results):
    """B9 on every storage (dense bf16, int8, e4m3, e5m2, int4) against
    its plain version under the low-precision gate, at Mixtral's w_gate
    (K 4096, F 14336) and w_down (K 14336, F 4096) with M = 16 (a forced
    decode step: batch 8 x top-2) and M = 8192 (a 4096-token prefill
    bucket x top-2) expert-sorted rows over 8 experts, group sizes
    skewed from the seed with one empty expert; plus a ragged shape (the
    first body), a band with base > 0 and rows past the data (which must
    come back exactly zero), experts that straddle the 128-row tiles in
    bf16 and fp16 (STRADDLE_SIZES), and fp16. The Mixtral shapes are
    timed beside their bound, the plain version and torch._grouped_mm on
    the dense bf16 stack of the same shape. Inputs come from the check's
    own seeded generators (rng is unused)."""
    from flash_attention_tpu_torch.ops.grouped import grouped_cost
    from flash_attention_tpu_torch.utils.metrics import (
        max_abs_error, verify_low_precision,
    )

    del rng
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    rng = np.random.default_rng(SEED + 8)
    e = N_EXPERTS
    timed = [(16, 4096, 14336), (16, 14336, 4096), (8192, 4096, 14336),
             (8192, 14336, 4096)]
    library = {}
    for label, kind in GROUPED_KINDS.items():
        fn, plain, storage = _grouped_fns(kind)
        ragged = (100, 384, 257) if kind == "int4" else (100, 130, 257)
        cases = [(m, k, f, torch.bfloat16, 0, m, None) for m, k, f in timed]
        cases += [(*ragged, torch.bfloat16, 0, 100, None),
                  (200, 256, 192, torch.bfloat16, 37, 120, None),
                  (64, 512, 384, torch.float16, 0, 64, None),
                  (600, 512, 384, torch.bfloat16, 0, 600, STRADDLE_SIZES),
                  (600, 512, 384, torch.float16, 0, 600, STRADDLE_SIZES)]
        rows = []
        for m, k, f, dt, base, live, fixed in cases:
            args = rand_stack(kind, e, k, f, gen)
            if kind == "dense":
                args = (args[0].to(dt),)
            x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
            sizes = (skewed_sizes(rng, live, e) if fixed is None else
                     torch.tensor(fixed, dtype=torch.int32, device="cuda"))
            body = expected_body(m, dt, (m, k, f) != ragged, grouped=True)
            before = first_body_count()
            got = fn(x, sizes, *args, base=base)
            torch.cuda.synchronize()
            check_first_body(f"{label} {m}x{k}x{f}", before, body)
            lo = plain(x, sizes, *args, base=base)
            hi = plain(x.float(), sizes,
                       *((args[0].float(),) if kind == "dense" else args),
                       base=base)
            ok, kerr, berr = verify_low_precision(got, hi, lo)
            finite = bool(torch.isfinite(got.float()).all())
            dead = bool((got[:base] == 0).all()) and bool(
                (got[base + live:] == 0).all())
            log(f"check {label} {m}x{k}x{f} {dt} ({body} body) sizes "
                f"{sizes.tolist()} base {base}: kernel_err={kerr:.3e} "
                f"plain_err={berr:.3e} finite={finite} "
                f"rows_outside_zero={dead}")
            if not (ok and finite and dead):
                raise AssertionError(f"{label} failed its gate at "
                                     f"{m}x{k}x{f} {dt} base {base}")
            if (m, k, f) not in timed:
                continue
            ms = time_ms(lambda: fn(x, sizes, *args), flush)
            dev_ms = device_ms(lambda: fn(x, sizes, *args), flush)
            plain_ms = time_ms(lambda: plain(x, sizes, *args), flush)
            if kind == "dense":
                library[(m, k, f)] = library_grouped(x, sizes, args[0],
                                                     flush)
            lib_ms, lib_what = library[(m, k, f)]
            flops, nbytes = grouped_cost(m, k, f, int((sizes > 0).sum()),
                                         storage)
            bms, by = bound_ms(flops, nbytes)
            log(f"time  {label} {m}x{k}x{f}: kernel_ms={ms:.4f} (device "
                f"alone {dev_ms:.4f}) plain_ms="
                f"{plain_ms:.4f} library_ms={lib_ms} ({lib_what}) "
                f"bound_ms={bms:.4f} ({by}) achieved="
                f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s "
                f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
            rows.append(dict(shape=f"x({m},{k}) w({e},{k},{f})",
                             sizes=sizes.tolist(), body=body,
                             max_abs_err=max_abs_error(got, lo), ms=ms,
                             device_ms=dev_ms, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by,
                             library_ms=lib_ms, library=lib_what))
            del args, x, got, lo, hi
        results[label] = rows
        torch.cuda.empty_cache()


def decode_first_body_counts():
    """(B4, B5) fp16 / bf16 launches on the first body, each None in a
    package without the counter (a parent timed by kernel_pairs.py)."""
    from flash_attention_tpu_torch.ops import decode, paged

    return (getattr(paged, "paged_decode_first_body_launches", None),
            getattr(decode, "decode_first_body_launches", None))


def decode_splits(b, hkv, rows, tokens, d=128):
    """The split body's blocks per (sequence, kv head, row group) for
    this shape (decode.split_plan), or None in a package without it."""
    from flash_attention_tpu_torch.ops import decode

    plan = getattr(decode, "split_plan", None)
    if plan is None:
        return None
    return plan(b * hkv * -(-rows // decode.SPLIT_ROWS), tokens, d)


def same_bits(what, fn, first) -> None:
    """fn() again gives identical bits (the split body merges its
    partials in a fixed order; no atomics into O or the LSE)."""
    again = fn()
    first = first if isinstance(first, tuple) else (first,)
    again = again if isinstance(again, tuple) else (again,)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    log(f"check {what}: identical bits on a rerun: {same}")
    if not same:
        raise AssertionError(f"{what}: a rerun changed the bits")


def host_row(what, fn, flush, row) -> None:
    """Adds the kernel's device time alone (device_ms) and the wrapper's
    host time a call (host_us_per_call) to a timed row."""
    row["device_ms"] = device_ms(fn, flush)
    row["host_us"] = host_us_per_call(fn)
    log(f"time  {what}: device_ms={row['device_ms']:.4f} host_us="
        f"{row['host_us']:.1f} a call")


def check_decode(rng, flush, results):
    """B5 at the generate phase's last step (4 sequences of 543 live
    positions in a 640-position cache, 32 q / 8 kv heads of 128, bf16),
    plus a ragged bf16 case with length-0 and length-S rows and an fp16
    D = 64 case; the generate shape is timed beside its bound, its plain
    time and SDPA (enable_gqa) with a length mask."""
    from flash_attention_tpu_torch.ops import decode as dec
    from flash_attention_tpu_torch.utils.metrics import (
        max_abs_error, verify_low_precision,
    )

    for dt, b, hq, hkv, s, d, lens in (
            (torch.bfloat16, 4, 32, 8, 640, 128, [543] * 4),
            (torch.bfloat16, 4, 32, 8, 640, 128, [0, 640, 1, 300]),
            (torch.float16, 3, 8, 2, 384, 64, [384, 0, 257])):
        q = randn(rng, (b, hq, d), dt)
        k = randn(rng, (b, hkv, s, d), dt)
        v = randn(rng, (b, hkv, s, d), dt)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        sc = 1.0 / math.sqrt(d)
        o = dec.flash_decode(q, k, v, lengths)
        torch.cuda.synchronize()
        lo = dec.flash_decode_plain(q, k, v, lengths, scale=sc)
        hi = dec.flash_decode_plain(q.float(), k.float(), v.float(),
                                    lengths, scale=sc)
        ok, kerr, berr = verify_low_precision(o, hi, lo)
        dead = [i for i, n in enumerate(lens) if n == 0]
        dead_ok = all(bool((o[i] == 0).all()) for i in dead)
        log(f"check B5 decode {dt} q({b},{hq},{d}) cache({b},{hkv},{s},{d}) "
            f"lens={lens}: kernel_err={kerr:.3e} plain_err={berr:.3e} "
            f"dead_rows_zero={dead_ok} splits="
            f"{decode_splits(b, hkv, hq // hkv, s, d)}")
        if not (ok and dead_ok and bool(torch.isfinite(o.float()).all())):
            raise AssertionError("B5 decode failed its gate")
        same_bits(f"B5 decode {dt} lens={lens}",
                  lambda: dec.flash_decode(q, k, v, lengths), o)
        if lens != [543] * 4:
            continue
        mask = (torch.arange(s, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        q4 = q[:, :, None]
        ms = time_ms(lambda: dec.flash_decode(q, k, v, lengths), flush)
        plain_ms = time_ms(
            lambda: dec.flash_decode_plain(q, k, v, lengths, scale=sc),
            flush)
        lib_ms = time_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(
                             q4, k, v, attn_mask=mask, enable_gqa=True),
                         flush)
        flops, nbytes = dec.decode_cost(lens, hq, hkv, d, 2)
        bms, by = bound_ms(flops, nbytes)
        log(f"time  B5 decode: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} (SDPA enable_gqa, length mask) "
            f"bound_ms={bms:.4f} ({by}) achieved="
            f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
        results["decode"] = dict(
            max_abs_err=max_abs_error(o, lo), ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=lib_ms,
            shape=f"q({b},{hq},{d}) cache({b},{hkv},{s},{d}) lens {lens} "
                  f"bf16")
        host_row("B5 decode", lambda: dec.flash_decode(q, k, v, lengths),
                 flush, results["decode"])


# --- phase 2/3: the window and segment-id branches (B1, B4, B5) -------------

MISTRAL_WINDOW = 4096
# Mistral's rolling prefill buffer at page 256, chunk 512 (engine.py
# _wbuf: the window rounded to pages, one page of eviction slack, one
# chunk of padding shift).
ROLL_BUFFER = 4096 + 256 + 512


def _lse_gate(lse, lse_hi, scale):
    """(max LSE error over rows that see something, dead rows' LSE all
    INIT_M * scale): dead rows are those of the fp32 reference."""
    from flash_attention_tpu_torch.ops.flash import INIT_M

    dead = lse_hi <= INIT_M * scale / 2
    err = float((lse - lse_hi).abs()[~dead].max()) if bool((~dead).any()) \
        else 0.0
    dead_ok = bool(torch.isfinite(lse).all()) and bool(torch.allclose(
        lse[dead], torch.full_like(lse[dead], INIT_M * scale), rtol=1e-6))
    return err, dead, dead_ok


def _b1_branch(rng, flush, results, key, what, nq, nk, mask_kw, lib_mask,
               timed=True, hq=32, hkv=8, d=128, dt=torch.bfloat16):
    """One B1 branch check: kernel vs its bf16 (or `dt`) plain version vs
    the fp32 plain version (3x gate, LSE within 1e-3 on live rows, dead
    rows O = 0 and LSE = INIT_M * scale), then times beside the bound,
    the plain version and SDPA with the same boolean mask (is_causal
    where lib_mask is None; timed only)."""
    from flash_attention_tpu_torch.ops import flash
    from flash_attention_tpu_torch.utils.metrics import (
        max_abs_error, verify_low_precision,
    )

    scale = 1.0 / math.sqrt(d)
    q = randn(rng, (1, hq, nq, d), dt)
    k = randn(rng, (1, hkv, nk, d), dt)
    v = randn(rng, (1, hkv, nk, d), dt)
    kw = dict(scale=scale, **mask_kw)
    kw.setdefault("offset", nk - nq)
    o, lse = flash.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    o_lo, _ = flash.flash_attention_fwd_plain(q, k, v, **kw)
    o_hi, lse_hi = flash.flash_attention_fwd_plain(q.float(), k.float(),
                                                   v.float(), **kw)
    torch.cuda.synchronize()
    ok, kerr, berr = verify_low_precision(o, o_hi, o_lo)
    lse_err, dead, dead_ok = _lse_gate(lse, lse_hi, scale)
    dead_ok = dead_ok and bool((o[dead[..., None].expand_as(o)] == 0).all())
    log(f"check B1 {what}: kernel_err={kerr:.3e} plain_err={berr:.3e} "
        f"lse_err={lse_err:.3e} dead_rows={int(dead.sum())} "
        f"dead_rows_ok={dead_ok}")
    if not (ok and dead_ok and lse_err <= 1e-3
            and bool(torch.isfinite(o.float()).all())):
        raise AssertionError(f"B1 {what} failed its gate")
    err_vs_plain = max_abs_error(o, o_lo)
    del o_lo, o_hi, lse_hi
    torch.cuda.empty_cache()
    if not timed:
        return
    mask = None if lib_mask is None else lib_mask.to("cuda")
    ms = time_ms(lambda: flash.flash_attention_fwd(q, k, v, **kw), flush)
    plain_ms = time_ms(lambda: flash.flash_attention_fwd_plain(q, k, v, **kw),
                       flush, iters=5, warmup=1)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=mask is None, enable_gqa=True),
        flush)
    flops, nbytes = flash.fwd_cost(
        1, hq, hkv, nq, nk, d, kw.get("causal", False), 2,
        offset=kw["offset"], window=kw.get("window"),
        segment_ids=kw.get("segment_ids"))
    bms, by = bound_ms(flops, nbytes)
    log(f"time  B1 {what}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} (SDPA, "
        f"{'is_causal' if mask is None else 'boolean attn_mask'}) bound_ms="
        f"{bms:.4f} ({by}) achieved={flops / (ms * 1e-3) / 1e12:.1f} "
        f"TFLOP/s over visible pairs")
    results[key] = dict(
        max_abs_err=err_vs_plain, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms,
        shape=f"q(1,{hq},{nq},{d}) kv(1,{hkv},{nk},{d}) {what} bf16")
    torch.cuda.empty_cache()


def check_flash_branches(rng, flush, results):
    """B1's segment-id and window branches at Mistral's serving shapes:
    the chunked-prefill prefix attention (q 512 rows against an
    8192-row buffer, columns >= prefix_len hidden by segment ids, at
    prefix_len 0 / 3000 / 8192), the rolling-buffer attention (causal,
    offset = W_b, window 4096, segment ids hiding the unfilled front, at
    prefix 0 / 2000 / 12000) and windowed self-attention at T = 8192."""
    from flash_attention_tpu_torch.ops.flash import SegmentIds

    hq, nq = 32, 512
    zeros = torch.zeros((1, nq), dtype=torch.int32, device="cuda")
    for prefix in (0, 3000, 8192):
        nk = 8192
        kv = (torch.arange(nk, device="cuda")[None] >= prefix).to(torch.int32)
        mask = (kv == 0)[:, None, None, :].expand(1, 1, nq, nk)
        _b1_branch(rng, flush, results, ("flash_seg", prefix),
                   f"chunk prefix (segment ids, prefix_len {prefix})", nq, nk,
                   dict(causal=False, segment_ids=SegmentIds(zeros, kv)),
                   mask)
    w_b, win = ROLL_BUFFER, MISTRAL_WINDOW
    row = torch.arange(nq, device="cuda")[:, None]
    col = torch.arange(w_b, device="cuda")[None, :]
    band = (col <= row + w_b) & (col > row + w_b - win)
    for prefix in (0, 2000, 12000):
        kv = (torch.arange(w_b, device="cuda")[None]
              < w_b - prefix).to(torch.int32)
        mask = (band & (kv == 0))[None, None]
        _b1_branch(rng, flush, results, ("flash_roll", prefix),
                   f"roll buffer (offset {w_b}, window {win}, prefix "
                   f"{prefix})", nq, w_b,
                   dict(causal=True, offset=w_b, window=win,
                        segment_ids=SegmentIds(zeros, kv)), mask)
    t = 8192
    row = torch.arange(t, device="cuda")[:, None]
    col = torch.arange(t, device="cuda")[None, :]
    mask = ((col <= row) & (col > row - win))[None, None]
    _b1_branch(rng, flush, results, "flash_window",
               f"windowed self-attention T={t} window {win}", t, t,
               dict(causal=True, window=win), mask)


def check_paged_window(rng, flush, results):
    """B4 with per-sequence window starts (some negative, one past a
    short row's length) at batch 8, Mistral's 32 q / 8 kv heads, pages of
    256, with 1 and 4 folded query positions."""
    from flash_attention_tpu_torch.ops import paged
    from flash_attention_tpu_torch.utils.metrics import (
        max_abs_error, verify_low_precision,
    )

    b, hkv, d, ps = 8, 8, 128, 256
    lengths = np.array([4400, 4300, 300, 4110, 1, 2000, 4600, 3000],
                       np.int32)
    starts = np.array([300, 220, -3780, 30, 5, -2080, 520, -1080], np.int32)
    need = [-(-int(n) // ps) for n in lengths]
    width = 24
    num_pages = 1 + sum(need) + 3
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((b, width), np.int32)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[at:at + n]
        at += n
    kp = randn(rng, (hkv, num_pages, ps, d), torch.bfloat16)
    vp = randn(rng, (hkv, num_pages, ps, d), torch.bfloat16)
    tbl, lens, st = (torch.from_numpy(x).cuda()
                     for x in (table, lengths, starts))
    scale = 1.0 / math.sqrt(d)
    for spread in (1, 4):
        hq = 32 * spread
        q = randn(rng, (b, hq, d), torch.bfloat16)
        kw = dict(window_starts=st, qpos_spread=spread, return_lse=True)
        o, lse = paged.paged_flash_decode(q, kp, vp, tbl, lens, **kw)
        torch.cuda.synchronize()
        pkw = dict(scale=scale, starts=st, qpos_spread=spread)
        o_lo, _ = paged.paged_flash_decode_plain(q, kp, vp, tbl, lens, **pkw)
        o_hi, lse_hi = paged.paged_flash_decode_plain(
            q.float(), kp.float(), vp.float(), tbl, lens, **pkw)
        torch.cuda.synchronize()
        ok, kerr, berr = verify_low_precision(o, o_hi, o_lo)
        lse_err, dead, dead_ok = _lse_gate(lse, lse_hi, scale)
        dead_ok = dead_ok and bool((o[dead] == 0).all())
        log(f"check B4 paged_decode window starts {starts.tolist()} "
            f"qpos_spread={spread}: kernel_err={kerr:.3e} bf16_plain_err="
            f"{berr:.3e} lse_err={lse_err:.3e} dead_rows={int(dead.sum())} "
            f"dead_rows_ok={dead_ok}")
        if not (ok and dead_ok and lse_err <= 1e-3):
            raise AssertionError("B4 windowed paged_decode failed its gate")
        same_bits(f"B4 paged_decode window starts qpos_spread={spread}",
                  lambda: paged.paged_flash_decode(q, kp, vp, tbl, lens,
                                                   **kw), (o, lse))
        ms = time_ms(lambda: paged.paged_flash_decode(q, kp, vp, tbl, lens,
                                                      **kw), flush)
        plain_ms = time_ms(lambda: paged.paged_flash_decode_plain(
            q, kp, vp, tbl, lens, **pkw), flush)
        flops, nbytes = paged.paged_decode_cost(
            lengths, hq, hkv, d, 2, ps, starts=starts, qpos_spread=spread)
        bms, by = bound_ms(flops, nbytes)
        log(f"time  B4 paged_decode window starts qpos_spread={spread}: "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=null "
            f"bound_ms={bms:.4f} ({by}) achieved="
            f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
        results[("paged_win", spread)] = dict(
            max_abs_err=max_abs_error(o, o_lo), ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=None,
            shape=f"q({b},{hq},{d}) pools({hkv},{num_pages},{ps},{d}) lens "
                  f"{lengths.tolist()} starts {starts.tolist()} bf16")
        host_row(f"B4 paged_decode window starts qpos_spread={spread}",
                 lambda: paged.paged_flash_decode(q, kp, vp, tbl, lens, **kw),
                 flush, results[("paged_win", spread)])
    check_paged_serving(rng, flush, results)


def check_decode_window(rng, flush, results):
    """B5's window branch at the windowed generate phase's last step (4
    sequences of 5031 live positions in a 5120-position cache, window
    4096, 32 q / 8 kv heads of 128, bf16), timed beside its bound, its
    plain version and SDPA with the window mask."""
    from flash_attention_tpu_torch.ops import decode as dec
    from flash_attention_tpu_torch.utils.metrics import (
        max_abs_error, verify_low_precision,
    )

    b, hq, hkv, s, d, win = 4, 32, 8, 5120, 128, MISTRAL_WINDOW
    lens = [5031, 5031, 4000, 100]
    q = randn(rng, (b, hq, d), torch.bfloat16)
    k = randn(rng, (b, hkv, s, d), torch.bfloat16)
    v = randn(rng, (b, hkv, s, d), torch.bfloat16)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    sc = 1.0 / math.sqrt(d)
    o = dec.flash_decode(q, k, v, lengths, window=win)
    torch.cuda.synchronize()
    starts = lengths - win
    lo = dec.flash_decode_plain(q, k, v, lengths, scale=sc, starts=starts)
    hi = dec.flash_decode_plain(q.float(), k.float(), v.float(), lengths,
                                scale=sc, starts=starts)
    ok, kerr, berr = verify_low_precision(o, hi, lo)
    log(f"check B5 decode window {win} q({b},{hq},{d}) cache({b},{hkv},{s},"
        f"{d}) lens={lens}: kernel_err={kerr:.3e} plain_err={berr:.3e}")
    if not (ok and bool(torch.isfinite(o.float()).all())):
        raise AssertionError("B5 windowed decode failed its gate")
    same_bits(f"B5 decode window {win}",
              lambda: dec.flash_decode(q, k, v, lengths, window=win), o)
    pos = torch.arange(s, device="cuda")[None, :]
    mask = ((pos < lengths[:, None]) & (pos >= starts[:, None]))[
        :, None, None, :]
    q4 = q[:, :, None]
    ms = time_ms(lambda: dec.flash_decode(q, k, v, lengths, window=win),
                 flush)
    plain_ms = time_ms(lambda: dec.flash_decode_plain(
        q, k, v, lengths, scale=sc, starts=starts), flush)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k, v, attn_mask=mask, enable_gqa=True), flush)
    flops, nbytes = dec.decode_cost(lens, hq, hkv, d, 2, window=win)
    bms, by = bound_ms(flops, nbytes)
    log(f"time  B5 decode window {win}: kernel_ms={ms:.4f} plain_ms="
        f"{plain_ms:.4f} library_ms={lib_ms:.4f} (SDPA enable_gqa, window "
        f"mask) bound_ms={bms:.4f} ({by}) achieved="
        f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
    results["decode_win"] = dict(
        max_abs_err=max_abs_error(o, lo), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=lib_ms,
        shape=f"q({b},{hq},{d}) cache({b},{hkv},{s},{d}) lens {lens} "
              f"window {win} bf16")
    host_row(f"B5 decode window {win}",
             lambda: dec.flash_decode(q, k, v, lengths, window=win), flush,
             results["decode_win"])


# --- phase 2/3: the int8 / fp8 branches (B1, B4, B5) and the P2 bodies -----

QUANT_KINDS = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn,
               "e5m2": torch.float8_e5m2}


def spread_blocks(rng, shape, dim, std=0.25):
    """bf16 N(0, std^2) values times a random factor in [e^-3, e^3] per
    128-row block along `dim`: scales that differ by orders of magnitude
    between blocks, so a kernel that reads the wrong scale row fails its
    gate."""
    fshape = list(shape)
    fshape[dim] //= 128
    f = torch.from_numpy(np.exp(rng.uniform(-3.0, 3.0, fshape))
                         .astype(np.float32)).to("cuda")
    x = randn(rng, shape, torch.float32, std=std)
    return (x * f.repeat_interleave(128, dim=dim)).to(torch.bfloat16)


def quant_pools(pool, dtype):
    """[Hkv, P, ps, D] -> (codes, scales [Hkv, P, ps/128, D]) through the
    port's quantizer (ops/quant.py quantize_blocks)."""
    from flash_attention_tpu_torch.ops.quant import QUANT_BLOCK, quantize_blocks

    h, n, ps, d = pool.shape
    codes, sc = quantize_blocks(
        pool.float().reshape(h, n, ps // QUANT_BLOCK, QUANT_BLOCK, d), dtype, 3)
    return codes.reshape(h, n, ps, d), sc[..., 0, :].contiguous()


def paged_setup(rng, lengths, hkv, d, ps, width, spare=3):
    """A shuffled page table for `lengths` (page 0 the scratch page) and
    bf16 pools whose 128-token blocks differ in scale by orders of
    magnitude."""
    b = len(lengths)
    need = [-(-int(n) // ps) for n in lengths]
    num_pages = 1 + sum(need) + spare
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((b, width), np.int32)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[at:at + n]
        at += n
    kp = spread_blocks(rng, (hkv, num_pages, ps, d), 2)
    vp = spread_blocks(rng, (hkv, num_pages, ps, d), 2)
    return kp, vp, torch.from_numpy(table).cuda(), num_pages


# The kernel against its bf16 plain version (the same roundings: code x
# scale in fp32 rounded to bf16, probabilities rounded to bf16 before the
# PV product): each row's max error within this share of the row's max
# |O| in the fp32 reference (8 bf16 ulps at that magnitude), and each live
# row's LSE within ROW_LSE_TOL.
ROW_REL_TOL = 2.0 ** -5
ROW_LSE_TOL = 1e-3


def _quant_gate(what, o, hi, lo, lse=None, lse_hi=None, lse_lo=None,
                scale=None):
    """The gates of a quantized branch. (1) The low-precision gate
    against the fp32 reference over the dequantized K/V: kernel error <=
    3x the bf16 plain version's, the same for the LSE of rows that see
    something (+ 1e-3: the bf16 rounding of dequantized K moves scores,
    and so the LSE, in both), dead rows exact. (2) Row by row against the
    bf16 plain version, which shares the kernel's roundings: (1) alone
    is loose where blocks of large scale make the bf16 baseline's error
    large next to rows of small |O|."""
    from flash_attention_tpu_torch.utils.metrics import verify_low_precision

    ok, kerr, berr = verify_low_precision(o, hi, lo)
    row_err = (o.float() - lo.float()).abs().amax(-1)
    row_max = hi.float().abs().amax(-1)
    rel = float((row_err / row_max.clamp(min=1e-30)).max())
    ok = ok and bool((row_err <= ROW_REL_TOL * row_max + 1e-6).all())
    msg = (f"kernel_err={kerr:.3e} bf16_plain_err={berr:.3e} "
           f"worst_row_err_vs_bf16_plain/row_max={rel:.3e} "
           f"(gate {ROW_REL_TOL:.3e})")
    if lse is not None:
        lse_err, dead, dead_ok = _lse_gate(lse, lse_hi, scale)
        lse_base, _, _ = _lse_gate(lse_lo, lse_hi, scale)
        lse_row, _, _ = _lse_gate(lse, lse_lo, scale)
        dead_ok = dead_ok and bool((o[dead] == 0).all())
        ok = (ok and dead_ok and lse_err <= 3 * lse_base + 1e-3
              and lse_row <= ROW_LSE_TOL)
        msg += (f" lse_err={lse_err:.3e} bf16_plain_lse_err={lse_base:.3e} "
                f"lse_vs_bf16_plain={lse_row:.3e} dead_rows="
                f"{int(dead.sum())} dead_rows_ok={dead_ok}")
    ok = ok and bool(torch.isfinite(o.float()).all())
    log(f"check {what}: {msg}")
    if not ok:
        raise AssertionError(f"{what} failed its gate")


def check_paged_quant(rng, flush, results):
    """B4 over int8 / e4m3 / e5m2 pools at the 8B decode shape (B = 16,
    32 q / 8 kv heads of 128, pages of 256, lengths 256-1132), its
    fold_scales body on int8, and its window starts at Mistral's shape
    (qpos_spread 1 and 4) over quantized pools; each held to the fp32
    reference over the dequantized pools, timed beside its bound and
    plain version (no single PyTorch call attends over a page table)."""
    from flash_attention_tpu_torch.ops import paged

    from flash_attention_tpu_torch.utils.metrics import verify_low_precision

    b, hq, hkv, d, ps = 16, 32, 8, 128, 256
    scale = 1.0 / math.sqrt(d)
    lengths = np.linspace(256, 1132, b).astype(np.int32)
    kp, vp, tbl, num_pages = paged_setup(rng, lengths, hkv, d, ps, 8)
    lens = torch.from_numpy(lengths).cuda()
    q = randn(rng, (b, hq, d), torch.bfloat16)
    # Dense bf16 pools at the same shape, beside the quantized rows.
    what = f"B4 paged_decode bf16 pools B={b} lens " \
        f"{int(lengths.min())}-{int(lengths.max())}"

    def dense():
        return paged.paged_flash_decode(q, kp, vp, tbl, lens,
                                        return_lse=True)

    o, lse = dense()
    o_lo, _ = paged.paged_flash_decode_plain(q, kp, vp, tbl, lens,
                                             scale=scale)
    o_hi, lse_hi = paged.paged_flash_decode_plain(
        q.float(), kp.float(), vp.float(), tbl, lens, scale=scale)
    ok, kerr, berr = verify_low_precision(o, o_hi, o_lo)
    lse_err, _, dead_ok = _lse_gate(lse, lse_hi, scale)
    log(f"check {what}: kernel_err={kerr:.3e} bf16_plain_err={berr:.3e} "
        f"lse_err={lse_err:.3e} splits={decode_splits(b, hkv, 4, 8 * ps)}")
    if not (ok and dead_ok and lse_err <= 1e-3):
        raise AssertionError(f"{what} failed its gate")
    same_bits(what, dense, (o, lse))
    ms = time_ms(dense, flush)
    plain_ms = time_ms(lambda: paged.paged_flash_decode_plain(
        q, kp, vp, tbl, lens, scale=scale), flush)
    flops, nbytes = paged.paged_decode_cost(lengths, hq, hkv, d, 2, ps)
    bms, by = bound_ms(flops, nbytes)
    log(f"time  {what}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms=null bound_ms={bms:.4f} ({by})")
    results[("paged_q", "bf16", "default")] = dict(
        max_abs_err=max_abs(o, o_lo), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"q({b},{hq},{d}) pools({hkv},{num_pages},{ps},{d}) bf16 "
              f"lens {int(lengths.min())}-{int(lengths.max())}")
    host_row(what, dense, flush, results[("paged_q", "bf16", "default")])
    for kind, dt in QUANT_KINDS.items():
        kc, ks = quant_pools(kp, dt)
        vc, vs = quant_pools(vp, dt)
        sc = dict(k_scales=ks, v_scales=vs)
        bodies = [("default", False)] + ([("fold", True)]
                                         if kind == "int8" else [])
        o_hi, lse_hi = paged.paged_flash_decode_plain(
            q.float(), kc, vc, tbl, lens, scale=scale, **sc)
        for body, fold in bodies:
            kw = dict(sc, fold_scales=fold)
            o, lse = paged.paged_flash_decode(q, kc, vc, tbl, lens,
                                              return_lse=True, **kw)
            torch.cuda.synchronize()
            o_lo, lse_lo = paged.paged_flash_decode_plain(
                q, kc, vc, tbl, lens, scale=scale, **kw)
            what = f"B4 paged_decode {kind} {body} B={b} lens " \
                f"{int(lengths.min())}-{int(lengths.max())}"
            _quant_gate(what, o, o_hi, o_lo, lse, lse_hi, lse_lo, scale)
            same_bits(what, lambda: paged.paged_flash_decode(
                q, kc, vc, tbl, lens, return_lse=True, **kw), (o, lse))
            ms = time_ms(lambda: paged.paged_flash_decode(
                q, kc, vc, tbl, lens, return_lse=True, **kw), flush)
            plain_ms = time_ms(lambda: paged.paged_flash_decode_plain(
                q, kc, vc, tbl, lens, scale=scale, **kw), flush)
            flops, nbytes = paged.paged_decode_cost(lengths, hq, hkv, d, 2,
                                                    ps, kv_itemsize=1)
            bms, by = bound_ms(flops, nbytes)
            log(f"time  {what}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms=null bound_ms={bms:.4f} ({by}) achieved="
                f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
            results[("paged_q", kind, body)] = dict(
                max_abs_err=max_abs(o, o_lo), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None,
                shape=f"q({b},{hq},{d}) pools({hkv},{num_pages},{ps},{d}) "
                      f"{kind} lens {int(lengths.min())}-"
                      f"{int(lengths.max())} bf16 q")
            host_row(what, lambda: paged.paged_flash_decode(
                q, kc, vc, tbl, lens, return_lse=True, **kw), flush,
                results[("paged_q", kind, body)])

    # Window starts over quantized pools at Mistral's shape.
    b = 8
    lengths = np.array([4400, 4300, 300, 4110, 1, 2000, 4600, 3000],
                       np.int32)
    starts = np.array([300, 220, -3780, 30, 5, -2080, 520, -1080], np.int32)
    kp, vp, tbl, num_pages = paged_setup(rng, lengths, hkv, d, ps, 24)
    lens, st = (torch.from_numpy(x).cuda() for x in (lengths, starts))
    for kind, dt in QUANT_KINDS.items():
        kc, ks = quant_pools(kp, dt)
        vc, vs = quant_pools(vp, dt)
        for spread in (1, 4):
            hq = 32 * spread
            q = randn(rng, (b, hq, d), torch.bfloat16)
            kw = dict(k_scales=ks, v_scales=vs)
            pkw = dict(kw, scale=scale, starts=st, qpos_spread=spread)
            o, lse = paged.paged_flash_decode(
                q, kc, vc, tbl, lens, window_starts=st, qpos_spread=spread,
                return_lse=True, **kw)
            torch.cuda.synchronize()
            o_lo, lse_lo = paged.paged_flash_decode_plain(
                q, kc, vc, tbl, lens, **pkw)
            o_hi, lse_hi = paged.paged_flash_decode_plain(
                q.float(), kc, vc, tbl, lens, **pkw)
            what = (f"B4 paged_decode {kind} window starts qpos_spread="
                    f"{spread}")
            _quant_gate(what, o, o_hi, o_lo, lse, lse_hi, lse_lo, scale)
            same_bits(what, lambda: paged.paged_flash_decode(
                q, kc, vc, tbl, lens, window_starts=st, qpos_spread=spread,
                return_lse=True, **kw), (o, lse))
            if kind != "int8":
                continue
            ms = time_ms(lambda: paged.paged_flash_decode(
                q, kc, vc, tbl, lens, window_starts=st, qpos_spread=spread,
                return_lse=True, **kw), flush)
            plain_ms = time_ms(lambda: paged.paged_flash_decode_plain(
                q, kc, vc, tbl, lens, **pkw), flush)
            flops, nbytes = paged.paged_decode_cost(
                lengths, hq, hkv, d, 2, ps, starts=starts,
                qpos_spread=spread, kv_itemsize=1)
            bms, by = bound_ms(flops, nbytes)
            log(f"time  {what}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms=null bound_ms={bms:.4f} ({by})")
            results[("paged_q_win", spread)] = dict(
                max_abs_err=max_abs(o, o_lo), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None,
                shape=f"q({b},{hq},{d}) pools({hkv},{num_pages},{ps},{d}) "
                      f"int8 lens {lengths.tolist()} starts "
                      f"{starts.tolist()}")
            host_row(what, lambda: paged.paged_flash_decode(
                q, kc, vc, tbl, lens, window_starts=st, qpos_spread=spread,
                return_lse=True, **kw), flush,
                results[("paged_q_win", spread)])


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def quant_cache(rng, shape, dt):
    """A bf16 cache [B, Hkv, S, D] with block scales spread apart, and
    its QuantizedTensor in storage dt."""
    from flash_attention_tpu_torch.ops.quant import quantize_kv

    return quantize_kv(spread_blocks(rng, shape, 2), dtype=dt)


def check_decode_quant(rng, flush, results):
    """B5 over int8 / e4m3 / e5m2 caches at the generate shape (4 x 543
    live positions of a 640-position cache, 32 q / 8 kv heads of 128) and
    with Mistral's window (4096 over a 5120-position cache), held to the
    fp32 reference over the dequantized caches; timed beside the bound,
    the plain version and SDPA over the dequantized bf16 caches (the
    dequantization outside the timing)."""
    from flash_attention_tpu_torch.ops import decode as dec
    from flash_attention_tpu_torch.ops.quant import dequantize_kv

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for s, lens, win in ((640, [543] * 4, None),
                         (5120, [5031, 5031, 4000, 100], MISTRAL_WINDOW)):
        b, hq, hkv, d = 4, 32, 8, 128
        sc = 1.0 / math.sqrt(d)
        q = randn(rng, (b, hq, d), torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        starts = None if win is None else lengths - win
        pos = torch.arange(s, device="cuda")[None, :]
        mask = pos < lengths[:, None]
        if win is not None:
            mask = mask & (pos >= starts[:, None])
        mask = mask[:, None, None, :]
        for kind, dt in QUANT_KINDS.items():
            kq = quant_cache(rng, (b, hkv, s, d), dt)
            vq = quant_cache(rng, (b, hkv, s, d), dt)
            o = dec.flash_decode(q, kq, vq, lengths, window=win)
            torch.cuda.synchronize()
            kb, vb = dequantize_kv(kq), dequantize_kv(vq)
            lo = dec.flash_decode_plain(q, kb, vb, lengths, scale=sc,
                                        starts=starts)
            hi = dec.flash_decode_plain(
                q.float(), dequantize_kv(kq, torch.float32),
                dequantize_kv(vq, torch.float32), lengths, scale=sc,
                starts=starts)
            what = (f"B5 decode {kind} cache({b},{hkv},{s},{d}) lens {lens}"
                    + (f" window {win}" if win else ""))
            _quant_gate(what, o, hi, lo)
            same_bits(what, lambda: dec.flash_decode(q, kq, vq, lengths,
                                                     window=win), o)
            ms = time_ms(lambda: dec.flash_decode(q, kq, vq, lengths,
                                                  window=win), flush)
            plain_ms = time_ms(lambda: dec.flash_decode_plain(
                q, dequantize_kv(kq), dequantize_kv(vq), lengths, scale=sc,
                starts=starts), flush)
            lib_ms = time_ms(lambda: sdpa(q[:, :, None], kb, vb,
                                          attn_mask=mask, enable_gqa=True),
                             flush)
            flops, nbytes = dec.decode_cost(lens, hq, hkv, d, 2, window=win,
                                            kv_itemsize=1)
            bms, by = bound_ms(flops, nbytes)
            log(f"time  {what}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms:.4f} (SDPA on the dequantized bf16 "
                f"cache) bound_ms={bms:.4f} ({by}) achieved="
                f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
            results[("decode_q", kind, win)] = dict(
                max_abs_err=max_abs(o, lo), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                shape=f"q({b},{hq},{d}) cache({b},{hkv},{s},{d}) {kind} "
                      f"lens {lens}" + (f" window {win}" if win else ""))
            host_row(what, lambda: dec.flash_decode(q, kq, vq, lengths,
                                                    window=win), flush,
                     results[("decode_q", kind, win)])
            del kq, vq, kb, vb
        torch.cuda.empty_cache()


def check_flash_quant(rng, flush, results):
    """B1 over int8 / e4m3 / e5m2 K/V, causal at (1, 32/8, 8192, 128)
    (flash_attention_quantized's long-context prefill), held to the fp32
    reference over the dequantized K/V, timed beside the bound, the
    plain version and SDPA over the dequantized bf16 K/V (dequantization
    outside the timing)."""
    from flash_attention_tpu_torch.ops import flash
    from flash_attention_tpu_torch.ops.quant import dequantize_kv

    b, hq, hkv, t, d = 1, 32, 8, 8192, 128
    scale = 1.0 / math.sqrt(d)
    q = randn(rng, (b, hq, t, d), torch.bfloat16)
    kw = dict(causal=True, scale=scale, offset=0)
    for kind, dt in QUANT_KINDS.items():
        kq = quant_cache(rng, (b, hkv, t, d), dt)
        vq = quant_cache(rng, (b, hkv, t, d), dt)
        o = flash.flash_attention_quantized(q, kq, vq, causal=True)
        o_res, lse = flash.flash_attention_fwd(q, kq, vq, causal=True)
        torch.cuda.synchronize()
        kb, vb = dequantize_kv(kq), dequantize_kv(vq)
        lo, lse_lo = flash.flash_attention_fwd_plain(q, kb, vb, **kw)
        hi, lse_hi = flash.flash_attention_fwd_plain(
            q.float(), dequantize_kv(kq, torch.float32),
            dequantize_kv(vq, torch.float32), **kw)
        torch.cuda.synchronize()
        what = f"B1 flash_fwd {kind} causal q(1,{hq},{t},{d})"
        if not torch.equal(o, o_res):
            raise AssertionError(f"{what}: flash_attention_quantized and "
                                 f"flash_attention_fwd disagree")
        _quant_gate(what, o, hi, lo, lse, lse_hi, lse_lo, scale)
        err = max_abs(o, lo)
        del lo, hi, o_res, lse, lse_lo, lse_hi
        torch.cuda.empty_cache()
        ms = time_ms(lambda: flash.flash_attention_quantized(
            q, kq, vq, causal=True), flush)
        plain_ms = time_ms(lambda: flash.flash_attention_fwd_plain(
            q, dequantize_kv(kq), dequantize_kv(vq), **kw), flush, iters=5,
            warmup=1)
        lib_ms = time_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(
                             q, kb, vb, is_causal=True, enable_gqa=True),
                         flush)
        flops, nbytes = flash.fwd_cost(b, hq, hkv, t, t, d, True, 2,
                                       kv_itemsize=1)
        bms, by = bound_ms(flops, nbytes)
        log(f"time  {what}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} (SDPA on the dequantized bf16 K/V) "
            f"bound_ms={bms:.4f} ({by}) achieved="
            f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
        results[("flash_q", kind)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=lib_ms,
            shape=f"q({b},{hq},{t},{d}) kv({b},{hkv},{t},{d}) {kind} causal")
        del kq, vq, kb, vb
        torch.cuda.empty_cache()


# --- phase 2/3: B2/B3's window and segment ids; head dims 32 / 256; rows --

# Mistral's training row: documents packed into 8192 tokens.
PACKED_DOCS = (3000, 2500, 1500, 1192)
# q rows put in a document no kv column belongs to (the dead-row case).
DEAD_ROWS = (6000, 6500)


def packed_ids(lengths=PACKED_DOCS) -> torch.Tensor:
    """[1, sum(lengths)] int32 segment ids on the card, document i = i."""
    return torch.repeat_interleave(
        torch.arange(len(lengths), dtype=torch.int32),
        torch.tensor(lengths))[None].cuda()


def _bwd_timed(what, case, flush, lib_mask, **kw):
    """Times of B2 and B3 on one case of _bwd_case (kw: its masks) beside
    their bounds, the plain backward (by kv group) and SDPA's backward
    (enable_gqa; dq, dk and dv together) with the same boolean mask, or
    is_causal where lib_mask is None. Returns {"dq": ..., "dkv": ...}
    entries for the kernels line."""
    from flash_attention_tpu_torch.ops import flash

    q, k, v, o, lse, do = case
    b, hq, nq, d = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    delta = flash._bwd_delta(o, do)
    ms_dq = time_ms(lambda: flash._bwd_dq_cuda(q, k, v, do, lse, delta,
                                               **kw), flush)
    ms_dkv = time_ms(lambda: flash._bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                 **kw), flush)
    plain_ms = time_ms(lambda: by_kv_group(
        flash.flash_attention_bwd_plain, q, k, v, o, lse, do, **kw), flush,
        iters=3, warmup=1)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vr, attn_mask=lib_mask, is_causal=lib_mask is None,
        enable_gqa=True)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        out, (qr, kr, vr), do, retain_graph=True), flush)
    del out
    (f2, b2), (f3, b3) = flash.bwd_cost(
        b, hq, hkv, nq, nk, d, kw["causal"], q.element_size(),
        offset=kw["offset"], window=kw.get("window"),
        segment_ids=kw.get("segment_ids"))
    bound2, by2 = bound_ms(f2, b2, _peak(q.dtype))
    bound3, by3 = bound_ms(f3, b3, _peak(q.dtype))
    log(f"time  B2 {what}: kernel_ms={ms_dq:.4f} bound_ms={bound2:.4f} "
        f"({by2}) achieved={f2 / (ms_dq * 1e-3) / 1e12:.1f} TFLOP/s over "
        f"visible pairs")
    log(f"time  B3 {what}: kernel_ms={ms_dkv:.4f} bound_ms={bound3:.4f} "
        f"({by3}) achieved={f3 / (ms_dkv * 1e-3) / 1e12:.1f} TFLOP/s")
    log(f"time  B2+B3 {what}: kernel_ms={ms_dq + ms_dkv:.4f} plain_ms="
        f"{plain_ms:.4f} library_ms={lib_ms:.4f} (autograd.grad through "
        f"SDPA with {'is_causal' if lib_mask is None else 'the mask'}: "
        f"dq, dk, dv together)")
    shape = (f"q({b},{hq},{nq},{d}) kv({b},{hkv},{nk},{d}) {what} "
             f"{str(q.dtype).split('.')[-1]}")
    note = ("plain_ms and library_ms compute dq, dk and dv together: "
            "compare them with B2 + B3")
    return dict(dq=dict(ms=ms_dq, plain_ms=plain_ms, bound_ms=bound2,
                        bound_by=by2, library_ms=lib_ms, shape=shape,
                        note=note),
                dkv=dict(ms=ms_dkv, plain_ms=plain_ms, bound_ms=bound3,
                         bound_by=by3, library_ms=lib_ms, shape=shape,
                         note=note))


def check_bwd_branches(rng, flush, results):
    """B2 and B3's window and segment-id branches at Mistral's training
    shape (q [1, 32, 8192, 128], kv 8 heads, causal, bf16): window 4096;
    documents of 3000 / 2500 / 1500 / 1192 tokens with window 4096; the
    same with q rows 6000-6499 in a document no kv column belongs to,
    whose dq must be exactly 0. Each: the 3x gate on dq, dk and dv
    against the plain versions (by kv group), identical bits on a
    rerun; the first two timed beside their bounds, the plain backward
    and SDPA's backward with the same boolean mask."""
    from flash_attention_tpu_torch.ops.flash import SegmentIds

    t, hq, hkv, d, win = 8192, 32, 8, 128, MISTRAL_WINDOW
    ids = packed_ids()
    dead_q = ids.clone()
    dead_q[:, DEAD_ROWS[0]:DEAD_ROWS[1]] = len(PACKED_DOCS) + 7
    row = torch.arange(t, device="cuda")[:, None]
    col = torch.arange(t, device="cuda")[None, :]
    band = (col <= row) & (col > row - win)
    same_doc = ids[0][:, None] == ids[0][None, :]
    for key, seg, mask in (
            ("window", None, band),
            ("segments", SegmentIds(ids, ids), band & same_doc),
            ("dead_rows", SegmentIds(dead_q, ids), None)):
        mkw = dict(window=win, segment_ids=seg)
        what = (f"{key} (window {win}"
                + ("" if seg is None else ", packed segment ids") + ")")
        case, got, hi, lo = _bwd_case(rng, torch.bfloat16, 1, hq, hkv, t, t,
                                      d, True, **mkw)
        errs = _bwd_gate(f"B2/B3 {what} q(1,{hq},{t},{d}) kv(1,{hkv},{t},"
                         f"{d}) causal bf16, deterministic", got, hi, lo)
        del hi, lo
        if key == "dead_rows":
            zero = bool((got[0][:, :, DEAD_ROWS[0]:DEAD_ROWS[1]] == 0).all())
            log(f"check B2 dead rows {DEAD_ROWS}: dq exactly 0 {zero}")
            if not zero:
                raise AssertionError("B2 gave a dead row a gradient")
            continue
        del got
        torch.cuda.empty_cache()
        timed = _bwd_timed(what, case, flush, mask[None, None], causal=True,
                           scale=1.0 / math.sqrt(d), offset=0, **mkw)
        timed["dq"]["max_abs_err"] = errs[0]
        timed["dkv"]["max_abs_err"] = max(errs[1:])
        results[("bwd", key)] = timed
        del case
        torch.cuda.empty_cache()


def _paged_case(rng, dt, lengths, hq, hkv, d, ps, starts=None, spread=1,
                kv_dtype=None, fold=False, width=None):
    """B4 against its plain versions on a shuffled page table (dense
    pools in dt, or int8 / fp8 codes of them when kv_dtype is given;
    `fold`: int8's fold_scales body; `width`: the table's, at least the
    longest row's pages + 1): the 3x gate on O and LSE, dead rows exact
    (quantized: _quant_gate). Returns (what, o, o_lo, args of the kernel
    call, kw)."""
    from flash_attention_tpu_torch.ops import paged
    from flash_attention_tpu_torch.utils.metrics import verify_low_precision

    lengths = np.asarray(lengths, np.int32)
    kp, vp, tbl, num_pages = paged_setup(
        rng, lengths, hkv, d, ps,
        width or -(-int(lengths.max()) // ps) + 1)
    kp, vp = kp.to(dt), vp.to(dt)
    q = randn(rng, (len(lengths), hq, d), dt)
    lens = torch.from_numpy(lengths).cuda()
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32,
                                                  device="cuda")
    kw, hi_pools = {}, (kp.float(), vp.float())
    if kv_dtype is not None:
        kc, ks = quant_pools(kp, kv_dtype)
        vc, vs = quant_pools(vp, kv_dtype)
        kp, vp, hi_pools = kc, vc, (kc, vc)
        kw = dict(k_scales=ks, v_scales=vs)
        if fold:
            kw["fold_scales"] = True
    scale = 1.0 / math.sqrt(d)
    o, lse = paged.paged_flash_decode(q, kp, vp, tbl, lens, window_starts=st,
                                      qpos_spread=spread, return_lse=True,
                                      **kw)
    torch.cuda.synchronize()
    pkw = dict(kw, scale=scale, starts=st, qpos_spread=spread)
    o_lo, lse_lo = paged.paged_flash_decode_plain(q, kp, vp, tbl, lens,
                                                  **pkw)
    o_hi, lse_hi = paged.paged_flash_decode_plain(q.float(), *hi_pools, tbl,
                                                  lens, **pkw)
    rows = hq // hkv
    what = (f"B4 {str(dt).split('.')[-1]} d={d} rows={rows} page {ps} "
            f"lens {lengths.tolist()}"
            + (f" starts {list(starts)} spread {spread}" if starts else "")
            + (f" {str(kv_dtype).split('.')[-1]} pools" if kv_dtype else "")
            + (" fold_scales" if fold else "")
            + f" table width {tbl.shape[1]} splits "
              + str(decode_splits(len(lengths), hkv, rows,
                                  tbl.shape[1] * ps, d)))
    if kv_dtype is not None:
        _quant_gate(what, o, o_hi, o_lo, lse, lse_hi, lse_lo, scale)
    else:
        ok, kerr, berr = verify_low_precision(o, o_hi, o_lo)
        lse_err, dead, dead_ok = _lse_gate(lse, lse_hi, scale)
        dead_ok = dead_ok and bool((o[dead] == 0).all())
        log(f"check {what}: kernel_err={kerr:.3e} plain_err={berr:.3e} "
            f"lse_err={lse_err:.3e} dead_rows={int(dead.sum())} "
            f"dead_rows_ok={dead_ok}")
        if not (ok and dead_ok and lse_err <= 1e-3):
            raise AssertionError(f"{what} failed its gate")
    return what, o, o_lo, (q, kp, vp, tbl, lens), dict(
        kw, window_starts=st, qpos_spread=spread, return_lse=True)


def _decode_case(rng, dt, lengths, hq, hkv, d, s, window=None,
                 kv_dtype=None):
    """B5 against its plain versions (dense caches in dt, or int8 / fp8
    QuantizedTensors): the 3x gate, length-0 rows exactly 0. Returns
    (what, o, o_lo, args of the kernel call, kw)."""
    from flash_attention_tpu_torch.ops import decode as dec
    from flash_attention_tpu_torch.ops.quant import dequantize_kv
    from flash_attention_tpu_torch.utils.metrics import verify_low_precision

    b = len(lengths)
    q = randn(rng, (b, hq, d), dt)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    starts = None if window is None else lens - window
    scale = 1.0 / math.sqrt(d)
    if kv_dtype is None:
        k = randn(rng, (b, hkv, s, d), dt)
        v = randn(rng, (b, hkv, s, d), dt)
        lo_kv, hi_kv = (k, v), (k.float(), v.float())
    else:
        k = quant_cache(rng, (b, hkv, s, d), kv_dtype)
        v = quant_cache(rng, (b, hkv, s, d), kv_dtype)
        lo_kv = (dequantize_kv(k), dequantize_kv(v))
        hi_kv = (dequantize_kv(k, torch.float32),
                 dequantize_kv(v, torch.float32))
    o = dec.flash_decode(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    lo = dec.flash_decode_plain(q, *lo_kv, lens, scale=scale, starts=starts)
    hi = dec.flash_decode_plain(q.float(), *hi_kv, lens, scale=scale,
                                starts=starts)
    what = (f"B5 {str(dt).split('.')[-1]} d={d} rows={hq // hkv} cache "
            f"{s} lens {list(lengths)}"
            + (f" window {window}" if window else "")
            + (f" {str(kv_dtype).split('.')[-1]} cache" if kv_dtype else ""))
    if kv_dtype is not None:
        _quant_gate(what, o, hi, lo)
    else:
        ok, kerr, berr = verify_low_precision(o, hi, lo)
        dead_ok = all(bool((o[i] == 0).all())
                      for i, n in enumerate(lengths) if n == 0)
        log(f"check {what}: kernel_err={kerr:.3e} plain_err={berr:.3e} "
            f"dead_rows_zero={dead_ok}")
        if not (ok and dead_ok and bool(torch.isfinite(o.float()).all())):
            raise AssertionError(f"{what} failed its gate")
    return what, o, lo, (q, k, v, lens), dict(window=window)


def check_paged_serving(rng, flush, results):
    """B4 at Mistral's serving decode step: batch 8, 32 q / 8 kv heads of
    128, pages of 256, window 4096 (window starts lengths - 4096, the
    pages wholly below them pointing at the scratch page, as after the
    engine's eviction), lengths 700-12000; on bf16 and int8 pools, each
    held to its plain versions and rerun for identical bits, timed
    beside its bound and plain version, its device time and the
    wrapper's host time a call."""
    from flash_attention_tpu_torch.ops import paged

    b, hq, hkv, d, ps = 8, 32, 8, 128, 256
    lengths = np.array([700, 1500, 3000, 4500, 6000, 8000, 10000, 12000],
                       np.int32)
    starts = lengths - MISTRAL_WINDOW
    kp, vp, tbl, num_pages = paged_setup(rng, lengths, hkv, d, ps,
                                         -(-int(lengths.max()) // ps))
    below = (np.arange(tbl.shape[1])[None, :] + 1) * ps <= starts[:, None]
    tbl[torch.from_numpy(below).cuda()] = 0
    lens, st = (torch.from_numpy(x).cuda() for x in (lengths, starts))
    q = randn(rng, (b, hq, d), torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    for kind in ("bf16", "int8"):
        if kind == "bf16":
            pools, kw = (kp, vp), {}
            hi_pools = (kp.float(), vp.float())
        else:
            kc, ks = quant_pools(kp, torch.int8)
            vc, vs = quant_pools(vp, torch.int8)
            pools, hi_pools = (kc, vc), (kc, vc)
            kw = dict(k_scales=ks, v_scales=vs)

        def kern():
            return paged.paged_flash_decode(
                q, *pools, tbl, lens, window_starts=st, return_lse=True,
                **kw)

        o, lse = kern()
        pkw = dict(kw, scale=scale, starts=st)
        o_lo, lse_lo = paged.paged_flash_decode_plain(q, *pools, tbl, lens,
                                                      **pkw)
        o_hi, lse_hi = paged.paged_flash_decode_plain(q.float(), *hi_pools,
                                                      tbl, lens, **pkw)
        what = (f"B4 paged_decode mistral serving {kind} pools lens "
                f"{lengths.tolist()} window {MISTRAL_WINDOW} splits "
                f"{decode_splits(b, hkv, hq // hkv, tbl.shape[1] * ps)}")
        _quant_gate(what, o, o_hi, o_lo, lse, lse_hi, lse_lo, scale)
        same_bits(what, kern, (o, lse))
        ms = time_ms(kern, flush)
        plain_ms = time_ms(lambda: paged.paged_flash_decode_plain(
            q, *pools, tbl, lens, **pkw), flush)
        flops, nbytes = paged.paged_decode_cost(
            lengths, hq, hkv, d, 2, ps, starts=starts,
            kv_itemsize=None if kind == "bf16" else 1)
        bms, by = bound_ms(flops, nbytes)
        log(f"time  {what}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms=null bound_ms={bms:.4f} ({by}) achieved="
            f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
        results[("paged_serving", kind)] = dict(
            max_abs_err=max_abs(o, o_lo), ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=None,
            shape=f"q({b},{hq},{d}) pools({hkv},{num_pages},{ps},{d}) "
                  f"{kind} lens {lengths.tolist()} window {MISTRAL_WINDOW}")
        host_row(what, kern, flush, results[("paged_serving", kind)])


def check_split_edges(rng):
    """The split body's edges (untimed), each held to its plain versions
    and rerun for identical bits: more splits than live slabs (B4 and
    B5), window starts that leave most splits empty (B4, also with 4
    folded positions and negative starts), head dim 256 with several
    splits (B4 windowed fp16, B4 int8 fold_scales, B5 windowed bf16);
    and a page size the split body does not walk (40: the first body,
    counted by paged_decode_first_body_launches)."""
    from flash_attention_tpu_torch.ops import decode as dec
    from flash_attention_tpu_torch.ops import paged
    from flash_attention_tpu_torch.utils.metrics import verify_low_precision

    bf, hf = torch.bfloat16, torch.float16
    for args, kw in (
            ((bf, [1, 40, 0], 32, 8, 128, 256), dict(width=8)),
            ((bf, [4400, 3000], 32, 8, 128, 256),
             dict(starts=[4380, 2990])),
            ((bf, [300, 5000, 0], 128, 8, 128, 256),
             dict(starts=[-290, 4990, 0], spread=4)),
            ((hf, [4400, 300, 0, 1500], 32, 8, 256, 256),
             dict(starts=[300, -3780, 0, 700], spread=2)),
            ((bf, [1500, 0, 700], 32, 8, 256, 256),
             dict(kv_dtype=torch.int8, fold=True))):
        what, o, _, call, ckw = _paged_case(rng, *args, **kw)
        same_bits(what, lambda: paged.paged_flash_decode(*call, **ckw),
                  (o,))
    for args, kw in (((bf, [1, 17, 0, 3], 32, 8, 128, 640), {}),
                     ((bf, [5031, 100], 32, 8, 256, 5120),
                      dict(window=MISTRAL_WINDOW))):
        what, o, _, call, ckw = _decode_case(rng, *args, **kw)
        same_bits(what, lambda: dec.flash_decode(*call, **ckw), o)
    # Pages of 40 tokens: the first body.
    b, hq, hkv, d, ps = 3, 32, 8, 128, 40
    lengths = np.array([100, 0, 37], np.int32)
    width = 3
    table = np.zeros((b, width), np.int32)
    table[0] = [1, 2, 3]
    table[2, 0] = 4
    kp = randn(rng, (hkv, 5, ps, d), bf)
    vp = randn(rng, (hkv, 5, ps, d), bf)
    q = randn(rng, (b, hq, d), bf)
    tbl, lens = (torch.from_numpy(x).cuda() for x in (table, lengths))
    scale = 1.0 / math.sqrt(d)
    before = decode_first_body_counts()[0]
    o, lse = paged.paged_flash_decode(q, kp, vp, tbl, lens, return_lse=True)
    after = decode_first_body_counts()[0]
    torch.cuda.synchronize()
    o_lo, _ = paged.paged_flash_decode_plain(q, kp, vp, tbl, lens,
                                             scale=scale)
    o_hi, lse_hi = paged.paged_flash_decode_plain(
        q.float(), kp.float(), vp.float(), tbl, lens, scale=scale)
    ok, kerr, berr = verify_low_precision(o, o_hi, o_lo)
    lse_err, dead, dead_ok = _lse_gate(lse, lse_hi, scale)
    first = None if after is None else after - before
    log(f"check B4 bf16 page {ps} lens {lengths.tolist()} (first body): "
        f"kernel_err={kerr:.3e} plain_err={berr:.3e} lse_err={lse_err:.3e} "
        f"dead_rows_ok={dead_ok} first-body launches {first}")
    if not (ok and dead_ok and lse_err <= 1e-3 and first in (None, 1)):
        raise AssertionError("B4 on the first body failed its gate")


# B4's serving shape of check_paged and B5's generate shape of
# check_decode, at the other head dims.
HEAD_DIM_PAGED_LENS = [1, 1500, 0, 600, 255, 257, 1024, 777]
HEAD_DIM_DECODE_LENS = [543] * 4


def check_head_dims(rng, flush, results):
    """Head dims 32 and 256 on B1-B5 (CUDA_HEAD_DIMS = SUPPORTED_HEAD_DIMS):
    in bf16 at one timed shape each (B1 / B2 / B3 at the 1B training
    shape's (1, 16/8, 2048) causal, B4 at check_paged's batch of 8 over
    pages of 256, B5 at the generate shape) beside the bound, the plain
    version and the library call; in fp16 at a small shape (B2 / B3 with
    a window and segment ids, B4 with window starts and folded
    positions, B5 with a window); and the int8 branches of B1 / B4 / B5
    at one small shape. Each held to its gate."""
    from flash_attention_tpu_torch.ops import decode as dec
    from flash_attention_tpu_torch.ops import flash, paged
    from flash_attention_tpu_torch.ops.flash import SegmentIds
    from flash_attention_tpu_torch.ops.quant import dequantize_kv, quantize_kv

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for d in (32, 256):
        sc = 1.0 / math.sqrt(d)
        t = 2048
        _b1_branch(rng, flush, results, ("d", d, "B1"),
                   f"head dim {d} causal T={t}", t, t, dict(causal=True),
                   None, hq=16, hkv=8, d=d)
        _b1_branch(rng, flush, results, None,
                   f"head dim {d} fp16 window 100 T=300", 300, 300,
                   dict(causal=True, window=100), None, timed=False, hq=4,
                   hkv=2, d=d, dt=torch.float16)

        case, got, hi, lo = _bwd_case(rng, torch.bfloat16, 1, 16, 8, t, t, d,
                                      True)
        errs = _bwd_gate(f"B2/B3 head dim {d} q(1,16,{t},{d}) kv(1,8,{t},"
                         f"{d}) causal bf16, deterministic", got, hi, lo)
        del got, hi, lo
        timed = _bwd_timed(f"head dim {d} causal", case, flush, None,
                           causal=True, scale=sc, offset=0)
        timed["dq"]["max_abs_err"] = errs[0]
        timed["dkv"]["max_abs_err"] = max(errs[1:])
        results[("d", d, "B2/B3")] = timed
        del case
        seg = (torch.arange(300, device="cuda")[None] >= 137).to(torch.int32)
        _, got, hi, lo = _bwd_case(rng, torch.float16, 1, 4, 2, 300, 300, d,
                                   True, window=100,
                                   segment_ids=SegmentIds(seg, seg))
        _bwd_gate(f"B2/B3 head dim {d} fp16 window 100 segment ids "
                  f"q(1,4,300,{d}) kv(1,2,300,{d}), deterministic", got, hi,
                  lo)

        what, o, lo, args, kw = _paged_case(
            rng, torch.bfloat16, HEAD_DIM_PAGED_LENS, 32, 8, d, 256)
        lens_np = np.asarray(HEAD_DIM_PAGED_LENS, np.int32)
        ms = time_ms(lambda: paged.paged_flash_decode(*args, **kw), flush)
        plain_ms = time_ms(lambda: paged.paged_flash_decode_plain(
            *args, scale=sc), flush)
        bms, by = bound_ms(*paged.paged_decode_cost(lens_np, 32, 8, d, 2,
                                                    256))
        log(f"time  {what}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms=null bound_ms={bms:.4f} ({by})")
        results[("d", d, "B4")] = dict(
            max_abs_err=max_abs(o, lo), ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=None, shape=what)
        _paged_case(rng, torch.float16, [0, 1, 63, 300], 16, 2, d, 128,
                    starts=[0, -5, 10, 200], spread=2)
        _paged_case(rng, torch.bfloat16, [0, 130, 300], 8, 2, d, 128,
                    kv_dtype=torch.int8)

        what, o, lo, args, kw = _decode_case(
            rng, torch.bfloat16, HEAD_DIM_DECODE_LENS, 32, 8, d, 640)
        q, k, v, lens = args
        mask = (torch.arange(640, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        ms = time_ms(lambda: dec.flash_decode(*args), flush)
        plain_ms = time_ms(lambda: dec.flash_decode_plain(*args, scale=sc),
                           flush)
        lib_ms = time_ms(lambda: sdpa(q[:, :, None], k, v, attn_mask=mask,
                                      enable_gqa=True), flush)
        bms, by = bound_ms(*dec.decode_cost(HEAD_DIM_DECODE_LENS, 32, 8, d,
                                            2))
        log(f"time  {what}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} (SDPA enable_gqa, length mask) "
            f"bound_ms={bms:.4f} ({by})")
        results[("d", d, "B5")] = dict(
            max_abs_err=max_abs(o, lo), ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=lib_ms, shape=what)
        _decode_case(rng, torch.float16, [384, 0, 257], 8, 2, d, 384,
                     window=100)
        _decode_case(rng, torch.bfloat16, [256, 0, 100], 8, 2, d, 256,
                     kv_dtype=torch.int8)

        # B1 over int8 K/V at this head dim.
        q = randn(rng, (1, 4, 256, d), torch.bfloat16)
        kq, vq = (quantize_kv(spread_blocks(rng, (1, 2, 256, d), 2),
                              dtype=torch.int8) for _ in range(2))
        o, lse = flash.flash_attention_fwd(q, kq, vq, causal=True)
        kw = dict(causal=True, scale=sc, offset=0)
        o_lo, lse_lo = flash.flash_attention_fwd_plain(
            q, dequantize_kv(kq), dequantize_kv(vq), **kw)
        o_hi, lse_hi = flash.flash_attention_fwd_plain(
            q.float(), dequantize_kv(kq, torch.float32),
            dequantize_kv(vq, torch.float32), **kw)
        _quant_gate(f"B1 int8 head dim {d} q(1,4,256,{d}) kv(1,2,256,{d}) "
                    f"causal", o, o_hi, o_lo, lse, lse_hi, lse_lo, sc)
        torch.cuda.empty_cache()


def check_rows(rng):
    """B4 and B5 at more than 16 query rows per kv head, where the kernel
    walks its K/V once per group of 16 rows in the one launch:
    llama3_70b's GQA group of 8 with 4 and 8 folded positions (32 and 64
    rows) on B4 with window starts, a group of 32 and of 64 on B5 with
    and without a window, and the int8 branches at 32 rows. Untimed."""
    hkv, d = 8, 128
    for spread in (4, 8):
        _paged_case(rng, torch.bfloat16, [4400, 300, 0, 1500],
                    8 * hkv * spread, hkv, d, 256,
                    starts=[300, -3780, 0, 700], spread=spread)
    _paged_case(rng, torch.float16, [700, 0, 129], 32 * hkv, hkv, 64, 128,
                starts=[100, 0, -5], spread=4)
    _paged_case(rng, torch.bfloat16, [700, 0, 129], 32 * hkv, hkv, d, 128,
                starts=[100, 0, -5], spread=4, kv_dtype=torch.int8)
    for group in (32, 64):
        _decode_case(rng, torch.bfloat16, [543, 0, 640, 1], group * 2, 2, d,
                     640)
        _decode_case(rng, torch.float16, [543, 0, 640, 1], group * 2, 2, 64,
                     640, window=200)
    _decode_case(rng, torch.bfloat16, [543, 0, 640], 64, 2, d, 640,
                 kv_dtype=torch.int8)
    torch.cuda.synchronize()


# --- phase 11: windowed training, the segmented gradient, moe_loss_fn -----

MISTRAL_TRAIN_LAYERS = 4         # for the time limit (58 GB of state at 32)


def train_1b() -> dict:
    """LlamaConfig.llama3_1b at full width and depth, batch 4 x 2048,
    8 steps (train())."""
    from flash_attention_tpu_torch.models.llama import LlamaConfig

    return train("train", LlamaConfig.llama3_1b(dtype=torch.bfloat16), 4,
                 2048, 8)


def train_mistral() -> dict:
    """LlamaConfig.mistral_7b at full width (window 4096), cut to
    MISTRAL_TRAIN_LAYERS layers, trained at batch 1 x 8192 (train(): 4
    steps, 2 B1 and 1 B2 and B3 launches a layer a step, every one on its
    window branch); the kernel
    path held to the plain path over the first 2 layers at T = 8192."""
    from flash_attention_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.mistral_7b(n_layers=MISTRAL_TRAIN_LAYERS,
                                 dtype=torch.bfloat16)
    return train("train_mistral", cfg, 1, 8192, 4, compare_layers=2)


def segmented_grad() -> dict:
    """The segment-id branches through the public API: one
    flash_attention(q, k, v, SegmentIds(...), causal=True, window=4096)
    and its gradient at Mistral's shape (q [1, 32, 8192, 128], kv 8
    heads, bf16) over packed documents, launches counted around it
    (one each of B1, B2, B3, every one with segment ids and a window);
    the gradients bit-equal to the direct B2 / B3 launch on the same
    inputs, and finite."""
    from flash_attention_tpu_torch.ops import flash

    rng = np.random.default_rng(SEED + 7)
    t, hq, hkv, d = 8192, 32, 8, 128
    ids = packed_ids()
    seg = flash.SegmentIds(ids, ids)
    kw = dict(causal=True, window=MISTRAL_WINDOW)
    q, k, v = (randn(rng, (1, h, t, d), torch.bfloat16).requires_grad_()
               for h in (hq, hkv, hkv))
    do = randn(rng, (1, hq, t, d), torch.bfloat16)
    reset_counts()
    out = flash.flash_attention(q, k, v, seg, **kw)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    counts = read_counts()
    with torch.no_grad():
        o, lse = flash.flash_attention_fwd(q, k, v, seg, **kw)
        want = flash.flash_attention_bwd(q, k, v, o, lse, do, seg, **kw)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
    one = dict(flash=1, flash_seg=1, flash_win=1, bwd_dq=1, bwd_dkv=1,
               bwd_dq_seg=1, bwd_dkv_seg=1, bwd_dq_win=1, bwd_dkv_win=1)
    wanted = dict(dict.fromkeys(counts, 0), **one)
    log(f"segmented gradient: flash_attention with packed segment ids "
        f"{list(PACKED_DOCS)} and window {MISTRAL_WINDOW}, q(1,{hq},{t},"
        f"{d}): launches { {k: v for k, v in counts.items() if v} }; "
        f"gradients equal to the direct B2 / B3 launch {same}; finite "
        f"{finite}")
    if counts != wanted or not (same and finite):
        raise AssertionError("segmented gradient: launches or gradients off")
    return counts


def moe_loss() -> dict:
    """moe_loss_fn forward and backward on the card on MoEConfig.tiny_moe
    in bf16 (capacity routing, remat): finite loss and aux metrics,
    finite gradients on every leaf, the router's among them; 2 B1
    launches per layer, 1 B2 and 1 B3 (parity is held on the CPU,
    tests/test_torch_windowed_train.py)."""
    from flash_attention_tpu_torch.models.llama import param_leaves
    from flash_attention_tpu_torch.models.moe import (
        MoEConfig, init_moe_params, moe_loss_fn,
    )

    cfg = MoEConfig.tiny_moe(dtype=torch.bfloat16)
    params = init_moe_params(cfg, seed=SEED)
    leaves = param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tokens = np.random.default_rng(SEED + 8).integers(
        0, cfg.vocab_size, (4, 129)).astype(np.int32)
    reset_counts()
    loss, metrics = moe_loss_fn(params, tokens, cfg, remat=True)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    counts = read_counts()
    n = cfg.n_layers
    wanted = dict(dict.fromkeys(counts, 0), flash=2 * n, bwd_dq=n,
                  bwd_dkv=n)
    values = {k: float(v) for k, v in dict(metrics, loss=loss).items()}
    finite = (all(math.isfinite(x) for x in values.values())
              and all(bool(torch.isfinite(g.float()).all()) for g in grads))
    router = sum(float(g.float().abs().sum()) for leaf, g in zip(leaves, grads)
                 if leaf.dtype == torch.float32 and leaf.dim() == 2
                 and leaf.shape[1] == cfg.n_experts)
    log(f"moe_loss: tiny_moe bf16 ({cfg.routing} routing, remat) on "
        f"tokens (4, 129): {values}; gradients finite {finite}, router "
        f"gradient |sum| {router:.4e}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if counts != wanted or not finite or router == 0.0:
        raise AssertionError("moe_loss: launches, values or gradients off")
    return counts


# --- phase: the kernel-study harness (B10a-c, B1 fp32, B1's split) -------

STUDY_SHAPE = (1, 32, 8192, 128)     # benchmarks/perf_1_32_8192_128
STUDY_GQA_KV = 8                     # B10b's GQA case: 32 q / 8 kv heads
STUDY_SMALL = (1, 8, 2048)           # fp16 / fp32 (and bf16) at each D
SPLIT_BANDS = (512, 2048)


def _peak(dtype) -> float:
    return PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS


def _hi(dtype):
    """The reference dtype of the low-precision gate: fp32 for fp16 /
    bf16 inputs, fp64 for fp32 ones."""
    return torch.float64 if dtype == torch.float32 else torch.float32


def _study_fns(name, causal=False):
    """(kernel fn, plain fn) of one study kernel on q, k, v: the plain
    version tiled as the kernel is (its compiled default tile)."""
    from flash_attention_tpu_torch.ops import variants

    def tile(q):
        if name == "B10a":
            return max(variants.fa1_compiled_tiles(q.dtype, q.shape[-1]),
                       key=lambda t: t[0] * t[1])
        return variants.study_tile(q.dtype, q.shape[-1])

    def kern(q, k, v, block_sizes=None):
        if name == "B10a":
            return variants.flash_attention_fa1(q, k, v,
                                                block_sizes=block_sizes)
        if name == "B10b":
            return (variants.flash_attention_fa2_inloop(
                q, k, v, causal=causal, block_sizes=block_sizes),)
        return (variants.naive_attention_pallas(q, k, v,
                                                block_sizes=block_sizes),)

    def plain(q, k, v, block_kv=None):
        sc = q.shape[-1] ** -0.5
        bkv = block_kv or tile(q)[1]
        if name == "B10a":
            return variants.flash_attention_fa1_plain(q, k, v, scale=sc,
                                                      block_kv=bkv)
        if name == "B10b":
            return (variants.flash_attention_fa2_inloop_plain(
                q, k, v, causal=causal, scale=sc, block_kv=bkv),)
        return (variants.naive_attention_plain(q, k, v, scale=sc,
                                               block_kv=bkv),)

    return kern, plain


def _study_gate(what, got, hi, lo):
    """The 3x low-precision gate on O (and, for B10a, LSE = m + log l,
    m and l each within 1e-3 of the reference's: m max-abs, l relative,
    since l sums up to Nk terms). Returns the kernel's max-abs
    difference from the plain version in the same dtype."""
    from flash_attention_tpu_torch.utils.metrics import (
        max_abs_error, verify_low_precision,
    )

    ok, kerr, berr = verify_low_precision(got[0], hi[0], lo[0])
    finite = bool(torch.isfinite(got[0].float()).all())
    line = (f"check {what}: kernel_err={kerr:.3e} plain_err={berr:.3e} "
            f"finite={finite}")
    if len(got) == 3:
        lse_err = max_abs_error(got[1] + torch.log(got[2]),
                                hi[1] + torch.log(hi[2]))
        m_err = max_abs_error(got[1], hi[1])
        l_rel = float(((got[2].double() - hi[2].double()).abs()
                       / hi[2].double()).max())
        line += (f" lse_err={lse_err:.3e} m_err={m_err:.3e} "
                 f"l_rel_err={l_rel:.3e}")
        ok = ok and lse_err <= 1e-3 and m_err <= 1e-3 and l_rel <= 1e-3
    log(line)
    if not (ok and finite):
        raise AssertionError(f"{what} failed its gate")
    return max_abs_error(got[0], lo[0])


def _study_case(rng, name, dt, b, hq, hkv, n, d, causal=False,
                block_sizes=None, nk=None):
    """Kernel, plain (same dtype) and reference (fp32, fp64 for fp32
    inputs) of one study kernel on seeded inputs, q [b, hq, n, d] and
    k, v [b, hkv, nk (default n), d]; gated."""
    kern, plain = _study_fns(name, causal)
    nk = n if nk is None else nk
    q = randn(rng, (b, hq, n, d), dt)
    k = randn(rng, (b, hkv, nk, d), dt)
    v = randn(rng, (b, hkv, nk, d), dt)
    got = kern(q, k, v, block_sizes=block_sizes)
    torch.cuda.synchronize()
    bkv = None if block_sizes is None else block_sizes.block_kv
    lo = plain(q, k, v, bkv)
    hi = plain(*(x.to(_hi(dt)) for x in (q, k, v)), bkv)
    torch.cuda.synchronize()
    tile = "" if block_sizes is None else \
        f" tile {block_sizes.block_q}x{block_sizes.block_kv}"
    err = _study_gate(
        f"{name} {str(dt).split('.')[-1]} q({b},{hq},{n},{d}) "
        f"kv({hkv}{'' if nk == n else f',{nk}'})"
        f"{' causal' if causal else ''}{tile}", got, hi, lo)
    return (q, k, v), err


def _sdpa(q, k, v, causal=False):
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=q.shape[1] != k.shape[1])


def check_study_long(rng, flush, results):
    """B10a (o, m, l) at q [1, 32, 8192, 128] bf16 and B10b non-causal
    and causal GQA 32/8 (kv [1, 8, 8192, 128]): the 3x gate against the
    fp32 reference (B10a's m and l within 1e-3), each timed beside its
    bound, plain version and SDPA."""
    h = STUDY_SHAPE[1]
    for name, hkv, causal in (("B10a", h, False),
                              ("B10b", STUDY_GQA_KV, False),
                              ("B10b", STUDY_GQA_KV, True)):
        _study_row(rng, flush, results, name, hkv, causal)
        torch.cuda.empty_cache()


def _study_row(rng, flush, results, name, hkv, causal):
    """One study kernel at STUDY_SHAPE bf16, gated and timed into
    results[(name, causal)]."""
    from flash_attention_tpu_torch.ops import variants

    b, h, n, d = STUDY_SHAPE
    (q, k, v), err = _study_case(rng, name, torch.bfloat16, b, h, hkv, n, d,
                                 causal)
    kern, plain = _study_fns(name, causal)
    flops, nbytes = variants.study_cost(
        b, h, hkv, n, n, d, causal, 2, stats=2 if name == "B10a" else 0)
    results[(name, causal)] = dict(
        max_abs_err=err,
        shape=f"q({b},{h},{n},{d}) kv({b},{hkv},{n},{d})"
              f"{' causal' if causal else ''} bf16",
        **_timed_row(f"{name} bf16 q({b},{h},{n},{d}) kv({hkv})"
                     f"{' causal' if causal else ''}",
                     lambda: kern(q, k, v), lambda: plain(q, k, v),
                     lambda: _sdpa(q, k, v, causal), flush, flops,
                     nbytes, PEAK_BF16_FLOPS, plain_iters=2))


# B10a's ragged cases across the Hopper body's 64-row tiles: (Nq, Nk).
STUDY_RAGGED = ((77, 131), (200, 333), (1, 40))


def check_study_kernels(rng, flush) -> dict:
    """B10a (o, m, l), B10b (causal and not, GQA 32/8) and B10c at q [1,
    32, 8192, 128] bf16 (B10b's GQA at kv [1, 8, 8192, 128]), timed
    (check_study_long and B10c); every compiled tile of each in bf16,
    fp16 and fp32 at (1, 8, 2048, D) for D in 32..256; B10a at ragged
    lengths (STUDY_RAGGED) and B10b causal with Nq < Nk (GQA 4/2) in
    fp16 and bf16 at D = 32 / 128 / 256, and in fp32 at every D on both
    row counts of its body; the launch counters of the 16 x 16 and fp32
    bodies exact over these cases; then check_fa1_tiles and
    check_study_fp32 (B1 fp32: check_flash_fp32). Gate: 3x the plain
    version's error in the same dtype against fp32 (fp64 for fp32
    inputs)."""
    from flash_attention_tpu_torch.config import BlockSizes
    from flash_attention_tpu_torch.ops import variants

    out = {}
    check_study_long(rng, flush, out)
    _study_row(rng, flush, out, "B10c", STUDY_SHAPE[1], False)
    torch.cuda.synchronize()

    tile16 = variants.fa1_tile16_launches
    f32_before = variants.study_f32_launches
    n16 = 0       # fp16 / bf16 16 x 16 cases below, one launch each
    n32 = 0       # fp32 cases (csrc/study_f32.cuh), one launch each
    for dt in (torch.bfloat16, torch.float16):
        for d in (32, 64, 128, 256):
            for nq, nk in STUDY_RAGGED:
                if d != 64:
                    _study_case(rng, "B10a", dt, 2, 3, 3, nq, d, nk=nk)
                # The 16 x 16 body (study_sm80.cuh) at the same edges.
                _study_case(rng, "B10a", dt, 2, 3, 3, nq, d, nk=nk,
                            block_sizes=BlockSizes(16, 16))
                n16 += 1
            if d != 64:
                _study_case(rng, "B10b", dt, 2, 4, 2, 128, d, causal=True,
                            nk=320)
    # fp32 (csrc/study_f32.cuh) at the same edges on both of its row
    # counts a block: 2 x 3 heads take blocks of 32 rows, 2 x 34 of 64
    # (up to D = 128; D = 256 has only the 32-row plan).
    for d in (32, 64, 128, 256):
        for b, h in ((2, 3), (2, 34)) if d <= 128 else ((2, 3),):
            for nq, nk in STUDY_RAGGED:
                for tile in variants.fa1_compiled_tiles(torch.float32, d):
                    _study_case(rng, "B10a", torch.float32, b, h, h, nq, d,
                                nk=nk, block_sizes=BlockSizes(*tile))
                    n32 += 1
            _study_case(rng, "B10b", torch.float32, b, 2 * h, h, 128, d,
                        causal=True, nk=320)
            n32 += 1
    torch.cuda.synchronize()

    b, h, n = STUDY_SMALL
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        for d in (32, 64, 128, 256):
            f32 = dt == torch.float32
            for tile in variants.fa1_compiled_tiles(dt, d):
                _study_case(rng, "B10a", dt, b, h, h, n, d,
                            block_sizes=BlockSizes(*tile))
                n16 += not f32 and tile == (16, 16)
                n32 += f32
            for causal in (False, True):
                _study_case(rng, "B10b", dt, b, h, 2, n, d, causal)
                n32 += f32
            _study_case(rng, "B10c", dt, b, h, h, n, d)
            n32 += f32
    torch.cuda.synchronize()
    got = variants.fa1_tile16_launches - tile16
    log(f"study: fp16 / bf16 16 x 16 launches {got} (expected {n16})")
    if got != n16:
        raise AssertionError(f"16 x 16 body launches {got}, expected {n16}")
    got = variants.study_f32_launches - f32_before
    log(f"study: fp32 body launches {got} (expected {n32})")
    if got != n32:
        raise AssertionError(f"fp32 study body launches {got}, expected "
                             f"{n32}")

    check_fa1_tiles(rng, flush, out)
    check_study_fp32(rng, flush, out)
    return out


FA1_TILE_SHAPES = ((1, 8, 2048, 128), (1, 8, 2048, 64))


def check_fa1_tiles(rng, flush, results):
    """B10a's two tiles in bf16 and fp16 at (1, 8, 2048, 128) and (1, 8,
    2048, 64): 16 x 16 on the mma.sync body (csrc/study_sm80.cuh), 64 x
    64 on the Hopper block (study_sm90.cuh), each under the study gate
    (o, m, l) and timed beside its bound, its plain version at the same
    tile and SDPA (fp32 rows: check_study_fp32). results[("B10a",
    dtype, shape, tile)]."""
    from flash_attention_tpu_torch.config import BlockSizes
    from flash_attention_tpu_torch.ops import variants

    kern, plain = _study_fns("B10a")
    cases = [(dt, shape, tile)
             for dt in (torch.bfloat16, torch.float16)
             for shape in FA1_TILE_SHAPES for tile in ((16, 16), (64, 64))]
    for dt, (b, h, n, d), (bq, bk) in cases:
        (q, k, v), err = _study_case(rng, "B10a", dt, b, h, h, n, d,
                                     block_sizes=BlockSizes(bq, bk))
        flops, nbytes = variants.study_cost(b, h, h, n, n, d, False,
                                            dt.itemsize, stats=2)
        name = str(dt).split(".")[-1]
        results[("B10a", name, f"({b},{h},{n},{d})", f"{bq}x{bk}")] = dict(
            max_abs_err=err, shape=f"q({b},{h},{n},{d}) {name} tile "
                                   f"{bq}x{bk}",
            **_timed_row(f"B10a {name} q({b},{h},{n},{d}) tile {bq}x{bk}",
                         lambda: kern(q, k, v,
                                      block_sizes=BlockSizes(bq, bk)),
                         lambda: plain(q, k, v, bk), lambda: _sdpa(q, k, v),
                         flush, flops, nbytes, _peak(dt), plain_iters=5))
        torch.cuda.synchronize()


# The fp32 study rows (csrc/study_f32.cuh): (kernel, B10a's tile or
# None, (B, H, N, D), causal). (1, 8, 512, 64) is cli verify's defaults.
STUDY_F32_ROWS = (
    ("B10a", (16, 16), (1, 8, 512, 64), False),
    ("B10a", (16, 16), (1, 8, 2048, 64), False),
    ("B10a", (16, 16), (1, 8, 2048, 128), False),
    ("B10a", (64, 64), (1, 8, 2048, 64), False),
    ("B10a", (64, 64), (1, 8, 2048, 128), False),
    ("B10b", None, (1, 8, 2048, 128), False),
    ("B10b", None, (1, 8, 2048, 128), True),
    ("B10c", None, (1, 8, 2048, 128), False),
    ("B10a", (16, 16), (1, 8, 2048, 256), False),
    ("B10c", None, (1, 8, 2048, 256), False),
)


def check_study_fp32(rng, flush, results):
    """B10a (both tiles), B10b (causal and not) and B10c on fp32 inputs
    (csrc/study_f32.cuh) at STUDY_F32_ROWS, MHA: each under the study
    gate against fp64 (B10a's m and l too) and timed beside its bound at
    the 67 TFLOP/s FFMA rate (the function's 4 D FLOPs a visible pair,
    variants.study_cost; B10c's second Q K^T is work, not bound), its
    plain version at the same tile and SDPA in fp32 (TF32 off); the first row also with its device time alone and the
    wrapper's host time a call; one case of each kernel rerun for
    identical bits. results[("B10a fp32", shape, tile)], results[(
    "B10b fp32", shape, causal)], results[("B10c fp32", shape)]."""
    from flash_attention_tpu_torch.config import BlockSizes
    from flash_attention_tpu_torch.ops import variants

    reran = set()
    for r, (name, tile, (b, h, n, d), causal) in enumerate(STUDY_F32_ROWS):
        bs = None if tile is None else BlockSizes(*tile)
        (q, k, v), err = _study_case(rng, name, torch.float32, b, h, h, n,
                                     d, causal, block_sizes=bs)
        kern, plain = _study_fns(name, causal)
        bkv = None if tile is None else tile[1]
        flops, nbytes = variants.study_cost(
            b, h, h, n, n, d, causal, 4, stats=2 if name == "B10a" else 0)
        shape = f"({b},{h},{n},{d})"
        what = (f"{name} fp32 q{shape}{' causal' if causal else ''}"
                f"{'' if tile is None else f' tile {tile[0]}x{tile[1]}'}")

        def fn():
            return kern(q, k, v, block_sizes=bs)

        key = ((f"{name} fp32", shape, f"{tile[0]}x{tile[1]}") if tile
               else (f"{name} fp32", shape, causal) if name == "B10b"
               else (f"{name} fp32", shape))
        results[key] = row = dict(
            max_abs_err=err, shape=what.split(" ", 2)[2],
            **_timed_row(what, fn, lambda: plain(q, k, v, bkv),
                         lambda: _sdpa(q, k, v, causal), flush, flops,
                         nbytes, PEAK_FP32_FLOPS, plain_iters=2))
        if r == 0:
            host_row(what, fn, flush, row)
        if (name, tile, causal) not in reran:
            reran.add((name, tile, causal))
            same_bits(what, fn, fn())
        torch.cuda.synchronize()


# B1's ragged cases across the Hopper body's tile edges (64-row
# consumer warpgroups, 128-row blocks and kv tiles, 64 at D = 256):
# (Hq, Hkv, Nq, Nk, offset), each at D = 32 / 128 / 256.
LONG_RAGGED = ((4, 1, 77, 131, 54), (4, 2, 200, 200, 0), (8, 1, 200, 333, 0))


def check_flash_long(rng, flush, results):
    """B1 dense causal at (1, 32, 8192, 128) and (1, 32/8, 8192, 128) and
    B10c at (1, 32, 8192, 128), bf16: the 3x gate against the fp32
    reference (by kv group; B1's LSE within 1e-3), each timed beside its
    bound, plain version and SDPA; then B1 at ragged lengths across its
    tile edges (LONG_RAGGED, bf16 and fp16) under the same gate."""
    from flash_attention_tpu_torch.ops import flash, variants
    from flash_attention_tpu_torch.utils.metrics import (
        max_abs_error, verify_low_precision,
    )

    b, h, n, d = STUDY_SHAPE
    sc = d ** -0.5
    kw = dict(causal=True, scale=sc, offset=0)
    for hkv in (h, STUDY_GQA_KV):
        q = randn(rng, (b, h, n, d), torch.bfloat16)
        k = randn(rng, (b, hkv, n, d), torch.bfloat16)
        v = randn(rng, (b, hkv, n, d), torch.bfloat16)
        o, lse = flash.flash_attention_fwd(q, k, v, causal=True)
        lo = by_kv_group(flash.flash_attention_fwd_plain, q, k, v, **kw)
        hi = by_kv_group(flash.flash_attention_fwd_plain, q.float(),
                         k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        ok, kerr, berr = verify_low_precision(o, hi[0], lo[0])
        lse_err = max_abs_error(lse, hi[1])
        what = f"B1 flash_fwd causal q({b},{h},{n},{d}) kv({hkv}) bf16"
        log(f"check {what}: kernel_err={kerr:.3e} plain_err={berr:.3e} "
            f"lse_err={lse_err:.3e}")
        if not (ok and lse_err <= 1e-3
                and bool(torch.isfinite(o.float()).all())):
            raise AssertionError(f"{what} failed its gate")
        err = max_abs_error(o, lo[0])
        del lo, hi
        flops, nbytes = flash.fwd_cost(b, h, hkv, n, n, d, True, 2)
        results[("flash_long", hkv)] = dict(
            max_abs_err=err, shape=f"q({b},{h},{n},{d}) kv({b},{hkv},{n},"
                                   f"{d}) causal bf16",
            **_timed_row(
                what, lambda: flash.flash_attention_fwd(q, k, v, causal=True),
                lambda: by_kv_group(flash.flash_attention_fwd_plain, q, k, v,
                                    **kw),
                lambda: _sdpa(q, k, v, True), flush, flops, nbytes,
                PEAK_BF16_FLOPS, plain_iters=2))
        del q, k, v, o, lse
        torch.cuda.empty_cache()

    (q, k, v), err = _study_case(rng, "B10c", torch.bfloat16, b, h, h, n, d)
    kern, plain = _study_fns("B10c")
    flops, nbytes = variants.study_cost(b, h, h, n, n, d, False, 2)
    results[("naive_long", h)] = dict(
        max_abs_err=err, shape=f"q({b},{h},{n},{d}) bf16",
        **_timed_row(f"B10c bf16 q({b},{h},{n},{d})", lambda: kern(q, k, v),
                     lambda: plain(q, k, v), lambda: _sdpa(q, k, v), flush,
                     flops, nbytes, PEAK_BF16_FLOPS, plain_iters=2))
    del q, k, v
    torch.cuda.empty_cache()

    for dt in (torch.bfloat16, torch.float16):
        for d in (32, 128, 256):
            for hq, hkv, nq, nk, off in LONG_RAGGED:
                q = randn(rng, (1, hq, nq, d), dt)
                k = randn(rng, (1, hkv, nk, d), dt)
                v = randn(rng, (1, hkv, nk, d), dt)
                o, lse = flash.flash_attention_fwd(q, k, v, causal=True,
                                                   offset=off)
                rkw = dict(causal=True, scale=d ** -0.5, offset=off)
                lo = flash.flash_attention_fwd_plain(q, k, v, **rkw)
                hi = flash.flash_attention_fwd_plain(q.float(), k.float(),
                                                     v.float(), **rkw)
                torch.cuda.synchronize()
                ok, kerr, berr = verify_low_precision(o, hi[0], lo[0])
                lse_err = max_abs_error(lse, hi[1])
                what = (f"B1 flash_fwd {str(dt).split('.')[-1]} causal "
                        f"q(1,{hq},{nq},{d}) kv(1,{hkv},{nk},{d}) "
                        f"offset {off}")
                log(f"check {what}: kernel_err={kerr:.3e} "
                    f"plain_err={berr:.3e} lse_err={lse_err:.3e}")
                if not (ok and lse_err <= 1e-3
                        and bool(torch.isfinite(o.float()).all())):
                    raise AssertionError(f"{what} failed its gate")


# B1 on fp32 inputs (csrc/flash_fwd_f32.cuh): timed at (1, 8, 2048, D)
# causal for each D; gated (not timed) at the body's edges: (what, (B, Hq,
# Hkv, Nq, Nk, D), keyword arguments; seg=True: packed documents, one of
# them in no kv column, so its rows see nothing).
FLASH_F32_DIMS = (32, 64, 128, 256)
FLASH_F32_CASES = (
    *(("gqa 8/2", (1, 8, 2, 2048, 2048, d), dict(causal=True))
      for d in FLASH_F32_DIMS),
    *((f"ragged{' causal' if c else ''}", (2, 3, 1, 77, 131, d),
       dict(causal=c)) for d in FLASH_F32_DIMS for c in (False, True)),
    ("gqa 8/1", (1, 8, 1, 600, 600, 128), dict(causal=True)),
    ("window", (1, 4, 2, 1000, 1500, 128), dict(causal=True, window=300)),
    ("window", (1, 4, 2, 700, 700, 256), dict(causal=True, window=200)),
    ("segments", (2, 4, 2, 700, 700, 64), dict(causal=True, seg=True)),
    ("segments + window", (1, 4, 1, 700, 700, 32),
     dict(causal=True, window=250, seg=True)),
    ("roll buffer", (1, 8, 2, 300, 1000, 128),
     dict(causal=True, offset=1000, window=700)),
    ("offset Nk", (1, 4, 2, 77, 131, 128), dict(causal=True, offset=131)),
    ("bulk", (1, 8, 8, 1024, 1024, 128), dict(strict_below=128)),
    ("band", (1, 8, 8, 1024, 1024, 128), dict(causal=True, diag_band=128)),
    ("bulk", (1, 4, 4, 1024, 1024, 256), dict(strict_below=64)),
    ("band", (1, 4, 4, 1024, 1024, 256), dict(causal=True, diag_band=64)),
)


def _f32_docs(b, nq, nk):
    """Segment ids of FLASH_F32_CASES: q rows in documents 0, 1, 9, 2
    (document 9 in no kv column), kv columns in 0, 1, 2."""
    from flash_attention_tpu_torch.ops.flash import SegmentIds

    q = torch.tensor([0] * 200 + [1] * 200 + [9] * 100
                     + [2] * (nq - 500), dtype=torch.int32)
    kv = torch.tensor([0] * 200 + [1] * 200 + [2] * (nk - 400),
                      dtype=torch.int32)
    return SegmentIds(q.repeat(b, 1).cuda(), kv.repeat(b, 1).cuda())


def _b1_f32_plain(q, k, v, seg, kw):
    """B1's plain version under a case's masks, in q's dtype (fp64 for the
    reference)."""
    from flash_attention_tpu_torch.ops import flash

    sc = q.shape[-1] ** -0.5
    nq, nk = q.shape[2], k.shape[2]
    if "strict_below" in kw or "diag_band" in kw:
        bulk, band = flash._split_masks(
            nq, nk, kw.get("strict_below") or kw["diag_band"], q.device)
        return flash._masked_fwd_plain(
            q, k, v, sc, bulk if "strict_below" in kw else band)
    return flash.flash_attention_fwd_plain(
        q, k, v, causal=kw.get("causal", False), scale=sc,
        offset=kw.get("offset", nk - nq), window=kw.get("window"),
        segment_ids=seg)


def _flash_f32_case(rng, what, shape, kw):
    """One B1 fp32 case: the 3x gate against the fp64 plain version, LSE
    within 1e-3 on rows that see something, rows that see nothing O = 0
    and LSE = INIT_M * scale, identical bits on a rerun (two launches).
    Returns ((q, k, v, segment ids, kw), max-abs difference from the fp32
    plain version)."""
    from flash_attention_tpu_torch.ops import flash

    b, hq, hkv, nq, nk, d = shape
    kw = dict(kw)
    seg = _f32_docs(b, nq, nk) if kw.pop("seg", False) else None
    q = randn(rng, (b, hq, nq, d), torch.float32)
    k = randn(rng, (b, hkv, nk, d), torch.float32)
    v = randn(rng, (b, hkv, nk, d), torch.float32)
    o, lse = flash.flash_attention_fwd(q, k, v, seg, **kw)
    lo = _b1_f32_plain(q, k, v, seg, kw)
    hi = _b1_f32_plain(q.double(), k.double(), v.double(), seg, kw)
    torch.cuda.synchronize()
    what = (f"B1 fp32 {what} q({b},{hq},{nq},{d}) kv({hkv},{nk}) "
            f"{' '.join(f'{k_}={v_}' for k_, v_ in kw.items())}")
    err = _fp32_gate(what, o, hi[0], lo[0])
    lse_err, dead, dead_ok = _lse_gate(lse, hi[1], d ** -0.5)
    dead_ok = dead_ok and bool((o[dead] == 0).all())
    log(f"check {what}: lse_err={lse_err:.3e} dead_rows={int(dead.sum())} "
        f"dead_rows_ok={dead_ok}")
    if lse_err > 1e-3 or not dead_ok:
        raise AssertionError(f"{what}: LSE or dead rows off")
    same_bits(what, lambda: flash.flash_attention_fwd(q, k, v, seg, **kw),
              (o, lse))
    return (q, k, v, seg, kw), err


def check_flash_fp32(rng, flush, results):
    """B1 on fp32 inputs (the register-blocked FFMA body of
    csrc/flash_fwd_f32.cuh) over every branch: FLASH_F32_CASES (GQA 8/2
    at (1, 8, 2048, D) and ragged lengths at each D, GQA 8/1, windows,
    packed segment ids with rows that see nothing, segment ids with a
    window, the rolling buffer's offset > Nk - Nq, offset = Nk, the
    split's bulk and band passes at D = 128 and 256), each under the 3x
    gate against fp64 with identical bits on a rerun; the fp32, window,
    segment-id and split counters exact over them; then (1, 8, 2048, D)
    causal for each D gated and timed beside its bound at the 67 TFLOP/s
    FFMA rate, its fp32 plain version and SDPA in fp32 (TF32 off), D =
    128 also with its device time alone and the wrapper's host time a
    call. results[("B1 fp32", D)]. Calls only flash_attention_fwd and
    the plain version, so kernel_pairs.py times a parent with it."""
    from flash_attention_tpu_torch.ops import flash

    names = ("flash_fwd_fp32_launches", "flash_fwd_window_launches",
             "flash_fwd_segment_launches", "flash_fwd_split_bulk_launches",
             "flash_fwd_split_band_launches")
    before = [getattr(flash, n) for n in names]
    for what, shape, kw in FLASH_F32_CASES:
        _flash_f32_case(rng, what, shape, kw)
        torch.cuda.empty_cache()
    got = [getattr(flash, n) - x for n, x in zip(names, before)]
    want = [2 * sum(bool(f(kw)) for _, _, kw in FLASH_F32_CASES)
            for f in (lambda kw: True, lambda kw: kw.get("window"),
                      lambda kw: kw.get("seg"),
                      lambda kw: kw.get("strict_below"),
                      lambda kw: kw.get("diag_band"))]
    log(f"check B1 fp32 launches (fp32, window, segment ids, bulk, band): "
        f"{got} (expected {want})")
    if got != want:
        raise AssertionError(f"B1 fp32 launches {got}, expected {want}")

    b, h, n = STUDY_SMALL
    for d in FLASH_F32_DIMS:
        (q, k, v, _, kw), err = _flash_f32_case(
            rng, "timed", (b, h, h, n, n, d), dict(causal=True))
        flops, nbytes = flash.fwd_cost(b, h, h, n, n, d, True, 4)
        what = f"B1 fp32 q({b},{h},{n},{d}) causal"

        def fn():
            return flash.flash_attention_fwd(q, k, v, causal=True)

        results[("B1 fp32", d)] = row = dict(
            max_abs_err=err, shape=f"q({b},{h},{n},{d}) causal fp32",
            **_timed_row(what, fn,
                         lambda: _b1_f32_plain(q, k, v, None, kw),
                         lambda: _sdpa(q, k, v, True), flush, flops,
                         nbytes, PEAK_FP32_FLOPS, plain_iters=2))
        if d == 128:
            host_row(what, fn, flush, row)
        del q, k, v
        torch.cuda.empty_cache()


def check_split(rng, flush) -> dict:
    """flash_attention_fwd_split (two B1 launches, the bulk and band
    passes, and the LSE merge) at q [1, 32, 8192, 128] bf16, band 512
    and 2048: the 3x gate against its plain version (bf16) and fp32
    reference (by kv group), LSE within 1e-3 of single-pass B1 causal;
    its public call driven once per band with the counters zeroed (1
    bulk and 1 band launch each, exactly); timed beside single-pass B1
    causal and SDPA is_causal."""
    from flash_attention_tpu_torch.ops import flash
    from flash_attention_tpu_torch.utils.metrics import (
        max_abs_error, verify_low_precision,
    )

    b, h, n, d = STUDY_SHAPE
    sc = d ** -0.5
    q, k, v = (randn(rng, (b, h, n, d), torch.bfloat16) for _ in "qkv")
    o1, lse1 = flash.flash_attention_fwd(q, k, v, causal=True)
    out = {}
    for band in SPLIT_BANDS:
        reset_counts()
        o, lse = flash.flash_attention_fwd_split(q, k, v, band=band,
                                                 save_residuals=True)
        torch.cuda.synchronize()
        got = read_counts()
        want = dict(flash=2, flash_split_bulk=1, flash_split_band=1)
        if {key: got[key] for key in want} != want:
            raise AssertionError(f"split band {band}: launches {got}")
        lo = by_kv_group(flash.flash_attention_fwd_split_plain, q, k, v,
                         scale=sc, band=band)
        hi = by_kv_group(flash.flash_attention_fwd_split_plain, q.float(),
                         k.float(), v.float(), scale=sc, band=band)
        torch.cuda.synchronize()
        ok, kerr, berr = verify_low_precision(o, hi[0], lo[0])
        lse_err = max_abs_error(lse, hi[1])
        vs_single = max_abs_error(lse, lse1)
        o_single = max_abs_error(o, o1)
        log(f"check B1 split band {band} q({b},{h},{n},{d}) bf16: "
            f"kernel_err={kerr:.3e} plain_err={berr:.3e} "
            f"lse_err={lse_err:.3e} vs single-pass B1: lse {vs_single:.3e} "
            f"o {o_single:.3e}; launches bulk 1 band 1")
        if not (ok and lse_err <= 1e-3 and vs_single <= 1e-3):
            raise AssertionError(f"B1 split band {band} failed its gate")
        flops, nbytes = flash.fwd_cost(b, h, h, n, n, d, True, 2)
        out[band] = dict(
            max_abs_err=max_abs_error(o, lo[0]), launches=2,
            shape=f"q({b},{h},{n},{d}) causal bf16 band {band}",
            **_timed_row(
                f"B1 split band {band}",
                lambda: flash.flash_attention_fwd_split(q, k, v, band=band),
                lambda: by_kv_group(flash.flash_attention_fwd_split_plain,
                                    q, k, v, scale=sc, band=band),
                lambda: _sdpa(q, k, v, True), flush, flops, nbytes,
                PEAK_BF16_FLOPS, plain_iters=2))
        del lo, hi
    out["single"] = time_ms(
        lambda: flash.flash_attention_fwd(q, k, v, causal=True), flush)
    log(f"time  B1 single-pass causal at the split's shape: "
        f"{out['single']:.4f} ms")
    return out


def _harness_calls(warmup, iters, inner):
    """Calls utils.bench.measure makes of its function."""
    return max(warmup, 1) + iters * inner


def study_path() -> dict:
    """The kernel-study harness through its entry point, cli.main: verify
    with the reference's defaults, compare at the three bf16 perf
    configs (non-causal, then --causal) and fp32 at 1,8,2048,128, then
    perf with its defaults and --causal --bwd. Gates: exit codes 0,
    every cross-check pair PASS, no failure but the fixed-tile entries'
    head-dim ValueError at a foreign D, and every launch counter exact
    (bench_attention's calls worked out from its warmup / iters /
    inner). Returns the counts and the compare results."""
    from flash_attention_tpu_torch import cli

    reset_counts()
    if cli.main(["verify"]) != 0:
        raise AssertionError("cli verify failed")
    # The same in bf16: the tile law's 16 x 16 on the mma.sync body.
    if cli.main(["verify", "--dtype", "bfloat16"]) != 0:
        raise AssertionError("cli verify --dtype bfloat16 failed")
    results, cfgs = [], ((1, 32, 8192, 128), (1, 32, 8192, 64),
                         (1, 32, 8192, 32))
    for causal in (False, True):
        for cfg in cfgs:
            results.append(cli.compare_config(
                cfg, dtype="bfloat16", causal=causal, warmup=3, iters=5,
                device=torch.device("cuda")))
    results.append(cli.compare_config(
        (1, 8, 2048, 128), dtype="float32", causal=False, warmup=3, iters=5,
        device=torch.device("cuda")))
    for res in results:
        d = res["config"][3]
        for rep in res["reports"]:
            log(f"compare {res['config']}: {rep.line()}")
        bad = [pair for pair, r in res["checks"].items() if not r.passed]
        for (a, bname), r in res["checks"].items():
            if not r.passed:
                log(f"compare {res['config']}: {a} vs {bname} FAIL {r}")
        for name, (kind, exc, msg) in res["failures"].items():
            log(f"compare {res['config']}: {name} {kind}: {exc}: {msg}")
            fixed = {"flash_fixed_d64": 64, "flash_fixed_d32": 32}
            if not (name in fixed and d != fixed[name] and exc ==
                    "ValueError" and "fixed to head_dim" in msg):
                bad.append(name)
        if bad:
            raise AssertionError(f"compare {res['config']}: {bad}")
        log(f"compare {res['config']} {res['dtype']} causal="
            f"{res['causal']}: {len(res['checks'])} pairs PASS")
    if cli.main(["perf", "--causal", "--bwd"]) != 0:
        raise AssertionError("cli perf failed")
    got = read_counts()
    call = _harness_calls(3, 5, 5) + 1      # bench_attention + one output
    verify_calls = 1 + _harness_calls(5, 5, 5)
    perf_fwd, perf_bwd = _harness_calls(3, 5, 5), _harness_calls(3, 5, 16)
    fixed_runs = 2 * 2          # d64 at D = 64, d32 at D = 32, both modes
    want = dict(
        fa1=2 * verify_calls + 4 * call,      # 3 bf16 + 1 fp32 configs
        fa1_tile16=verify_calls,
        # fp32: verify at its defaults (B10a 16 x 16), compare's fp32
        # config (B10a 64 x 64, B10b, B10c).
        study_f32=verify_calls + 3 * call,
        naive=4 * call,
        fa2=7 * call,                         # 6 bf16 + 1 fp32
        flash=(7 + fixed_runs) * call + 2 * (perf_fwd + perf_bwd),
        flash_fp32=call,
        bwd_dq=2 * perf_bwd, bwd_dkv=2 * perf_bwd,
        flash_split_bulk=0, flash_split_band=0)
    have = {key: got[key] for key in want}
    log(f"study: launches {have}")
    if have != want:
        raise AssertionError(f"study launches {have}, expected {want}")
    return dict(launches=got, compare=results)


def study() -> dict:
    """The study phase: the kernels against their plain versions
    (check_study_kernels, check_split), then the harness through its
    entry point (study_path)."""
    flush = L2Flush()
    rng = np.random.default_rng(SEED + 9)
    out = {}
    for key, fn in (("kernels", check_study_kernels), ("split", check_split)):
        t = time.perf_counter()
        out[key] = fn(rng, flush)
        torch.cuda.synchronize()
        log(f"study: {fn.__name__} {time.perf_counter() - t:.1f} s")
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["path"] = study_path()
    log(f"study: study_path {time.perf_counter() - t:.1f} s")
    return out


# --- phase 2/3: fp32 on B2-B9 -------------------------------------------------

FP32_BWD_DIMS = (32, 64, 128, 256)   # B2 / B3 at (1, 8, 2048, D) causal
# B2 / B3 fp32 causal with Nq < Nk (offset Nk - Nq) across the body's
# 64-row resident and 16-row streamed tiles: (B, Hq, Hkv, Nq, Nk, D).
FP32_BWD_OFFSET = ((1, 4, 2, 200, 333, 128), (2, 4, 1, 77, 131, 32),
                   (1, 2, 2, 77, 131, 256))


def _fp32_gate(what, got, hi, lo):
    """The 3x gate of an fp32 kernel: its error against the fp64
    reference within 3x its fp32 plain version's (floored at one fp32
    ulp), finite. Returns the max-abs difference from the plain
    version."""
    from flash_attention_tpu_torch.utils.metrics import (
        max_abs_error, verify_low_precision,
    )

    ok, kerr, berr = verify_low_precision(got, hi, lo)
    finite = bool(torch.isfinite(got.float()).all())
    log(f"check {what}: kernel_err={kerr:.3e} fp32_plain_err={berr:.3e} "
        f"finite={finite}")
    if not (ok and finite):
        raise AssertionError(f"{what} failed its gate")
    return max_abs_error(got, lo)


def _timed_row(what, kern, plain, library, flush, flops, nbytes, peak,
               plain_iters=25, lib_what="", **extra):
    """CUDA-event medians of a kernel, its plain version and the library
    call (None: no single call), beside the bound at `peak`."""
    ms = time_ms(kern, flush)
    plain_ms = time_ms(plain, flush, iters=plain_iters,
                       warmup=min(3, plain_iters - 1))
    lib_ms = None if library is None else time_ms(library, flush)
    bms, by = bound_ms(flops, nbytes, peak)
    log(f"time  {what}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms} {lib_what} bound_ms={bms:.4f} ({by}) "
        f"achieved={flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s "
        f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by, **extra)


def check_fp32_bwd(rng, flush, results):
    """B2 / B3 on fp32 inputs (FFMA products): at (1, 8, 2048, D) causal
    for D = 32, 64, 128, 256, with a window and packed segment ids at (1,
    8, 1024, 128), and causal with Nq < Nk (FP32_BWD_OFFSET); each
    gradient under the 3x gate against the fp64 plain backward, identical
    bits on a rerun; the (1, 8, 2048, D) cases timed beside the bound at
    the FFMA rate, the plain backward and SDPA's fp32 backward."""
    from flash_attention_tpu_torch.ops.flash import SegmentIds

    f32 = torch.float32
    for d in FP32_BWD_DIMS:
        case, got, hi, lo = _bwd_case(rng, f32, 1, 8, 8, 2048, 2048, d, True)
        errs = _bwd_gate(f"B2/B3 q(1,8,2048,{d}) causal fp32, "
                         f"deterministic", got, hi, lo)
        del got, hi, lo
        timed = _bwd_timed("causal", case, flush, None, causal=True,
                           scale=1.0 / math.sqrt(d), offset=0)
        results[("fp32", "dq", d)] = dict(timed["dq"], max_abs_err=errs[0])
        results[("fp32", "dkv", d)] = dict(timed["dkv"],
                                           max_abs_err=max(errs[1:]))
        # B2 + B3, the backward's time (kernel_pairs.py compares it).
        results[("fp32", "dq+dkv", d)] = dict(
            ms=timed["dq"]["ms"] + timed["dkv"]["ms"])
        del case
    t = 1024
    ids = torch.repeat_interleave(
        torch.arange(3, dtype=torch.int32), torch.tensor([400, 350, 274]))
    ids = ids[None].cuda()
    case, got, hi, lo = _bwd_case(rng, f32, 1, 8, 8, t, t, 128, True,
                                  window=300, segment_ids=SegmentIds(ids,
                                                                     ids))
    errs = _bwd_gate(f"B2/B3 q(1,8,{t},128) causal window 300 + segment "
                     f"ids fp32, deterministic", got, hi, lo)
    results[("fp32", "masked")] = errs
    del case, got, hi, lo
    results[("fp32", "offset")] = []
    for b, hq, hkv, nq, nk, d in FP32_BWD_OFFSET:
        _, got, hi, lo = _bwd_case(rng, f32, b, hq, hkv, nq, nk, d, True)
        results[("fp32", "offset")].append(_bwd_gate(
            f"B2/B3 q({b},{hq},{nq},{d}) kv({hkv},{nk}) causal offset "
            f"{nk - nq} fp32, deterministic", got, hi, lo))
    torch.cuda.empty_cache()


def check_fp32_decode(rng, flush, results):
    """B4 on an fp32 q at check_paged's shape (8 sequences of 0-1500
    tokens, 16 q / 8 kv heads of 128, pages of 256) over fp32 pools and
    over int8 pools (and their fold_scales body), and B5 on an fp32 q at
    the generate shape over an fp32 cache and an int8 one; each under
    the 3x gate against the fp64 plain version (dead rows exactly 0),
    timed beside its bound (bytes), its plain version and, for B5, SDPA
    in fp32 with a length mask."""
    from flash_attention_tpu_torch.ops import decode as dec
    from flash_attention_tpu_torch.ops import paged
    from flash_attention_tpu_torch.ops.quant import dequantize_kv, quantize_kv

    f32 = torch.float32
    lengths = np.array([1, 1500, 0, 600, 255, 257, 1024, 777], np.int32)
    b, hq, hkv, d, ps = 8, 16, 8, 128, 256
    sc = 1.0 / math.sqrt(d)
    kp, vp, tbl, num_pages = paged_setup(rng, lengths, hkv, d, ps, 8)
    kp, vp = kp.float(), vp.float()
    q = randn(rng, (b, hq, d), f32)
    lens = torch.from_numpy(lengths).cuda()
    kc, ks = quant_pools(kp, torch.int8)
    vc, vs = quant_pools(vp, torch.int8)
    for what, pools, kw, kvi in (
            ("fp32 pools", (kp, vp), {}, None),
            ("int8 pools", (kc, vc), dict(k_scales=ks, v_scales=vs), 1),
            ("int8 pools fold_scales", (kc, vc),
             dict(k_scales=ks, v_scales=vs, fold_scales=True), 1)):
        o = paged.paged_flash_decode(q, *pools, tbl, lens, **kw)
        lo, _ = paged.paged_flash_decode_plain(q, *pools, tbl, lens,
                                               scale=sc, **kw)
        # The fp64 reference over the dequantized pools (fold_scales is
        # the same function: its reference is the default body's).
        hi_pools = pools if kvi else tuple(t.double() for t in pools)
        hi_kw = {k: v for k, v in kw.items() if k != "fold_scales"}
        hi, _ = paged.paged_flash_decode_plain(q.double(), *hi_pools, tbl,
                                               lens, scale=sc, **hi_kw)
        err = _fp32_gate(f"B4 fp32 q({b},{hq},{d}) {what} lens "
                         f"{lengths.tolist()}", o, hi, lo)
        if not bool((o[2] == 0).all()):
            raise AssertionError(f"B4 fp32 {what}: the dead row is not 0")
        flops, nbytes = paged.paged_decode_cost(lengths, hq, hkv, d, 4, ps,
                                                kv_itemsize=kvi)
        results[("fp32", "paged", what)] = _timed_row(
            f"B4 fp32 {what}", lambda: paged.paged_flash_decode(
                q, *pools, tbl, lens, **kw),
            lambda: paged.paged_flash_decode_plain(q, *pools, tbl, lens,
                                                   scale=sc, **kw),
            None, flush, flops, nbytes, PEAK_FP32_FLOPS, max_abs_err=err,
            lib_what="(no single PyTorch call attends over a page table)",
            shape=f"q({b},{hq},{d}) pools({hkv},{num_pages},{ps},{d}) "
                  f"{what}")
    del kp, vp, kc, vc
    b, s = 4, 640
    lens = [543] * 4
    q = randn(rng, (b, 32, d), f32)
    k = randn(rng, (b, 8, s, d), f32)
    v = randn(rng, (b, 8, s, d), f32)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    mask = (torch.arange(s, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    qk, qv = quantize_kv(k), quantize_kv(v)
    for what, kv, dense in (("fp32 cache", (k, v), (k, v)),
                            ("int8 cache", (qk, qv),
                             (dequantize_kv(qk, f32),
                              dequantize_kv(qv, f32)))):
        o = dec.flash_decode(q, *kv, lengths)
        lo = dec.flash_decode_plain(q, *dense, lengths, scale=sc)
        hi = dec.flash_decode_plain(q.double(), *(x.double() for x in dense),
                                    lengths, scale=sc)
        err = _fp32_gate(f"B5 fp32 q({b},32,{d}) {what} ({b},8,{s},{d}) "
                         f"lens {lens}", o, hi, lo)
        flops, nbytes = dec.decode_cost(
            lens, 32, 8, d, 4, kv_itemsize=None if kv[0] is k else 1)
        results[("fp32", "decode", what)] = _timed_row(
            f"B5 fp32 {what}", lambda: dec.flash_decode(q, *kv, lengths),
            lambda: dec.flash_decode_plain(q, *dense, lengths, scale=sc),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], *dense, attn_mask=mask, enable_gqa=True),
            flush, flops, nbytes, PEAK_FP32_FLOPS, max_abs_err=err,
            lib_what="(SDPA fp32, enable_gqa, length mask, over the "
                     "(dequantized) fp32 cache)",
            shape=f"q({b},32,{d}) cache({b},8,{s},{d}) lens {lens} {what}")


# fp32 B6-B8 at the 8B decode and prefill shapes of w_gate and the
# prefill shape of w_down; B9 at Mixtral's expert shapes with 16 rows.
FP32_MATMUL_SHAPES = ((16, 4096, 14336), (1024, 4096, 14336),
                      (1024, 14336, 4096))
FP32_GROUPED_SHAPES = ((16, 4096, 14336), (16, 14336, 4096))
# Shapes off the FFMA body's fast paths, gated only: x rows of K % 4 != 0
# (4-byte staging), weight rows of F % 16 != 0 bytes (byte loads), M
# across the 16 / 32 / 64 / 128-row tiles, K not a multiple of a step.
FP32_RAGGED = ((3, 130, 257), (33, 384, 200), (70, 256, 96), (129, 200, 384))
# B9's: (M, K, F, group sizes, base).
FP32_GROUPED_RAGGED = ((300, 384, 200, [100, 30, 0, 77, 50, 20, 13, 5], 3),
                       (13, 256, 130, [2, 0, 5, 3], None))


def _fp32_weight(kind, k, f, gen):
    """A random [k, f] weight for fp32 activations: the product's weight
    args and the exact fp32 weight they stand for (what the kernel
    multiplies: codes times scales in fp32; for "dense" an fp32 weight)."""
    from flash_attention_tpu_torch.ops import quant_matmul as qm

    if kind == "dense":
        w = torch.randn((k, f), generator=gen, device="cuda") / math.sqrt(k)
        return (w,), w
    args, _ = rand_weight(kind, k, f, gen)
    if kind == "int4":
        return args, qm.int4_dequant(*args, torch.float32)
    return args, args[0].float() * args[1]


def ffma_count():
    """The fp32 FFMA body's launch counter (every fp32 B6-B9 launch), or
    None in a package without it (a parent in kernel_pairs.py)."""
    from flash_attention_tpu_torch.ops import quant_matmul as qm

    return getattr(qm, "matmul_ffma_launches", None)


def _ffma_twice(what, fn):
    """fn() twice: identical bits (split rows merge their partials in a
    fixed order), and exactly two launches on the FFMA body's counter
    where the package has it. Returns the first output."""
    before = ffma_count()
    got = fn()
    same_bits(what, fn, got)
    after = ffma_count()
    if before is not None and after - before != 2:
        raise AssertionError(f"{what}: {after - before} FFMA body "
                             f"launches for 2 calls")
    return got


def _fp32_hi(kind, x, args, w32):
    """The fp64 product of B6-B8: B6 scales the sum at the store; B7 /
    B8 multiply the exact fp32 weight."""
    if kind in (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2):
        return (x.double() @ args[0].float().double()) * args[1].double()
    return x.double() @ w32.double()


def _grouped_hi(x, sizes, w32, base=None):
    """The fp64 product of B9 over the exact fp32 stack: each expert's
    rows against its weight, rows outside every expert zero."""
    offs = [(base or 0) + o for o in [0] + torch.cumsum(sizes, 0).tolist()]
    hi = torch.zeros((x.shape[0], w32.shape[2]), dtype=torch.float64,
                     device="cuda")
    for g in range(w32.shape[0]):
        lo, up = max(offs[g], 0), min(offs[g + 1], x.shape[0])
        if lo < up:
            hi[lo:up] = x[lo:up].double() @ w32[g].double()
    return hi


def check_fp32_matmul(rng, flush, results):
    """B6 (int8), B7 (int4) and B8 (an fp32 weight) on fp32 activations
    (csrc/matmul_f32.cuh's FFMA body) at 16 and 1024 rows of 4096 x 14336
    and 1024 rows of 14336 x 4096, and B9 on all five storages at
    Mixtral's w_gate / w_down with 16 expert-sorted rows over 8 experts:
    each under the 3x gate against the fp64 product over the exact fp32
    weight the kernel multiplies, rerun for identical bits with the FFMA
    body's counter exact, timed beside its bound (the FFMA rate or
    bytes), the plain version and the library call (torch.matmul in fp32
    on the fp32 weight; torch._grouped_mm on the fp32 stack where it
    takes one, else the reason it gave); then FP32_RAGGED on every
    storage and FP32_GROUPED_RAGGED (a base, an empty expert) on the
    dense and int4 stacks, gated only. Inputs come from the check's own
    seeded generators (rng is unused)."""
    from flash_attention_tpu_torch.ops.grouped import grouped_cost

    del rng
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 12)
    rng = np.random.default_rng(SEED + 12)
    for label, kind in (("B6 int8", torch.int8), ("B7 int4", "int4"),
                        ("B8 dense", "dense")):
        fn, plain, cost = _matmul_fns(kind)
        rows = []
        for m, k, f in FP32_MATMUL_SHAPES:
            args, w32 = _fp32_weight(kind, k, f, gen)
            x = torch.randn((m, k), generator=gen, device="cuda")
            what = f"{label} fp32 {m}x{k}x{f}"
            got = _ffma_twice(what, lambda: fn(x, *args))
            lo = plain(x, *args)
            hi = _fp32_hi(kind, x, args, w32)
            err = _fp32_gate(what, got, hi, lo)
            del hi
            flops, nbytes = cost(m, k, f, 4)
            rows.append(_timed_row(
                f"{label} fp32 {m}x{k}x{f}", lambda: fn(x, *args),
                lambda: plain(x, *args), lambda: torch.matmul(x, w32),
                flush, flops, nbytes, PEAK_FP32_FLOPS, max_abs_err=err,
                lib_what="(torch.matmul fp32 on the fp32 weight)",
                shape=f"x({m},{k}) w({k},{f}) fp32 x"))
            del args, w32, x, got, lo
        results[("fp32", label)] = rows
    e = N_EXPERTS
    for label, kind in GROUPED_KINDS.items():
        fn, plain, storage = _grouped_fns(kind)
        rows = []
        for m, k, f in FP32_GROUPED_SHAPES:
            per = [_fp32_weight(kind, k, f, gen) for _ in range(e)]
            args = tuple(torch.stack(t) for t in zip(*(a for a, _ in per)))
            w32 = torch.stack([w for _, w in per])
            del per
            x = torch.randn((m, k), generator=gen, device="cuda")
            sizes = skewed_sizes(rng, m, e)
            what = f"{label} fp32 {m}x{k}x{f} sizes {sizes.tolist()}"
            got = _ffma_twice(what, lambda: fn(x, sizes, *args))
            lo = plain(x, sizes, *args)
            err = _fp32_gate(what, got, _grouped_hi(x, sizes, w32), lo)
            lib_ms, lib_what = library_grouped(x, sizes, w32, flush)
            log(f"library {label} fp32 {m}x{k}x{f}: {lib_ms} ms ({lib_what})")
            flops, nbytes = grouped_cost(m, k, f, int((sizes > 0).sum()),
                                         storage, x_itemsize=4)
            row = _timed_row(
                f"{label} fp32 {m}x{k}x{f}", lambda: fn(x, sizes, *args),
                lambda: plain(x, sizes, *args), None, flush, flops, nbytes,
                PEAK_FP32_FLOPS, max_abs_err=err,
                shape=f"x({m},{k}) w({e},{k},{f}) fp32 x, sizes "
                      f"{sizes.tolist()}")
            row.update(library_ms=lib_ms, library=lib_what)
            rows.append(row)
            del args, w32, x, got, lo
        results[("fp32", label)] = rows
        torch.cuda.empty_cache()
    for kind in ("dense", torch.int8, torch.float8_e4m3fn,
                 torch.float8_e5m2, "int4"):
        fn, plain, _ = _matmul_fns(kind)
        for m, k, f in FP32_RAGGED:
            k = -(-k // 128) * 128 if kind == "int4" else k
            args, w32 = _fp32_weight(kind, k, f, gen)
            x = torch.randn((m, k), generator=gen, device="cuda")
            what = f"{kind} fp32 ragged {m}x{k}x{f}"
            got = _ffma_twice(what, lambda: fn(x, *args))
            _fp32_gate(what, got, _fp32_hi(kind, x, args, w32),
                       plain(x, *args))
    for label in ("B9 dense", "B9 int4"):
        kind = GROUPED_KINDS[label]
        fn, plain, _ = _grouped_fns(kind)
        for m, k, f, sizes, base in FP32_GROUPED_RAGGED:
            per = [_fp32_weight(kind, k, f, gen) for _ in sizes]
            args = tuple(torch.stack(t) for t in zip(*(a for a, _ in per)))
            w32 = torch.stack([w for _, w in per])
            x = torch.randn((m, k), generator=gen, device="cuda")
            gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            what = f"{label} fp32 ragged {m}x{k}x{f} sizes {sizes} base {base}"
            got = _ffma_twice(what, lambda: fn(x, gs, *args, base=base))
            _fp32_gate(what, got, _grouped_hi(x, gs, w32, base),
                       plain(x, gs, *args, base=base))
    torch.cuda.synchronize()
    log(f"check_fp32_matmul: {time.perf_counter() - t0:.1f} s")


def check_fp32(rng, flush, results):
    """B2-B9 on fp32 inputs (check_fp32_bwd, check_fp32_decode,
    check_fp32_matmul)."""
    check_fp32_bwd(rng, flush, results)
    torch.cuda.synchronize()
    check_fp32_decode(rng, flush, results)
    torch.cuda.synchronize()
    check_fp32_matmul(rng, flush, results)
    torch.cuda.synchronize()


def check_kernels() -> dict:
    """Phase 2/3: every check in turn, each one's seconds logged."""
    flush = L2Flush()
    rng = np.random.default_rng(SEED)
    results: dict = {}
    full = (check_flash, check_paged, check_flash_bwd, check_decode,
            check_quant_matmul, check_grouped, check_flash_branches,
            check_paged_window, check_decode_window, check_paged_quant,
            check_decode_quant, check_flash_quant, check_flash_long,
            check_bwd_branches, check_head_dims, check_flash_fp32,
            check_fp32)
    for fn in (check_flash, check_paged, check_flash_bwd, check_variants,
               check_decode, check_quant_matmul, check_grouped,
               check_flash_branches, check_paged_window,
               check_decode_window, check_paged_quant, check_decode_quant,
               check_flash_quant, check_flash_long, check_bwd_branches,
               check_head_dims, check_rows, check_split_edges,
               check_flash_fp32, check_fp32):
        t = time.perf_counter()
        if fn in full:
            fn(rng, flush, results)
        else:
            fn(rng)
        torch.cuda.synchronize()
        log(f"check: {fn.__name__} {time.perf_counter() - t:.1f} s")
    return results


# --- phase: fp32 through the public entry points ---------------------------


def fp32_api() -> dict:
    """B1-B9 on fp32 inputs through the calls a user makes, with every
    counter zeroed first: one flash_attention forward and backward at
    (1, 8, 1024, 128) causal (B1, B2, B3), paged_flash_decode over fp32
    and int8 pools, flash_decode over an fp32 cache, quant_matmul,
    int4_matmul and dense_matmul at 16 x 4096 x 4096, grouped_matmul and
    grouped_int4_matmul over 8 experts. Each fp32 counter must equal its
    kernel's total, the fp32 FFMA body's the five B6-B9 calls (none on
    the first body); the outputs must be finite."""
    from flash_attention_tpu_torch.ops import decode as dec
    from flash_attention_tpu_torch.ops import (
        flash, grouped, paged, quant_matmul as qm,
    )

    rng = np.random.default_rng(SEED + 13)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 13)
    f32 = torch.float32
    q, k, v = (randn(rng, (1, 8, 1024, 128), f32).requires_grad_()
               for _ in "qkv")
    lengths = np.array([700, 0, 1024, 300], np.int32)
    kp, vp, tbl, _ = paged_setup(rng, lengths, 8, 128, 256, 4)
    kp, vp = kp.float(), vp.float()
    kc, ks = quant_pools(kp, torch.int8)
    vc, vs = quant_pools(vp, torch.int8)
    lens = torch.from_numpy(lengths).cuda()
    qp = randn(rng, (4, 16, 128), f32)
    qd = randn(rng, (4, 32, 128), f32)
    kd, vd = (randn(rng, (4, 8, 640, 128), f32) for _ in "kv")
    x = torch.randn((16, 4096), generator=gen, device="cuda")
    (q8, s8), _ = rand_weight(torch.int8, 4096, 4096, gen)
    (p4, s4), _ = rand_weight("int4", 4096, 4096, gen)
    w32 = torch.randn((4096, 4096), generator=gen, device="cuda") / 64.0
    sizes = torch.tensor([5, 0, 3, 8], dtype=torch.int32, device="cuda")
    stack = torch.randn((4, 512, 384), generator=gen, device="cuda")
    p4s, s4s = rand_stack("int4", 4, 512, 384, gen)
    xg = torch.randn((16, 512), generator=gen, device="cuda")
    torch.cuda.synchronize()

    reset_counts()
    o = flash.flash_attention(q, k, v, causal=True)
    o.backward(torch.ones_like(o))
    outs = [o, q.grad, k.grad, v.grad,
            paged.paged_flash_decode(qp, kp, vp, tbl, lens),
            paged.paged_flash_decode(qp, kc, vc, tbl, lens,
                                     k_scales=ks, v_scales=vs),
            dec.flash_decode(qd, kd, vd,
                             torch.tensor([543] * 4, dtype=torch.int32,
                                          device="cuda")),
            qm.quant_matmul(x, q8, s8), qm.int4_matmul(x, p4, s4),
            qm.dense_matmul(x, w32), grouped.grouped_matmul(xg, sizes, stack),
            grouped.grouped_int4_matmul(xg, sizes, p4s, s4s)]
    torch.cuda.synchronize()
    got = read_counts()
    want = dict(flash=1, flash_fp32=1, bwd_dq=1, bwd_dkv=1, bwd_dq_fp32=1,
                bwd_dkv_fp32=1, paged=2, paged_fp32=2, paged_quant=1,
                decode=1, decode_fp32=1, quant=1, quant_fp32=1, int4=1,
                int4_fp32=1, dense=1, dense_fp32=1, grouped=2,
                grouped_fp32=2, matmul_ffma=5, matmul_first_body=0)
    have = {key: got[key] for key in want}
    finite = all(bool(torch.isfinite(t.float()).all()) for t in outs)
    log(f"fp32_api: launches {have} finite={finite}")
    if have != want or not finite:
        raise AssertionError(f"fp32 path launches {have}, expected {want}, "
                             f"finite={finite}")
    return got


# --- phase: the probes (P1, P2, P3) on their kernels -----------------------

# Calls of fn per time_ms(fn, flush) at its defaults (warm-up + timed).
TIMED_CALLS = 3 + 25


def probe_p1(flush) -> dict:
    """P1 (flash_attention_tpu_torch.scripts.probe_int4_variants) at the
    JAX probe's shape through its run(): v1 and v2 each under the 3x gate
    against the fp32 dequant reference (each against its own plain
    version's error: v1 rounds b s_b with b up to 15, so its error is
    larger by design) and with identical bits on a rerun (the split-K
    decode body sums its 2 splits in order); the launch counts exact, 0
    on the first body; then the M = 200 and first-body cases
    (_p1_cases)."""
    from flash_attention_tpu_torch.scripts import probe_int4_variants as p1
    from flash_attention_tpu_torch.utils.metrics import verify_low_precision

    reset_counts()
    rows = p1.run(timer=lambda fn: time_ms(fn, flush), keep_outputs=True,
                  out=log)
    torch.cuda.synchronize()
    got = read_counts()
    c = TIMED_CALLS
    want = dict(p1_v1=1 + c, p1_v2=1 + c, p1_first_body=0, dense=c,
                quant=c, int4=c)
    have = {key: got[key] for key in want}
    log(f"p1: launches {have}")
    if have != want:
        raise AssertionError(f"P1 launches {have}, expected {want}")
    for r in rows:
        outs = r.pop("outputs", None)
        if outs is None:
            continue
        ok, kerr, berr = verify_low_precision(outs["kernel"],
                                              outs["reference"],
                                              outs["plain"])
        finite = bool(torch.isfinite(outs["kernel"].float()).all())
        same = torch.equal(p1.int4_variant_matmul(*outs["inputs"],
                                                  r["variant"]),
                           outs["kernel"])
        log(f"check P1 v{r['variant']}: kernel_err={kerr:.3e} "
            f"plain_err={berr:.3e} (vs the fp32 dequant reference) "
            f"rel {r['rel_err']:.3e} plain rel {r['plain_rel_err']:.3e} "
            f"finite={finite} rerun_identical={same}")
        if not (ok and finite and same):
            raise AssertionError(f"P1 v{r['variant']} failed its gate")
    _p1_cases()
    return dict(rows=rows, launches=got)


def _p1_cases():
    """P1 v1 and v2 beyond the probe's shape, each under the 3x gate
    against the fp32 dequant reference with its plain version's error as
    the baseline: 200 rows of (4096, 14336) (four 64-row slices of x on
    the decode body, 2 splits) and (8, 1024, 5000), whose packed rows of
    5000 bytes TMA cannot address (the first body: its counter rises by
    exactly one a call, and by none on the decode body)."""
    from flash_attention_tpu_torch.scripts import probe_int4_variants as p1
    from flash_attention_tpu_torch.utils.metrics import verify_low_precision

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 15)
    for m, k, f in ((200, 4096, 14336), (8, 1024, 5000)):
        packed = torch.randint(0, 256, (k // 2, f), generator=gen,
                               device="cuda", dtype=torch.uint8)
        scales = (0.5 + torch.rand((k // 128, f), generator=gen,
                                   device="cuda")) / (4.64 * math.sqrt(k))
        x = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        b = p1.unpack_offset_binary(packed).float() - 8.0
        ref = x.float() @ (b.view(k // 128, 128, f)
                           * scales[:, None, :]).view(k, f)
        del b
        body = "decode" if f % 16 == 0 else "first"
        for variant in (1, 2):
            before = p1.first_body_launches
            got = p1.int4_variant_matmul(x, packed, scales, variant)
            torch.cuda.synchronize()
            first = p1.first_body_launches - before
            plain = p1.int4_variant_plain(x, packed, scales, variant)
            ok, kerr, berr = verify_low_precision(got, ref, plain)
            finite = bool(torch.isfinite(got.float()).all())
            log(f"check P1 v{variant} {m}x{k}x{f} ({body} body): "
                f"kernel_err={kerr:.3e} plain_err={berr:.3e} "
                f"finite={finite} first_body_launches={first}")
            if not (ok and finite and first == (body == "first")):
                raise AssertionError(f"P1 v{variant} failed at "
                                     f"{m}x{k}x{f}")
        del packed, scales, x, ref


def probe_p2(flush) -> dict:
    """P2 (flash_attention_tpu_torch.scripts.probe_paged_int8) at the
    JAX probe's shape through its run(): v2 under the quantized-branch
    gates (O and LSE on the 3x rule against the fp32 reference over the
    dequantized pools, row by row against the bf16 plain version); the
    launch counts exact."""
    from flash_attention_tpu_torch.scripts import probe_paged_int8 as p2

    reset_counts()
    rows = p2.run(timer=lambda fn: time_ms(fn, flush), keep_outputs=True,
                  out=log)
    torch.cuda.synchronize()
    got = read_counts()
    c = TIMED_CALLS
    want = dict(p2_v2=1 + c, paged=4 * c, paged_quant=3 * c,
                paged_fold=c)
    have = {key: got[key] for key in want}
    log(f"p2: launches {have}")
    if have != want:
        raise AssertionError(f"P2 launches {have}, expected {want}")
    for r in rows:
        outs = r.pop("outputs", None)
        if outs is not None:
            _quant_gate("P2 v2 (B=64, 32q/8kv, D=128, 4088 tokens, int8 "
                        "pages of 256)", outs["o"], outs["ref_o"],
                        outs["plain_o"], lse=outs["lse"],
                        lse_hi=outs["ref_lse"], lse_lo=outs["plain_lse"],
                        scale=1.0 / math.sqrt(p2.D))
    return dict(rows=rows, launches=got)


def probe_p3(flush) -> dict:
    """P3 (flash_attention_tpu_torch.scripts.probe_lmhead_argmax) at the
    JAX probe's shape through its run(): the fused kernel's values under
    the 3x gate against the fp64 logits' row max, with the path it
    replaces (B7's bf16 logits, their row max) as the same-precision
    baseline -- its tensor-core fp32 sums are less exact than the fp32
    plain version's FFMA sums, which the log reports beside; its ids
    equal to the plain version's on every row whose top-2 fp32 logit gap
    exceeds 4e (e the larger of the kernel's and the plain version's
    value error against fp64); then a crafted head with a row of exact
    ties (x = 0: every logit 0, id 0) and a row whose logits are all
    negative, at each chunk width, on V = 5000 (packed rows TMA cannot
    address: the first body) and V = 5008 (the decode body); and 200 rows
    of x (four 64-row slices) at the probe's lm_head. Launch counts
    exact: 0 on the first body at the probe's shapes, exactly 1 a call
    at V = 5000."""
    from flash_attention_tpu_torch.scripts import probe_lmhead_argmax as p3

    reset_counts()
    rows = p3.run(timer=lambda fn: time_ms(fn, flush), keep_outputs=True,
                  out=log)
    torch.cuda.synchronize()
    got = read_counts()
    c = TIMED_CALLS
    want = dict(p3=len(p3.CHUNKS) * (1 + c), p3_first_body=0, int4=1 + c)
    have = {key: got[key] for key in want}
    log(f"p3: launches {have}")
    if have != want:
        raise AssertionError(f"P3 launches {have}, expected {want}")
    for r in rows:
        outs = r.pop("outputs", None)
        if outs is None:
            continue
        _p3_gate(f"P3 ({p3.M} rows, chunk {r['chunk']})", outs["x"],
                 outs["packed"], outs["scales"], outs["ids"],
                 outs["values"], outs["plain_ids"], outs["plain_values"],
                 outs["logits"], r["agree"])
        x, packed, scales = outs["x"], outs["packed"], outs["scales"]
        del outs
        # 200 rows: four 64-row slices of x on the decode body, gated at
        # the default chunk; the other widths only regroup the same keys,
        # so their ids and values must be identical.
        x200 = randn(np.random.default_rng(SEED + 15), (200, p3.K),
                     torch.bfloat16, std=0.5)
        before = p3.first_body_launches
        by_chunk = {chunk: p3.lmhead_argmax(x200, packed, scales,
                                            chunk=chunk)
                    for chunk in p3.CHUNKS}
        torch.cuda.synchronize()
        if p3.first_body_launches != before:
            raise AssertionError("P3 at 200 rows left the decode body")
        ids, vals = by_chunk[p3.DEFAULT_CHUNK]
        pids, pvals = p3.lmhead_argmax_plain(x200, packed, scales)
        _p3_gate(f"P3 (200 rows, chunk {p3.DEFAULT_CHUNK})", x200, packed,
                 scales, ids, vals, pids, pvals,
                 p3.lmhead_logits_plain(x200, packed, scales))
        same = all(torch.equal(i, ids) and torch.equal(v, vals)
                   for i, v in by_chunk.values())
        log(f"check P3 (200 rows): chunks {p3.CHUNKS} identical: {same}")
        if not same:
            raise AssertionError("P3 at 200 rows differs between chunks")
        del x, packed, scales, x200, by_chunk
    for v in (5000, 5008):
        for chunk in p3.CHUNKS:
            _p3_edge_rows(chunk, v)
    return dict(rows=rows, launches=got)


def _p3_gate(what, x, packed, scales, ids, vals, pids, pvals, logits,
             agree=None):
    """P3's values under the 3x gate against the fp64 logits' row max
    with B7's bf16 logits' row max as the baseline; its ids equal the
    plain version's on every row whose top-2 fp32 logit gap exceeds 4e
    (e the larger of the kernel's and the plain version's value error
    against fp64)."""
    from flash_attention_tpu_torch.ops import quant_matmul as qm
    from flash_attention_tpu_torch.utils.metrics import verify_low_precision

    hi = (x.double() @ qm.int4_dequant(packed, scales, torch.bfloat16)
          .double()).max(-1).values
    b7 = qm.int4_matmul(x, packed, scales).float().max(-1).values
    ok, kerr, berr = verify_low_precision(vals, hi, b7)
    plain_err = float((pvals.double() - hi).abs().max())
    e = max(kerr, plain_err)
    top2 = logits.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 4 * e
    same = bool((ids[clear] == pids[clear]).all())
    log(f"check {what} values: kernel_err={kerr:.3e} b7_bf16_err="
        f"{berr:.3e} fp32_plain_err={plain_err:.3e} (vs the fp64 row max); "
        f"ids equal the plain version's on {int(clear.sum())} of "
        f"{x.shape[0]} rows with a top-2 gap > 4e (e={e:.3e}): {same}"
        + ("" if agree is None else
           f"; agreement with B7 + argmax {agree:.3f}"))
    if not (ok and same):
        raise AssertionError(f"{what} failed its gate")


def _p3_edge_rows(chunk, v):
    """The fused kernel on a crafted lm_head [4096, v] at one chunk
    width: row 0 of x is zero (every logit exactly 0: id 0), row 1 sees
    only negative logits (x < 0, weights > 0), row 2 a random row; ids
    and values equal the plain version's. V = 5000 (rows of 5000 bytes)
    runs the first body, V = 5008 the decode body: the first-body
    counter rises by exactly one a call on the first, by none on the
    second."""
    from flash_attention_tpu_torch.ops import quant_matmul as qm
    from flash_attention_tpu_torch.scripts import probe_lmhead_argmax as p3

    rng = np.random.default_rng(SEED + 14)
    k = 4096
    w = np.abs(rng.normal(0, 0.02, (k, v))).astype(np.float32) + 1e-3
    packed, scales = (t.cuda() for t in qm.quantize_weight_int4(w))
    x = torch.from_numpy(np.stack([
        np.zeros(k), -np.abs(rng.normal(0, 0.5, k)),
        rng.normal(0, 0.5, k)]).astype(np.float32)).to("cuda",
                                                      torch.bfloat16)
    before = p3.first_body_launches
    ids, vals = p3.lmhead_argmax(x, packed, scales, chunk=chunk)
    first = p3.first_body_launches - before
    pids, pvals = p3.lmhead_argmax_plain(x, packed, scales)
    torch.cuda.synchronize()
    body = "first" if v % 16 else "decode"
    ok = (torch.equal(ids, pids) and int(ids[0]) == 0
          and float(vals[0]) == 0.0 and float(vals[1]) < 0
          and float((vals - pvals).abs().max()) <= 1e-3
          and first == (body == "first"))
    log(f"check P3 V={v} ({body} body) chunk {chunk} edge rows: ids "
        f"{ids.tolist()} plain {pids.tolist()} values {vals.tolist()} "
        f"first_body_launches={first} -> {ok}")
    if not ok:
        raise AssertionError(f"P3 V={v} chunk {chunk} edge rows differ")


def probes() -> dict:
    """The probes phase: P1, P2, P3 through their run() at the JAX
    probes' shapes, timed with this script's L2-flushed CUDA events; then
    P2 v2's edges (check_probe_paged)."""
    flush = L2Flush()
    out = {}
    for name, fn in (("p1", probe_p1), ("p2", probe_p2), ("p3", probe_p3)):
        t = time.perf_counter()
        out[name] = fn(flush)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"probes: {name} {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    out["p2_check"] = {}
    check_probe_paged(np.random.default_rng(SEED), flush, out["p2_check"])
    gc.collect()
    torch.cuda.empty_cache()
    log(f"probes: check_probe_paged {time.perf_counter() - t:.1f} s")
    return out


def _probe_row(what, fn, flush, cost, **extra):
    """time_ms and device_ms of fn() beside the bound of cost = (flops,
    bytes)."""
    ms, dev = time_ms(fn, flush), device_ms(fn, flush)
    bms, by = bound_ms(*cost)
    log(f"time  {what}: ms={ms:.4f} (device alone {dev:.4f}) "
        f"bound_ms={bms:.4f} ({by})")
    return dict(ms=ms, device_ms=dev, bound_ms=bms, bound_by=by, **extra)


def check_probe_int4(rng, flush, results):
    """P1 at the probe's shape (32 x 4096 x 14336 bf16) on weights drawn
    on the card (uniform random bytes: offset-binary nibbles for v1 / v2,
    two's-complement ones for v0 = B7): v1 and v2 under the 3x gate
    against the fp32 dequant reference (their plain versions' error the
    baseline), then v1, v2, v0 and torch.matmul on the dense bf16 weight
    timed (CUDA events, L2 flushed; device_ms the kernels alone). Calls
    only names both sides of a kernel_pairs.py run have
    (int4_variant_matmul, int4_matmul)."""
    from flash_attention_tpu_torch.ops import quant_matmul as qm
    from flash_attention_tpu_torch.scripts import probe_int4_variants as p1
    from flash_attention_tpu_torch.utils.metrics import verify_low_precision

    del rng
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 15)
    m, k, f = p1.M, p1.K, p1.F
    (packed, scales), _ = rand_weight("int4", k, f, gen)
    ob = packed.view(torch.uint8)
    x = (torch.randn((m, k), generator=gen, device="cuda") * 0.5).to(
        torch.bfloat16)
    b = p1.unpack_offset_binary(ob).float() - 8.0
    ref = x.float() @ (b.view(k // 128, 128, f) * scales[:, None, :]).view(
        k, f)
    del b
    cost = qm.int4_matmul_cost(m, k, f)
    for variant in (1, 2):
        got = p1.int4_variant_matmul(x, ob, scales, variant)
        plain = p1.int4_variant_plain(x, ob, scales, variant)
        ok, kerr, berr = verify_low_precision(got, ref, plain)
        log(f"check P1 v{variant} (pairs input): kernel_err={kerr:.3e} "
            f"plain_err={berr:.3e}")
        if not ok:
            raise AssertionError(f"P1 v{variant} failed its gate")
        results[f"P1 v{variant}"] = _probe_row(
            f"P1 v{variant} {m}x{k}x{f}",
            lambda: p1.int4_variant_matmul(x, ob, scales, variant), flush,
            cost)
    results["P1 v0 (B7)"] = _probe_row(
        f"P1 v0 = B7 {m}x{k}x{f}", lambda: qm.int4_matmul(x, packed, scales),
        flush, cost)
    wd = qm.int4_dequant(packed, scales, torch.bfloat16)
    results["P1 torch.matmul"] = _probe_row(
        f"P1 torch.matmul dense bf16 {m}x{k}x{f}",
        lambda: torch.matmul(x, wd), flush, qm.dense_matmul_cost(m, k, f))


# P2 v2's edges on the split-KV body: (what, B, Hq, Hkv, page size, table
# width, lengths). B = 2 at 16 pages of 256 takes 8 splits, more than its
# sequences' live quant blocks (0 and 2); the rest take 1-4 splits.
P2_EDGES = (
    ("more splits than live blocks", 2, 32, 8, 256, 16, (0, 129)),
    ("block edges", 5, 12, 2, 128, 4, (0, 1, 127, 128, 129)),
    ("pages of 512", 3, 8, 1, 512, 2, (1000, 513, 300)),
    ("ragged batch", 8, 32, 8, 256, 16,
     (4088, 3000, 1, 0, 129, 2000, 4096, 255)),
)


def _p2_case(gen, b, hq, hkv, ps, width, lengths):
    """Seeded int8 pools of the probe's draw (N(0, 0.02^2), quantized by
    quantize_pool) drawn on the card, a page table of distinct pages, q
    in bf16: the arguments of paged_int8_v2."""
    from flash_attention_tpu_torch.scripts import probe_paged_int8 as p2

    pages = b * width
    kq, ks = p2.quantize_pool(torch.randn(
        (hkv, pages, ps, p2.D), generator=gen, device="cuda") * 0.02)
    vq, vs = p2.quantize_pool(torch.randn(
        (hkv, pages, ps, p2.D), generator=gen, device="cuda") * 0.02)
    table = torch.randperm(pages, generator=gen, device="cuda").view(
        b, width).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = (torch.randn((b, hq, p2.D), generator=gen, device="cuda")
         * 0.02).to(torch.bfloat16)
    return q, kq, vq, ks, vs, table, lens


def _p2_gated(what, args):
    """P2 v2 on args under the quantized-branch gates (O and LSE on the
    3x rule against the fp32 reference over the dequantized pools, row by
    row against the bf16 plain version, sequences of length 0 exact) and
    identical bits on a rerun (two launches)."""
    from flash_attention_tpu_torch.ops.paged import paged_flash_decode_plain
    from flash_attention_tpu_torch.scripts import probe_paged_int8 as p2

    q, kq, vq, ks, vs, table, lens = args
    scale = 1.0 / math.sqrt(p2.D)
    o, lse = p2.paged_int8_v2(*args)
    po, plse = p2.paged_int8_v2_plain(*args, scale=scale)
    ro, rlse = paged_flash_decode_plain(q.float(), kq, vq, table, lens,
                                        scale=scale, k_scales=ks,
                                        v_scales=vs)
    torch.cuda.synchronize()
    _quant_gate(what, o, ro, po, lse=lse, lse_hi=rlse, lse_lo=plse,
                scale=scale)
    same_bits(what, lambda: p2.paged_int8_v2(*args), (o, lse))


def check_probe_paged(rng, flush, results):
    """P2 v2 (paged_int8_v2, csrc/probe_paged_int8.cu on decode_sm90.cuh's
    split-KV pieces) at the probe's shape (B = 64, 32 q / 8 kv heads, D =
    128, 4088 tokens, int8 pages of 256) on pools drawn on the card and
    at P2_EDGES, each under the quantized-branch gates with identical
    bits on a rerun, its launch counter exact; then v2 and v0 (B4's
    default int8 body, paged_flash_decode) at the probe's shape timed
    beside the byte bound (device_ms the kernels alone). Calls only
    paged_int8_v2 and its plain version, quantize_pool and
    paged_flash_decode, so kernel_pairs.py times a parent with it."""
    from flash_attention_tpu_torch.ops.paged import (
        paged_decode_cost, paged_flash_decode,
    )
    from flash_attention_tpu_torch.scripts import probe_paged_int8 as p2

    del rng
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 19)
    before = p2.paged_int8_v2_launches
    cases = [("probe's shape", p2.B, p2.HQ, p2.HKV, 256, p2.CTX // 256,
              (p2.CTX - 8,) * p2.B), *P2_EDGES]
    plan = getattr(p2, "v2_splits", None)   # a parent may lack the plan
    probe_args = None
    for what, b, hq, hkv, ps, width, lengths in cases:
        args = _p2_case(gen, b, hq, hkv, ps, width, lengths)
        splits = f", {plan(b * hkv, width * ps)} splits" if plan else ""
        _p2_gated(f"P2 v2 {what} (B={b}, {hq}q/{hkv}kv, pages of {ps}"
                  f"{splits})", args)
        probe_args = probe_args or args
        torch.cuda.empty_cache()
    got = p2.paged_int8_v2_launches - before
    log(f"check P2 v2 launches {got} (expected {2 * len(cases)})")
    if got != 2 * len(cases):
        raise AssertionError(f"P2 v2 launches {got}, expected "
                             f"{2 * len(cases)}")
    q, kq, vq, ks, vs, table, lens = probe_args
    cost = paged_decode_cost(lens.tolist(), p2.HQ, p2.HKV, p2.D, 2, 256,
                             kv_itemsize=1)
    results["P2 v2"] = _probe_row(
        "P2 v2 (probe's shape)", lambda: p2.paged_int8_v2(*probe_args),
        flush, cost)
    results["P2 v0 (B4 int8)"] = _probe_row(
        "P2 v0 = B4 int8 (probe's shape)",
        lambda: paged_flash_decode(q, kq, vq, table, lens, k_scales=ks,
                                   v_scales=vs), flush, cost)


def check_probe_lmhead(rng, flush, results):
    """P3 at the probe's shape (32 x 4096 x 128256 bf16) on a packed int4
    lm_head drawn on the card: ids equal to the plain version's on every
    row whose top-2 fp32 logit gap exceeds 1e-2, values within 1e-2 of
    it; then the fused kernel at each chunk width, B7 + torch.argmax (the
    probe's baseline) and torch.matmul on the dense bf16 lm_head +
    torch.argmax timed (CUDA events, L2 flushed; device_ms the calls
    alone). Calls only names both sides of a kernel_pairs.py run have
    (lmhead_argmax, int4_matmul)."""
    from flash_attention_tpu_torch.ops import quant_matmul as qm
    from flash_attention_tpu_torch.scripts import probe_lmhead_argmax as p3

    del rng
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 15)
    m, k, v = p3.M, p3.K, p3.V
    (packed, scales), wd = rand_weight("int4", k, v, gen)
    x = (torch.randn((m, k), generator=gen, device="cuda") * 0.5).to(
        torch.bfloat16)
    logits = x.float() @ wd.float()
    top2 = logits.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-2
    cost = p3.argmax_cost(m, k, v)
    for chunk in p3.CHUNKS:
        ids, vals = p3.lmhead_argmax(x, packed, scales, chunk=chunk)
        err = float((vals - top2[:, 0]).abs().max())
        same = bool((ids.long() == logits.argmax(-1))[clear].all())
        log(f"check P3 chunk {chunk} (pairs input): ids equal the plain "
            f"argmax on {int(clear.sum())} clear rows: {same}; value err "
            f"{err:.3e}")
        if not (same and err <= 1e-2):
            raise AssertionError(f"P3 chunk {chunk} failed its gate")
        results[f"P3 chunk {chunk}"] = _probe_row(
            f"P3 fused chunk {chunk}",
            lambda: p3.lmhead_argmax(x, packed, scales, chunk=chunk), flush,
            cost)
    del logits
    results["P3 B7 + argmax"] = _probe_row(
        "P3 B7 + torch.argmax",
        lambda: torch.argmax(qm.int4_matmul(x, packed, scales), -1), flush,
        qm.int4_matmul_cost(m, k, v))
    results["P3 torch.matmul + argmax"] = _probe_row(
        "P3 torch.matmul dense bf16 + torch.argmax",
        lambda: torch.argmax(torch.matmul(x, wd), -1), flush,
        qm.dense_matmul_cost(m, k, v))


def fp32_entries(results, fp32p, bwd_ptxas, mm_ptxas) -> list:
    """The kernels line's entries of B2-B9 on fp32 inputs, each with the
    launches its own fp32 counter saw on the fp32_api path (B2 / B3 and
    B6-B9 also their ptxas rows; B6-B9 the FFMA body's counter)."""
    def one(name, source, replaces, counter, row, **more):
        return dict(name=name, route="cuda",
                    source=f"flash_attention_tpu_torch/csrc/{source}",
                    replaces=f"flash_attention_tpu/ops/{replaces}",
                    launches=fp32p[counter],
                    launches_by_path={"fp32_api": fp32p[counter]},
                    **row, **more)

    def head_dims(part):
        return {f"head dim {d}": results[("fp32", part, d)]
                for d in FP32_BWD_DIMS if d != 128}

    def grouped_at():
        return {label: results[("fp32", label)] for label in GROUPED_KINDS
                if label != "B9 int4"}

    masked = results[("fp32", "masked")]
    offset = results[("fp32", "offset")]
    mm_body = ("register-blocked FFMA: 256 threads on a 16-128 x 128 tile "
               "(8 x 8 a thread, K sliced across thread groups below 128 "
               "rows), cp.async ring with the weight widened once a block "
               "in shared memory, K split by ffma_plan with a fixed-order "
               "merge (matmul_f32.cu / matmul_f32_grouped.cu instantiate it)")
    body = ("register-blocked FFMA: 4 warps over 64 resident rows (32 at "
            "D = 256), 16-row streamed tiles in a cp.async double buffer, "
            "accumulators in registers (flash_bwd_f32.cu instantiates it)")
    return [
        one("flash_bwd_dq (B2 fp32)", "flash_bwd_f32.cuh", "flash.py:716",
            "bwd_dq_fp32", results[("fp32", "dq", 128)], body=body,
            ptxas=[r for r in bwd_ptxas if "_dq_" in r],
            at_head_dims=head_dims("dq"),
            masked_window_segments_max_abs_err=masked[0],
            causal_offset_max_abs_err=max(e[0] for e in offset)),
        one("flash_bwd_dkv (B3 fp32)", "flash_bwd_f32.cuh", "flash.py:773",
            "bwd_dkv_fp32", results[("fp32", "dkv", 128)], body=body,
            ptxas=[r for r in bwd_ptxas if "_dkv_" in r],
            at_head_dims=head_dims("dkv"),
            masked_window_segments_max_abs_err=max(masked[1:]),
            causal_offset_max_abs_err=max(max(e[1:]) for e in offset)),
        one("paged_decode (B4 fp32)", "paged_decode_f32.cu", "paged.py:37",
            "paged_fp32", results[("fp32", "paged", "fp32 pools")],
            at_shapes={k: results[("fp32", "paged", k)]
                       for k in ("int8 pools", "int8 pools fold_scales")}),
        one("decode (B5 fp32)", "decode_f32.cu", "decode.py:71",
            "decode_fp32", results[("fp32", "decode", "fp32 cache")],
            at_shapes={"int8 cache": results[("fp32", "decode",
                                              "int8 cache")]}),
        *(one(name, "matmul_f32.cuh", replaces, counter,
              results[("fp32", label)][0], body=mm_body,
              ffma_launches_fp32_api=fp32p["matmul_ffma"],
              ptxas=[r for r in mm_ptxas if r.startswith(
                  "B9" if label.startswith("B9") else "B6-B8")],
              at_shapes=(results[("fp32", label)][1:] if at is None
                         else at))
          for name, replaces, counter, label, at in (
              ("quant_matmul (B6 fp32)", "quant_matmul.py:41", "quant_fp32",
               "B6 int8", None),
              ("int4_matmul (B7 fp32)", "quant_matmul.py:214", "int4_fp32",
               "B7 int4", None),
              ("dense_matmul (B8 fp32)", "quant_matmul.py:141",
               "dense_fp32", "B8 dense", None),
              ("grouped_matmul (B9 fp32)", "grouped.py:132", "grouped_fp32",
               "B9 int4", {"B9 int4 w_down": results[("fp32", "B9 int4")][1:],
                           **grouped_at()}))),
    ]


def probe_entries(pr, mm_ptxas, p2_ptxas) -> list:
    """The kernels line's entries of the probes' kernels (P1 v1 / v2, P2
    v2, P3), each with the launches its own counter saw in its probe's
    run() and its ptxas rows (P1 / P3 also their first-body launches; P2
    its check_probe_paged rows)."""
    def pick(rows, **match):
        return next(r for r in rows
                    if all(r.get(k) == v for k, v in match.items()))

    def fields(r):
        return {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}

    p1, p2, p3 = (pr[k]["rows"] for k in ("p1", "p2", "p3"))
    body = ("the split-K decode body of csrc/matmul_sm90.cuh (bf16, NP = "
            "64, x in 64-row slices)")
    entries = []
    for variant, line in ((1, 87), (2, 125)):
        r = pick(p1, variant=variant)
        entries.append(dict(
            name=f"probe_int4_variants v{variant} (P1)", route="cuda",
            source="flash_attention_tpu_torch/csrc/matmul_sm90.cuh",
            sources=[f"flash_attention_tpu_torch/csrc/probe_int4_v{variant}"
                     "_sm90.cu",
                     "flash_attention_tpu_torch/csrc/probe_int4_variants.cu "
                     "(entry; first body over matmul_core.cuh)"],
            body=body, replaces=f"scripts/probe_int4_variants.py:{line}",
            ptxas=[r for r in mm_ptxas if r.startswith(f"P1 v{variant}")],
            launches=pr["p1"]["launches"][f"p1_v{variant}"],
            launches_by_path={"probe_int4_variants":
                              pr["p1"]["launches"][f"p1_v{variant}"]},
            first_body_launches=pr["p1"]["launches"]["p1_first_body"],
            **fields(r), rel_err=r["rel_err"],
            plain_rel_err=r["plain_rel_err"],
            shape="x(32,4096) bf16 w(4096,14336) offset-binary int4",
            b7_as_built_ms=pick(p1, name="v0 shipped int4_matmul (B7)")
            ["ms"]))
    r = next(r for r in p2 if r["name"].startswith("v2 "))
    entries.append(dict(
        name="probe_paged_int8 v2 (P2)", route="cuda",
        source="flash_attention_tpu_torch/csrc/probe_paged_int8.cu",
        body="split-KV over decode_sm90.cuh's pieces (v2_splits from "
             "shapes, write_unit's fixed-order merge): 8 warps, each "
             "128-token quant block's K then V widened once into one bf16 "
             "tile the warps share, codes and scale rows in a 2-stage "
             "cp.async ring, tokens on the mma.sync M side",
        ptxas=p2_ptxas, check_probe_paged=pr["p2_check"],
        replaces="scripts/probe_paged_int8.py:76",
        launches=pr["p2"]["launches"]["p2_v2"],
        launches_by_path={"probe_paged_int8":
                          pr["p2"]["launches"]["p2_v2"]},
        **fields(r), ref_max_abs_err=r["ref_max_abs_err"],
        shape="q(64,32,128) bf16 int8 pools(8,1024,256,128), 4088 tokens",
        other_bodies={x["name"]: x["ms"] for x in p2 if x is not r}))
    r = pick(p3, chunk=2048)
    entries.append(dict(
        name="probe_lmhead_argmax (P3)", route="cuda",
        source="flash_attention_tpu_torch/csrc/matmul_sm90.cuh",
        sources=["flash_attention_tpu_torch/csrc/probe_lmhead_sm90.cu",
                 "flash_attention_tpu_torch/csrc/probe_lmhead_argmax.cu "
                 "(entry, key reduction; first body over matmul_core.cuh)"],
        body=body + ", argmax epilogue",
        ptxas=[r for r in mm_ptxas if r.startswith("P3")],
        replaces="scripts/probe_lmhead_argmax.py:40",
        launches=pr["p3"]["launches"]["p3"],
        launches_by_path={"probe_lmhead_argmax":
                          pr["p3"]["launches"]["p3"]},
        first_body_launches=pr["p3"]["launches"]["p3_first_body"],
        **fields(r), agree_with_b7_argmax=r["agree"],
        ids_equal_plain=r["plain_agree"],
        at_chunks={c: pick(p3, chunk=c)["ms"] for c in (1024, 4096)},
        b7_plus_argmax_ms=p3[0]["ms"],
        shape="x(32,4096) bf16 lm_head(4096,128256) int4, chunk 2048"))
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from flash_attention_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        secs = _cuda.build(verbose=True)
    print(report.getvalue(), end="", flush=True)
    for row in ptxas_rows(report.getvalue(), "flash_bwd_"):
        log(f"ptxas B2/B3 {row}")
    bwd_f32_ptxas = ptxas_rows(report.getvalue(), "flash_bwd_d")
    bwd_f32_ptxas = [r for r in bwd_f32_ptxas if "_f32 " in r]
    tile16_ptxas = ptxas_rows(report.getvalue(), "fa1_tile16")
    for row in tile16_ptxas:
        log(f"ptxas B10a 16x16 {row}")
    study_f32_ptxas = study_f32_ptxas_rows(report.getvalue())
    for row in study_f32_ptxas:
        log(f"ptxas B10a-c fp32 {row}")
    mm_ptxas = matmul_ptxas_rows(report.getvalue())
    for row in mm_ptxas:
        log(f"ptxas B6-B9 {row}")
    mm_f32_ptxas = matmul_f32_ptxas_rows(report.getvalue())
    for row in mm_f32_ptxas:
        log(f"ptxas B6-B9 fp32 {row}")
    split_ptxas = split_ptxas_rows(report.getvalue())
    for row in split_ptxas:
        log(f"ptxas B4/B5 {row}")
    flash_f32_ptxas = flash_f32_ptxas_rows(report.getvalue())
    for row in flash_f32_ptxas:
        log(f"ptxas B1 fp32 {row}")
    p2_ptxas = p2_ptxas_rows(report.getvalue())
    for row in p2_ptxas:
        log(f"ptxas P2 v2 {row}")
    log(f"build: kernels built in {secs:.2f} s "
        f"(phase {time.perf_counter() - t0:.2f} s)")
    phase_s = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        phase_s[name] = round(time.perf_counter() - t, 1)
        return out

    results = timed("check", check_kernels)
    fp32p = timed("fp32_api", fp32_api)
    pr = timed("probes", probes)
    gc.collect()
    torch.cuda.empty_cache()
    st = timed("study", study)
    gc.collect()
    torch.cuda.empty_cache()
    sl, sk, sp = st["path"]["launches"], st["kernels"], st["split"]
    launches = timed("serve_1b", serve)
    trained = timed("train_1b", train_1b)
    gc.collect()
    torch.cuda.empty_cache()
    q8 = timed("serve_8b", serve_8b_phase)
    l4, l8 = q8["int4"]["launches"], q8["int8"]["launches"]
    lg = q8["int4"]["generate"]["launches"]
    kvpaths = {"serve_8b_bf16_kv_int8": q8["kv_int8"]["launches"],
               "serve_8b_bf16_kv_e4m3": q8["kv_e4m3"]["launches"]}
    mix = timed("mixtral", mixtral)
    log(f"mixtral: decode tok/s at batch 8 -- int4 {MIXTRAL_INT4_LAYERS} "
        f"layers {mix['int4']['decode_tok_s']:.1f}, int8 {MIXTRAL_INT8_LAYERS} "
        f"layers {mix['int8']['decode_tok_s']:.1f}, int4 forced-grouped "
        f"{mix['int4_forced']['decode_tok_s']:.1f}, bf16 "
        f"{MIXTRAL_BF16_LAYERS} layers {mix['bf16']['decode_tok_s']:.1f}")
    mis = timed("mistral", mistral)
    gc.collect()
    torch.cuda.empty_cache()
    # The training paths of the window and segment-id branches of B2/B3.
    tpaths = {"train_mistral": timed("train_mistral", train_mistral)}
    gc.collect()
    torch.cuda.empty_cache()
    tpaths["segmented_grad_api"] = timed("segmented_grad", segmented_grad)
    tpaths["moe_loss_tiny"] = timed("moe_loss", moe_loss)
    log(f"phase seconds: {phase_s}")
    mm, mc = mis["monolithic"], mis["chunked"]
    log(f"mistral: decode tok/s at batch 8 -- monolithic "
        f"{mm['stats'].decode_tokens_per_s:.1f}, chunked "
        f"{mc['stats'].decode_tokens_per_s:.1f}; ttft p50/p90 monolithic "
        f"{mm['stats'].ttft_percentiles()}, chunked "
        f"{mc['stats'].ttft_percentiles()}")
    mq = mis["chunked_int8"]
    wpaths = {"serve_mistral_monolithic": mm["launches"],
              "serve_mistral_chunked": mc["launches"],
              "serve_mistral_chunked_int8_kv": mq["launches"],
              "generate_mistral_windowed": mis["generate"]["launches"]}
    cpaths = {"serve_1b_chunked": launches["chunked"]}
    apaths = {"forward_8b_int8_kv_api": q8["quant_api"]["launches"]}
    # The paths that reach the branches.
    bpaths = {**cpaths, **wpaths, **kvpaths, **apaths, **tpaths}
    log(f"quantized KV: decode tok/s llama3_8b bf16 / int8 / e4m3 KV "
        f"{q8['bf16']['decode_tok_s']:.1f} / "
        f"{q8['kv_int8']['decode_tok_s']:.1f} / "
        f"{q8['kv_e4m3']['decode_tok_s']:.1f}; mistral chunked bf16 / int8 "
        f"KV {mc['stats'].decode_tokens_per_s:.1f} / "
        f"{mq['stats'].decode_tokens_per_s:.1f}; B4 device ms per step "
        f"(profiled) mistral chunked bf16 / int8 KV "
        f"{mc.get('b4_ms_per_step')} / {mq.get('b4_ms_per_step')}")
    p2 = pr["p2"]["rows"]
    log("p2 table (B=64, 32q/8kv, D=128, ctx 4096): " + "; ".join(
        f"{r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
        f"{r['bound_by']})" for r in p2))

    def by_path(paths, key):
        return {path: got[key] for path, got in paths.items()}

    mpaths = {"serve_mixtral_int4": mix["int4"]["launches"],
              f"serve_mixtral{MIXTRAL_INT8_LAYERS}_int8":
                  mix["int8"]["launches"],
              "serve_mixtral_int4_forced": mix["int4_forced"]["launches"],
              f"serve_mixtral{MIXTRAL_BF16_LAYERS}_bf16":
                  mix["bf16"]["launches"]}

    def mix_by_path(key):
        return {path: got[key] for path, got in mpaths.items()}

    # B4 / B5 fp16 / bf16 launches on the first body, by model path (each
    # phase holds them at 0 through NO_BRANCHES).
    model_paths = {"serve_1b": launches, "serve_8b_int4": l4,
                   "serve_8b_int8": l8, "generate_8b_int4": lg, **mpaths,
                   **bpaths}
    first_body_paths = {
        key: {path: got.get(key) for path, got in model_paths.items()}
        for key in ("paged_first_body", "decode_first_body")}

    def matmul_entry(label, **extra):
        rows = results[label]
        return dict(rows[0], at_shapes=rows[1:], **MATMUL_SOURCES, **extra)

    def head_dims(kernel, part=None):
        return {f"head dim {d}": (results[("d", d, kernel)] if part is None
                                  else results[("d", d, kernel)][part])
                for d in (32, 256)}

    def bwd_entry(name, part, counter, key, replaces):
        return dict(name=name, route="cuda",
                    source="flash_attention_tpu_torch/csrc/flash_bwd_sm90.cuh",
                    replaces=replaces,
                    launches=sum(by_path(bpaths, counter).values()),
                    launches_by_path=by_path(bpaths, counter),
                    **results[("bwd", key)][part])

    kernels = [
        dict(name="flash_fwd (B1)", route="cuda",
             source="flash_attention_tpu_torch/csrc/flash_fwd.cu",
             replaces="flash_attention_tpu/ops/flash.py:259",
             launches=launches["flash"] + trained["flash"] + l4["flash"]
             + l8["flash"] + lg["flash"] + sl["flash"]
             + sum(mix_by_path("flash").values())
             + sum(by_path(bpaths, "flash").values()),
             launches_by_path={"serve_1b": launches["flash"],
                               "cli_study": sl["flash"],
                               "train_1b": trained["flash"],
                               "serve_8b_int4": l4["flash"],
                               "serve_8b_int8": l8["flash"],
                               "generate_8b_int4": lg["flash"],
                               **mix_by_path("flash"),
                               **by_path(bpaths, "flash")},
             **results[("flash", 512)],
             at_train_shape=results["flash_train"],
             at_long_context={"causal MHA":
                              results[("flash_long", STUDY_SHAPE[1])],
                              "causal GQA 32/8":
                              results[("flash_long", STUDY_GQA_KV)]},
             at_head_dims=head_dims("B1")),
        # B1's branches, each with the launches its own counter saw on
        # the paths (a roll-buffer launch takes both).
        dict(name="flash_fwd (B1 segment ids)", route="cuda",
             source="flash_attention_tpu_torch/csrc/flash_fwd.cu",
             replaces="flash_attention_tpu/ops/flash.py:259",
             launches=sum(by_path(bpaths, "flash_seg").values()),
             launches_by_path=by_path(bpaths, "flash_seg"),
             **results[("flash_seg", 3000)],
             at_shapes={f"chunk prefix, prefix_len {k}":
                        results[("flash_seg", k)] for k in (0, 8192)}),
        dict(name="flash_fwd (B1 window)", route="cuda",
             source="flash_attention_tpu_torch/csrc/flash_fwd.cu",
             replaces="flash_attention_tpu/ops/flash.py:259",
             launches=sum(by_path(bpaths, "flash_win").values()),
             launches_by_path=by_path(bpaths, "flash_win"),
             **results[("flash_roll", 12000)],
             at_shapes={**{f"roll buffer, prefix {k}":
                           results[("flash_roll", k)]
                           for k in (0, 2000)},
                        "windowed self-attention T=8192":
                            results["flash_window"]}),
        dict(name="flash_bwd_dq (B2)", route="cuda",
             source="flash_attention_tpu_torch/csrc/flash_bwd_sm90.cuh",
             replaces="flash_attention_tpu/ops/flash.py:716",
             launches=trained["bwd_dq"] + sl["bwd_dq"]
             + sum(by_path(bpaths, "bwd_dq").values()),
             launches_by_path={"train_1b": trained["bwd_dq"],
                               "cli_perf_bwd": sl["bwd_dq"],
                               **by_path(tpaths, "bwd_dq")},
             **results["bwd_dq"], at_head_dims=head_dims("B2/B3", "dq")),
        dict(name="flash_bwd_dkv (B3)", route="cuda",
             source="flash_attention_tpu_torch/csrc/flash_bwd_sm90.cuh",
             replaces="flash_attention_tpu/ops/flash.py:773",
             launches=trained["bwd_dkv"] + sl["bwd_dkv"]
             + sum(by_path(bpaths, "bwd_dkv").values()),
             launches_by_path={"train_1b": trained["bwd_dkv"],
                               "cli_perf_bwd": sl["bwd_dkv"],
                               **by_path(tpaths, "bwd_dkv")},
             **results["bwd_dkv"], at_head_dims=head_dims("B2/B3", "dkv")),
        # B2 / B3's branches, each with the launches its own counter saw
        # (the segmented gradient takes both).
        bwd_entry("flash_bwd_dq (B2 window)", "dq", "bwd_dq_win", "window",
                  "flash_attention_tpu/ops/flash.py:716"),
        bwd_entry("flash_bwd_dq (B2 segment ids)", "dq", "bwd_dq_seg",
                  "segments", "flash_attention_tpu/ops/flash.py:716"),
        bwd_entry("flash_bwd_dkv (B3 window)", "dkv", "bwd_dkv_win",
                  "window", "flash_attention_tpu/ops/flash.py:773"),
        bwd_entry("flash_bwd_dkv (B3 segment ids)", "dkv", "bwd_dkv_seg",
                  "segments", "flash_attention_tpu/ops/flash.py:773"),
        dict(name="paged_decode (B4)", route="cuda", source="flash_attention_tpu_torch/csrc/decode_sm90.cuh",
             replaces="flash_attention_tpu/ops/paged.py:37",
             launches=launches["paged"] + l4["paged"] + l8["paged"]
             + sum(mix_by_path("paged").values())
             + sum(by_path(bpaths, "paged").values()),
             launches_by_path={"serve_1b": launches["paged"],
                               "serve_8b_int4": l4["paged"],
                               "serve_8b_int8": l8["paged"],
                               **mix_by_path("paged"),
                               **by_path(bpaths, "paged")},
             **results["paged"], at_head_dims=head_dims("B4"),
             first_body_launches=first_body_paths["paged_first_body"],
             ptxas=split_ptxas),
        dict(name="paged_decode (B4 window starts)", route="cuda",
             source="flash_attention_tpu_torch/csrc/decode_sm90.cuh",
             replaces="flash_attention_tpu/ops/paged.py:37",
             launches=sum(by_path(bpaths, "paged_win").values()),
             launches_by_path=by_path(bpaths, "paged_win"),
             **results[("paged_win", 1)],
             at_qpos_spread_4=results[("paged_win", 4)],
             at_mistral_serving={k: results[("paged_serving", k)]
                                 for k in ("bf16", "int8")}),
        dict(name="decode (B5)", route="cuda", source="flash_attention_tpu_torch/csrc/decode_sm90.cuh",
             replaces="flash_attention_tpu/ops/decode.py:71",
             launches=lg["decode"] + sum(by_path(bpaths, "decode").values()),
             launches_by_path={"generate_8b_int4": lg["decode"],
                               **by_path(bpaths, "decode")},
             **results["decode"], at_head_dims=head_dims("B5"),
             first_body_launches=first_body_paths["decode_first_body"]),
        dict(name="decode (B5 window)", route="cuda",
             source="flash_attention_tpu_torch/csrc/decode_sm90.cuh",
             replaces="flash_attention_tpu/ops/decode.py:71",
             launches=sum(by_path(bpaths, "decode_win").values()),
             launches_by_path=by_path(bpaths, "decode_win"),
             **results["decode_win"]),
        # The int8 / fp8 branches, each with its own counter: int8 at the
        # headline shape, the fp8 storages (and windows) beside it.
        dict(name="flash_fwd (B1 int8/fp8)", route="cuda",
             source="flash_attention_tpu_torch/csrc/flash_fwd.cu",
             replaces="flash_attention_tpu/ops/flash.py:259",
             launches=sum(by_path(bpaths, "flash_quant").values()),
             launches_by_path=by_path(bpaths, "flash_quant"),
             **results[("flash_q", "int8")],
             at_shapes={k: results[("flash_q", k)]
                        for k in ("e4m3", "e5m2")}),
        dict(name="paged_decode (B4 int8/fp8)", route="cuda",
             source="flash_attention_tpu_torch/csrc/decode_sm90.cuh",
             replaces="flash_attention_tpu/ops/paged.py:37",
             launches=sum(by_path(bpaths, "paged_quant").values()),
             launches_by_path=by_path(bpaths, "paged_quant"),
             **results[("paged_q", "int8", "default")],
             at_shapes={**{k: results[("paged_q", k, "default")]
                           for k in ("e4m3", "e5m2", "bf16")},
                        **{f"int8 window starts qpos_spread {k}":
                           results[("paged_q_win", k)] for k in (1, 4)}},
             p2=p2),
        dict(name="paged_decode (B4 fold_scales)", route="cuda",
             source="flash_attention_tpu_torch/csrc/decode_sm90.cuh",
             replaces="flash_attention_tpu/ops/paged.py:37",
             launches=sum(by_path(bpaths, "paged_fold").values()),
             launches_by_path=by_path(bpaths, "paged_fold"),
             **results[("paged_q", "int8", "fold")]),
        dict(name="decode (B5 int8/fp8)", route="cuda",
             source="flash_attention_tpu_torch/csrc/decode_sm90.cuh",
             replaces="flash_attention_tpu/ops/decode.py:71",
             launches=sum(by_path(bpaths, "decode_quant").values()),
             launches_by_path=by_path(bpaths, "decode_quant"),
             **results[("decode_q", "int8", None)],
             at_shapes={**{k: results[("decode_q", k, None)]
                           for k in ("e4m3", "e5m2")},
                        **{f"{k} window 4096": results[("decode_q", k,
                                                        MISTRAL_WINDOW)]
                           for k in QUANT_KINDS}}),
        matmul_entry("B6 int8", name="quant_matmul (B6)", route="cuda",
                     replaces="flash_attention_tpu/ops/quant_matmul.py:41",
                     launches=l8["quant"] + mix["int8"]["launches"][
                         "quant"],
                     launches_by_path={
                         "serve_8b_int8": l8["quant"],
                         f"serve_mixtral{MIXTRAL_INT8_LAYERS}_int8":
                             mix["int8"]["launches"]["quant"]},
                     fp8=dict(e4m3=results["B6 e4m3"],
                              e5m2=results["B6 e5m2"]),
                     ptxas=[r for r in mm_ptxas
                            if r.startswith("B6-B8")]),
        matmul_entry("B7 int4", name="int4_matmul (B7)", route="cuda",
                     replaces="flash_attention_tpu/ops/quant_matmul.py:214",
                     host_us_per_call=results["host B7 int4"]["host_us"],
                     launches=l4["int4"] + lg["int4"]
                     + mpaths["serve_mixtral_int4"]["int4"]
                     + mpaths["serve_mixtral_int4_forced"]["int4"],
                     launches_by_path={
                         "serve_8b_int4": l4["int4"],
                         "generate_8b_int4": lg["int4"],
                         "serve_mixtral_int4":
                             mpaths["serve_mixtral_int4"]["int4"],
                         "serve_mixtral_int4_forced":
                             mpaths["serve_mixtral_int4_forced"]["int4"]}),
        matmul_entry("B8 dense", name="dense_matmul (B8)", route="cuda",
                     replaces="flash_attention_tpu/ops/quant_matmul.py:141",
                     launches=launches["dense"],
                     launches_by_path={"prefill_1b_dense_pallas_mm":
                                       launches["dense"]}),
        # Headline: int4 at the 4096-token prefill bucket (8192 sorted
        # rows) of w_gate, where B9 runs on the default path.
        dict(name="grouped_matmul (B9)", route="cuda",
             source="flash_attention_tpu_torch/csrc/matmul_sm90.cuh",
             sources=["flash_attention_tpu_torch/csrc/grouped_sm90_bf16.cu",
                      "flash_attention_tpu_torch/csrc/grouped_sm90_f16.cu",
                      "flash_attention_tpu_torch/csrc/grouped_matmul.cu "
                      "(entry; first body over matmul_core.cuh)"],
             replaces="flash_attention_tpu/ops/grouped.py:132",
             launches=sum(mix_by_path("grouped").values()),
             launches_by_path=mix_by_path("grouped"),
             **results["B9 int4"][2],
             at_shapes={label: results[label] for label in GROUPED_KINDS},
             ptxas=[r for r in mm_ptxas if r.startswith("B9")],
             crossover=mix["crossover"]),
        # The study kernels and B1's fp32 and split branches, each
        # with the launches its own counter saw on the study path.
        dict(name="fa1 (B10a)", route="cuda",
             source="flash_attention_tpu_torch/csrc/variants_fa1.cu",
             body="fp16 / bf16 at 64 x 64: wgmma + TMA ring "
                  "(csrc/study_sm90.cuh over sm90_attn.cuh); fp16 / bf16 "
                  "at 16 x 16: mma.sync register body (csrc/study_sm80.cuh,"
                  " its own entry); fp32: csrc/study_f32.cuh (its own "
                  "entry)",
             replaces="flash_attention_tpu/ops/variants.py:80",
             launches=sl["fa1"], launches_by_path={"cli_study": sl["fa1"]},
             **sk[("B10a", False)],
             at_tiles={" ".join(k[1:]): v for k, v in sk.items()
                       if isinstance(k, tuple) and len(k) == 4}),
        dict(name="fa1 16x16 (B10a, fp16 / bf16)", route="cuda",
             source="flash_attention_tpu_torch/csrc/study_sm80.cuh",
             body="one warp a 16-row q tile, 8 a block, Q fragments and O "
                  "in registers, mma.sync m16n8k16 with P from registers, "
                  "a cp.async K / V ring shared by the block",
             replaces="flash_attention_tpu/ops/variants.py:80",
             launches=sl["fa1_tile16"],
             launches_by_path={"cli_verify_bf16": sl["fa1_tile16"]},
             ptxas=tile16_ptxas,
             **sk[("B10a", "bfloat16", "(1,8,2048,128)", "16x16")],
             at_shapes={" ".join(k[1:]): v for k, v in sk.items()
                        if isinstance(k, tuple) and len(k) == 4
                        and k[3] == "16x16" and k[1] != "float32"}),
        dict(name="fa2_inloop (B10b)", route="cuda",
             source="flash_attention_tpu_torch/csrc/variants_fa2.cu",
             body="fp16 / bf16: wgmma + TMA ring (csrc/study_sm90.cuh "
                  "over sm90_attn.cuh); fp32: csrc/study_f32.cuh (its own "
                  "entry)",
             replaces="flash_attention_tpu/ops/variants.py:216",
             launches=sl["fa2"], launches_by_path={"cli_study": sl["fa2"]},
             **sk[("B10b", True)],
             at_shapes={"non-causal": sk[("B10b", False)]}),
        dict(name="naive (B10c)", route="cuda",
             source="flash_attention_tpu_torch/csrc/variants_naive.cu",
             body="fp16 / bf16: wgmma + TMA ring (csrc/study_sm90.cuh); "
                  "fp32: csrc/study_f32.cuh (its own entry)",
             replaces="flash_attention_tpu/ops/variants.py:349",
             launches=sl["naive"],
             launches_by_path={"cli_study": sl["naive"]},
             **sk[("B10c", False)]),
        # B10a-c on fp32 inputs: one body; the headline row is B10a's 16
        # x 16 tile at (1, 8, 2048, 128), the others in at_shapes.
        dict(name="study fp32 (B10a, B10b, B10c)", route="cuda",
             source="flash_attention_tpu_torch/csrc/study_f32.cuh",
             body="4 warps over 64 (or 32) q rows, S and O in registers, "
                  "P through shared memory, K / V slabs of 64 keys by "
                  "cp.async through two buffers, FFMA (no TF32)",
             replaces="flash_attention_tpu/ops/variants.py:80",
             also_replaces=["flash_attention_tpu/ops/variants.py:216",
                            "flash_attention_tpu/ops/variants.py:349"],
             launches=sl["study_f32"],
             launches_by_path={"cli_verify_and_compare_fp32":
                               sl["study_f32"]},
             ptxas=study_f32_ptxas,
             **sk[("B10a fp32", "(1,8,2048,128)", "16x16")],
             at_shapes={" ".join(map(str, k)): v for k, v in sk.items()
                        if isinstance(k, tuple) and k[0].endswith("fp32")}),
        dict(name="flash_fwd (B1 split)", route="cuda",
             source="flash_attention_tpu_torch/csrc/flash_fwd.cu",
             replaces="flash_attention_tpu/ops/flash.py:259",
             launches=sum(sp[band]["launches"] for band in SPLIT_BANDS),
             launches_by_path={f"flash_attention_fwd_split band {band}":
                               sp[band]["launches"] for band in SPLIT_BANDS},
             **{k: v for k, v in sp[SPLIT_BANDS[-1]].items()
                if k != "launches"},
             at_shapes={f"band {SPLIT_BANDS[0]}": sp[SPLIT_BANDS[0]]},
             single_pass_ms=sp["single"]),
        dict(name="flash_fwd (B1 fp32)", route="cuda",
             source="flash_attention_tpu_torch/csrc/flash_fwd_f32.cuh",
             sources=["flash_attention_tpu_torch/csrc/flash_fwd_f32.cu",
                      "flash_attention_tpu_torch/csrc/flash_fwd_f32_"
                      "masked.cu"],
             body="register-blocked FFMA on study_f32.cuh's plan (4 warps "
                  "over 64 q rows, 32 at D = 256; S and O in registers, P "
                  "through shared memory, K / V slabs of 64 keys through "
                  "two cp.async buffers), masks only on the slabs that "
                  "need them, window / segment ids in their own "
                  "instantiations",
             replaces="flash_attention_tpu/ops/flash.py:259",
             launches=sl["flash_fp32"] + fp32p["flash_fp32"],
             launches_by_path={"cli_compare_fp32": sl["flash_fp32"],
                               "fp32_api": fp32p["flash_fp32"]},
             ptxas=flash_f32_ptxas, **results[("B1 fp32", 128)],
             at_head_dims={f"head dim {d}": results[("B1 fp32", d)]
                           for d in FLASH_F32_DIMS if d != 128}),
        *fp32_entries(results, fp32p, bwd_f32_ptxas, mm_f32_ptxas),
        *probe_entries(pr, mm_ptxas, p2_ptxas),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
