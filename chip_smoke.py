#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flash_attention_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   compile the port's CUDA kernels (csrc/*.cu) and the native
             page allocator from the sources in this checkout;
  2. check   hold each kernel against its plain PyTorch version on the
             card in bf16 at the serving shapes (B1, B4) and the training
             shape (B2, B3), and in fp16/bf16 at small shapes for its
             other instantiations (the low-precision gate: kernel error
             <= 3x the plain version's error in the same dtype against an
             fp32 reference, LSE within 1e-3); B2/B3 must also give
             identical bits on a rerun;
  3. time    each kernel, its plain version and (where one exists) the
             one PyTorch call that computes the same function, with CUDA
             events; the bound is the larger of bytes / 3.35 TB/s and
             FLOPs / 989 TFLOP/s (H100 SXM data sheet);
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
  7. serve8b the Engine on LlamaConfig.llama3_8b at full width and depth
             on int4 (B7) and int8 (B6) weights drawn on the card by
             init_quantized_params: 16 greedy requests, exact launch
             counts, transcripts held to a teacher-forced forward on the
             dequantized weights; 8 profiled decode steps; the same
             requests on bf16 weights as the cuBLAS yardstick;
  8. generate sampling.generate on the int4 8B tree (B5 attention,
             exact launch counts, the same teacher-forced band);
  9. mixtral  the Engine on MoEConfig.mixtral_8x7b (dropless routing) at
             full width and depth on int4 and int8 weights drawn on the
             card by init_quantized_moe_params, then the int4 tree with
             FA_TPU_GROUPED_MIN_TOKENS=1 (B9 at every decode step), then
             bf16 weights at 16 layers (the one-card depth): 8 greedy
             requests of 300-4600 tokens, exact B9 / B7 / B6 / B1 / B4
             launch counts, transcripts held to a teacher-forced forward
             with plain attention and a plain per-expert MoE, 8 profiled
             decode steps each; between the int4 runs, one int4 MoE layer
             timed through the one-hot cubes and the grouped path at
             16-8192 tokens (the card's crossover, reported).
The 1B serve phase also runs one prefill with FA_TPU_DENSE_PALLAS_MM=1
(B8: exactly 7 launches per layer + 1, logits within the bf16 gate of
the cuBLAS path). Kernel checks (phase 2) cover B5 at the generate
shape and B6 (int8, e4m3, e5m2), B7 and B8 at the 8B decode (M = 16)
and prefill (M = 1024) shapes, ragged shapes and fp16, and B9 on all five
storages at Mixtral's expert shapes with 16 and 8192 expert-sorted rows,
a ragged shape, a base band with rows past the data, and fp16.

Prints information lines, then one JSON line describing the kernels,
then the card's name and power limit, and last one JSON line
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
no CUDA device is present or any phase fails.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12        # dense bf16 tensor-core rate, H100 SXM
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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_BF16_FLOPS
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


def _bwd_case(rng, dt, b, hq, hkv, nq, nk, d, causal, offset=None):
    """Kernel, bf16/fp16 plain and fp32 plain backward of one case, with
    the forward's o and LSE from B1 (the kernel path) or from the plain
    forward (the plain paths). The kernel runs twice: both runs must
    give identical bits."""
    from flash_attention_tpu_torch.ops import flash

    q = randn(rng, (b, hq, nq, d), dt)
    k = randn(rng, (b, hkv, nk, d), dt)
    v = randn(rng, (b, hkv, nk, d), dt)
    do = randn(rng, (b, hq, nq, d), dt)
    sc = 1.0 / math.sqrt(d)
    off = nk - nq if offset is None else offset
    kw = dict(causal=causal, scale=sc, offset=off)
    # The private launchers take any offset (negative ones make rows that
    # see no key); the public API rejects causal offsets below 0.
    o, lse = flash._flash_fwd_cuda(q, k, v, **kw)
    got = flash._flash_bwd_cuda(q, k, v, o, lse, do, **kw)
    again = flash._flash_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
    o_lo, lse_lo = flash.flash_attention_fwd_plain(q, k, v, **kw)
    lo = flash.flash_attention_bwd_plain(q, k, v, o_lo, lse_lo, do, **kw)
    f32 = [x.float() for x in (q, k, v, do)]
    o_hi, lse_hi = flash.flash_attention_fwd_plain(*f32[:3], **kw)
    hi = flash.flash_attention_bwd_plain(*f32[:3], o_hi, lse_hi, f32[3],
                                         **kw)
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
    sc = 1.0 / math.sqrt(d)
    kw = dict(causal=True, scale=sc, offset=0)
    (q, k, v, o, lse, do), got, hi, lo = _bwd_case(
        rng, torch.bfloat16, b, hq, hkv, t, t, d, True)
    errs = _bwd_gate(f"B2/B3 flash_bwd q({b},{hq},{t},{d}) "
                     f"kv({b},{hkv},{t},{d}) causal bf16, deterministic",
                     got, hi, lo)
    delta = flash._bwd_delta(o, do)

    def dq_kernel():
        flash._bwd_dq_cuda(q, k, v, do, lse, delta, **kw)

    def dkv_kernel():
        flash._bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)

    def plain_bwd():
        flash.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)

    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vr, is_causal=True, enable_gqa=True)

    def library_bwd():
        torch.autograd.grad(out, (qr, kr, vr), do, retain_graph=True)

    def fwd_kernel():
        flash.flash_attention_fwd(q, k, v, causal=True)

    def fwd_plain():
        flash.flash_attention_fwd_plain(q, k, v, **kw)

    def fwd_library():
        torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)

    ms_dq, ms_dkv = time_ms(dq_kernel, flush), time_ms(dkv_kernel, flush)
    plain_ms, lib_ms = time_ms(plain_bwd, flush), time_ms(library_bwd, flush)
    del out
    (f2, b2), (f3, b3) = flash.bwd_cost(b, hq, hkv, t, t, d, True, 2)
    bound2, by2 = bound_ms(f2, b2)
    bound3, by3 = bound_ms(f3, b3)
    log(f"time  B2 flash_bwd_dq: kernel_ms={ms_dq:.4f} bound_ms="
        f"{bound2:.4f} ({by2}) achieved={f2 / (ms_dq * 1e-3) / 1e12:.1f} "
        f"TFLOP/s")
    log(f"time  B3 flash_bwd_dkv: kernel_ms={ms_dkv:.4f} bound_ms="
        f"{bound3:.4f} ({by3}) achieved={f3 / (ms_dkv * 1e-3) / 1e12:.1f} "
        f"TFLOP/s")
    log(f"time  B2+B3: kernel_ms={ms_dq + ms_dkv:.4f} plain_ms="
        f"{plain_ms:.4f} library_ms={lib_ms:.4f} (autograd.grad through "
        f"SDPA(is_causal, enable_gqa): dq, dk, dv together)")
    shape = f"q({b},{hq},{t},{d}) kv({b},{hkv},{t},{d}) causal bf16"
    note = ("plain_ms and library_ms compute dq, dk and dv together "
            "(flash_attention_bwd_plain; autograd.grad through SDPA): "
            "compare them with B2 + B3")
    results["bwd_dq"] = dict(
        max_abs_err=errs[0], ms=ms_dq, plain_ms=plain_ms, bound_ms=bound2,
        bound_by=by2, library_ms=lib_ms, shape=shape, note=note)
    results["bwd_dkv"] = dict(
        max_abs_err=max(errs[1:]), ms=ms_dkv, plain_ms=plain_ms,
        bound_ms=bound3, bound_by=by3, library_ms=lib_ms, shape=shape,
        note=note)

    ms = time_ms(fwd_kernel, flush)
    p_ms, l_ms = time_ms(fwd_plain, flush), time_ms(fwd_library, flush)
    flops, nbytes = flash.fwd_cost(b, hq, hkv, t, t, d, True, 2)
    bms, by = bound_ms(flops, nbytes)
    log(f"time  B1 flash_fwd at the training shape: kernel_ms={ms:.4f} "
        f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} bound_ms={bms:.4f} "
        f"({by}) achieved={flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
    results["flash_train"] = dict(ms=ms, plain_ms=p_ms, library_ms=l_ms,
                                  bound_ms=bms, bound_by=by, shape=shape)


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
        paged.paged_flash_decode(q, kp, vp, tbl, lens, return_lse=True)

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


# --- phase 4: serve ----------------------------------------------------------


def serve() -> dict:
    """Serve 8 greedy requests on the 1B model at full width and depth
    and hold each transcript to a teacher-forced plain-attention
    forward. Returns the kernels' launch counts from the serving run."""
    import dataclasses

    from flash_attention_tpu_torch.models.llama import (
        LlamaConfig, forward, init_params,
    )
    from flash_attention_tpu_torch.ops import flash, paged
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
    flash.flash_fwd_launches = 0
    paged.paged_decode_launches = 0
    t0 = time.perf_counter()
    comps = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash": flash.flash_fwd_launches,
                "paged": paged.paged_decode_launches}
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
        f"{launches['paged']} (want {want_paged} = {cfg.n_layers}/step)")
    if launches["flash"] != want_flash or launches["paged"] != want_paged \
            or st.decode_steps == 0:
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
    profile_decode(eng, prompts, Request)
    return launches


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
        got = prefill_kv(params, tokens, cfg)[0]
        torch.cuda.synchronize()
        launches = qm.dense_matmul_launches
    finally:
        del os.environ["FA_TPU_DENSE_PALLAS_MM"]
    with torch.no_grad():
        ref = forward(params32, tokens, cfg32, attn_impl=plain_attn)[:, -1]
    ok, kerr, berr = verify_low_precision(got, ref, default)
    want = 7 * cfg.n_layers + 1
    log(f"b8 path: prefill_kv T=512 with FA_TPU_DENSE_PALLAS_MM=1: B8 "
        f"launches {launches} (want {want}); last-token logit error vs "
        f"fp32 {kerr:.4e}, default cuBLAS path's {berr:.4e} (gate 3x)")
    if launches != want or not ok:
        raise AssertionError("the B8 path failed its gate")
    return launches


def profile_decode(eng, prompts, request_cls,
                   what: str = "decode steps") -> None:
    """Where a decode step's time goes: torch.profiler over 8 engine
    decode steps of the same 8 prompts (after their prefill), device
    time by kernel and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.submit(request_cls(prompt=p, max_new_tokens=10))
    eng.step()                      # admission + prefill + first decode
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
    report_profile(prof, wall, steps, what)


def report_profile(prof, wall, steps, what) -> None:
    """Device time by kernel over a profiled window of `steps` steps and
    the device's busy share of its wall time."""
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
        return
    log(f"profile: {steps} {what}, wall {wall * 1e3 / steps:.3f} "
        f"ms/step, device busy {busy_us / 1e3 / steps:.3f} ms/step = "
        f"{busy_us / 1e6 / wall:.3f} of wall")
    for dev_us, key, count in rows[:10]:
        log(f"profile:   {dev_us / 1e3 / steps:8.4f} ms/step  "
            f"{count // steps:5d} launches/step  {key[:90]}")


# --- phase 7: serve 8B on quantized weights, generate ---------------------

# One prompt over 1024 tokens: its prefill bucket (2048 rows) takes the
# wide dequantize path for the layer products.
PROMPT_LENS_8B = [256, 300, 333, 400, 480, 512, 600, 640, 700, 777, 800,
                  900, 960, 1000, 1024, 1100]

def _counters() -> dict:
    """name -> (module, attribute) of every serving kernel's launch
    count."""
    from flash_attention_tpu_torch.ops import (
        decode, flash, grouped, paged, quant_matmul,
    )

    return {"flash": (flash, "flash_fwd_launches"),
            "paged": (paged, "paged_decode_launches"),
            "decode": (decode, "decode_launches"),
            "quant": (quant_matmul, "quant_matmul_launches"),
            "int4": (quant_matmul, "int4_matmul_launches"),
            "dense": (quant_matmul, "dense_matmul_launches"),
            "grouped": (grouped, "grouped_matmul_launches")}


def reset_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {key: getattr(mod, attr)
            for key, (mod, attr) in _counters().items()}


def teacher_forced(params, cfg, prompts, transcripts, what,
                   mlp=None) -> None:
    """Hold greedy transcripts to a teacher-forced forward with plain
    attention on the dequantized weights (PR 1's band): e = max |bf16 -
    fp32| logit error of that forward over the generated positions; the
    token each transcript chose must have a bf16 plain-forward logit
    within 4e of the max. Each layer is dequantized inside the forward
    (an fp32 copy of the 8B model would take 32 GB) and each sequence
    runs alone (the plain attention of a 4600-token sequence holds 3 GB
    of fp32 scores). `mlp(layer, x, cfg)` replaces the FFN block (the
    plain MoE of the Mixtral phases); the router stays fp32."""
    from flash_attention_tpu_torch.models.llama import (
        _attention_block, _mlp_block, rmsnorm,
    )
    from flash_attention_tpu_torch.models.quantized import (
        EXPERT_STACK_TYPES, QUANT_LEAF_TYPES,
    )
    from flash_attention_tpu_torch.ops.reference import attention_reference

    mlp = mlp or _mlp_block

    def plain_attn(q, k, v):
        return attention_reference(q, k, v, causal=True)

    def dense(name, w, dtype):
        if isinstance(w, QUANT_LEAF_TYPES + EXPERT_STACK_TYPES):
            return w.dequant(dtype)
        return w if name == "router" else w.to(dtype)

    dtypes = (torch.bfloat16, torch.float32)
    dev = params["embed"].device
    seqs = [torch.tensor(list(p) + list(t[:-1]), device=dev)[None]
            for p, t in zip(prompts, transcripts)]
    xs = {dt: [params["embed"][s].to(dt) for s in seqs] for dt in dtypes}
    with torch.no_grad():
        for layer in params["layers"]:
            for dt in dtypes:
                lay = {k: dense(k, w, dt) for k, w in layer.items()}
                for i, s in enumerate(seqs):
                    pos = torch.arange(s.shape[1], dtype=torch.int32,
                                       device=dev)
                    x = xs[dt][i]
                    a, _ = _attention_block(lay, x, cfg, pos,
                                            attn_impl=plain_attn)
                    x = x + a
                    xs[dt][i] = x + mlp(lay, x, cfg)
                del lay
        logits = {}
        for dt in dtypes:
            head = dense("lm_head", params["lm_head"], dt)
            norm = params["final_norm"].to(dt)
            logits[dt] = torch.stack([
                (rmsnorm(x[0, len(p) - 1:len(p) - 1 + len(t)], norm,
                         cfg.norm_eps) @ head).float()
                for x, p, t in zip(xs[dt], prompts, transcripts)])
    lg = logits[torch.bfloat16]
    diff = (lg - logits[torch.float32]).abs()
    err = float(diff.max())
    chosen = torch.tensor([list(t) for t in transcripts], device=dev)
    gaps = (lg.amax(-1) - lg.gather(-1, chosen[..., None])[..., 0]).amax(-1)
    gaps = gaps.tolist()
    agree = float((logits[torch.float32].argmax(-1) == chosen).float().mean())
    delta = 4.0 * err
    log(f"{what}: teacher-forced check: bf16 logit error e={err:.4f} "
        f"(mean {float(diff.mean()):.4f}), delta=4e={delta:.4f}, worst "
        f"chosen-token gap to the max logit per request "
        f"{[round(g, 4) for g in gaps]}; chosen = fp32 argmax at "
        f"{agree:.3f} of positions (reported)")
    if not all(np.isfinite(gaps)) or max(gaps) > delta:
        raise AssertionError(f"{what}: a transcript left the "
                             f"teacher-forced band")


def serve_8b(kind: str) -> dict:
    """Serve 16 greedy requests (prompts of 256-1100 tokens, 32 new
    tokens each) on LlamaConfig.llama3_8b at full width and depth from
    seeded random weights: "int4" and "int8" trees from
    init_quantized_params (drawn on the card), or the "bf16" init_params
    tree as the yardstick (decode tok/s and a profile only). For the
    quantized trees, gate on exact B7 / B6 launches (7 per layer + the
    lm_head per decode step and per prefill bucket of at most 1024 rows;
    1 for the lm_head of a wider prefill), B1 / B4 as in the 1B phase,
    and hold every transcript to the teacher-forced band. int4 also
    profiles 8 decode steps and runs the generate phase."""
    from flash_attention_tpu_torch.models.llama import (
        LlamaConfig, init_params,
    )
    from flash_attention_tpu_torch.models.quantized import (
        init_quantized_params, logical_param_count, params_nbytes,
    )
    from flash_attention_tpu_torch.runtime.engine import (
        Engine, Request, _bucket,
    )

    cfg = LlamaConfig.llama3_8b(dtype=torch.bfloat16)
    what = f"serve8b[{kind}]"
    t0 = time.perf_counter()
    if kind == "bf16":
        params = init_params(cfg, seed=SEED)
    else:
        params = init_quantized_params(
            cfg, SEED, "int4" if kind == "int4" else torch.int8)
    torch.cuda.synchronize()
    log(f"{what}: llama3_8b ({cfg.n_layers} layers, dim {cfg.dim}, "
        f"{cfg.n_heads}q/{cfg.n_kv_heads}kv x {cfg.head_dim}, ffn "
        f"{cfg.ffn_dim}, vocab {cfg.vocab_size}) "
        f"{logical_param_count(params) / 1e9:.3f} B logical params, "
        f"{params_nbytes(params) / 1e9:.3f} GB of weights, seed {SEED}, "
        f"built on the card in {time.perf_counter() - t0:.2f} s")
    eng = Engine(params, cfg, max_batch=16, num_pages=96, page_size=256,
                 tail_size=16, seed=SEED)
    eng.run([Request(prompt=[1, 2, 3], max_new_tokens=2)])    # warm-up
    torch.cuda.synchronize()

    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS_8B]
    reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
    eng.stats = type(eng.stats)()
    reset_counts()
    t0 = time.perf_counter()
    comps = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    st = eng.stats
    log(f"{what}: {len(comps)} completions in {wall:.3f} s; prefill "
        f"{st.prefill_tokens} tokens in {st.prefill_s:.4f} s; decode "
        f"{st.decode_tokens} tokens in {st.decode_steps} steps, "
        f"{st.decode_s:.4f} s = {st.decode_tokens_per_s:.1f} tok/s; "
        f"ttft {st.ttft_percentiles()}; launches {got}")
    out = dict(decode_tok_s=st.decode_tokens_per_s, prefill_s=st.prefill_s,
               ttft=st.ttft_percentiles(), decode_steps=st.decode_steps,
               launches=got)
    if sorted(c.request_id for c in comps) != sorted(
            r.request_id for r in reqs) or any(
            len(c.tokens) != 32 or c.finish_reason != "length"
            for c in comps):
        raise AssertionError(f"{what}: incomplete transcripts")
    if kind != "bf16":
        per = 7 * cfg.n_layers + 1
        small = sum(_bucket(n) <= 1024 for n in PROMPT_LENS_8B)
        want = per * (st.decode_steps + small) + (len(reqs) - small)
        mine, other = (("int4", "quant") if kind == "int4"
                       else ("quant", "int4"))
        want_all = dict(got, **{mine: want, other: 0, "dense": 0,
                                "decode": 0, "grouped": 0,
                                "flash": cfg.n_layers * len(reqs),
                                "paged": cfg.n_layers * st.decode_steps})
        log(f"{what}: want launches {want_all} ({per} per decode step and "
            f"per prefill of at most 1024 rows: {small} prefills, "
            f"{st.decode_steps} steps; 1 per wider prefill)")
        if got != want_all or st.decode_steps == 0:
            raise AssertionError(f"{what}: kernel launch counts off the "
                                 f"serving path")
        by_id = {c.request_id: c for c in comps}
        teacher_forced(params, cfg, prompts,
                       [by_id[r.request_id].tokens for r in reqs], what)
    gc.collect()
    torch.cuda.empty_cache()
    if kind != "int8":
        profile_decode(eng, prompts, Request, f"{kind} 8B decode steps")
    if kind == "int4":
        out["generate"] = generate_8b(params, cfg, eng, Request)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
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
    want = dict(got, decode=cfg.n_layers * steps, int4=per * steps + 1,
                flash=cfg.n_layers, paged=0, quant=0, dense=0, grouped=0)
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
    each) on a Mixtral tree with the Engine (max_batch 8, pages of 256,
    tail 16); `forced` sets FA_TPU_GROUPED_MIN_TOKENS=1 for the run (the
    grouped path at every dispatch, decode included). Gates: exact
    launch counts of B9, B7 / B6, B1 and B4 worked out from the code, and
    every transcript inside the teacher-forced band (plain attention,
    plain dropless MoE, weights dequantized one layer at a time).
    Profiles 8 decode steps. Returns the run's numbers."""
    import os

    from flash_attention_tpu_torch.models.moe import dropless_dispatch_path
    from flash_attention_tpu_torch.runtime.engine import (
        Engine, Request, _bucket,
    )

    what = f"serve_mixtral[{kind}{' forced' if forced else ''}]"
    if forced:
        os.environ["FA_TPU_GROUPED_MIN_TOKENS"] = "1"
    try:
        eng = Engine(params, cfg, max_batch=8, num_pages=96, page_size=256,
                     tail_size=16, seed=SEED)
        eng.run([Request(prompt=[1, 2, 3], max_new_tokens=2)])  # warm-up
        torch.cuda.synchronize()
        rng = np.random.default_rng(SEED + 6)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in PROMPT_LENS_MIXTRAL]
        reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
        eng.stats = type(eng.stats)()
        reset_counts()
        t0 = time.perf_counter()
        comps = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        st = eng.stats
        # The profile below runs more steps on this engine's stats.
        out = dict(decode_tok_s=st.decode_tokens_per_s,
                   prefill_s=st.prefill_s, ttft=st.ttft_percentiles(),
                   decode_steps=st.decode_steps, launches=got)
        buckets = [_bucket(n) for n in PROMPT_LENS_MIXTRAL]
        grouped_prefills = sum(dropless_dispatch_path(b) == "grouped"
                               for b in buckets)
        grouped_steps = (st.decode_steps if dropless_dispatch_path(
            eng.max_batch) == "grouped" else 0)
        log(f"{what}: {len(comps)} completions in {wall:.3f} s; prefill "
            f"{st.prefill_tokens} tokens in {st.prefill_s:.4f} s; decode "
            f"{st.decode_tokens} tokens in {st.decode_steps} steps, "
            f"{st.decode_s:.4f} s = {st.decode_tokens_per_s:.1f} tok/s; "
            f"ttft {st.ttft_percentiles()}; launches {got}")
        if sorted(c.request_id for c in comps) != sorted(
                r.request_id for r in reqs) or any(
                len(c.tokens) != 32 or c.finish_reason != "length"
                for c in comps):
            raise AssertionError(f"{what}: incomplete transcripts")
        n = cfg.n_layers
        per = 4 * n + 1          # wq, wk, wv, wo per layer + the lm_head
        small = sum(b <= 1024 for b in buckets)
        want_q = per * (st.decode_steps + small) + (len(reqs) - small)
        quant = {"int4": ("int4", "quant"), "int8": ("quant", "int4")}
        mine, other = quant.get(kind, ("quant", "int4"))
        want = dict(got, **{mine: want_q if kind in quant else 0, other: 0,
                            "dense": 0, "decode": 0,
                            "grouped": 3 * n * (grouped_prefills
                                                + grouped_steps),
                            "flash": n * len(reqs),
                            "paged": n * st.decode_steps})
        log(f"{what}: want launches {want} (B9 3 per MoE layer per grouped "
            f"dispatch: {grouped_prefills} prefills, {grouped_steps} decode "
            f"steps; B7/B6 {per} per decode step and per prefill of at most "
            f"1024 rows ({small}), 1 per wider prefill)")
        if got != want or st.decode_steps == 0:
            raise AssertionError(f"{what}: kernel launch counts off the "
                                 f"serving path")
        by_id = {c.request_id: c for c in comps}
        out["transcripts"] = [by_id[r.request_id].tokens for r in reqs]
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


def mixtral() -> dict:
    """Phase 9: Mixtral-8x7B (MoEConfig.mixtral_8x7b, dropless routing)
    at full width and depth on int4 and int8 trees from
    init_quantized_moe_params, the int4 tree again with the grouped path
    forced, and a bf16 tree at the one-card depth of 16 layers; between
    the int4 runs the crossover report. Returns each run's numbers."""
    from flash_attention_tpu_torch.models.moe import (
        MoEConfig, init_moe_params,
    )
    from flash_attention_tpu_torch.models.quantized import (
        init_quantized_moe_params, logical_param_count, params_nbytes,
    )

    out = {}
    for kind in ("int4", "int8", "bf16"):
        layers = 16 if kind == "bf16" else None
        cfg = MoEConfig.mixtral_8x7b(
            routing="dropless", dtype=torch.bfloat16,
            **({} if layers is None else {"n_layers": layers}))
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
        key = "bf16_16" if kind == "bf16" else kind
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


# --- phase 6: train ----------------------------------------------------------


class _PlainFlash(torch.autograd.Function):
    """Causal attention through the plain forward and backward versions
    (flash_attention_fwd_plain / flash_attention_bwd_plain) on any
    device: the reference the kernel path is held to."""

    @staticmethod
    def forward(ctx, q, k, v):
        from flash_attention_tpu_torch.ops import flash

        ctx.scale = 1.0 / math.sqrt(q.shape[-1])
        o, lse = flash.flash_attention_fwd_plain(
            q, k, v, causal=True, scale=ctx.scale, offset=0)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        from flash_attention_tpu_torch.ops import flash

        q, k, v, o, lse = ctx.saved_tensors
        return flash.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=True, scale=ctx.scale, offset=0)


def _loss_and_grad_norm(params, tokens, cfg, attn_impl):
    from flash_attention_tpu_torch.models.llama import loss_fn, param_leaves

    leaves = param_leaves(params)
    loss = loss_fn(params, tokens, cfg, remat=True, attn_impl=attn_impl)
    grads = torch.autograd.grad(loss, leaves)
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    return float(loss.detach()), float(norm)


def compare_train_paths(params, cfg, tokens) -> None:
    """One loss and gradient at batch 1 x 2048 through the kernels (B1,
    B2, B3), through the plain versions in bf16, and through the plain
    versions on an fp32 copy of the same weights. The kernel path's loss
    and gradient-norm errors against fp32 must stay within 3x the bf16
    plain path's (floored at one bf16 ulp), the rule the kernels are
    held to one by one."""
    import dataclasses

    from flash_attention_tpu_torch.models.llama import param_leaves

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    lk, gk = _loss_and_grad_norm(params, tokens, cfg, None)
    lp, gp = _loss_and_grad_norm(params, tokens, cfg, _PlainFlash.apply)
    params32 = fp32_copy(params)
    for leaf in param_leaves(params32):
        leaf.requires_grad_(True)
    l32, g32 = _loss_and_grad_norm(params32, tokens, cfg32,
                                   _PlainFlash.apply)
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


def train() -> dict:
    """Train LlamaConfig.llama3_1b at full width and depth (bf16, remat,
    AdamW lr 1e-4 with weight_decay 1e-4 passed explicitly) on a seeded
    token shard read through BatchLoader at batch 4 x 2048: 8 steps on
    one repeated batch, exactly 32 B1 / 16 B2 / 16 B3 launches per step,
    finite and falling loss, then checkpoint and exact resume, then the
    kernel path against the plain path. Returns the launch counts of
    the 8 steps."""
    import functools
    import pathlib
    import tempfile

    from flash_attention_tpu_torch.models.llama import (
        LlamaConfig, param_leaves,
    )
    from flash_attention_tpu_torch.models.trainer import (
        Trainer, TrainerConfig,
    )
    from flash_attention_tpu_torch.ops import flash
    from flash_attention_tpu_torch.utils.data import (
        BatchLoader, TokenShardDataset, write_token_shard,
    )

    cfg = LlamaConfig.llama3_1b(dtype=torch.bfloat16)
    batch, seq, steps = 4, 2048, 8
    opt = functools.partial(torch.optim.AdamW, lr=1e-4, weight_decay=1e-4)
    rng = np.random.default_rng(SEED + 2)
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
        log(f"train: llama3_1b Trainer (bf16 params, remat, AdamW lr 1e-4 "
            f"weight_decay 1e-4) built in {time.perf_counter() - t0:.2f} s;"
            f" batch {batch} x seq {seq} from a seeded token shard via "
            f"BatchLoader")
        torch.cuda.reset_peak_memory_stats()
        flash.flash_fwd_launches = 0
        flash.flash_bwd_dq_launches = 0
        flash.flash_bwd_dkv_launches = 0
        losses, times, per_step = [], [], []
        for _ in range(steps):
            before = (flash.flash_fwd_launches, flash.flash_bwd_dq_launches,
                      flash.flash_bwd_dkv_launches)
            t0 = time.perf_counter()
            loss = tr.train_step(first)
            losses.append(float(loss))          # syncs
            times.append(time.perf_counter() - t0)
            per_step.append(tuple(
                a - b for a, b in zip((flash.flash_fwd_launches,
                                       flash.flash_bwd_dq_launches,
                                       flash.flash_bwd_dkv_launches),
                                      before)))
        launches = {"flash": flash.flash_fwd_launches,
                    "bwd_dq": flash.flash_bwd_dq_launches,
                    "bwd_dkv": flash.flash_bwd_dkv_launches}
        peak = torch.cuda.max_memory_allocated()
        step_s = statistics.median(times[1:])
        log(f"train: losses {[round(x, 4) for x in losses]}")
        log(f"train: {steps} steps, first {times[0] * 1e3:.1f} ms, median "
            f"of the rest {step_s * 1e3:.1f} ms/step = "
            f"{batch * seq / step_s:.0f} tokens/s; peak "
            f"max_memory_allocated {peak / 2**30:.2f} GiB")
        log(f"train: launches per step (B1, B2, B3) {per_step}; want "
            f"({2 * cfg.n_layers}, {cfg.n_layers}, {cfg.n_layers})")
        if any(p != (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
               for p in per_step):
            raise AssertionError("kernel launch counts off the train step")
        if not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError("training loss is not finite and falling")

        tr.save()
        resumed = Trainer(cfg, opt, trainer_cfg=tc, seed=SEED + 1)
        if resumed.step_num != steps:
            raise AssertionError(f"resumed at step {resumed.step_num}")
        same_state = all(
            torch.equal(a, b) for a, b in zip(
                param_leaves(tr.optimizer.state_dict()["state"]),
                param_leaves(resumed.optimizer.state_dict()["state"]),
                strict=True))
        la = float(tr.train_step(second))
        lb = float(resumed.train_step(second))
        # The step after that also reads the restored optimizer state
        # and the first resumed update (shown, not gated).
        la2 = float(tr.train_step(first))
        lb2 = float(resumed.train_step(first))
        log(f"train: checkpoint at step {steps} resumed into a fresh "
            f"Trainer (other init seed): optimizer state identical "
            f"{same_state}; step {steps + 1} loss {la:.6f} vs {lb:.6f}; "
            f"step {steps + 2} loss {la2:.6f} vs {lb2:.6f}")
        if not same_state or la != lb:
            raise AssertionError("resume is not exact")
        del resumed
    profile_train_step(tr, second)
    torch.cuda.empty_cache()
    one = torch.as_tensor(first[:1], device="cuda")
    compare_train_paths(tr.params, cfg, one)
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


MATMUL_KINDS = {"B6 int8": torch.int8, "B6 e4m3": torch.float8_e4m3fn,
                "B6 e5m2": torch.float8_e5m2, "B7 int4": "int4",
                "B8 dense": "dense"}


def check_quant_matmul(flush, results):
    """B6 (int8, e4m3, e5m2), B7 and B8 against their plain versions
    under the low-precision gate at the 8B decode shapes (M = 16) and
    prefill shapes (M = 1024) of w_gate/w_up (4096 x 14336) and w_down
    (14336 x 4096), a ragged shape and fp16; timed at the 8B shapes
    beside their bound, their plain time and torch.matmul on the dense
    bf16 weight of the same shape (the product the quantized weight
    replaces; for B8 the same function)."""
    from flash_attention_tpu_torch.utils.metrics import (
        max_abs_error, verify_low_precision,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    timed = [(16, 4096, 14336), (16, 14336, 4096), (1024, 4096, 14336),
             (1024, 14336, 4096)]
    for label, kind in MATMUL_KINDS.items():
        fn, plain, cost = _matmul_fns(kind)
        ragged = (3, 384, 257) if kind == "int4" else (3, 130, 257)
        cases = [(m, k, f, torch.bfloat16) for m, k, f in timed] + [
            (*ragged, torch.bfloat16), (16, 512, 384, torch.float16)]
        rows = []
        for m, k, f, dt in cases:
            args, wdense = rand_weight(kind, k, f, gen)
            if kind == "dense":
                args = (args[0].to(dt),)
            x = (torch.randn((m, k), generator=gen, device="cuda")).to(dt)
            got = fn(x, *args)
            torch.cuda.synchronize()
            lo = plain(x, *args)
            hi = plain(x.float(), *((args[0].float(),) if kind == "dense"
                                    else args))
            ok, kerr, berr = verify_low_precision(got, hi, lo)
            finite = bool(torch.isfinite(got.float()).all())
            log(f"check {label} {m}x{k}x{f} {dt}: kernel_err={kerr:.3e} "
                f"plain_err={berr:.3e} finite={finite}")
            if not (ok and finite):
                raise AssertionError(f"{label} failed its gate at "
                                     f"{m}x{k}x{f} {dt}")
            if (m, k, f) not in timed:
                continue
            wd = wdense.to(dt)
            ms = time_ms(lambda: fn(x, *args), flush)
            plain_ms = time_ms(lambda: plain(x, *args), flush)
            lib_ms = time_ms(lambda: torch.matmul(x, wd), flush)
            flops, nbytes = cost(m, k, f)
            bms, by = bound_ms(flops, nbytes)
            log(f"time  {label} {m}x{k}x{f}: kernel_ms={ms:.4f} plain_ms="
                f"{plain_ms:.4f} library_ms={lib_ms:.4f} (torch.matmul, "
                f"dense bf16 weight) bound_ms={bms:.4f} ({by}) achieved="
                f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s "
                f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
            rows.append(dict(shape=f"x({m},{k}) w({k},{f}) bf16 x",
                             max_abs_err=max_abs_error(got, lo), ms=ms,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                             library_ms=lib_ms))
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
    """torch._grouped_mm on the dense bf16 stack with the same int32
    offsets: the library yardstick, timed only (never called by the
    port). Returns (ms or None, what was timed or why not)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch._grouped_mm is absent from this torch"
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    try:
        fn(x, w, offs=offs)
        torch.cuda.synchronize()
    except RuntimeError as exc:
        return None, f"torch._grouped_mm refused: {str(exc)[:200]}"
    return (time_ms(lambda: fn(x, w, offs=offs), flush),
            "torch._grouped_mm, dense bf16 stack")


def check_grouped(flush, results):
    """B9 on every storage (dense bf16, int8, e4m3, e5m2, int4) against
    its plain version under the low-precision gate, at Mixtral's w_gate
    (K 4096, F 14336) and w_down (K 14336, F 4096) with M = 16 (a forced
    decode step: batch 8 x top-2) and M = 8192 (a 4096-token prefill
    bucket x top-2) expert-sorted rows over 8 experts, group sizes
    skewed from the seed with one empty expert; plus a ragged shape, a
    band with base > 0 and rows past the data (which must come back
    exactly zero), and fp16. The Mixtral shapes are timed beside their
    bound, the plain version and torch._grouped_mm on the dense bf16
    stack of the same shape."""
    from flash_attention_tpu_torch.ops.grouped import grouped_cost
    from flash_attention_tpu_torch.utils.metrics import (
        max_abs_error, verify_low_precision,
    )

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
        cases = [(m, k, f, torch.bfloat16, 0, m) for m, k, f in timed] + [
            (*ragged, torch.bfloat16, 0, 100),
            (200, 256, 192, torch.bfloat16, 37, 120),
            (64, 512, 384, torch.float16, 0, 64)]
        rows = []
        for m, k, f, dt, base, live in cases:
            args = rand_stack(kind, e, k, f, gen)
            if kind == "dense":
                args = (args[0].to(dt),)
            x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
            sizes = skewed_sizes(rng, live, e)
            got = fn(x, sizes, *args, base=base)
            torch.cuda.synchronize()
            lo = plain(x, sizes, *args, base=base)
            hi = plain(x.float(), sizes,
                       *((args[0].float(),) if kind == "dense" else args),
                       base=base)
            ok, kerr, berr = verify_low_precision(got, hi, lo)
            finite = bool(torch.isfinite(got.float()).all())
            dead = bool((got[:base] == 0).all()) and bool(
                (got[base + live:] == 0).all())
            log(f"check {label} {m}x{k}x{f} {dt} sizes "
                f"{sizes.tolist()} base {base}: kernel_err={kerr:.3e} "
                f"plain_err={berr:.3e} finite={finite} "
                f"rows_outside_zero={dead}")
            if not (ok and finite and dead):
                raise AssertionError(f"{label} failed its gate at "
                                     f"{m}x{k}x{f} {dt} base {base}")
            if (m, k, f) not in timed:
                continue
            ms = time_ms(lambda: fn(x, sizes, *args), flush)
            plain_ms = time_ms(lambda: plain(x, sizes, *args), flush)
            if kind == "dense":
                library[(m, k, f)] = library_grouped(x, sizes, args[0],
                                                     flush)
            lib_ms, lib_what = library[(m, k, f)]
            flops, nbytes = grouped_cost(m, k, f, int((sizes > 0).sum()),
                                         storage)
            bms, by = bound_ms(flops, nbytes)
            log(f"time  {label} {m}x{k}x{f}: kernel_ms={ms:.4f} plain_ms="
                f"{plain_ms:.4f} library_ms={lib_ms} ({lib_what}) "
                f"bound_ms={bms:.4f} ({by}) achieved="
                f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s "
                f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
            rows.append(dict(shape=f"x({m},{k}) w({e},{k},{f}) bf16 x, "
                                   f"sizes {sizes.tolist()}",
                             max_abs_err=max_abs_error(got, lo), ms=ms,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                             library_ms=lib_ms, library=lib_what))
            del args, x, got, lo, hi
        results[label] = rows
        torch.cuda.empty_cache()


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
            f"dead_rows_zero={dead_ok}")
        if not (ok and dead_ok and bool(torch.isfinite(o.float()).all())):
            raise AssertionError("B5 decode failed its gate")
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


def check_kernels() -> dict:
    flush = L2Flush()
    rng = np.random.default_rng(SEED)
    results: dict = {}
    check_flash(rng, flush, results)
    torch.cuda.synchronize()
    check_paged(rng, flush, results)
    torch.cuda.synchronize()
    check_flash_bwd(rng, flush, results)
    torch.cuda.synchronize()
    check_variants(rng)
    check_decode(rng, flush, results)
    torch.cuda.synchronize()
    check_quant_matmul(flush, results)
    torch.cuda.synchronize()
    check_grouped(flush, results)
    torch.cuda.synchronize()
    return results


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
    secs = _cuda.build(verbose=True)
    log(f"build: kernels built in {secs:.2f} s "
        f"(phase {time.perf_counter() - t0:.2f} s)")
    results = check_kernels()
    launches = serve()
    torch.cuda.synchronize()
    trained = train()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    q8 = {kind: serve_8b(kind) for kind in ("int4", "int8", "bf16")}
    log(f"serve8b: decode tok/s at batch 16 -- int4 "
        f"{q8['int4']['decode_tok_s']:.1f}, int8 "
        f"{q8['int8']['decode_tok_s']:.1f}, bf16 (cuBLAS yardstick) "
        f"{q8['bf16']['decode_tok_s']:.1f}")
    l4, l8 = q8["int4"]["launches"], q8["int8"]["launches"]
    lg = q8["int4"]["generate"]["launches"]
    mix = mixtral()
    log(f"mixtral: decode tok/s at batch 8 -- int4 "
        f"{mix['int4']['decode_tok_s']:.1f}, int8 "
        f"{mix['int8']['decode_tok_s']:.1f}, int4 forced-grouped "
        f"{mix['int4_forced']['decode_tok_s']:.1f}, bf16 16 layers "
        f"{mix['bf16_16']['decode_tok_s']:.1f}")
    mpaths = {"serve_mixtral_int4": mix["int4"]["launches"],
              "serve_mixtral_int8": mix["int8"]["launches"],
              "serve_mixtral_int4_forced": mix["int4_forced"]["launches"],
              "serve_mixtral16_bf16": mix["bf16_16"]["launches"]}

    def mix_by_path(key):
        return {path: got[key] for path, got in mpaths.items()}

    def matmul_entry(label, **extra):
        rows = results[label]
        return dict(rows[0], at_shapes=rows[1:], **extra)

    kernels = [
        dict(name="flash_fwd (B1)", route="cuda",
             source="flash_attention_tpu_torch/csrc/flash_fwd.cu",
             replaces="flash_attention_tpu/ops/flash.py:259",
             launches=launches["flash"] + trained["flash"] + l4["flash"]
             + l8["flash"] + lg["flash"]
             + sum(mix_by_path("flash").values()),
             launches_by_path={"serve_1b": launches["flash"],
                               "train_1b": trained["flash"],
                               "serve_8b_int4": l4["flash"],
                               "serve_8b_int8": l8["flash"],
                               "generate_8b_int4": lg["flash"],
                               **mix_by_path("flash")},
             **results[("flash", 512)],
             at_train_shape=results["flash_train"]),
        dict(name="flash_bwd_dq (B2)", route="cuda",
             source="flash_attention_tpu_torch/csrc/flash_bwd.cu",
             replaces="flash_attention_tpu/ops/flash.py:716",
             launches=trained["bwd_dq"], **results["bwd_dq"]),
        dict(name="flash_bwd_dkv (B3)", route="cuda",
             source="flash_attention_tpu_torch/csrc/flash_bwd.cu",
             replaces="flash_attention_tpu/ops/flash.py:773",
             launches=trained["bwd_dkv"], **results["bwd_dkv"]),
        dict(name="paged_decode (B4)", route="cuda",
             source="flash_attention_tpu_torch/csrc/paged_decode.cu",
             replaces="flash_attention_tpu/ops/paged.py:37",
             launches=launches["paged"] + l4["paged"] + l8["paged"]
             + sum(mix_by_path("paged").values()),
             launches_by_path={"serve_1b": launches["paged"],
                               "serve_8b_int4": l4["paged"],
                               "serve_8b_int8": l8["paged"],
                               **mix_by_path("paged")},
             **results["paged"]),
        dict(name="decode (B5)", route="cuda",
             source="flash_attention_tpu_torch/csrc/decode.cu",
             replaces="flash_attention_tpu/ops/decode.py:71",
             launches=lg["decode"],
             launches_by_path={"generate_8b_int4": lg["decode"]},
             **results["decode"]),
        matmul_entry("B6 int8", name="quant_matmul (B6)", route="cuda",
                     source="flash_attention_tpu_torch/csrc/quant_matmul.cu",
                     replaces="flash_attention_tpu/ops/quant_matmul.py:41",
                     launches=l8["quant"]
                     + mpaths["serve_mixtral_int8"]["quant"],
                     launches_by_path={
                         "serve_8b_int8": l8["quant"],
                         "serve_mixtral_int8":
                             mpaths["serve_mixtral_int8"]["quant"]},
                     fp8=dict(e4m3=results["B6 e4m3"],
                              e5m2=results["B6 e5m2"])),
        matmul_entry("B7 int4", name="int4_matmul (B7)", route="cuda",
                     source="flash_attention_tpu_torch/csrc/quant_matmul.cu",
                     replaces="flash_attention_tpu/ops/quant_matmul.py:214",
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
                     source="flash_attention_tpu_torch/csrc/quant_matmul.cu",
                     replaces="flash_attention_tpu/ops/quant_matmul.py:141",
                     launches=launches["dense"],
                     launches_by_path={"prefill_1b_dense_pallas_mm":
                                       launches["dense"]}),
        # Headline: int4 at the 4096-token prefill bucket (8192 sorted
        # rows) of w_gate, where B9 runs on the default path.
        dict(name="grouped_matmul (B9)", route="cuda",
             source="flash_attention_tpu_torch/csrc/grouped_matmul.cu",
             replaces="flash_attention_tpu/ops/grouped.py:132",
             launches=sum(mix_by_path("grouped").values()),
             launches_by_path=mix_by_path("grouped"),
             **results["B9 int4"][2],
             at_shapes={label: results[label] for label in GROUPED_KINDS},
             crossover=mix["crossover"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
