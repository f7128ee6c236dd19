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
             the kernel path held to the plain path.

Prints information lines, then one JSON line describing the kernels,
then the card's name and power limit, and last one JSON line
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
no CUDA device is present or any phase fails.
"""

from __future__ import annotations

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
    del params32
    profile_decode(eng, prompts, Request)
    return launches


def profile_decode(eng, prompts, request_cls) -> None:
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
    report_profile(prof, wall, steps, "decode steps")


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
    kernels = [
        dict(name="flash_fwd (B1)", route="cuda",
             source="flash_attention_tpu_torch/csrc/flash_fwd.cu",
             replaces="flash_attention_tpu/ops/flash.py:259",
             launches=launches["flash"] + trained["flash"],
             launches_by_path={"serve": launches["flash"],
                               "train": trained["flash"]},
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
             launches=launches["paged"], **results["paged"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
