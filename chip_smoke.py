#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flash_attention_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   compile the port's CUDA kernels (csrc/*.cu) and the native
             page allocator from the sources in this checkout;
  2. check   hold each kernel against its plain PyTorch version on the
             card in bf16 at the serving shapes, and in fp16/bf16 at small
             shapes for its other instantiations (the low-precision gate:
             kernel error <= 3x the plain version's error in the same
             dtype against an fp32 reference, LSE within 1e-3);
  3. time    each kernel, its plain version and (where one exists) the
             one PyTorch call that computes the same function, with CUDA
             events; the bound is the larger of bytes / 3.35 TB/s and
             FLOPs / 989 TFLOP/s (H100 SXM data sheet);
  4. serve   the continuous-batching Engine on LlamaConfig.llama3_1b at
             full width and depth from seeded random weights, counting
             kernel launches, and hold every greedy transcript to a
             teacher-forced forward with plain attention;
  5. profile a few decode steps of the same engine with torch.profiler:
             device time by kernel and the device's busy share.

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
    params32 = {
        "embed": params["embed"].float(),
        "lm_head": params["lm_head"].float(),
        "final_norm": params["final_norm"].float(),
        "layers": [{k: w.float() for k, w in layer.items()}
                   for layer in params["layers"]],
    }

    def plain_attn(q, k, v):
        return attention_reference(q, k, v, causal=True)

    by_id = {c.request_id: c for c in comps}
    err, gaps = 0.0, []
    for req in reqs:
        c = by_id[req.request_id]
        t = len(req.prompt)
        toks = torch.tensor(req.prompt + c.tokens[:-1], device="cuda")[None]
        lg = forward(params, toks, cfg, attn_impl=plain_attn)[0, t - 1:]
        lg32 = forward(params32, toks, cfg32, attn_impl=plain_attn)[0, t - 1:]
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
    rows = []
    for evt in prof.key_averages():
        # Kernel events only: CPU-side ops also carry the device time of
        # the kernels they launched, which would count it twice.
        if evt.device_type != torch.autograd.DeviceType.CUDA:
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
    log(f"profile: {steps} decode steps, wall {wall * 1e3 / steps:.3f} "
        f"ms/step, device busy {busy_us / 1e3 / steps:.3f} ms/step = "
        f"{busy_us / 1e6 / wall:.3f} of wall")
    for dev_us, key, count in rows[:10]:
        log(f"profile:   {dev_us / 1e3 / steps:8.4f} ms/step  "
            f"{count // steps:5d} launches/step  {key[:90]}")


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


def check_kernels() -> dict:
    flush = L2Flush()
    rng = np.random.default_rng(SEED)
    results: dict = {}
    check_flash(rng, flush, results)
    torch.cuda.synchronize()
    check_paged(rng, flush, results)
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
    kernels = [
        dict(name="flash_fwd (B1)", route="cuda",
             source="flash_attention_tpu_torch/csrc/flash_fwd.cu",
             replaces="flash_attention_tpu/ops/flash.py:259",
             launches=launches["flash"], **results[("flash", 512)]),
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
