"""Command-line harness of the port: verify-then-benchmark, N-way
compare, perf-only, max-batch, profile (port of
`flash_attention_tpu/cli.py`).

  * `verify`  — positional config `B H N D M runs` with the reference's
    defaults (1 8 512 64 4096 50): the FA1 kernel (B10a) under the tile
    law of budget M against the exact two-pass baseline with the 2%
    gate, then both timed.
  * `compare` — every study implementation (ops/dispatch.py) on the same
    seeded input, all pairs cross-checked, a perf + accuracy verdict; a
    failing implementation is recorded and the study goes on.
  * `perf`    — the flagship (B1) timed with the analytic models only;
    `--bwd` adds the forward + backward step (B1, B2, B3).
  * `max-batch`, `profile` — OOM search; analytic FLOPs and bytes with a
    torch.profiler table of device time by kernel.

Every subcommand takes `--device` (default `cuda`: the card, or an
error when there is none; `cpu` runs the plain PyTorch versions). Times
come from CUDA events on the card.

Usage:
    python -m flash_attention_tpu_torch.cli verify 1 8 512 64 4096 50
    python -m flash_attention_tpu_torch.cli compare --configs 1,32,8192,128
    python -m flash_attention_tpu_torch.cli perf --configs 1,32,8192,128 --causal
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import sys

import numpy as np
import torch


def _make_inputs(batch, heads, seq, head_dim, dtype_name, seed=42,
                 kv_heads=None, device="cpu"):
    """q, k, v ~ N(0, 0.02^2) from np.random.default_rng(seed): the same
    draws, in the same order and rounding, as the JAX CLI's (numpy
    rounds the float64 draws to fp32 / fp16 as jnp.asarray does; bf16,
    which numpy lacks, rounds in torch to the same values)."""
    rng = np.random.default_rng(seed)
    kv_heads = kv_heads or heads
    dt = getattr(torch, dtype_name)
    np_dt = {torch.float32: np.float32, torch.float16: np.float16}.get(dt)

    def draw(shape):
        x = rng.normal(0, 0.02, shape)
        if np_dt is not None:
            x = x.astype(np_dt)
        return torch.from_numpy(x).to(device, dt)

    return (draw((batch, heads, seq, head_dim)),
            draw((batch, kv_heads, seq, head_dim)),
            draw((batch, kv_heads, seq, head_dim)))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _maybe_profile(profile_dir, device):
    """torch.profiler over the block, its chrome trace written under
    `profile_dir` (nothing when it is None)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        _sync(device)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def _device(args):
    from flash_attention_tpu_torch.config import resolve_device
    return resolve_device(args.device)


def _banner(device):
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (plain PyTorch versions)")
    print(f"Device: {kind} ({device.type})")


def cmd_verify(args):
    """Verify-then-benchmark (the reference's main program)."""
    from flash_attention_tpu_torch.ops.reference import attention_baseline
    from flash_attention_tpu_torch.ops.variants import (
        fa1_kernel_tile, fa1_tile_sizes, flash_attention_fa1,
    )
    from flash_attention_tpu_torch.utils.bench import bench_attention
    from flash_attention_tpu_torch.utils.metrics import verify

    device = _device(args)
    b, h, n, d, m, runs = (args.B, args.H, args.N, args.D, args.M, args.runs)
    dtype = getattr(torch, args.dtype)
    jbr, jbc = fa1_tile_sizes(m, d)
    br, bc = fa1_kernel_tile(m, d, dtype)
    print(f"Config: B={b} H={h} N={n} d={d} M={m} runs={runs}")
    print(f"FA1 tile law -> Br={jbr} Bc={jbc} (JAX, lane-aligned); "
          f"kernel tile Br={br} Bc={bc}")
    q, k, v = _make_inputs(b, h, n, d, args.dtype, device=device)

    # The M knob drives the FA1 kernel's tiles, as the reference's CLI
    # does: the verified and benchmarked candidate is the FA1 kernel
    # under that budget.
    def fa1(q, k, v):
        return flash_attention_fa1(q, k, v, m_budget=m)[0]

    report = verify(fa1(q, k, v), attention_baseline(q, k, v))
    print(report)
    if not report.passed:
        print("VERIFICATION FAILED")
        return 1
    with _maybe_profile(args.profile, device):
        base = bench_attention("attention_baseline", attention_baseline,
                               q, k, v, warmup=5, iters=max(2, runs // 10))
        flash = bench_attention(f"fa1[M={m}]", fa1, q, k, v, warmup=5,
                                iters=max(2, runs // 10))
    for r in (base, flash):
        print(r.line())
    print(f"speedup: {base.timing.mean_s / flash.timing.mean_s:.2f}x")
    return 0


def _study_outputs(causal):
    from flash_attention_tpu_torch.ops.dispatch import (
        CAUSAL_CAPABLE, IMPLEMENTATIONS,
    )
    outs = {}
    for name, impl in IMPLEMENTATIONS.items():
        if name == "reference_exact":
            continue  # baseline_xla already covers the exact role
        if causal and name not in CAUSAL_CAPABLE:
            continue
        outs[name] = (impl, {"causal": True} if causal else {})
    return outs


def compare_config(cfg, *, dtype, causal, warmup, iters, device,
                   profile=None) -> dict:
    """One config of `compare`: every study implementation timed on the
    same seeded input, then all pairs cross-checked. Returns
    {"config", "dtype", "causal", "reports" (BenchReport list),
    "failures" ({name: (kind, exception type, first line)}), "checks"
    ({(a, b): VerifyReport})}.
    An implementation that raises is recorded (kind "OOM" for
    torch.cuda.OutOfMemoryError, else "ERROR") and the others go on."""
    from flash_attention_tpu_torch.utils.bench import bench_attention
    from flash_attention_tpu_torch.utils.metrics import cross_check

    b, h, n, d = cfg
    q, k, v = _make_inputs(b, h, n, d, dtype, device=device)
    outs, reports, failures = {}, [], {}
    with _maybe_profile(profile, device):
        for name, (impl, kw) in _study_outputs(causal).items():
            fn = functools.partial(impl, **kw)
            try:
                reports.append(bench_attention(
                    name, fn, q, k, v, causal=causal, warmup=warmup,
                    iters=iters))
                outs[name] = fn(q, k, v)
            except torch.cuda.OutOfMemoryError as e:
                failures[name] = ("OOM", type(e).__name__,
                                  str(e).splitlines()[0][:120])
                outs.pop(name, None)
                torch.cuda.empty_cache()
            except Exception as e:  # recorded, the study goes on
                failures[name] = ("ERROR", type(e).__name__,
                                  str(e).splitlines()[0][:120])
    _sync(device)
    return dict(config=cfg, dtype=dtype, causal=causal, reports=reports,
                failures=failures, checks=cross_check(outs))


def cmd_compare(args):
    """N-way comparison test (the reference's test program)."""
    device = _device(args)
    _banner(device)
    exit_code = 0
    for cfg in args.configs:
        b, h, n, d = cfg
        print(f"\n=== Config B={b} H={h} N={n} D={d} "
              f"dtype={args.dtype} causal={args.causal} ===")
        res = compare_config(cfg, dtype=args.dtype, causal=args.causal,
                             warmup=args.warmup, iters=args.iters,
                             device=device, profile=args.profile)
        for rep in res["reports"]:
            print(rep.line())
        for name, (kind, exc, msg) in res["failures"].items():
            print(f"{name:24s} {kind}: {exc}: {msg}")
        ok = True
        for (a, bname), r in res["checks"].items():
            status = "PASS" if r.passed else "FAIL"
            print(f"  {a:14s} vs {bname:14s}: max_rel="
                  f"{r.max_rel_err:.6f} [{status}]")
            ok &= r.passed
        print("accuracy verdict:", "ALL PASS" if ok else "FAILURES")
        if not ok:
            exit_code = 1
    return exit_code


def _fwd_bwd(q, k, v, causal):
    """One forward and backward of sum(o^2) through flash_attention."""
    from flash_attention_tpu_torch.ops.flash import flash_attention

    o = flash_attention(q, k, v, causal=causal)
    return torch.autograd.grad(o.float().square().sum(), (q, k, v))


def cmd_perf(args):
    """Perf-only benchmark; --bwd adds the fwd+bwd step with the 3.5x
    FLOPs model of a recompute backward (fwd 2 matmuls + bwd 5)."""
    from flash_attention_tpu_torch.ops.flash import flash_attention
    from flash_attention_tpu_torch.utils.bench import (
        attention_flops, bench_attention, measure, peak_memory_bytes,
    )

    device = _device(args)
    for cfg in args.configs:
        b, h, n, d = cfg
        q, k, v = _make_inputs(b, h, n, d, args.dtype,
                               kv_heads=args.kv_heads, device=device)
        with _maybe_profile(args.profile, device):
            rep = bench_attention(
                f"flash[{b},{h},{n},{d}]",
                functools.partial(flash_attention, causal=args.causal),
                q, k, v, causal=args.causal, warmup=args.warmup,
                iters=args.iters)
        print(rep.line())
        if args.bwd:
            grads = [x.detach().requires_grad_() for x in (q, k, v)]
            t = measure(_fwd_bwd, *grads, args.causal, warmup=args.warmup,
                        iters=args.iters)
            total = attention_flops(b, h, n, n, d, args.causal) * 3.5
            print(f"{'flash fwd+bwd':24s} {t.mean_ms:10.3f} ms "
                  f"{total / t.mean_s / 1e12:8.2f} TFLOP/s")
        peak = peak_memory_bytes(device) if device.type == "cuda" else None
        if peak:
            print(f"{'peak hbm':24s} {peak / 1e9:10.2f} GB")
    return 0


def cmd_max_batch(args):
    """Max-batch OOM search: exponential growth + binary search of the
    largest batch whose fwd (or fwd+bwd) fits the card's memory."""
    from flash_attention_tpu_torch.ops.flash import flash_attention
    from flash_attention_tpu_torch.utils.bench import find_max_batch

    device = _device(args)
    _, h, n, d = args.config

    def probe(batch):
        q, k, v = _make_inputs(batch, h, n, d, args.dtype, device=device)
        if args.bwd:
            _fwd_bwd(*(x.requires_grad_() for x in (q, k, v)), args.causal)
        else:
            flash_attention(q, k, v, causal=args.causal)
        _sync(device)

    best = find_max_batch(probe, limit=args.limit)
    mode = "fwd+bwd" if args.bwd else "fwd"
    print(f"max batch ({mode}, H={h} N={n} D={d} {args.dtype}): {best}")
    return 0


def cmd_profile(args):
    """Profile of the flagship kernel (B1): the analytic FLOPs and bytes
    (an eager program has no compiler cost analysis), a torch.profiler
    table of device time by kernel, and utilization against a peak."""
    from torch.profiler import ProfilerActivity, profile

    from flash_attention_tpu_torch.ops.flash import flash_attention
    from flash_attention_tpu_torch.utils.bench import (
        attention_flops, attention_hbm_bytes, bench_attention,
    )

    device = _device(args)
    b, h, n, d = args.config
    q, k, v = _make_inputs(b, h, n, d, args.dtype, device=device)
    _banner(device)
    print(f"profile: config B={b} H={h} N={n} D={d} dtype={args.dtype} "
          f"causal={args.causal}")
    fn = functools.partial(flash_attention, causal=args.causal)
    flops = attention_flops(b, h, n, n, d, args.causal)
    print("\n== analytic model ==")
    print(f"  {'flops':28s} {flops:,}")
    print(f"  {'hbm bytes (min)':28s} "
          f"{attention_hbm_bytes(b, h, h, n, n, d, q.element_size()):,}")
    fn(q, k, v)
    _sync(device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(args.iters):
            fn(q, k, v)
        _sync(device)
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, evt.count, evt.key))
    print("== device time by kernel ==")
    if not rows:
        print("  not measured (no device time recorded)")
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {dev_us / 1e3 / args.iters:10.4f} ms/call "
              f"{count // args.iters:4d} launches/call  {key[:80]}")
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        print(f"  trace written under {args.profile}")
    rep = bench_attention("flash", fn, q, k, v, causal=args.causal,
                          warmup=args.warmup, iters=args.iters)
    print("\n== measured ==")
    print(rep.line())
    if args.peak_tflops and device.type == "cuda":
        print(f"  utilization vs peak ({args.peak_tflops} TFLOP/s): "
              f"{100 * rep.tflops_per_s / args.peak_tflops:.1f}%")
    return 0


def _unported(name):
    def cmd(args):
        raise NotImplementedError(
            f"{name} is not ported yet: it arrives with the tooling "
            "slice (ROADMAP.md §A item 6)")
    return cmd


def _parse_configs(values):
    out = []
    for s in values:
        parts = [int(x) for x in s.split(",")]
        if len(parts) != 4:
            raise argparse.ArgumentTypeError(f"config must be B,H,N,D: {s}")
        out.append(tuple(parts))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="flash_attention_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, fn, help_):
        sp = sub.add_parser(name, help=help_)
        sp.add_argument("--device", default="cuda",
                        help="cuda (the card) or cpu (plain versions)")
        sp.set_defaults(fn=fn)
        return sp

    pv = add("verify", cmd_verify, "verify then benchmark")
    # The reference's defaults: B=1 H=8 N=512 d=64 M=4096 runs=50.
    pv.add_argument("B", nargs="?", type=int, default=1)
    pv.add_argument("H", nargs="?", type=int, default=8)
    pv.add_argument("N", nargs="?", type=int, default=512)
    pv.add_argument("D", nargs="?", type=int, default=64)
    pv.add_argument("M", nargs="?", type=int, default=4096)
    pv.add_argument("runs", nargs="?", type=int, default=50)
    pv.add_argument("--dtype", default="float32")
    pv.add_argument("--profile", default=None)

    pc = add("compare", cmd_compare, "N-way study comparison")
    pc.add_argument("--configs", nargs="+", default=["1,8,2048,128"])
    pc.add_argument("--dtype", default="bfloat16")
    pc.add_argument("--causal", action="store_true")
    pc.add_argument("--warmup", type=int, default=3)
    pc.add_argument("--iters", type=int, default=5)
    pc.add_argument("--profile", default=None)

    pp = add("perf", cmd_perf, "perf-only benchmark")
    pp.add_argument("--configs", nargs="+",
                    default=["1,32,8192,128", "1,64,8192,128"])
    pp.add_argument("--dtype", default="bfloat16")
    pp.add_argument("--kv-heads", type=int, default=None,
                    help="GQA: number of KV heads (default = q heads)")
    pp.add_argument("--causal", action="store_true")
    pp.add_argument("--warmup", type=int, default=3)
    pp.add_argument("--iters", type=int, default=5)
    pp.add_argument("--profile", default=None)
    pp.add_argument("--bwd", action="store_true",
                    help="also time the fwd+bwd step")

    pm = add("max-batch", cmd_max_batch, "OOM binary search over batch")
    pm.add_argument("--config", default="1,32,8192,128")
    pm.add_argument("--dtype", default="bfloat16")
    pm.add_argument("--causal", action="store_true")
    pm.add_argument("--bwd", action="store_true")
    pm.add_argument("--limit", type=int, default=4096)

    for name, help_ in (
            ("decode-bench", "paged decode kernel / model tokens-per-s"),
            ("moe-bench", "grouped vs one-hot expert MLP throughput"),
            ("train-bench", "train-step tokens/s + MFU on one card"),
            ("serve-bench", "engine end-to-end tokens/s")):
        add(name, _unported(name), help_ + " (not ported yet)")

    pf = add("profile", cmd_profile, "analytic model + profiler table")
    pf.add_argument("--config", default="1,32,8192,128")
    pf.add_argument("--dtype", default="bfloat16")
    pf.add_argument("--causal", action="store_true")
    pf.add_argument("--peak-tflops", type=float, default=989.0,
                    help="card peak for utilization (H100 SXM bf16 989)")
    pf.add_argument("--warmup", type=int, default=3)
    pf.add_argument("--iters", type=int, default=5)
    pf.add_argument("--profile", default=None,
                    help="directory for a chrome trace")

    args = p.parse_args(argv)
    try:
        if hasattr(args, "configs"):
            args.configs = _parse_configs(args.configs)
        if hasattr(args, "config"):
            args.config = _parse_configs([args.config])[0]
    except (argparse.ArgumentTypeError, ValueError) as e:
        p.error(str(e))            # clean usage error, exit 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
