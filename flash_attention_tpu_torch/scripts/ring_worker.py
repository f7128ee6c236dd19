"""Ring-attention worker: one rank of a sequence-parallel run.

    python -m flash_attention_tpu_torch.scripts.launch_multihost \\
        --simulate N --device cpu -- \\
        -m flash_attention_tpu_torch.scripts.ring_worker CASES OUT \\
        [--backend gloo]

CASES is a `torch.save`d dict {"cases": [case, ...]}; every rank reads
it, runs each case on its own device with its own chunks, and rank 0
gathers the results and writes them to OUT ({"cases": {name: result},
"world": N, "backend": ..., "device": ...}). The device comes from
FA_TPU_DEVICE (the launcher's `--device`), `--backend` names a
backend other than the device's default (gloo over card tensors: every
rotation staged through host memory).

An "attn" case holds GLOBAL q, k, v [B, H, N, D] in the layout the ring
expects (zigzag-ordered for layout "zigzag"), optionally a cotangent
"do" and segment ids "seg" [B, N], and causal / layout / window, "dp"
and "sp" (a mesh of dp x sp ranks, qkv_spec ("dp", None, "sp", None)).
Rank (i, j) of the mesh takes batch rows i and sequence chunk j, runs
`make_ring_attention` forward (and backward with "do"), and its chunks
of o, dq, dk, dv come back assembled into global tensors (dk / dv: the
sequence chunks of each kv chunk's owner). Each rank's launches of B1,
B2 and B3 in the case and its seconds of forward + backward come back
per rank; "repeat" > 0 runs the case that many more times and adds the
median of their seconds ("repeat_seconds"). `--start-after FILE` holds
the ranks, once joined and with their meshes made, until FILE exists,
so a caller can start them early and keep its own device work out of
their times; `--warmup` then runs every case once (neither counted nor
timed) before the counted runs.

A "llama" case holds "cfg" (LlamaConfig keyword arguments, "dtype" a
torch dtype name), "seed" and GLOBAL "tokens" [B, T + 1]: each rank runs
the model's forward on its contiguous chunk of T tokens (global
positions) with the ring as `attn_impl`, takes the mean next-token
cross-entropy over its chunk and the gradients of every parameter; the
loss and gradients averaged over the ranks (equal chunks: the global
mean's) come back as "loss" and "grads" (`param_leaves` order).
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from flash_attention_tpu_torch.ops import flash
from flash_attention_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
)
from flash_attention_tpu_torch.parallel.ring import make_ring_attention

COUNTERS = {"B1": "flash_fwd_launches", "B2": "flash_bwd_dq_launches",
            "B3": "flash_bwd_dkv_launches"}


def _counts() -> dict:
    return {k: getattr(flash, attr) for k, attr in COUNTERS.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _attn_run(case, mesh, device):
    """One forward (+ backward) of an attn case on this rank's chunks;
    returns (local outputs, the slices they fill)."""
    dp, sp = case.get("dp", 1), case["sp"]
    i, j = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    b, n = case["q"].shape[0], case["q"].shape[2]
    bs, cs = slice(i * (b // dp), (i + 1) * (b // dp)), \
        slice(j * (n // sp), (j + 1) * (n // sp))

    def local(x):
        return x[bs, :, cs].contiguous().to(device)

    grads = case.get("do") is not None
    q, k, v = (local(case[x]).requires_grad_(grads) for x in "qkv")
    fn = make_ring_attention(
        mesh, causal=case.get("causal", False),
        layout=case.get("layout", "contiguous"), window=case.get("window"),
        segmented=case.get("seg") is not None,
        qkv_spec=("dp", None, "sp", None))
    args = (q, k, v)
    if case.get("seg") is not None:
        ids = case["seg"][bs, cs].contiguous().to(device)
        args += (flash.SegmentIds(ids, ids),)
    out = {}
    if grads:
        o = fn(*args)
        out["dq"], out["dk"], out["dv"] = torch.autograd.grad(
            o, (q, k, v), local(case["do"]))
        out["o"] = o.detach()
    else:
        with torch.no_grad():
            out["o"] = fn(*args)
    return out, (bs, cs)


def _assemble(case, parts):
    """Global o / dq / dk / dv from every rank's (outputs, slices)."""
    res = {}
    for key in parts[0][0]:
        ref = case["k"] if key in ("dk", "dv") else case["q"]
        full = torch.empty(ref.shape, dtype=parts[0][0][key].dtype)
        for outs, (bs, cs) in parts:
            full[bs, :, cs] = outs[key]
        res[key] = full
    return res


def _llama_run(case, mesh, device):
    from flash_attention_tpu_torch.models.llama import (
        LlamaConfig, forward, init_params, param_leaves,
    )

    kw = dict(case["cfg"])
    kw["dtype"] = getattr(torch, kw.get("dtype", "float32"))
    cfg = LlamaConfig(**kw)
    params = init_params(cfg, seed=case.get("seed", 0), device=device)
    leaves = param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    sp, j = case["sp"], mesh.get_local_rank("sp")
    tokens = case["tokens"].long().to(device)
    t = (tokens.shape[1] - 1) // sp
    cs = slice(j * t, (j + 1) * t)
    inputs, targets = tokens[:, :-1][:, cs], tokens[:, 1:][:, cs]
    positions = torch.arange(j * t, (j + 1) * t, dtype=torch.int32,
                             device=device)
    ring = make_ring_attention(mesh, causal=True, window=cfg.window)
    logits = forward(params, inputs, cfg, positions=positions,
                     attn_impl=ring).float()
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))
    grads = torch.autograd.grad(loss, leaves)
    group = mesh.get_group("sp")
    total = torch.stack([loss.detach()])
    dist.all_reduce(total, group=group)
    out = []
    for g in grads:
        g = g.detach().clone()
        dist.all_reduce(g, group=group)
        out.append((g / sp).cpu())
    return {"loss": float(total[0]) / sp, "grads": out}


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    got = fn()
    _sync(device)
    return got, time.perf_counter() - t0


def _wait_for(path: str, timeout_s: float = 3600.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout_s} s")
        time.sleep(0.05)


def _run_case(case, mesh, device):
    fn = _llama_run if case.get("kind") == "llama" else _attn_run
    return fn(case, mesh, device)


def run(cases: list, device: torch.device, start_after: str | None = None,
        warmup: bool = False) -> dict | None:
    """Run every case on this rank; rank 0 returns the gathered results
    (other ranks None). The meshes are made first; with `start_after`,
    the ranks then wait for that file to exist (so a caller can start
    them before the kernel library is even built); then on the card the
    library is loaded, and with `warmup` every case runs once, neither
    counted nor timed (first launches load the kernels)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    meshes = {}
    for case in cases:
        dp, sp = case.get("dp", 1), case["sp"]
        if (dp, sp) not in meshes:
            meshes[dp, sp] = make_mesh(dp=dp, sp=sp, device_type=device.type)
    if start_after is not None:
        _wait_for(start_after)
        dist.barrier()
    if device.type == "cuda":
        from flash_attention_tpu_torch.ops import _cuda
        _cuda.lib()
    for case in cases if warmup else ():
        _run_case(case, meshes[case.get("dp", 1), case["sp"]], device)
    results = {}
    for case in cases:
        mesh = meshes[case.get("dp", 1), case["sp"]]
        before = _counts()
        got, secs = _timed(lambda: _run_case(case, mesh, device), device)
        after = _counts()
        launches = {k: after[k] - before[k] for k in after}
        again = [_timed(lambda: _run_case(case, mesh, device), device)[1]
                 for _ in range(case.get("repeat", 0))]
        if case.get("kind") == "llama":
            mine = got
        else:
            outs, slices = got
            mine = ({k: x.detach().cpu() for k, x in outs.items()}, slices)
        gathered = [None] * world if rank == 0 else None
        dist.gather_object(dict(result=mine, launches=launches,
                                seconds=secs, repeat_seconds=again),
                           gathered, dst=0)
        if rank == 0:
            res = (gathered[0]["result"] if case.get("kind") == "llama"
                   else _assemble(case, [g["result"] for g in gathered]))
            res["launches"] = [g["launches"] for g in gathered]
            res["seconds"] = [g["seconds"] for g in gathered]
            res["repeat_seconds"] = [
                statistics.median(g["repeat_seconds"])
                if g["repeat_seconds"] else None for g in gathered]
            results[case["name"]] = res
    return results if rank == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flash_attention_tpu_torch.scripts.ring_worker")
    ap.add_argument("cases")
    ap.add_argument("out")
    ap.add_argument("--start-after", default=None, metavar="FILE",
                    help="wait for FILE to exist (after joining the world, "
                         "reading the cases and making the meshes) before "
                         "loading the kernels and running the cases")
    ap.add_argument("--warmup", action="store_true",
                    help="run every case once first, neither counted nor "
                         "timed")
    ap.add_argument("--backend", default=None,
                    help="process-group backend (default: nccl on cuda, "
                         "gloo on cpu)")
    args = ap.parse_args(argv)
    device = torch.device(os.environ.get("FA_TPU_DEVICE", "cuda"))
    initialize_distributed(device=device, backend=args.backend)
    if not dist.is_initialized():
        ap.error("no rendezvous: run under launch_multihost (--simulate N "
                 "for local ranks)")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cases = torch.load(args.cases, weights_only=True)["cases"]
    results = run(cases, device, args.start_after, args.warmup)
    if results is not None:
        torch.save({"cases": results, "world": dist.get_world_size(),
                    "backend": str(dist.get_backend()),
                    "device": str(device)}, args.out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
