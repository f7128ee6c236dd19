"""Tensor-parallel serving worker: one rank of an SPMD engine run.

    python -m flash_attention_tpu_torch.scripts.launch_multihost \\
        --simulate N --device cpu -- \\
        -m flash_attention_tpu_torch.scripts.tp_worker CASES OUT \\
        [--backend gloo] [--start-after FILE]

Every rank reads CASES (a `torch.save`d dict {"cases": [case, ...],
"params": {name: tree}}), runs each case and sends its results to rank
0, which writes OUT: {"cases": {name: [one result per rank]}, "world":
N, "backend": ..., "device": ...}. The device comes from FA_TPU_DEVICE
(the launcher's `--device`); `--backend` names a backend other than the
device's default (gloo over card tensors: every collective staged
through host memory). `--start-after FILE` holds the ranks, once joined
and with their meshes made, until FILE exists, so a caller can start
them early (with its kernel build) and keep its own card work out of
their times.

An "engine" case (the default kind) serves its requests through the
`Engine`, every rank with the same arguments (the SPMD rule):
  cfg       LlamaConfig keyword arguments; "preset" names a LlamaConfig
            constructor (default "tiny"), or a MoEConfig one ("tiny_moe",
            "mixtral_8x7b", with "routing" and the other MoEConfig
            fields), "dtype" a torch dtype name;
  params    a name in the file's "params" (a parameter tree, quantized
            leaves included), or {"seed": s, "weights": "int4" | "int8"
            | "dense"} to draw the tree on the device
            (init_quantized_params / init_params, for an MoE config
            init_quantized_moe_params / init_moe_params; drawn once per
            recipe);
  mesh      make_mesh keyword arguments ({"tp": 2, "dp": -1}), or None
            for the engine without a mesh;
  engine    Engine keyword arguments ("kv_quant_dtype" a dtype name);
  requests  Request keyword arguments, in submission order, or
  waves     lists of them, each served to the end before the next;
  warmup    serve one 3-token request first (not counted);
  env       environment variables set for the case (engine build and
            run), e.g. {"FA_TPU_GROUPED_MIN_TOKENS": "1"};
  record_bases  keep the `base` row offset of every grouped-kernel (B9)
            call of the counted run: "bases", as integers read after it.
Its result per rank: "transcripts" [(request index, branch, tokens,
finish reason)], "launches" (every kernel and body launch counter of
the ops modules, as deltas over the counted run), "collectives"
(parallel/collectives.py counts over the run), "seconds" (the run's
wall time, synchronised) and "stats" (decode steps and tokens, prefill
chunks, decode and prefill seconds).

A "collective_bytes" case runs parallel/scaling.py
`tp_decode_collective_bytes(cfg, tp, batch)` and returns its bytes.

A "moe_block" case runs one MoE FFN block under the mesh's tp group as
`expert_shard_axis`: layer 0 of the tree `params` cut by
serving_param_shardings, on the replicated activations `x` [B, T, d];
`route` "grouped" (moe_mlp_grouped) or "onehot" (moe_mlp, capacity =
B T). Its result: "y" on the CPU, "collectives", "launches".
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import torch
import torch.distributed as dist

from flash_attention_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
)


def launch_counts() -> dict:
    """Every `*_launches` counter of the kernel modules, by
    "module.counter"."""
    from flash_attention_tpu_torch.ops import (
        decode, flash, grouped, paged, quant_matmul,
    )

    return {f"{mod.__name__.rsplit('.', 1)[1]}.{attr}": getattr(mod, attr)
            for mod in (flash, paged, decode, quant_matmul, grouped)
            for attr in sorted(vars(mod)) if attr.endswith("_launches")}


MOE_PRESETS = ("tiny_moe", "mixtral_8x7b")


def _config(spec: dict):
    from flash_attention_tpu_torch.models.llama import LlamaConfig
    from flash_attention_tpu_torch.models.moe import MoEConfig

    kw = dict(spec)
    preset = kw.pop("preset", "tiny")
    kw["dtype"] = getattr(torch, kw.get("dtype", "bfloat16"))
    cls = MoEConfig if preset in MOE_PRESETS else LlamaConfig
    return getattr(cls, preset)(**kw)


def _params(case, cfg, trees: dict, cache: dict, device):
    """The case's parameter tree: a named tree of the cases file, or one
    drawn on the device from its recipe (kept for the cases after)."""
    from flash_attention_tpu_torch.models.llama import init_params
    from flash_attention_tpu_torch.models.moe import (
        MoEConfig, init_moe_params,
    )
    from flash_attention_tpu_torch.models.quantized import (
        init_quantized_moe_params, init_quantized_params,
    )

    src = case["params"]
    if isinstance(src, str):
        return trees[src]
    key = (repr(sorted(case["cfg"].items())), src["seed"], src["weights"])
    if key not in cache:
        cache.clear()
        moe = isinstance(cfg, MoEConfig)
        if src["weights"] == "dense":
            draw = init_moe_params if moe else init_params
            cache[key] = draw(cfg, seed=src["seed"], device=device)
        else:
            dt = "int4" if src["weights"] == "int4" else torch.int8
            draw = init_quantized_moe_params if moe else init_quantized_params
            cache[key] = draw(cfg, src["seed"], dt, device=device)
    return cache[key]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def environ(env: dict):
    """`env` set in os.environ within the block, the old values back
    after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _engine_run(case, mesh, trees, cache, device) -> dict:
    with environ(case.get("env", {})):
        return _engine_case(case, mesh, trees, cache, device)


def _engine_case(case, mesh, trees, cache, device) -> dict:
    from flash_attention_tpu_torch.parallel import collectives
    from flash_attention_tpu_torch.runtime.engine import Engine, Request

    cfg = _config(case["cfg"])
    kw = dict(case.get("engine", {}))
    if kw.get("kv_quant_dtype") is not None:
        kw["kv_quant_dtype"] = getattr(torch, kw["kv_quant_dtype"])
    eng = Engine(_params(case, cfg, trees, cache, device), cfg, mesh=mesh,
                 device=device, **kw)
    if case.get("warmup"):
        eng.run([Request(prompt=[1, 2, 3], max_new_tokens=2)])
        eng.stats = type(eng.stats)()
    waves = [[Request(**r) for r in wave]
             for wave in case.get("waves", [case.get("requests")])]
    order = {r.request_id: i
             for i, r in enumerate(r for wave in waves for r in wave)}
    bases = []
    _sync(device)
    launches0, coll0 = launch_counts(), collectives.collective_counts()
    t0 = time.perf_counter()
    with _recording_bases(bases if case.get("record_bases") else None):
        comps = [c for wave in waves for c in eng.run(wave)]
    _sync(device)
    secs = time.perf_counter() - t0
    launches1, coll1 = launch_counts(), collectives.collective_counts()
    st = eng.stats
    out = dict(
        transcripts=sorted((order[c.request_id], c.branch, list(c.tokens),
                            c.finish_reason) for c in comps),
        launches={k: launches1[k] - launches0[k] for k in launches1},
        collectives={kind: {f: coll1[kind][f] - coll0[kind][f]
                            for f in coll1[kind]} for kind in coll1},
        seconds=secs,
        stats=dict(decode_steps=st.decode_steps, decode_tokens=st.decode_tokens,
                   prefill_chunks=st.prefill_chunks, decode_s=st.decode_s,
                   prefill_s=st.prefill_s, spec_accepted=st.spec_accepted,
                   prefix_cached_tokens=st.prefix_cached_tokens))
    if case.get("record_bases"):
        out["bases"] = [int(b) for b in bases]
    return out


@contextlib.contextmanager
def _recording_bases(bases):
    """Within the block, keep (in `bases`, unless it is None) the `base`
    of every grouped expert product, B9's band offset: a device tensor,
    read after the run."""
    from flash_attention_tpu_torch.models import moe

    if bases is None:
        yield
        return
    inner = moe._expert_stack_mm

    def recorded(xs, w, group_sizes=None, base=None):
        if group_sizes is not None:
            bases.append(0 if base is None else base)
        return inner(xs, w, group_sizes, base)

    moe._expert_stack_mm = recorded
    try:
        yield
    finally:
        moe._expert_stack_mm = inner


def _moe_block(case, mesh, trees, device) -> dict:
    from flash_attention_tpu_torch.models.llama import serving_param_shardings
    from flash_attention_tpu_torch.models.moe import moe_mlp, moe_mlp_grouped
    from flash_attention_tpu_torch.parallel import collectives
    from flash_attention_tpu_torch.parallel.mesh import shard_params

    cfg = _config(case["cfg"])
    tp = mesh["tp"].size()
    layer = shard_params(trees[case["params"]]["layers"][0],
                         serving_param_shardings(cfg, tp)["layers"][0],
                         mesh, device=device)
    x = case["x"].to(device)
    group = mesh.get_group("tp")
    launches0, coll0 = launch_counts(), collectives.collective_counts()
    with torch.no_grad():
        if case["route"] == "grouped":
            y, _ = moe_mlp_grouped(layer, x, cfg, expert_shard_axis=group)
        else:
            y, _ = moe_mlp(layer, x, cfg, expert_shard_axis=group,
                           capacity=x.shape[0] * x.shape[1])
    launches1, coll1 = launch_counts(), collectives.collective_counts()
    return dict(y=y.cpu(),
                launches={k: launches1[k] - launches0[k] for k in launches1},
                collectives={kind: {f: coll1[kind][f] - coll0[kind][f]
                                    for f in coll1[kind]} for kind in coll1})


def _wait_for(path: str, timeout_s: float = 3600.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout_s} s")
        time.sleep(0.05)


def _mesh_key(case):
    m = case.get("mesh")
    return None if m is None else tuple(sorted(m.items()))


def run(cases: list, trees: dict, device: torch.device,
        start_after: str | None = None) -> dict | None:
    """Run every case on this rank; rank 0 returns the gathered results
    (other ranks None). The meshes are made first (every rank in the
    same order); with `start_after` the ranks then wait for that file;
    then on the card the kernel library is loaded."""
    from flash_attention_tpu_torch.parallel.scaling import (
        tp_decode_collective_bytes,
    )

    rank = dist.get_rank()
    meshes = {}
    for case in cases:
        key = _mesh_key(case)
        if key is not None and key not in meshes:
            meshes[key] = make_mesh(**dict(key), device_type=device.type)
    if start_after is not None:
        _wait_for(start_after)
        dist.barrier()
    if device.type == "cuda":
        from flash_attention_tpu_torch.ops import _cuda
        _cuda.lib()
    cache, results = {}, {}
    for case in cases:
        if case.get("kind") == "collective_bytes":
            mine = tp_decode_collective_bytes(
                _config(case["cfg"]), case["tp"], case["batch"],
                device=device)
        elif case.get("kind") == "moe_block":
            mine = _moe_block(case, meshes[_mesh_key(case)], trees, device)
        else:
            mine = _engine_run(case, meshes.get(_mesh_key(case)), trees,
                               cache, device)
        gathered = [None] * dist.get_world_size() if rank == 0 else None
        dist.gather_object(mine, gathered, dst=0)
        if rank == 0:
            results[case["name"]] = gathered
    return results if rank == 0 else None


def main(argv=None) -> int:
    from flash_attention_tpu_torch.models.quantized import (
        Int4Weight, QuantizedWeight,
    )

    ap = argparse.ArgumentParser(
        prog="python -m flash_attention_tpu_torch.scripts.tp_worker")
    ap.add_argument("cases")
    ap.add_argument("out")
    ap.add_argument("--start-after", default=None, metavar="FILE",
                    help="wait for FILE to exist (after joining the world, "
                         "reading the cases and making the meshes) before "
                         "loading the kernels and running the cases")
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
    with torch.serialization.safe_globals([QuantizedWeight, Int4Weight]):
        spec = torch.load(args.cases, weights_only=True, map_location=device)
    results = run(spec["cases"], spec.get("params", {}), device,
                  args.start_after)
    if results is not None:
        torch.save({"cases": results, "world": dist.get_world_size(),
                    "backend": str(dist.get_backend()),
                    "device": str(device)}, args.out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
