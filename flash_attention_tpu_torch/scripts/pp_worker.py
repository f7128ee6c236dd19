"""Pipeline- and expert-parallel training worker: one rank of an SPMD
GPipe / 1F1B or MoE run.

    python -m flash_attention_tpu_torch.scripts.launch_multihost \\
        --simulate N --device cpu -- \\
        -m flash_attention_tpu_torch.scripts.pp_worker CASES OUT \\
        [--backend gloo] [--start-after FILE]

Every rank reads CASES (a `torch.save`d dict {"cases": [case, ...],
"params": {name: tree}}), runs each case and sends its results to rank
0, which writes OUT: {"cases": {name: [one result per rank]}, "world":
N, "backend": ..., "device": ...}. The device comes from FA_TPU_DEVICE
(the launcher's `--device`); `--backend` names a backend other than the
device's default (gloo over card tensors: every collective staged
through host memory). `--start-after FILE` holds the ranks, once joined
and with their meshes made, until FILE exists.

Every case names `cfg` (LlamaConfig keyword arguments; "preset" a
LlamaConfig constructor, default "tiny", or a MoEConfig one, "tiny_moe"
or "mixtral_8x7b"; "dtype" a torch dtype name), `mesh` (make_mesh
keyword arguments) and `optimizer` ({"kind": "sgd" | "adamw", "lr",
"weight_decay"}). Its `kind`:

  step     `steps` optimizer steps of `schedule` ("gpipe" | "1f1b", with
           `remat`) on `tokens` [M, B, T]. `params` names a global tree
           of the file (split, sharded and stepped through
           make_pp_train_step / make_pp_train_step_1f1b), or is
           {"seed": s} (the Trainer draws it, family="pipeline"). Its
           result per rank: "losses", the gathered global tree after the
           first step ("params": (stages, shared) on the CPU, or with
           `fingerprint` its `fingerprints`), the shared params' local
           fingerprints ("shared"), and per step the "launches" (every
           kernel launch counter, as deltas), "collectives"
           (parallel/collectives.py counts) and "seconds" (synchronised
           wall time); the device's "peak_bytes" over the first step and,
           with more steps, "steady_peak_bytes" over the others (0 on the
           CPU); "build_s" and "gather_s" (the gather and fingerprints).
  loss     make_pp_loss on `tokens` with the tree `params`: "loss",
           "collectives".
  trainer  Trainer(family=`family`, default "pipeline", pp_schedule=
           `schedule`) from `seed` fed `batches` ([n, M, B, T], or [n, B,
           T] for "moe") in turn: `steps` steps with a checkpoint every
           `ckpt_every` under `ckpt_dir`, then a second Trainer from
           `resume_seed` that resumes from the newest checkpoint and runs
           the steps after it: "losses", "resumed_step",
           "resumed_losses", and for "moe" the first Trainer's
           "last_metrics".
  moe_step `steps` optimizer steps of models/moe.py make_moe_train_step
           (with `remat`) on `tokens` [B, T] (B over dp x ep). `params`
           names a global MoE tree of the file or is {"seed": s}
           (init_moe_params on the device); each rank keeps its shard
           (moe_param_shardings). Its result per rank: "losses",
           "metrics" (floats a step), per step "launches", "collectives"
           and "seconds", "peak_bytes" over the first step; after the
           first step the gathered global tree ("params" on the CPU, or
           with `fingerprint` its "fingerprints"; none with `gather`
           False), the replicated leaves' local fingerprints
           ("replicated") and, with `save_grads` (a path prefix), this
           rank's reduced gradients written to `<prefix>.rank<r>.pt` (a
           tree of its shard); "gather_s" the seconds of those.
  moe_mlp  models/moe.py moe_mlp(ep_axis=) over the mesh's ep group on
           this rank's (dp, ep) rows of `x` [B, T, d], layer 0 of the
           tree `params` cut by moe_param_shardings: "y" and "aux" on
           the CPU, "collectives".
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import torch
import torch.distributed as dist

from flash_attention_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
)
from flash_attention_tpu_torch.scripts.tp_worker import (
    _config,
    _mesh_key,
    _sync,
    _wait_for,
    launch_counts,
)


def fingerprint(t: torch.Tensor) -> tuple:
    """Two exact integer sums of a tensor's bits (plain and position
    weighted): equal fingerprints mean equal bits, without moving the
    tensor."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    x = t.detach().reshape(-1)
    if x.is_floating_point():
        x = x.view(ints[x.element_size()])
    x = x.long()
    w = torch.arange(x.numel(), device=x.device) % 65521 + 1
    return int(x.sum()), int((x * w).sum())


def fingerprints(stages, shared) -> dict:
    """{"layers.<i>.<key>": ..., "<shared key>": ...} of a global
    (stages, shared) pair, layer by layer: the names a plain tree's
    leaves have."""
    out = {f"layers.{i}.{k}": fingerprint(v[i])
           for k, v in stages.items() for i in range(v.shape[0])}
    out.update({k: fingerprint(v) for k, v in shared.items()})
    return out


def tree_fingerprints(params) -> dict:
    """`fingerprints`' names and values for a plain parameter tree."""
    out = {f"layers.{i}.{k}": fingerprint(v)
           for i, layer in enumerate(params["layers"])
           for k, v in layer.items()}
    out.update({k: fingerprint(v) for k, v in params.items()
                if k != "layers"})
    return out


def _optimizer(spec: dict):
    kw = {k: v for k, v in spec.items() if k != "kind"}
    cls = {"sgd": torch.optim.SGD, "adamw": torch.optim.AdamW}[spec["kind"]]
    return functools.partial(cls, **kw)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def _stepper(case, cfg, mesh, trees, device):
    """(stages, shared, step(tokens) -> loss) for a step case."""
    from flash_attention_tpu_torch.models.llama import param_leaves
    from flash_attention_tpu_torch.models.trainer import (
        Trainer, TrainerConfig,
    )
    from flash_attention_tpu_torch.parallel.mesh import shard_params
    from flash_attention_tpu_torch.parallel.pipeline import (
        make_pp_train_step, make_pp_train_step_1f1b, pipeline_shardings,
        split_pipeline_params,
    )

    opt = _optimizer(case["optimizer"])
    remat = case.get("remat", False)
    if not isinstance(case["params"], str):
        tr = Trainer(cfg, opt, trainer_cfg=TrainerConfig(remat=remat),
                     mesh=mesh, seed=case["params"]["seed"],
                     family="pipeline", pp_schedule=case["schedule"],
                     device=device)
        return (*tr.params, tr.train_step)
    tp_axis = "tp" if mesh["tp"].size() > 1 else None
    stages, shared = split_pipeline_params(trees[case["params"]],
                                           mesh["pp"].size())
    # A copy of the shared params: the step updates them in place.
    shared = {k: v.detach().clone() for k, v in shared.items()}
    st_s, sh_s = pipeline_shardings(mesh, stages, shared, tp_axis=tp_axis)
    stages = shard_params(stages, st_s, mesh, device=device)
    shared = shard_params(shared, sh_s, mesh, device=device)
    for leaf in param_leaves((stages, shared)):
        leaf.requires_grad_(True)
    optimizer = opt(param_leaves((stages, shared)))
    step = (make_pp_train_step(mesh, cfg, remat=remat)
            if case["schedule"] == "gpipe" else
            make_pp_train_step_1f1b(mesh, cfg))
    return stages, shared, lambda tok: step(stages, shared, optimizer, tok)


def _step_run(case, mesh, trees, device) -> dict:
    from flash_attention_tpu_torch.parallel import collectives
    from flash_attention_tpu_torch.parallel.mesh import gather_params
    from flash_attention_tpu_torch.parallel.pipeline import (
        pipeline_shardings,
    )

    cfg = _config(case["cfg"])
    t0 = time.perf_counter()
    stages, shared, step = _stepper(case, cfg, mesh, trees, device)
    _sync(device)
    out = dict(losses=[], launches=[], collectives=[], seconds=[],
               build_s=time.perf_counter() - t0)
    tokens = case["tokens"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for i in range(case.get("steps", 1)):
        _sync(device)
        launches0, coll0 = launch_counts(), collectives.collective_counts()
        t0 = time.perf_counter()
        loss = float(step(tokens))
        _sync(device)
        out["seconds"].append(time.perf_counter() - t0)
        launches1, coll1 = launch_counts(), collectives.collective_counts()
        out["losses"].append(loss)
        out["launches"].append({k: launches1[k] - launches0[k]
                                for k in launches1})
        out["collectives"].append({
            kind: {f: coll1[kind][f] - coll0[kind][f] for f in coll1[kind]}
            for kind in coll1})
        if i == 0:
            out["peak_bytes"] = _peak(device)
            t0 = time.perf_counter()
            tp_axis = "tp" if mesh["tp"].size() > 1 else None
            st_s, sh_s = pipeline_shardings(mesh, stages, shared,
                                            tp_axis=tp_axis)
            whole = (gather_params(stages, st_s, mesh),
                     gather_params(shared, sh_s, mesh))
            if case.get("fingerprint"):
                out["fingerprints"] = fingerprints(*whole)
            else:
                out["params"] = tuple({k: v.cpu() for k, v in part.items()}
                                      for part in whole)
            del whole
            out["shared"] = {k: fingerprint(v) for k, v in shared.items()}
            out["gather_s"] = time.perf_counter() - t0
            if device.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
    if len(out["losses"]) > 1:
        out["steady_peak_bytes"] = _peak(device)
    return out


def _loss_run(case, mesh, trees, device) -> dict:
    from flash_attention_tpu_torch.parallel import collectives
    from flash_attention_tpu_torch.parallel.mesh import shard_params
    from flash_attention_tpu_torch.parallel.pipeline import (
        make_pp_loss, pipeline_shardings, split_pipeline_params,
    )

    cfg = _config(case["cfg"])
    stages, shared = split_pipeline_params(trees[case["params"]],
                                           mesh["pp"].size())
    st_s, sh_s = pipeline_shardings(mesh, stages, shared)
    stages = shard_params(stages, st_s, mesh, device=device)
    shared = shard_params(shared, sh_s, mesh, device=device)
    coll0 = collectives.collective_counts()
    loss = float(make_pp_loss(mesh, cfg)(stages, shared, case["tokens"]))
    coll1 = collectives.collective_counts()
    return dict(loss=loss, collectives={
        kind: {f: coll1[kind][f] - coll0[kind][f] for f in coll1[kind]}
        for kind in coll1})


def _trainer_run(case, mesh, device) -> dict:
    from flash_attention_tpu_torch.models.trainer import (
        Trainer, TrainerConfig,
    )

    cfg = _config(case["cfg"])
    tc = TrainerConfig(ckpt_dir=case["ckpt_dir"],
                       ckpt_every=case["ckpt_every"], log_every=10 ** 9,
                       remat=case.get("remat", False))
    family = case.get("family", "pipeline")
    kw = dict(trainer_cfg=tc, mesh=mesh, family=family, device=device,
              pp_schedule=case.get("schedule", "gpipe"))
    opt = _optimizer(case["optimizer"])
    batches = case["batches"]
    t1 = Trainer(cfg, opt, seed=case["seed"], **kw)
    losses = t1.fit(iter(batches), steps=case["steps"], log=lambda s: None)
    metrics = ({k: float(v) for k, v in t1.last_metrics.items()}
               if t1.last_metrics is not None else None)
    del t1
    t2 = Trainer(cfg, opt, seed=case["resume_seed"], **kw)
    resumed_step = t2.step_num
    resumed = t2.fit(iter(batches[resumed_step:]),
                     steps=case["steps"] - resumed_step, log=lambda s: None)
    return dict(losses=losses, resumed_step=resumed_step,
                resumed_losses=resumed, last_metrics=metrics)


def _map(fn, tree):
    """fn over the tensors of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _cloned(tree):
    return _map(lambda t: t.detach().clone(), tree)


def _moe_shard(case, cfg, mesh, trees, device):
    """This rank's shard of the case's MoE tree (its own tensors)."""
    from flash_attention_tpu_torch.models.moe import (
        init_moe_params, moe_param_shardings,
    )
    from flash_attention_tpu_torch.parallel.mesh import shard_params

    src = case["params"]
    whole = (trees[src] if isinstance(src, str) else
             init_moe_params(cfg, src["seed"], device=device))
    local = shard_params(whole, moe_param_shardings(cfg), mesh,
                         device=device)
    return _cloned(local) if isinstance(src, str) else local


def _moe_step_run(case, mesh, trees, device) -> dict:
    from flash_attention_tpu_torch.models.llama import param_leaves
    from flash_attention_tpu_torch.models.moe import (
        EXPERT_KEYS, make_moe_train_step, moe_param_shardings,
    )
    from flash_attention_tpu_torch.parallel import collectives
    from flash_attention_tpu_torch.parallel.mesh import gather_params

    cfg = _config(case["cfg"])
    t0 = time.perf_counter()
    params = _moe_shard(case, cfg, mesh, trees, device)
    for leaf in param_leaves(params):
        leaf.requires_grad_(True)
    optimizer = _optimizer(case["optimizer"])(param_leaves(params))
    step = make_moe_train_step(mesh, cfg, remat=case.get("remat", False))
    _sync(device)
    out = dict(losses=[], metrics=[], launches=[], collectives=[],
               seconds=[], build_s=time.perf_counter() - t0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for i in range(case.get("steps", 1)):
        _sync(device)
        launches0, coll0 = launch_counts(), collectives.collective_counts()
        t0 = time.perf_counter()
        loss, metrics = step(params, optimizer, case["tokens"])
        loss = float(loss)
        _sync(device)
        out["seconds"].append(time.perf_counter() - t0)
        launches1, coll1 = launch_counts(), collectives.collective_counts()
        out["losses"].append(loss)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["launches"].append({k: launches1[k] - launches0[k]
                                for k in launches1})
        out["collectives"].append({
            kind: {f: coll1[kind][f] - coll0[kind][f] for f in coll1[kind]}
            for kind in coll1})
        if i:
            continue
        out["peak_bytes"] = _peak(device)
        t0 = time.perf_counter()
        if case.get("save_grads"):
            r = dist.get_rank()
            torch.save(_map(lambda t: t.grad.cpu(), params),
                       f"{case['save_grads']}.rank{r}.pt")
        if case.get("gather", True):
            whole = gather_params(params, moe_param_shardings(cfg), mesh)
            if case.get("fingerprint"):
                out["fingerprints"] = tree_fingerprints(whole)
            else:
                out["params"] = _map(lambda t: t.detach().cpu().clone(),
                                     whole)
            del whole
        out["replicated"] = {
            name: fp for name, fp in tree_fingerprints(params).items()
            if name.rsplit(".", 1)[-1] not in EXPERT_KEYS}
        out["gather_s"] = time.perf_counter() - t0
    return out


def _moe_mlp_run(case, mesh, trees, device) -> dict:
    from flash_attention_tpu_torch.models.moe import (
        moe_mlp, moe_param_shardings,
    )
    from flash_attention_tpu_torch.parallel import collectives
    from flash_attention_tpu_torch.parallel.mesh import shard_params

    cfg = _config(case["cfg"])
    dp, ep = mesh["dp"].size(), mesh["ep"].size()
    layer = shard_params(trees[case["params"]]["layers"][0],
                         moe_param_shardings(cfg)["layers"][0], mesh,
                         device=device)
    x = case["x"].to(device)
    c = x.shape[0] // (dp * ep)
    r = mesh.get_local_rank("dp") * ep + mesh.get_local_rank("ep")
    coll0 = collectives.collective_counts()
    with torch.no_grad():
        y, aux = moe_mlp(layer, x[r * c:(r + 1) * c], cfg,
                         ep_axis=mesh.get_group("ep") if ep > 1 else None)
    coll1 = collectives.collective_counts()
    return dict(y=y.cpu(), aux={k: float(v) for k, v in aux.items()},
                collectives={kind: {f: coll1[kind][f] - coll0[kind][f]
                                    for f in coll1[kind]} for kind in coll1})


def run(cases: list, trees: dict, device: torch.device,
        start_after: str | None = None) -> dict | None:
    """Run every case on this rank; rank 0 returns the gathered results
    (other ranks None). The meshes are made first (every rank in the
    same order); with `start_after` the ranks then wait for that file;
    then on the card the kernel library is loaded."""
    rank = dist.get_rank()
    meshes = {}
    for case in cases:
        key = _mesh_key(case)
        if key not in meshes:
            meshes[key] = make_mesh(**dict(key), device_type=device.type)
    # The first optimizer a process builds imports torch._dynamo (seconds
    # of host): build a throwaway one before the wait, not in a case.
    torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.0)
    if start_after is not None:
        _wait_for(start_after)
        dist.barrier()
    if device.type == "cuda":
        from flash_attention_tpu_torch.ops import _cuda
        _cuda.lib()
    results = {}
    for case in cases:
        mesh = meshes[_mesh_key(case)]
        kind = case.get("kind", "step")
        if kind == "step":
            mine = _step_run(case, mesh, trees, device)
        elif kind == "loss":
            mine = _loss_run(case, mesh, trees, device)
        elif kind == "moe_step":
            mine = _moe_step_run(case, mesh, trees, device)
        elif kind == "moe_mlp":
            mine = _moe_mlp_run(case, mesh, trees, device)
        else:
            mine = _trainer_run(case, mesh, device)
        gathered = [None] * dist.get_world_size() if rank == 0 else None
        dist.gather_object(mine, gathered, dst=0)
        if rank == 0:
            results[case["name"]] = gathered
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return results if rank == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flash_attention_tpu_torch.scripts.pp_worker")
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
