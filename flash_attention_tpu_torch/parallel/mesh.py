"""Process group and device mesh (port of
`flash_attention_tpu/parallel/mesh.py`).

Axis conventions, in mesh-major order, as in the JAX package:

  dp    data parallel (batch): gradients all-reduce
  pp    pipeline parallel (layer stages; microbatch activations hop)
  fsdp  fully-sharded data parallel (params + optimizer state sharded)
  sp    sequence parallel (ring attention rotates K/V around this axis)
  tp    tensor parallel (heads / hidden sharded; activations collective)
  ep    expert parallel (MoE experts sharded; token all-to-all)

One process is one rank and one device. `initialize_distributed()`
joins the processes into one `torch.distributed` world (NCCL between
cards, gloo between CPU processes), and `make_mesh` lays the six named
axes over its ranks as a `DeviceMesh`; `mesh.get_group(axis)` is the
process group of an axis, and `axes_group(mesh, axes)` the group of
several axes flattened into one (JAX's collective over a tuple of axis
names, e.g. `psum(x, ("dp", "ep"))`). `flash_attention_tpu_torch.scripts.
launch_multihost` is the per-host launcher, and its `--simulate N` mode
spawns N local ranks. `shard_params` cuts this rank's slice of a
parameter tree by its specs (tensor-parallel serving, the pipeline's
stages, expert-sharded stacks); `gather_params` puts the global tree
back together from the slices (the pipeline's and the expert-parallel
trainer's checkpoints).
"""

from __future__ import annotations

import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from flash_attention_tpu_torch.config import resolve_device

AXES = ("dp", "pp", "fsdp", "sp", "tp", "ep")

# How long a rank waits for its peers at the rendezvous and in a
# collective before it raises, instead of hanging.
TIMEOUT_S = 600


def _init_method(coordinator: str) -> str:
    """A `host:port` coordinator as a TCP rendezvous; `tcp://` and
    `file://` addresses pass as they are."""
    if coordinator.startswith(("tcp://", "file://", "env://")):
        return coordinator
    return f"tcp://{coordinator}"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids=None, *, device="cuda",
                           backend: str | None = None) -> None:
    """Join this process to the `torch.distributed` world. Call once per
    process, before `make_mesh`.

    The rendezvous comes from the arguments, else from the JAX
    package's contract FA_TPU_COORDINATOR (`host:port`, or a `tcp://` /
    `file://` address) / FA_TPU_NUM_PROCESSES / FA_TPU_PROCESS_ID (what
    `scripts/launch_multihost.py` sets), else from torchrun's
    MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK.

    `device="cuda"` (the default) makes an NCCL group and raises where
    there is no card or no NCCL; it never drops to gloo. `device="cpu"`
    makes a gloo group. `backend=` names another backend explicitly
    (gloo over card tensors: every transfer is staged through host
    memory). Each rank drives one device: `local_device_ids` (an index,
    or a sequence of one) names it, else LOCAL_RANK, else the rank modulo
    the visible cards.

    A no-op when a group already exists, and for one process that was
    given no rendezvous (no coordinator and at most one process).
    """
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("FA_TPU_COORDINATOR")
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = env.get("FA_TPU_NUM_PROCESSES",
                                env.get("WORLD_SIZE"))
    if process_id is None:
        process_id = env.get("FA_TPU_PROCESS_ID", env.get("RANK"))
    num_processes = 1 if num_processes is None else int(num_processes)
    process_id = 0 if process_id is None else int(process_id)
    if coordinator_address is None:
        if num_processes == 1:
            return
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "address (FA_TPU_COORDINATOR or MASTER_ADDR)")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("the NCCL backend is not available in this "
                           "torch build; pass device='cpu' for gloo")
    if dev.type == "cuda":
        if local_device_ids is None:
            index = int(env.get("LOCAL_RANK", process_id))
        elif isinstance(local_device_ids, int):
            index = local_device_ids
        else:
            (index,) = local_device_ids
        torch.cuda.set_device(index % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=_init_method(coordinator_address),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def mesh_shape_for(n_devices: int, *, dp=1, pp=1, fsdp=1, sp=1, tp=1,
                   ep=1) -> dict:
    """Fill in at most one -1 axis to consume the remaining devices."""
    shape = {"dp": dp, "pp": pp, "fsdp": fsdp, "sp": sp, "tp": tp, "ep": ep}
    free = [k for k, v in shape.items() if v == -1]
    if len(free) > 1:
        raise ValueError("at most one axis may be -1")
    fixed = int(np.prod([v for v in shape.values() if v != -1]))
    if free:
        if n_devices % fixed:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes {fixed}"
            )
        shape[free[0]] = n_devices // fixed
        fixed = n_devices
    if fixed != n_devices:
        raise ValueError(
            f"mesh shape {shape} needs {fixed} devices, have {n_devices}"
        )
    return shape


def make_mesh(*, dp=1, pp=1, fsdp=1, sp=1, tp=1, ep=1, devices=None,
              device_type: str = "cuda"):
    """A `DeviceMesh` over the ranks of the world with the six named
    axes (AXES, dp / pp outermost, tp / ep innermost). Use -1 for one
    auto axis. `devices` is a sequence of global ranks (default: every
    rank, in order). `device_type="cuda"` (the default) raises where
    there is no card; "cpu" meshes CPU ranks over gloo.

    Needs `initialize_distributed()` first (a world of one too). The JAX
    function lays the axes along the TPU's ICI torus when the devices
    are not given; there is no counterpart here: ranks are laid in
    enumeration order, and a card's topology (NVLink, the network) is
    NCCL's to route."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed() first")
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    shape = mesh_shape_for(len(ranks), dp=dp, pp=pp, fsdp=fsdp, sp=sp,
                           tp=tp, ep=ep)
    dims = tuple(shape[a] for a in AXES)
    if devices is None:
        return init_device_mesh(device_type, dims, mesh_dim_names=AXES)
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(dims),
                      mesh_dim_names=AXES)


def axes_group(mesh, axes):
    """The process group of `axes` (a name, or a tuple of names) flattened
    into one: the ranks that share this rank's coordinates on every other
    axis, ordered as the mesh lays them (the first axis outermost). One
    axis is `mesh.get_group(axis)`; a tuple makes its groups once per
    mesh, every rank of the world creating every group in the same order
    (`dist.new_group` is collective), and keeps them on the mesh."""
    if isinstance(axes, str):
        return mesh.get_group(axes)
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_axes_groups", {})
    if axes not in cache:
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        grid = mesh.mesh.permute(*rest, *dims)
        grid = grid.reshape(-1, math.prod(grid.shape[len(rest):]))
        me = dist.get_rank()
        mine = None
        for ranks in grid.tolist():
            group = dist.new_group(ranks)
            if me in ranks:
                mine = group
        cache[axes] = mine
    return cache[axes]


def _axis_slice(x, dim: int, axis, mesh):
    """This rank's chunk of x along `dim` for mesh axis `axis` (x itself
    for no axis or an axis of one rank)."""
    if axis is None or mesh[axis].size() == 1:
        return x
    n = mesh[axis].size()
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over the {n} ranks of axis {axis!r}")
    c = x.shape[dim] // n
    return x.narrow(dim, mesh.get_local_rank(axis) * c, c)


def _shard_leaf(x, spec, mesh, device):
    """x's slice on `device`: a new tensor holding only the slice (a view
    would keep the whole storage alive), or x moved as it is when the
    spec cuts nothing here."""
    y = x
    for dim, axis in enumerate(spec):
        y = _axis_slice(y, dim, axis, mesh)
    if y is x:
        return x.to(device)
    return torch.empty(y.shape, dtype=y.dtype, device=device).copy_(y)


def _shard_quantized(w, spec, mesh, device):
    """A quantized weight's shard: its leaves cut by its expanded spec,
    and its orig_shape the shard's logical shape (the leading dim of the
    contracted group over the row axis, of the output group over the
    column axis)."""
    from flash_attention_tpu_torch.models.quantized import (
        INT4_GROUP, Int4Weight,
    )

    int4 = isinstance(w, Int4Weight)
    k_ax, f_ax = spec.packed if int4 else spec.q
    shape = list(w.orig_shape)
    for lead, axis in ((0, k_ax), (w.n_contract, f_ax)):
        if axis is not None:
            n = mesh[axis].size()
            if shape[lead] % n:
                raise ValueError(f"dim {lead} of {w.orig_shape} does not "
                                 f"split over the {n} ranks of {axis!r}")
            shape[lead] //= n
    if int4 and k_ax is not None:
        k_local = math.prod(shape[: w.n_contract])
        if k_local % INT4_GROUP:
            raise ValueError(
                f"an int4 row shard must cut on a {INT4_GROUP}-row scale "
                f"group: {w.orig_shape} gives {k_local} rows a rank")
    if int4:
        leaves = dict(packed=_shard_leaf(w.packed, spec.packed, mesh, device),
                      scales=_shard_leaf(w.scales, spec.scales, mesh, device))
    else:
        leaves = dict(q=_shard_leaf(w.q, spec.q, mesh, device),
                      scale=_shard_leaf(w.scale, spec.scale, mesh, device))
    return type(w)(**leaves, orig_shape=tuple(shape),
                   n_contract=w.n_contract)


def shard_params(params, specs, mesh, *, device="cuda"):
    """This rank's shard of a parameter tree (the counterpart of the JAX
    engine's `device_put(x, NamedSharding(mesh, spec))`): every leaf cut
    to this rank's coordinate on each mesh axis its spec names, and only
    that slice moved to `device` (the whole tree may live on the host).
    An MoE expert stack [E, ...] with ("ep",) or ("tp",) keeps this
    rank's band of E / n experts, as any tensor does.

    `specs` has the tree's structure with a spec tuple per tensor; a
    quantized weight takes its expanded spec
    (models/quantized.py `expand_param_shardings`), and its shard
    carries the shard's logical orig_shape. An int4 shard over rows
    must cut on a scale group's boundary."""
    from flash_attention_tpu_torch.models.quantized import (
        QUANT_LEAF_TYPES, map_with_specs,
    )

    dev = resolve_device(device)

    def shard(x, spec):
        if isinstance(x, QUANT_LEAF_TYPES):
            return _shard_quantized(x, spec, mesh, dev)
        return _shard_leaf(x, spec, mesh, dev)

    return map_with_specs(shard, params, specs)


def gather_params(local, specs, mesh):
    """The inverse of `shard_params` for dense trees: every tensor of
    `local` (this rank's slice) all-gathered along each dim its spec
    names, over that axis's group, in rank order, so every rank gets the
    global tensor (detached) on the slice's device; a tensor whose spec
    names no axis comes back as it is. Dicts and lists are walked beside
    `specs`; any other leaf (an optimizer's hyperparameters and
    parameter ids) comes back as it is. The gathers go through
    parallel/collectives.py `all_gather_tiled` (counted; an axis of one
    rank still calls)."""
    from flash_attention_tpu_torch.parallel.collectives import (
        all_gather_tiled,
    )

    if isinstance(local, dict):
        return {k: gather_params(v, specs[k], mesh) for k, v in local.items()}
    if isinstance(local, list):
        return [gather_params(v, s, mesh) for v, s in zip(local, specs,
                                                          strict=True)]
    if not isinstance(local, torch.Tensor):
        return local
    out = local.detach()
    for dim, axis in enumerate(specs):
        if axis is not None:
            out = all_gather_tiled(out, mesh.get_group(axis), dim)
    return out


def spec_leaves(specs) -> list:
    """The spec tuples of a spec tree in `param_leaves` order (dict keys
    sorted, list entries in order): a tuple is a leaf here."""
    if isinstance(specs, dict):
        return [t for key in sorted(specs) for t in spec_leaves(specs[key])]
    if isinstance(specs, list):
        return [t for item in specs for t in spec_leaves(item)]
    return [specs]


def optimizer_state_specs(opt_state, leaves, leaf_specs, optimizer=None):
    """Spec tuples for a torch optimizer's `state_dict()` by the structural
    rule of JAX's `optax.tree_map_params`: each state tensor of its
    parameter's shape (a moment) takes that parameter's spec, every other
    leaf (a step count) is replicated. `leaves` / `leaf_specs` are the
    parameters and their specs in the order the optimizer was built over
    them; state ids name `optimizer`'s param groups in order when it is
    given, else `leaves` in order."""
    if optimizer is None:
        by_id = list(range(len(leaves)))
    else:
        where = {id(t): i for i, t in enumerate(leaves)}
        by_id = [where[id(p)] for group in optimizer.param_groups
                 for p in group["params"]]
    state = {}
    for pid, entry in opt_state["state"].items():
        leaf, spec = leaves[by_id[pid]], leaf_specs[by_id[pid]]
        state[pid] = {
            name: spec if (isinstance(v, torch.Tensor)
                           and tuple(v.shape) == tuple(leaf.shape)) else ()
            for name, v in entry.items()}
    return {"state": state, "param_groups": opt_state["param_groups"]}
