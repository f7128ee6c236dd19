"""The multi-device collectives, issued and counted in one place.

Tensor-parallel serving (models/llama.py `tp_axis=`) stitches its shards
back together with two collectives: a sum all-reduce of the residual
stream after each row-parallel product, and a tiled all-gather of the
vocab-sharded logits. Pipeline training (parallel/pipeline.py) adds two
more: `ppermute`, the non-wrapping shift that hands activations to the
next stage and cotangents to the one before, and `all_reduce_max`, the
vocab-parallel cross-entropy's shift. Expert parallelism (models/moe.py
`ep_axis=`) adds `all_to_all_tiled`, which swaps token slots against
expert shards twice an MoE layer. All of them go through this module,
which counts what it issues: per kind, the calls and the bytes, the way
the JAX package's `parallel/scaling.py:hlo_collective_bytes` counts the
result shapes of a compiled program's collectives (an all-reduce its
buffer, an all-gather its OUTPUT, a collective-permute what this rank
sends, an all-to-all its output, which is the size of its input). Eager PyTorch has no compiled program to read,
so the scaling model (parallel/scaling.py `collective_bytes`) reads
these counters instead. `collective_counts()` reads them and
`reset_collective_counts()` zeros them, like the kernels' launch
counters.

Transport: an NCCL group takes the card's tensors as they are; a gloo
group that is handed card tensors stages them through host memory (gloo
moves host buffers). Nothing drops from NCCL to gloo on its own: the
group's backend is the caller's choice. A group of one still issues the
call, so a world of one runs the code of a world of N and counts the
same.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

ALL_REDUCE = "all-reduce"
ALL_GATHER = "all-gather"
PERMUTE = "collective-permute"
ALL_TO_ALL = "all-to-all"

all_reduce_calls = 0
all_reduce_bytes = 0
all_gather_calls = 0
all_gather_bytes = 0
permute_calls = 0
permute_bytes = 0
all_to_all_calls = 0
all_to_all_bytes = 0


def collective_counts() -> dict:
    """{"all-reduce": {"calls", "bytes"}, "all-gather": {...},
    "collective-permute": {...}, "all-to-all": {...}} since the last
    reset."""
    return {ALL_REDUCE: dict(calls=all_reduce_calls, bytes=all_reduce_bytes),
            ALL_GATHER: dict(calls=all_gather_calls, bytes=all_gather_bytes),
            PERMUTE: dict(calls=permute_calls, bytes=permute_bytes),
            ALL_TO_ALL: dict(calls=all_to_all_calls, bytes=all_to_all_bytes)}


def reset_collective_counts() -> None:
    global all_reduce_calls, all_reduce_bytes
    global all_gather_calls, all_gather_bytes
    global permute_calls, permute_bytes
    global all_to_all_calls, all_to_all_bytes
    all_reduce_calls = all_reduce_bytes = 0
    all_gather_calls = all_gather_bytes = 0
    permute_calls = permute_bytes = 0
    all_to_all_calls = all_to_all_bytes = 0


def _staged(x: torch.Tensor, group) -> bool:
    """Whether `x` goes through host memory: card tensors on gloo."""
    backend = str(dist.get_backend(group))
    if backend == "nccl" and not x.is_cuda:
        raise ValueError("an NCCL group takes card tensors")
    return x.is_cuda and backend == "gloo"


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    global all_reduce_calls, all_reduce_bytes
    staged = _staged(x, group)
    y = x.cpu() if staged else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    all_reduce_calls += 1
    all_reduce_bytes += x.numel() * x.element_size()
    return y.to(x.device) if staged else y


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, as a new tensor (x is
    left as it is). Counts one call and x's bytes."""
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `x` over the ranks of `group` (JAX's
    `lax.pmax`), as a new tensor with no autograd history: it is only
    ever a shift that cancels in the result. Counts one "all-reduce"
    call and x's bytes."""
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def ppermute(x: torch.Tensor, group, pairs) -> torch.Tensor:
    """JAX's `lax.ppermute`: every (src, dst) of `pairs` (ranks of
    `group`) sends src's `x` to dst. Returns what this rank received, or
    zeros like `x` when no pair names it as a destination; every rank
    calls with an `x` of the same shape and dtype. Built from
    `batch_isend_irecv`; a pair (r, r) is a copy. Counts one
    "collective-permute" call and the bytes this rank sends."""
    global permute_calls, permute_bytes
    me = dist.get_rank(group)
    sends = [dst for src, dst in pairs if src == me]
    srcs = [src for src, dst in pairs if dst == me]
    if len(srcs) > 1 or len(set(dst for _, dst in pairs)) < len(pairs):
        raise ValueError(f"ppermute pairs {pairs} give a rank two sources")
    staged = _staged(x, group)
    xs = x.detach()
    xs = (xs.cpu() if staged else xs).contiguous()
    out = torch.zeros_like(xs)
    ops = []
    for dst in sends:
        if dst == me:
            out.copy_(xs)
        else:
            ops.append(dist.P2POp(dist.isend, xs,
                                  dist.get_global_rank(group, dst), group))
    if srcs and srcs[0] != me:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, srcs[0]), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    permute_calls += 1
    permute_bytes += len(sends) * x.numel() * x.element_size()
    return out.to(x.device) if staged else out


def all_gather_tiled(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order (JAX's
    `all_gather(x, axis, axis=dim, tiled=True)`): one
    all_gather_into_tensor on dim 0 of x with `dim` moved to the front,
    then the shards moved back to `dim`. Counts one call and the
    output's bytes."""
    global all_gather_calls, all_gather_bytes
    n = dist.get_world_size(group)
    staged = _staged(x, group)
    xm = x.movedim(dim, 0).contiguous()
    if staged:
        xm = xm.cpu()
    out = torch.empty((n * xm.shape[0], *xm.shape[1:]), dtype=x.dtype,
                      device=xm.device)
    dist.all_gather_into_tensor(out, xm, group=group)
    all_gather_calls += 1
    all_gather_bytes += out.numel() * out.element_size()
    out = out.movedim(0, dim).contiguous()
    return out.to(x.device) if staged else out


def _all_to_all(x: torch.Tensor, group, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    """The tiled all-to-all itself (no autograd): `x` cut into n chunks
    along `split_axis`, chunk j sent to rank j, the chunks received
    concatenated along `concat_axis` in rank order."""
    global all_to_all_calls, all_to_all_bytes
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of size {x.shape[split_axis]} "
                         f"does not split over {n} ranks")
    staged = _staged(x, group)
    xm = x.movedim(split_axis, 0)
    xm = xm.reshape(n, xm.shape[0] // n, *xm.shape[1:])
    xm = (xm.cpu() if staged else xm).contiguous()
    out = torch.empty_like(xm)
    dist.all_to_all_single(out, xm, group=group)
    all_to_all_calls += 1
    all_to_all_bytes += x.numel() * x.element_size()
    # out[j] is rank j's chunk with the split dim in front: put the split
    # dim back, then lay the n chunks along concat_axis, rank-major.
    y = out.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(x.shape)
    shape[split_axis] //= n
    shape[concat_axis] *= n
    y = y.reshape(shape)
    return y.to(x.device) if staged else y


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; its transpose is the same call with the two
    axes swapped."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, concat_axis, split_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, ct):
        return _AllToAll.apply(ct, *ctx.args), None, None, None


def all_to_all_tiled(x: torch.Tensor, group, split_axis: int,
                     concat_axis: int) -> torch.Tensor:
    """JAX's `lax.all_to_all(x, axis, split_axis, concat_axis,
    tiled=True)`: x split into n equal chunks along `split_axis` (n the
    group's size), chunk j sent to rank j, the chunks this rank receives
    concatenated along `concat_axis` in rank order. One
    `all_to_all_single` over the chunks made contiguous. Differentiable:
    the backward is the same call with the axes swapped (counted too).
    Counts one "all-to-all" call and x's bytes (the output's size)."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)
