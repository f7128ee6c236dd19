"""The tensor-parallel collectives, issued and counted in one place.

Tensor-parallel serving (models/llama.py `tp_axis=`) stitches its shards
back together with two collectives: a sum all-reduce of the residual
stream after each row-parallel product, and a tiled all-gather of the
vocab-sharded logits. Both go through this module, which counts what it
issues: per kind, the calls and the bytes, the way the JAX package's
`parallel/scaling.py:hlo_collective_bytes` counts the result shapes of
a compiled program's collectives (an all-reduce its buffer, an
all-gather its OUTPUT). Eager PyTorch has no compiled program to read,
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

all_reduce_calls = 0
all_reduce_bytes = 0
all_gather_calls = 0
all_gather_bytes = 0


def collective_counts() -> dict:
    """{"all-reduce": {"calls", "bytes"}, "all-gather": {...}} since the
    last reset."""
    return {ALL_REDUCE: dict(calls=all_reduce_calls, bytes=all_reduce_bytes),
            ALL_GATHER: dict(calls=all_gather_calls, bytes=all_gather_bytes)}


def reset_collective_counts() -> None:
    global all_reduce_calls, all_reduce_bytes
    global all_gather_calls, all_gather_bytes
    all_reduce_calls = all_reduce_bytes = 0
    all_gather_calls = all_gather_bytes = 0


def _staged(x: torch.Tensor, group) -> bool:
    """Whether `x` goes through host memory: card tensors on gloo."""
    backend = str(dist.get_backend(group))
    if backend == "nccl" and not x.is_cuda:
        raise ValueError("an NCCL group takes card tensors")
    return x.is_cuda and backend == "gloo"


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, as a new tensor (x is
    left as it is). Counts one call and x's bytes."""
    global all_reduce_calls, all_reduce_bytes
    staged = _staged(x, group)
    y = x.cpu() if staged else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    all_reduce_calls += 1
    all_reduce_bytes += x.numel() * x.element_size()
    return y.to(x.device) if staged else y


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
