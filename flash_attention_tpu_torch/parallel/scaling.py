"""Analytic decode-scaling model, fed by measured inputs (port of
`flash_attention_tpu/parallel/scaling.py`).

    predicted t_step(N) =  weight_read(N) + kv_read(N)
                         + sum over collectives of ring_time(bytes, N)
    efficiency(N)       =  t_step(1) / (N * t_step(N))

Every input is either counted by the program or a figure of the fabric
and the card, passed by the caller:

  * collective bytes per decode step come from the port's own
    collectives (parallel/collectives.py counts each all-reduce's buffer
    and each all-gather's output) while one tensor-parallel decode step
    runs (`tp_decode_collective_bytes`): if the Megatron layout regresses
    (an extra gather), the model's inputs change and the tests see it.
    The JAX module reads the same numbers from a compiled program's
    optimized HLO (`hlo_collective_bytes` and its parser); eager PyTorch
    compiles no program, so they have no counterpart here and
    `collective_bytes` counts the calls instead;
  * the fabric (`Fabric`: per-rank ring bandwidth and per-hop latency)
    and the effective HBM bandwidth (`DecodeStepCosts.hbm_bw`) have no
    defaults: the JAX module's are TPU v5e figures, which say nothing of
    this card. Pass a measured weight-read bandwidth (chip_smoke.py's
    `tp` phase prints the 70B decode step's, with the card's name and
    power limit) and a fabric's published or measured figures.

The model covers the two deployment shapes: data-parallel replicas (no
per-step collectives; efficiency bounded by the scheduler) and tensor
parallelism (per-layer all-reduces and the logits gather).
"""

from __future__ import annotations

import dataclasses

import torch

from flash_attention_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class Fabric:
    """Link parameters of one mesh axis."""

    bandwidth: float              # usable B/s per rank along the ring
    latency: float                # per-hop latency (s)


def ring_all_reduce_time(nbytes: int, n: int, fabric: Fabric) -> float:
    """Ring all-reduce: each rank moves 2(N-1)/N of the buffer, in
    2(N-1) latency-bound steps."""
    if n <= 1:
        return 0.0
    return (2 * (n - 1) / n) * nbytes / fabric.bandwidth \
        + 2 * (n - 1) * fabric.latency


def ring_all_gather_time(nbytes_out: int, n: int, fabric: Fabric) -> float:
    if n <= 1:
        return 0.0
    return ((n - 1) / n) * nbytes_out / fabric.bandwidth \
        + (n - 1) * fabric.latency


@dataclasses.dataclass(frozen=True)
class DecodeStepCosts:
    """Per-decode-step inputs of the model (one rank's view at TP=1)."""

    weight_bytes: int             # full weight read per step
    kv_bytes: int                 # KV-cache read per step (batch total)
    # Per-step collective bytes AT TP=tp_measured, counted by
    # collective_bytes over the sharded step.
    all_reduce_bytes: int
    all_gather_bytes: int
    tp_measured: int
    hbm_bw: float                 # measured effective, not the plate rate


def predict_tp_decode(costs: DecodeStepCosts, n: int,
                      fabric: Fabric) -> dict:
    """Predicted decode step time and scaling efficiency at TP=n.

    Collective buffers are activation-shaped ([batch, dim] class), so
    the all-reduce's is independent of tp and the logits all-gather's
    output is the full row at every tp; the counts at tp_measured
    rescale accordingly."""
    t_hbm = (costs.weight_bytes / n + costs.kv_bytes / n) / costs.hbm_bw
    ar = ring_all_reduce_time(costs.all_reduce_bytes, n, fabric)
    ag = ring_all_gather_time(
        costs.all_gather_bytes * costs.tp_measured, n, fabric)
    t = t_hbm + ar + ag
    t1 = (costs.weight_bytes + costs.kv_bytes) / costs.hbm_bw
    return {
        "t_step": t,
        "t_hbm": t_hbm,
        "t_collective": ar + ag,
        "efficiency": t1 / (n * t) if n >= 1 else float("nan"),
    }


def predict_dp_decode(n_hosts: int, *, dispatch_overhead: float = 0.02
                      ) -> dict:
    """Data-parallel replicas exchange nothing per step; the only
    scaling loss is request-routing / dispatch skew, modelled as a fixed
    overhead fraction."""
    return {"efficiency": 1.0 - dispatch_overhead, "n_hosts": n_hosts}


def collective_bytes(fn, *args, **kw) -> dict:
    """The bytes of the collectives that one call fn(*args, **kw) issues
    through parallel/collectives.py, by kind ("all-reduce": the buffers,
    "all-gather" and "all-to-all": the outputs, "collective-permute":
    what this rank sends), kinds it did not issue left out: the
    counterpart of the JAX `hlo_collective_bytes` of a compiled step."""
    before = collectives.collective_counts()
    fn(*args, **kw)
    after = collectives.collective_counts()
    return {kind: after[kind]["bytes"] - before[kind]["bytes"]
            for kind in after
            if after[kind]["calls"] > before[kind]["calls"]}


def tp_decode_collective_bytes(cfg, tp: int, batch: int, devices=None, *,
                               device="cuda") -> dict:
    """Run one tensor-parallel decode_step_paged of `cfg` at `batch` and
    return its collective bytes (collective_bytes). Call it on every
    rank of a world (initialize_distributed) holding tp ranks, or
    `devices` naming tp * dp of them: the mesh is make_mesh(tp=tp,
    dp=-1). The parameters are init_params(cfg, seed 0) cut by
    serving_param_shardings through shard_params, and the pools JAX's
    tiny ones (4 pages of 128, a tail of 16) with this rank's
    n_kv_heads / tp heads. A cut-depth config extrapolates linearly: the
    collectives are per-layer all-reduces and one logits all-gather."""
    from flash_attention_tpu_torch.config import resolve_device
    from flash_attention_tpu_torch.models.llama import (
        decode_step_paged, init_params, serving_param_shardings,
    )
    from flash_attention_tpu_torch.parallel.mesh import make_mesh, shard_params

    dev = resolve_device(device)
    mesh = make_mesh(tp=tp, dp=-1, devices=devices, device_type=dev.type)
    params = shard_params(init_params(cfg, seed=0, device=dev),
                          serving_param_shardings(cfg, tp), mesh,
                          device=dev)
    hkv, hd, n_layers = cfg.n_kv_heads // tp, cfg.head_dim, cfg.n_layers
    pages, ps, tail = 4, 128, 16

    def zeros(*shape):
        return [torch.zeros(shape, dtype=cfg.dtype, device=dev)
                for _ in range(n_layers)]

    kp, vp = zeros(hkv, pages, ps, hd), zeros(hkv, pages, ps, hd)
    kt, vt = zeros(batch, hkv, tail, hd), zeros(batch, hkv, tail, hd)
    i32 = dict(dtype=torch.int32, device=dev)
    toks = torch.zeros(batch, **i32)
    tables = torch.arange(batch * 2, **i32).reshape(batch, 2) % pages
    lens = torch.full((batch,), ps, **i32)
    tpos = torch.zeros(batch, **i32)
    return collective_bytes(
        decode_step_paged, params, toks, cfg, kp, vp, kt, vt, tables, lens,
        tpos, tp_axis=mesh.get_group("tp"))
