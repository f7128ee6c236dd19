"""Pipeline parallelism: GPipe and 1F1B microbatched training over a
`pp` mesh axis (port of `flash_attention_tpu/parallel/pipeline.py`).

The layer stack splits into `pp` contiguous stages. `split_pipeline_params`
stacks the per-layer dicts into `[n_layers, ...]` leaves (`stages`) and
keeps embed / final_norm / lm_head apart (`shared`); `shard_params` with
`pipeline_shardings`' specs cuts each rank's `[n_layers / pp, ...]` slab
(and, under tp, its Megatron shard and its vocab shard of lm_head).

SPMD, as the rest of parallel/: one process is one rank, every rank calls
the same step on the same global tokens `[M, B, T]` and cuts its own dp
slice (JAX's `P(None, "dp", None)`). A rank holds only its slab, and its
optimizer is built over its local leaves, so the optimizer state lies
where its parameter lies. Activations hop to the next stage and
cotangents to the one before through `collectives.ppermute`, a
non-wrapping shift issued on the same tick by every rank of the pp
group; the last tick of each direction, whose data no rank would use,
issues none.

  * **GPipe** (`make_pp_train_step`): all M forwards over M + S - 1
    ticks (rank r runs microbatch t - r at tick t), each microbatch
    keeping its autograd graph (per layer `torch.utils.checkpoint` under
    `remat`), then the backwards in reverse order over M + S - 1 ticks.
    Rank 0 embeds; the last rank folds the cross-entropy of each
    microbatch, back-propagated with weight 1 / M.
  * **1F1B** (`make_pp_train_step_1f1b`): JAX's timetable of 2M + 2S - 2
    half-ticks; rank r runs the forward of microbatch j at half-tick
    2j + r and its backward at 2j + 2S - 1 - r. A forward runs under
    `torch.no_grad` and keeps only the stage's input, in a FIFO of S; a
    backward recomputes the stage with grad from it and applies the
    arriving cotangent (the last rank runs the tail and its loss
    instead; rank 0 scatter-adds its input cotangent into the embedding
    gradient). Gradients are summed over microbatches, then divided by M.
    The last rank's forward only stores its input: its output would go
    nowhere, and its backward recomputes it.

Unlike JAX's rank-uniform programs (where every rank runs the masked
lm-head every tick), only rank 0 embeds and only the last rank runs the
head; the loss and gradients are the same, the launches are not. Then
the loss is summed over pp (its value only) and averaged over dp; the
shared gradients are summed over pp (a rank that did not use a shared
parameter adds zeros) and every gradient is averaged over dp. These
collectives run on groups of one too, so a world of one issues every
call but the permutes.

Under a mesh with tp > 1 the stages run the Megatron splits
(models/llama.py `tp_axis=`) and the tail is the vocab-parallel
cross-entropy of JAX :271-292 (the max of the detached local maxima,
sums of the exponentials and of the gold logit over tp); without tp the
tail is `loss_fn`'s cross-entropy op for op, so one stage and one
microbatch give the dense step's bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

# As a module: models/llama.py imports parallel/collectives.py, which runs
# this package's __init__ and so this module while llama is half made.
from flash_attention_tpu_torch.models import llama
from flash_attention_tpu_torch.parallel.collectives import (
    all_reduce_max,
    all_reduce_sum,
    ppermute,
)
from flash_attention_tpu_torch.parallel.mesh import (
    optimizer_state_specs,
    spec_leaves,
)

SHARED_KEYS = ("embed", "final_norm", "lm_head")


def split_pipeline_params(params, n_stages: int):
    """Split a Llama parameter tree into (stages, shared): stages the
    per-layer dicts stacked on a leading layer dim [n_layers, ...] (new
    tensors), shared embed / final_norm / lm_head (the tree's own
    tensors). n_layers must divide by n_stages."""
    layers = params["layers"]
    if len(layers) % n_stages:
        raise ValueError(
            f"n_layers={len(layers)} not divisible by pp={n_stages}")
    with torch.no_grad():
        stages = {k: torch.stack([layer[k] for layer in layers])
                  for k in layers[0]}
    return stages, {k: params[k] for k in SHARED_KEYS}


def merge_pipeline_params(stages, shared):
    """Inverse of split_pipeline_params (checkpoint interchange): a plain
    tree whose layers are copies of the stacked slices."""
    n_layers = next(iter(stages.values())).shape[0]
    with torch.no_grad():
        layers = [{k: v[i].clone() for k, v in stages.items()}
                  for i in range(n_layers)]
    return {"layers": layers, **shared}


def _stage_leaf_specs(cfg, tp_axis):
    """Spec tuples for the stacked stage tree: layer dim on pp and, with
    `tp_axis`, the head / ffn dims on it (Megatron's splits)."""
    if tp_axis is None:
        return {k: ("pp",) for k in ("attn_norm", "wq", "wk", "wv", "wo",
                                     "mlp_norm", "w_gate", "w_up",
                                     "w_down")}
    return {
        "attn_norm": ("pp",),
        "wq": ("pp", None, tp_axis, None),
        "wk": ("pp", None, tp_axis, None),
        "wv": ("pp", None, tp_axis, None),
        "wo": ("pp", tp_axis, None, None),
        "mlp_norm": ("pp",),
        "w_gate": ("pp", None, tp_axis),
        "w_up": ("pp", None, tp_axis),
        "w_down": ("pp", tp_axis, None),
    }


def pipeline_shardings(mesh, stages, shared, opt_state=None, *,
                       optimizer=None, tp_axis=None):
    """Spec tuples (what parallel/mesh.py `shard_params` and
    `gather_params` take) placing the stacked stages over pp (and, with
    `tp_axis`, head / ffn dims over it) and the shared params replicated
    (lm_head split over the vocab under tp). Returns (stage_specs,
    shared_specs), plus opt_specs when `opt_state` is given.

    `opt_state` is a torch optimizer's `state_dict()`. Its specs follow
    the structural rule of the JAX function (optax.tree_map_params): each
    state tensor of a parameter's shape (a moment) takes that parameter's
    spec, every other leaf (a step count) is replicated -- no rule by
    dim 0, so an embed moment whose dim 0 equals n_layers stays
    replicated. State ids name the parameters of `optimizer`'s param
    groups in order when it is given, else `param_leaves((stages,
    shared))` in order (how the Trainer builds its optimizer). `mesh` is
    JAX's argument; a spec tuple names axes and needs no mesh."""
    del mesh
    stage_specs = _stage_leaf_specs(None, tp_axis)
    stage_tree = {k: stage_specs[k] for k in stages}
    shared_tree = {"embed": (), "final_norm": (),
                   "lm_head": (None, tp_axis) if tp_axis else ()}
    out = (stage_tree, shared_tree)
    if opt_state is None:
        return out
    return out + (optimizer_state_specs(
        opt_state, llama.param_leaves((stages, shared)),
        spec_leaves(stage_tree) + spec_leaves(shared_tree), optimizer),)


# --- the stage and its tail ----------------------------------------------


class _Axes:
    """This rank's place on the mesh: its pp stage, dp slice and tp
    group (None at tp = 1)."""

    def __init__(self, mesh):
        self.S = mesh["pp"].size()
        self.r = mesh.get_local_rank("pp")
        self.pp = mesh.get_group("pp")
        self.dp = mesh["dp"].size()
        self.dp_rank = mesh.get_local_rank("dp")
        self.dp_group = mesh.get_group("dp")
        self.tp = mesh.get_group("tp") if mesh["tp"].size() > 1 else None
        self.tp_rank = mesh.get_local_rank("tp")
        self.first, self.last = self.r == 0, self.r == self.S - 1


def _layer_fn(x, layer, cfg, positions, tp_axis):
    a, _ = llama._attention_block(layer, x, cfg, positions,
                                  tp_axis=tp_axis)
    x = x + a
    return x + llama._mlp_block(layer, x, cfg, tp_axis=tp_axis)


def _apply_stage(stages, x, cfg, positions, tp_axis, remat=False):
    """This rank's layers over x, in order (each layer a view of the
    stacked leaves; under `remat` each recomputed in the backward)."""
    cols = {k: v.unbind(0) for k, v in stages.items()}
    for i in range(len(next(iter(cols.values())))):
        layer = {k: c[i] for k, c in cols.items()}
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _layer_fn, x, layer, cfg, positions, tp_axis,
                use_reentrant=False)
        else:
            x = _layer_fn(x, layer, cfg, positions, tp_axis)
    return x


def _tail_loss(shared, y, targets, cfg, ax: _Axes):
    """Final norm -> lm_head -> mean next-token cross-entropy (fp32
    logits): `loss_fn`'s ops without tp, the vocab-parallel form with."""
    h = llama.tp_copy(
        llama.rmsnorm(y, shared["final_norm"], cfg.norm_eps), ax.tp)
    logits = llama._mm("btd,dv->btv", h, shared["lm_head"]).float()
    if ax.tp is None:
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))
    v_local = logits.shape[-1]
    # The shift cancels in logz, so its max carries no gradient.
    m = all_reduce_max(logits.detach().amax(dim=-1), ax.tp)
    sumexp = llama._psum(torch.exp(logits - m[..., None]).sum(dim=-1),
                         ax.tp)
    logz = m + torch.log(sumexp)
    tloc = targets - ax.tp_rank * v_local
    hit = (tloc >= 0) & (tloc < v_local)
    gold = logits.gather(-1, tloc.clamp(0, v_local - 1)[..., None])[..., 0]
    gold = llama._psum(torch.where(hit, gold, torch.zeros_like(gold)),
                       ax.tp)
    return (logz - gold).mean()


def _local_tokens(tokens, ax: _Axes, device) -> torch.Tensor:
    """This rank's dp slice [M, B / dp, T] of the global tokens."""
    tok = torch.as_tensor(tokens, device=device).long()
    b = tok.shape[1]
    if b % ax.dp:
        raise ValueError(f"batch {b} does not split over dp={ax.dp}")
    c = b // ax.dp
    return tok[:, ax.dp_rank * c:(ax.dp_rank + 1) * c]


def _reduce(ax: _Axes, loss_vals, m, device):
    """The step's loss: the mean of the last rank's microbatch losses,
    summed over pp (the other ranks add zeros), averaged over dp."""
    loss = (torch.stack(loss_vals).sum() / m if loss_vals else
            torch.zeros((), dtype=torch.float32, device=device))
    loss = all_reduce_sum(loss, ax.pp)
    loss = all_reduce_sum(loss, ax.dp_group)
    return loss / ax.dp if ax.dp > 1 else loss


def _reduce_grads(ax: _Axes, stages, shared, divide: int = 1) -> None:
    """Gradients divided by `divide`, the shared ones summed over pp (a
    rank that did not use one holds zeros), then every one averaged
    over dp; written back to `.grad`."""
    for name, p in [*sorted(stages.items()), *sorted(shared.items())]:
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if divide != 1:
            g = g / divide
        if name in SHARED_KEYS:
            g = all_reduce_sum(g, ax.pp)
        g = all_reduce_sum(g, ax.dp_group)
        p.grad = g / ax.dp if ax.dp > 1 else g


# --- GPipe -----------------------------------------------------------------


def _gpipe(ax: _Axes, cfg, stages, shared, tokens, *, remat=False,
           train=True):
    """The GPipe schedule on this rank; returns the loss (pp- and
    dp-reduced). With `train`, gradients land in the leaves' `.grad`
    (not yet reduced)."""
    dev = shared["embed"].device
    tok = _local_tokens(tokens, ax, dev)
    m, b, t = tok.shape
    positions = torch.arange(t - 1, dtype=torch.int32, device=dev)
    S, r = ax.S, ax.r
    zeros = torch.zeros((b, t - 1, cfg.dim), dtype=shared["embed"].dtype,
                        device=dev)
    ticks = m + S - 1
    xs, ys, losses = [None] * m, [None] * m, []
    recv = None
    with torch.set_grad_enabled(train):
        for tick in range(ticks):
            j, y = tick - r, None
            if 0 <= j < m:
                x = (F.embedding(tok[j, :, :-1], shared["embed"])
                     if ax.first else recv.requires_grad_(train))
                y = _apply_stage(stages, x, cfg, positions, ax.tp, remat)
                if ax.last:
                    losses.append(_tail_loss(shared, y, tok[j, :, 1:], cfg,
                                             ax))
                elif train:
                    ys[j] = y
                if train:
                    xs[j] = x
            if S > 1 and tick < ticks - 1:
                recv = ppermute(y if y is not None else zeros, ax.pp,
                                [(i, i + 1) for i in range(S - 1)])
    loss_vals = [v.detach() for v in losses]
    if train:
        grad_in = None
        for tick in range(ticks):
            j, gx = m - 1 - tick + (S - 1 - r), None
            if 0 <= j < m:
                if ax.last:
                    (losses[j] / m).backward()
                    losses[j] = None
                else:
                    torch.autograd.backward(ys[j], grad_in)
                    ys[j] = None
                if not ax.first:
                    gx, xs[j] = xs[j].grad, None
            if S > 1 and tick < ticks - 1:
                grad_in = ppermute(gx if gx is not None else zeros, ax.pp,
                                   [(i, i - 1) for i in range(1, S)])
    return _reduce(ax, loss_vals, m, dev)


def make_pp_train_step(mesh, cfg, *, remat: bool = False):
    """`step(stages, shared, optimizer, tokens) -> loss`: one GPipe
    optimizer step on tokens [M, B, T] (B split over dp), updating this
    rank's stage slab, the shared params and `optimizer` (a torch
    optimizer over their leaves, which must require grad) in place. The
    loss is the mean next-token cross-entropy over microbatches and dp
    slices, a 0-d fp32 tensor on the parameters' device (no host sync).
    The JAX step takes an optax optimizer and returns new trees."""
    ax = _Axes(mesh)

    def step(stages, shared, optimizer, tokens):
        optimizer.zero_grad(set_to_none=True)
        loss = _gpipe(ax, cfg, stages, shared, tokens, remat=remat)
        _reduce_grads(ax, stages, shared)
        optimizer.step()
        return loss

    return step


def make_pp_loss(mesh, cfg):
    """Forward-only pipelined loss `fn(stages, shared, tokens) -> loss`
    (evaluation): the GPipe schedule's forward under torch.no_grad."""
    ax = _Axes(mesh)

    def fn(stages, shared, tokens):
        return _gpipe(ax, cfg, stages, shared, tokens, train=False)

    return fn


# --- 1F1B ------------------------------------------------------------------


def _microbatch_at(d: int, m: int):
    """The microbatch a rank runs `d` half-ticks after its first slot of
    a direction, or None (odd offsets and the drained ticks)."""
    return d // 2 if d >= 0 and d % 2 == 0 and d // 2 < m else None


def _one_f_one_b(ax: _Axes, cfg, stages, shared, tokens):
    """The 1F1B schedule on this rank; returns (the pp- and dp-reduced
    loss, M). Gradients land in the leaves' `.grad`, summed over the
    microbatches and not yet reduced."""
    dev = shared["embed"].device
    tok = _local_tokens(tokens, ax, dev)
    m, b, t = tok.shape
    positions = torch.arange(t - 1, dtype=torch.int32, device=dev)
    S, r = ax.S, ax.r
    zeros = torch.zeros((b, t - 1, cfg.dim), dtype=shared["embed"].dtype,
                        device=dev)
    embed = shared["embed"]
    fifo, loss_vals = [None] * S, []
    x_in = g_in = None
    for h in range(2 * m + 2 * S - 2):
        jf = _microbatch_at(h - r, m)
        jb = _microbatch_at(h - (2 * S - 1 - r), m)
        y_out = g_out = None
        if jf is not None:
            with torch.no_grad():
                x = (F.embedding(tok[jf, :, :-1], embed) if ax.first
                     else x_in)
                fifo[jf % S] = x
                if not ax.last:
                    y_out = _apply_stage(stages, x, cfg, positions, ax.tp)
        if jb is not None:
            x = fifo[jb % S].requires_grad_()
            fifo[jb % S] = None
            with torch.enable_grad():
                y = _apply_stage(stages, x, cfg, positions, ax.tp)
                if ax.last:
                    loss = _tail_loss(shared, y, tok[jb, :, 1:], cfg, ax)
                    loss.backward()
                    loss_vals.append(loss.detach())
                else:
                    torch.autograd.backward(y, g_in)
            if ax.first:
                # F.embedding's own backward: a scatter-add of the input
                # cotangent into the embedding rows, in a fixed order.
                g = torch.ops.aten.embedding_backward(
                    x.grad, tok[jb, :, :-1], embed.shape[0], -1, False,
                    False)
                embed.grad = g if embed.grad is None else embed.grad.add_(g)
            else:
                g_out = x.grad
        if S > 1 and any(_microbatch_at(h - q, m) is not None
                         for q in range(S - 1)):
            x_in = ppermute(y_out if y_out is not None else zeros, ax.pp,
                            [(i, i + 1) for i in range(S - 1)])
        if S > 1 and any(_microbatch_at(h - (2 * S - 1 - q), m) is not None
                         for q in range(1, S)):
            g_in = ppermute(g_out if g_out is not None else zeros, ax.pp,
                            [(i, i - 1) for i in range(1, S)])
    return _reduce(ax, loss_vals, m, dev), m


def make_pp_train_step_1f1b(mesh, cfg):
    """`step(stages, shared, optimizer, tokens) -> loss`: one 1F1B
    optimizer step (see the module docstring), in place like
    `make_pp_train_step`. Under a mesh with tp > 1 the stages run the
    Megatron splits and the tail the vocab-parallel cross-entropy."""
    ax = _Axes(mesh)

    def step(stages, shared, optimizer, tokens):
        optimizer.zero_grad(set_to_none=True)
        loss, m = _one_f_one_b(ax, cfg, stages, shared, tokens)
        _reduce_grads(ax, stages, shared, divide=m)
        optimizer.step()
        return loss

    return step
