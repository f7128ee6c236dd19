"""Training loop with checkpoint/resume (port of
`flash_attention_tpu/models/trainer.py`: `family="dense"` on one device,
`family="pipeline"` and `family="moe"` over a mesh).

The Trainer owns (params, optimizer, step): it runs the family's train
step in place, checkpoints `{"params", "opt_state", "step"}` through
utils/checkpoint.py every `ckpt_every` steps, and in `__init__` resumes
from the newest checkpoint of `ckpt_dir`.

  * ``dense``    -- `make_train_step` on one device; tokens [B, T].
  * ``pipeline`` -- parallel/pipeline.py's GPipe (`pp_schedule="gpipe"`,
                   `remat` per layer) or 1F1B (`"1f1b"`) over a mesh with
                   a pp axis (and dp; tp composes); `self.params` is this
                   rank's `(stages, shared)` and tokens are [M, B, T]
                   (utils/data.py `microbatched`). SPMD: every rank draws
                   the same global tree from `seed`, splits it and keeps
                   its slab. A checkpoint is the JAX package's global
                   layout: every rank gathers its slabs and optimizer
                   moments, the mesh's first rank writes them, and a
                   restore cuts each rank's slab again, so
                   `merge_pipeline_params(*state["params"])` reads one
                   into a plain tree.
  * ``moe``      -- models/moe.py `make_moe_train_step` over a mesh with
                   an ep axis (and dp; JAX :155-176, :212-215): every rank
                   draws the same `init_moe_params` tree from `seed` and
                   keeps its shard (`moe_param_shardings`: the expert
                   stacks over ep); tokens [B, T] split over (dp, ep).
                   The last step's router metrics ("ce", "load_balance",
                   "router_z", "dropped_frac") land in `last_metrics`. A
                   checkpoint is the JAX package's global tree (the
                   expert stacks and their moments gathered over ep),
                   written and restored as the pipeline's.

The JAX Trainer takes an optax transformation, a stateless spec. A torch
optimizer binds to tensors, so this one takes a factory,
`params_iterable -> torch.optim.Optimizer`, and calls it on the
parameters it creates (a pipeline rank: its local leaves, so the state
lies where its parameter lies), e.g.
`functools.partial(torch.optim.AdamW, lr=1e-4, weight_decay=1e-4)`.
Pass `weight_decay` explicitly: optax.adamw's default is 1e-4,
torch.optim.AdamW's 1e-2; the update rules otherwise agree (decoupled
decay scaled by lr, eps added to sqrt(v_hat), decay on every leaf).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Iterator

import torch
import torch.distributed as dist

from flash_attention_tpu_torch.config import resolve_device
from flash_attention_tpu_torch.models.llama import (
    init_params,
    make_train_step,
    param_leaves,
)
from flash_attention_tpu_torch.utils.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    max_to_keep: int = 3
    remat: bool = False
    log_every: int = 10


class Trainer:
    """Owns (params, optimizer, step_num); runs the train step in place
    and checkpoints/resumes. `family="dense"` runs on one device (its
    `mesh=` / `tp_size=` sharding, ROADMAP multi-device 2f, raises
    NotImplementedError); `family="pipeline"` needs `mesh` with a pp axis
    and takes `pp_schedule` "gpipe" or "1f1b"; `family="moe"` needs
    `mesh` with an ep axis (ValueError otherwise, as in JAX)."""

    def __init__(self, cfg,
                 optimizer: Callable[[Iterable], torch.optim.Optimizer], *,
                 trainer_cfg: TrainerConfig | None = None, mesh=None,
                 tp_size: int | None = None, seed: int = 0,
                 family: str = "dense", pp_schedule: str = "gpipe",
                 device="cuda"):
        if family not in ("dense", "pipeline", "moe"):
            raise ValueError(
                f"unknown family {family!r} "
                "(expected dense | pipeline | moe)")
        if family == "moe" and (
                mesh is None or "ep" not in (mesh.mesh_dim_names or ())):
            raise ValueError("family='moe' needs a mesh with 'dp' and "
                             "'ep' axes")
        if family == "dense" and (mesh is not None or tp_size is not None):
            raise NotImplementedError(
                "sharded dense training (mesh=, tp_size=) arrives with the "
                "multi-device slice 2f (ROADMAP section A item 2)")
        if family == "pipeline":
            if mesh is None or "pp" not in (mesh.mesh_dim_names or ()):
                raise ValueError("family='pipeline' needs a mesh with a "
                                 "'pp' axis (and 'dp'; optionally 'tp')")
            if pp_schedule not in ("gpipe", "1f1b"):
                raise ValueError(f"unknown pp_schedule {pp_schedule!r} "
                                 "(expected gpipe | 1f1b)")
        self.cfg = cfg
        self.tc = trainer_cfg or TrainerConfig()
        self.mesh = mesh
        self.family = family
        self.step_num = 0
        self.last_metrics: dict | None = None
        self.device = resolve_device(device)
        if family == "pipeline":
            self._init_pipeline(seed, pp_schedule)
        elif family == "moe":
            self._init_moe(seed)
        else:
            self.params = init_params(cfg, seed, device=self.device)
            self._step_fn = make_train_step(cfg, remat=self.tc.remat)
        for leaf in param_leaves(self.params):
            leaf.requires_grad_(True)
        self.optimizer = optimizer(param_leaves(self.params))

        if self.tc.ckpt_dir is not None:
            last = latest_step(self.tc.ckpt_dir)
            if last is not None:
                self.restore(last)

    def _init_pipeline(self, seed, pp_schedule) -> None:
        from flash_attention_tpu_torch.parallel.mesh import shard_params
        from flash_attention_tpu_torch.parallel.pipeline import (
            make_pp_train_step, make_pp_train_step_1f1b,
            pipeline_shardings, split_pipeline_params,
        )

        mesh = self.mesh
        self._step_fn = (
            make_pp_train_step(mesh, self.cfg, remat=self.tc.remat)
            if pp_schedule == "gpipe" else
            make_pp_train_step_1f1b(mesh, self.cfg))
        self._tp_axis = "tp" if mesh["tp"].size() > 1 else None
        stages, shared = split_pipeline_params(
            init_params(self.cfg, seed, device=self.device),
            mesh["pp"].size())
        st_s, sh_s = pipeline_shardings(mesh, stages, shared,
                                        tp_axis=self._tp_axis)
        self.params = (shard_params(stages, st_s, mesh, device=self.device),
                       shard_params(shared, sh_s, mesh, device=self.device))

    def _init_moe(self, seed) -> None:
        from flash_attention_tpu_torch.models.moe import (
            init_moe_params, make_moe_train_step, moe_param_shardings,
        )
        from flash_attention_tpu_torch.parallel.mesh import shard_params

        self._step_fn = make_moe_train_step(self.mesh, self.cfg,
                                            remat=self.tc.remat)
        self.params = shard_params(
            init_moe_params(self.cfg, seed, device=self.device),
            moe_param_shardings(self.cfg), self.mesh, device=self.device)

    # --- checkpointing --------------------------------------------------

    def _sharded(self) -> bool:
        return self.family in ("pipeline", "moe")

    def _moe_specs(self, opt=None, params=None):
        """The MoE tree's specs, and with `opt` (a state_dict of
        self.optimizer's structure) its optimizer state's."""
        from flash_attention_tpu_torch.models.moe import moe_param_shardings
        from flash_attention_tpu_torch.parallel.mesh import (
            optimizer_state_specs, spec_leaves,
        )

        specs = moe_param_shardings(self.cfg)
        if opt is None:
            return specs
        leaves = param_leaves(self.params if params is None else params)
        return specs, optimizer_state_specs(
            opt, leaves, spec_leaves(specs),
            self.optimizer if params is None else None)

    def _state(self):
        """The state to save: this process's trees, or for a pipeline or
        an MoE mesh the global layout gathered over the mesh (a
        collective: every rank calls)."""
        if not self._sharded():
            return {"params": self.params,
                    "opt_state": self.optimizer.state_dict(),
                    "step": self.step_num}
        from flash_attention_tpu_torch.parallel.mesh import gather_params

        opt = self.optimizer.state_dict()
        if self.family == "moe":
            specs, o_s = self._moe_specs(opt)
            params = gather_params(self.params, specs, self.mesh)
        else:
            from flash_attention_tpu_torch.parallel.pipeline import (
                pipeline_shardings,
            )

            st_s, sh_s, o_s = pipeline_shardings(
                self.mesh, *self.params, opt, optimizer=self.optimizer,
                tp_axis=self._tp_axis)
            params = (gather_params(self.params[0], st_s, self.mesh),
                      gather_params(self.params[1], sh_s, self.mesh))
        return {"params": params,
                "opt_state": gather_params(opt, o_s, self.mesh),
                "step": self.step_num}

    def _writes(self) -> bool:
        return (not self._sharded()
                or dist.get_rank() == int(self.mesh.mesh.flatten()[0]))

    def _barrier(self) -> None:
        """Every rank of the mesh waits for the others (one barrier an
        axis): no rank looks for a checkpoint before it is written."""
        if self._sharded():
            for axis in self.mesh.mesh_dim_names:
                dist.barrier(group=self.mesh.get_group(axis))

    def save(self) -> None:
        if self.tc.ckpt_dir is None:
            return
        state = self._state()
        if self._writes():
            save_checkpoint(self.tc.ckpt_dir, self.step_num, state,
                            max_to_keep=self.tc.max_to_keep)
        self._barrier()

    def restore(self, step: int | None = None) -> int:
        if self._sharded():
            step, state = restore_checkpoint(self.tc.ckpt_dir, step=step)
            params, opt = self._slab(state)
        else:
            step, state = restore_checkpoint(
                self.tc.ckpt_dir, step=step, template=self._state())
            params, opt = state["params"], state["opt_state"]
        # Copy into the live tensors, which the optimizer is bound to.
        with torch.no_grad():
            for live, saved in zip(param_leaves(self.params),
                                   param_leaves(params), strict=True):
                live.copy_(saved)
        # load_state_dict moves the moments to their parameters' devices.
        self.optimizer.load_state_dict(opt)
        self.step_num = int(state["step"])
        return self.step_num

    def _slab(self, state):
        """This rank's slab of a global checkpoint: its params (a
        pipeline's stage and shared params, an MoE mesh's expert band and
        the replicated leaves) and its optimizer state."""
        from flash_attention_tpu_torch.parallel.mesh import shard_params

        opt = state["opt_state"]
        if self.family == "moe":
            specs, o_s = self._moe_specs(opt, params=state["params"])
            params = shard_params(state["params"], specs, self.mesh,
                                  device=self.device)
        else:
            from flash_attention_tpu_torch.parallel.pipeline import (
                pipeline_shardings,
            )

            stages, shared = state["params"]
            st_s, sh_s, o_s = pipeline_shardings(
                self.mesh, stages, shared, opt, tp_axis=self._tp_axis)
            params = (shard_params(stages, st_s, self.mesh,
                                   device=self.device),
                      shard_params(shared, sh_s, self.mesh,
                                   device=self.device))
        opt = dict(opt, state=shard_params(opt["state"], o_s["state"],
                                           self.mesh, device="cpu"))
        return params, opt

    # --- loop -------------------------------------------------------------

    def train_step(self, tokens) -> torch.Tensor:
        """One step on tokens [B, T] ([M, B, T] for a pipeline; numpy or
        tensor); the loss comes back as a 0-d device tensor (no host
        sync). An MoE step also sets `last_metrics`."""
        if self.family == "pipeline":
            loss = self._step_fn(*self.params, self.optimizer, tokens)
        elif self.family == "moe":
            loss, self.last_metrics = self._step_fn(
                self.params, self.optimizer, tokens)
        else:
            loss = self._step_fn(self.params, self.optimizer, tokens)
        self.step_num += 1
        if (self.tc.ckpt_dir is not None
                and self.step_num % self.tc.ckpt_every == 0):
            self.save()
        return loss

    def fit(self, batches: Iterator, *, steps: int,
            log: Callable[[str], None] = print) -> list[float]:
        """Run `steps` steps from `batches`; returns the loss history.
        Syncs with the device only when it logs."""
        losses = []
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = self.train_step(next(batches))
            losses.append(loss)
            if self.step_num % self.tc.log_every == 0:
                loss_f = float(loss)  # sync point, only when logging
                dt = time.perf_counter() - t0
                log(f"step {self.step_num}: loss={loss_f:.4f} "
                    f"({dt / max(len(losses), 1):.3f} s/step)")
        return [float(x) for x in losses]
