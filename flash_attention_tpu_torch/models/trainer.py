"""Training loop with checkpoint/resume (port of
`flash_attention_tpu/models/trainer.py`, `family="dense"` on one
device).

The Trainer owns (params, optimizer, step): it runs `make_train_step`,
checkpoints `{"params", "opt_state", "step"}` through
utils/checkpoint.py every `ckpt_every` steps, and in `__init__` resumes
from the newest checkpoint of `ckpt_dir`.

The JAX Trainer takes an optax transformation, a stateless spec. A torch
optimizer binds to tensors, so this one takes a factory,
`params_iterable -> torch.optim.Optimizer`, and calls it on the
parameters it creates, e.g.
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
    and checkpoints/resumes. Only `family="dense"` on one device is
    ported: the pipeline and MoE families and `mesh=` raise
    NotImplementedError until their slices land."""

    def __init__(self, cfg,
                 optimizer: Callable[[Iterable], torch.optim.Optimizer], *,
                 trainer_cfg: TrainerConfig | None = None, mesh=None,
                 tp_size: int | None = None, seed: int = 0,
                 family: str = "dense", device="cuda"):
        if family not in ("dense", "pipeline", "moe"):
            raise ValueError(
                f"unknown family {family!r} "
                "(expected dense | pipeline | moe)")
        if family == "pipeline":
            raise NotImplementedError(
                "family='pipeline' arrives with the multi-device slice")
        if family == "moe":
            raise NotImplementedError(
                "family='moe' (MoE training: expert-parallel mesh, "
                "capacity routing) arrives with the multi-device slice")
        if mesh is not None or tp_size is not None:
            raise NotImplementedError(
                "sharded training (mesh=, tp_size=) arrives with the "
                "multi-device slice")
        self.cfg = cfg
        self.tc = trainer_cfg or TrainerConfig()
        self.family = family
        self.step_num = 0
        self.params = init_params(cfg, seed, device=device)
        for leaf in param_leaves(self.params):
            leaf.requires_grad_(True)
        self.optimizer = optimizer(param_leaves(self.params))
        self._step_fn = make_train_step(cfg, remat=self.tc.remat)

        if self.tc.ckpt_dir is not None:
            last = latest_step(self.tc.ckpt_dir)
            if last is not None:
                self.restore(last)

    # --- checkpointing --------------------------------------------------

    def _state(self):
        return {"params": self.params,
                "opt_state": self.optimizer.state_dict(),
                "step": self.step_num}

    def save(self) -> None:
        if self.tc.ckpt_dir is None:
            return
        save_checkpoint(self.tc.ckpt_dir, self.step_num, self._state(),
                        max_to_keep=self.tc.max_to_keep)

    def restore(self, step: int | None = None) -> int:
        step, state = restore_checkpoint(
            self.tc.ckpt_dir, step=step, template=self._state())
        # Copy into the live tensors, which the optimizer is bound to.
        with torch.no_grad():
            for live, saved in zip(param_leaves(self.params),
                                   param_leaves(state["params"]),
                                   strict=True):
                live.copy_(saved)
        # load_state_dict moves the moments to their parameters' devices.
        self.optimizer.load_state_dict(state["opt_state"])
        self.step_num = int(state["step"])
        return self.step_num

    # --- loop -------------------------------------------------------------

    def train_step(self, tokens) -> torch.Tensor:
        """One step on tokens [B, T] (numpy or tensor); the loss comes
        back as a 0-d device tensor (no host sync)."""
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
