"""Checkpoint / resume for training state (port of
`flash_attention_tpu/utils/checkpoint.py`, which uses Orbax).

The same functions and layout rules on `torch.save` / `torch.load`:
one step-indexed subdirectory per checkpoint (`<ckpt_dir>/<step>/`),
the newest `max_to_keep` kept. A checkpoint is written under a
temporary name and renamed into place, so a crash mid-write leaves no
directory that `latest_step` would pick. States are nested dicts,
lists and tuples of tensors and Python scalars (what an optimizer's
`state_dict()` holds) and load with `weights_only=True`.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import tempfile
from typing import Any

import torch

_STATE_FILE = "state.pt"


def _steps(ckpt_dir: pathlib.Path) -> list[int]:
    if not ckpt_dir.is_dir():
        return []
    return sorted(int(p.name) for p in ckpt_dir.iterdir()
                  if p.name.isdigit() and (p / _STATE_FILE).is_file())


def save_checkpoint(ckpt_dir, step: int, state: Any, *,
                    max_to_keep: int = 3) -> None:
    """Save `state` (params / opt_state / step / metadata) at `step`.
    Retains the newest `max_to_keep` steps."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / str(int(step))
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=f".tmp-{int(step)}-",
                                        dir=ckpt_dir))
    try:
        torch.save(state, tmp / _STATE_FILE)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(ckpt_dir / str(old))


def latest_step(ckpt_dir) -> int | None:
    steps = _steps(pathlib.Path(ckpt_dir))
    return steps[-1] if steps else None


def _place(state, template):
    """Move each restored tensor to the device of the template's tensor
    at the same place; leaves without one stay where they loaded."""
    if isinstance(state, torch.Tensor):
        if isinstance(template, torch.Tensor):
            return state.to(template.device)
        return state
    if isinstance(state, dict):
        tmpl = template if isinstance(template, dict) else {}
        return {k: _place(v, tmpl.get(k)) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        tmpl = template if isinstance(template, (list, tuple)) \
            and len(template) == len(state) else [None] * len(state)
        return type(state)(_place(v, t) for v, t in zip(state, tmpl))
    return state


def restore_checkpoint(ckpt_dir, *, step: int | None = None,
                       template: Any = None) -> tuple[int, Any]:
    """Restore (step, state). With `template` (a like-structured state),
    each tensor lands on the device of the template's tensor at the same
    place; without one, everything loads on the CPU."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = ckpt_dir / str(int(step)) / _STATE_FILE
    if not path.is_file():
        raise FileNotFoundError(f"no checkpoint for step {step} under "
                                f"{ckpt_dir}")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if template is not None:
        state = _place(state, template)
    return int(step), state
