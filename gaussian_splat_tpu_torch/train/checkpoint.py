"""Checkpoint / resume for the training state.

Counterpart of gaussian_splat_tpu/train/checkpoint.py, on `torch.save` and
`torch.load` in place of Orbax: one file `step_<step>.pt` per saved step in
the checkpoint directory, the newest three kept. A checkpoint holds what the
reference's holds — the model's five leaves, the optimizer's moments and step
counts, the step, and (for an `AdcTrainState`) the densify scores and the
state of the jitter generator, so that a resumed run replays the random
streams of the uninterrupted one. PLY export via `io.ply.save_gaussians`
remains the interchange format, usable at any step.

There is nothing to close: every save is written, renamed into place and
finished before `save_checkpoint` returns.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from gaussian_splat_tpu_torch.train.densify import DensifyState

MAX_TO_KEEP = 3
_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m
    )


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.pt")


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def save_checkpoint(directory: str, state) -> None:
    """Save a `TrainState` or `AdcTrainState` under its step."""
    os.makedirs(directory, exist_ok=True)
    payload = {
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
    }
    if hasattr(state, "densify"):
        payload["densify"] = {
            "grad_score": state.densify.grad_score,
            "ema_beta": state.densify.ema_beta,
        }
        payload["jitter_rng_state"] = state.jitter_rng.get_state()
    path = _path(directory, payload["step"])
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader sees a whole file or none
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        os.remove(_path(directory, old))


def restore_checkpoint(directory: str, template):
    """Load the latest checkpoint INTO `template` (a state of the same
    structure, whose tensors' device is kept) and return it; None if the
    directory holds no checkpoint."""
    step = latest_step(directory)
    if step is None:
        return None
    device = template.model.device
    payload = torch.load(_path(directory, step), map_location=device, weights_only=True)
    template.model.load_state_dict(payload["model"])
    template.optimizer.load_state_dict(payload["optimizer"])
    template.step = int(payload["step"])
    if hasattr(template, "densify"):
        template.densify = DensifyState(
            grad_score=payload["densify"]["grad_score"].to(device),
            ema_beta=float(payload["densify"]["ema_beta"]),
        )
        template.jitter_rng.set_state(payload["jitter_rng_state"].cpu())
    return template
