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

Under a mesh (sharded training, `parallel.mesh`) every rank holds one row
block of the model and of the optimizer's moments. `save_checkpoint(...,
mesh)` gathers the blocks to rank 0, which alone writes the whole state —
the file a single process would write — and removes old ones, while the
other ranks wait; `restore_checkpoint(..., mesh)` gives each rank its block
of that file back.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch
import torch.distributed as dist

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


def _gather_rows(tensor: torch.Tensor, group) -> torch.Tensor:
    out = tensor.new_empty((dist.get_world_size(group) * tensor.shape[0], *tensor.shape[1:]))
    dist.all_gather_into_tensor(out, tensor.contiguous(), group=group)
    return out


def _map_rows(state_dicts, fn):
    """(model state dict, optimizer state dict) with `fn` applied to every
    tensor split over splats: the leaves and the moments, not Adam's 0-d
    step count, which is the same on every rank."""
    model_sd, opt_sd = state_dicts
    model_sd = {k: fn(v) for k, v in model_sd.items()}
    opt_sd = dict(opt_sd, state={
        i: {k: fn(v) if torch.is_tensor(v) and v.dim() > 0 else v for k, v in moments.items()}
        for i, moments in opt_sd["state"].items()
    })
    return model_sd, opt_sd


def save_checkpoint(directory: str, state, mesh=None, axis_name: str = "dev") -> None:
    """Save a `TrainState` or `AdcTrainState` under its step. With `mesh`
    (a `TrainState` of sharded training), call it on every rank with that
    rank's state: rank 0 writes the whole model and moments, gathered in
    rank order."""
    model_sd, opt_sd = state.model.state_dict(), state.optimizer.state_dict()
    lead = True
    if mesh is not None:
        group = mesh.get_group(axis_name)
        model_sd, opt_sd = _map_rows((model_sd, opt_sd), lambda t: _gather_rows(t, group))
        lead = dist.get_rank(group) == 0
    if lead:
        _write(directory, state, model_sd, opt_sd)
    if mesh is not None:
        dist.barrier(group)  # no rank goes on before the file is there


def _write(directory: str, state, model_sd, opt_sd) -> None:
    os.makedirs(directory, exist_ok=True)
    payload = {"step": int(state.step), "model": model_sd, "optimizer": opt_sd}
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


def restore_checkpoint(directory: str, template, mesh=None, axis_name: str = "dev"):
    """Load the latest checkpoint INTO `template` (a state of the same
    structure, whose tensors' device is kept) and return it; None if the
    directory holds no checkpoint. With `mesh`, call it on every rank with
    a template of that rank's block: each rank takes its rows of the whole
    state."""
    step = latest_step(directory)
    if step is None:
        return None
    device = template.model.device
    payload = torch.load(_path(directory, step), map_location=device, weights_only=True)
    model_sd, opt_sd = payload["model"], payload["optimizer"]
    if mesh is not None:
        ndev, rank = mesh.size(), mesh.get_local_rank(axis_name)

        def block(t):
            per = t.shape[0] // ndev
            return t[rank * per : (rank + 1) * per].clone()

        model_sd, opt_sd = _map_rows((model_sd, opt_sd), block)
    template.model.load_state_dict(model_sd)
    template.optimizer.load_state_dict(opt_sd)
    template.step = int(payload["step"])
    if hasattr(template, "densify"):
        template.densify = DensifyState(
            grad_score=payload["densify"]["grad_score"].to(device),
            ema_beta=float(payload["densify"]["ema_beta"]),
        )
        template.jitter_rng.set_state(payload["jitter_rng_state"].cpu())
    return template
