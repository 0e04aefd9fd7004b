"""Adaptive density control (3DGS densify/clone/split/prune) at a fixed N.

Counterpart of gaussian_splat_tpu/train/densify.py: ADC as a slot
redistribution at constant N.

  * every gaussian carries a densify score — an EMA of its screen-space
    positional gradient magnitude (the 3DGS criterion);
  * a fixed fraction of slots (the lowest opacity) are VICTIMS; the same
    number of top-scoring gaussians are DONORS;
  * each victim slot is respawned as a *split* of its donor: positioned at the
    donor's mean plus a scale-sized jitter, with donor and child scales divided
    by 1.6 and opacities shared (3DGS split rule);
  * periodic opacity reset clamps all opacities below a ceiling, as in 3DGS.

Optimizer moments for respawned slots are zeroed via `reset_opt_rows`.

Where the reference returns new arrays, `densify_step`, `reset_opacity` and
`reset_opt_rows` UPDATE IN PLACE: the optimizer's state is keyed by the
parameter objects, which therefore must stay the same ones.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_tpu_torch.ops.binning import _top_indices
from gaussian_splat_tpu_torch.ops.projection import _rotmat_rows


class DensifyState(NamedTuple):
    grad_score: torch.Tensor  # (N,) EMA of the screen-space positional
    #   gradient ‖∂L/∂means2d‖ (pixels) — the 3DGS criterion; the trainer gets
    #   it by differentiating w.r.t. a zero screen offset
    ema_beta: float = 0.9


def init_densify_state(n: int, device=None) -> DensifyState:
    return DensifyState(grad_score=torch.zeros((n,), device=device))


@torch.no_grad()
def update_scores(state: DensifyState, grads_means2d: torch.Tensor) -> DensifyState:
    """Accumulate the screen-space positional-gradient EMA (every train step)."""
    g = torch.linalg.norm(grads_means2d, dim=-1)
    score = state.ema_beta * state.grad_score + (1.0 - state.ema_beta) * g
    return state._replace(grad_score=score)


@torch.no_grad()
def densify_step(
    model: GaussianModel,
    state: DensifyState,
    noise: Union[torch.Generator, torch.Tensor],
    *,
    victim_fraction: float = 0.05,
    opacity_floor: float = 0.005,
    split_scale: float = 1.6,
) -> Tuple[GaussianModel, DensifyState, torch.Tensor]:
    """One redistribution, in place on `model`. Returns (model, state,
    respawned_mask (N,) bool).

    `noise` is the jitter's standard-normal draw: a `torch.Generator` on the
    model's device, or the (v, 3) draw itself (v = max(1, int(N ·
    victim_fraction))) — the frameworks' generators differ, so a parity test
    hands both sides the same numbers."""
    n = model.num_gaussians
    v = max(1, int(n * victim_fraction))
    dev = model.device

    # keep-priority: low opacity first to die (3DGS prune criterion); ties go
    # to the lower index, as jax.lax.top_k orders them
    victim_idx = _top_indices(-model.opacities, v)
    # donors: highest gradient score, excluding victims
    score = state.grad_score.clone()
    score[victim_idx] = -torch.inf
    donor_idx = _top_indices(score, v)

    if isinstance(noise, torch.Generator):
        noise = torch.randn((v, 3), generator=noise, device=dev)
    elif tuple(noise.shape) != (v, 3):
        raise ValueError(f"noise: expected shape {(v, 3)}, got {tuple(noise.shape)}")
    jitter = torch.exp(model.log_scales[donor_idx]) * noise.to(dev)
    # rotate jitter into the donor's frame (scales are axis-aligned pre-rotation)
    r = _rotmat_rows(model.quats[donor_idx])
    offset = torch.stack(
        [r[3 * i] * jitter[:, 0] + r[3 * i + 1] * jitter[:, 1] + r[3 * i + 2] * jitter[:, 2]
         for i in range(3)],
        dim=-1,
    )

    new_means = model.means[donor_idx] + offset
    new_log_scales = model.log_scales[donor_idx] - float(np.log(np.float32(split_scale)))
    donor_quats = model.quats[donor_idx]
    donor_logits = model.opacity_logits[donor_idx]
    donor_sh = model.sh[donor_idx]

    model.means[victim_idx] = new_means
    model.log_scales[victim_idx] = new_log_scales
    # the donor also shrinks (split semantics)
    model.log_scales[donor_idx] = new_log_scales
    model.quats[victim_idx] = donor_quats
    model.opacity_logits[victim_idx] = donor_logits
    model.sh[victim_idx] = donor_sh

    respawned = torch.zeros((n,), dtype=torch.bool, device=dev)
    respawned[victim_idx] = True
    respawned[donor_idx] = True

    grad_score = state.grad_score.clone()
    grad_score[victim_idx] = 0.0
    grad_score[donor_idx] = 0.0
    return model, state._replace(grad_score=grad_score), respawned


@torch.no_grad()
def reset_opacity(model: GaussianModel, ceiling: float = 0.01) -> GaussianModel:
    """Clamp opacities to ≤ ceiling, in place (3DGS periodic opacity reset)."""
    c = np.float32(ceiling)
    cap = float(np.log(c) - np.log1p(-c))  # logit(ceiling), in float32
    model.opacity_logits.clamp_(max=cap)
    return model


@torch.no_grad()
def reset_opt_rows(optimizer: torch.optim.Optimizer, mask: torch.Tensor):
    """Zero the optimizer's moments of respawned slots, in place: every state
    tensor whose leading dimension matches the mask gets its masked rows
    zeroed (in every parameter group)."""
    n = mask.shape[0]
    for per_param in optimizer.state.values():
        for value in per_param.values():
            if torch.is_tensor(value) and value.ndim >= 1 and value.shape[0] == n:
                value[mask] = 0.0
    return optimizer
