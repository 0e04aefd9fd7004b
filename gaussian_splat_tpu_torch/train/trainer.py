"""Training loop: per-group Adam, the train step, multi-view fits, density control.

Counterpart of gaussian_splat_tpu/train/trainer.py, in PyTorch's idiom:

  * `optax.multi_transform` of five Adams → one `torch.optim.Adam` with five
    parameter groups (same betas, eps outside the square root, no weight
    decay); the 3DGS position-lr decay is a plain function of the number of
    updates made (`position_lr`), set on the `means` group before each update.
  * no jit, scan or buffer donation: a step is eager code that updates the
    model and the optimizer IN PLACE and returns the same state object.
    `steps_per_dispatch=K` keeps its contract — K steps per call, the last
    loss returned — as a Python loop.
  * gradients flow through the raster stage's explicit backward (the CUDA
    kernels on the GPU) and autograd through projection and SH.
  * `mesh=` (a `parallel.mesh.make_mesh` mesh): every rank steps its own
    block of the model (`parallel.mesh.shard_model`) through
    `render_sharded`, which gives every rank the whole frame; the loss is
    computed on every rank, and each rank's Adam updates its own block only —
    the model is split over splats, so there is no gradient all-reduce.

`fit*` copy the caller's model first; the fitted copy is returned.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from gaussian_splat_tpu_torch.camera import Camera
from gaussian_splat_tpu_torch.config import RenderConfig, TrainConfig
from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_tpu_torch.ops.render import render
from gaussian_splat_tpu_torch.train import densify as adc
from gaussian_splat_tpu_torch.train.loss import photometric_loss


def position_lr(tc: TrainConfig, count: int) -> float:
    """Learning rate of the means for the update after `count` updates (0 on
    the first): log-linear from `lr_means` to `lr_means_final` over
    `lr_decay_steps` (default 30 000, the 3DGS horizon, independent of
    num_steps), then held — `optax.exponential_decay(init, steps,
    rate=final/init, end_value=final)` as a plain function."""
    if not tc.lr_means_final or tc.lr_means_final == tc.lr_means:
        return tc.lr_means
    steps = tc.lr_decay_steps or 30_000
    rate = tc.lr_means_final / tc.lr_means
    lr = tc.lr_means * math.pow(rate, count / steps)
    clip = max if rate < 1.0 else min
    return clip(lr, tc.lr_means_final)


def make_optimizer(model: GaussianModel, tc: TrainConfig) -> torch.optim.Adam:
    """Per-group Adam (3DGS convention: position lr ≪ opacity lr). The `means`
    group's lr follows `position_lr`; see `set_position_lr`."""
    lrs = {
        "means": position_lr(tc, 0),
        "quats": tc.lr_quats,
        "log_scales": tc.lr_scales,
        "opacity_logits": tc.lr_opacities,
        "sh": tc.lr_sh,
    }
    groups = [
        {"params": [getattr(model, name)], "lr": lrs[name], "name": name}
        for name in GaussianModel.LEAVES
    ]
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


def set_position_lr(optimizer: torch.optim.Adam, tc: TrainConfig, count: int) -> None:
    for group in optimizer.param_groups:
        if group["name"] == "means":
            group["lr"] = position_lr(tc, count)


def _sh_band_of_coeff(num_coeffs: int) -> np.ndarray:
    """Per-coefficient SH band indices: coeff k of a degree-d basis has band
    ⌈√(k+1)⌉−1 (1, 3, 5, 7 coeffs for bands 0-3)."""
    k = np.arange(num_coeffs)
    return (np.ceil(np.sqrt(k + 1)) - 1).astype(np.int64)


def apply_sh_warmup(model, step: int, tc: TrainConfig):
    """3DGS SH warmup: only bands ≤ step // sh_warmup_every are active.

    Returns a view of the model whose inactive bands' coefficients are
    multiplied by zero — image-equivalent to lowering the eval degree. The
    model itself is untouched, and gradients reach its parameters."""
    if not tc.sh_warmup_every:
        return model
    active = int(step) // tc.sh_warmup_every
    bands = _sh_band_of_coeff(model.sh.shape[1])
    mask = torch.as_tensor(bands <= active, dtype=model.sh.dtype, device=model.sh.device)
    return model.replace(sh=model.sh * mask[None, :, None])


@dataclasses.dataclass
class TrainState:
    model: GaussianModel
    optimizer: torch.optim.Adam
    step: int = 0  # updates made so far


def create_train_state(model: GaussianModel, tc: TrainConfig) -> TrainState:
    # copy the leaves: steps update the state in place, and that must never
    # reach the caller's model
    model = copy.deepcopy(model)
    return TrainState(model=model, optimizer=make_optimizer(model, tc), step=0)


def _image_fn(render_config: RenderConfig, mesh):
    """(model, camera) → the rendered image: sharded over `mesh` when given."""
    if mesh is None:
        return lambda model, cam: render(model, cam, render_config).image
    from gaussian_splat_tpu_torch.parallel.sharded_render import render_sharded

    return lambda model, cam: render_sharded(model, cam, render_config, mesh).image


def _update(state, tc: TrainConfig, loss: torch.Tensor) -> None:
    """One Adam update from `loss`, in place on the state."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    set_position_lr(state.optimizer, tc, state.step)
    state.optimizer.step()
    state.step += 1


def make_train_step(
    camera: Camera,
    render_config: RenderConfig,
    train_config: TrainConfig,
    mesh=None,
) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, torch.Tensor]]:
    """Build a train step against one target image. The returned step runs
    `train_config.steps_per_dispatch` steps per call, updating the state in
    place. Returns (state, loss of the last step). With `mesh`, the state
    holds this rank's block of the model and the target is the whole
    frame."""
    render_image = _image_fn(render_config, mesh)
    K = max(1, train_config.steps_per_dispatch)

    def train_step(state: TrainState, target: torch.Tensor):
        for _ in range(K):
            model = apply_sh_warmup(state.model, state.step, train_config)
            img = render_image(model, camera)
            loss = photometric_loss(img, target, train_config.ssim_weight)
            _update(state, train_config, loss)
        return state, loss.detach()

    return train_step


def make_multiview_train_step(
    dataset,
    render_config: RenderConfig,
    train_config: TrainConfig,
    mesh=None,
) -> Callable:
    """Multi-view step: `step(state, view_idx)`. With steps_per_dispatch
    K > 1, pass a sequence of K view indices per call. With `mesh`, as in
    `make_train_step`: each view renders sharded."""
    render_image = _image_fn(render_config, mesh)
    K = max(1, train_config.steps_per_dispatch)

    def train_step(state: TrainState, view_idx):
        views = [int(view_idx)] if K == 1 else [int(v) for v in view_idx]
        for view in views:
            model = apply_sh_warmup(state.model, state.step, train_config)
            img = render_image(model, dataset.camera(view))
            loss = photometric_loss(
                img, dataset.target(view), train_config.ssim_weight
            )
            _update(state, train_config, loss)
        return state, loss.detach()

    return train_step


@dataclasses.dataclass
class AdcTrainState:
    """Train state with adaptive-density-control bookkeeping."""

    model: GaussianModel
    optimizer: torch.optim.Adam
    step: int
    densify: adc.DensifyState
    jitter_rng: torch.Generator  # the densify jitter's stream; its state is
    #   checkpointed, so a resumed run draws what the uninterrupted run would


def _maybe_checkpoint(tc: TrainConfig, state, due: bool, mesh=None) -> None:
    """Save when due; under `mesh` every rank takes part and rank 0 writes
    the whole state."""
    if tc.checkpoint_dir and tc.checkpoint_every and due:
        from gaussian_splat_tpu_torch.train.checkpoint import save_checkpoint

        save_checkpoint(tc.checkpoint_dir, state, mesh)


def fit_multiview_adc(
    model: GaussianModel,
    dataset,
    render_config: RenderConfig = RenderConfig(),
    train_config: TrainConfig = TrainConfig(),
    *,
    densify_every: int = 100,
    densify_until: Optional[int] = None,
    opacity_reset_every: int = 500,
    victim_fraction: float = 0.05,
    seed: int = 0,
    log_every: int = 100,
    resume: bool = False,
) -> Tuple[GaussianModel, List[float]]:
    """Multi-view fit with 3DGS-style adaptive density control at fixed N
    (slot redistribution — see train/densify.py).

    Checkpointing: with `train_config.checkpoint_dir` set, the full
    AdcTrainState (model + optimizer moments + densify scores + step + the
    jitter generator's state) is saved every `checkpoint_every` steps;
    `resume=True` restores the latest checkpoint and continues from its step,
    drawing the views and the jitter the uninterrupted run would have drawn."""
    tc = train_config
    model = copy.deepcopy(model)
    jitter_rng = torch.Generator(device=model.device)
    jitter_rng.manual_seed(seed)
    state = AdcTrainState(
        model=model,
        optimizer=make_optimizer(model, tc),
        step=0,
        densify=adc.init_densify_state(model.num_gaussians, model.device),
        jitter_rng=jitter_rng,
    )
    densify_until = densify_until or int(tc.num_steps * 0.8)

    def train_step(view: int) -> torch.Tensor:
        # differentiate w.r.t. a zero screen-space offset to get the TRUE 3DGS
        # densify criterion — ‖∂L/∂means2d‖ in pixels — in the same backward
        # as the parameter gradients
        off = torch.zeros(
            (state.model.num_gaussians, 2), device=state.model.device,
            requires_grad=True,
        )
        img = render(
            state.model, dataset.camera(view), render_config, screen_offset=off
        ).image
        loss = photometric_loss(img, dataset.target(view), tc.ssim_weight)
        _update(state, tc, loss)
        state.densify = adc.update_scores(state.densify, off.grad)
        return loss.detach()

    rng = np.random.default_rng(seed)
    start = 0
    if resume and tc.checkpoint_dir:
        from gaussian_splat_tpu_torch.train.checkpoint import restore_checkpoint

        if restore_checkpoint(tc.checkpoint_dir, state) is not None:
            start = state.step
            # keep the view stream aligned with the fresh run: one draw per step
            _ = rng.integers(dataset.num_views, size=start)
    history = []
    for i in range(start, tc.num_steps):
        view = int(rng.integers(dataset.num_views))
        loss = train_step(view)
        if 0 < i <= densify_until and i % densify_every == 0:
            _, state.densify, respawned = adc.densify_step(
                state.model, state.densify, state.jitter_rng,
                victim_fraction=victim_fraction,
            )
            adc.reset_opt_rows(state.optimizer, respawned)
        if opacity_reset_every and 0 < i <= densify_until and i % opacity_reset_every == 0:
            adc.reset_opacity(state.model)
        if i % log_every == 0 or i == tc.num_steps - 1:
            history.append(float(loss))
        _maybe_checkpoint(tc, state, i > 0 and (i + 1) % max(tc.checkpoint_every, 1) == 0)
    return state.model, history


def _fit_loop(state, step_fn, next_arg, tc: TrainConfig, log_every, callback, mesh=None):
    K = max(1, tc.steps_per_dispatch)
    history = []
    for i in range(0, tc.num_steps, K):
        state, loss = step_fn(state, next_arg())
        if (i // K) % max(1, log_every // K) == 0 or i + K >= tc.num_steps:
            history.append(float(loss))
            if callback is not None:
                callback(i, float(loss), state)
        _maybe_checkpoint(tc, state, (i + K) % max(tc.checkpoint_every, 1) < K, mesh)
    return state.model, history


def fit_multiview(
    model: GaussianModel,
    dataset,
    render_config: RenderConfig = RenderConfig(),
    train_config: TrainConfig = TrainConfig(),
    seed: int = 0,
    log_every: int = 100,
    callback=None,
) -> Tuple[GaussianModel, List[float]]:
    """Fit to a multi-view dataset with random view sampling per step."""
    rng = np.random.default_rng(seed)
    K = max(1, train_config.steps_per_dispatch)

    def next_views():
        if K == 1:
            return int(rng.integers(dataset.num_views))
        return rng.integers(dataset.num_views, size=K)

    return _fit_loop(
        create_train_state(model, train_config),
        make_multiview_train_step(dataset, render_config, train_config),
        next_views, train_config, log_every, callback,
    )


def fit(
    model: GaussianModel,
    camera: Camera,
    target: torch.Tensor,
    render_config: RenderConfig = RenderConfig(),
    train_config: TrainConfig = TrainConfig(),
    mesh=None,
    log_every: int = 100,
    callback=None,
) -> Tuple[GaussianModel, List[float]]:
    """Fit a model to a single target image. Returns (model, loss history).
    With `mesh`, call it on every rank with that rank's block of the model
    (`shard_model`) and the whole target; it returns the fitted block, and
    the same history on every rank; a checkpoint holds the whole model
    (`checkpoint.save_checkpoint(mesh=)`)."""
    target = torch.as_tensor(target, dtype=torch.float32).to(model.device)
    return _fit_loop(
        create_train_state(model, train_config),
        make_train_step(camera, render_config, train_config, mesh),
        lambda: target, train_config, log_every, callback, mesh,
    )
