"""Parameters and training state carried across from the JAX package, by way
of numpy.

The JAX `GaussianModel`'s five leaves and the JAX `Camera`'s fields arrive
here as numpy arrays (the caller does the `np.asarray(...)`), so both packages
can be handed bit-identical inputs; likewise the optax Adam moments with their
update count, and the densify scores, so that both trainers can start from
the same mid-run state. This module imports no jax.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gaussian_splat_tpu_torch._device import DeviceLike, resolve_device
from gaussian_splat_tpu_torch.camera import Camera
from gaussian_splat_tpu_torch.models.gaussians import GaussianModel


def model_from_numpy(leaves: Mapping[str, np.ndarray], device: DeviceLike = None) -> GaussianModel:
    """Build a GaussianModel from a dict holding the five raw leaves
    (`means`, `quats`, `log_scales`, `opacity_logits`, `sh`)."""
    missing = [k for k in GaussianModel.LEAVES if k not in leaves]
    if missing:
        raise KeyError(f"model leaves missing: {missing}")
    return GaussianModel.create(
        *(np.asarray(leaves[k], np.float32) for k in GaussianModel.LEAVES),
        device=device,
    )


def camera_from_numpy(
    viewmat, fx, fy, cx, cy, width: int, height: int, device: DeviceLike = None
) -> Camera:
    """Build a Camera from a (4,4) world→camera matrix and pixel intrinsics."""
    device = resolve_device(device)

    def scalar(v):
        return torch.tensor(float(np.asarray(v, np.float32)), dtype=torch.float32, device=device)

    return Camera(
        viewmat=torch.tensor(np.asarray(viewmat, np.float32), device=device),
        fx=scalar(fx), fy=scalar(fy), cx=scalar(cx), cy=scalar(cy),
        width=int(width), height=int(height),
    )


def load_adam_state(
    optimizer: torch.optim.Adam,
    model: GaussianModel,
    mu: Mapping[str, np.ndarray],
    nu: Mapping[str, np.ndarray],
    count: int,
) -> None:
    """Put Adam moments into `optimizer` (made by `trainer.make_optimizer` for
    `model`): `mu[name]` and `nu[name]` are the first and second moments of
    leaf `name` (optax's `ScaleByAdamState.mu/.nu`), `count` the number of
    updates already made (its `.count`)."""
    for name in GaussianModel.LEAVES:
        param = getattr(model, name)

        def moment(x):
            t = torch.tensor(np.asarray(x, np.float32), device=param.device)
            if t.shape != param.shape:
                raise ValueError(f"{name}: moment {tuple(t.shape)} vs leaf {tuple(param.shape)}")
            return t

        optimizer.state[param] = {
            "step": torch.tensor(float(count)),
            "exp_avg": moment(mu[name]),
            "exp_avg_sq": moment(nu[name]),
        }


def densify_state_from_numpy(grad_score, ema_beta: float = 0.9, device: DeviceLike = None):
    """A `DensifyState` from the reference's `grad_score` (N,) and `ema_beta`."""
    from gaussian_splat_tpu_torch.train.densify import DensifyState

    return DensifyState(
        grad_score=torch.tensor(np.asarray(grad_score, np.float32), device=resolve_device(device)),
        ema_beta=float(ema_beta),
    )


def random_leaves(
    seed: int,
    n: int,
    sh_degree: int = 0,
    extent: float = 1.0,
    scale_range=(0.01, 0.1),
) -> dict:
    """A random scene as numpy leaves, made from `seed` by numpy alone — the
    same numbers whichever framework then takes them (its own generators
    differ). Same distributions as `GaussianModel.random`."""
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    quats = rng.standard_normal((n, 4))
    sh = np.zeros((n, k, 3))
    sh[:, 0, :] = (rng.uniform(0.1, 0.9, (n, 3)) - 0.5) / 0.28209479177387814
    sh[:, 1:, :] = 0.1 * rng.standard_normal((n, k - 1, 3))
    leaves = {
        "means": rng.uniform(-extent, extent, (n, 3)),
        "quats": quats / np.linalg.norm(quats, axis=-1, keepdims=True),
        "log_scales": rng.uniform(
            np.log(scale_range[0]), np.log(scale_range[1]), (n, 3)
        ),
        "opacity_logits": rng.uniform(-1.0, 3.0, (n,)),
        "sh": sh,
    }
    return {name: v.astype(np.float32) for name, v in leaves.items()}
