"""Dense oracle rasterizer: every splat against every pixel, exact semantics.

Counterpart of gaussian_splat_tpu/ops/reference.py and the port's CPU ground
truth: front-to-back alpha compositing with NO capacity limits, NO tiling and
NO early termination, differentiable by autograd.

  α_i   = min(opacity_i · exp(−σ_i), alpha_clamp),  σ = 0.5(A dx² + C dy²) + B dx dy
  α_i ← 0 where α_i < alpha_skip, σ < 0, or the splat was culled
  T_i   = Π_{j<i} (1 − α_j)   (depth order, near to far)
  C     = Σ_i c_i α_i T_i + T_final · background

Memory is O(N·H·W): use only for small scenes/tests.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gaussian_splat_tpu_torch.config import RenderConfig
from gaussian_splat_tpu_torch.ops.falloff import (
    alpha_from_sigma, sigma_bound, sigma_quadform,
)


def composite_sorted(
    means2d: torch.Tensor,  # (N,2) already depth-sorted near→far
    conics: torch.Tensor,  # (N,3)
    colors: torch.Tensor,  # (N,C) — any channel count; the standard pipeline
    #   passes RGB+depth so the expected-depth map falls out of the same math
    opacities: torch.Tensor,  # (N,)
    valid: torch.Tensor,  # (N,) bool
    width: int,
    height: int,
    config: RenderConfig = RenderConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite depth-sorted splats over all pixels. Returns (image (H,W,C), T_final (H,W))."""
    dev = means2d.device
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5

    dx = xs[None, None, :] - means2d[:, 0, None, None]  # (N,H,W) via broadcast
    dy = ys[None, :, None] - means2d[:, 1, None, None]
    A2 = 0.5 * conics[:, 0, None, None]
    B = conics[:, 1, None, None]
    C2 = 0.5 * conics[:, 2, None, None]
    sigma = sigma_quadform(dx, dy, A2, B, C2)  # (N,H,W)
    bound = sigma_bound(
        opacities[:, None, None], valid[:, None, None],
        config.sigma_cutoff, config.alpha_skip,
    )
    alpha, _, _ = alpha_from_sigma(
        sigma, opacities[:, None, None], bound, config.alpha_clamp
    )

    trans = torch.cumprod(1.0 - alpha, dim=0)  # inclusive
    t_excl = torch.cat([torch.ones_like(trans[:1]), trans[:-1]], dim=0)  # T_i
    weights = alpha * t_excl  # (N,H,W)

    image = torch.einsum("nhw,nc->hwc", weights, colors)
    if trans.shape[0] > 0:
        t_final = trans[-1]
    else:
        t_final = torch.ones((height, width), dtype=torch.float32, device=dev)
    return image, t_final


def render_reference(
    means2d: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    depths: torch.Tensor,
    valid: torch.Tensor,
    width: int,
    height: int,
    config: RenderConfig = RenderConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Depth-sort then composite. Returns (image (H,W,3), T_final (H,W),
    depth (H,W) — the α-weighted expected camera-space depth, composited as a
    fourth color channel). Background is applied here: C += T_final · bg."""
    key = torch.where(valid, depths, torch.inf)
    order = torch.argsort(key.detach(), stable=True)
    image, t_final = composite_sorted(
        means2d[order],
        conics[order],
        torch.cat([colors, depths[:, None]], dim=1)[order],
        opacities[order],
        valid[order],
        width,
        height,
        config,
    )
    bg = torch.tensor(config.background, dtype=torch.float32, device=image.device)
    depth = image[..., 3]
    image = image[..., :3] + t_final[..., None] * bg
    return image, t_final, depth
